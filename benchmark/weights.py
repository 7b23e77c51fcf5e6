"""Seeded random weights, drawn on the device in the type they are served in.

The benchmark makes its own weights from ``--seed``; the program and the
plain reference are both handed these tensors.  The rule is the port's
``models/dia.py::init_params`` (kernels normal / sqrt(fan_in), fan_in the
contracted axes after a layer stack, two for ``o_proj``; embeddings normal x
0.02; norm scales ones) and ``models/dac.py::init_dac_decoder_params`` for
the codec's decode side (conv kernels normal / sqrt(in x k), zero biases,
unit snake alphas, normal codebooks).  The draws are not the port's numpy
draws: one ``torch.Generator`` on the device, one call a leaf (the per-layer
leaves are stacked ``[L, ...]``, so a leaf is one large call), in a fixed
order, so one seed gives one tree on one kind of device.

The shape tables are this module's own copies, held to the port's
``param_shapes`` and ``init_dac_decoder_params`` by
``tests/test_bench_weights.py``.
"""

from __future__ import annotations

import math

import torch

SEED_MASK = (1 << 63) - 1


def dia_shapes(model: dict) -> dict:
    """The shape of every leaf of the Dia tree, from a ``DiaConfig`` JSON
    object (``{"model": {...}, "data": {...}}``), in the tree's order."""
    m, d = model["model"], model["data"]
    enc, dec = m["encoder"], m["decoder"]
    C = d["channels"]

    def attn(L, d_q, d_kv, nq, nkv, h):
        return {"q_proj": {"kernel": (L, d_q, nq, h)}, "k_proj": {"kernel": (L, d_kv, nkv, h)},
                "v_proj": {"kernel": (L, d_kv, nkv, h)}, "o_proj": {"kernel": (L, nq, h, d_q)}}

    def mlp(L, dim, f):
        return {"wi_fused": {"kernel": (L, dim, 2, f)}, "wo": {"kernel": (L, f, dim)}}

    def norm(*shape):
        return {"scale": shape}

    Le, Ld = enc["n_layer"], dec["n_layer"]
    return {
        "encoder": {
            "embedding": {"embedding": (m["src_vocab_size"], enc["n_embd"])},
            "layers": {
                "pre_sa_norm": norm(Le, enc["n_embd"]),
                "self_attention": attn(Le, enc["n_embd"], enc["n_embd"], enc["n_head"],
                                       enc["n_head"], enc["head_dim"]),
                "post_sa_norm": norm(Le, enc["n_embd"]),
                "mlp": mlp(Le, enc["n_embd"], enc["n_hidden"]),
            },
            "norm": norm(enc["n_embd"]),
        },
        "decoder": {
            "embeddings": {"embedding": (C, m["tgt_vocab_size"], dec["n_embd"])},
            "layers": {
                "pre_sa_norm": norm(Ld, dec["n_embd"]),
                "self_attention": attn(Ld, dec["n_embd"], dec["n_embd"], dec["gqa_query_heads"],
                                       dec["kv_heads"], dec["gqa_head_dim"]),
                "pre_ca_norm": norm(Ld, dec["n_embd"]),
                "cross_attention": attn(Ld, dec["n_embd"], enc["n_embd"],
                                        dec["cross_query_heads"], dec["cross_query_heads"],
                                        dec["cross_head_dim"]),
                "pre_mlp_norm": norm(Ld, dec["n_embd"]),
                "mlp": mlp(Ld, dec["n_embd"], dec["n_hidden"]),
            },
            "norm": norm(dec["n_embd"]),
            "logits_dense": {"kernel": (dec["n_embd"], C, m["tgt_vocab_size"])},
        },
    }


def dac_decoder_shapes(dac: dict) -> dict:
    """The shape of every leaf of the codec's decode side (``DACConfig``
    fields as a dict), in the tree's order; lists stay lists."""
    dd, rates = dac["decoder_dim"], dac["decoder_rates"]
    latent = dac["encoder_dim"] * 2 ** len(dac["encoder_rates"])

    def conv(o, i, k, transpose=False):
        return {"weight": (i, o, k) if transpose else (o, i, k), "bias": (o,)}

    def alpha(dim):
        return {"alpha": (1, dim, 1)}

    def res(dim):
        return {"snake1": alpha(dim), "conv1": conv(dim, dim, 7), "snake2": alpha(dim),
                "conv2": conv(dim, dim, 1)}

    blocks = []
    for i, stride in enumerate(rates):
        in_d, out_d = dd // 2 ** i, dd // 2 ** (i + 1)
        blocks.append({"snake": alpha(in_d), "conv_t": conv(out_d, in_d, 2 * stride, True),
                       "res1": res(out_d), "res2": res(out_d), "res3": res(out_d)})
    final_d = dd // 2 ** len(rates)
    quantizers = [{"out_proj": conv(latent, dac["codebook_dim"], 1),
                   "codebook": {"embedding": (dac["codebook_size"], dac["codebook_dim"])}}
                  for _ in range(dac["n_codebooks"])]
    return {"decoder": {"stem": conv(dd, latent, 7), "blocks": blocks,
                        "snake": alpha(final_d), "head": conv(1, final_d, 7)},
            "quantizer": {"quantizers": quantizers}}


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator on ``device`` for one of the seed's streams (0: the Dia
    weights, 1: the codec); any whole ``seed`` is taken modulo 2**63."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 2 + stream) & SEED_MASK)
    return g


def dia_leaf_scale(path: tuple, shape: tuple) -> float | None:
    """The factor a normal draw is multiplied by; None for a norm scale (ones)."""
    if path[-1] == "scale":
        return None
    if path[-1] == "embedding":
        return 0.02
    lead = 1 if "layers" in path else 0
    fan_in = math.prod(shape[lead:lead + (2 if "o_proj" in path else 1)])
    return 1.0 / math.sqrt(fan_in)


def _walk(tree, path, fn):
    if isinstance(tree, dict):
        return {k: _walk(v, path + (k,), fn) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(v, path + (i,), fn) for i, v in enumerate(tree)]
    return fn(tuple(tree), path)


@torch.no_grad()
def dia_weights(model: dict, seed: int, dtype=torch.bfloat16, device="cuda") -> dict:
    """The Dia tree for ``seed``: one normal draw a leaf in ``dtype`` on
    ``device``, scaled in place (norm scales are ones)."""
    g = generator(seed, device, 0)

    def leaf(shape, path):
        scale = dia_leaf_scale(path, shape)
        if scale is None:
            return torch.ones(shape, dtype=dtype, device=device)
        return torch.randn(shape, generator=g, dtype=dtype, device=device).mul_(scale)

    return _walk(dia_shapes(model), (), leaf)


@torch.no_grad()
def dac_weights(dac: dict, seed: int, device="cuda") -> dict:
    """The codec's decode side for ``seed``, float32 (the port decodes in
    float32): conv kernels normal / sqrt(in x k), zero biases, unit alphas,
    normal codebooks."""
    g = generator(seed, device, 1)

    def leaf(shape, path):
        name = path[-1]
        if name == "alpha":
            return torch.ones(shape, device=device)
        if name == "bias":
            return torch.zeros(shape, device=device)
        w = torch.randn(shape, generator=g, device=device)
        if name == "weight":  # conv: [O, I, K], transposed conv: [I, O, K]; fan_in = I x K
            fan_in = (shape[0] if "conv_t" in path else shape[1]) * shape[2]
            w.mul_(1.0 / math.sqrt(fan_in))
        return w

    return _walk(dac_decoder_shapes(dac), (), leaf)
