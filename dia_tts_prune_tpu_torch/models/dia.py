"""Dia text→dialogue-speech model (counterpart of ``dia_tts_prune_tpu/models/dia.py``).

Functions over a params dict of tensors in the JAX package's layout:
stacked per-layer weights with a leading ``L`` axis, so a JAX checkpoint maps
one to one (``checkpoint.params_from_jax``).

* Encoder: byte embedding → N pre-norm blocks {RMSNorm → MHA self-attention
  (RoPE, segment mask, flash kernel) → RMSNorm → SwiGLU MLP} → RMSNorm
  (dia/layers.py:419-462).
* Decoder: 9 per-channel embeddings summed → N blocks {RMSNorm → GQA causal
  self-attention (KV cache) → RMSNorm → MHA cross-attention over the static
  text K/V → RMSNorm → SwiGLU MLP} → RMSNorm → logits [C, V]
  (dia/layers.py:465-766).

The KV cache is time-major ``[L, B, T, N, H]``.  Unlike the JAX package,
which returns a new cache from every call, ``decoder_prefill`` and
``decode_step`` write the caller's cache in place — a copy of the cache per
token would dominate the step's memory traffic.  Every decode-step attention
(self and cross) runs the decode-attention kernel over each row's valid slot
range; full-sequence attention (encoder, prompt prefill) runs the flash
kernel.

Decoder kernels may be packed int8/int4 containers (``ops/quant.py``) or
block-sparse ones (``ops/sparse.py``): every function here works unchanged on
such a tree, ``dense_general`` dispatching on the leaf's type.  The caches may be int8 (``QuantKVCache``): prefill quantizes
K/V on the way into the cache, and a decode step attends the quantized prefix
plus its own unquantized K/V before committing them quantized — the order of
the JAX package's ``decode_step_scan`` (:661-745), which the port needs no
separate function for (it has no ``lax.scan``; ``decode_step`` is the one
step for float and packed trees alike).

``decode_step(n_layers=k)`` is the early-exit draft of speculative decoding
(the first k layers, then the shared norm and head), and ``decode_step`` on
W token rows a stream its verify pass (the JAX ``decode_window``): the W
rows in one pass from a cache slot on, each row computing what the step at
its slot computes, through the decode-attention kernel's window form.

A decoder packed with ``quantize_params_int8_packed(fused=True)`` carries a
``fused_pack``, and ``decode_step_fused`` then runs each step's whole stack
as one kernel (``ops/kernels/fused_step.py``); prefill stays on the packed
tree.

Training runs ``encoder_forward(remat=...)`` and ``decoder_forward``: the
same layer bodies, no cache and no in-place write, each layer optionally
rematerialized in the backward pass; every attention goes through the
trainable flash kernels (``ops/modules.py::full_attention``).

Tensor parallelism (``parallel/sharding.py``): every forward that serving
runs takes ``group``, the mesh's model group, over a tree of local shards.
Head counts and FFN widths come from the local weights' shapes, never from
``config``, so the same code runs the whole model or a rank's slice of it;
``attention_out`` and ``mlp_block`` add the ranks' partial sums
(``ops.modules.model_psum``).  Training runs the same layers under autograd:
each replicated activation that enters a column-parallel product passes
``ops.modules.model_copy``, whose backward sums its gradient over the ranks,
and under ``remat`` the recomputed forward issues its all-reduces again
inside the backward pass, in the same order on every rank.  The fused step
has no tensor-parallel form: one cooperative launch cannot all-reduce
between layers.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import DiaConfig
from ..ops.kernels.decode_attention import decode_attention
from ..ops.kernels.fused_step import slot_tensor
from ..ops.modules import (
    attention,
    attention_out,
    attention_qkv,
    dense_general,
    full_attention,
    mlp_block,
    model_copy,
    rms_norm,
    rope,
)

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Stacked per-layer K/V: [L, B, T, N, H]."""

    k: torch.Tensor
    v: torch.Tensor


class QuantKVCache(NamedTuple):
    """int8 K/V with per-(slot, head) symmetric scales: k/v int8
    [L, B, T, N, H], ks/vs fp32 [L, B, T, N].  The decode loop re-reads the
    whole cache every token, so this halves its bytes against bf16; the
    scales stay outside the attention's dots (decode-attention kernel)."""

    k: torch.Tensor
    v: torch.Tensor
    ks: torch.Tensor
    vs: torch.Tensor


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 over the trailing (head-dim) axis: [..., H] →
    (int8 [..., H], fp32 scales [...])."""
    scale = x.abs().amax(dim=-1).clamp_min(1e-12).float() / 127.0
    return torch.round(x.float() / scale[..., None]).to(torch.int8), scale


def quantize_cache(cache: KVCache) -> QuantKVCache:
    """A float cache as an int8 one (the cross cache, once prefill has used it)."""
    kq, ks = quantize_kv(cache.k)
    vq, vs = quantize_kv(cache.v)
    return QuantKVCache(k=kq, v=vq, ks=ks, vs=vs)


def _layer(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked tree; a packed kernel indexes its values
    and scales and keeps its metadata."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def _unstack(layers: Params, n: int) -> list[Params]:
    """The stacked tree as ``n`` per-layer trees.  Tensors are unbound in one
    op, so under autograd a stacked weight's gradient is assembled by one
    ``stack`` of its layers' gradients (indexing layer by layer would add a
    full-size zero-padded tensor per layer)."""
    def parts(v):
        if isinstance(v, dict):
            sub = {k: parts(x) for k, x in v.items()}
            return [{k: x[i] for k, x in sub.items()} for i in range(n)]
        return v.unbind(0) if isinstance(v, torch.Tensor) else [v[i] for i in range(n)]

    return parts(layers)


def _run_layer(fn, remat: bool, *args):
    """``fn(*args)``, rematerialized in the backward pass when ``remat``
    (the JAX package's ``jax.checkpoint`` on its layer scans): only the
    layer's inputs are kept, and its forward — attention kernels included —
    runs a second time during backward."""
    if remat and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint

        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def param_shapes(config: DiaConfig) -> Params:
    """The shape of every leaf of ``init_params``'s tree (the JAX package's
    layout), as tuples, in the tree's order: stacked per-layer kernels
    ``[L, in..., out...]``, embeddings, norm scales, the logits head."""
    m = config.model
    enc, dec = m.encoder, m.decoder
    C = config.data.channels

    def attn(L, d_q, d_kv, nq, nkv, h):
        return {"q_proj": {"kernel": (L, d_q, nq, h)}, "k_proj": {"kernel": (L, d_kv, nkv, h)},
                "v_proj": {"kernel": (L, d_kv, nkv, h)}, "o_proj": {"kernel": (L, nq, h, d_q)}}

    def mlp(L, d, f):
        return {"wi_fused": {"kernel": (L, d, 2, f)}, "wo": {"kernel": (L, f, d)}}

    def norm(*shape):
        return {"scale": shape}

    return {
        "encoder": {
            "embedding": {"embedding": (m.src_vocab_size, enc.n_embd)},
            "layers": {
                "pre_sa_norm": norm(enc.n_layer, enc.n_embd),
                "self_attention": attn(enc.n_layer, enc.n_embd, enc.n_embd, enc.n_head,
                                       enc.n_head, enc.head_dim),
                "post_sa_norm": norm(enc.n_layer, enc.n_embd),
                "mlp": mlp(enc.n_layer, enc.n_embd, enc.n_hidden),
            },
            "norm": norm(enc.n_embd),
        },
        "decoder": {
            "embeddings": {"embedding": (C, m.tgt_vocab_size, dec.n_embd)},
            "layers": {
                "pre_sa_norm": norm(dec.n_layer, dec.n_embd),
                "self_attention": attn(dec.n_layer, dec.n_embd, dec.n_embd, dec.gqa_query_heads,
                                       dec.kv_heads, dec.gqa_head_dim),
                "pre_ca_norm": norm(dec.n_layer, dec.n_embd),
                "cross_attention": attn(dec.n_layer, dec.n_embd, enc.n_embd,
                                        dec.cross_query_heads, dec.cross_query_heads,
                                        dec.cross_head_dim),
                "pre_mlp_norm": norm(dec.n_layer, dec.n_embd),
                "mlp": mlp(dec.n_layer, dec.n_embd, dec.n_hidden),
            },
            "norm": norm(dec.n_embd),
            "logits_dense": {"kernel": (dec.n_embd, C, m.tgt_vocab_size)},
        },
    }


def init_params(config: DiaConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> Params:
    """Random weights from a numpy seed in ``param_shapes``: kernels normal /
    sqrt(fan_in) (fan_in the contracted axes after a layer stack: two for
    ``o_proj``), embeddings normal x 0.02, norm scales ones, drawn in the
    tree's order, for runs at full width without a checkpoint.  The draws
    differ from ``jax.random``'s; tests that need equal weights in both
    packages use ``checkpoint.params_from_jax``."""
    rng = np.random.default_rng(seed)

    def leaf(shape, path):
        if path[-1] == "scale":
            a = np.ones(shape, np.float32)
        else:
            a = rng.standard_normal(size=shape, dtype=np.float32)
            if path[-1] == "embedding":
                a *= np.float32(0.02)
            else:
                lead = 1 if "layers" in path else 0
                fan_in = int(np.prod(shape[lead:lead + (2 if "o_proj" in path else 1)]))
                a *= np.float32(1.0 / np.sqrt(fan_in))
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def walk(tree, path):
        return {k: walk(v, path + (k,)) if isinstance(v, dict) else leaf(v, path + (k,))
                for k, v in tree.items()}

    return walk(param_shapes(config), ())


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_forward(
    params: Params,
    config: DiaConfig,
    x_ids: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T]
    compute_dtype=torch.float32,
    remat: bool = False,
    group=None,
) -> torch.Tensor:
    """Encoder stack (reference: dia/layers.py:445-462).  Returns [B, T, D].
    The padding mask is the flash kernel's segment ids (pad attends pad,
    non-pad attends non-pad).  ``remat`` rematerializes each layer in the
    backward pass (training memory against a second forward).  ``group``:
    the mesh's model group over local shards (module docstring)."""
    m = config.model
    eps = m.normalization_layer_epsilon
    x = params["encoder"]["embedding"]["embedding"][x_ids.long()].to(compute_dtype)
    seg = (x_ids != config.data.text_pad_value).to(torch.int32)

    def layer_fn(x, lp):
        h = rms_norm(x, lp["pre_sa_norm"]["scale"], eps)
        sa = attention(lp["self_attention"], h, h, positions, positions,
                       m.rope_min_timescale, m.rope_max_timescale, False, seg, seg, group)
        x = x + sa.to(x.dtype)
        h = rms_norm(x, lp["post_sa_norm"]["scale"], eps)
        return x + mlp_block(lp["mlp"], h, group).to(x.dtype)

    for lp in _unstack(params["encoder"]["layers"], m.encoder.n_layer):
        x = _run_layer(layer_fn, remat, x, lp)
    return rms_norm(x, params["encoder"]["norm"]["scale"], eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _embed_channels(params: Params, tgt_BxTxC: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Sum the per-channel codebook embeddings (reference: dia/layers.py:690-697)."""
    embs = params["decoder"]["embeddings"]["embedding"]  # [C, V, D]
    ids = tgt_BxTxC.long()
    per_channel = torch.stack([embs[c][ids[..., c]] for c in range(embs.shape[0])])
    return per_channel.sum(dim=0).to(compute_dtype)


def precompute_cross_cache(
    params: Params,
    config: DiaConfig,
    enc_out: torch.Tensor,  # [B, S, E]
    enc_positions: torch.Tensor,  # [B, S]
    group=None,
) -> KVCache:
    """Static cross-attention K/V for all layers (reference: dia/layers.py:632-669):
    RoPE on keys with encoder positions, raw value projections.  [L, B, S, N, H],
    N the heads of the given weights (a rank's own under a mesh).  Under a
    model ``group`` the gradient of ``enc_out``, every layer's share added
    first, is summed over its ranks (one ``model_copy``: a copy a layer
    would add the layers' shares in another order, and a one-rank mesh
    would then leave one process's bits)."""
    m = config.model
    ca = params["decoder"]["layers"]["cross_attention"]
    enc = model_copy(enc_out, group)
    ks, vs = [], []
    for lp in _unstack({"k": ca["k_proj"]["kernel"], "v": ca["v_proj"]["kernel"]},
                       m.decoder.n_layer):
        k = dense_general(enc, lp["k"])
        ks.append(rope(k, enc_positions, m.rope_min_timescale, m.rope_max_timescale))
        vs.append(dense_general(enc, lp["v"]))
    return KVCache(k=torch.stack(ks), v=torch.stack(vs))


def new_self_cache(params: Params, config: DiaConfig, batch: int, max_len: int | None = None,
                   dtype=torch.float32, device: str | torch.device = "cuda",
                   quant: bool = False) -> KVCache | QuantKVCache:
    """Preallocated decoder self-attention cache [L, B, T, Nkv, H]
    (reference: dia/state.py:72-109, time-major) for the weights ``params``:
    Nkv their KV heads (``local_heads``, a rank's own under a mesh).
    ``quant`` allocates the int8 + per-slot-scale layout (``QuantKVCache``)."""
    dec = config.model.decoder
    T = max_len if max_len is not None else config.data.audio_length
    shape = (dec.n_layer, batch, T, local_heads(params), dec.gqa_head_dim)
    if quant:
        return QuantKVCache(k=torch.zeros(shape, dtype=torch.int8, device=device),
                            v=torch.zeros(shape, dtype=torch.int8, device=device),
                            ks=torch.zeros(shape[:-1], dtype=torch.float32, device=device),
                            vs=torch.zeros(shape[:-1], dtype=torch.float32, device=device))
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def local_heads(params: Params, attention: str = "self_attention") -> int:
    """The KV heads of a decoder attention's weights: the config's on a
    whole tree, a rank's share on a sharded one.  The one place that a
    cache's head count comes from."""
    kernel = params["decoder"]["layers"][attention]["k_proj"]["kernel"]
    shape = kernel.shape if torch.is_tensor(kernel) else (None, None, *kernel.out_shape)
    return int(shape[2])


def _decoder_layer_full(lp: Params, m, x, dec_positions, cross_k, cross_v, is_causal: bool,
                        dec_segment_ids, cross_q_segment_ids, enc_segment_ids, group=None):
    """One decoder block on a full sequence (the JAX package's
    ``_decoder_layer_full`` :324): flash self-attention, flash
    cross-attention, MLP.  Returns (x, self_k, self_v); writes nothing in
    place, so it is safe under autograd.  Under a model ``group`` the inputs
    of the column-parallel products pass ``model_copy`` (their gradients
    summed over the ranks)."""
    eps = m.normalization_layer_epsilon
    h = model_copy(rms_norm(x, lp["pre_sa_norm"]["scale"], eps), group)
    q, k, v = attention_qkv(lp["self_attention"], h, h, dec_positions, dec_positions,
                            m.rope_min_timescale, m.rope_max_timescale)
    sa = full_attention(q, k, v, is_causal, dec_segment_ids, dec_segment_ids)
    x = x + attention_out(lp["self_attention"], sa, group).to(x.dtype)

    h = model_copy(rms_norm(x, lp["pre_ca_norm"]["scale"], eps), group)
    cq = dense_general(h, lp["cross_attention"]["q_proj"]["kernel"])
    cq = rope(cq, dec_positions, m.rope_min_timescale, m.rope_max_timescale)
    ca = full_attention(cq, cross_k, cross_v, False, cross_q_segment_ids, enc_segment_ids)
    x = x + attention_out(lp["cross_attention"], ca, group).to(x.dtype)

    h = rms_norm(x, lp["pre_mlp_norm"]["scale"], eps)
    x = x + mlp_block(lp["mlp"], h, group).to(x.dtype)
    return x, k, v


def decoder_forward(
    params: Params,
    config: DiaConfig,
    tgt_BxTxC: torch.Tensor,  # [B, T, C]
    enc_out: torch.Tensor,  # [B, S, E]
    enc_positions: torch.Tensor,  # [B, S]
    dec_positions: torch.Tensor,  # [B, T]
    enc_padding_mask: torch.Tensor,  # bool [B, S]
    compute_dtype=torch.float32,
    return_kv: bool = False,
    remat: bool = False,
    group=None,
):
    """Full-sequence decoder pass for teacher-forced training (reference:
    dia/layers.py:722-766; the JAX package's ``decoder_forward`` :360 on its
    flash route).  Causal self-attention over every row (segment = ones),
    cross-attention from every row to the text's non-pad keys.  Differentiable:
    nothing is written in place.  Returns logits [B, T, C, V] fp32, and with
    ``return_kv`` also the stacked self-attention K/V ([L, B, T, Nkv, H]).
    The JAX signature's mask arguments have no counterpart: the segment ids
    carry the same masks to the flash kernels.  ``group``: the mesh's model
    group over local shards (module docstring)."""
    m = config.model
    cross = precompute_cross_cache(params, config, enc_out, enc_positions, group)
    x = _embed_channels(params, tgt_BxTxC, compute_dtype)
    dec_seg = torch.ones(tgt_BxTxC.shape[:2], dtype=torch.int32, device=x.device)
    enc_seg = enc_padding_mask.to(torch.int32)

    def layer_fn(x, lp, ck, cv):
        return _decoder_layer_full(lp, m, x, dec_positions, ck, cv, True, dec_seg, dec_seg,
                                   enc_seg, group)

    ks, vs = [], []
    layers = _unstack(params["decoder"]["layers"], m.decoder.n_layer)
    for lp, ck, cv in zip(layers, cross.k.unbind(0), cross.v.unbind(0)):
        x, k, v = _run_layer(layer_fn, remat, x, lp, ck, cv)
        if return_kv:
            ks.append(k)
            vs.append(v)
    x = rms_norm(x, params["decoder"]["norm"]["scale"], m.normalization_layer_epsilon)
    logits = dense_general(x, params["decoder"]["logits_dense"]["kernel"]).float()
    if return_kv:
        return logits, KVCache(k=torch.stack(ks), v=torch.stack(vs))
    return logits


def decoder_prefill(
    params: Params,
    config: DiaConfig,
    tgt_BxTxC: torch.Tensor,  # [B, P, C]
    dec_positions: torch.Tensor,  # [B, P]
    cross_cache: KVCache,
    self_cache: KVCache | QuantKVCache,
    dec_segment_ids: torch.Tensor,  # int [B, P]: 1 = valid prompt row
    enc_segment_ids: torch.Tensor,  # int [B, S]: text padding mask
    compute_dtype=torch.float32,
    group=None,  # the mesh's model group over local shards
) -> torch.Tensor:
    """Prefill the self-attention cache from prompt tokens: causal flash
    self-attention (segment = valid row) and flash cross-attention (segment =
    text non-pad), K/V written into cache slots [0, P) in place, quantized on
    the way into a ``QuantKVCache``.  The cross cache is float here.  Returns
    logits [B, P, C, V] fp32 (reference: dia/model.py:403-419, without its
    prefill off-by-one, quirk Q5)."""
    m = config.model
    P = tgt_BxTxC.shape[1]
    x = _embed_channels(params, tgt_BxTxC, compute_dtype)
    ones = torch.ones_like(dec_segment_ids)
    layers = params["decoder"]["layers"]
    for i in range(m.decoder.n_layer):
        x, k, v = _decoder_layer_full(_layer(layers, i), m, x, dec_positions, cross_cache.k[i],
                                      cross_cache.v[i], True, dec_segment_ids, ones,
                                      enc_segment_ids, group)
        if isinstance(self_cache, QuantKVCache):
            self_cache.k[i, :, :P], self_cache.ks[i, :, :P] = quantize_kv(k)
            self_cache.v[i, :, :P], self_cache.vs[i, :, :P] = quantize_kv(v)
        else:
            self_cache.k[i, :, :P] = k.to(self_cache.k.dtype)
            self_cache.v[i, :, :P] = v.to(self_cache.v.dtype)
    x = rms_norm(x, params["decoder"]["norm"]["scale"], m.normalization_layer_epsilon)
    return dense_general(x, params["decoder"]["logits_dense"]["kernel"]).float()


def _commit(cache: KVCache | QuantKVCache, layer: int | None, flat_slots: torch.Tensor,
            k: torch.Tensor, v: torch.Tensor) -> None:
    """This token's K/V [B, Nkv, H] (``layer`` None: [L, B, Nkv, H], every
    layer) into the cache, row b at its own slot, in place and quantized for
    an int8 cache.  ``flat_slots`` (``write_slots``; int64 [B] on the
    device) indexes the cache's row and slot axes viewed as one, so that
    one ``index_copy_`` a cache tensor writes every row, with the slots read
    from device memory: a captured CUDA graph's replays write each step's
    own slots.  The indices are distinct, so the write is deterministic."""
    at = slice(None) if layer is None else layer
    axis = 1 if layer is None else 0  # the merged (row, slot) axis of flat[at]
    if isinstance(cache, QuantKVCache):
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        pairs = ((cache.k, kq), (cache.ks, ks), (cache.v, vq), (cache.vs, vs))
    else:
        pairs = ((cache.k, k), (cache.v, v))
    for dst, src in pairs:  # view, never a copy: it raises where the axes do not merge
        flat = dst.view(dst.shape[0], -1, *dst.shape[3:])
        flat[at].index_copy_(axis, flat_slots, src.to(dst.dtype))


def write_slots(write_slot, batch: int, cache_len: int,
                device) -> tuple[torch.Tensor, torch.Tensor]:
    """``write_slot`` as one int64 slot a row [B] on ``device``, and the
    same slots as ``_commit``'s indices into a cache's row and slot axes
    viewed as one (``b * cache_len + slot[b]``).  An int or a one-element
    tensor is every row's slot (``slot_tensor``, expanded), a [B] tensor row
    b's own (the JAX ``decode_step_scan``'s ``[B]`` ``write_slot``)."""
    if torch.is_tensor(write_slot) and write_slot.numel() > 1:
        if write_slot.numel() != batch:
            raise ValueError(f"write_slot has {write_slot.numel()} slots for {batch} rows")
        slots = write_slot.reshape(batch).to(device=device, dtype=torch.int64)
    else:
        slots = slot_tensor(write_slot, device).long().expand(batch)
    return slots, slots + torch.arange(0, batch * cache_len, cache_len, device=device)


def decode_step(
    params: Params,
    config: DiaConfig,
    tgt_BxWxC: torch.Tensor,  # [B, W, C]: W = 1 the loop's step, W > 1 a window
    position: torch.Tensor,  # [B, W] RoPE positions of these tokens
    write_slot,  # int, int [1] or int [B] tensor: cache slot of the first row (== #valid slots - 1)
    self_cache: KVCache | QuantKVCache,
    cross_cache: KVCache | QuantKVCache,
    cross_ends: torch.Tensor,  # int32 [B]: text keys per row (0 = fully masked)
    compute_dtype=torch.float32,
    valid_from: torch.Tensor | None = None,  # int32 [B]: first valid self-cache slot
    n_layers: int | None = None,  # run only the first n layers (early exit)
    group=None,  # the mesh's model group over local shards
) -> torch.Tensor:
    """Autoregressive decode step (reference: dia/layers.py:671-720).
    Writes this token's K/V into slot ``write_slot`` of every layer (in
    place) and returns logits [B, W, C, V] fp32.

    ``n_layers`` (the JAX ``decode_step_scan``'s, :577) truncates the stack
    to an early-exit draft model (``speculative.py``): only the first
    ``n_layers`` layers run and only their cache slots are written; the
    shared final norm and logits head give the draft's logits.

    Self-attention reads slots [valid_from[b], write_slot] (``valid_from``
    None: from slot 0); cross-attention reads each row's first
    ``cross_ends[b]`` text keys — both through the decode-attention kernel.
    ``valid_from`` serves batched voice prompts of different lengths
    (the JAX ``decode_step``'s argument, :475): streams are left-padded so
    that all prompts end on one slot, and each row's pad slots stay out of
    its attention.  With an int8 self cache the step attends the
    quantized slots [0, write_slot) and this token's own unquantized K/V, and
    then writes them quantized (``decode_step_scan``'s order: quantizing
    first would change the last token's share).  The JAX step's
    ``skip_uncond_cross`` has no counterpart: the CFG unconditional row has ``cross_ends == 0``, and for
    such a row every block of the kernel skips the cache and the combine pass
    writes exact zeros, so that row already reads no keys or values.

    ``write_slot`` may live on the device (the JAX ``decode_step_scan``'s
    traced slot): the attention ends come from it and the K/V commits index
    with it, so a CUDA graph that captures the step replays it at each
    step's own slot.  The slot is one a row (``write_slots``; the JAX
    ``decode_step_scan``'s per-row ``write_slot``): row b attends
    ``[valid_from[b], slot[b]]`` (``[.., slot[b])`` and its own K/V with an
    int8 cache) and commits at ``slot[b]``.  An int or a one-element tensor
    is every row's slot (streams in lockstep), a [B] tensor gives each row
    its own (continuous batching: each stream on its own timeline): one
    path.

    W > 1 token rows a stream are a window, teacher-forced (speculative
    decoding's verify pass, the JAX ``decode_window``, :755; with
    ``n_layers`` its draft q pass, ``decode_step_scan_window_q``, :253):
    row ``i`` writes slot ``slot[b] + i`` and attends through it, so it
    computes what the step at that slot computes from the same cache — on
    the card bit for bit: per layer the W rows' K/V are committed first,
    then each query row attends its own range through the decode-attention
    kernel's window form, and every product through a kernel whose rows keep
    their bits at any row count (``dense_general(decode=True)``, the norms'
    kernel).  A window takes float self and cross caches only (the JAX
    speculative path's ``kv_quant=False``); like the JAX function, it takes
    any W."""
    m = config.model
    eps = m.normalization_layer_epsilon
    B, W = tgt_BxWxC.shape[:2]
    dev = tgt_BxWxC.device
    quant = isinstance(self_cache, QuantKVCache)
    if W > 1 and (quant or isinstance(cross_cache, QuantKVCache)):
        raise ValueError("decode_step: a window (W > 1 rows) takes float self and cross caches")
    slots, flat_slots = write_slots(write_slot, B, self_cache.k.shape[2], dev)
    if W > 1:  # query row (b, i) writes slot slot[b] + i and attends through it
        offs = torch.arange(W, device=dev)
        slots, flat_slots = ((t[:, None] + offs).reshape(B * W) for t in (slots, flat_slots))

    def per_query(t):  # [B] -> [B·W]: each stream's value for its W query rows
        return t if W == 1 else t.repeat_interleave(W)

    self_start = (torch.zeros(B * W, dtype=torch.int32, device=dev) if valid_from is None
                  else per_query(valid_from.to(device=dev, dtype=torch.int32)).contiguous())
    self_end = (slots + (0 if quant else 1)).to(torch.int32).contiguous()
    cross_end = per_query(cross_ends)
    cross_start = torch.zeros_like(cross_end)

    def rows(t):  # [B, W, ...] -> the kernel's B·W query rows
        return t.flatten(0, 1)

    x = _embed_channels(params, tgt_BxWxC, compute_dtype)  # [B, W, D]
    layers = params["decoder"]["layers"]
    for i in range(_depth(m.decoder.n_layer, n_layers)):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["pre_sa_norm"]["scale"], eps)
        q, k, v = attention_qkv(lp["self_attention"], h, h, position, position,
                                m.rope_min_timescale, m.rope_max_timescale, decode=True)
        if quant:
            k1, v1 = rows(k).contiguous(), rows(v).contiguous()
            sa = decode_attention(rows(q).contiguous(), self_cache.k[i], self_cache.v[i],
                                  self_start, self_end, self_cache.ks[i], self_cache.vs[i],
                                  k1, v1)
            _commit(self_cache, i, flat_slots, k1, v1)
        else:
            _commit(self_cache, i, flat_slots, rows(k), rows(v))
            sa = decode_attention(rows(q).contiguous(), self_cache.k[i], self_cache.v[i],
                                  self_start, self_end, queries_per_row=W)
        x = x + attention_out(lp["self_attention"], sa.unflatten(0, (B, W)), group, decode=True)

        h = rms_norm(x, lp["pre_ca_norm"]["scale"], eps)
        cq = dense_general(h, lp["cross_attention"]["q_proj"]["kernel"], decode=True)
        cq = rope(cq, position, m.rope_min_timescale, m.rope_max_timescale)
        ca = decode_attention(rows(cq).contiguous(), cross_cache.k[i], cross_cache.v[i],
                              cross_start, cross_end, *(t[i] for t in cross_cache[2:]),
                              queries_per_row=W)
        x = x + attention_out(lp["cross_attention"], ca.unflatten(0, (B, W)), group, decode=True)

        h = rms_norm(x, lp["pre_mlp_norm"]["scale"], eps)
        x = x + mlp_block(lp["mlp"], h, group, decode=True)

    x = rms_norm(x, params["decoder"]["norm"]["scale"], eps)
    return dense_general(x, params["decoder"]["logits_dense"]["kernel"], decode=True).float()


def _depth(n_layer: int, n_layers: int | None) -> int:
    """The layers an early-exit pass runs: ``n_layers`` of the ``n_layer``, all of them for None."""
    if n_layers is None:
        return n_layer
    if not 1 <= n_layers <= n_layer:
        raise ValueError(f"n_layers must be in [1, {n_layer}], got {n_layers}")
    return int(n_layers)


def decode_step_fused(
    params: Params,
    config: DiaConfig,
    tgt_Bx1xC: torch.Tensor,  # [B, 1, C]
    position: torch.Tensor,  # [B, 1] RoPE position of this token
    write_slot,  # int or int [1] tensor: cache slot to write (== #valid slots - 1)
    self_cache: KVCache | QuantKVCache,
    cross_cache: KVCache | QuantKVCache,
    cross_ends: torch.Tensor,  # int32 [B]: text keys per row (0 = fully masked)
    compute_dtype=torch.float32,
    valid_from: torch.Tensor | None = None,  # int32 [B]: first valid self-cache slot
    group=None,
) -> torch.Tensor:
    """``decode_step`` through the fused whole-decoder-step kernel (the JAX
    ``decode_step_fused``, :868): channel embeddings → the kernel over
    ``params["decoder"]["fused_pack"]`` (``ops.quant.quantize_params_int8_packed(
    fused=True)``) → this token's K/V committed into slot ``write_slot`` of
    every layer, in place, quantized for an int8 cache (the kernel attends
    them unquantized, as ``decode_step`` does) → the final norm and the
    logits head.  Same arguments and results as ``decode_step``; a model
    ``group`` raises (one cooperative launch cannot all-reduce between
    layers)."""
    from ..ops.kernels.fused_step import fused_decode_step

    if group is not None:
        raise NotImplementedError("the fused decode step has no tensor-parallel form: one "
                                  "cooperative launch cannot all-reduce between layers")

    m = config.model
    eps = m.normalization_layer_epsilon
    dev = tgt_Bx1xC.device
    quant = isinstance(self_cache, QuantKVCache)
    if quant != isinstance(cross_cache, QuantKVCache):
        raise ValueError("decode_step_fused: the self and cross caches must both be int8 "
                         "or both float")
    x = _embed_channels(params, tgt_Bx1xC, compute_dtype)[:, 0]  # [B, D]
    vf = None if valid_from is None else valid_from.to(device=dev, dtype=torch.int32)
    x_out, k_new, v_new = fused_decode_step(
        params["decoder"]["fused_pack"], x, position[:, 0], write_slot, self_cache.k,
        self_cache.v, cross_cache.k, cross_cache.v, cross_ends, eps, m.rope_min_timescale,
        m.rope_max_timescale, vf, *self_cache[2:], *cross_cache[2:])
    _, flat_slots = write_slots(write_slot, x.shape[0], self_cache.k.shape[2], dev)
    _commit(self_cache, None, flat_slots, k_new, v_new)
    h = rms_norm(x_out[:, None].to(compute_dtype), params["decoder"]["norm"]["scale"], eps)
    return dense_general(h, params["decoder"]["logits_dense"]["kernel"], decode=True).float()
