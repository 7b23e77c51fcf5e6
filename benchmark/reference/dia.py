"""Plain PyTorch reference of Dia-1.6B's inference forward, in float32.

No kernel, no cache, no batching: the encoder over the text, the cross K/V,
the decoder over a whole sequence of delayed token rows at once (causal
self-attention), the CFG combination and the bans of the sampler.  It
follows the published architecture (nari-labs/dia, ``dia/layers.py``) as the
program serves it:

* a decoder input row ``i`` of a request without a voice prompt sits at
  RoPE position ``i + 1`` (the decode loop's step ``t`` feeds row ``t - 1``
  at position ``t``);
* text padding is masked (non-pad keys form a prefix of the conditional
  row); the unconditional row's text is all padding, so its
  cross-attention output is zero;
* norms, RoPE and softmax in float32; every product in float32 with TF32 off
  (``fp32_matmuls``).

A configuration that packs its decoder (``weights="int8"``) is held to the
same packing, recomputed here from the float weights: symmetric per-column
int8 of every decoder kernel (``round(w / s)``, ``s = max|w| / 127`` over
the contracted rows), the products then taken in float32 on the dequantized
values; ``kv_int8`` holds both caches to symmetric int8 per (slot, head),
with each query's own K/V exact, as the program attends them.

Imports nothing of the program.
"""

from __future__ import annotations

import contextlib
import math

import torch

NEG = torch.finfo(torch.float32).min


@contextlib.contextmanager
def fp32_matmuls():
    """Float32 products and convolutions that are float32 (TF32 off)."""
    m, c = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def int8_columns(w: torch.Tensor, n_in: int) -> torch.Tensor:
    """``w`` (float32, ``[K..., N...]`` with ``n_in`` contracted axes) through
    symmetric per-column int8 and back."""
    shape = w.shape
    K = math.prod(shape[:n_in])
    w2 = w.reshape(K, -1)
    s = w2.abs().amax(dim=0, keepdim=True).clamp_min(1e-12) / 127.0
    return (torch.round(w2 / s).clamp(-127, 127) * s).reshape(shape)


def int8_heads(x: torch.Tensor) -> torch.Tensor:
    """K or V ``[..., H]`` through symmetric int8 per head (the last axis) and back."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(x / s) * s


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, pos: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Split-half RoPE on ``x [B, T, N, H]`` at positions ``pos [T]``."""
    H = x.shape[-1]
    frac = 2.0 * torch.arange(H // 2, dtype=torch.float32, device=x.device) / H
    inv = 1.0 / (lo * (hi / lo) ** frac)
    ang = pos.float()[None, :, None, None] * inv
    s, c = torch.sin(ang), torch.cos(ang)
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def attend(q, k, v, causal: bool, exact_k=None, exact_v=None) -> torch.Tensor:
    """Softmax attention, queries [B, T, Nq, H] over keys [B, S, Nkv, H]
    (grouped: query head n G + g reads key head n).  ``causal``: query i
    reads keys 0..i; ``exact_k`` / ``exact_v`` (causal only) replace each
    query's own key and value on the diagonal."""
    B, T, Nq, H = q.shape
    S, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    qg = q.reshape(B, T, Nkv, G, H)
    s = torch.einsum("btngh,bsnh->bngts", qg, k) / math.sqrt(H)
    if exact_k is not None:
        diag = torch.einsum("btngh,btnh->bngt", qg, exact_k) / math.sqrt(H)
        torch.diagonal(s, dim1=-2, dim2=-1).copy_(diag)
    if causal:
        s = s.masked_fill(~torch.ones(T, S, dtype=torch.bool, device=q.device).tril(), NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bngts,bsnh->btngh", p, v)
    if exact_v is not None:
        pd = torch.diagonal(p, dim1=-2, dim2=-1)  # [B, Nkv, G, T]
        out = out + pd.permute(0, 3, 1, 2)[..., None] * (exact_v - v)[:, :, :, None, :]
    return out.reshape(B, T, Nq, H)


def _get(tree, *path):
    for k in path:
        tree = tree[k]
    return tree


def float_weights(params: dict, weights: str) -> dict:
    """The served weights as float32 for the reference; ``weights="int8"``
    passes every decoder kernel through per-column int8 (``o_proj``
    contracts two axes; a layer stack quantizes each layer)."""
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
                continue
            w = v.float()
            if weights == "int8" and k == "kernel" and path[0] == "decoder":
                n_in = 2 if "o_proj" in path else 1
                if "layers" in path:
                    w = torch.stack([int8_columns(w[i], n_in) for i in range(w.shape[0])])
                else:
                    w = int8_columns(w, n_in)
            out[k] = w
        return out

    if weights not in ("bf16", "int8"):
        raise ValueError(f"reference weights: bf16 or int8, got {weights!r}")
    return walk(params, ())


def encoder(W: dict, model: dict, text_ids: torch.Tensor) -> torch.Tensor:
    """The encoder over one text's non-pad bytes ``[n]`` (padding attends
    only padding, so it changes nothing that cross-attention reads).
    Returns [1, n, E]."""
    m = model["model"]
    eps, lo, hi = m["normalization_layer_epsilon"], m["rope_min_timescale"], m["rope_max_timescale"]
    e = W["encoder"]
    x = e["embedding"]["embedding"][text_ids.long()][None]
    pos = torch.arange(text_ids.shape[0], device=x.device)
    lay = e["layers"]
    for i in range(m["encoder"]["n_layer"]):
        sa = lay["self_attention"]
        h = rms_norm(x, lay["pre_sa_norm"]["scale"][i], eps)
        q = rope(torch.einsum("btd,dnh->btnh", h, sa["q_proj"]["kernel"][i]), pos, lo, hi)
        k = rope(torch.einsum("btd,dnh->btnh", h, sa["k_proj"]["kernel"][i]), pos, lo, hi)
        v = torch.einsum("btd,dnh->btnh", h, sa["v_proj"]["kernel"][i])
        a = attend(q, k, v, causal=False)
        x = x + torch.einsum("btnh,nhd->btd", a, sa["o_proj"]["kernel"][i])
        h = rms_norm(x, lay["post_sa_norm"]["scale"][i], eps)
        x = x + mlp(lay["mlp"], i, h)
    return rms_norm(x, e["norm"]["scale"], eps)


def mlp(p: dict, i: int, h: torch.Tensor) -> torch.Tensor:
    gu = torch.einsum("btd,dgf->btgf", h, p["wi_fused"]["kernel"][i])
    return torch.einsum("btf,fd->btd", torch.nn.functional.silu(gu[..., 0, :]) * gu[..., 1, :],
                        p["wo"]["kernel"][i])


def guided_logits(W: dict, model: dict, text_ids: torch.Tensor, rows: torch.Tensor,
                  cfg_scale: float, kv_int8: bool) -> torch.Tensor:
    """The guided logits ``[T, C, V]`` that predict rows 1..T from the
    delayed input rows ``rows [T, C]`` (row i at RoPE position i + 1), with
    the sampler's bans (EOS outside channel 0, PAD and BOS everywhere)."""
    m, d = model["model"], model["data"]
    eps, lo, hi = m["normalization_layer_epsilon"], m["rope_min_timescale"], m["rope_max_timescale"]
    dec = W["decoder"]
    lay = dec["layers"]
    L = m["decoder"]["n_layer"]
    T, C = rows.shape
    dev = rows.device
    enc = encoder(W, model, text_ids)  # [1, n, E]
    n = enc.shape[1]
    enc_pos = torch.arange(n, device=dev)
    emb = dec["embeddings"]["embedding"]
    x1 = sum(emb[c][rows[:, c].long()] for c in range(C))  # [T, D]
    x = torch.stack([x1, x1])  # [uncond; cond]
    pos = torch.arange(1, T + 1, device=dev)
    for i in range(L):
        sa, ca = lay["self_attention"], lay["cross_attention"]
        h = rms_norm(x, lay["pre_sa_norm"]["scale"][i], eps)
        q = rope(torch.einsum("btd,dnh->btnh", h, sa["q_proj"]["kernel"][i]), pos, lo, hi)
        k = rope(torch.einsum("btd,dnh->btnh", h, sa["k_proj"]["kernel"][i]), pos, lo, hi)
        v = torch.einsum("btd,dnh->btnh", h, sa["v_proj"]["kernel"][i])
        if kv_int8:
            a = attend(q, int8_heads(k), int8_heads(v), True, exact_k=k, exact_v=v)
        else:
            a = attend(q, k, v, True)
        x = x + torch.einsum("btnh,nhd->btd", a, sa["o_proj"]["kernel"][i])

        h = rms_norm(x, lay["pre_ca_norm"]["scale"][i], eps)
        cq = rope(torch.einsum("btd,dnh->btnh", h[1:], ca["q_proj"]["kernel"][i]), pos, lo, hi)
        ck = rope(torch.einsum("btd,dnh->btnh", enc, ca["k_proj"]["kernel"][i]), enc_pos, lo, hi)
        cv = torch.einsum("btd,dnh->btnh", enc, ca["v_proj"]["kernel"][i])
        if kv_int8:
            ck, cv = int8_heads(ck), int8_heads(cv)
        ca_out = torch.einsum("btnh,nhd->btd", attend(cq, ck, cv, False), ca["o_proj"]["kernel"][i])
        x = x + torch.cat([torch.zeros_like(ca_out), ca_out])  # the uncond row reads no text

        h = rms_norm(x, lay["pre_mlp_norm"]["scale"][i], eps)
        x = x + mlp(lay["mlp"], i, h)
    x = rms_norm(x, dec["norm"]["scale"], eps)
    logits = torch.einsum("btd,dcv->btcv", x, dec["logits_dense"]["kernel"])
    guided = logits[1] + cfg_scale * (logits[1] - logits[0])
    V = guided.shape[-1]
    col = torch.arange(V, device=dev)[None, :]
    chan = torch.arange(C, device=dev)[:, None]
    ban = ((col == d["audio_eos_value"]) & (chan > 0)) | (col == d["audio_pad_value"]) | (
        col == d["audio_bos_value"])
    return guided.masked_fill(ban, NEG)
