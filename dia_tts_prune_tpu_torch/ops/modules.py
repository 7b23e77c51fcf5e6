"""Core model ops: generalized dense, RMSNorm, RoPE, SwiGLU MLP, attention.

PyTorch counterparts of ``dia_tts_prune_tpu/ops/modules.py`` (float and
packed int8/int4 weights), as plain functions over a params dict of tensors
in the JAX layout:

* ``dense_general`` contracts the trailing axes of ``x`` against the leading
  axes of a kernel stored ``in_shapes + out_features`` (reference:
  dia/layers.py:35-66), one ``tensordot`` (on the card, up to 64 rows at
  exactly 64: ``fixed_rows_matmul``); a packed kernel
  (``ops/quant.py``) goes to the int8-matmul or int4-GEMV kernel, a
  block-sparse one (``ops/sparse.py``) to the block-sparse matmul;
* GQA attention reshapes queries to [B, T, Nkv, G, H] and contracts them
  against un-repeated K/V;
* norms, the SiLU gate, RoPE trig and softmax run in float32 whatever the
  compute dtype (reference: dia/layers.py:101,161-173,393).

A float32 contraction on the card must stay true fp32: PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False`` gives that; callers that
measure parity set it explicitly.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import torch
import torch.nn.functional as F

from .kernels.flash_attention import flash_attention, flash_attention_trainable
from .kernels.int4_gemv import int4_gemv
from .kernels.int8_matmul import MAX_ROWS, int8_matmul
from .kernels.sparse_matmul import block_sparse_matmul
from .quant import Quantized4Kernel, QuantizedKernel, dequantize4
from .sparse import BlockSparseKernel

Params = dict[str, Any]

NEG = torch.finfo(torch.float32).min


def dense_general(x: torch.Tensor, kernel, axis: tuple[int, ...] = (-1,)) -> torch.Tensor:
    """Contract ``axis`` of ``x`` against the leading axes of ``kernel``
    (reference: dia/layers.py:55-66).  No bias.  ``kernel`` is a tensor, a
    packed ``QuantizedKernel`` / ``Quantized4Kernel`` or a
    ``BlockSparseKernel`` (trailing axes only)."""
    if isinstance(kernel, (QuantizedKernel, Quantized4Kernel)):
        return _dense_general_packed(x, kernel, axis)
    if isinstance(kernel, BlockSparseKernel):
        return _dense_general_sparse(x, kernel, axis)
    n_in = len(axis)
    norm_axis = [ax if ax >= 0 else x.dim() + ax for ax in axis]
    x = x.to(kernel.dtype)
    lead = x.shape[: x.dim() - n_in]
    if x.is_cuda and norm_axis == list(range(x.dim() - n_in, x.dim())) \
            and math.prod(lead) <= MAX_ROWS:
        K = math.prod(x.shape[x.dim() - n_in:])
        y = fixed_rows_matmul(x.reshape(-1, K), kernel.reshape(K, -1))
        return y.reshape(*lead, *kernel.shape[n_in:])
    return torch.tensordot(x, kernel, dims=(norm_axis, list(range(n_in))))


def fixed_rows_matmul(x2: torch.Tensor, w2: torch.Tensor) -> torch.Tensor:
    """``x2 @ w2`` for up to ``MAX_ROWS`` rows (every float contraction of a
    decode step), computed at exactly ``MAX_ROWS`` rows, the rest zeros.
    cuBLAS picks its algorithm, and with it the order in which each output
    sums, by the row count: at 2 rows against 4 it sums Dia-1.6B's logits
    head (2048 x 9252) in another order, so a batched stream's logits left
    its single-stream run's by a bf16 step.  At one row count a row's bits do
    not depend on the rows beside it, for any batch of up to 32 streams."""
    rows = x2.shape[0]
    return (F.pad(x2, (0, 0, 0, MAX_ROWS - rows)) @ w2)[:rows]


def _dense_general_packed(x: torch.Tensor, qk, axis: tuple[int, ...]) -> torch.Tensor:
    """Contraction against a packed kernel; activations keep their dtype.

    The route follows the JAX dispatcher's own rule (its ops/modules.py:160,
    ops/kernels/int4_gemv.py:98), by shape and device only:

    * up to 64 rows — every contraction of a decode step — the int8-matmul
      or int4-GEMV wrapper: the CUDA kernel on the card, the plain version
      on the CPU;
    * more rows on the card (prompt prefill, the cross-attention K/V of the
      text) are large matrix products, which the JAX package also computes
      outside any Pallas kernel (``int8_matmul_upcast``,
      ``int4_matmul_halfsplit*``): the weight is widened to ``x.dtype`` and
      goes to ``torch.matmul``; int8 scales multiply the fp32 result, int4
      scales (per group) are folded into the widened weight.
    """
    n_in = len(axis)
    if n_in != len(qk.in_shape):
        raise ValueError(
            f"kernel packed for {len(qk.in_shape)} contraction axes, called with {n_in}")
    K, N = math.prod(qk.in_shape), math.prod(qk.out_shape)
    lead = x.shape[: x.dim() - n_in]
    x2 = x.reshape(-1, K).contiguous()
    int8 = isinstance(qk, QuantizedKernel)
    if x2.is_cuda and x2.shape[0] > MAX_ROWS:
        if int8:
            y = ((x2 @ qk.values.to(x2.dtype)).float() * qk.scale.reshape(1, N)).to(x2.dtype)
        else:
            y = x2 @ dequantize4(qk, x2.dtype).reshape(K, N)
    elif int8:
        y = int8_matmul(x2, qk.values, qk.scale.reshape(N))
    else:
        y = int4_gemv(x2, qk.values, qk.scale, qk.layout)
    return y.reshape(*lead, *qk.out_shape)


def _dense_general_sparse(x: torch.Tensor, sk: BlockSparseKernel,
                          axis: tuple[int, ...]) -> torch.Tensor:
    """Contraction against a block-sparse kernel (the JAX package's
    ``_dense_general_sparse``, its ops/modules.py:185): ``x`` cast to the
    values' dtype, its trailing axes flattened to K, the block-sparse matmul
    at every row count — decode steps, prompt prefill and the cross K/V
    projection alike, as the JAX dispatcher sends them all to its Pallas
    kernel — and the result shaped to the kernel's output dims."""
    n_in = len(axis)
    if n_in != len(sk.in_shape):
        raise ValueError(
            f"kernel packed for {len(sk.in_shape)} contraction axes, called with {n_in}")
    K = math.prod(sk.in_shape)
    lead = x.shape[: x.dim() - n_in]
    x2 = x.reshape(-1, K).to(sk.values.dtype).contiguous()
    y = block_sparse_matmul(x2, sk.values, sk.indices, sk.counts, sk.block_k, sk.block_n)
    return y.reshape(*lead, *sk.out_shape)


NORM_PARTS = 16  # partial means a row's mean of squares is taken from


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in float32 (reference: torch.nn.RMSNorm at dia/layers.py:360-393).

    The mean of squares is the mean of ``NORM_PARTS`` partial means of a
    row's consecutive values.  A CUDA reduction's launch shape — how many
    threads share an output, and so the order its sum is taken in — follows
    its output count, and from 16 outputs on it no longer changes: split so,
    a row's bits do not depend on how many rows the call holds (a decode step
    holds two a stream, so a batched stream would otherwise leave its
    single-stream run).  The width must be a multiple of ``NORM_PARTS``."""
    D = x.shape[-1]
    if D % NORM_PARTS:
        raise ValueError(f"rms_norm width {D} is not a multiple of {NORM_PARTS}")
    x32 = x.float()
    var = x32.square().unflatten(-1, (NORM_PARTS, D // NORM_PARTS)).mean(-1).mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(
    x: torch.Tensor,  # [B, T, N, H]
    position: torch.Tensor,  # [B, T]
    min_timescale: float,
    max_timescale: float,
) -> torch.Tensor:
    """Split-half rotary embedding with fp32 trig, broadcast over heads:
    ``[x1*cos - x2*sin, x1*sin + x2*cos]`` with
    ``freq[i] = position / (min * (max/min)^(2i/H))``."""
    inv_freq = _inv_freq(x.shape[-1], float(min_timescale), float(max_timescale), x.device)
    freqs = position.float()[:, :, None, None] * inv_freq  # [B, T, 1, H/2]
    sin, cos = torch.sin(freqs), torch.cos(freqs)
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(x.dtype)


@functools.lru_cache(maxsize=32)
def _inv_freq(H: int, min_timescale: float, max_timescale: float,
              device: torch.device) -> torch.Tensor:
    """RoPE inverse frequencies [H/2], computed once per (H, device) on the
    CPU in fp32 — the same numbers on every device, and no host→device copy
    (which would wait for the queued work) inside the decode loop."""
    fraction = 2.0 * torch.arange(H // 2, dtype=torch.float32) / H
    base = torch.tensor(max_timescale / min_timescale, dtype=torch.float32)
    return (1.0 / (min_timescale * base ** fraction)).to(device)


def mlp_block(params: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU MLP with the fused gate/up kernel [D, 2, F] (reference:
    dia/layers.py:69-105); SiLU on the gate runs in float32."""
    fused = dense_general(x, params["wi_fused"]["kernel"])  # [..., 2, F]
    gate, up = fused[..., 0, :], fused[..., 1, :]
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return dense_general(hidden, params["wo"]["kernel"])


def sdpa(
    q: torch.Tensor,  # [B, Tq, Nq, H]
    k: torch.Tensor,  # [B, Tk, Nkv, H]
    v: torch.Tensor,  # [B, Tk, Nkv, H]
    mask: torch.Tensor | None,  # bool, broadcastable to [B, 1, Tq, Tk]; True = attend
    is_causal: bool = False,
) -> torch.Tensor:
    """Plain scaled dot-product attention with GQA and an fp32 softmax
    (``F.scaled_dot_product_attention`` semantics as the reference uses it,
    dia/layers.py:329-337).  Fully masked rows give exact zeros (the CFG
    unconditional row's cross-attention).  Returns [B, Tq, Nq, H] in q.dtype.

    The port's attention paths go through the kernels; this is the plain
    arithmetic their CPU versions share."""
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    qg = q.reshape(B, Tq, Nkv, G, H).float()
    scores = torch.einsum("btngh,bsnh->bngts", qg, k.float()) * (1.0 / math.sqrt(H))
    if mask is not None:
        m = mask[:, :, None, :, :] if mask.dim() == 4 else mask  # [B, 1, 1, Tq, Tk]
        scores = scores.masked_fill(~m, NEG)
    if is_causal:
        causal = torch.ones(Tq, Tk, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~causal, NEG)
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(row_max <= NEG * 0.5, torch.zeros_like(row_max), row_max)
    unnorm = torch.exp(scores - row_max)  # masked entries underflow to exactly 0
    denom = unnorm.sum(dim=-1, keepdim=True)
    weights = (unnorm / denom.clamp_min(1e-30)).to(q.dtype)
    out = torch.einsum("bngts,bsnh->btngh", weights.float(), v.float())
    return out.reshape(B, Tq, Nq, H).to(q.dtype)


def attention_qkv(
    params: Params,
    x_q: torch.Tensor,  # [B, Tq, Dq]
    x_kv: torch.Tensor,  # [B, Tkv, Dkv]
    q_positions: torch.Tensor,  # [B, Tq]
    kv_positions: torch.Tensor,  # [B, Tkv]
    rope_min: float,
    rope_max: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project q/k/v and apply RoPE to q and k (reference: dia/layers.py:271-279)."""
    q = dense_general(x_q, params["q_proj"]["kernel"])
    k = dense_general(x_kv, params["k_proj"]["kernel"])
    v = dense_general(x_kv, params["v_proj"]["kernel"])
    return rope(q, q_positions, rope_min, rope_max), rope(k, kv_positions, rope_min, rope_max), v


def attention_out(params: Params, attn: torch.Tensor) -> torch.Tensor:
    """Output projection contracting (head, head_dim) (reference: dia/layers.py:222-227)."""
    return dense_general(attn, params["o_proj"]["kernel"], axis=(-2, -1))


def full_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    is_causal: bool,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
) -> torch.Tensor:
    """Full-sequence attention: always the flash kernels (segment ids carry
    the reference's pad mask, ops/masks.py).  When autograd will need a
    gradient of q, k or v it is the trainable entry (LSE forward, dK/dV and dQ
    backward kernels), else the forward-only kernel.  Unlike the JAX
    dispatcher, head_dim is not padded to 128 — the kernels take 32, 64 and
    128 as they are."""
    needs_grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                              or v.requires_grad)
    return (flash_attention_trainable if needs_grad else flash_attention)(
        q.contiguous(), k.contiguous(), v.contiguous(),
        q_segment_ids.to(torch.int32).contiguous(), kv_segment_ids.to(torch.int32).contiguous(),
        is_causal,
    )


def attention(
    params: Params,
    x_q: torch.Tensor,
    x_kv: torch.Tensor,
    q_positions: torch.Tensor,
    kv_positions: torch.Tensor,
    rope_min: float,
    rope_max: float,
    is_causal: bool,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
) -> torch.Tensor:
    """Full-sequence attention with projections (encoder self-attention)."""
    q, k, v = attention_qkv(params, x_q, x_kv, q_positions, kv_positions, rope_min, rope_max)
    out = full_attention(q, k, v, is_causal, q_segment_ids, kv_segment_ids)
    return attention_out(params, out)
