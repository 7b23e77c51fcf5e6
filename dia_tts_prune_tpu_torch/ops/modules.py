"""Core model ops: generalized dense, RMSNorm, RoPE, SwiGLU MLP, attention.

PyTorch counterparts of ``dia_tts_prune_tpu/ops/modules.py`` (float and
packed int8/int4 weights), as plain functions over a params dict of tensors
in the JAX layout:

* ``dense_general`` contracts the trailing axes of ``x`` against the leading
  axes of a kernel stored ``in_shapes + out_features`` (reference:
  dia/layers.py:35-66), one ``tensordot`` (a decode step's on the
  dense-rows kernel, whose rows keep their bits at any row count); a packed
  kernel (``ops/quant.py``) goes to the int8-matmul or int4-GEMV kernel, a
  block-sparse one (``ops/sparse.py``) to the block-sparse matmul;
* GQA attention reshapes queries to [B, T, Nkv, G, H] and contracts them
  against un-repeated K/V;
* norms, the SiLU gate, RoPE trig and softmax run in float32 whatever the
  compute dtype (reference: dia/layers.py:101,161-173,393); ``rms_norm``
  is the RMSNorm kernel's wrapper (``ops/kernels/rms_norm.py``).

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

from .kernels.dense_rows import dense_rows
from .kernels.flash_attention import flash_attention, flash_attention_trainable
from .kernels.int4_gemv import int4_gemv
from .kernels.int8_matmul import MAX_ROWS, int8_matmul
from .kernels.rms_norm import rms_norm  # noqa: F401  (the model's norm, imported from here)
from .kernels.sparse_matmul import block_sparse_matmul
from .quant import Quantized4Kernel, QuantizedKernel, dequantize4
from .sparse import BlockSparseKernel

Params = dict[str, Any]

NEG = torch.finfo(torch.float32).min


def dense_general(x: torch.Tensor, kernel, axis: tuple[int, ...] = (-1,),
                  decode: bool = False) -> torch.Tensor:
    """Contract ``axis`` of ``x`` against the leading axes of ``kernel``
    (reference: dia/layers.py:55-66).  No bias.  ``kernel`` is a tensor, a
    packed ``QuantizedKernel`` / ``Quantized4Kernel`` or a
    ``BlockSparseKernel`` (trailing axes only).

    ``decode``: a decode step's contraction (``models.dia.decode_step`` says
    so), whose rows must keep their bits whatever the other rows of the call
    are — a continuous-batching lane equals its solo run, a speculative
    verify row the loop step at its slot.  A float one that needs no
    gradient goes to ``dense_rows`` (on the card its kernel, whose plan is
    read from the weight's shape alone; cuBLAS picks its sum order by the row
    count).  Prompt prefill, the cross-attention K/V and everything under
    autograd keep ``torch.tensordot``: the JAX package computes them outside
    any Pallas kernel too."""
    if isinstance(kernel, (QuantizedKernel, Quantized4Kernel)):
        return _dense_general_packed(x, kernel, axis, decode)
    if isinstance(kernel, BlockSparseKernel):
        return _dense_general_sparse(x, kernel, axis)
    n_in = len(axis)
    norm_axis = [ax if ax >= 0 else x.dim() + ax for ax in axis]
    x = x.to(kernel.dtype)
    if decode and norm_axis == list(range(x.dim() - n_in, x.dim())) and not (
            torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad)):
        lead = x.shape[: x.dim() - n_in]
        K = math.prod(x.shape[x.dim() - n_in:])
        y = dense_rows(x.reshape(-1, K).contiguous(), kernel.reshape(K, -1))
        return y.reshape(*lead, *kernel.shape[n_in:])
    return torch.tensordot(x, kernel, dims=(norm_axis, list(range(n_in))))


def _dense_general_packed(x: torch.Tensor, qk, axis: tuple[int, ...],
                          decode: bool) -> torch.Tensor:
    """Contraction against a packed kernel; activations keep their dtype.

    The route follows the JAX dispatcher's own rule (its ops/modules.py:160,
    ops/kernels/int4_gemv.py:98), by shape and device, and keeps a decode
    step's contractions on the kernels at any row count:

    * a decode step's contractions (``decode``), and up to 64 rows of any
      other, the int8-matmul or int4-GEMV wrapper: the CUDA kernel on the
      card (above 64 rows in groups of 64, each with the plan of a 64-row
      call, so a lane's rows keep their bits), the plain version on the CPU;
    * more rows outside a decode step on the card (prompt prefill, the
      cross-attention K/V of the text) are large matrix products, which the
      JAX package also computes outside any Pallas kernel
      (``int8_matmul_upcast``, ``int4_matmul_halfsplit*``): the weight is
      widened to ``x.dtype`` and goes to ``torch.matmul``; int8 scales
      multiply the fp32 result, int4 scales (per group) are folded into the
      widened weight.
    """
    n_in = len(axis)
    if n_in != len(qk.in_shape):
        raise ValueError(
            f"kernel packed for {len(qk.in_shape)} contraction axes, called with {n_in}")
    K, N = math.prod(qk.in_shape), math.prod(qk.out_shape)
    lead = x.shape[: x.dim() - n_in]
    x2 = x.reshape(-1, K).contiguous()
    int8 = isinstance(qk, QuantizedKernel)
    if x2.is_cuda and x2.shape[0] > MAX_ROWS and not decode:
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


def model_psum(y: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``y`` over the ranks of ``group`` (a mesh's model axis,
    ``parallel/sharding.py``), in ``y``'s dtype; ``y`` itself for no group.
    Each rank holds a partial sum of a row-parallel product (``o_proj``,
    ``wo``), and the sum is every rank's whole output.  Under autograd its
    backward is the identity: each rank's partial takes the whole output
    gradient.  Without a gradient to keep, the sum is taken in place."""
    if group is None:
        return y
    if torch.is_grad_enabled() and y.requires_grad:
        return _ModelSum.apply(y, group)
    import torch.distributed as dist

    y = y.contiguous()
    dist.all_reduce(y, group=group)
    return y


def model_copy(x: torch.Tensor, group) -> torch.Tensor:
    """``x``, a replicated activation about to enter a column-parallel
    product (q/k/v, the cross-attention q and K/V, ``wi_fused``), under a
    mesh's model group: the identity forward, and under autograd a backward
    that sums the input gradient over the ranks of ``group``, since each
    rank's product sees only its own columns.  ``model_psum``'s partner (the
    f and g operators of Megatron-LM's tensor parallelism).  ``x`` itself,
    with no autograd node, for no group or where no gradient flows."""
    if group is None or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _ModelCopy.apply(x, group)


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, group):
        import torch.distributed as dist

        out = y.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def mlp_block(params: Params, x: torch.Tensor, group=None, decode: bool = False) -> torch.Tensor:
    """SwiGLU MLP with the fused gate/up kernel [D, 2, F] (reference:
    dia/layers.py:69-105); SiLU on the gate runs in float32.  Under a model
    group each rank holds a slice of F, and the ranks' partial sums over D
    are added (``model_psum``); the gradient of ``x`` is summed over them
    (``model_copy``).  ``decode`` as in ``dense_general``."""
    fused = dense_general(model_copy(x, group), params["wi_fused"]["kernel"],
                          decode=decode)  # [..., 2, F]
    gate, up = fused[..., 0, :], fused[..., 1, :]
    hidden = F.silu(gate.float()).to(x.dtype) * up
    return model_psum(dense_general(hidden, params["wo"]["kernel"], decode=decode), group)


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
    decode: bool = False,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project q/k/v and apply RoPE to q and k (reference: dia/layers.py:271-279);
    ``decode`` as in ``dense_general``."""
    q = dense_general(x_q, params["q_proj"]["kernel"], decode=decode)
    k = dense_general(x_kv, params["k_proj"]["kernel"], decode=decode)
    v = dense_general(x_kv, params["v_proj"]["kernel"], decode=decode)
    return rope(q, q_positions, rope_min, rope_max), rope(k, kv_positions, rope_min, rope_max), v


def attention_out(params: Params, attn: torch.Tensor, group=None,
                  decode: bool = False) -> torch.Tensor:
    """Output projection contracting (head, head_dim) (reference:
    dia/layers.py:222-227).  Under a model group each rank holds a slice of
    the heads, and the ranks' partial sums over D are added
    (``model_psum``).  ``decode`` as in ``dense_general``."""
    return model_psum(dense_general(attn, params["o_proj"]["kernel"], axis=(-2, -1),
                                    decode=decode), group)


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
    group=None,
) -> torch.Tensor:
    """Full-sequence attention with projections (encoder self-attention);
    ``group`` as in ``attention_out``, and the gradients of ``x_q`` and
    ``x_kv`` summed over it (``model_copy``)."""
    self_attention = x_kv is x_q  # one copy: its gradient adds the q, k and v shares first
    x_q = model_copy(x_q, group)
    x_kv = x_q if self_attention else model_copy(x_kv, group)
    q, k, v = attention_qkv(params, x_q, x_kv, q_positions, kv_positions, rope_min, rope_max)
    out = full_attention(q, k, v, is_causal, q_segment_ids, kv_segment_ids)
    return attention_out(params, out, group)
