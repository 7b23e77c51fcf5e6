"""Single-token GQA decode attention over a cache: CUDA kernel wrapper and its
plain PyTorch version.

Kernel: ``csrc/decode_attention.cu`` (hand-written split-K flash-decoding for
sm_90a, loaded with ctypes).  It replaces the Pallas kernel
``dia_tts_prune_tpu/ops/kernels/decode_attention.py::decode_attention`` (:95),
generalising its scalar ``valid_len`` to a per-row slot range
``[start[b], end[b])``.  Slots outside the range are never read, and a row
whose range is empty gets exact zeros.

The port's decode step runs it for every layer, twice:

* self-attention over the KV cache: ``start = 0``, ``end = write_slot + 1``
  (the JAX kernel's ``valid_len``);
* cross-attention over the text keys: ``start = 0``, ``end`` = the row's text
  length (``ends_from_padding_mask``), which is 0 for the CFG unconditional
  row — the same exact zeros the JAX decode step gets from its masked
  ``sdpa``.
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 4  # query heads per kv head the kernel takes (one warp each)
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def decode_attention_plain(
    q: torch.Tensor,  # [B, Nq, H]
    k_cache: torch.Tensor,  # [B, T, Nkv, H]
    v_cache: torch.Tensor,  # [B, T, Nkv, H]
    start: torch.Tensor,  # int32 [B]
    end: torch.Tensor,  # int32 [B]
) -> torch.Tensor:
    """Plain PyTorch version: masked ``sdpa`` over the whole cache."""
    from ..modules import sdpa

    slots = torch.arange(k_cache.shape[1], device=k_cache.device)
    mask = (slots[None, :] >= start[:, None]) & (slots[None, :] < end[:, None])  # [B, T]
    return sdpa(q[:, None], k_cache, v_cache, mask[:, None, None, :])[:, 0]


def ends_from_padding_mask(mask: torch.Tensor) -> torch.Tensor:
    """Per-row key count of a key-padding mask whose True entries form a
    prefix (cross-attention over left-aligned text): int32 [B].  Accepts
    [B, S] or the [B, 1, 1, S] decode cross mask; raises if a row's True
    entries are not a prefix, since the kernel attends a contiguous range."""
    m = mask.reshape(mask.shape[0], mask.shape[-1]).to(torch.bool)
    ends = m.sum(dim=-1)
    prefix = torch.arange(m.shape[-1], device=m.device)[None, :] < ends[:, None]
    if not torch.equal(prefix, m):
        raise ValueError("decode attention mask must be a prefix of each row")
    return ends.to(torch.int32)


def _check(q, k_cache, v_cache, start, end):
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k_cache.dtype}/{v_cache.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, Nq, H = q.shape
    Nkv = k_cache.shape[2]
    if (k_cache.shape[0] != B or k_cache.shape[3] != H or Nq % Nkv != 0
            or Nq // Nkv > MAX_GROUP or H not in _HEAD_DIMS):
        raise ValueError(f"decode_attention needs matching batch/head_dim, Nq % Nkv == 0, "
                         f"Nq / Nkv <= {MAX_GROUP} and head_dim in {_HEAD_DIMS}: "
                         f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if start.shape != (B,) or end.shape != (B,):
        raise ValueError(f"start/end must be [B]: {tuple(start.shape)}, {tuple(end.shape)}")
    if start.dtype != torch.int32 or end.dtype != torch.int32:
        raise TypeError("start/end must be int32")
    tensors = (q, k_cache, v_cache, start, end)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention inputs must be contiguous")


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
) -> torch.Tensor:
    """One query token per row against cache slots ``[start[b], end[b])``;
    returns [B, Nq, H] in q.dtype.  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_cache, v_cache, start, end)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(q, k_cache, v_cache, start, end)
    from ._build import kernel_function

    fn = kernel_function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    chunk = kernel_function("decode_attention", "decode_attention_chunk", [])()
    B, Nq, H = q.shape
    T, Nkv = k_cache.shape[1], k_cache.shape[2]
    n_split = -(-T // chunk)
    out = torch.empty_like(q)
    part = torch.empty(B * Nq * n_split * (H + 2), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), start.data_ptr(),
                 end.data_ptr(), out.data_ptr(), part.data_ptr(), B, T, Nq, Nkv, H,
                 _DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (cudaError {err})")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
