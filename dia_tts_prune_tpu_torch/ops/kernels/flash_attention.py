"""Flash attention forward with segment masking (+ causal): CUDA kernel wrapper
and its plain PyTorch version.

Kernel: ``csrc/flash_attention.cu`` (hand-written for sm_90a, loaded with
ctypes).  It replaces the Pallas forward of
``dia_tts_prune_tpu/ops/kernels/flash_attention.py`` (``flash_attention``
:121 and ``_fwd_with_lse`` :346): two positions attend iff their segment ids
are equal, optionally only at or below the diagonal, GQA query head ``n``
reads kv head ``n // group``, and fully masked rows come out as exact zeros.
The source note in the ``.cu`` file says what bounds it on the H100 and how
the design answers that.

The main path runs it for the encoder's self-attention (segment = non-pad)
and for the voice-prompt prefill (causal self-attention, segment = valid row;
cross-attention, segment = text non-pad).
"""

from __future__ import annotations

import ctypes

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def flash_attention_plain(
    q: torch.Tensor,  # [B, Tq, Nq, H]
    k: torch.Tensor,  # [B, Tk, Nkv, H]
    v: torch.Tensor,  # [B, Tk, Nkv, H]
    q_segment_ids: torch.Tensor,  # int [B, Tq]
    kv_segment_ids: torch.Tensor,  # int [B, Tk]
    causal: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version: the segment-equality mask through ``sdpa``."""
    from ..modules import sdpa

    mask = (q_segment_ids[:, :, None] == kv_segment_ids[:, None, :])[:, None]
    return sdpa(q, k, v, mask, is_causal=causal)


def _check(q, k, v, q_seg, kv_seg):
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q/k/v of one dtype, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != H or Nq % Nkv != 0 or H not in _HEAD_DIMS:
        raise ValueError(f"flash_attention needs matching batch/head_dim, Nq % Nkv == 0 and "
                         f"head_dim in {_HEAD_DIMS}: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q_seg.shape != (B, Tq) or kv_seg.shape != (B, Tk):
        raise ValueError(f"segment ids must be [B, Tq] / [B, Tk]: {tuple(q_seg.shape)}, "
                         f"{tuple(kv_seg.shape)}")
    if q_seg.dtype != torch.int32 or kv_seg.dtype != torch.int32:
        raise TypeError("segment ids must be int32")
    tensors = (q, k, v, q_seg, kv_seg)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention inputs must be contiguous")


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """Segment-masked (optionally causal) attention; returns [B, Tq, Nq, H]
    in q.dtype.  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_segment_ids, kv_segment_ids, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    from ._build import kernel_function

    fn = kernel_function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segment_ids.data_ptr(),
                 kv_segment_ids.data_ptr(), out.data_ptr(), B, Tq, Tk, Nq, Nkv, H,
                 _DTYPE_CODES[q.dtype], int(bool(causal)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed (cudaError {err})")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
