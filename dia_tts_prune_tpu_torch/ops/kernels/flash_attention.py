"""Flash attention with segment masking (+ causal), forward and backward: CUDA
kernel wrappers and their plain PyTorch versions.

Kernels: ``csrc/flash_attention.cu`` (forward, with or without the
log-sum-exp rows) and ``csrc/flash_attention_bwd.cu`` (dK/dV and dQ), all
hand-written for sm_90a and loaded with ctypes.  They replace the Pallas
kernels of ``dia_tts_prune_tpu/ops/kernels/flash_attention.py``: the forwards
``flash_attention`` :121 and ``_fwd_with_lse`` :346, and the recompute-p
backward ``_flash_bwd_vjp`` :428 (``_bwd_kv_kernel`` :244, ``_bwd_q_kernel``
:297).  Two positions attend iff their segment ids are equal, optionally only
at or below the diagonal, GQA query head ``n`` reads kv head ``n // group``,
and fully masked rows come out as exact zeros (and get exactly zero ``dq``).
The source notes in the ``.cu`` files say what bounds the kernels on the H100
and how the designs answer that.

* ``flash_attention`` — forward only; inference runs it for the encoder's
  self-attention (segment = non-pad) and the voice-prompt prefill.
* ``flash_attention_trainable`` — a ``torch.autograd.Function``: forward =
  the LSE kernel, backward = the dK/dV and dQ kernels.  Training runs it for
  every attention of every layer (``ops/modules.py::full_attention`` picks it
  whenever q, k or v requires grad).  Segment ids and ``causal`` get no
  gradient.
* ``flash_attention_lse``, ``flash_attention_bwd_kv``, ``flash_attention_bwd_q``
  — the three kernels' wrappers, each with its launch count; on CPU tensors
  they compute ``flash_attention_lse_plain`` / ``flash_attention_bwd_plain``.
* ``tile_visits`` — which 64 x 64 (query, key) tiles the bf16 forward,
  dK/dV and dQ kernels compute; they skip the others whole.

bf16 q/k/v run all three kernels on the tensor cores, fp32 on the CUDA cores
(true fp32).
"""

from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_LSE_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_KV_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_BWD_Q_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


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


def _launch(fn_name, lib, argtypes, pointers, q, k, causal):
    """Call the C entry ``fn_name`` of ``csrc/<lib>.cu`` on the tensors' pointers, the
    shape and dtype of q/k, ``causal`` and the current stream; raise if the
    launch is refused."""
    from ._build import kernel_function

    fn = kernel_function(lib, fn_name, argtypes)
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    with torch.cuda.device(q.device):
        err = fn(*(t.data_ptr() for t in pointers), B, Tq, Tk, Nq, Nkv, H,
                 _DTYPE_CODES[q.dtype], int(bool(causal)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed (cudaError {err})")


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
    out = torch.empty_like(q)
    _launch("flash_attention_fwd", "flash_attention", _ARGTYPES,
            (q, k, v, q_segment_ids, kv_segment_ids, out), q, k, causal)
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# Training: forward with log-sum-exp rows, recompute-p backward
# ---------------------------------------------------------------------------


def _mask(q_seg: torch.Tensor, kv_seg: torch.Tensor, causal: bool) -> torch.Tensor:
    """bool [B, Tq, Tk]: segment ids equal and, if causal, key <= query."""
    mask = q_seg[:, :, None] == kv_seg[:, None, :]
    if causal:
        Tq, Tk = q_seg.shape[1], kv_seg.shape[1]
        mask = mask & torch.ones(Tq, Tk, dtype=torch.bool, device=mask.device).tril()
    return mask


def _scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """fp32 q.k^T / sqrt(H) as [B, Nkv, G, Tq, Tk]."""
    B, Tq, Nq, H = q.shape
    Nkv = k.shape[2]
    qg = q.reshape(B, Tq, Nkv, Nq // Nkv, H).float()
    return torch.einsum("btngh,bsnh->bngts", qg, k.float()) * (1.0 / math.sqrt(H))


TILE = 64  # query rows and keys per tile of the bf16 forward, dK/dV and dQ kernels


def _tile_ranges(seg: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Smallest and largest segment id of each 64-position tile, [B, n_tiles]
    each (a ragged last tile counts only its positions)."""
    B, T = seg.shape
    n = -(-T // TILE)
    big = torch.iinfo(torch.int64).max

    def padded(fill):
        pad = torch.full((B, n * TILE - T), fill, dtype=torch.int64, device=seg.device)
        return torch.cat([seg.to(torch.int64), pad], dim=1).reshape(B, n, TILE)

    return padded(big).amin(-1), padded(-big).amax(-1)


def tile_visits(q_segment_ids: torch.Tensor, kv_segment_ids: torch.Tensor,
                causal: bool = False) -> torch.Tensor:
    """bool [B, query tiles, key tiles]: the 64 x 64 tile pairs that the bf16
    forward, dK/dV and dQ kernels compute.  A pair is skipped whole when the key
    tile lies above the causal diagonal, or when the segment-id ranges of the
    two tiles do not meet, so that no pair of positions in it can have equal
    ids.  (Tiles past 32768 positions are never skipped by range; no shape the
    model runs has them.)"""
    q_lo, q_hi = _tile_ranges(q_segment_ids)
    k_lo, k_hi = _tile_ranges(kv_segment_ids)
    visits = (q_hi[:, :, None] >= k_lo[:, None, :]) & (k_hi[:, None, :] >= q_lo[:, :, None])
    if causal:
        visits &= torch.ones(visits.shape[1:], dtype=torch.bool, device=visits.device).tril()
    return visits


def flash_attention_lse_plain(q, k, v, q_segment_ids, kv_segment_ids, causal: bool = False):
    """Plain PyTorch version of the training forward: (out [B, Tq, Nq, H] in
    q.dtype, lse fp32 [B, Nq, Tq]) with ``lse = m + log(max(l, 1e-30))``, ``m``
    the row maximum over the attended keys (0 on a fully masked row) and ``l``
    the sum of ``exp(s - m)`` over them."""
    B, Tq, Nq, H = q.shape
    mask = _mask(q_segment_ids, kv_segment_ids, causal)[:, None, None]  # [B, 1, 1, Tq, Tk]
    s = _scores(q, k)
    m = s.masked_fill(~mask, -1e30).amax(dim=-1, keepdim=True)
    m = torch.where(m <= -0.5e30, torch.zeros_like(m), m)
    p = torch.where(mask, torch.exp(torch.where(mask, s - m, torch.zeros_like(s))),
                    torch.zeros_like(s))
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bngts,bsnh->btngh", p / l, v.float()).reshape(B, Tq, Nq, H)
    lse = (m + torch.log(l)).reshape(B, Nq, Tq)
    return out.to(q.dtype), lse


def flash_attention_bwd_plain(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout,
                              causal: bool = False):
    """Plain PyTorch version of the backward kernels, the same recompute-p
    arithmetic in fp32: ``p = mask ? exp(s - lse) : 0``, ``dv = p^T.dO``,
    ``ds = p * (dO.v^T - dd) * scale`` with ``dd = sum_h dO*O``, ``dk = ds^T.q``
    (both summed over the GQA group), ``dq = ds.k``.  Returns (dq, dk, dv) in
    q.dtype."""
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    scale = 1.0 / math.sqrt(H)
    mask = _mask(q_segment_ids, kv_segment_ids, causal)[:, None, None]
    s = _scores(q, k)  # [B, Nkv, G, Tq, Tk]
    lse5 = lse.reshape(B, Nkv, G, Tq, 1)
    p = torch.where(mask, torch.exp(torch.where(mask, s - lse5, torch.zeros_like(s))),
                    torch.zeros_like(s))
    do = dout.float().reshape(B, Tq, Nkv, G, H)
    dd = (dout.float() * out.float()).sum(dim=-1)  # [B, Tq, Nq]
    dd5 = dd.transpose(1, 2).reshape(B, Nkv, G, Tq, 1)
    dv = torch.einsum("bngts,btngh->bsnh", p, do)
    dp = torch.einsum("btngh,bsnh->bngts", do, v.float())
    ds = p * (dp - dd5) * scale
    dk = torch.einsum("bngts,btngh->bsnh", ds, q.float().reshape(B, Tq, Nkv, G, H))
    dq = torch.einsum("bngts,bsnh->btngh", ds, k.float()).reshape(B, Tq, Nq, H)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_lse(q, k, v, q_segment_ids, kv_segment_ids, causal: bool = False):
    """The training forward: (out [B, Tq, Nq, H] in q.dtype, lse fp32
    [B, Nq, Tq]).  CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if q.device.type == "cpu":
        return flash_attention_lse_plain(q, k, v, q_segment_ids, kv_segment_ids, causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_lse: unsupported device {q.device}")
    _check(q, k, v, q_segment_ids, kv_segment_ids)
    B, Tq, Nq, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(B, Nq, Tq, dtype=torch.float32, device=q.device)
    _launch("flash_attention_fwd_lse", "flash_attention", _LSE_ARGTYPES,
            (q, k, v, q_segment_ids, kv_segment_ids, out, lse), q, k, causal)
    flash_attention_lse.launches += 1
    return out, lse


def _check_bwd(q, k, v, q_seg, kv_seg, out, lse, dout, dd):
    """What the backward kernels read beyond the forward's inputs; ``dd`` may
    still be None."""
    _check(q, k, v, q_seg, kv_seg)
    B, Tq, Nq, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_attention backward: {name} must be shaped and typed like "
                             f"q, on its device: {tuple(t.shape)} {t.dtype} {t.device}")
    if not dout.is_contiguous():
        raise ValueError("flash_attention backward: dout must be contiguous")
    for name, t in (("lse", lse), ("dd", dd)):
        if t is None:
            continue
        if (t.shape != (B, Nq, Tq) or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != q.device):
            raise ValueError(f"flash_attention backward: {name} must be contiguous float32 "
                             f"[B, Nq, Tq] on q's device: {tuple(t.shape)} {t.dtype} {t.device}")


def _dd(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """dd = sum_h dO*O as fp32 [B, Nq, Tq] (a reduction outside the kernels,
    as in the JAX package)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


def flash_attention_bwd_kv(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout,
                           causal: bool = False, dd: torch.Tensor | None = None):
    """(dk, dv) [B, Tk, Nkv, H] in the input dtype, already summed over the
    GQA group.  CPU tensors take the plain version; CUDA tensors launch the
    dK/dV kernel or raise.  ``dd`` (``sum_h dO*O``, fp32 [B, Nq, Tq]) is
    computed from ``out`` unless the caller already has it."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout,
                                         causal)[1:]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_kv: unsupported device {q.device}")
    _check_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, dd)
    dd = _dd(out, dout) if dd is None else dd
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_attention_bwd_kv", "flash_attention_bwd", _BWD_KV_ARGTYPES,
            (q, k, v, dout, lse, dd, q_segment_ids, kv_segment_ids, dk, dv), q, k, causal)
    flash_attention_bwd_kv.launches += 1
    return dk, dv


def flash_attention_bwd_q(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout,
                          causal: bool = False, dd: torch.Tensor | None = None):
    """dq [B, Tq, Nq, H] in the input dtype.  CPU tensors take the plain
    version; CUDA tensors launch the dQ kernel or raise.  ``dd`` as for
    ``flash_attention_bwd_kv``."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout,
                                         causal)[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd_q: unsupported device {q.device}")
    _check_bwd(q, k, v, q_segment_ids, kv_segment_ids, out, lse, dout, dd)
    dd = _dd(out, dout) if dd is None else dd
    dq = torch.empty_like(q)
    _launch("flash_attention_bwd_q", "flash_attention_bwd", _BWD_Q_ARGTYPES,
            (q, k, v, dout, lse, dd, q_segment_ids, kv_segment_ids, dq), q, k, causal)
    flash_attention_bwd_q.launches += 1
    return dq


flash_attention_lse.launches = 0
flash_attention_bwd_kv.launches = 0
flash_attention_bwd_q.launches = 0


class _FlashAttentionFunction(torch.autograd.Function):
    """Forward = the LSE kernel, backward = the dK/dV and dQ kernels."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal):
        out, lse = flash_attention_lse(q, k, v, q_seg, kv_seg, causal)
        ctx.save_for_backward(q, k, v, q_seg, kv_seg, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_seg, kv_seg, out, lse = ctx.saved_tensors
        dout = dout.contiguous()
        dd = _dd(out, dout)  # once, for both kernels
        dk, dv = flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, ctx.causal, dd)
        dq = flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, ctx.causal, dd)
        return dq, dk, dv, None, None, None


def flash_attention_trainable(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_segment_ids: torch.Tensor,
    kv_segment_ids: torch.Tensor,
    causal: bool = False,
) -> torch.Tensor:
    """Differentiable segment-masked attention, [B, Tq, Nq, H] in q.dtype.
    On CUDA tensors the forward and the backward are the hand-written kernels
    (or raise); on CPU tensors it is the plain version under ordinary autograd."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, q_segment_ids, kv_segment_ids, causal)
    return _FlashAttentionFunction.apply(q, k, v, q_segment_ids, kv_segment_ids, bool(causal))
