"""Single-token GQA decode attention over a cache: CUDA kernel wrapper and its
plain PyTorch version.

Kernel: ``csrc/decode_attention.cu`` (hand-written for sm_90a, loaded with
ctypes).  It replaces the Pallas kernel
``dia_tts_prune_tpu/ops/kernels/decode_attention.py::decode_attention`` (:95),
generalising its scalar ``valid_len`` to a per-row slot range
``[start[b], end[b])``.  Slots outside the range are never read, and a row
whose range is empty gets exact zeros.  One launch per call: the splits of a
(row, kv head) are the blocks of a thread-block cluster, each an equal share
of the row's own range (so a row's result never depends on the batch, the
cache capacity or the other rows), combined on chip through distributed
shared memory.

The port's decode step runs it for every layer, twice:

* self-attention over the KV cache: ``start = 0``, ``end = write_slot + 1``
  (the JAX kernel's ``valid_len``);
* cross-attention over the text keys: ``start = 0``, ``end`` = the row's text
  length (``ends_from_padding_mask``), which is 0 for the CFG unconditional
  row — the same exact zeros the JAX decode step gets from its masked
  ``sdpa``.

With an int8 cache (``models.dia.QuantKVCache``: int8 K/V and one fp32 scale
per slot and kv head) the kernel widens the codes itself and keeps the scales
outside the dots, as ``models/dia.py::_sdpa_quant`` (:85) does: slot ``t``
scores ``(q·k8[t])·ks[t]/sqrt(H)`` and contributes ``p[t]·vs[t]·v8[t]``.  The
self-attention of such a step passes the current token's unquantized
``k_new``, ``v_new`` beside the quantized prefix ``[0, write_slot)``: that
token is not in the cache yet, and ``decode_step_scan`` (:661-685) adds it
analytically in the same way.

Window form (``queries_per_row`` W > 1; the verify pass of speculative
decoding, ``models/dia.py::decode_step`` on W rows): q, ``start`` and ``end`` hold
B·W rows against a cache of B rows, and query row ``r`` reads cache row
``r // W`` over its own range.  The kernel computes each query row exactly as
a one-query call over the same cache row and range does, so a window row's
result is the decode loop's step at that row, bit for bit.  Float caches
only: an int8 cache or a current token raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 4  # query heads per kv head the kernel takes
MAX_GRID_ROWS = 65535  # query rows (B·W) of one launch: the grid's z extent
# how the kernel combines a row's splits: a thread-block cluster that merges
# them on chip through distributed shared memory (csrc: CLUSTER blocks)
DESIGN = "cluster"
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def decode_attention_plain(
    q: torch.Tensor,  # [B·W, Nq, H]
    k_cache: torch.Tensor,  # [B, T, Nkv, H]
    v_cache: torch.Tensor,  # [B, T, Nkv, H]
    start: torch.Tensor,  # int32 [B·W]
    end: torch.Tensor,  # int32 [B·W]
    k_scale: torch.Tensor | None = None,  # fp32 [B, T, Nkv]: the caches are int8
    v_scale: torch.Tensor | None = None,
    k_new: torch.Tensor | None = None,  # [B, Nkv, H]: one more token, not in the cache
    v_new: torch.Tensor | None = None,
    queries_per_row: int = 1,
) -> torch.Tensor:
    """Plain PyTorch version: masked ``sdpa`` over the whole cache; for an
    int8 cache the arithmetic of ``_sdpa_quant`` in fp32, the extra token
    entering the softmax as one more key with scales of 1.  The window form
    (``queries_per_row`` W > 1, float caches) gathers cache row ``r // W``
    for each query row ``r``."""
    from ..modules import NEG, sdpa

    W = queries_per_row
    if W != 1:
        if k_scale is not None or k_new is not None:
            raise ValueError("decode_attention: the window form takes float caches and no "
                             "current token")
        rows = torch.arange(q.shape[0], device=q.device) // W
        k_cache, v_cache = k_cache[rows], v_cache[rows]

    slots = torch.arange(k_cache.shape[1], device=k_cache.device)
    mask = (slots[None, :] >= start[:, None]) & (slots[None, :] < end[:, None])  # [B, T]
    if k_scale is None:
        return sdpa(q[:, None], k_cache, v_cache, mask[:, None, None, :])[:, 0]
    B, Nq, H = q.shape
    Nkv = k_cache.shape[2]
    qg = q.reshape(B, Nkv, Nq // Nkv, H).float()
    inv = 1.0 / math.sqrt(H)
    scores = torch.einsum("bngh,bsnh->bngs", qg, k_cache.float()) * inv
    scores = scores * k_scale.transpose(1, 2)[:, :, None, :]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG)
    values, w_scale = v_cache.float(), v_scale.transpose(1, 2)[:, :, None, :]  # [B, Nkv, 1, T]
    if k_new is not None:
        s_cur = torch.einsum("bngh,bnh->bng", qg, k_new.float()) * inv
        scores = torch.cat([scores, s_cur[..., None]], dim=-1)
        values = torch.cat([values, v_new.float()[:, None]], dim=1)
        w_scale = torch.cat([w_scale, torch.ones_like(w_scale[..., :1])], dim=-1)
    row_max = scores.amax(dim=-1, keepdim=True)
    row_max = torch.where(row_max <= NEG * 0.5, torch.zeros_like(row_max), row_max)
    unnorm = torch.exp(scores - row_max)  # masked entries underflow to exactly 0
    weights = unnorm / unnorm.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bngs,bsnh->bngh", weights * w_scale, values)
    return out.reshape(B, Nq, H).to(q.dtype)


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


def _check(q, k_cache, v_cache, start, end, k_scale=None, v_scale=None, k_new=None, v_new=None,
           queries_per_row=1):
    W = queries_per_row
    if not isinstance(W, int) or W < 1:
        raise ValueError(f"decode_attention: queries_per_row must be a positive int, got {W!r}")
    if W > 1 and (k_scale is not None or k_new is not None):
        raise ValueError("decode_attention: the window form (queries_per_row > 1) takes float "
                         "caches and no current token")
    cache_dtype = q.dtype if k_scale is None else torch.int8
    if q.dtype not in _DTYPE_CODES or k_cache.dtype != cache_dtype or v_cache.dtype != cache_dtype:
        raise TypeError(f"decode_attention takes float32 or bfloat16 q with caches of q's dtype, "
                        f"or int8 caches with scales, got {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}, scales {'given' if k_scale is not None else 'absent'}")
    if (k_scale is None) != (v_scale is None) or (k_new is None) != (v_new is None):
        raise ValueError("decode_attention: k_scale/v_scale and k_new/v_new come in pairs")
    if k_new is not None and k_scale is None:
        raise ValueError("decode_attention: k_new/v_new go with an int8 cache (a float cache "
                         "holds the current token already)")
    if q.dim() != 3 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention shapes: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    R, Nq, H = q.shape
    B = k_cache.shape[0]
    Nkv = k_cache.shape[2]
    if R != B * W or R > MAX_GRID_ROWS:
        raise ValueError(f"decode_attention: q has {R} rows for {B} cache rows x "
                         f"{W} queries a row (at most {MAX_GRID_ROWS})")
    if (k_cache.shape[3] != H or Nq % Nkv != 0
            or Nq // Nkv > MAX_GROUP or H not in _HEAD_DIMS):
        raise ValueError(f"decode_attention needs matching batch/head_dim, Nq % Nkv == 0, "
                         f"Nq / Nkv <= {MAX_GROUP} and head_dim in {_HEAD_DIMS}: "
                         f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)}")
    if start.shape != (R,) or end.shape != (R,):
        raise ValueError(f"start/end must be [B·W]: {tuple(start.shape)}, {tuple(end.shape)}")
    if start.dtype != torch.int32 or end.dtype != torch.int32:
        raise TypeError("start/end must be int32")
    extras = [t for t in (k_scale, v_scale, k_new, v_new) if t is not None]
    if k_scale is not None and not all(
            t.dtype == torch.float32 and t.shape == k_cache.shape[:3] for t in (k_scale, v_scale)):
        raise ValueError(f"decode_attention scales must be float32 [B, T, Nkv]: "
                         f"{k_scale.dtype} {tuple(k_scale.shape)}, {tuple(v_scale.shape)}")
    if k_new is not None and not all(
            t.dtype == q.dtype and t.shape == (B, Nkv, H) for t in (k_new, v_new)):
        raise ValueError(f"decode_attention k_new/v_new must be [B, Nkv, H] in q's dtype: "
                         f"{k_new.dtype} {tuple(k_new.shape)}, {tuple(v_new.shape)}")
    tensors = (q, k_cache, v_cache, start, end, *extras)
    if any(t.device != q.device for t in tensors):
        raise ValueError("decode_attention inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("decode_attention inputs must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("decode_attention caches must start on a 16-byte boundary")


def decode_attention(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    start: torch.Tensor,
    end: torch.Tensor,
    k_scale: torch.Tensor | None = None,
    v_scale: torch.Tensor | None = None,
    k_new: torch.Tensor | None = None,
    v_new: torch.Tensor | None = None,
    queries_per_row: int = 1,
) -> torch.Tensor:
    """One query token per row against cache slots ``[start[b], end[b])``;
    returns [B, Nq, H] in q.dtype.  ``k_scale``/``v_scale`` [B, T, Nkv] mark
    int8 caches; ``k_new``/``v_new`` [B, Nkv, H] are then one more token every
    row attends.  ``queries_per_row`` W > 1 is the window form: q, start and
    end have B·W rows, query row ``r`` reading cache row ``r // W`` (float
    caches only; its launches are counted in ``window_launches``, the
    one-query form's in ``launches``).  CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    args = (q, k_cache, v_cache, start, end, k_scale, v_scale, k_new, v_new)
    if q.device.type == "cpu":
        return decode_attention_plain(*args, queries_per_row=queries_per_row)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check(*args, queries_per_row=queries_per_row)
    from ._build import kernel_function

    fn = kernel_function("decode_attention", "decode_attention_fwd", _ARGTYPES)
    _, Nq, H = q.shape
    B, T, Nkv = k_cache.shape[:3]
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 *(None if t is None else t.data_ptr() for t in args[5:]), start.data_ptr(),
                 end.data_ptr(), out.data_ptr(), B, T, Nq, Nkv, H, _DTYPE_CODES[q.dtype],
                 int(k_scale is not None), queries_per_row,
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"decode_attention kernel launch failed (cudaError {err})")
    if queries_per_row == 1:
        decode_attention.launches += 1
    else:  # the window form counts apart: launch_counts()["decode_attention_window"]
        decode_attention.window_launches += 1
    return out


decode_attention.launches = 0
decode_attention.window_launches = 0
