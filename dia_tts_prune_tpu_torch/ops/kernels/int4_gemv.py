"""Int4-weight (nibble bytes) GEMV for the decode path: CUDA kernel wrapper
and its plain PyTorch version.

Kernel: ``csrc/int4_gemv.cu`` (hand-written for sm_90a, loaded with ctypes).
It replaces the Pallas kernel
``dia_tts_prune_tpu/ops/kernels/int4_gemv.py::int4_gemv_halfsplit`` (:103) and
covers what ``dia_tts_prune_tpu/ops/kernels/int4_matmul.py`` computes for the
nibble layouts, for every layout ``ops/quant.py::quantize_int4`` can emit:

* ``"halfsplit"`` — byte ``[r, n]`` = row ``r`` (low nibble) | row ``r + K/2``
  (high): ``y = x[:, :K/2] @ sext(b << 4 >> 4) + x[:, K/2:] @ (b >> 4)``;
* ``"parity"`` — byte ``r`` = rows ``2r`` | ``2r + 1``;
* ``"unpacked"`` — one int4 value per int8 byte (odd K only).

Scales are per column ``[N]`` or grouped ``[K/G, N]``.  They multiply fp32
partial sums, one per (group, column), which is the arithmetic of
``int4_matmul_halfsplit_grouped``.  The Pallas body instead scales the weights
in the compute dtype before its dot (int4_gemv.py:78-79), rounding each to
bf16 — an artefact of feeding the matrix unit; fp32 sums are cheaper here and
closer to the dequantized kernel.  The Pallas kernel's lane constraints
(``K % 256``, ``N % 128``) do not apply: any K, N with 1..64 rows is served.

bf16 activations in the two nibble layouts (the decode path) take the tensor
cores in one cluster launch, the int8 matmul's design: a cluster of blocks
owns a strip of ``STRIP`` columns, each block a slice of byte rows
(``cluster_plan``, from the weight's shape alone), nibbles widen to bf16 in
registers, and the blocks add their fp32 totals in rank order on chip; the
weight is read once at any row count.  fp32 activations and the
one-value-a-byte layout take the CUDA cores: column strips × slices of byte
rows (``split_plan``), each slice's fp32 partial summed in slice order by a
second small kernel.  Either way no atomics: the output is the same from run
to run, and a row's bits do not depend on the other rows.
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import unpack_nibble_rows
# the tensor-core route plans byte rows with the bf16 int8 route's rule (a stage
# holds STAGE_ROWS byte rows, each two rows of K); it never sees the row count
from .int8_matmul import MAX_ROWS, cluster_plan, copy_width, split_plan, vector_width

LAYOUTS = {"halfsplit": 0, "parity": 1, "unpacked": 2}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
MAX_SLICE = 512  # byte rows a block of the CUDA-core route walks (csrc: RS_MAX)


def uses_mma(dtype: torch.dtype, layout: str) -> bool:
    """The tensor-core route: bf16 activations, two nibbles a byte."""
    return dtype == torch.bfloat16 and layout != "unpacked"


def _dims(x, w_b, scale, layout):
    """(K, group): the contraction length the bytes hold and the scale group
    size (None for per-column scales)."""
    if layout not in LAYOUTS:
        raise ValueError(f"int4_gemv layout must be one of {sorted(LAYOUTS)}, got {layout!r}")
    K = w_b.shape[0] * (1 if layout == "unpacked" else 2)
    if scale.dim() == 1:
        return K, None
    if scale.shape[0] == 0 or K % scale.shape[0]:
        raise ValueError(f"int4_gemv: {scale.shape[0]} scale rows do not divide K = {K}")
    return K, K // scale.shape[0]


def int4_gemv_plain(x: torch.Tensor, w_b: torch.Tensor, scale: torch.Tensor,
                    layout: str = "halfsplit") -> torch.Tensor:
    """Plain PyTorch version: unpack by layout to rows in their original
    order, per-group fp32 partial dots, scale, sum, one rounding to
    ``x.dtype``."""
    K, group = _dims(x, w_b, scale, layout)
    w = (w_b if layout == "unpacked" else unpack_nibble_rows(w_b, layout == "halfsplit")).float()
    N = w.shape[1]
    if group is None:
        return ((x.float() @ w) * scale.float()[None, :]).to(x.dtype)
    part = torch.einsum("bkg,kgn->bkn", x.float().reshape(x.shape[0], K // group, group),
                        w.reshape(K // group, group, N))
    return torch.einsum("bkn,kn->bn", part, scale.float()).to(x.dtype)


def _check(x, w_b, scale, layout):
    K, group = _dims(x, w_b, scale, layout)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int4_gemv takes float32 or bfloat16 activations, got {x.dtype}")
    if w_b.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int4_gemv takes int8 bytes and float32 scales, got "
                        f"{w_b.dtype}, {scale.dtype}")
    if x.dim() != 2 or w_b.dim() != 2 or x.shape[1] != K or 0 in w_b.shape:
        raise ValueError(f"int4_gemv shapes: x {tuple(x.shape)}, bytes {tuple(w_b.shape)} "
                         f"({layout}: K = {K})")
    if scale.shape[-1] != w_b.shape[1] or scale.dim() not in (1, 2):
        raise ValueError(f"int4_gemv scale must be [N] or [K/G, N]: {tuple(scale.shape)}")
    if group is not None:
        if layout == "halfsplit" and (K // 2) % group:
            raise ValueError(f"int4_gemv halfsplit needs (K/2) % group == 0: K {K}, group {group}")
        if layout == "parity" and group % 2:
            raise ValueError(f"int4_gemv parity needs an even group, got {group}")
    if not 1 <= x.shape[0] <= MAX_ROWS:
        raise ValueError(f"int4_gemv takes 1..{MAX_ROWS} rows, got {x.shape[0]}")
    if any(t.device != x.device for t in (w_b, scale)):
        raise ValueError("int4_gemv inputs must be on one device")
    if not all(t.is_contiguous() for t in (x, w_b, scale)):
        raise ValueError("int4_gemv inputs must be contiguous")
    return K, group


def launch(x: torch.Tensor, w_b: torch.Tensor, scale: torch.Tensor, layout: str, K: int,
           group: int | None, vec: int, n_split: int, slice_rows: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs with a given copy or load width
    and slices of byte rows (``int4_gemv`` plans them; a tuning sweep sets
    them).  Tensor-core route: the slices are the blocks of a cluster, no
    scratch; CUDA-core route: an fp32 scratch of ``n_split`` partials."""
    from ._build import kernel_function

    fn = kernel_function("int4_gemv", "int4_gemv_fwd", _ARGTYPES)
    B = x.shape[0]
    R, N = w_b.shape
    # byte rows that share their scale rows, and the high plane's scale-row offset
    if group is None:
        S, seg, hi_off = 1, R, 0
    else:
        S = K // group
        seg = group // 2 if layout == "parity" else group
        hi_off = S // 2 if layout == "halfsplit" else 0
    out = torch.empty(B, N, dtype=x.dtype, device=x.device)
    part = None
    if not uses_mma(x.dtype, layout) and n_split > 1:
        part = torch.empty(n_split * B * N, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_b.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), B, K, R, N, S, LAYOUTS[layout], seg,
                 hi_off, vec, n_split, slice_rows, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int4_gemv kernel launch failed (cudaError {err})")
    int4_gemv.launches += 1
    return out


def int4_gemv(x: torch.Tensor, w_b: torch.Tensor, scale: torch.Tensor,
              layout: str = "halfsplit") -> torch.Tensor:
    """``x [B, K] @ dequant(w_b, scale)`` in ``x.dtype``, shape [B, N].  CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise."""
    if x.device.type == "cpu":
        return int4_gemv_plain(x, w_b, scale, layout)
    if x.device.type != "cuda":
        raise ValueError(f"int4_gemv: unsupported device {x.device}")
    K, group = _check(x, w_b, scale, layout)
    R, N = w_b.shape
    if uses_mma(x.dtype, layout):
        return launch(x, w_b, scale, layout, K, group, copy_width(N, w_b.data_ptr()),
                      *cluster_plan(R, N))
    vec = vector_width(N, w_b.data_ptr())
    n_split = split_plan(R, N, vec, max_slice=MAX_SLICE)
    return launch(x, w_b, scale, layout, K, group, vec, n_split, -(-R // n_split))


int4_gemv.launches = 0
