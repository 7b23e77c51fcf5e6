"""Float-weight product for the decode step's rows: CUDA kernel wrapper and
its plain PyTorch version.

Kernel: ``csrc/dense_rows.cu`` (hand-written for sm_90a, loaded with ctypes).
It replaces no Pallas kernel: the JAX package computes the decode step's
float contractions with XLA (``dia_tts_prune_tpu/ops/modules.py::
dense_general``).  It exists so that a row's bits depend on its own values
and the weight's shape only, at any row count: ``y[M, N] = x[M, K] @ w[K, N]``
with fp32 sums and one rounding to ``x.dtype``.  cuBLAS picks its algorithm,
and with it each output's sum order, by the problem size, so a continuous-
batching lane or a speculative verify row would leave its solo run.

bf16 (the decode path): TMA boxes of the weight and of x into a ring of
128-byte-swizzled stages, ``wgmma.m64n16k16`` with the weight as the A
operand straight from shared memory, one instruction shape over every
16-row tile; a cluster of blocks owns a strip of ``STRIP`` columns, each
block a K slice (``row_plan``, from the weight's shape alone), the blocks add
their fp32 partials in rank order on chip; the weight is read once for up to
``GROUP_ROWS`` rows, more rows go in groups, each with the same plan.  A
weight that no tensor map describes (the logits head: rows of 18504 bytes)
is copied by threads, 8 bytes a ``cp.async``, into the same layout, x still
by TMA.  fp32 takes the CUDA cores:
column strips × K slices (``split_plan``), each slice's fp32 partial summed
in slice order by a second small kernel.  No atomics, no TF32.
"""

from __future__ import annotations

import ctypes

import torch

from .int8_matmul import split_plan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# bf16 route (csrc: namespace tc)
GROUP_ROWS = 128  # rows a block multiplies (csrc: GROUP_ROWS); more rows are more groups
STRIP = 128  # columns of a block's strip (csrc: STRIP)
STAGE_ROWS = 64  # weight rows a stage holds; slices are multiples of it (csrc: KC)
MAX_CLUSTER = 16  # blocks of a cluster (above the portable 8: the kernel opts in)
# from tools/torch_dense_rows_sweep.py on an H100: at 2 and at 80 rows the five
# decode shapes are fastest with at most ~64 blocks and slices of 256 rows or more
# (fewer ranks to merge; an SM streams more than its 1/132 of the memory rate)
PLAN_BLOCKS = 64  # blocks a call aims for at most
MIN_SLICE = 256  # K rows a block's slice keeps at least: four stages
TMA = 16  # the entry's vec for TMA boxes (else bytes of a copying thread's unit)


def dense_rows_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x @ w``."""
    return x @ w


def weight_route(n_cols: int, data_ptr: int) -> int:
    """bf16 route: how the weight reaches shared memory (the entry's ``vec``).
    ``TMA`` (16): boxes of the [K, N] weight, where a tensor map can describe
    it (address 16-byte aligned, a row a multiple of 16 bytes); else bytes of
    one ``cp.async`` by the copying threads: 8 where the address is 8-byte
    aligned and a row's length a multiple of 4 (the logits head, rows of
    18504 bytes: x still by TMA where ``x_by_tma``), 4 where 4-byte aligned
    and even, else 2 (single values, copied synchronously)."""
    if data_ptr % 16 == 0 and n_cols % 8 == 0:
        return TMA
    if data_ptr % 8 == 0 and n_cols % 4 == 0:
        return 8
    return 4 if n_cols % 2 == 0 and data_ptr % 4 == 0 else 2


def x_by_tma(k_cols: int, data_ptr: int) -> bool:
    """bf16 route: whether a tensor map can describe x (address 16-byte
    aligned, a row a multiple of 16 bytes); the TMA route needs both."""
    return data_ptr % 16 == 0 and k_cols % 8 == 0


def row_plan(k_rows: int, n_cols: int) -> tuple[int, int]:
    """bf16 route: (blocks of a cluster, K rows of each block's slice) for a
    [k_rows, n_cols] weight.  The cluster doubles, up to ``MAX_CLUSTER``, while
    strips × blocks stay within ``PLAN_BLOCKS`` and the slices keep at least
    ``MIN_SLICE`` rows; a slice is a whole number of stages.  It never sees
    the row count, so neither does a row's sum order."""
    strips = -(-n_cols // STRIP)
    cluster = 1
    while (cluster < MAX_CLUSTER and 2 * cluster * strips <= PLAN_BLOCKS
           and k_rows >= 2 * cluster * MIN_SLICE):
        cluster *= 2
    return cluster, -(-k_rows // (cluster * STAGE_ROWS)) * STAGE_ROWS


def vector_width(n_cols: int, data_ptr: int) -> int:
    """fp32 route: floats a lane loads at once: 4 where the weight's address
    is 16-byte aligned and a row's length a multiple of 4; else 1."""
    return 4 if n_cols % 4 == 0 and data_ptr % 16 == 0 else 1


def _check(x, w):
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"dense_rows takes float32 or bfloat16 x and w of one dtype, got "
                        f"{x.dtype}, {w.dtype}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or 0 in (*x.shape, *w.shape):
        raise ValueError(f"dense_rows shapes: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError("dense_rows inputs must be on one device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("dense_rows inputs must be contiguous")


def launch(x: torch.Tensor, w: torch.Tensor, vec: int, n_split: int,
           slice_rows: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs with a given copy or load
    width and K slices (``dense_rows`` plans them).  bf16: the slices are the
    blocks of a cluster, no scratch; fp32: an fp32 scratch of ``n_split``
    partials."""
    from ._build import kernel_function

    fn = kernel_function("dense_rows", "dense_rows_fwd", _ARGTYPES)
    M, K = x.shape
    N = w.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    part = None
    if x.dtype == torch.float32 and n_split > 1:
        part = torch.empty(n_split * M * N, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), M, K, N, vec, n_split, slice_rows,
                 _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dense_rows kernel launch failed (cudaError {err})")
    dense_rows.launches += 1
    return out


def dense_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N]`` in ``x.dtype``, a row's bits independent of M.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if x.device.type == "cpu":
        return dense_rows_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"dense_rows: unsupported device {x.device}")
    _check(x, w)
    K, N = w.shape
    if x.dtype == torch.bfloat16:
        vec = weight_route(N, w.data_ptr())
        if vec == TMA and not x_by_tma(K, x.data_ptr()):
            vec = 8  # an x no tensor map takes: the copying threads take both
        return launch(x, w, vec, *row_plan(K, N))
    vec = vector_width(N, w.data_ptr())
    n_split = split_plan(K, N, vec)
    return launch(x, w, vec, n_split, -(-K // n_split))


dense_rows.launches = 0
