"""Int8-weight matmul for the decode path: CUDA kernel wrapper and its plain
PyTorch version.

Kernel: ``csrc/int8_matmul.cu`` (hand-written for sm_90a, loaded with
ctypes).  It replaces the Pallas kernel
``dia_tts_prune_tpu/ops/kernels/int8_matmul.py::int8_matmul`` (:37):
``y[B, N] = (x[B, K] @ w_q[K, N]) * scale[N]`` with fp32 accumulation and one
rounding to ``x.dtype``.  Activations are never quantized.

At B <= 64 rows (the decode step has 2) this is a GEMV whose cost is the
int8 weight bytes; more rows (continuous-batching lanes past 32) go in
groups of 64, one launch each with the same plan.  bf16 activations (the decode path) take the tensor cores
in one cluster launch: a cluster of blocks owns a strip of ``STRIP`` columns,
each block a K slice (``cluster_plan``, from the weight's shape alone), and
the blocks add their fp32 partials in rank order on chip; the weight is read
once at any row count.  fp32 activations take the CUDA cores: column strips
× K slices (``split_plan``), each slice's fp32 partial summed in slice order
by a second small kernel.  Either way no atomics: the output is the same from
run to run, and a row's bits do not depend on the other rows.
"""

from __future__ import annotations

import ctypes

import torch

MAX_ROWS = 64  # rows of one launch (the JAX dispatcher's gate, ops/modules.py:160); more go in groups
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
# fp32 route (and the int4 GEMV, which shares it): from tools/torch_port_gemv_sweep.py
# on an H100, the model's five weight shapes are fastest at about eight blocks
# per SM with 64 to 256 rows each, and 4-byte loads are as fast as wider ones.
_TARGET_BLOCKS = 8 * 132
_LANES = 32
MAX_SLICE = 1024  # K rows a block keeps of x in shared memory (csrc: KS_MAX)
MIN_SLICE = 64
# bf16 route (csrc: namespace tc)
STRIP = 128  # columns of a cluster's strip (csrc: STRIP)
KSTEP = 16  # rows of an mma k-step (csrc: KSTEP)
STAGE_ROWS = 64  # weight rows a stage of the ring holds; slices are multiples of it (csrc: KC)
MAX_CLUSTER = 16  # blocks of a cluster (above the portable 8: the kernel opts in)
CLUSTER_BLOCKS = 3 * 132  # blocks a call aims for: as many as fit the SMs at once (3 each)
MIN_CLUSTER_SLICE = 64


def int8_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: int8 values widened exactly to fp32, fp32
    matmul, scales on the fp32 result, one rounding to ``x.dtype``."""
    return ((x.float() @ w_q.float()) * scale.float()[None, :]).to(x.dtype)


def vector_width(n_cols: int, data_ptr: int) -> int:
    """fp32 route: bytes a thread loads at once: 4 where that divides both a
    weight row's length and the weight's address, so that every load is
    aligned and lies wholly inside or outside a row; else 1."""
    return 4 if n_cols % 4 == 0 and data_ptr % 4 == 0 else 1


def split_plan(k_rows: int, n_cols: int, vec: int, max_slice: int = MAX_SLICE) -> int:
    """fp32 route: K slices for a [k_rows, n_cols] weight: enough that strips
    × slices fill the card, each slice within [MIN_SLICE, max_slice] rows."""
    strips = -(-n_cols // (_LANES * vec))
    want = -(-_TARGET_BLOCKS // strips)
    return max(-(-k_rows // max_slice), min(want, max(1, k_rows // MIN_SLICE)))


def copy_width(n_cols: int, data_ptr: int) -> int:
    """bf16 route: bytes of one ``cp.async`` of weight.  16 where the weight's
    address is 16-byte aligned and a row's length a multiple of 4 (rows whose
    start is not 16-byte aligned are copied from the boundary before it); else
    4 where that divides both; else 1."""
    if data_ptr % 16 == 0 and n_cols % 4 == 0:
        return 16
    return 4 if n_cols % 4 == 0 and data_ptr % 4 == 0 else 1


def cluster_plan(k_rows: int, n_cols: int) -> tuple[int, int]:
    """bf16 route: (blocks of a cluster, K rows of each block's slice) for a
    [k_rows, n_cols] weight.  The cluster doubles, up to ``MAX_CLUSTER``, while
    strips × blocks stay within ``CLUSTER_BLOCKS`` and the slices keep at least
    ``MIN_CLUSTER_SLICE`` rows; a slice is a whole number of stages.  It never
    sees the row count, so neither does a row's sum order."""
    strips = -(-n_cols // STRIP)
    cluster = 1
    while (cluster < MAX_CLUSTER and 2 * cluster * strips <= CLUSTER_BLOCKS
           and k_rows >= 2 * cluster * MIN_CLUSTER_SLICE):
        cluster *= 2
    return cluster, -(-k_rows // (cluster * STAGE_ROWS)) * STAGE_ROWS


def _check(x, w_q, scale):
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul takes float32 or bfloat16 activations, got {x.dtype}")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int8_matmul takes int8 weights and float32 scales, got "
                        f"{w_q.dtype}, {scale.dtype}")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] or 0 in w_q.shape:
        raise ValueError(f"int8_matmul shapes: x {tuple(x.shape)}, w_q {tuple(w_q.shape)}")
    if scale.shape != (w_q.shape[1],):
        raise ValueError(f"int8_matmul scale must be [N]: {tuple(scale.shape)}")
    if x.shape[0] < 1:
        raise ValueError("int8_matmul takes at least one row")
    if any(t.device != x.device for t in (w_q, scale)):
        raise ValueError("int8_matmul inputs must be on one device")
    if not all(t.is_contiguous() for t in (x, w_q, scale)):
        raise ValueError("int8_matmul inputs must be contiguous")


def launch(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, vec: int, n_split: int,
           slice_rows: int, out: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs of at most ``MAX_ROWS`` rows
    with a given load width and K slices (``int8_matmul`` plans them; a
    tuning sweep sets them), into ``out`` (contiguous rows) or a new tensor.
    bf16: the slices are the blocks of a cluster, no scratch; fp32: an fp32
    scratch of ``n_split`` partials."""
    from ._build import kernel_function

    fn = kernel_function("int8_matmul", "int8_matmul_fwd", _ARGTYPES)
    B, K = x.shape
    N = w_q.shape[1]
    if out is None:
        out = torch.empty(B, N, dtype=x.dtype, device=x.device)
    part = None
    if x.dtype == torch.float32 and n_split > 1:
        part = torch.empty(n_split * B * N, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), B, K, N, vec, n_split, slice_rows,
                 _DTYPE_CODES[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_matmul kernel launch failed (cudaError {err})")
    int8_matmul.launches += 1
    return out


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x [B, K] @ (w_q int8 [K, N] * scale [N])`` in ``x.dtype``.  CPU
    tensors take the plain version; CUDA tensors launch the kernel or raise.
    Above ``MAX_ROWS`` rows the kernel runs once for each group of
    ``MAX_ROWS`` rows, each with the same plan: a row's bits depend on its
    own values and the weight's shape only."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, w_q, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    _check(x, w_q, scale)
    K, N = w_q.shape
    if x.dtype == torch.bfloat16:
        plan = (copy_width(N, w_q.data_ptr()), *cluster_plan(K, N))
    else:
        vec = vector_width(N, w_q.data_ptr())
        n_split = split_plan(K, N, vec)
        plan = (vec, n_split, -(-K // n_split))
    return in_row_groups(x, N, lambda xg, out: launch(xg, w_q, scale, *plan, out=out))


def in_row_groups(x: torch.Tensor, n_cols: int, launch_group) -> torch.Tensor:
    """``launch_group(x_rows, out_rows)`` once for each group of ``MAX_ROWS``
    rows of ``x``, writing the rows of one [B, n_cols] output; one launch
    and no copy for up to ``MAX_ROWS`` rows."""
    B = x.shape[0]
    if B <= MAX_ROWS:
        return launch_group(x, None)
    out = torch.empty(B, n_cols, dtype=x.dtype, device=x.device)
    for g in range(0, B, MAX_ROWS):
        launch_group(x[g:g + MAX_ROWS], out[g:g + MAX_ROWS])
    return out


int8_matmul.launches = 0
