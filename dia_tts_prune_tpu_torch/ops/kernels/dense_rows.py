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

bf16 (the decode path) takes the int8 matmul's tensor-core design: a cluster
of blocks owns a strip of ``STRIP`` columns, each block a K slice
(``int8_matmul.cluster_plan``, from the weight's shape alone), the blocks add
their fp32 partials in rank order on chip; the rows go in groups of
``GROUP_ROWS``, each group with the same plan.  fp32 takes the CUDA cores:
column strips × K slices (``split_plan``), each slice's fp32 partial summed
in slice order by a second small kernel.  No atomics, no TF32.
"""

from __future__ import annotations

import ctypes

import torch

from .int8_matmul import cluster_plan, split_plan

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
GROUP_ROWS = 64  # rows a block multiplies (csrc: GROUP_ROWS); more rows are more groups


def dense_rows_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``x @ w``."""
    return x @ w


def copy_width(n_cols: int, data_ptr: int) -> int:
    """bf16 route: bytes of one ``cp.async`` of weight.  16 where the weight's
    address is 16-byte aligned and a row's length a multiple of 4 (rows whose
    start is not 16-byte aligned are copied from the boundary before it, 0 or
    8 bytes back); else 4 where the address is 4-byte aligned and a row's
    length even; else 2 (single values, copied synchronously)."""
    if data_ptr % 16 == 0 and n_cols % 4 == 0:
        return 16
    return 4 if n_cols % 2 == 0 and data_ptr % 4 == 0 else 2


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
        return launch(x, w, copy_width(N, w.data_ptr()), *cluster_plan(K, N))
    vec = vector_width(N, w.data_ptr())
    n_split = split_plan(K, N, vec)
    return launch(x, w, vec, n_split, -(-K // n_split))


dense_rows.launches = 0
