"""Block-sparse matmul for pruned weights: CUDA kernel wrapper, its plain
PyTorch version, and the plan that compresses a weight's zero blocks.

Kernel: ``csrc/block_sparse_matmul.cu`` (hand-written for sm_90a, loaded with
ctypes).  It replaces the Pallas kernel
``dia_tts_prune_tpu/ops/kernels/sparse_matmul.py::block_sparse_matmul`` (:89):
``y = x @ w`` reading only the weight blocks the plan lists — per N-tile of
``block_n`` columns, ``indices[j, :counts[j]]`` are its nonzero K-blocks of
``block_k`` rows — with fp32 accumulation and one rounding to ``x.dtype``.
The weight stays stored dense (pruned blocks are zeros), so an unlisted block
costs nothing but its bytes in memory.

The decode step is bound by weight bytes, so the kernel reads the listed
blocks only, split over column strips and slices of the listed rows, with
fp32 partials summed in a fixed order (no atomics).  The split depends on
K, N and the plan, never on the row count, so a row's result does not depend
on which rows ride with it (batched lanes equal their single-stream runs).
Every row count goes to the kernel: the JAX dispatcher sends prompt prefill
and the cross K/V projection through its Pallas kernel too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_TARGET_BLOCKS = 8 * 132  # about eight blocks per SM, as the int8 kernel's plan
_LANES = 32
MAX_SLICE = 1024  # listed rows a block keeps of x in shared memory (csrc: KS_MAX)
MIN_SLICE = 64


class BlockSparsePlan(NamedTuple):
    indices: torch.Tensor  # int32 [n_tiles_n, max_blocks] K-block ids (clamp-padded)
    counts: torch.Tensor  # int32 [n_tiles_n]
    block_k: int
    block_n: int
    density: float


def plan_block_sparsity(w, block_k: int = 256, block_n: int = 256) -> BlockSparsePlan:
    """Compress the zero-block structure of a pruned [K, N] weight (the JAX
    package's ``plan_block_sparsity`` :41): a K-block of an N-tile is listed
    iff any of its entries is nonzero; padding slots repeat the last real id."""
    from ..sparse import _pack_indices, _plan_one

    w = torch.as_tensor(w)
    nonzero, counts = _plan_one(w, block_k, block_n)
    indices = _pack_indices(nonzero, counts, max(1, int(counts.max(initial=0))))
    return BlockSparsePlan(indices=torch.from_numpy(indices), counts=torch.from_numpy(counts),
                           block_k=block_k, block_n=block_n, density=float(nonzero.mean()))


def block_sparse_matmul_plain(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                              counts: torch.Tensor, block_k: int, block_n: int) -> torch.Tensor:
    """Plain PyTorch version: the fp32 product over the listed blocks only —
    every unlisted block is replaced by zeros here, whatever ``values``
    stores there, so a plan that leaves out a nonzero block gives a wrong
    number instead of being hidden by the stored zeros — and one rounding to
    ``x.dtype``."""
    K, N = values.shape
    return (x.float() @ torch.where(listed_mask(indices, counts, K, N, block_k, block_n),
                                    values.float(), 0.0)).to(x.dtype)


def listed_mask(indices: torch.Tensor, counts: torch.Tensor, K: int, N: int, block_k: int,
                block_n: int) -> torch.Tensor:
    """bool [K, N]: True on the weight entries of the plan's listed blocks."""
    nn, max_blocks = indices.shape
    slot_ok = torch.arange(max_blocks, device=indices.device)[None] < counts[:, None]
    tiles = torch.arange(nn, device=indices.device)[:, None].expand(nn, max_blocks)
    listed = torch.zeros(-(-K // block_k), nn, dtype=torch.bool, device=indices.device)
    listed[indices[slot_ok].long(), tiles[slot_ok]] = True
    return listed.repeat_interleave(block_k, 0)[:K].repeat_interleave(block_n, 1)[:, :N]


def vector_width(dtype: torch.dtype, n_cols: int, block_n: int, data_ptr: int) -> int:
    """Columns a lane loads at once: two bf16 values (4 bytes) where 2
    divides the row length, the tile width and the weight's address in
    elements; else one."""
    if dtype == torch.bfloat16 and n_cols % 2 == 0 and block_n % 2 == 0 and data_ptr % 4 == 0:
        return 2
    return 1


def split_plan(n_cols: int, block_k: int, block_n: int, max_blocks: int, vec: int,
               max_slice: int = MAX_SLICE) -> int:
    """Slices of each tile's ``max_blocks * block_k`` listed rows: enough that
    strips × slices fill the card, each within [MIN_SLICE, max_slice] rows.
    It reads the weight's shape and the plan only — never the row count."""
    rows = max_blocks * block_k
    strips = -(-n_cols // block_n) * -(-block_n // (_LANES * vec))
    want = -(-_TARGET_BLOCKS // strips)
    return max(-(-rows // max_slice), min(want, max(1, rows // MIN_SLICE)))


def _check(x, values, indices, counts, block_k, block_n):
    if x.dtype not in _DTYPE_CODES or values.dtype != x.dtype:
        raise TypeError(f"block_sparse_matmul takes float32 or bfloat16 x and weights of the same "
                        f"dtype, got {x.dtype}, {values.dtype}")
    if indices.dtype != torch.int32 or counts.dtype != torch.int32:
        raise TypeError("block_sparse_matmul takes int32 indices and counts")
    if x.dim() != 2 or values.dim() != 2 or x.shape[1] != values.shape[0] or 0 in x.shape \
            or 0 in values.shape:
        raise ValueError(f"block_sparse_matmul shapes: x {tuple(x.shape)}, "
                         f"values {tuple(values.shape)}")
    if block_k <= 0 or block_n <= 0:
        raise ValueError(f"block_sparse_matmul blocks must be positive: {block_k}, {block_n}")
    n_tiles = -(-values.shape[1] // block_n)
    if indices.dim() != 2 or indices.shape[0] != n_tiles or indices.shape[1] < 1 \
            or counts.shape != (n_tiles,):
        raise ValueError(f"block_sparse_matmul plan: indices {tuple(indices.shape)}, counts "
                         f"{tuple(counts.shape)} for {n_tiles} tiles of {block_n} columns")
    if any(t.device != x.device for t in (values, indices, counts)):
        raise ValueError("block_sparse_matmul inputs must be on one device")
    if not all(t.is_contiguous() for t in (x, values, indices, counts)):
        raise ValueError("block_sparse_matmul inputs must be contiguous")


def launch(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor, counts: torch.Tensor,
           block_k: int, block_n: int, vec: int, n_split: int) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs with a given load width and
    number of slices (``block_sparse_matmul`` plans both)."""
    from ._build import kernel_function

    fn = kernel_function("block_sparse_matmul", "block_sparse_matmul_fwd", _ARGTYPES)
    M, K = x.shape
    N = values.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    part = torch.empty(n_split * M * N if n_split > 1 else 1, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), values.data_ptr(), indices.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), part.data_ptr(), M, K, N, block_k, block_n, indices.shape[1],
                 vec, n_split, _DTYPE_CODES[x.dtype],
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"block_sparse_matmul kernel launch failed (cudaError {err})")
    block_sparse_matmul.launches += 1
    return out


def block_sparse_matmul(x: torch.Tensor, values: torch.Tensor, indices: torch.Tensor,
                        counts: torch.Tensor, block_k: int = 256,
                        block_n: int = 256) -> torch.Tensor:
    """``x [M, K] @ values [K, N]`` over the listed blocks only, in
    ``x.dtype``.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (any M) or raise."""
    if x.device.type == "cpu":
        return block_sparse_matmul_plain(x, values, indices, counts, block_k, block_n)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul: unsupported device {x.device}")
    _check(x, values, indices, counts, block_k, block_n)
    vec = vector_width(x.dtype, values.shape[1], block_n, values.data_ptr())
    n_split = split_plan(values.shape[1], block_k, block_n, indices.shape[1], vec)
    return launch(x, values, indices, counts, block_k, block_n, vec, n_split)


block_sparse_matmul.launches = 0
