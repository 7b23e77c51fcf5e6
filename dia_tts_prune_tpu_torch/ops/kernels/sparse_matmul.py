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
fp32 partials summed in slice order (no atomics).  bf16 runs on the tensor
cores (``mma.sync`` tiles of 16, 64 or 128 rows, picked by ``mma_plan``),
fp32 on the CUDA cores.  The slices depend on K, N and the plan, never on
the row count, and every tile shape sums an element in the same order, so a
row's result does not depend on which rows ride with it (batched lanes equal
their single-stream runs).  Every row count goes to the kernel: the JAX
dispatcher sends prompt prefill and the cross K/V projection through its
Pallas kernel too.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_TARGET_BLOCKS = 8 * 132  # about eight blocks per SM, as the int8 kernel's plan
_SMS = 132
# bf16: four 16-row blocks per SM, each streaming a longer slice (measured on
# an H100 against 1056: every decode shape as fast or faster)
_BF16_TARGET_BLOCKS = 4 * 132
_LANES = 32  # columns of an fp32 block's strip
STRIP = 64  # columns of the bf16 decode tile's strip (csrc: tc::Small::SN)
MAX_SLICE = 1024  # listed rows an fp32 block keeps of x in shared memory (csrc: KS_MAX)
MIN_SLICE = 64
SLICE_ALIGN = 64  # bf16 slices start at multiples of 64 listed rows (csrc: SLICE_ALIGN)
# rows x columns of the bf16 kernel's tiles (csrc: tc::Small, tc::Medium, tc::Large)
MMA_TILES = ((16, 64), (64, 64), (128, 128))


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


def vector_width(dtype: torch.dtype, k_rows: int, n_cols: int, block_k: int, block_n: int,
                 *data_ptrs: int) -> int:
    """How the bf16 kernel copies: in units of 8 values where 8 divides both
    block sides, with every row 16-byte aligned (8: 8 divides K, N and every
    address in elements) or 8-byte aligned (4: a unit whose row starts 8
    bytes off goes as two halves); else 1 (element loads).  fp32: 1."""
    if dtype != torch.bfloat16 or block_k % 8 or block_n % 8:
        return 1
    for vec in (8, 4):
        if k_rows % vec == 0 and n_cols % vec == 0 and all(p % (2 * vec) == 0 for p in data_ptrs):
            return vec
    return 1


def split_plan(n_cols: int, block_k: int, block_n: int, max_blocks: int, strip: int,
               max_slice: int = MAX_SLICE, target_blocks: int = _TARGET_BLOCKS) -> int:
    """Slices of each tile's ``max_blocks * block_k`` listed rows: enough that
    column strips of ``strip`` columns × slices make ``target_blocks``, each
    within [MIN_SLICE, max_slice] rows.  It reads the weight's shape and the
    plan only — never the row count."""
    rows = max_blocks * block_k
    strips = -(-n_cols // block_n) * -(-block_n // strip)
    want = -(-target_blocks // strips)
    return max(-(-rows // max_slice), min(want, max(1, rows // MIN_SLICE)))


def slice_rows(max_blocks: int, block_k: int, n_split: int) -> int:
    """Listed rows of one bf16 slice (csrc computes the same): the even share
    rounded up to SLICE_ALIGN, so every tile shape's stage of rows ends on a
    slice bound."""
    share = -(-max_blocks * block_k // n_split)
    return -(-share // SLICE_ALIGN) * SLICE_ALIGN


def bf16_split(n_cols: int, block_k: int, block_n: int, max_blocks: int) -> int:
    """The bf16 kernel's slices: ``split_plan`` at the decode tile's strip
    width, less the slices that rounding the share up left empty (the slice
    length stays the same).  Like ``split_plan``, it never reads the row
    count."""
    n_split = split_plan(n_cols, block_k, block_n, max_blocks, STRIP,
                         target_blocks=_BF16_TARGET_BLOCKS)
    return -(-max_blocks * block_k // slice_rows(max_blocks, block_k, n_split))


def mma_plan(n_rows: int, n_cols: int, block_n: int, vec: int, n_split: int) -> tuple[int, bool]:
    """(tile, fused) for the bf16 kernel: the tile of ``MMA_TILES`` (16 rows
    up to 16, 64 up to 64, 128 beyond; 16 with element loads), and whether
    each block runs every slice of its tile instead of one slice with a
    finish pass: with 128-row tiles, once the row tiles alone fill the card
    (there the partials would outweigh the weight; at 64 rows the finish pass
    measured faster).  It may read the row count: each element's sum is the
    same chain whatever the choice."""
    tile = 0 if vec == 1 or n_rows <= 16 else 1 if n_rows <= 64 else 2
    rows, cols = MMA_TILES[tile]
    blocks = -(-n_rows // rows) * -(-n_cols // block_n) * -(-block_n // cols)
    return tile, tile == 2 and n_split > 1 and blocks >= _SMS


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
           block_k: int, block_n: int, vec: int, n_split: int, tile: int = 0,
           fused: bool = False) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs with a given load width,
    number of slices and (bf16) tile and slice mapping (``block_sparse_matmul``
    plans them all)."""
    from ._build import kernel_function

    fn = kernel_function("block_sparse_matmul", "block_sparse_matmul_fwd", _ARGTYPES)
    M, K = x.shape
    N = values.shape[1]
    out = torch.empty(M, N, dtype=x.dtype, device=x.device)
    part = torch.empty(n_split * M * N if n_split > 1 and not fused else 1, dtype=torch.float32,
                       device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), values.data_ptr(), indices.data_ptr(), counts.data_ptr(),
                 out.data_ptr(), part.data_ptr(), M, K, N, block_k, block_n, indices.shape[1],
                 vec, n_split, _DTYPE_CODES[x.dtype], tile, int(fused),
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
    (M, K), N = x.shape, values.shape[1]
    if x.dtype == torch.float32:
        n_split = split_plan(N, block_k, block_n, indices.shape[1], _LANES)
        return launch(x, values, indices, counts, block_k, block_n, 1, n_split)
    vec = vector_width(x.dtype, K, N, block_k, block_n, x.data_ptr(), values.data_ptr())
    n_split = bf16_split(N, block_k, block_n, indices.shape[1])
    tile, fused = mma_plan(M, N, block_n, vec, n_split)
    return launch(x, values, indices, counts, block_k, block_n, vec, n_split, tile, fused)


block_sparse_matmul.launches = 0
