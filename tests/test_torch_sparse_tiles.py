"""The plan of the bf16 tensor-core block-sparse kernel, emulated on the CPU.

``csrc/block_sparse_matmul.cu`` cannot run here, so its plan is checked as
torch code that follows it block by block: the virtual-row map (slot s, row r
-> weight row ``indices[j, s] * block_k + r``, nothing past the count or past
K), the slices (``split_plan`` with the bf16 strip width, ``slice_rows``),
16-row steps summed into a fresh fp32 accumulator per slice, the tiles of
``MMA_TILES`` with their stage depths, and the two ways ``mma_plan`` maps
slices to blocks: each slice a block of its own, its partial added in slice
order by the finish pass, or one block running every slice and adding each
slice's accumulator to a running total in slice order.  The two must give
the same bits, whatever the tile, and a row's result must not depend on M.
A 16-row step is emulated as an elementwise fp32 chain, so that, as on the
card, an element's value depends on its own row and column only.  The kernel
itself is held to the plain version on the card by ``tests/test_torch_gpu.py``
and ``chip_smoke.py``.
"""

import inspect

import numpy as np
import pytest
import torch

from chip_smoke import GEMV_SUM_TOL, TOL
from dia_tts_prune_tpu_torch.ops.kernels import block_sparse_matmul_plain
from dia_tts_prune_tpu_torch.ops.kernels import sparse_matmul as tsm

torch.set_num_threads(1)

STAGE_ROWS = (64, 64, 64)  # listed rows per stage of each tile (csrc: Cfg::KC)


def _weight_rows(v: torch.Tensor, v_end: int, ids: torch.Tensor, block_k: int, K: int):
    """The kernel's ``weight_row``: -1 past the slice or past K."""
    kb = torch.div(v, block_k, rounding_mode="floor").clamp_max(ids.numel() - 1)
    k = ids[kb].long() * block_k + (v - kb * block_k)
    return torch.where((v < v_end) & (k < K), k, -1)


def emulate(x, w, indices, counts, block_k, block_n, tile, fused, n_split, reads=None):
    """``bsm_mma_kernel`` for every block of the grid, then (split route) the
    finish pass; returns the fp32 result before the one rounding.  ``reads``:
    a [K, N] int tensor counting the weight elements the first row tile's
    blocks copy."""
    M, K = x.shape
    N = w.shape[1]
    rows_t, cols_t = tsm.MMA_TILES[tile]
    kc = STAGE_ROWS[tile]
    max_blocks = indices.shape[1]
    slice_ = tsm.slice_rows(max_blocks, block_k, n_split)
    out = torch.zeros(M, N)
    part = torch.zeros(n_split, M, N)
    for j in range(-(-N // block_n)):
        tile_end = min(N, (j + 1) * block_n)
        length = int(counts[j]) * block_k
        for col0 in range(j * block_n, tile_end, cols_t):
            cols = torch.arange(col0, min(col0 + cols_t, tile_end))
            for m0 in range(0, M, rows_t):
                rows = torch.arange(m0, min(m0 + rows_t, M))
                ranges = ([(0, length)] if fused else
                          [(s * slice_, min(length, (s + 1) * slice_)) for s in range(n_split)])
                for s, (v_begin, v_end) in enumerate(ranges):
                    acc = torch.zeros(len(rows), len(cols))
                    total = torch.zeros(len(rows), len(cols))
                    n_chunks = -(-(v_end - v_begin) // kc) if v_end > v_begin else 0
                    for c in range(n_chunks):
                        v0 = v_begin + c * kc
                        for kk in range(kc // 16):
                            if v0 + kk * 16 >= v_end:
                                break
                            k = _weight_rows(torch.arange(v0 + kk * 16, v0 + kk * 16 + 16),
                                             v_end, indices[j], block_k, K)
                            ok = k >= 0
                            xs = torch.where(ok, x[rows][:, k.clamp_min(0)], 0.0)
                            ws = torch.where(ok[:, None], w[k.clamp_min(0)][:, cols], 0.0)
                            if reads is not None and m0 == 0:
                                reads[k[ok][:, None], cols[None]] += 1
                            for i in range(16):  # one 16-row step, per element
                                acc = acc + xs[:, i, None] * ws[i][None, :]
                        vn = v0 + kc
                        if fused and (vn >= v_end or vn % slice_ == 0):
                            total = total + acc
                            acc = torch.zeros_like(acc)
                    if fused:
                        out[rows[:, None], cols[None]] = total
                    else:
                        part[s][rows[:, None], cols[None]] = acc
    if fused:
        return out
    if n_split == 1:
        return part[0]
    total = torch.zeros(M, N)
    for s in range(n_split):  # the finish pass: 0 + p0 + p1 + ...
        total = total + part[s]
    return total


def _case(seed, M, K, N, bk, bn, density=0.5):
    """bf16 values of x and a weight with about ``density`` of its blocks
    kept (the first N-tile empty), widened to fp32, and its plan."""
    rng = np.random.default_rng(seed)
    kept = rng.random((-(-K // bk), -(-N // bn))) < density
    kept[:, 0] = False
    kept[0, -1] = True
    w = rng.normal(size=(K, N)).astype(np.float32) / np.sqrt(K)
    w *= np.repeat(np.repeat(kept, bk, 0), bn, 1)[:K, :N]
    w = torch.from_numpy(w).bfloat16().float()
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).bfloat16().float()
    plan = tsm.plan_block_sparsity(w, bk, bn)
    return x, w, plan.indices, plan.counts


# (M, K, N, block_k, block_n): the decode blocks at a small width, ragged K
# and N, blocks narrower than a stage, more rows than one 128-row tile
SHAPES = [(40, 512, 512, 64, 128), (70, 320, 200, 32, 64), (5, 100, 150, 32, 64),
          (130, 640, 512, 64, 256)]
SHAPE_IDS = ["x".join(map(str, s)) for s in SHAPES]


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_every_slice_map_and_tile_gives_the_same_bits(shape):
    """All slices in one block (fresh accumulator per slice, added in slice
    order) equals slices in separate blocks plus the finish pass, bit for
    bit, at every tile shape; the result meets the chip's GEMV gate against
    the plain version, and each row equals its 2-row run."""
    M, K, N, bk, bn = shape
    x, w, idx, cnt = _case(sum(shape), M, K, N, bk, bn)
    n_split = tsm.bf16_split(N, bk, bn, idx.shape[1])
    assert n_split > 1
    split = emulate(x, w, idx, cnt, bk, bn, 0, False, n_split)
    for tile, fused in ((1, False), (1, True), (2, False), (2, True)):
        assert torch.equal(emulate(x, w, idx, cnt, bk, bn, tile, fused, n_split), split)
    ref = block_sparse_matmul_plain(x, w, idx, cnt, bk, bn)
    listed = tsm.listed_mask(idx, cnt, K, N, bk, bn)
    sum_abs = x.abs() @ torch.where(listed, w.abs(), 0.0)
    assert ((split - ref).abs() <= GEMV_SUM_TOL * sum_abs + TOL["float32"]["atol"]).all()
    assert (split[:, :bn] == 0).all()  # the empty tile: exact zeros
    for r0 in range(0, M - 1, 2):
        assert torch.equal(emulate(x[r0:r0 + 2], w, idx, cnt, bk, bn, 0, False, n_split),
                           split[r0:r0 + 2])


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("tile,fused", [(0, False), (1, True), (2, True)])
def test_the_kernels_plan_reads_only_listed_blocks(shape, tile, fused):
    """Each row tile's blocks copy every listed weight element once and no
    other; NaN in every unlisted element changes nothing."""
    M, K, N, bk, bn = shape
    x, w, idx, cnt = _case(sum(shape) + 1, M, K, N, bk, bn)
    n_split = tsm.bf16_split(N, bk, bn, idx.shape[1])
    reads = torch.zeros(K, N, dtype=torch.int64)
    clean = emulate(x, w, idx, cnt, bk, bn, tile, fused, n_split, reads)
    listed = tsm.listed_mask(idx, cnt, K, N, bk, bn)
    assert torch.equal(reads, listed.long())
    poisoned = torch.where(listed, w, float("nan"))
    assert torch.equal(emulate(x, poisoned, idx, cnt, bk, bn, tile, fused, n_split), clean)


# the five weight shapes of a Dia-1.6B decode step (K, N)
DECODE_SHAPES = [(2048, 2048), (2048, 512), (2048, 16384), (8192, 2048), (2048, 9252)]


@pytest.mark.parametrize("K,N", DECODE_SHAPES, ids=["%dx%d" % s for s in DECODE_SHAPES])
def test_split_plan_with_the_strip_width_ignores_the_row_count(K, N):
    """The slices come from the weight's shape and plan only; the tile and
    the slice map may follow M: 16-row tiles in separate slices at decode,
    one block per tile running every slice once the row tiles fill the card."""
    for fn in (tsm.split_plan, tsm.bf16_split):
        assert not {"M", "n_rows", "rows"} & set(inspect.signature(fn).parameters)
    for max_blocks in (K // 256 // 2, K // 256):
        planned = tsm.split_plan(N, 256, 256, max_blocks, tsm.STRIP,
                                 target_blocks=tsm._BF16_TARGET_BLOCKS)
        n_split = tsm.bf16_split(N, 256, 256, max_blocks)
        slice_ = tsm.slice_rows(max_blocks, 256, n_split)
        # every slice holds rows, and the kernel's slice length is the planned one
        assert n_split <= planned and slice_ == tsm.slice_rows(max_blocks, 256, planned)
        assert slice_ % tsm.SLICE_ALIGN == 0 and (n_split - 1) * slice_ < max_blocks * 256
        vec = tsm.vector_width(torch.bfloat16, K, N, 256, 256, 0, 0)
        assert vec == (8 if N % 8 == 0 else 4)
        plans = {M: tsm.mma_plan(M, N, 256, vec, n_split) for M in (1, 2, 8, 16, 64, 512)}
        assert all(plans[M] == (0, False) for M in (1, 2, 8, 16))
        assert plans[64] == (1, False) and plans[512][0] == 2
        if N >= 9252:
            assert plans[512] == (2, n_split > 1)
    assert tsm.mma_plan(512, 2048, 256, 1, 5) == (0, False)  # element loads: 16-row tiles
