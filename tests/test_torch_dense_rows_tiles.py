"""The arithmetic of the dense-rows and RMSNorm kernels, emulated on the CPU.

``csrc/dense_rows.cu`` and ``csrc/rms_norm.cu`` cannot run here, so their
plans are checked as torch code that follows them block by block, with the
constants read from the sources.

dense_rows, bf16 (TMA and wgmma): rows in groups of GROUP_ROWS, each group
padded to whole row tiles of ROW_TILE rows whose padding is NaN here (the
kernel fills zeros: a wgmma output reads only its own row of x, so the
padding stays in its own rows); a cluster of blocks owns a strip of STRIP
columns, block ``rank`` the K slice of ``dense_rows.row_plan``; it walks the
slice in stages of KC rows and KSTEP-row k-steps from the slice start (every
step of a stage, rows past K zero in both operands), each step's products
added to the fp32 accumulator at once (the tensor core's sum, emulated in
float64: a product of two bf16 is exact there); the blocks' partials are
added in rank order and rounded once.  fp32 (the CUDA-core route, unchanged):
``split_plan``'s slices, row tiles of 2, 4 or 8 rows, four warps each walking
every fourth row of a slice with fused multiply-adds, the warps' sums added in
warp order and the slices' in slice order.  RMSNorm, bf16 at widths that are
a multiple of 8 up to 8192: ``row_warps(D)`` warps a row, lane l of warp w
summing its 16-byte units (j * row_warps + w) * 32 + l in order with fused
multiply-adds, an XOR shuffle tree, the warps in warp order; fp32 and other
widths (unchanged): a block a row of ``threads(D)`` threads, each summing its
strided elements with fused multiply-adds, a shuffle-down tree to lane 0, the
warps in warp order; then one factor, ``(x * factor) * scale``.

The emulations are held to the plain versions at the gates ``chip_smoke.py``
holds the kernels to on the card; they show that a row's bits depend on its
own values and the weight's shape only (at 1, 2, 16, 64, 80, 128 and 130
rows), that the TMA boxes and the copying threads cover each weight element
exactly once, and that the wgmma descriptors read back what TMA's swizzle
wrote.  The RMSNorm gradient that the card's autograd route uses is checked
against autograd through the plain version.  The kernels themselves are held
to their plain versions on the card by ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import GEMV_SHAPES, GEMV_SUM_TOL, TOL
from dia_tts_prune_tpu_torch.ops.kernels import dense_rows_plain, rms_norm_plain

torch.set_num_threads(1)

i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
dr = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.dense_rows")
rn = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.rms_norm")
CSRC = Path(__file__).resolve().parents[1] / "dia_tts_prune_tpu_torch" / "csrc"
SOURCE = (CSRC / "dense_rows.cu").read_text()
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE)}
STRIP, TILE, KSTEP, KC = CONST["STRIP"], CONST["TILE"], CONST["KSTEP"], CONST["KC"]
ROW_TILE, GROUP_ROWS, NWARPS = CONST["ROW_TILE"], CONST["GROUP_ROWS"], CONST["NWARPS"]
RING_BYTES = eval(re.search(r"constexpr int RING_BYTES = ([\d *]+);", SOURCE).group(1))
NORM_CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                                (CSRC / "rms_norm.cu").read_text())}
BOX_BYTES = KC * TILE * 2  # one weight box: KC rows of 128 bytes
PRODUCERS = CONST["PRODUCERS"]
UNITS_8 = STRIP * 2 // 8  # the 8-byte route: units of a strip's row (csrc: UNITS_8)
ROWS_8 = PRODUCERS // UNITS_8  # rows its threads take at once (csrc: ROWS_8)


def row_tiles(m: int) -> int:
    """The kernel's row tiles of ROW_TILE rows for a call of ``m`` rows
    (``row_tiles``): a group's rows rounded up, the N of its one wgmma."""
    return -(-min(m, GROUP_ROWS) // ROW_TILE)


def stages(tb: int) -> int:
    """Stages of the ring at ``tb`` row tiles (``Smem<TB>::STAGES``)."""
    return RING_BYTES // ((STRIP // TILE) * BOX_BYTES + ROW_TILE * tb * KC * 2)


def smem_bytes(tb: int) -> int:
    """Dynamic shared memory of a block at ``tb`` row tiles (``Smem<TB>::BYTES``)."""
    stage = (STRIP // TILE) * BOX_BYTES + ROW_TILE * tb * KC * 2
    barriers = -(-(2 * stages(tb) + 1) * 8 // 16) * 16
    return stages(tb) * stage + barriers + STRIP * (ROW_TILE * tb + 2) * 4 + 1024


def swz(r, b):
    """Byte ``b`` of row ``r`` in 128-byte rows as TMA's SWIZZLE_128B lays it
    down (csrc: ``swz``): the 16-byte chunk index XOR the row mod 8."""
    return r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15)


def emulate_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The TMA and wgmma route's output [M, N] in bf16."""
    M, K = x.shape
    N = w.shape[1]
    cluster, slice_ = dr.row_plan(K, N)
    tile_rows = ROW_TILE * row_tiles(M)
    wd = w.double()
    out = []
    for g0 in range(0, M, GROUP_ROWS):
        xg = x[g0:g0 + GROUP_ROWS].double()
        B = xg.shape[0]
        xd = torch.cat([xg, torch.full((tile_rows - B, K), float("nan"), dtype=torch.float64)])
        parts = []
        for rank in range(cluster):
            k0 = min(K, rank * slice_)
            k1 = min(K, k0 + slice_)
            acc = torch.zeros(tile_rows, N)
            for c in range(-(-(k1 - k0) // KC)):
                for kk in range(KC // KSTEP):  # every step of a stage: past K zeros in both
                    ks = k0 + c * KC + kk * KSTEP
                    ke = max(ks, min(ks + KSTEP, k1))
                    acc = (acc.double() + xd[:, ks:ke] @ wd[ks:ke]).float()
            parts.append(acc)
        total = parts[0]
        for p in parts[1:]:  # rank order
            total = total + p
        out.append(total[:B])
    return torch.cat(out).to(x.dtype)


def emulate_fp32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The CUDA-core route's output [M, N] in fp32."""
    M, K = x.shape
    N = w.shape[1]
    n_split = i8.split_plan(K, N, dr.vector_width(N, 0))
    slice_ = -(-K // n_split)
    rows = 2 if M <= 2 else 4 if M <= 4 else 8  # dispatch_fp32_rows
    wd = w.double()
    out = []
    for b0 in range(0, M, rows):
        xd = torch.zeros(rows, K, dtype=torch.float64)  # rows past M: zeros
        xd[:min(rows, M - b0)] = x[b0:b0 + rows].double()
        parts = []
        for s in range(n_split):
            k0, k1 = s * slice_, min(K, (s + 1) * slice_)
            acc = torch.zeros(NWARPS, rows, N)  # warp w: rows k0 + w, k0 + w + NWARPS, ...
            for k in range(k0, k1, NWARPS):
                n = min(NWARPS, k1 - k)
                fma = acc[:n].double() + xd[:, k:k + n].T[:, :, None] * wd[k:k + n, None, :]
                acc[:n] = fma.float()
            v = acc[0]
            for wi in range(1, NWARPS):  # warp order
                v = v + acc[wi]
            parts.append(v)
        if n_split == 1:
            total = parts[0]
        else:
            total = torch.zeros(rows, N)
            for p in parts:  # the finish pass: 0 + p0 + p1 + ...
                total = total + p
        out.append(total[:min(rows, M - b0)])
    return torch.cat(out)


def emulate_block_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The block-a-row RMSNorm kernel's output (fp32 rows, other widths), row by
    row, in x's dtype."""
    rows, D = x.reshape(-1, x.shape[-1]).shape
    T = rn.threads(D)
    x32 = x.reshape(rows, D).float()
    acc = torch.zeros(rows, T)
    for j in range(-(-D // T)):  # thread i: elements i, i + T, ... in order, fused
        i = torch.arange(T) + j * T
        v = torch.where(i < D, x32[:, i.clamp_max(D - 1)], 0.0).double()
        acc = (acc.double() + v * v).float()
    lanes = acc.reshape(rows, T // 32, 32)
    for off in (16, 8, 4, 2, 1):  # shuffle down: lane l adds lane l + off
        shifted = torch.cat([lanes[..., off:], lanes[..., -off:]], dim=-1)
        lanes = lanes + shifted
    total = lanes[..., 0, 0]
    for wi in range(1, T // 32):  # warp order
        total = total + lanes[..., wi, 0]
    factor = torch.rsqrt(total / D + eps)[:, None]
    return (x32 * factor * scale.float()).to(x.dtype).reshape(x.shape)


def emulate_row_warps_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The bf16 warps-a-row RMSNorm kernel's output, row by row: lane l of
    warp w sums the squares of its 16-byte units (j * rw + w) * 32 + l, j <
    LANE_UNITS, value by value with fused multiply-adds; an XOR shuffle tree
    (every lane ends with the same sum); the row's warps in warp order."""
    rows, D = x.reshape(-1, x.shape[-1]).shape
    rw = rn.row_warps(D, x.dtype)
    x32 = x.reshape(rows, D).float()
    acc = torch.zeros(rows, rw, 32)
    for j in range(rn.LANE_UNITS):
        u = (j * rw + torch.arange(rw)[:, None]) * 32 + torch.arange(32)  # [rw, 32]
        for e in range(8):
            i = u * 8 + e
            v = torch.where(i < D, x32[:, i.clamp_max(D - 1)], 0.0).double()
            acc = (acc.double() + v * v).float()
    for off in (16, 8, 4, 2, 1):  # lane l adds lane l ^ off
        acc = acc + acc[..., torch.arange(32) ^ off]
    assert bool((acc == acc[..., :1]).all())  # the same sum in every lane
    total = acc[:, 0, 0]
    for wi in range(1, rw):  # warp order
        total = total + acc[:, wi, 0]
    factor = 1.0 / torch.sqrt(total / D + eps)[:, None]
    return (x32 * factor * scale.float()).to(x.dtype).reshape(x.shape)


def emulate_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The RMSNorm kernel's output by the route the width and dtype take."""
    if rn.row_warps(x.shape[-1], x.dtype):
        return emulate_row_warps_norm(x, scale, eps)
    return emulate_block_norm(x, scale, eps)


def copies(K: int, N: int, vec: int, structured: bool = False) -> torch.Tensor:
    """[K, N] count of the times the bf16 route puts each weight element into a
    stage, following the kernel's index arithmetic (strip, rank, stage).  vec
    16: the TMA boxes, KC rows x TILE columns at (col0 + t * TILE, k0 + c *
    KC), every element of the box that lies inside the weight (a box past the
    weight's edge fills zeros); else the copying threads' units of ``vec``
    bytes, left out past the slice or past N: ``structured`` (vec 8 with x by
    TMA, the logits head's route), thread pt always unit pt % UNITS_8 of rows
    pt // UNITS_8 + ROWS_8 q; else the generic loop, unit i of the stage at
    row i // upr."""
    cluster, slice_ = dr.row_plan(K, N)
    hits = []  # the flat index of every element put into a stage
    for rank in range(cluster):
        k0 = min(K, rank * slice_)
        k1 = min(K, k0 + slice_)
        for c in range(-(-(k1 - k0) // KC)):
            r0 = k0 + c * KC
            for col0 in range(0, N, STRIP):
                if vec == dr.TMA:
                    for t in range(STRIP // TILE):
                        k = torch.arange(r0, min(r0 + KC, K))[:, None]
                        c_lo = col0 + t * TILE  # a box wholly past N: zeros only
                        col = torch.arange(c_lo, max(c_lo, min(c_lo + TILE, N)))
                        hits.append((k * N + col).reshape(-1))
                    continue
                per = vec // 2  # elements a copy
                if structured:
                    pt = torch.arange(PRODUCERS)
                    q = torch.arange(KC // ROWS_8)[:, None]
                    k = r0 + pt // UNITS_8 + ROWS_8 * q
                    col = (col0 + 4 * (pt % UNITS_8)).expand_as(k)
                else:
                    upr = STRIP // per
                    i = torch.arange(KC * upr)
                    k, col = r0 + i // upr, col0 + i % upr * per
                ok = (k < k1) & (col < N)
                hits += [k[ok] * N + col[ok] + j for j in range(per)]
    return torch.bincount(torch.cat(hits), minlength=K * N).view(K, N).int()


def _case(seed, M, K, N, dtype):
    rng = np.random.default_rng(seed)
    w = (torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)) / K ** 0.5).to(dtype)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dtype)
    return x, w


def _gate(out, x, w, dtype) -> float:
    """max |out - ref| over chip_smoke's GEMV gate: passes at <= 1."""
    ref = dense_rows_plain(x.float(), w.float())
    tol = GEMV_SUM_TOL * (x.float().abs() @ w.float().abs()) + TOL[dtype]["rtol"] * ref.abs()
    return ((out.float() - ref).abs() / tol).max().item()


EMULATE = {"float32": emulate_fp32, "bfloat16": emulate_bf16}
# the five decode shapes at M = 2; odd shapes at M = 3: K not a multiple of 16,
# N a multiple of 4 only / of nothing, a K shorter than one k-step
GATE_CASES = [(2, K, N) for K, N in GEMV_SHAPES.values()] + [
    (3, 1000, 520), (3, 1000, 1027), (3, 40, 7)]
GATE_IDS = [f"M{m}_{k}x{n}" for m, k, n in GATE_CASES]


def test_the_constants_are_the_wrappers():
    """The wrapper plans with the kernel's strip, stage and row group; its
    largest cluster is one the entry takes; a block's shared memory fits the
    SM at every row-tile count, with at least three stages (the copying
    threads' lag) and room in the ring for the block's sums; the norm's
    launch shapes are the source's."""
    assert (dr.STRIP, dr.STAGE_ROWS, dr.GROUP_ROWS) == (STRIP, KC, GROUP_ROWS)
    assert dr.MAX_CLUSTER <= CONST["MAX_CLUSTER"] and KC % KSTEP == 0 and STRIP % TILE == 0
    assert TILE * 2 == 128 and KC * 2 == 128  # a box row and an x row: one swizzle span
    assert GROUP_ROWS == ROW_TILE * 8 >= 128  # 40 lanes' and a W = 40 window's 80 rows
    assert CONST["KS_MAX"] == i8.MAX_SLICE
    assert [stages(tb) for tb in range(1, 9)] == [7, 6, 5, 5, 4, 4, 4, 4]
    assert all(smem_bytes(tb) <= 232448 for tb in range(1, 9))
    assert all(STRIP * (ROW_TILE * tb + 2) * 4 <= RING_BYTES for tb in range(1, 9))
    assert [row_tiles(m) for m in (1, 2, 16, 17, 64, 80, 128, 130)] == [1, 1, 1, 2, 4, 5, 8, 8]
    assert (rn.PER_THREAD, rn.MAX_THREADS) == (NORM_CONST["PER_THREAD"],
                                               NORM_CONST["MAX_THREADS"])
    assert (rn.LANE_UNITS, rn.NORM_THREADS) == (NORM_CONST["LANE_UNITS"],
                                                NORM_CONST["NORM_THREADS"])
    assert [rn.threads(d) for d in (20, 1024, 2048, 9000)] == [32, 128, 256, 1024]
    assert [rn.row_warps(d, torch.bfloat16) for d in (20, 1024, 2048, 4096, 8192, 8200)] == [
        0, 1, 1, 2, 4, 0]
    assert rn.row_warps(2048, torch.float32) == 0
    # every unit of a row is some lane's: LANE_UNITS units of 32 lanes a warp
    assert all(rn.row_warps(d, torch.bfloat16) * 32 * rn.LANE_UNITS * 8 >= d
               for d in range(8, 8193, 8))


def test_row_plan_never_sees_the_rows_and_fills_the_card():
    """``row_plan`` of the decode shapes: whole stages a slice, the slices
    covering K once, a power-of-two cluster, at most ``PLAN_BLOCKS`` blocks
    a call."""
    for K, N in [*GEMV_SHAPES.values(), (1000, 1027), (40, 7), (1000, 520)]:
        cluster, slice_ = dr.row_plan(K, N)
        assert slice_ % KC == 0 and cluster * slice_ >= K > (cluster - 1) * slice_ or K < KC
        assert cluster & (cluster - 1) == 0 and cluster <= dr.MAX_CLUSTER
        assert cluster == 1 or cluster * -(-N // STRIP) <= dr.PLAN_BLOCKS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATE_CASES, ids=GATE_IDS)
def test_emulated_kernel_meets_the_chip_gate(case, dtype):
    M, K, N = case
    x, w = _case(sum(case), M, K, N, getattr(torch, dtype))
    out = EMULATE[dtype](x, w)
    assert out.dtype == x.dtype and out.shape == (M, N)
    assert _gate(out, x, w, dtype) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(2048, 512), (1000, 1027), (40, 7), (256, 9252)])
def test_a_row_does_not_depend_on_the_row_count(K, N, dtype):
    """A row's bits among 130 rows (two groups of 128 in bf16, the second of
    two) equal its bits among 128 (the cap), 80, 64, 16, 2 and 1, and none is
    NaN: the row tiles' padding stays in its own rows."""
    x, w = _case(K + N, 130, K, N, getattr(torch, dtype))
    emulate = EMULATE[dtype]
    full = emulate(x, w)
    assert torch.isfinite(full.float()).all()
    for m in (128, 80, 64):
        assert torch.equal(emulate(x[:m], w), full[:m])
    for i in (3, 112):
        assert torch.equal(emulate(x[i:i + 16], w), full[i:i + 16])
    for i in (0, 66, 127, 128):
        assert torch.equal(emulate(x[i:i + 2], w), full[i:i + 2])
    for i in (5, 63, 64, 129):
        assert torch.equal(emulate(x[i:i + 1], w), full[i:i + 1])


@pytest.mark.parametrize("K,N,ptr", [(K, N, 0) for K, N in GEMV_SHAPES.values()]
                         + [(2048, 512, 4), (1000, 520, 0), (1000, 1027, 0), (40, 7, 0),
                            (1000, 1042, 0), (64, 9252, 2), (2048, 9252, 8), (1000, 520, 8),
                            (200, 1000, 0), (130, 1036, 0), (1000, 9252, 0), (999, 1036, 0)])
def test_every_weight_element_is_copied_once(K, N, ptr):
    """The stages of every strip, rank and chunk cover the weight once: no
    element missed, none put twice, by TMA boxes (a 16-byte aligned weight
    whose rows are whole 16-byte units) and by the copying threads (8 bytes,
    in the structured mapping of the logits head's route and in the generic
    loop; 4 bytes; single values)."""
    vec = dr.weight_route(N, ptr)
    assert vec == (16 if ptr % 16 == 0 and N % 8 == 0 else 8 if ptr % 8 == 0 and N % 4 == 0
                   else 4 if N % 2 == 0 and ptr % 4 == 0 else 2)
    ones = torch.ones(K, N, dtype=torch.int32)
    assert torch.equal(copies(K, N, vec), ones)
    if vec == 8:
        assert torch.equal(copies(K, N, vec, structured=True), ones)


def test_the_logits_head_takes_8_byte_copies_and_x_by_tma():
    """No tensor map can describe the head (a row of 18504 bytes is not a
    multiple of 16, and a box of a [K / 2, 2N] view would start 8 bytes past
    one at every odd row): its weight takes 8-byte copies, its x TMA; the
    four other decode shapes take TMA for both."""
    routes = {name: dr.weight_route(N, 0) for name, (K, N) in GEMV_SHAPES.items()}
    assert routes.pop("logits_2048x9252") == 8 and 2 * 9252 % 16 == 8
    assert set(routes.values()) == {dr.TMA}
    assert all(dr.x_by_tma(K, 0) for K, N in GEMV_SHAPES.values())
    assert not dr.x_by_tma(1000 + 4, 0) and not dr.x_by_tma(2048, 8)


@pytest.mark.parametrize("tiles", [1, 3, 5, 8])
def test_wgmma_descriptors_read_what_tma_wrote(tiles):
    """The operands as the wgmma descriptors address them (the PTX ISA's
    canonical 128-byte-swizzled layouts: A MN-major, 64 columns a 128-byte
    row, its second 8 k rows 1024 bytes on; B K-major, 8-row groups 1024
    bytes apart, a k-step 32 bytes on) read back the weight tile and x's rows
    that TMA's swizzle (or the copying threads) put into a stage, for one
    wgmma of N = 16 * ``tiles`` rows."""
    rows = ROW_TILE * tiles
    rng = np.random.default_rng(tiles)
    w = rng.integers(1, 1 << 15, size=(KC, STRIP))  # stage rows of the weight
    x = rng.integers(1, 1 << 15, size=(rows, KC))  # the group's rows of x
    stage = np.zeros(2 * BOX_BYTES + rows * KC * 2, dtype=np.int64)
    for r in range(KC):  # TMA's writes, a value at its first byte
        for c in range(STRIP):
            stage[c // TILE * BOX_BYTES + swz(r, c % TILE * 2)] = w[r, c]
    for n in range(rows):
        for k in range(KC):
            stage[2 * BOX_BYTES + swz(n, k * 2)] = x[n, k]

    def read(addr):  # the address wgmma computes, swizzled by the hardware on the absolute address
        return stage[(addr & ~0x3FF) + swz((addr >> 7) & 7, addr & 0x7F)]

    for kk in range(KC // KSTEP):
        ks = np.arange(kk * KSTEP, (kk + 1) * KSTEP)
        for t in range(STRIP // TILE):
            start = t * BOX_BYTES + kk * KSTEP * 128  # A: columns m, the step's 16 k
            a = np.array([[read(start + (j // 8) * 1024 + (j % 8) * 128 + m * 2)
                           for j in range(KSTEP)] for m in range(TILE)])
            assert np.array_equal(a, w[ks, t * TILE:(t + 1) * TILE].T)
        start = 2 * BOX_BYTES + kk * KSTEP * 2  # B: rows n, the step's 16 k
        b = np.array([[read(start + (n // 8) * 1024 + (n % 8) * 128 + j * 2)
                       for j in range(KSTEP)] for n in range(rows)])
        assert np.array_equal(b, x[:, ks])


@pytest.mark.parametrize("D", [20, 1024, 2048, 4096, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_norm_is_row_invariant_and_near_the_plain_norm(D, dtype):
    """The norm kernel's order: a row's bits are the same among 130 rows,
    2 rows and alone, and within fp32 summation noise of the plain norm
    (a width that is not a multiple of 16 among them; one, two and four
    warps a row on the bf16 route)."""
    rng = np.random.default_rng(D)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(130, 1, D)).astype(np.float32)).to(dt)
    scale = torch.from_numpy(1.0 + 0.1 * rng.normal(size=D).astype(np.float32)).to(dt)
    full = emulate_norm(x, scale, 1e-5)
    assert full.dtype == dt and full.shape == x.shape
    for i in (0, 64, 128):
        assert torch.equal(emulate_norm(x[i:i + 2], scale, 1e-5), full[i:i + 2])
    assert torch.equal(emulate_norm(x[77:78], scale, 1e-5), full[77:78])
    ref = rms_norm_plain(x.float(), scale, 1e-5)  # fp32: the kernel's one rounding is in tol
    tol = 1e-5 if dtype == "float32" else 2.0 ** -8
    assert ((full.float() - ref).abs() <= 1e-5 + tol * ref.abs()).all()


def _norm64(x, scale, eps):
    """The plain version's formula in float64."""
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


class _PlainWithFormulaBackward(torch.autograd.Function):
    """The plain forward (in float64) with the card route's hand-written backward."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return _norm64(x, scale, eps)

    @staticmethod
    def backward(ctx, grad):
        x, scale = ctx.saved_tensors
        dx, ds = rn.rms_norm_backward(grad, x, scale, ctx.eps)
        return dx, ds, None


def test_rms_norm_backward_formula_passes_gradcheck():
    """``rms_norm_backward`` in float64 against finite differences
    (``torch.autograd.gradcheck``); its fp32 results against autograd through
    the plain version."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(3, 2, 20))).requires_grad_()
    scale = torch.from_numpy(1.0 + 0.1 * rng.normal(size=20)).requires_grad_()
    assert torch.autograd.gradcheck(lambda a, s: _PlainWithFormulaBackward.apply(a, s, 1e-5),
                                     (x, scale))
    x32 = x.detach().float().requires_grad_()
    s32 = scale.detach().float().requires_grad_()
    g = torch.from_numpy(rng.normal(size=(3, 2, 20)).astype(np.float32))
    rms_norm_plain(x32, s32, 1e-5).backward(g)
    dx, ds = rn.rms_norm_backward(g, x32.detach(), s32.detach(), 1e-5)
    np.testing.assert_allclose(dx.numpy(), x32.grad.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(ds.numpy(), s32.grad.numpy(), rtol=0, atol=1e-5)
