"""The arithmetic of the dense-rows and RMSNorm kernels, emulated on the CPU.

``csrc/dense_rows.cu`` and ``csrc/rms_norm.cu`` cannot run here, so their
plans are checked as torch code that follows them block by block, with the
constants read from the sources.

dense_rows, bf16 (the tensor-core route): rows in groups of GROUP_ROWS, each
group padded to whole n-tiles of 8 rows whose padding holds whatever shared
memory held (NaN here: it must stay in its own rows); a cluster of blocks
owns a strip of columns, block ``rank`` the K slice of
``int8_matmul.cluster_plan``; it walks the slice in stages of KC rows and
16-row k-steps from the slice start (every step of a stage, rows past the
slice zero in both operands), each step's 16 products added to the fp32
accumulator at once (the tensor core's sum, emulated in float64: a product of
two bf16 is exact there); the blocks' partials are added in rank order and
rounded once.  fp32 (the CUDA-core route): ``split_plan``'s slices, row tiles
of 2, 4 or 8 rows, four warps each walking every fourth row of a slice with
fused multiply-adds, the warps' sums added in warp order and the slices' in
slice order.  RMSNorm: a block a row of ``threads(D)`` threads, each summing
its strided elements with fused multiply-adds, a shuffle-down tree to lane 0,
the warps in warp order, one rsqrt, ``(x * factor) * scale``.

The emulations are held to the plain versions at the gates ``chip_smoke.py``
holds the kernels to on the card; they show that a row's bits depend on its
own values and the weight's shape only (at 1, 2, 64, 80 and 130 rows), and
that the copies of the weight cover each element exactly once.  The RMSNorm
gradient that the card's autograd route uses is checked against autograd
through the plain version.  The kernels themselves are held to their plain
versions on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
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
STRIP, KSTEP, KC = CONST["STRIP"], CONST["KSTEP"], CONST["KC"]
GROUP_ROWS, NWARPS = CONST["GROUP_ROWS"], CONST["NWARPS"]
RING_BYTES = eval(re.search(r"constexpr int RING_BYTES = ([\d *]+);", SOURCE).group(1))
W_STRIDE = eval(re.search(r"constexpr int W_STRIDE = ([\w\d *+]+);", SOURCE).group(1),
                {"STRIP": STRIP})
NORM_CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);",
                                                (CSRC / "rms_norm.cu").read_text())}


def stages(tb: int) -> int:
    """Stages of the ring at ``tb`` n-tiles of x (``Smem<TB>::STAGES``)."""
    stage = KC * W_STRIDE + 8 * tb * (KC + 8) * 2
    return max(3, RING_BYTES // stage)


def smem_bytes(tb: int) -> int:
    """Dynamic shared memory of a block at ``tb`` n-tiles and their most rows."""
    stage = KC * W_STRIDE + 8 * tb * (KC + 8) * 2
    return stages(tb) * stage + 2 * stages(tb) * 8 + 8 * tb * STRIP * 4


def n_tiles(m: int) -> int:
    """The kernel's n-tiles of 8 rows for a call of ``m`` rows (``dispatch_rows``)."""
    rows = min(m, GROUP_ROWS)
    return next(tb for tb in (1, 2, 4, 8) if rows <= 8 * tb)


def emulate_bf16(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The tensor-core route's output [M, N] in bf16."""
    M, K = x.shape
    N = w.shape[1]
    cluster, slice_ = i8.cluster_plan(K, N)
    tile_rows = 8 * n_tiles(M)
    wd = w.double()
    out = []
    for g0 in range(0, M, GROUP_ROWS):
        xg = x[g0:g0 + GROUP_ROWS].double()
        B = xg.shape[0]
        # the n-tiles' rows past the group's: whatever shared memory held
        xd = torch.cat([xg, torch.full((tile_rows - B, K), float("nan"), dtype=torch.float64)])
        parts = []
        for rank in range(cluster):
            k0 = min(K, rank * slice_)
            k1 = min(K, k0 + slice_)
            acc = torch.zeros(tile_rows, N)
            for c in range(-(-(k1 - k0) // KC)):
                for kk in range(KC // KSTEP):  # every step of a stage: past k1 zeros in both
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


def emulate_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """The RMSNorm kernel's output, row by row, in x's dtype."""
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


def copies(K: int, N: int, vec: int) -> torch.Tensor:
    """[K, N] count of the times the bf16 route's copying warps copy each
    weight element to where the multiplying warps read it, following their
    index arithmetic (strip, rank, stage, copy).  16-byte copies start at the
    16-byte boundary at or before a row's first column of the strip (17 a
    row when N % 8 != 0, else 16), are cut at the weight's end and left out
    past the slice; an element counts where it is the element the reader
    expects at that place of the stage row."""
    cluster, slice_ = i8.cluster_plan(K, N)
    hits = []  # the flat index of every element copied to its place
    col0 = torch.arange(0, N, STRIP)[:, None, None]  # every strip at once
    for rank in range(cluster):
        k0 = min(K, rank * slice_)
        k1 = min(K, k0 + slice_)
        for c in range(-(-(k1 - k0) // KC)):
            r0 = k0 + c * KC
            if vec == 16:
                upr = 2 * STRIP // 16 + (N % 8 != 0)
                k = r0 + torch.arange(KC)[None, :, None]
                start = 2 * (k * N + col0)  # byte address of the row's column col0
                at = start // 16 * 16 + 16 * torch.arange(upr)[None, None, :]
                n = torch.where(k < k1, (2 * K * N - at.clamp_max(2 * K * N)).clamp_max(16), 0)
                a = at[..., None] + torch.arange(0, 16, 2)  # element byte addresses
                place = (a - start[..., None]).expand(a.shape) // 2  # column within the strip
                ok = ((torch.arange(0, 16, 2) + 2 <= n[..., None]) & (place >= 0)
                      & (place < STRIP) & (place + col0[..., None] < N))
                hits.append(a[ok] // 2)
                continue
            per = vec // 2  # elements a copy
            upr = STRIP // per
            i = torch.arange(KC * upr)
            r, u = i // upr, i % upr
            for c0 in range(0, N, STRIP):
                k, col = r0 + r, c0 + u * per
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
    """The wrapper plans with the int8 matmul's strip, k-step and stage
    (its ``cluster_plan``); its largest cluster is one the entry takes; a
    block's shared memory fits the SM at every n-tile count; the norm's
    launch shape is the source's."""
    assert (i8.STRIP, i8.KSTEP, i8.STAGE_ROWS) == (STRIP, KSTEP, KC)
    assert i8.MAX_CLUSTER <= CONST["MAX_CLUSTER"] and KC % KSTEP == 0
    assert dr.GROUP_ROWS == GROUP_ROWS == i8.MAX_ROWS
    assert CONST["KS_MAX"] == i8.MAX_SLICE
    assert [stages(tb) for tb in (1, 2, 4, 8)] == [3, 3, 3, 3]
    assert all(smem_bytes(tb) <= 232448 for tb in (1, 2, 4, 8))
    assert (rn.PER_THREAD, rn.MAX_THREADS) == (NORM_CONST["PER_THREAD"],
                                               NORM_CONST["MAX_THREADS"])
    assert [rn.threads(d) for d in (20, 1024, 2048, 9000)] == [32, 128, 256, 1024]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATE_CASES, ids=GATE_IDS)
def test_emulated_kernel_meets_the_chip_gate(case, dtype):
    M, K, N = case
    x, w = _case(sum(case), M, K, N, getattr(torch, dtype))
    out = EMULATE[dtype](x, w)
    assert out.dtype == x.dtype and out.shape == (M, N)
    assert _gate(out, x, w, dtype) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(2048, 512), (1000, 1027), (40, 7)])
def test_a_row_does_not_depend_on_the_row_count(K, N, dtype):
    """A row's bits among 130 rows (three groups of 64, the last of two)
    equal its bits among 80, 64, 2 and 1, and none is NaN: the n-tiles'
    padding stays in its own rows."""
    x, w = _case(K + N, 130, K, N, getattr(torch, dtype))
    emulate = EMULATE[dtype]
    full = emulate(x, w)
    assert torch.isfinite(full.float()).all()
    for m in (80, 64):
        assert torch.equal(emulate(x[:m], w), full[:m])
    for i in (0, 66, 128):
        assert torch.equal(emulate(x[i:i + 2], w), full[i:i + 2])
    for i in (5, 63, 64, 129):
        assert torch.equal(emulate(x[i:i + 1], w), full[i:i + 1])


@pytest.mark.parametrize("K,N,ptr", [(K, N, 0) for K, N in GEMV_SHAPES.values()]
                         + [(2048, 512, 4), (1000, 520, 0), (1000, 1027, 0), (40, 7, 0),
                            (1000, 1042, 0), (64, 9252, 2)])
def test_every_weight_element_is_copied_once(K, N, ptr):
    """The copies of every strip, rank and stage cover the weight once: no
    element missed, none copied twice, at each copy width (16 bytes from the
    boundary before a row, shifted by 8 bytes where N % 8 == 4; 4 bytes; 2)."""
    vec = dr.copy_width(N, ptr)
    assert vec == (16 if ptr % 16 == 0 and N % 4 == 0 else 4 if N % 2 == 0 and ptr % 4 == 0
                   else 2)
    assert torch.equal(copies(K, N, vec), torch.ones(K, N, dtype=torch.int32))


@pytest.mark.parametrize("D", [20, 1024, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_emulated_norm_is_row_invariant_and_near_the_plain_norm(D, dtype):
    """The norm kernel's order: a row's bits are the same among 130 rows,
    2 rows and alone, and within fp32 summation noise of the plain norm
    (a width that is not a multiple of 16 among them)."""
    rng = np.random.default_rng(D)
    dt = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(130, 1, D)).astype(np.float32)).to(dt)
    scale = torch.from_numpy(1.0 + 0.1 * rng.normal(size=D).astype(np.float32)).to(dt)
    full = emulate_norm(x, scale, 1e-5)
    assert full.dtype == dt and full.shape == x.shape
    for i in (0, 64, 128):
        assert torch.equal(emulate_norm(x[i:i + 2], scale, 1e-5), full[i:i + 2])
    assert torch.equal(emulate_norm(x[77:78], scale, 1e-5), full[77:78])
    ref = rms_norm_plain(x, scale, 1e-5).float()
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
