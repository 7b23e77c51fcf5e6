"""The arithmetic of the int8-matmul kernel, emulated on the CPU.

``csrc/int8_matmul.cu`` cannot run here, so its plan is checked as torch code
that follows it block by block.  bf16 (the tensor-core route): a cluster of
blocks owns a strip of columns, block ``rank`` the K slice ``[rank * slice,
(rank + 1) * slice)`` of ``cluster_plan``; it walks the slice in stages of KC
rows and 16-row k-steps from the slice start (every step of a stage, rows
past the slice zero-filled in both operands), each step's 16 products added
to the fp32 accumulator at once (the tensor core's sum, emulated exactly in
float64: a product of a bf16 and an int8 has at most 16 significant bits);
the blocks' partials are added in rank order, times the scales, rounded
once.
fp32 (the CUDA-core route): ``split_plan``'s slices, four warps each walking
every fourth row of a slice with fused multiply-adds, the warps' sums added
in warp order and the slices' in slice order.  The constants (strip width,
k-step, stage rows, ring bytes, largest cluster) are read from the source.
The emulation is held to the plain version at the gate ``chip_smoke.py``
holds the kernel to on the card; it shows that a row's bits depend on its
own values and the weight's shape only, and that the copies of the weight
cover each element exactly once.  The kernel itself is held to the plain
version on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import GEMV_SHAPES, GEMV_SUM_TOL, TOL
from dia_tts_prune_tpu_torch.ops import quant
from dia_tts_prune_tpu_torch.ops.kernels import int8_matmul_plain

torch.set_num_threads(1)

i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
SOURCE = (Path(__file__).resolve().parents[1] / "dia_tts_prune_tpu_torch" / "csrc"
          / "int8_matmul.cu").read_text()
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE)}
STRIP, KSTEP, KC = CONST["STRIP"], CONST["KSTEP"], CONST["KC"]
RING_BYTES = eval(re.search(r"constexpr int RING_BYTES = ([\d *]+);", SOURCE).group(1))


def stages(tb: int) -> int:
    """Stages of the ring at ``tb`` n-tiles of x (``Smem<TB>::STAGES``)."""
    stage = KC * (STRIP + 16) + 8 * tb * (KC + 8) * 2
    return max(3, RING_BYTES // stage)
NWARPS = CONST["NWARPS"]  # the fp32 kernel's warps


def emulate_bf16(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The tensor-core route's output [B, N] in bf16."""
    B, K = x.shape
    cluster, slice_ = i8.cluster_plan(*w_q.shape)
    xd, wd = x.double(), w_q.double()
    parts = []
    for rank in range(cluster):
        k0 = min(K, rank * slice_)
        k1 = min(K, k0 + slice_)
        acc = torch.zeros(B, w_q.shape[1])
        for c in range(-(-(k1 - k0) // KC)):
            for kk in range(KC // KSTEP):  # every step of a stage: past k1 zeros in both
                ks = k0 + c * KC + kk * KSTEP
                ke = max(ks, min(ks + KSTEP, k1))
                acc = (acc.double() + xd[:, ks:ke] @ wd[ks:ke]).float()
        parts.append(acc)
    total = parts[0]
    for p in parts[1:]:  # rank order
        total = total + p
    return (total * scale).to(x.dtype)


def emulate_fp32(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """The CUDA-core route's output [B, N] in fp32."""
    B, K = x.shape
    N = w_q.shape[1]
    n_split = i8.split_plan(K, N, i8.vector_width(N, 0))
    slice_ = -(-K // n_split)
    xd, wd = x.double(), w_q.double()
    parts = []
    for s in range(n_split):
        k0, k1 = s * slice_, min(K, (s + 1) * slice_)
        acc = torch.zeros(NWARPS, B, N)  # warp w: rows k0 + w, k0 + w + NWARPS, ...
        for k in range(k0, k1, NWARPS):
            n = min(NWARPS, k1 - k)
            fma = acc[:n].double() + xd[:, k:k + n].T[:, :, None] * wd[k:k + n, None, :]
            acc[:n] = fma.float()
        v = acc[0]
        for w in range(1, NWARPS):  # warp order
            v = v + acc[w]
        parts.append(v)
    if n_split == 1:
        return parts[0] * scale
    total = torch.zeros(B, N)
    for p in parts:  # the finish pass: 0 + p0 + p1 + ...
        total = total + p
    return total * scale


def copies(K: int, N: int, vec: int) -> torch.Tensor:
    """[K, N] count of the times the bf16 route's copying warps copy each
    weight element to where the multiplying warps read it, following their
    index arithmetic (strip, rank, stage, copy).  16-byte copies start at the
    16-byte boundary at or before a row's first column of the strip (9 a row
    when N % 16 != 0, else 8), are cut at the weight's end and left out past
    the slice; a byte counts where it is the element the reader expects at
    that place of the stage row."""
    cluster, slice_ = i8.cluster_plan(K, N)
    hits = []  # the flat index of every element copied to its place
    col0 = torch.arange(0, N, STRIP)[:, None, None]  # every strip at once
    for rank in range(cluster):
        k0 = min(K, rank * slice_)
        k1 = min(K, k0 + slice_)
        for c in range(-(-(k1 - k0) // KC)):
            r0 = k0 + c * KC
            if vec == 16:
                upr = 8 + (N % 16 != 0)
                k = r0 + torch.arange(KC)[None, :, None]
                start = k * N + col0  # the row's column col0
                at = start // 16 * 16 + 16 * torch.arange(upr)[None, None, :]
                n = torch.where(k < k1, (K * N - at.clamp_max(K * N)).clamp_max(16), 0)
                a = at[..., None] + torch.arange(16)  # byte address, its place in the row
                place = (a - start[..., None]).expand(a.shape)
                ok = ((torch.arange(16) < n[..., None]) & (place >= 0) & (place < STRIP)
                      & (place + col0[..., None] < N))
                hits.append(a[ok])
                continue
            upr = STRIP // vec
            i = torch.arange(KC * upr)
            r, u = i // upr, i % upr
            for c0 in range(0, N, STRIP):
                k, col = r0 + r, c0 + u * vec
                ok = (k < k1) & (col < N)
                hits += [k[ok] * N + col[ok] + j for j in range(vec)]
    return torch.bincount(torch.cat(hits), minlength=K * N).view(K, N).int()


def _case(seed, B, K, N, dtype):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)) / K ** 0.5
    qk = quant.quantize_int8(w)
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(dtype)
    return x, qk.values, qk.scale.reshape(N), quant.dequantize(qk)


def _gate(out, x, w_q, scale, deq, dtype) -> float:
    """max |out - ref| over chip_smoke's GEMV gate: passes at <= 1."""
    ref = int8_matmul_plain(x.float(), w_q, scale)
    tol = GEMV_SUM_TOL * (x.float().abs() @ deq.abs()) + TOL[dtype]["rtol"] * ref.abs()
    return ((out.float() - ref).abs() / tol).max().item()


EMULATE = {"float32": emulate_fp32, "bfloat16": emulate_bf16}
# the five decode shapes at B = 2; odd shapes at B = 3: K not a multiple of 16,
# N a multiple of 8 only / of nothing, a K shorter than one k-step
GATE_CASES = [(2, K, N) for K, N in GEMV_SHAPES.values()] + [
    (3, 1000, 520), (3, 1000, 1027), (3, 40, 7)]
GATE_IDS = [f"B{b}_{k}x{n}" for b, k, n in GATE_CASES]


def test_the_constants_are_the_wrappers():
    """The wrapper plans with the source's strip and k-step; its largest
    cluster is one the entry takes."""
    assert (i8.STRIP, i8.KSTEP, i8.STAGE_ROWS) == (STRIP, KSTEP, KC)
    assert i8.MAX_CLUSTER <= CONST["MAX_CLUSTER"] and KC % KSTEP == 0
    assert [stages(tb) for tb in (1, 2, 4, 8)] == [6, 5, 4, 3]
    assert CONST["KS_MAX"] == i8.MAX_SLICE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GATE_CASES, ids=GATE_IDS)
def test_emulated_kernel_meets_the_chip_gate(case, dtype):
    B, K, N = case
    x, w_q, scale, deq = _case(sum(case), B, K, N, getattr(torch, dtype))
    out = EMULATE[dtype](x, w_q, scale)
    assert out.dtype == x.dtype and out.shape == (B, N)
    assert _gate(out, x, w_q, scale, deq, dtype) <= 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,N", [(2048, 512), (1000, 1027), (40, 7)])
def test_a_row_does_not_depend_on_the_batch(K, N, dtype):
    """A row's bits among 64 rows equal its bits among 8, 2 and 1."""
    x, w_q, scale, _ = _case(K + N, 64, K, N, getattr(torch, dtype))
    emulate = EMULATE[dtype]
    full = emulate(x, w_q, scale)
    assert torch.equal(emulate(x[:8], w_q, scale), full[:8])
    for i in range(0, 8, 2):
        assert torch.equal(emulate(x[i:i + 2], w_q, scale), full[i:i + 2])
    for i in (0, 5, 63):
        assert torch.equal(emulate(x[i:i + 1], w_q, scale), full[i:i + 1])


@pytest.mark.parametrize("K,N,ptr", [(K, N, 0) for K, N in GEMV_SHAPES.values()]
                         + [(2048, 512, 4), (1000, 520, 0), (1000, 1027, 0), (40, 7, 0),
                            (1000, 1040, 1)])
def test_every_weight_element_is_copied_once(K, N, ptr):
    """The copies of every strip, rank and stage cover the weight once: no
    element twice, none left out, none of another slice."""
    vec = i8.copy_width(N, ptr)
    assert torch.equal(copies(K, N, vec), torch.ones(K, N, dtype=torch.int32))


@pytest.mark.parametrize("K", [16, 40, 130, 1000, 1023, 2048, 8192, 9000])
@pytest.mark.parametrize("N", [7, 512, 2048, 9252, 16384])
def test_the_slices_are_whole_stages(K, N):
    """Slices are whole stages of the ring (so only K ends a stage early) and
    together cover K: the k-steps of a row are fixed by (K, N)."""
    cluster, slice_ = i8.cluster_plan(K, N)
    assert 1 <= cluster <= i8.MAX_CLUSTER and cluster & (cluster - 1) == 0
    assert slice_ % KC == 0 and cluster * slice_ >= K
    assert cluster == 1 or slice_ >= i8.MIN_CLUSTER_SLICE
    assert -(-N // STRIP) * cluster <= max(i8.CLUSTER_BLOCKS, -(-N // STRIP))


@pytest.mark.parametrize("B", [1, 64, 65, 80, 130])
def test_rows_past_64_go_in_groups_of_64(B):
    """The int8 and int4 wrappers' ``in_row_groups``: one launch with no
    output of its own for up to 64 rows; above, one launch for each group of
    64 rows (the last holds the rest), each writing its rows of one output."""
    x = torch.arange(B * 3, dtype=torch.float32).reshape(B, 3)
    groups = []

    def launch_group(xg, out):
        groups.append((xg.shape[0], out is None))
        y = xg.sum(1, keepdim=True).expand(-1, 5)
        if out is None:
            return y.clone()
        out.copy_(y)
        return out

    y = i8.in_row_groups(x, 5, launch_group)
    torch.testing.assert_close(y, x.sum(1, keepdim=True).expand(-1, 5), rtol=0, atol=0)
    sizes = [min(64, B - g) for g in range(0, B, 64)]
    assert groups == [(n, B <= 64) for n in sizes]
