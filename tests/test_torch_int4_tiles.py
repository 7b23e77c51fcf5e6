"""The arithmetic of the int4 GEMV's tensor-core route, emulated on the CPU.

``csrc/int4_gemv.cu`` cannot run here, so its bf16 route is checked as torch
code that follows it block by block: a cluster of blocks owns a strip of
columns, block ``rank`` the byte rows ``[rank * slice, (rank + 1) * slice)`` of
``int4_gemv.cluster_plan``; it walks its slice in stages of KC byte rows —
halfsplit: every stage twice, the low nibble plane's 16-byte-row k-steps
against x[:, r] and then the high plane's against x[:, K/2 + r]; parity: one
pass, each k-step 8 byte rows whose two nibbles meet x[:, 2r] and x[:, 2r+1]
— each k-step's products added to the fp32 sums at once (the tensor core's
sum, emulated exactly in float64: a product of a bf16 and a nibble has at most
12 significant bits).  The sums are those of one scale row: when the next
k-step takes another (a new segment of byte rows, or the other halfsplit
plane), they are multiplied by their scales into the fp32 total with one
fused multiply-add each; a k-step that crosses a segment's end runs once per
segment.  The blocks' totals are added in rank order and rounded once.

The emulation is held to the plain version at the gate ``chip_smoke.py``
holds the kernel to on the card; it shows that a row's bits depend on its own
values and the weight's shape only, that the copies of the weight and of x
cover what the multiplying warps read exactly once, and that the magic-number
widening of nibbles to bf16 is exact.  The constants are read from the
source.  The kernel itself is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import importlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import GEMV_SHAPES, GEMV_SUM_TOL, TOL
from dia_tts_prune_tpu_torch.ops import quant
from dia_tts_prune_tpu_torch.ops.kernels import int4_gemv_plain
from tests.test_torch_gemv_tiles import copies

torch.set_num_threads(1)

i4 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int4_gemv")
i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
SOURCE = (Path(__file__).resolve().parents[1] / "dia_tts_prune_tpu_torch" / "csrc"
          / "int4_gemv.cu").read_text()
TC = SOURCE[SOURCE.index("namespace tc {"):]  # the tensor-core route's constants
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", TC)}
STRIP, KSTEP, KC = CONST["STRIP"], CONST["KSTEP"], CONST["KC"]
STEPS = KC // KSTEP
RING_BYTES = eval(re.search(r"constexpr int RING_BYTES = ([\d *]+);", TC).group(1))
MAGIC = int(re.search(r"constexpr uint32_t MAGIC = (0x[0-9A-Fa-f]+)u;", TC).group(1), 16)
W_STRIDE = STRIP + 16
X_PAD = {0: 8, 1: 16}  # x_stride<LAYOUT>() - XCOLS


def stages(tb: int, layout: int) -> int:
    """Stages of the ring at ``tb`` n-tiles of x (``Smem<TB, LAYOUT>::STAGES``)."""
    stage = KC * W_STRIDE + 8 * tb * (2 * KC + X_PAD[layout]) * 2
    return max(3, RING_BYTES // stage)


def segments(K: int, R: int, scale: torch.Tensor, layout: str):
    """(scale rows as [S, N], seg, hi_off): byte rows [g*seg, (g+1)*seg) take
    scale row g, the halfsplit high plane g + hi_off (the wrapper's rule)."""
    if scale.dim() == 1:
        return scale[None], R, 0
    S = scale.shape[0]
    group = K // S
    return scale, (group // 2 if layout == "parity" else group), (S // 2 if layout == "halfsplit"
                                                                   else 0)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fp32 a * b + c with one rounding (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def emulate(x: torch.Tensor, w_b: torch.Tensor, scale: torch.Tensor, layout: str) -> torch.Tensor:
    """The tensor-core route's output [B, N] in bf16."""
    B, K = x.shape
    R, N = w_b.shape
    cluster, slice_ = i4.cluster_plan(R, N)
    rows_s, seg, hi_off = segments(K, R, scale, layout)
    b = w_b.to(torch.int32)
    planes = (((b << 28) >> 28).double(), (b >> 4).double())  # sign-extended nibbles
    xd = x.double()
    parts = []
    for rank in range(cluster):
        k0 = min(R, rank * slice_)
        k1 = min(R, k0 + slice_)
        st = {"acc": torch.zeros(B, N), "tot": torch.zeros(B, N), "cur": -1}

        def use_row(row, st=st):
            if row == st["cur"]:
                return
            if st["cur"] >= 0:
                st["tot"] = fma(st["acc"], rows_s[st["cur"]], st["tot"])
                st["acc"] = torch.zeros(B, N)
            st["cur"] = row

        def kstep(ra, rb, plane, st=st):
            rb = min(rb, k1 - 1)
            for sg in range(ra // seg, rb // seg + 1):  # the k-step's part in each segment
                use_row(sg + plane * hi_off)
                r = torch.arange(max(ra, sg * seg), min(rb + 1, (sg + 1) * seg))
                if layout == "halfsplit":
                    s = xd[:, plane * R + r] @ planes[plane][r]
                else:
                    s = xd[:, 2 * r] @ planes[0][r] + xd[:, 2 * r + 1] @ planes[1][r]
                st["acc"] = (st["acc"].double() + s).float()

        for c in range(-(-(k1 - k0) // KC)):
            r0 = k0 + c * KC
            if layout == "halfsplit":
                for plane in (0, 1):
                    for kk in range(STEPS):
                        base = r0 + kk * KSTEP
                        if base >= k1:
                            break
                        kstep(base, base + KSTEP - 1, plane)
            else:
                for kk in range(STEPS):
                    for h in (0, 1):
                        base = r0 + kk * KSTEP + 8 * h
                        if base >= k1:
                            break
                        kstep(base, base + 7, 0)
        use_row(-1)
        parts.append(st["tot"])
    total = parts[0]
    for p in parts[1:]:  # rank order
        total = total + p
    return total.to(x.dtype)


def _case(seed, B, K, N, group, layout):
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32)) / K ** 0.5
    qk = quant.quantize_int4(w, group=group, halfsplit=layout == "halfsplit")
    assert (qk.layout, qk.group) == (layout, group)
    x = torch.from_numpy(rng.normal(size=(B, K)).astype(np.float32)).to(torch.bfloat16)
    return x, qk.values, qk.scale, quant.dequantize4(qk)


FORMS = [(128, "halfsplit"), (None, "halfsplit"), (128, "parity"), (None, "parity")]
# the five decode shapes at B = 2 in the four forms; odd shapes at B = 3: groups
# whose segments end inside k-steps, N a multiple of 4 only / of nothing
GATE_CASES = ([(2, K, N, g, lay) for K, N in GEMV_SHAPES.values() for g, lay in FORMS]
              + [(3, 1000, 520, 100, "halfsplit"), (3, 1000, 520, 50, "parity"),
                 (3, 1000, 1027, None, "halfsplit"), (3, 256, 36, 128, "parity"),
                 (5, 64, 12, 8, "halfsplit"), (5, 64, 12, 4, "parity")])
GATE_IDS = [f"B{b}_{k}x{n}_{lay}{g or ''}" for b, k, n, g, lay in GATE_CASES]


def test_the_constants_are_the_wrappers():
    """The wrapper plans with the source's strip and stage rows; its largest
    cluster is one the entry takes; the ring holds 5 stages at one n-tile
    and never fewer than 3."""
    assert (i8.STRIP, i8.STAGE_ROWS, i8.KSTEP) == (STRIP, KC, KSTEP)
    assert i8.MAX_CLUSTER <= CONST["MAX_CLUSTER"] and KC % KSTEP == 0
    assert [stages(tb, 0) for tb in (1, 2, 4, 8)] == [5, 4, 3, 3]
    assert [stages(tb, 1) for tb in (1, 2, 4, 8)] == [5, 4, 3, 3]
    assert int(re.search(r"constexpr int RS_MAX = (\d+);", SOURCE).group(1)) == i4.MAX_SLICE


@pytest.mark.parametrize("case", GATE_CASES, ids=GATE_IDS)
def test_emulated_kernel_meets_the_chip_gate(case):
    B, K, N, group, layout = case
    x, w_b, scale, deq = _case(B * K + N, B, K, N, group, layout)
    out = emulate(x, w_b, scale, layout)
    assert out.dtype == x.dtype and out.shape == (B, N)
    ref = int4_gemv_plain(x.float(), w_b, scale, layout)
    tol = GEMV_SUM_TOL * (x.float().abs() @ deq.abs()) + TOL["bfloat16"]["rtol"] * ref.abs()
    assert ((out.float() - ref).abs() / tol).max().item() <= 1


@pytest.mark.parametrize("K,N,group,layout", [(2048, 512, 128, "halfsplit"),
                                              (2048, 512, None, "parity"),
                                              (1000, 1027, 100, "halfsplit"),
                                              (1000, 1027, 50, "parity")])
def test_a_row_does_not_depend_on_the_batch(K, N, group, layout):
    """A row's bits among 64 rows equal its bits among 8, 2 and 1."""
    x, w_b, scale, _ = _case(K + N, 64, K, N, group, layout)
    full = emulate(x, w_b, scale, layout)
    assert torch.equal(emulate(x[:8], w_b, scale, layout), full[:8])
    for i in range(0, 8, 2):
        assert torch.equal(emulate(x[i:i + 2], w_b, scale, layout), full[i:i + 2])
    for i in (0, 5, 63):
        assert torch.equal(emulate(x[i:i + 1], w_b, scale, layout), full[i:i + 1])


@pytest.mark.parametrize("K,N,ptr", [(K, N, 0) for K, N in GEMV_SHAPES.values()]
                         + [(2048, 9252, 4), (2048, 9252, 1), (1000, 520, 0), (1000, 1027, 0),
                            (256, 36, 0)])
def test_every_weight_byte_is_copied_once(K, N, ptr):
    """The copies of every strip, rank and stage cover the byte weight once:
    no byte twice, none left out, none of another slice (the int8 route's
    copying warps over byte rows, planned by ``int4_gemv.cluster_plan``)."""
    R = K // 2
    assert i4.cluster_plan(R, N) == i8.cluster_plan(R, N)
    assert torch.equal(copies(R, N, i4.copy_width(N, ptr)), torch.ones(R, N, dtype=torch.int32))


def x_copies(K: int, N: int, layout: str, aligned: bool) -> torch.Tensor:
    """[K] count of the times the copying warps copy each value of an x row
    into the place of its stage the multiplying warps read it from (the
    16-byte units or single values of the source's copy loops); a place read
    by the B fragments of a k-step counts where it holds the x value that
    the k-step's weight rows meet."""
    R = K // 2
    cluster, slice_ = i4.cluster_plan(R, N)
    hits = []
    for rank in range(cluster):
        k0 = min(R, rank * slice_)
        k1 = min(R, k0 + slice_)
        for c in range(-(-(k1 - k0) // KC)):
            r0 = k0 + c * KC
            cols = torch.arange(2 * KC)  # the stage row's places
            if layout == "halfsplit":
                r = r0 + cols % KC
                src, ok = torch.where(cols < KC, 0, R) + r, r < k1
            else:
                src = 2 * r0 + cols
                ok = src < 2 * k1
            if aligned:  # whole units of 8: valid by their first value
                ok = ok.view(-1, 8)[:, :1].expand(-1, 8).reshape(-1)
            # what the k-steps read at each place: halfsplit plane p, row r0 + j
            # at place p * KC + j; parity byte row r0 + j's two values at 2j, 2j + 1
            if layout == "halfsplit":
                want = torch.where(cols < KC, 0, R) + r0 + cols % KC
            else:
                want = 2 * r0 + cols
            hits.append(src[ok & (src == want) & (src < K)])
    return torch.bincount(torch.cat(hits), minlength=K).int()


@pytest.mark.parametrize("layout", ["halfsplit", "parity"])
@pytest.mark.parametrize("K,N", list(GEMV_SHAPES.values()) + [(1000, 520), (64, 12)])
def test_every_x_value_is_copied_once(K, N, layout):
    """Over the ranks and stages of a strip, every value of an x row lands
    once at the place the k-steps read it (16-byte units where K allows,
    else single values); none of another slice."""
    aligned = K % (16 if layout == "halfsplit" else 8) == 0
    assert torch.equal(x_copies(K, N, layout, aligned), torch.ones(K, dtype=torch.int32))
    if aligned:
        assert torch.equal(x_copies(K, N, layout, False), torch.ones(K, dtype=torch.int32))


@pytest.mark.parametrize("R", [10, 32, 64, 500, 1000, 1024, 4096])
@pytest.mark.parametrize("N", [7, 36, 512, 2048, 9252, 16384])
def test_the_slices_are_whole_stages(R, N):
    """Slices are whole stages of the ring and together cover the byte rows:
    the k-steps and scale flushes of a row are fixed by (R, N, group)."""
    cluster, slice_ = i4.cluster_plan(R, N)
    assert 1 <= cluster <= CONST["MAX_CLUSTER"] and cluster & (cluster - 1) == 0
    assert slice_ % KC == 0 and cluster * slice_ >= R
    assert cluster == 1 or slice_ >= i8.MIN_CLUSTER_SLICE


def _bf16_of_bits(bits: np.ndarray) -> np.ndarray:
    """bf16 words (uint16) as float32 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _nibbles(p: np.ndarray) -> np.ndarray:
    """The source's ``nibbles(p)`` (magic-number form): bf16x2 (136 + q) of the
    low nibbles of bytes 0 and 2 of p, minus bf16x2 (136, 136), as float32
    pairs [..., 2] (a bf16 subtraction whose exact result, an integer of at
    most 4 bits, bf16 holds)."""
    m = (p & 0x000F000F) ^ MAGIC
    halves = np.stack([m & 0xFFFF, m >> 16], axis=-1)
    return _bf16_of_bits(halves) - _bf16_of_bits(np.full_like(halves, MAGIC & 0xFFFF))


def _byte_perm(a: np.ndarray, b: np.ndarray, sel: int) -> np.ndarray:
    """CUDA's ``__byte_perm(a, b, sel)`` on uint32 arrays."""
    pool = [(a >> (8 * i)) & 0xFF for i in range(4)] + [(b >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4)).astype(np.uint32)


def test_the_magic_number_widening_is_exact():
    """For all 16 nibbles, and every pair of bytes in the positions the
    source reads them from: the halfsplit planes of two byte rows and the
    parity pair of one byte widen to the signed nibble values, exactly."""
    assert (MAGIC & 0xFFFF) == 0x4308 and _bf16_of_bits(np.array([0x4308]))[0] == 136.0
    u = np.arange(16, dtype=np.uint32)
    assert np.array_equal(_nibbles(u)[:, 0], np.where(u < 8, u, u.astype(np.int64) - 16))
    vals = np.arange(256, dtype=np.uint32)
    a, b = np.meshgrid(vals, vals, indexing="ij")
    a, b = a.reshape(-1), b.reshape(-1)
    signed = lambda v: v.astype(np.int64) - 256 * (v >= 128)  # noqa: E731
    low = lambda v: ((signed(v) << 60) >> 60).astype(np.float32)  # noqa: E731
    high = lambda v: (signed(v) >> 4).astype(np.float32)  # noqa: E731
    for j in range(4):  # byte j of the rows' words
        wa, wb = a << (8 * j), b << (8 * j)
        p = _byte_perm(wa, wb, j | (4 + j) << 8)
        assert np.array_equal(_nibbles(p), np.stack([low(a), low(b)], -1))  # low plane
        assert np.array_equal(_nibbles(p >> 4), np.stack([high(a), high(b)], -1))  # high plane
        q = _byte_perm(wa, wa >> 4, j | (4 + j) << 8)
        assert np.array_equal(_nibbles(q), np.stack([low(a), high(a)], -1))  # parity pair
