"""The arithmetic of the decode-attention kernel, emulated on the CPU.

``csrc/decode_attention.cu`` cannot run here, so its design is checked as
torch code that follows it block by block and warp by warp: the splits of a
(row, kv head) are the blocks of a cluster, each an equal share of the row's
own range ``[start, end)``; each block's share is cut into equal warp shares;
a warp walks its share in stages of 16-byte units (one per lane, several
lanes per slot), scores its slots by lane-partial dots and a butterfly over
the lanes of a slot, and keeps an online softmax (exp2 of scores in log2
units) whose sums stay per lane
until a butterfly over the slots' lanes at the end; the block merges its
warps' partials in warp order, rank 0 the blocks' in rank order and then the
current token (``k_new``, ``v_new``).  The constants (cluster size, warps,
units per stage) are read from the source.  The emulation is held to the
plain version at the gate ``chip_smoke.py`` holds the kernel to on the card;
it shows that a row's bits depend only on its own range, and that no slot
outside the range is read.  The kernel itself is held to the plain version
on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import TOL
from dia_tts_prune_tpu_torch.models.dia import quantize_kv
from dia_tts_prune_tpu_torch.ops.kernels import decode_attention_plain

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "dia_tts_prune_tpu_torch" / "csrc"
          / "decode_attention.cu").read_text()
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE)}
CLUSTER, NWARPS, UNITS = CONST["CLUSTER"], CONST["NWARPS"], CONST["UNITS"]
NEG = -1e30


def shares(lo: int, n: int) -> list[tuple[int, int, int, int]]:
    """(rank, warp, w0, w1): each block's equal share of [lo, lo + n), and
    each warp's of its block's, as the kernel cuts them (C integer division)."""
    out = []
    for rank in range(CLUSTER):
        r0 = lo + n * rank // CLUSTER
        nb = lo + n * (rank + 1) // CLUSTER - r0
        for w in range(NWARPS):
            out.append((rank, w, r0 + nb * w // NWARPS, r0 + nb * (w + 1) // NWARPS))
    return out


def geometry(elt_bytes: int, H: int) -> tuple[int, int, int]:
    """(EPL, LPS, SPI): elements per 16-byte unit, lanes per slot, slots per
    warp-wide copy (``Geom`` in the source)."""
    lps = H * elt_bytes // 16
    return 16 // elt_bytes, lps, 32 // lps


def butterfly(x: torch.Tensor, dim: int, offsets) -> torch.Tensor:
    """x[i] + x[i ^ o] over ``dim`` for each o in turn (``__shfl_xor_sync``)."""
    idx = torch.arange(x.shape[dim])
    for o in offsets:
        x = x + x.index_select(dim, idx ^ o)
    return x


def warp_partial(qg, K, V, ks, vs, w0, w1, geom, scale, reads):
    """One warp over slots [w0, w1) of one (row, kv head): (m [G], l [G],
    acc [G, H]) after the butterfly over the lanes of different slots.
    qg [G, H]; K, V [T, H] fp32; ks, vs [T] or None; reads collects the slots
    copied."""
    epl, lps, spi = geom
    G, H = qg.shape
    sps = UNITS * spi
    m = torch.full((G,), NEG)
    l = torch.zeros(spi, G)  # per group of lanes: its own slots' sum
    acc = torch.zeros(spi, G, H)
    for j in range(-(-(w1 - w0) // sps)):
        idx = w0 + j * sps + torch.arange(UNITS)[:, None] * spi + torch.arange(spi)[None]
        ok = idx < w1  # [UNITS, spi]; slots past the share are zero-filled, not read
        rows = idx[ok]
        reads.update(rows.tolist())
        k, v = torch.zeros(UNITS, spi, H), torch.zeros(UNITS, spi, H)
        k[ok], v[ok] = K[rows], V[rows]
        ksc, vsc = torch.zeros(UNITS, spi), torch.ones(UNITS, spi)
        if ks is not None:
            vsc = torch.zeros(UNITS, spi)
            ksc[ok], vsc[ok] = ks[rows], vs[rows]
        lane = (qg[None, None] * k[:, :, None]).reshape(UNITS, spi, G, lps, epl).sum(-1)
        d = butterfly(lane, 3, [lps >> i for i in range(1, lps.bit_length())])[..., 0]
        kscale = ksc * scale if ks is not None else torch.full_like(ksc, scale)
        s = torch.where(ok[..., None], d * kscale[..., None], torch.tensor(NEG))
        m_new = torch.maximum(m, s.amax((0, 1)))
        alpha = torch.exp2(m - m_new)
        m = m_new
        p = torch.where(ok[..., None], torch.exp2(s - m_new), 0.0)  # [UNITS, spi, G]
        l = l * alpha + p.sum(0)
        acc = acc * alpha[None, :, None]
        for u in range(UNITS):
            acc = acc + (p[u] * vsc[u][:, None])[..., None] * v[u][:, None, :]
    groups = [1 << i for i in range(spi.bit_length() - 1)]
    return m, butterfly(l, 0, groups)[0], butterfly(acc, 0, groups)[0]


def merge(parts, first=None):
    """Partials (m [G], l [G], acc [G, H]) merged in order, skipping empty ones
    (l == 0), optionally after a head start ``first`` = (m, l, acc) that
    counts last: the current token."""
    ms = torch.stack([p[0] for p in parts])
    ls = torch.stack([p[1] for p in parts])
    M = torch.where(ls > 0, ms, torch.tensor(NEG)).amax(0)
    if first is not None:
        M = torch.maximum(M, first[0])
    num = torch.zeros_like(parts[0][2])
    den = torch.zeros_like(M)
    for m, l, a in parts:
        e = torch.where(l > 0, torch.exp2(m - M), 0.0)
        num, den = num + e[:, None] * a, den + e * l
    if first is not None:
        e = torch.exp2(first[0] - M)
        num, den = num + e[:, None] * first[2], den + e
    return M, den, num


def emulate(q, k_cache, v_cache, start, end, k_scale=None, v_scale=None, k_new=None,
            v_new=None, reads=None):
    """The kernel's output [B, Nq, H] in q's dtype; ``reads`` (a dict) gets
    the set of slots copied for each (row, kv head)."""
    B, Nq, H = q.shape
    Tc, Nkv = k_cache.shape[1], k_cache.shape[2]
    G = Nq // Nkv
    geom = geometry(k_cache.element_size(), H)
    scale = math.log2(math.e) / math.sqrt(H)  # scores in log2 units, as exp2f takes them
    out = torch.zeros(B, Nq, H)
    for b in range(B):
        lo = max(int(start[b]), 0)
        n = max(min(int(end[b]), Tc) - lo, 0)
        for nk in range(Nkv):
            qg = q[b, nk * G:(nk + 1) * G].float()
            K, V = k_cache[b, :, nk].float(), v_cache[b, :, nk].float()
            ks = None if k_scale is None else k_scale[b, :, nk]
            vs = None if v_scale is None else v_scale[b, :, nk]
            seen = set() if reads is None else reads.setdefault((b, nk), set())
            warps = [warp_partial(qg, K, V, ks, vs, w0, w1, geom, scale, seen)
                     for _, _, w0, w1 in shares(lo, n)]
            blocks = [merge(warps[r * NWARPS:(r + 1) * NWARPS]) for r in range(CLUSTER)]
            cur = None
            if k_new is not None:
                s_cur = (qg * k_new[b, nk].float()).sum(-1) * scale
                cur = (s_cur, torch.ones(G), v_new[b, nk].float().expand(G, H))
            _, den, num = merge(blocks, cur)
            out[b, nk * G:(nk + 1) * G] = num / den.clamp_min(1e-30)[:, None]
    return out.to(q.dtype)


def _wide(*args):
    return tuple(a.float() if a is not None and a.is_floating_point() else a for a in args)


def _excess(got, ref, tol) -> float:
    """max(|got - ref| - rtol |ref|) over atol: the gate passes at <= 1."""
    return ((got.float() - ref).abs() - tol["rtol"] * ref.abs()).max().item() / tol["atol"]


def _inputs(seed, B, T, Nq, Nkv, H, dtype, int8=False, with_new=False):
    rng = np.random.default_rng(seed)
    normal = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    q = normal(B, Nq, H).to(dtype)
    if not int8:
        return [q, normal(B, T, Nkv, H).to(dtype), normal(B, T, Nkv, H).to(dtype)]
    (k8, ks), (v8, vs) = quantize_kv(normal(B, T, Nkv, H)), quantize_kv(normal(B, T, Nkv, H))
    args = [q, k8, v8]
    extra = [ks, vs] + ([normal(B, Nkv, H).to(dtype) for _ in range(2)] if with_new else [])
    return args, extra


def _ends(pairs):
    return (torch.tensor([p[0] for p in pairs], dtype=torch.int32),
            torch.tensor([p[1] for p in pairs], dtype=torch.int32))


# (B's ranges, T, Nq, Nkv, H): shorter than one split, empty rows, start > 0,
# start >= end, a range past the capacity, long ranges; G 1 / 4, H 32 / 64 / 128
CASES = [
    ([(0, 3), (0, 0), (5, 200), (0, 61)], 200, 4, 4, 32),
    ([(0, 150), (7, 7), (9, 2), (3, 140)], 150, 8, 2, 64),
    ([(0, 0), (0, 300), (37, 300), (0, 1)], 300, 4, 1, 128),
    ([(2, 9), (0, 130), (64, 500), (0, 77)], 130, 16, 16, 128),
    ([(0, 1024), (0, 700)], 1024, 4, 1, 128),  # several stages per warp
]
CASE_IDS = ["x".join(map(str, c[1:])) for c in CASES]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_emulated_kernel_meets_the_chip_gate(case, dtype):
    pairs, T, Nq, Nkv, H = case
    q, k, v = _inputs(1, len(pairs), T, Nq, Nkv, H, dtype)
    start, end = _ends(pairs)
    out = emulate(q, k, v, start, end)
    ref = decode_attention_plain(*_wide(q, k, v), start, end)
    assert _excess(out, ref, TOL[str(dtype).split(".")[1]]) <= 1
    for b, (s, e) in enumerate(pairs):
        if min(e, T) <= max(s, 0):
            assert (out[b] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_new", [False, True])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_emulated_kernel_int8_cache_meets_the_chip_gate(case, dtype, with_new):
    pairs, T, Nq, Nkv, H = case
    args, extra = _inputs(2, len(pairs), T, Nq, Nkv, H, dtype, int8=True, with_new=with_new)
    start, end = _ends(pairs)
    out = emulate(*args, start, end, *extra)
    ref = decode_attention_plain(*_wide(*args), start, end, *_wide(*extra))
    assert _excess(out, ref, TOL[str(dtype).split(".")[1]]) <= 1
    G = Nq // Nkv
    for b, (s, e) in enumerate(pairs):
        if min(e, T) <= max(s, 0):
            want = extra[3][b].repeat_interleave(G, 0) if with_new else torch.zeros(Nq, H)
            torch.testing.assert_close(out[b].float(), want.float(),
                                       **{"rtol": TOL["bfloat16"]["rtol"], "atol": 1e-6})


@pytest.mark.parametrize("B", [2, 8])
@pytest.mark.parametrize("int8", [False, True])
def test_a_row_does_not_depend_on_the_batch_or_the_capacity(B, int8):
    """A row's bits run alone equal its bits among B rows with other ranges,
    and in a cache of another capacity Tc."""
    T, Nq, Nkv, H = 260, 8, 2, 64
    pairs = [(0, 260), (3, 100), (0, 0), (0, 5), (17, 250), (0, 129), (1, 2), (0, 64)][:B]
    start, end = _ends(pairs)
    if int8:
        (q, k, v), extra = _inputs(3, B, T, Nq, Nkv, H, torch.bfloat16, int8=True, with_new=True)
    else:
        (q, k, v), extra = _inputs(3, B, T, Nq, Nkv, H, torch.bfloat16), []
    full = emulate(q, k, v, start, end, *extra)
    for b in range(B):
        one = [t[b:b + 1] for t in extra]
        alone = emulate(q[b:b + 1], k[b:b + 1], v[b:b + 1], start[b:b + 1], end[b:b + 1], *one)
        assert torch.equal(alone[0], full[b])
        wider = [torch.cat([t[b:b + 1], torch.zeros_like(t[b:b + 1, :40])], 1)
                 for t in (k, v, *extra[:2])]  # capacity 300: 40 more slots past every end
        in_wider = emulate(q[b:b + 1], wider[0], wider[1], start[b:b + 1], end[b:b + 1],
                           *wider[2:], *one[2:])
        assert torch.equal(in_wider[0], full[b])


@pytest.mark.parametrize("int8", [False, True])
def test_no_slot_outside_the_range_is_read(int8):
    """Only slots in [start, end) are copied; NaN everywhere else changes no bit."""
    T, Nq, Nkv, H = 300, 4, 1, 128
    pairs = [(0, 3), (5, 200), (0, 0), (250, 300)]
    start, end = _ends(pairs)
    if int8:
        (q, k, v), extra = _inputs(4, 4, T, Nq, Nkv, H, torch.float32, int8=True)
    else:
        (q, k, v), extra = _inputs(4, 4, T, Nq, Nkv, H, torch.float32), []
    reads = {}
    clean = emulate(q, k, v, start, end, *extra, reads=reads)
    slots = torch.arange(T)
    outside = (slots[None] < start[:, None]) | (slots[None] >= end[:, None])  # [B, T]
    for (b, _), seen in reads.items():
        lo, hi = pairs[b]
        assert seen == set(range(lo, hi))
    if int8:
        # the codes are int8: poison the scales of the slots outside
        extra = [torch.where(outside[..., None], float("nan"), s) for s in extra]
    else:
        k, v = (torch.where(outside[..., None, None], float("nan"), t) for t in (k, v))
    assert torch.equal(emulate(q, k, v, start, end, *extra), clean)


@pytest.mark.parametrize("n", [0, 1, 3, 7, 8, 31, 33, 61, 700, 1537])
def test_the_shares_cover_the_range_once(n):
    """Blocks and warps split [lo, lo + n) into consecutive equal shares (sizes
    differ by at most one), and a warp's stages cover its share exactly once."""
    lo = 11
    got = shares(lo, n)
    assert [(r, w) for r, w, _, _ in got] == [(r, w) for r in range(CLUSTER) for w in range(NWARPS)]
    bounds = [(w0, w1) for _, _, w0, w1 in got]
    assert bounds[0][0] == lo and bounds[-1][1] == lo + n
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    blocks = [bounds[r * NWARPS][0] for r in range(CLUSTER)] + [lo + n]
    sizes = np.diff(blocks)
    assert sizes.max() - sizes.min() <= 1
    for elt, H in ((1, 32), (2, 128), (4, 128)):
        _, _, spi = geometry(elt, H)
        sps = UNITS * spi
        for w0, w1 in bounds:
            stages = -(-(w1 - w0) // sps)
            slots = [w0 + j * sps + u * spi + s for j in range(stages) for u in range(UNITS)
                     for s in range(spi)]
            assert [t for t in slots if t < w1] == list(range(w0, w1))
