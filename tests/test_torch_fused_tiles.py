"""The fused decode step's plan, schedule and arithmetic, emulated on the CPU.

``csrc/fused_step.cu`` cannot run here, so its design is checked as Python
that follows it, with the constants read from the source:

* The copy plan: every block's copying warps stream the weight rows of their
  GEMV items (per layer and matrix, STRIP columns x a K slice of
  ``slice_rows(K, pairing)``, dealt to blocks by ``my_range`` rotated by
  ``gemv_offset``) in stages of KC rows.  The plan moves every weight byte of
  every layer's seven matrices exactly once a step (at up to PASS rows), in
  the order the block's consuming warps take the stages, and is the same at
  every row count up to PASS.
* The schedule: blocks running their consuming programs in random orders,
  under the counter waits (attention on the qkv / cq strips of its heads,
  o_proj / co_proj on the attention of the heads in their K slice, wm on the
  gate/up strips in its K slice), the arrival counts that the block which ran
  a strip's last slice (a (row, head)'s last chunk) waits on, after its own
  items of the phase, before it finishes the strip (combines the chunks),
  and three grid barriers a layer: every read
  finds the value its producer released for this layer (neither missing nor
  overwritten), and every wait is met (no deadlock).
* The arithmetic: mma k-steps of 16 rows (the products of a bf16 and an int8
  or a nibble are exact; each k-step's sum added to the fp32 sums at once,
  emulated in float64), the two halves of the consuming warps taking every
  other KC-row stage of an item, their sums added in half order, int4 sums
  times their scale rows per slice, slices
  added in slice order, norms from per-strip sums of squares (a butterfly
  tree a warp, warps in order, strips in order), attention by 32-slot chunks
  (a chunk's softmax sum a butterfly over its slots) combined in chunk order.  It meets ``chip_smoke.FUSED_TOL`` against
  ``fused_decode_step_plain`` for int8 and int4-MLP packs, and a row's bits
  are the same at B = 2, 8 and 20.

The kernel itself is held to the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import random
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import FUSED_TOL, fused_gate
from dia_tts_prune_tpu_torch.models.dia import quantize_kv
from dia_tts_prune_tpu_torch.ops.kernels.fused_step import (fused_decode_step_plain,
                                                            repack_decoder_fused)
from dia_tts_prune_tpu_torch.ops.modules import _inv_freq

torch.set_num_threads(1)

SOURCE = (Path(__file__).resolve().parents[1] / "dia_tts_prune_tpu_torch" / "csrc"
          / "fused_step.cu").read_text()
CONST = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", SOURCE)}
CGROUPS, HALVES, KSTEP, KC, KSLICE, CH, PASS = (
    CONST[k] for k in ("CGROUPS", "HALVES", "KSTEP", "KC", "KSLICE", "CH", "PASS"))
assert "constexpr int STRIP = CGROUPS * 32;" in SOURCE
STRIP = CGROUPS * 32
M_QKV, M_O, M_CQ, M_CO, M_G, M_U, M_M = range(7)
GA, GC, GD, GF, GG, GH = range(6)
MATRIX_OF = (M_QKV, M_O, M_CQ, M_CO, M_G, M_M)
DIMS = dict(L=2, D=256, F=1024, Nq=4, Nkv=2, Ncq=4, H=64)
T, S, WRITE_SLOT = 80, 40, 70
EPS = 1e-5


def cdiv(a, b):
    return -(-a // b)


# ---------------------------------------------------------------------------
# the plan (slice_rows, dims_of, gemv_items, my_range, gemv_offset, item_of)
# ---------------------------------------------------------------------------

def slice_rows(kp, pair):
    s = KSLICE
    if pair:
        while pair % s:
            s //= 2
    return min(s, kp)


def dims_of(which, d, int4, mt):
    """(rows, columns, nibble pairing) of one layer's matrix."""
    D, F, Nq, Nkv, Ncq, H = (d[k] for k in ("D", "F", "Nq", "Nkv", "Ncq", "H"))
    return {M_QKV: (D, (Nq + 2 * Nkv) * H, 0), M_O: (Nq * H, D, 0), M_CQ: (D, Ncq * H, 0),
            M_CO: (Ncq * H, D, 0), M_G: (D // 2 if int4 else D, F, D // 2 if int4 else 0),
            M_U: (D // 2 if int4 else D, F, D // 2 if int4 else 0),
            M_M: (F // 2 if int4 else F, D, F // (2 * mt) if int4 else 0)}[which]


def plan_of(kp, n, pair):
    """(slice, slices, strips)."""
    sl = slice_rows(kp, pair)
    return sl, cdiv(kp, sl), cdiv(n, STRIP)


def gemv_items(d, int4, mt, gph):
    kp, n, pair = dims_of(MATRIX_OF[gph], d, int4, mt)
    _, nsl, ns = plan_of(kp, n, pair)
    return nsl * ns * (2 if gph == GG else 1)


def my_range(n, off, nb, bid):
    r = (bid + off) % nb
    return r * n // nb, (r + 1) * n // nb


def gemv_offset(d, int4, mt, gph, nb):
    return sum(gemv_items(d, int4, mt, q) for q in range(gph)) % nb


def item_of(gph, i, ns):
    if gph == GG:
        return M_G + (i & 1), (i >> 1) // ns, (i >> 1) % ns
    return MATRIX_OF[gph], i // ns, i % ns


def copy_plan(d, int4, mt, B, nb, bid):
    """The stages block ``bid``'s copying warps stream, in order (``produce``):
    (layer, matrix, strip, first row, rows)."""
    out, passes = [], cdiv(B, PASS)
    for l in range(d["L"]):
        for gph in range(6):
            kp0, n0, pair0 = dims_of(MATRIX_OF[gph], d, int4, mt)
            _, _, ns = plan_of(kp0, n0, pair0)
            lo, hi = my_range(gemv_items(d, int4, mt, gph), gemv_offset(d, int4, mt, gph, nb),
                              nb, bid)
            for i in range(lo, hi):
                which, sl, strip = item_of(gph, i, ns)
                kp, n, pair = dims_of(which, d, int4, mt)
                slice_, _, _ = plan_of(kp, n, pair)
                p0 = sl * slice_
                length = min(slice_, kp - p0)
                for _ in range(passes):
                    for j in range(cdiv(length, KC)):
                        out.append((l, which, strip, p0 + j * KC, min(KC, length - j * KC)))
    return out


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("nb", [1, 5, 13, 264])
def test_copy_plan_moves_every_weight_byte_once(int4, nb):
    """Over all blocks, each weight byte of each layer's seven matrices is in
    exactly one stage (a stage: KC rows x STRIP columns, zeros past the
    matrix), and the plan is the same at B = 1, 2, 8, 20 and PASS."""
    d, mt = DIMS, 4
    plans = {B: [copy_plan(d, int4, mt, B, nb, b) for b in range(nb)]
             for B in (1, 2, 8, 20, PASS)}
    assert all(p == plans[2] for p in plans.values())
    counts = {(l, w): np.zeros(dims_of(w, d, int4, mt)[:2], np.int64)
              for l in range(d["L"]) for w in range(7)}
    for blk in plans[2]:
        for l, w, strip, k0, rows in blk:
            assert rows > 0
            counts[(l, w)][k0:k0 + rows, strip * STRIP:(strip + 1) * STRIP] += 1
    assert all((c == 1).all() for c in counts.values())
    # the blocks' shares: as many items a layer to every block, give or take one a phase
    per_block = [len(p) for p in plans[2]]
    assert max(per_block) - min(per_block) <= 6 * d["L"] * cdiv(KSLICE, KC)
    # past PASS rows each item streams once per pass of PASS rows
    assert [len(p) for p in [copy_plan(d, int4, mt, PASS + 1, nb, b) for b in range(nb)]] == \
        [2 * n for n in per_block]


@pytest.mark.parametrize("int4", [False, True])
def test_every_scale_is_read_once(int4):
    """int8: each column scale by its strip's epilogue; int4 (g, u, wm): each
    item applies the two scale rows of its pairing tile to its sums, and at
    these widths a tile is one slice — so every scale of every layer's seven
    matrices is read once a step.  (At Dia-1.6B widths a wm tile of 1024 byte
    rows is 4 slices, and its two scale rows are read by each.)"""
    d, mt, nb = DIMS, 4, 7
    reads = {}
    for b in range(nb):
        for l in range(d["L"]):
            for gph in range(6):
                kp0, n0, pair0 = dims_of(MATRIX_OF[gph], d, int4, mt)
                _, nsl0, ns = plan_of(kp0, n0, pair0)
                lo, hi = my_range(gemv_items(d, int4, mt, gph), gemv_offset(d, int4, mt, gph, nb),
                                  nb, b)
                for i in range(lo, hi):
                    which, sl, strip = item_of(gph, i, ns)
                    kp, n, pair = dims_of(which, d, int4, mt)
                    slice_, _, _ = plan_of(kp, n, pair)
                    rows = (2 * (sl * slice_ // pair), 2 * (sl * slice_ // pair) + 1) if pair \
                        else ((0,) if sl == 0 else ())  # int8: the strip's epilogue, once
                    cols = range(strip * STRIP, min(n, (strip + 1) * STRIP))
                    for r in rows:
                        for c in cols:
                            reads[(l, which, r, c)] = reads.get((l, which, r, c), 0) + 1
    for l in range(d["L"]):
        for w in range(7):
            kp, n, pair = dims_of(w, d, int4, mt)
            n_rows = 2 * (kp // pair) if pair else 1
            assert all(reads.get((l, w, r, c)) == 1 for r in range(n_rows) for c in range(n))
    assert len(reads) == sum(
        (2 * (dims_of(w, d, int4, mt)[0] // dims_of(w, d, int4, mt)[2])
         if dims_of(w, d, int4, mt)[2] else 1) * dims_of(w, d, int4, mt)[1]
        for w in range(7)) * d["L"]


# ---------------------------------------------------------------------------
# the schedule: random block orders under counters, tickets and barriers
# ---------------------------------------------------------------------------

class Schedule:
    """The consuming warps of ``nb`` blocks as generators that yield the
    condition they wait on; reads check the version of what they read."""

    def __init__(self, d, int4, mt, B, nb, ws, seed):
        self.d, self.int4, self.mt, self.B, self.nb, self.ws = d, int4, mt, B, nb, ws
        self.rng = random.Random(seed)
        self.ver = {}      # (buffer, index) -> (layer, phase) of the last write
        self.cnt = {}      # counter -> value
        self.consumed = [[] for _ in range(nb)]

    # memory and counters
    def write(self, key, tag):
        self.ver[key] = tag

    def read(self, key, tag):
        got = self.ver.get(key)
        assert got == tag, f"read {key}: found {got}, expected {tag}"

    def add(self, c, v=1):
        self.cnt[c] = self.cnt.get(c, 0) + v
        return self.cnt[c]

    def at_least(self, cs, target):
        return lambda: all(self.cnt.get(c, 0) >= target for c in cs)

    # the consuming program of one block (the kernel's consumer loop)
    def program(self, bid):
        d, B, nb = self.d, self.B, self.nb
        D, F, Nq, Nkv, Ncq, H = (d[k] for k in ("D", "F", "Nq", "Nkv", "Ncq", "H"))
        G = Nq // Nkv
        nsd = cdiv(D, STRIP)
        # start-up: x = x_emb and its sums of squares (strips bid, bid + nb, ...), one grid.sync
        for strip in range(bid, nsd, nb):
            for b in range(B):
                self.write(("x", b, strip), ("init",))
                self.write(("ss", 2, b, strip), ("init",))
        self.add("start")
        yield self.at_least(["start"], nb)
        x_tag = ("init",)
        for l in range(d["L"]):
            yield from self.gemv(bid, l, GA, x_tag)
            yield from self.attention(bid, l, True, G, Nkv, H, Nq)
            yield from self.gemv(bid, l, GC, None)
            yield from self.barrier()
            yield from self.gemv(bid, l, GD, (l, GC))
            yield from self.attention(bid, l, False, 1, Ncq, H, Nq)
            yield from self.gemv(bid, l, GF, None)
            yield from self.barrier()
            yield from self.gemv(bid, l, GG, (l, GF))
            yield from self.gemv(bid, l, GH, None)
            x_tag = (l, GH)
            if l + 1 < d["L"]:
                yield from self.barrier()
        self.done += 1

    def barrier(self):
        n = self.add("gbar")
        target = cdiv(n, self.nb) * self.nb
        yield self.at_least(["gbar"], target)

    def gemv(self, bid, l, gph, x_tag):
        d, B, nb, int4, mt = self.d, self.B, self.nb, self.int4, self.mt
        D, F, Nq, Nkv, Ncq, H = (d[k] for k in ("D", "F", "Nq", "Nkv", "Ncq", "H"))
        nsd = cdiv(D, STRIP)
        kp0, n0, pair0 = dims_of(MATRIX_OF[gph], d, int4, mt)
        _, nsl, ns = plan_of(kp0, n0, pair0)
        lo, hi = my_range(gemv_items(d, int4, mt, gph), gemv_offset(d, int4, mt, gph, nb),
                          nb, bid)
        ss_slot = {GA: 2, GD: 0, GG: 1}.get(gph)
        for i in range(lo, hi):
            which, sl, strip = item_of(gph, i, ns)
            kp, n, pair = dims_of(which, d, int4, mt)
            slice_, _, _ = plan_of(kp, n, pair)
            p0 = sl * slice_
            length = min(slice_, kp - p0)
            # the K columns of its input it reads (int4: both nibble planes)
            if pair:
                base = p0 // pair * 2 * pair + p0 % pair
                cols = list(range(base, base + length)) + list(range(base + pair,
                                                                     base + pair + length))
            else:
                cols = list(range(p0, p0 + length))
            if gph == GC:
                groups = sorted({c // H // (Nq // Nkv) for c in cols})
                yield self.at_least([("done_att", g) for g in groups], (l + 1) * B)
                for c in sorted({c // H for c in cols}):
                    for b in range(B):
                        self.read(("att", b, c), (l, "B"))
            elif gph == GF:
                heads = sorted({c // H for c in cols})
                yield self.at_least([("done_catt", h) for h in heads], (l + 1) * B)
                for h in heads:
                    for b in range(B):
                        self.read(("att", b, h), (l, "E"))
            elif gph == GH:
                strips = sorted({c // STRIP for c in cols})
                yield self.at_least([("done_h", s) for s in strips], l + 1)
                for s in strips:
                    for b in range(B):
                        self.read(("h", b, s), (l, GG))
            else:  # the normed x: every strip's sum of squares, then its own columns
                for b in range(B):
                    for s in range(nsd):
                        self.read(("ss", ss_slot, b, s), x_tag)
                    for s in sorted({c // STRIP for c in cols}):
                        self.read(("x", b, s), x_tag)
            for _ in range(cdiv(B, PASS)):
                for j in range(cdiv(length, KC)):
                    self.consumed[bid].append((l, which, strip, p0 + j * KC,
                                               min(KC, length - j * KC)))
            self.write(("part", gph, which, sl, strip), (l, gph))
            self.add(("arrived", gph, strip))
        # the strips whose last item this block ran, once its own items are done
        arrivals = (2 if gph == GG else 1) * nsl
        for i in range(lo, hi):
            which, sl, strip = item_of(gph, i, ns)
            if sl != nsl - 1 or which == M_G:
                continue
            yield self.at_least([("arrived", gph, strip)], (l + 1) * arrivals)
            for s2 in range(nsl):  # every slice, in slice order
                for w2 in ((M_G, M_U) if gph == GG else (which,)):
                    self.read(("part", gph, w2, s2, strip), (l, gph))
            for b in range(B):
                if gph == GA:
                    self.write(("qkv", b, strip), (l, GA))
                elif gph == GD:
                    self.write(("cq", b, strip), (l, GD))
                elif gph == GG:
                    self.write(("h", b, strip), (l, GG))
                else:
                    self.read(("x", b, strip), {GC: x_tag_of(l, GC), GF: (l, GC),
                                                GH: (l, GF)}[gph])
                    self.write(("x", b, strip), (l, gph))
                    self.write(("ss", {GC: 0, GF: 1, GH: 2}[gph], b, strip), (l, gph))
            if gph in (GA, GD, GG):
                self.add(({GA: "done_qkv", GD: "done_cq", GG: "done_h"}[gph], strip))

    def attention(self, bid, l, self_, G, nkv, H, Nq):
        d, B, nb = self.d, self.B, self.nb
        nch = max(1, cdiv(self.ws, CH)) if self_ else cdiv(S, CH)
        lo, hi = my_range(B * nkv * nch, 0, nb, bid)
        for i in range(lo, hi):
            c, n, b = i % nch, (i // nch) % nkv, i // (nch * nkv)
            if self_:
                cols = [(n * G * H, (n + 1) * G * H), ((Nq + n) * H, (Nq + n + 1) * H),
                        ((Nq + nkv + n) * H, (Nq + nkv + n + 1) * H)]
                strips = sorted({s for a, e in cols for s in range(a // STRIP, cdiv(e, STRIP))})
                yield self.at_least([("done_qkv", s) for s in strips], l + 1)
                for s in strips:
                    self.read(("qkv", b, s), (l, GA))
            else:
                strips = list(range(n * H // STRIP, cdiv((n + 1) * H, STRIP)))
                yield self.at_least([("done_cq", s) for s in strips], l + 1)
                for s in strips:
                    self.read(("cq", b, s), (l, GD))
            tag = (l, "B" if self_ else "E")
            self.write(("apart", self_, b, n, c), tag)
            self.add(("arrived_att", self_, b, n))
        # the (row, head) pairs whose last chunk this block ran, once its own are done
        for i in range(lo, hi):
            c, n, b = i % nch, (i // nch) % nkv, i // (nch * nkv)
            if c != nch - 1:
                continue
            tag = (l, "B" if self_ else "E")
            yield self.at_least([("arrived_att", self_, b, n)], (l + 1) * nch)
            for c2 in range(nch):
                self.read(("apart", self_, b, n, c2), tag)
            for g in range(G):
                self.write(("att", b, n * G + g), tag)
            self.add(("done_att", n) if self_ else ("done_catt", n))

    def run(self):
        self.done = 0
        progs = [self.program(b) for b in range(self.nb)]
        waits = [None] * self.nb
        live = list(range(self.nb))
        while live:
            ready = [b for b in live if waits[b] is None or waits[b]()]
            assert ready, f"deadlock: every live block waits ({len(live)} live)"
            b = self.rng.choice(ready)
            try:
                waits[b] = next(progs[b])
            except StopIteration:
                live.remove(b)
        assert self.done == self.nb


def x_tag_of(l, gph):
    """What x holds when o_proj's epilogue of layer l adds to it."""
    return ("init",) if l == 0 else (l - 1, GH)


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("B,nb,ws", [(2, 3, 70), (8, 7, 33), (20, 11, 1), (3, 64, 0)])
def test_schedule_reads_only_released_values_and_never_deadlocks(int4, B, nb, ws):
    for seed in range(3):
        sched = Schedule(DIMS, int4, 4, B, nb, ws, seed)
        sched.run()
        # the consuming order is the copying order, stage by stage, in every block
        for b in range(nb):
            assert sched.consumed[b] == copy_plan(DIMS, int4, 4, B, nb, b)


# ---------------------------------------------------------------------------
# the arithmetic
# ---------------------------------------------------------------------------

def f32(t):
    return t.to(torch.float32)


def bf16(t):
    return t.to(torch.bfloat16).to(torch.float32)


def fma(a, b, c):
    """fp32 a * b + c with one rounding."""
    return (a.double() * b.double() + c.double()).float()


def nibble_planes(w8):
    w = w8.to(torch.int32)
    return ((w << 28) >> 28).float(), (w >> 4).float()


def gemv_partials(x_bf, w8, scale, pair):
    """Per-slice fp32 sums [nsl, B, N] of one matrix against bf16 x [B, K]:
    16-row k-steps added to the fp32 sums at once (each k-step's products
    summed exactly), the item's KC-row stages taken by HALVES halves in turn
    and the halves' sums added in order; int4: each plane's sums times its
    scale row, added."""
    kp, n = w8.shape
    slice_, nsl, _ = plan_of(kp, n, pair)
    B = x_bf.shape[0]
    planes = nibble_planes(w8) if pair else (w8.float(),)
    parts = []
    for sl in range(nsl):
        p0 = sl * slice_
        length = min(slice_, kp - p0)
        accs = []
        for pl, wv in enumerate(planes):
            if pair:
                base = p0 // pair * 2 * pair + p0 % pair + pl * pair
                xs = x_bf[:, base:base + length]
            else:
                xs = x_bf[:, p0:p0 + length]
            halves = [torch.zeros(B, n) for _ in range(HALVES)]
            for k in range(0, length, KSTEP):
                step = xs[:, k:k + KSTEP].double() @ wv[p0 + k:p0 + min(k + KSTEP, length)].double()
                h = (k // KC) % HALVES
                halves[h] = (halves[h].double() + step).float()
            acc = halves[0]
            for h in range(1, HALVES):
                acc = acc + halves[h]
            accs.append(acc)
        if pair:
            tile = p0 // pair
            parts.append(fma(accs[0], scale[2 * tile], accs[1] * scale[2 * tile + 1]))
        else:
            parts.append(accs[0])
    return parts


def slice_sum(parts):
    v = torch.zeros_like(parts[0])
    for p in parts:
        v = v + p
    return v


def strip_sumsq(x):
    """[B, nsd]: each strip's sum of squares, a butterfly tree a warp of 32
    columns, the CGROUPS warps across the strip added in order."""
    B, D = x.shape
    nsd = cdiv(D, STRIP)
    xp = torch.zeros(B, nsd * STRIP)
    xp[:, :D] = x
    q = (xp * xp).reshape(B, nsd, CGROUPS, 32)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        q = q + q[..., lane ^ o]
    w = q[..., 0]
    a = w[..., 0]
    for i in range(1, CGROUPS):
        a = a + w[..., i]
    return a


def rstd_of(ss, D):
    a = torch.zeros(ss.shape[0])
    for j in range(ss.shape[1]):
        a = a + ss[:, j]
    return 1.0 / torch.sqrt(a / D + EPS)


def rope(src, pos, inv_freq):
    """[B, N, H] fp32: lane d with its bf16-rounded partner."""
    H = src.shape[-1]
    half = H // 2
    d = torch.arange(H)
    theta = pos.float()[:, None, None] * inv_freq[d % half]
    c, s = torch.cos(theta), torch.sin(theta)
    partner = bf16(src[..., torch.where(d < half, d + half, d - half)])
    return torch.where(d < half, src * c - partner * s, src * c + partner * s)


def lane_dot(q, k):
    """sum over the head dim as a warp does it: lane-strided fma chains, then
    a butterfly; q [..., H], k [..., H] -> [...]."""
    H = q.shape[-1]
    nj = cdiv(H, 32)
    qp = torch.zeros(*q.shape[:-1], nj * 32)
    kp = torch.zeros(*k.shape[:-1], nj * 32)
    qp[..., :H], kp[..., :H] = q, k
    qp, kp = qp.reshape(*q.shape[:-1], nj, 32), kp.reshape(*k.shape[:-1], nj, 32)
    a = torch.zeros(*q.shape[:-1], 32)
    for j in range(nj):
        a = fma(qp[..., j, :], kp[..., j, :], a)
    lane = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        a = a + a[..., lane ^ o]
    return a[..., 0]


def attention(q, kc, vc, ks, vs, lo_b, hi_b, cur_k, cur_v, nch, self_, scale):
    """One layer's attention by 32-slot chunks.  q [B, NKV, G, H]; caches [B,
    T, NKV, H] (fp32 values of the codes) and scales [B, T, NKV] or None;
    rows read slots [lo_b, hi_b); cur_k / cur_v [B, NKV, H] the current
    token (self) or None.  Returns [B, NKV * G, H], bf16-rounded."""
    B, NKV, G, H = q.shape
    ms, ls, accs = [], [], []
    for c in range(nch):
        m = torch.full((B, NKV, G), -1e30)
        sc = []
        for si in range(CH):
            slot = c * CH + si
            ok = [(max(c * CH, int(lo_b[b])) <= slot < min(c * CH + CH, int(hi_b[b])))
                  for b in range(B)]
            okt = torch.tensor(ok)[:, None, None]
            k = kc[:, min(slot, kc.shape[1] - 1)]
            a = lane_dot(q, k[:, :, None, :]) * scale
            if ks is not None:
                a = a * ks[:, min(slot, kc.shape[1] - 1)][:, :, None]
            a = torch.where(okt, a, torch.full_like(a, float("nan")))
            sc.append((a, okt))
        for a, okt in sc:
            m = torch.where(okt, torch.maximum(m, a), m)
        cur = self_ and c == 0
        if cur:
            s_cur = lane_dot(q, cur_k[:, :, None, :]) * scale
            m = torch.maximum(m, s_cur)
        probs, es = [], []
        for si, (a, okt) in enumerate(sc):
            e = torch.exp(a - m)
            es.append(torch.where(okt, e, torch.zeros_like(e)))
            if vs is not None:
                slot = min(c * CH + si, kc.shape[1] - 1)
                e = e * vs[:, slot][:, :, None]
            probs.append((e, okt))
        # the chunk's sum: a lane a slot, a butterfly over the 32 lanes
        lsum = torch.stack(es, dim=-1)
        lane = torch.arange(CH)
        for o in (16, 8, 4, 2, 1):
            lsum = lsum + lsum[..., lane ^ o]
        lsum = lsum[..., 0]
        if cur:
            e_cur = torch.exp(s_cur - m)
            lsum = lsum + e_cur
        acc = torch.zeros(B, NKV, G, H)
        for si, (e, okt) in enumerate(probs):
            v = vc[:, min(c * CH + si, vc.shape[1] - 1)]
            acc = torch.where(okt[..., None], fma(e[..., None], v[:, :, None, :], acc), acc)
        if cur:
            acc = fma(e_cur[..., None], cur_v[:, :, None, :], acc)
        ms.append(m)
        ls.append(lsum)
        accs.append(acc)
    mx = torch.full_like(ms[0], -1e30)
    for m in ms:
        mx = torch.maximum(mx, m)
    if not self_:
        mx = torch.where(mx <= -1e30 * 0.5, torch.zeros_like(mx), mx)
    num, den = torch.zeros_like(accs[0]), torch.zeros_like(ms[0])
    for m, lsum, acc in zip(ms, ls, accs):
        f = torch.exp(m - mx)
        num = fma(acc, f[..., None], num)
        den = fma(lsum, f, den)
    if not self_:
        den = torch.clamp_min(den, 1e-30)
    return bf16(num / den[..., None]).reshape(B, NKV * G, H)


def emulate(pack, inp):
    """The kernel's outputs (x [B, D], k_new, v_new [L, B, Nkv, H])."""
    L, B, _, Nkv, H = inp["self_k"].shape
    Ncq = inp["cross_k"].shape[3]
    Nq = pack.wo.shape[1] // H
    D = inp["x_emb"].shape[1]
    G = Nq // Nkv
    int4, scale = pack.mlp_int4, 1.0 / float(np.sqrt(H))
    inv_freq = _inv_freq(H, 1.0, 10000.0, torch.device("cpu"))
    pos, vf, ends, ws = inp["position"], inp["valid_from"], inp["cross_ends"], inp["write_slot"]
    kv8 = inp["self_ks"] is not None
    x = inp["x_emb"].float().clone()
    ss = strip_sumsq(x)
    ks_out, vs_out = [], []
    pairs = {M_G: D // 2 if int4 else 0, M_M: pack.wm.shape[1] // pack.mlp_tiles if int4 else 0}
    for i in range(L):
        def gemv(xin, w, s, pair=0):
            parts = gemv_partials(xin, w[i], s[i], pair)
            v = slice_sum(parts)
            return v if pair else v * s[i][0]

        xn = bf16(x * rstd_of(ss, D)[:, None])
        qkv = gemv(xn, pack.wqkv, pack.sqkv)
        q = rope(qkv[:, :Nq * H].reshape(B, Nq, H), pos, inv_freq).reshape(B, Nkv, G, H)
        kn = rope(qkv[:, Nq * H:(Nq + Nkv) * H].reshape(B, Nkv, H), pos, inv_freq)
        vn = qkv[:, (Nq + Nkv) * H:].reshape(B, Nkv, H)
        sk, sv = inp["self_k"][i].float(), inp["self_v"][i].float()
        sks = inp["self_ks"][i] if kv8 else None
        svs = inp["self_vs"][i] if kv8 else None
        sa = attention(q, sk, sv, sks, svs, vf, torch.full((B,), ws), kn, vn,
                       max(1, cdiv(ws, CH)), True, scale)
        x = x + gemv(sa.reshape(B, -1), pack.wo, pack.so)
        ss = strip_sumsq(x)
        xn = bf16(x * rstd_of(ss, D)[:, None])
        cq = rope(gemv(xn, pack.wcq, pack.scq).reshape(B, Ncq, H), pos, inv_freq)
        ck, cv = inp["cross_k"][i].float(), inp["cross_v"][i].float()
        cks = inp["cross_ks"][i] if kv8 else None
        cvs = inp["cross_vs"][i] if kv8 else None
        ca = attention(cq[:, :, None, :], ck, cv, cks, cvs, torch.zeros(B, dtype=torch.int32),
                       torch.clamp(ends, max=S), None, None, cdiv(S, CH), False, scale)
        x = x + gemv(ca.reshape(B, -1), pack.wco, pack.sco)
        ss = strip_sumsq(x)
        xn = bf16(x * rstd_of(ss, D)[:, None])
        g = gemv(xn, pack.wg, pack.sg, pairs[M_G])
        u = gemv(xn, pack.wu, pack.su, pairs[M_G])
        h = bf16(g / (1.0 + torch.exp(-g)) * u)
        x = x + gemv(h, pack.wm, pack.sm.reshape(L, -1, pack.wm.shape[2]), pairs[M_M])
        ss = strip_sumsq(x)
        ks_out.append(kn)
        vs_out.append(vn)
    out_dt = torch.float32 if kv8 else inp["self_k"].dtype
    return x, torch.stack(ks_out).to(out_dt), torch.stack(vs_out).to(out_dt)


def make_pack(int4, seed=3):
    g = torch.Generator().manual_seed(seed)
    L, D, F, Nq, Nkv, Ncq, H = (DIMS[k] for k in ("L", "D", "F", "Nq", "Nkv", "Ncq", "H"))

    def dense(*shape, fan_in):
        return {"kernel": torch.randn(L, *shape, generator=g) / fan_in ** 0.5}

    ones = {"scale": torch.ones(L, D)}
    params = {"decoder": {"layers": {
        "pre_sa_norm": ones, "pre_ca_norm": ones, "pre_mlp_norm": ones,
        "self_attention": {"q_proj": dense(D, Nq, H, fan_in=D), "k_proj": dense(D, Nkv, H, fan_in=D),
                           "v_proj": dense(D, Nkv, H, fan_in=D),
                           "o_proj": dense(Nq, H, D, fan_in=Nq * H)},
        "cross_attention": {"q_proj": dense(D, Ncq, H, fan_in=D),
                            "o_proj": dense(Ncq, H, D, fan_in=Ncq * H)},
        "mlp": {"wi_fused": dense(D, 2, F, fan_in=D), "wo": dense(F, D, fan_in=F)}}}}
    return repack_decoder_fused(params, mlp_int4=int4)


def make_inputs(B, kind, seed=5):
    """One step's inputs from a numpy seed: CFG row pairs (unconditional rows
    first, no text keys), per-row first valid slots and positions."""
    rng = np.random.default_rng(seed)
    L, D, Nkv, Ncq, H = (DIMS[k] for k in ("L", "D", "Nkv", "Ncq", "H"))
    caches = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              for s in [(L, B, T, Nkv, H)] * 2 + [(L, B, S, Ncq, H)] * 2]
    scales = [None] * 4
    if kind == "int8":
        q = [quantize_kv(c) for c in caches]
        caches, scales = [c for c, _ in q], [s for _, s in q]
    else:
        caches = [c.to(getattr(torch, kind)) for c in caches]
    n = B // 2
    off = [(7 * i) % 40 for i in range(n)] * 2
    i32 = dict(dtype=torch.int32)
    return dict(x_emb=torch.from_numpy(0.5 * rng.standard_normal((B, D)).astype(np.float32)),
                position=torch.tensor([WRITE_SLOT + 1 - o for o in off], **i32),
                write_slot=WRITE_SLOT, self_k=caches[0], self_v=caches[1], cross_k=caches[2],
                cross_v=caches[3],
                cross_ends=torch.tensor([0] * n + [S - 5 * i for i in range(n)], **i32),
                valid_from=torch.tensor(off, **i32), self_ks=scales[0], self_vs=scales[1],
                cross_ks=scales[2], cross_vs=scales[3])


def rows_of(inp, rows):
    idx = torch.tensor(rows)
    per_row = ("x_emb", "position", "cross_ends", "valid_from")
    return {k: (v.index_select(0, idx) if k in per_row else
                v.index_select(1, idx) if isinstance(v, torch.Tensor) else v)
            for k, v in inp.items()}


@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("kind", ["bfloat16", "int8"])
def test_emulated_sums_meet_the_gate(int4, kind):
    pack = make_pack(int4)
    inp = make_inputs(8, kind)
    out = emulate(pack, inp)
    ref = fused_decode_step_plain(pack, **inp)
    gate = fused_gate(out, ref)
    assert gate["err_over_tol"] <= 1.0, gate
    assert float(ref[0].abs().max()) > 0.5
    # the unconditional rows read no text keys: their cross-attention is exact zeros
    assert all(torch.isfinite(o.float()).all() for o in out)


@pytest.mark.parametrize("int4", [False, True])
def test_emulated_rows_do_not_depend_on_the_row_count(int4):
    """A row's bits at B = 20 equal the same row run 2 and 8 at a time."""
    pack = make_pack(int4)
    inp = make_inputs(20, "int8")
    full = emulate(pack, inp)
    for rows in ([0, 10], [9, 19], [0, 1, 2, 3, 10, 11, 12, 13]):
        part = emulate(pack, rows_of(inp, rows))
        idx = torch.tensor(rows)
        assert torch.equal(part[0], full[0][idx])
        assert all(torch.equal(p, f[:, idx]) for p, f in zip(part[1:], full[1:]))


def test_fused_tolerance_is_chip_smokes():
    assert FUSED_TOL == 2e-2
