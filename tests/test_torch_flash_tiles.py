"""The arithmetic of the bf16 tensor-core flash kernels, emulated on the CPU.

``csrc/flash_attention.cu`` (forward) and ``csrc/flash_attention_bwd.cu``
(dK/dV and dQ) cannot run here, so their design is checked as numpy/torch
code that follows them tile by tile: 64 x 64 (query, key) tiles in the kernels' order,
tiles skipped by ``tile_visits`` (causal diagonal, segment ranges that do not
meet), products of bf16 values summed in fp32 (as ``mma.sync`` does), the
online softmax, and the way an fp32 operand enters an MMA: one bf16 rounding
of it, or the hi + lo pair the kernels use.  The emulation is held to the
plain versions at the gates ``chip_smoke.py`` holds the kernels to on the card.
It shows which precision design can meet them: hi + lo does, one bf16 rounding
of P or dS does not.  The kernels themselves are held to the plain versions on the
card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import GRAD_TOL, LSE_ATOL, TOL
from dia_tts_prune_tpu_torch.ops.kernels import (
    flash_attention_bwd_plain,
    flash_attention_lse_plain,
    tile_visits,
)
from dia_tts_prune_tpu_torch.ops.kernels.flash_attention import TILE, _mask

torch.set_num_threads(1)

NEG = -1e30
QS = 32  # queries per sub-chunk of the dK/dV kernel
KS = 32  # keys per sub-chunk of the dQ kernel


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _operand(x: torch.Tensor, split: bool) -> list[torch.Tensor]:
    """An fp32 MMA operand as the kernels feed it: [hi, lo] or [bf16(x)]."""
    hi = _bf16(x)
    return [hi, _bf16(x - hi)] if split else [hi]


def _mma(parts: list[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    """sum_i parts[i] @ b, each product in fp32 (one MMA per part)."""
    out = parts[0] @ b
    for p in parts[1:]:
        out = out + p @ b
    return out


def _seg(kind: str, B: int, T: int, rng) -> torch.Tensor:
    t = torch.arange(T)
    if kind == "ones":
        seg = torch.ones(B, T, dtype=torch.int32)
    elif kind == "prefix":  # real lengths T and 3T/10, pad = segment 0 (the encoder's ids)
        seg = (t[None] < torch.tensor([T, 3 * T // 10])[:, None]).to(torch.int32)
    elif kind == "interleaved":  # ids t % 3: every tile holds every id
        seg = (t % 3).to(torch.int32)[None].repeat(B, 1)
    elif kind == "packed":  # several sequences packed one after another
        seg = torch.from_numpy(np.sort(rng.integers(0, 5, size=(B, T)), axis=1)).to(torch.int32)
    else:  # random ids
        seg = torch.from_numpy(rng.integers(0, 4, size=(B, T))).to(torch.int32)
    return seg.contiguous()


def _inputs(seed, B, Tq, Tk, Nq, Nkv, H, q_kind, k_kind):
    rng = np.random.default_rng(seed)
    q, k, v, do = (_bf16(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
                   for s in ((B, Tq, Nq, H), (B, Tk, Nkv, H), (B, Tk, Nkv, H), (B, Tq, Nq, H)))
    q_seg, kv_seg = _seg(q_kind, B, Tq, rng), _seg(k_kind, B, Tk, rng)
    q_seg[0, 5] = 7  # matches no key: a fully masked row
    return q, k, v, do, q_seg, kv_seg


def emulate_forward(q, k, v, q_seg, kv_seg, causal, split):
    """``flash_fwd_mma_kernel``: a block per (64 query rows, head, batch row),
    64-key tiles in order, skipped tiles never touched."""
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    scale = 1.0 / math.sqrt(H)
    mask = _mask(q_seg, kv_seg, causal)
    visits = tile_visits(q_seg, kv_seg, causal)
    out = torch.zeros(B, Tq, Nq, H)
    lse = torch.zeros(B, Nq, Tq)
    for b in range(B):
        for n in range(Nq):
            nk = n // (Nq // Nkv)
            for i in range(visits.shape[1]):
                rows = slice(i * TILE, min((i + 1) * TILE, Tq))
                qt = q[b, rows, n]
                m = torch.full((qt.shape[0],), NEG)
                l = torch.zeros(qt.shape[0])
                acc = torch.zeros(qt.shape[0], H)
                for j in range(visits.shape[2]):
                    if not visits[b, i, j]:
                        continue
                    keys = slice(j * TILE, min((j + 1) * TILE, Tk))
                    ok = mask[b, rows, keys]
                    s = torch.where(ok, (qt @ k[b, keys, nk].T) * scale, torch.tensor(NEG))
                    m_new = torch.maximum(m, s.amax(1))
                    m_safe = torch.where(m_new <= NEG * 0.5, 0.0, m_new)
                    alpha = torch.where(m <= NEG * 0.5, 0.0, torch.exp(m - m_safe))
                    p = torch.where(ok, torch.exp(s - m_safe[:, None]), 0.0)
                    l = l * alpha + p.sum(1)
                    acc = acc * alpha[:, None] + _mma(_operand(p, split), v[b, keys, nk])
                    m = m_new
                out[b, rows, n] = acc / l.clamp_min(1e-30)[:, None]
                lse[b, n, rows] = torch.where(m <= NEG * 0.5, 0.0, m) + torch.log(
                    l.clamp_min(1e-30))
    return _bf16(out), lse


def emulate_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, causal, split):
    """``flash_bwd_kv_mma_kernel``: a block per (64 keys, kv head, batch row)
    looping over the group's query heads and their visited 64-query tiles,
    32 queries at a time, dK/dV summed in that fixed order."""
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    scale = 1.0 / math.sqrt(H)
    mask = _mask(q_seg, kv_seg, causal)
    visits = tile_visits(q_seg, kv_seg, causal)
    dd = (dout * out).sum(-1)  # [B, Tq, Nq]
    dk, dv = torch.zeros(B, Tk, Nkv, H), torch.zeros(B, Tk, Nkv, H)
    for b in range(B):
        for nk in range(Nkv):
            for j in range(visits.shape[2]):
                keys = slice(j * TILE, min((j + 1) * TILE, Tk))
                kt, vt = k[b, keys, nk], v[b, keys, nk]
                dk_acc, dv_acc = torch.zeros(kt.shape[0], H), torch.zeros(kt.shape[0], H)
                for n in range(nk * G, (nk + 1) * G):
                    for i in range(visits.shape[1]):
                        if not visits[b, i, j]:
                            continue
                        for c0 in range(i * TILE, min((i + 1) * TILE, Tq), QS):
                            rows = slice(c0, min(c0 + QS, (i + 1) * TILE, Tq))
                            qt, dot = q[b, rows, n], dout[b, rows, n]
                            ok = mask[b, rows, keys].T  # [keys, queries]
                            st = (kt @ qt.T) * scale
                            pt = torch.where(ok, torch.exp(st - lse[b, n, rows][None]), 0.0)
                            dst = pt * ((vt @ dot.T) - dd[b, rows, n][None]) * scale
                            dv_acc = dv_acc + _mma(_operand(pt, split), dot)
                            dk_acc = dk_acc + _mma(_operand(dst, split), qt)
                dk[b, keys, nk], dv[b, keys, nk] = dk_acc, dv_acc
    return _bf16(dk), _bf16(dv)


def emulate_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, causal, split):
    """``flash_bwd_q_mma_kernel``: a block per (64 query rows, head, batch
    row) looping over its kv head's visited 64-key tiles, 32 keys at a time;
    dS / scale = P (dP - dd) enters dQ += dS.K as hi + lo (or rounded once),
    and the fp32 accumulator is scaled once.  Returns dq in fp32, before the
    kernel's one rounding to bf16."""
    B, Tq, Nq, H = q.shape
    Tk, Nkv = k.shape[1], k.shape[2]
    G = Nq // Nkv
    scale = 1.0 / math.sqrt(H)
    mask = _mask(q_seg, kv_seg, causal)
    visits = tile_visits(q_seg, kv_seg, causal)
    dd = (dout * out).sum(-1)  # [B, Tq, Nq]
    dq = torch.zeros(B, Tq, Nq, H)
    for b in range(B):
        for n in range(Nq):
            nk = n // G
            for i in range(visits.shape[1]):
                rows = slice(i * TILE, min((i + 1) * TILE, Tq))
                qt, dot = q[b, rows, n], dout[b, rows, n]
                acc = torch.zeros(qt.shape[0], H)
                for j in range(visits.shape[2]):
                    if not visits[b, i, j]:
                        continue
                    for c0 in range(j * TILE, min((j + 1) * TILE, Tk), KS):
                        keys = slice(c0, min(c0 + KS, Tk))
                        kt = k[b, keys, nk]
                        ok = mask[b, rows, keys]
                        s = (qt @ kt.T) * scale
                        p = torch.where(ok, torch.exp(s - lse[b, n, rows][:, None]), 0.0)
                        ds = p * ((dot @ v[b, keys, nk].T) - dd[b, rows, n][:, None])
                        acc = acc + _mma(_operand(ds, split), kt)
                dq[b, rows, n] = acc * scale
    return dq


def _excess(got, ref, tol) -> float:
    """max(|got - ref| - rtol |ref|) over atol: the gate passes at <= 1."""
    return ((got - ref).abs() - tol["rtol"] * ref.abs()).max().item() / tol["atol"]


# (B, Tq, Tk, Nq, Nkv, H, q ids, kv ids): odd lengths, GQA groups 1/2/4, H 32/64
SHAPES = [
    (2, 77, 77, 2, 2, 32, "prefix", "prefix"),
    (2, 200, 130, 4, 2, 64, "prefix", "prefix"),
    (2, 130, 200, 4, 1, 32, "interleaved", "interleaved"),
    (1, 150, 150, 4, 4, 64, "packed", "packed"),
]


SQUARE = (2, 256, 256, 4, 4, 64, "ones", "ones")  # whole tiles only, nothing masked
# causal attention is self-attention: only the shapes with Tq == Tk
CASES = [(s, c) for s in SHAPES for c in (False, True) if not c or s[1] == s[2]]
CASE_IDS = ["x".join(map(str, s[:6])) + s[6] + ("_causal" if c else "") for s, c in CASES]


@pytest.mark.parametrize("shape,causal", CASES, ids=CASE_IDS)
def test_emulated_forward_meets_the_chip_gate(shape, causal):
    B, Tq, Tk, Nq, Nkv, H, qk, kk = shape
    q, k, v, _, q_seg, kv_seg = _inputs(1, B, Tq, Tk, Nq, Nkv, H, qk, kk)
    out, lse = emulate_forward(q, k, v, q_seg, kv_seg, causal, split=True)
    ref_out, ref_lse = flash_attention_lse_plain(q, k, v, q_seg, kv_seg, causal)
    assert _excess(out, ref_out, TOL["bfloat16"]) <= 1
    assert (lse - ref_lse).abs().max().item() <= LSE_ATOL
    assert (out[0, 5] == 0).all()


@pytest.mark.parametrize("shape,causal", CASES, ids=CASE_IDS)
def test_emulated_dkdv_meets_the_chip_gate(shape, causal):
    B, Tq, Tk, Nq, Nkv, H, qk, kk = shape
    q, k, v, do, q_seg, kv_seg = _inputs(2, B, Tq, Tk, Nq, Nkv, H, qk, kk)
    out, lse = flash_attention_lse_plain(q, k, v, q_seg, kv_seg, causal)
    out = _bf16(out)
    dk, dv = emulate_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, do, causal, split=True)
    _, ref_dk, ref_dv = flash_attention_bwd_plain(q, k, v, q_seg, kv_seg, out, lse, do, causal)
    assert _excess(dk, ref_dk, GRAD_TOL["bfloat16"]) <= 1
    assert _excess(dv, ref_dv, GRAD_TOL["bfloat16"]) <= 1


@pytest.mark.parametrize("shape,causal", CASES, ids=CASE_IDS)
def test_emulated_dq_meets_the_chip_gate(shape, causal):
    """hi + lo dS meets the bf16 gate after the kernel's one rounding, and
    the fp32 gate before it; a fully masked row's dq is exactly 0."""
    B, Tq, Tk, Nq, Nkv, H, qk, kk = shape
    q, k, v, do, q_seg, kv_seg = _inputs(4, B, Tq, Tk, Nq, Nkv, H, qk, kk)
    out, lse = flash_attention_lse_plain(q, k, v, q_seg, kv_seg, causal)
    out = _bf16(out)
    dq = emulate_bwd_q(q, k, v, q_seg, kv_seg, out, lse, do, causal, split=True)
    ref_dq, _, _ = flash_attention_bwd_plain(q, k, v, q_seg, kv_seg, out, lse, do, causal)
    assert _excess(_bf16(dq), ref_dq, GRAD_TOL["bfloat16"]) <= 1
    assert _excess(dq, ref_dq, GRAD_TOL["float32"]) <= 1
    assert (dq[0, 5] == 0).all()


@pytest.mark.parametrize("shape,causal", CASES + [(SQUARE, False)],
                         ids=CASE_IDS + ["2x256x256x4x4x64ones"])
def test_one_bf16_rounding_of_p_misses_the_gate(shape, causal):
    """Why the kernels split P and dS (dK/dV and dQ alike): rounded once to
    bf16 (2^-9 relative),
    they move outputs and gradients several times past what the gates leave
    over the results' own rounding to bf16; the split brings them back to
    fp32 grade."""
    B, Tq, Tk, Nq, Nkv, H, qk, kk = shape
    q, k, v, do, q_seg, kv_seg = _inputs(3, B, Tq, Tk, Nq, Nkv, H, qk, kk)
    ref_out, ref_lse = flash_attention_lse_plain(q, k, v, q_seg, kv_seg, causal)
    fwd = [_excess(emulate_forward(q, k, v, q_seg, kv_seg, causal, split)[0], ref_out,
                   TOL["bfloat16"]) for split in (False, True)]
    out = _bf16(ref_out)
    _, ref_dk, ref_dv = flash_attention_bwd_plain(q, k, v, q_seg, kv_seg, out, ref_lse, do,
                                                  causal)
    bwd = [max(_excess(dk, ref_dk, GRAD_TOL["bfloat16"]), _excess(dv, ref_dv, GRAD_TOL["bfloat16"]))
           for dk, dv in (emulate_bwd_kv(q, k, v, q_seg, kv_seg, out, ref_lse, do, causal, split)
                          for split in (False, True))]
    ref_dq = flash_attention_bwd_plain(q, k, v, q_seg, kv_seg, out, ref_lse, do, causal)[0]
    dq = [_excess(_bf16(emulate_bwd_q(q, k, v, q_seg, kv_seg, out, ref_lse, do, causal, split)),
                  ref_dq, GRAD_TOL["bfloat16"]) for split in (False, True)]
    assert fwd[0] > 10 and bwd[0] > 3 and dq[0] > 3, (fwd, bwd, dq)
    assert fwd[1] <= 0.5 and bwd[1] <= 0.5 and dq[1] <= 0.5, (fwd, bwd, dq)


@pytest.mark.parametrize("kind", ["ones", "prefix", "interleaved", "packed", "random"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("T", [77, 320, 1000])
def test_a_skipped_tile_never_holds_an_attended_pair(kind, causal, T):
    rng = np.random.default_rng(T)
    q_seg = _seg(kind, 2, T, rng)
    kv_seg = q_seg if causal else _seg(kind, 2, T * 3 // 4 + 5, rng)
    visits = tile_visits(q_seg, kv_seg, causal)
    mask = _mask(q_seg, kv_seg, causal)
    Tq, Tk = mask.shape[1:]
    pad = torch.zeros(2, visits.shape[1] * TILE, visits.shape[2] * TILE, dtype=torch.bool)
    pad[:, :Tq, :Tk] = mask
    held = pad.reshape(2, visits.shape[1], TILE, visits.shape[2], TILE).any(4).any(2)
    assert not (held & ~visits).any()
    if kind == "interleaved":  # every tile holds every id: range skipping must not fire
        assert visits.all() if not causal else (visits == visits[0].tril()).all()


def test_prefix_padding_skips_pad_x_real_tiles():
    """The encoder's ids (real 700 / 300 of 1024, pad = 0): tiles wholly real
    against tiles wholly pad are skipped; a row that is all pad (one id) is not."""
    seg = (torch.arange(1024)[None] < torch.tensor([700, 300])[:, None]).to(torch.int32)
    visits = tile_visits(seg, seg)
    assert visits[1, :4, 5:].sum() == 0 and visits[1, 5:, :4].sum() == 0
    assert visits[0, :10, :10].all() and visits[0, :10, 11:].sum() == 0
    all_pad = torch.zeros(1, 1024, dtype=torch.int32)
    assert tile_visits(all_pad, all_pad).all()
