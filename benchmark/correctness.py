"""The comparison that decides ``correct``.

Once the window has closed, a sample of the greedy requests that finished
in it (drawn from the seed, the longest always among them) is judged
against the plain reference (``reference/``), which is given the same
seeded weights, made again here, and the same scripts:

* ``logit_gap``: for every token the decode loop chose and served, the
  reference is run once over the request's script and its served tokens
  (teacher forced), and the gap by which the served token's guided logit
  lies below the reference's best at that position is read; the number is
  the widest gap over the sample.  A greedy program that serves the
  reference's choice, up to its rounding, reads near 0.
* ``logit_gap_mean``: the same gaps' mean over every judged token: how
  often, and by how much, the served tokens leave the reference's choice.
* ``wave_diff``: the largest absolute difference between the waveform the
  client got and the reference codec's decode of the served codes;
  ``wave_sign_flips``, reported beside it, counts the samples whose sign
  differs.

The numbers that the configuration's ``check`` names are held to their
limits there; the others are reported beside them.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass

import numpy as np
import torch

import weights
from reference import dac as ref_dac
from reference import dia as ref_dia
from reference import text as ref_text


@dataclass
class Served:
    """A request as its client got it: the codes the program decoded and
    the waveform handed over."""

    request: object  # traffic.Request
    codes: np.ndarray
    audio: np.ndarray


def sample(served: list, seed: int, k: int) -> list:
    """``k`` greedy requests: the longest, and ``k - 1`` others drawn from the seed."""
    greedy = sorted((s for s in served if s.request.greedy and s.codes is not None
                     and s.codes.shape[0] > 0), key=lambda s: s.request.index)
    if not greedy:
        return []
    longest = max(greedy, key=lambda s: (s.codes.shape[0], -s.request.index))
    rest = [s for s in greedy if s is not longest]
    rng = np.random.default_rng((int(seed) + 7) & ((1 << 63) - 1))
    picked = [rest[i] for i in sorted(rng.choice(len(rest), min(k - 1, len(rest)),
                                                 replace=False))] if rest else []
    return [longest] + picked


PASSES = 8  # a bound on the rounds that settle the fed rows (two or three as a rule)


@torch.no_grad()
def token_gaps(W: dict, model: dict, text: str, codes: np.ndarray, cfg_scale: float,
               kv_int8: bool, device) -> np.ndarray:
    """The gap of every served token below the reference's best guided logit.

    The served codes clamp an id outside the codebook to 0, and the vocabulary
    holds one such id that a step may choose (1027; EOS, PAD and BOS are
    banned there, or end the request): a served 0 was fed back as 0 or as
    that id, and the token of the channel whose delay is the largest at row
    ``max_delay`` is never served.  The reference settles each such fed
    token as the program would have chosen it, by its own guided logits at
    that position (a round over the whole sequence, repeated until no choice
    changes, since a choice changes the rows after it), and a served 0 is
    judged by the better of its two readings."""
    data = model["data"]
    K = model["model"]["tgt_vocab_size"]
    banned = {data["audio_eos_value"], data["audio_pad_value"], data["audio_bos_value"]}
    cands = torch.tensor([0] + [v for v in range(1024, K) if v not in banned], device=device)
    ids = torch.from_numpy(ref_text.text_ids(text, data["text_length"])).to(device)
    rows, missing = ref_text.input_rows(codes, data)
    T = rows.shape[0]
    rows_t = torch.from_numpy(rows).to(device)
    r, c, tok = ref_text.served_positions(codes, data)
    r_t, c_t = torch.from_numpy(r).to(device), torch.from_numpy(c).to(device)
    tok_t = torch.from_numpy(tok.astype(np.int64)).to(device)
    amb = (tok_t == 0) & (r_t < T)  # served 0s that were fed back
    mr = torch.tensor([a for a, _ in missing], dtype=torch.long, device=device)
    mc = torch.tensor([b for _, b in missing], dtype=torch.long, device=device)
    with ref_dia.fp32_matmuls():
        for _ in range(PASSES):
            g = ref_dia.guided_logits(W, model, ids, rows_t, cfg_scale, kv_int8)
            new = rows_t.clone()
            if len(mr):
                new[mr, mc] = g[mr - 1, mc].argmax(-1)
            ar, ac = r_t[amb], c_t[amb]
            if len(ar):
                new[ar, ac] = cands[g[ar - 1, ac][:, cands].argmax(-1)]
            if torch.equal(new, rows_t):
                break
            rows_t = new
    at = g[r_t - 1, c_t]  # [P, V]: the logits that chose each served token
    served = at.gather(1, tok_t[:, None])[:, 0]
    served = torch.where(tok_t == 0, at[:, cands].max(-1).values, served)
    return (at.max(dim=-1).values - served).float().cpu().numpy()


def judge(config: dict, mix: dict, seed: int, samples: list, device,
          codec_control: bool = False) -> dict:
    """The readings of the sample against the reference: ``logit_gap``,
    ``logit_gap_mean``, ``wave_diff``, ``wave_sign_flips``, and how many
    tokens and samples were judged.
    ``codec_control`` adds ``wave_diff_bf16``: the reference codec computed
    in bfloat16 against its float32 decode (the codec's control)."""
    route = config["reference"]
    model, dac = config["dia"], config["dac"]
    served = {"bfloat16": torch.bfloat16, "float32": torch.float32}[
        config["route"]["compute_dtype"]]  # the weights as the program was handed them
    W = ref_dia.float_weights(weights.dia_weights(model, seed, served, device), route["weights"])
    gc.collect()
    dac_w = weights.dac_weights(dac, seed, device)
    gaps, waves, tokens, ctrl, gap_sum, flips = [], [], 0, [], 0.0, 0
    cfg_scale = mix["sampling"]["cfg_scale"]
    for s in samples:
        g = token_gaps(W, model, s.request.text, s.codes, cfg_scale, route["kv_int8"], device)
        tokens += g.size
        gap_sum += float(g.astype(np.float64).sum())
        gaps.append(float(g.max()) if g.size else 0.0)
        ref_wav = ref_dac.decode(dac_w, dac, torch.from_numpy(s.codes).to(device)).cpu().numpy()
        n = min(len(ref_wav), len(s.audio))
        mismatch = len(ref_wav) != len(s.audio)
        waves.append(float("inf") if mismatch else float(np.abs(ref_wav[:n] - s.audio[:n]).max()))
        flips += int((np.sign(ref_wav[:n]) != np.sign(s.audio[:n])).sum())
        if codec_control:
            low = ref_dac.decode(dac_w, dac, torch.from_numpy(s.codes).to(device),
                                 torch.bfloat16).cpu().numpy()
            ctrl.append(float(np.abs(ref_wav - low).max()))
    out = {"logit_gap": max(gaps) if gaps else None,
           "logit_gap_mean": gap_sum / tokens if tokens else None,
           "wave_diff": max(waves) if waves else None, "wave_sign_flips": flips,
           "tokens": tokens,
           "requests": len(samples)}
    if codec_control:
        out["wave_diff_bf16"] = max(ctrl) if ctrl else None
    return out


def verdict(readings: dict, limits: dict, failed: int) -> tuple[bool, dict]:
    """``correct`` and the numbers compared, each beside its limit."""
    shown = {}
    ok = failed == 0 and readings.get("requests", 0) > 0
    for name, limit in limits.items():
        value = readings.get(name)
        shown[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and limit is not None and value <= limit
    shown["failed"] = {"value": failed, "limit": 0}
    shown["judged_tokens"] = {"value": readings.get("tokens", 0), "limit": 1}
    ok = ok and readings.get("tokens", 0) >= 1
    return ok, shown
