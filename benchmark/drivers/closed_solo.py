"""A closed loop of one client calling ``Dia.generate``, one request after
another: the single-stream rendering of a creator or the CLI on a dedicated
card.

Set-up warms the shapes of the mix's requests: one short call of each
request's graph key (self-cache bucket, text window, greedy or sampled) and
a codec decode of each request's length.  The window opens with the first
timed request and closes when the request in flight at ``--seconds``
returns; ``audio_s_per_s`` is the audio handed back (waveforms, codec
included) over that elapsed time.

``Dia.generate`` runs as a user calls it.  Its decode loop keeps the CUDA
graphs of the last few keys, and the mix's lengths span more keys than
that, so a request may capture its graph again inside the window: the
program's own cost on this traffic, counted by ``graph_captures_per_request``.
The codes of each call, for the correctness check, are kept by a wrapper
around ``Dia.generate_codes`` (which ``Dia.generate`` calls) that passes its
arguments on unchanged.

``--trace 1``: after the window, the profiler covers one more request, the
next that asks for at most ``trace.max_audio_s`` seconds of audio (a short
one: a bf16 step is some thousand kernels).
"""

from __future__ import annotations

import time

import numpy as np

import harness
import traffic
from correctness import Served
from harness import Window
from reference.text import text_ids

STAT_FIELDS = ("decode_steps", "replays", "step_replays", "graph_steps", "captures",
               "capture_seconds", "replay_device_seconds", "wall_seconds")


def call_stats(stats) -> dict:
    return {k: float(getattr(stats, k)) for k in STAT_FIELDS}


def record_codes(dia, sink: list) -> None:
    """Append what each call of ``dia.generate_codes`` returns to ``sink``."""
    inner = dia.generate_codes

    def generate_codes(*args, **kwargs):
        codes = inner(*args, **kwargs)
        sink.append(codes)
        return codes

    dia.generate_codes = generate_codes


def warm(dia, mix: dict, rng: np.random.Generator) -> None:
    """For each length of the mix, a short call of its graph key (its text's
    window, its self-cache bucket through ``cache_len``, greedy or sampled
    as its slot is) and a codec decode of its frames."""
    s, greedy = mix["sampling"], traffic.greedy_slots(mix)
    for slot, audio_s in enumerate(traffic.lengths_s(mix)):
        frames = int(round(audio_s * traffic.FRAME_RATE))
        dia.generate_codes(traffic.script(rng, traffic.text_bytes(mix, audio_s)),
                           max_tokens=mix["warm_tokens"], cache_len=frames,
                           cfg_scale=s["cfg_scale"],
                           temperature=0.0 if slot in greedy else s["temperature"],
                           top_p=s["top_p"], seed=1)
        dia._decode_waveform(np.zeros((frames, dia.dac_config.n_codebooks), np.int32))


def run(ctx, dia) -> Window:
    mix = ctx.mix
    warm(dia, mix, np.random.default_rng([ctx.seed & ((1 << 63) - 1), 1]))
    codes: list = []
    record_codes(dia, codes)
    sr = dia.dac_config.sample_rate
    reqs = traffic.requests(mix, ctx.seed)
    served, calls, traced = [], [], None
    audio_s, failed, attempted = 0.0, 0, 0
    host = harness.host_load()
    t_open = time.perf_counter()
    t_end = t_open
    while True:
        req = next(reqs)
        attempted += 1
        try:
            wav = dia.generate(req.text, max_tokens=req.max_tokens,
                               **traffic.sampling_args(mix, req))
        except Exception:  # noqa: BLE001 — a request that fails is counted, not fatal
            failed += 1
            wav = None
        t_end = time.perf_counter()
        if wav is not None:
            calls.append(dict(call_stats(dia.generator.last_stats),
                              cross_len=len(text_ids(req.text, 1 << 20))))
            audio_s += len(wav) / sr
            served.append(Served(req, codes[-1], np.asarray(wav, np.float32)))
        if t_end - t_open >= ctx.seconds:
            break
    host = harness.host_note(host)
    if ctx.tracer.enabled:
        req = next(r for r in reqs if r.audio_s <= mix["trace"]["max_audio_s"])
        ctx.tracer.arm()
        ctx.tracer.start()
        dia.generate(req.text, max_tokens=req.max_tokens, **traffic.sampling_args(mix, req))
        ctx.tracer.stop()
        traced = dict(call_stats(dia.generator.last_stats),
                      cross_len=len(text_ids(req.text, 1 << 20)))
    elapsed = t_end - t_open
    captures = sum(c["captures"] for c in calls)
    capture_s = sum(c["capture_seconds"] for c in calls)
    return Window(t_open=t_open, end_to_end={"audio_s_per_s": audio_s / elapsed},
                  served=served, attempted=attempted, failed=failed,
                  layer={"calls": calls, "traced_call": traced},
                  notes=[f"window: {attempted} requests, {audio_s:.3f} s of audio in "
                         f"{elapsed:.3f} s; {captures:.0f} graph captures, {capture_s:.3f} s; "
                         f"tracer {ctx.tracer.timings}", host])
