"""Streaming generation in the port (``DiaGenerator.generate_tokens_stream``,
``api.stream_decode_wav``, ``Dia.generate_stream``) against the JAX package
and against the port's own offline runs, on the CPU.

* Greedy stream chunks equal the JAX ``generate_tokens_stream`` chunk for
  chunk on ``trained_small``, with and without a voice prompt.
* The chunks concatenate to the port's ``generate_tokens`` codes bit for
  bit, greedy and seeded-sampled, on float, int8 and fused trees (the port's
  seeded draws cannot match ``jax.random``, and the fused JAX route has no
  end-to-end counterpart, so those hold the port to itself).
* A segment runs exactly its steps: ``segment_plan`` for every remainder,
  and the graph loop's segment runner, its captures and replays stood in
  for by eager steps, on a counting fake step.
* Streamed audio equals the JAX ``stream_decode_wav`` on the same codes and
  codec weights, and ``Dia.generate`` within 1e-4 (the codec's spans differ
  in length, so its convolutions sum in other orders); a stream closed after
  its first chunk leaves the next call of its key right.
"""

from contextlib import nullcontext
from pathlib import Path

import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from dia_tts_prune_tpu.api import Dia as JaxDia
from dia_tts_prune_tpu.api import _unflatten_tree, load_dac_config
from dia_tts_prune_tpu.api import stream_decode_wav as jax_stream_decode_wav
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import generate as tgen
from dia_tts_prune_tpu_torch.api import stream_decode_wav

from .test_torch_loop import CFG_SCALE, TOP_K, TOP_P, _dummy_cache, _port_step, _table, _template

torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"
TEXT = "[S1] The birch canoe slid on the smooth planks. [S2]"
PROMPT_TEXT = "[S1] A voice."
MAX_TOKENS = 96


@pytest.fixture(scope="module")
def golden():
    return np.load(SMALL / "golden.npz")["tokens"]


@pytest.fixture(scope="module")
def dia():
    return Dia.from_pretrained(SMALL, device="cpu")


def _stream(gen, segment_steps, **kw):
    return list(gen.generate_tokens_stream(TEXT, segment_steps=segment_steps,
                                           max_tokens=MAX_TOKENS, **kw))


@pytest.mark.parametrize("prompted", [False, True], ids=["plain", "prompted"])
@pytest.mark.parametrize("segment_steps", [16, 20])
def test_greedy_chunks_equal_jax(dia, golden, segment_steps, prompted):
    jd = JaxDia.from_pretrained(str(SMALL))
    kw = dict(temperature=0.0)
    if prompted:
        kw.update(audio_prompt_codes=golden[:20], audio_prompt_text=PROMPT_TEXT)
    ref = [np.asarray(c) for c in _stream(jd.generator, segment_steps, **kw)]
    out = _stream(dia.generator, segment_steps, **kw)
    assert len(ref) > 2
    assert [c.shape for c in out] == [c.shape for c in ref]
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert dia.generator.last_stats.loop == "eager"


@pytest.mark.parametrize("temperature", [0.0, 1.3], ids=["greedy", "seeded"])
@pytest.mark.parametrize("segment_steps", [16, 20, 24])
def test_chunks_concatenate_to_offline_codes(dia, golden, segment_steps, temperature):
    for kw in (dict(), dict(audio_prompt_codes=golden[:30], audio_prompt_text=PROMPT_TEXT)):
        kw.update(temperature=temperature, seed=11)
        offline = dia.generate_codes(TEXT, max_tokens=MAX_TOKENS, **kw)
        chunks = _stream(dia.generator, segment_steps, **kw)
        assert len(chunks) > 2 and all(c.shape[0] > 0 for c in chunks)
        np.testing.assert_array_equal(np.concatenate(chunks), offline)


@pytest.mark.parametrize("pack", ["int8", "fused"])
def test_packed_streams_equal_offline_codes(pack):
    dia = Dia.from_pretrained(SMALL, device="cpu")
    dia.quantize_int8(fused=pack == "fused")
    for temperature in (0.0, 1.3):
        kw = dict(temperature=temperature, seed=5)
        offline = dia.generate_codes(TEXT, max_tokens=MAX_TOKENS, **kw)
        for segment_steps in (16, 24):
            chunks = _stream(dia.generator, segment_steps, **kw)
            np.testing.assert_array_equal(np.concatenate(chunks), offline)


def test_stream_ends_at_max_tokens_and_past_a_long_prompt(dia, golden):
    """A stream cut by ``max_tokens`` yields what the offline call returns;
    one whose prompt leaves no step yields nothing, as the offline call
    returns no frames."""
    kw = dict(temperature=0.0)
    for max_tokens in (40, 57):
        offline = dia.generate_codes(TEXT, max_tokens=max_tokens, **kw)
        chunks = list(dia.generator.generate_tokens_stream(TEXT, segment_steps=16,
                                                           max_tokens=max_tokens, **kw))
        np.testing.assert_array_equal(np.concatenate(chunks), offline)
    kw.update(audio_prompt_codes=golden[:50], audio_prompt_text=PROMPT_TEXT, max_tokens=40)
    assert dia.generate_codes(TEXT, **kw).shape[0] == 0
    assert list(dia.generator.generate_tokens_stream(TEXT, segment_steps=16, **kw)) == []
    with pytest.raises(ValueError, match="segment_steps"):
        next(dia.generator.generate_tokens_stream(TEXT, segment_steps=0))
    with pytest.raises(ValueError, match="audio_prompt_text"):
        next(dia.generator.generate_tokens_stream(TEXT, audio_prompt_codes=golden[:5]))


@pytest.mark.parametrize("captured", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("remainder", range(tgen.GRAPH_STEPS))
def test_segment_plan_runs_exactly_the_steps(captured, remainder):
    for steps in (remainder, remainder + tgen.GRAPH_STEPS, remainder + 8 * tgen.GRAPH_STEPS):
        warm, replays, singles = tgen.segment_plan(steps, captured)
        assert warm + replays * tgen.GRAPH_STEPS + singles == steps
        assert warm == (0 if captured else min(tgen.WARMUP_STEPS, steps))
        assert 0 <= singles < tgen.GRAPH_STEPS


class _FakeGraph:
    """A captured graph stood in for: replaying it runs its steps eagerly."""

    def __init__(self, body, steps):
        self.body, self.steps = body, steps

    def replay(self):
        for _ in range(self.steps):
            self.body()


class _Timed:
    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 0.0


def _fake_graph_loop(monkeypatch):
    """``_run_graphs`` on the CPU: no stream, captures that run nothing (as a
    real capture runs nothing) and replays that step eagerly."""
    captures = []

    def capture(body, buffers, stats, steps):
        captures.append(steps)
        stats.captures += 1
        stats.host_steps += steps
        return _FakeGraph(body, steps)

    def replay(graph, stats, events, steps):
        assert graph.steps == steps
        graph.replay()
        events.append(((_Timed(), _Timed()), steps))

    class _Stream:
        def wait_stream(self, other):
            pass

    monkeypatch.setattr(tgen, "_capture", capture)
    monkeypatch.setattr(tgen, "_replay", replay)
    monkeypatch.setattr(tgen.torch.cuda, "current_stream", lambda: _Stream())
    monkeypatch.setattr(tgen.torch.cuda, "stream", lambda s: nullcontext())
    return captures, _Stream


@pytest.mark.parametrize("segment_steps", [1, 7, 16, 20, 35])
def test_graph_segments_run_exactly_their_steps(monkeypatch, segment_steps):
    """The graph loop's segment runner on a counting fake step: each segment
    runs exactly its steps (warm-up, 16-step replays, one-step replays), the
    state's ``t`` moves by that much, each graph is captured once and only
    when a segment needs it, and the segments' token rows equal one eager
    run to the stop.  No EOS: the near-max trigger stops the run on its last
    row, so no segment is cut short."""
    cfg = tcfg.tiny_test_config()
    T = cfg.data.audio_length
    buf, prefill_step = _template(cfg, 0, seed=1)
    step = _port_step(_table(cfg, 2, seed=4))
    captures, stream = _fake_graph_loop(monkeypatch)
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return step(*args, **kwargs)

    monkeypatch.setattr(tgen, "step_function", lambda params: counting)

    def new_run(buffers):
        return tgen.DecodeRun({}, cfg, buf[None].copy(), _dummy_cache(2, T), None,
                              torch.zeros(2, dtype=torch.int32), prefill_step,
                              np.zeros(1, np.int64), np.asarray([T]),
                              tgen.Sampling(CFG_SCALE, 0.0, TOP_P, TOP_K), None, torch.float32,
                              "eager", buffers, None, clamp_window=True)

    whole = new_run(None)
    whole.run()
    buffers = tgen.LoopBuffers()
    buffers.stream = stream()
    run = new_run(buffers)
    run.loop = run.stats.loop = "graph"  # the CPU tensors' loop, run as the card's
    t, expected, graph, one = prefill_step - 1, [], False, False
    while not bool(run.state.stop):
        n = min(segment_steps, T - 1 - t)
        _, replays, singles = tgen.segment_plan(n, graph or one)
        if replays and not graph:
            expected.append(tgen.GRAPH_STEPS)
            graph = True
        if singles and not one:
            expected.append(1)
            one = True
        calls.clear()
        run.run(n)
        t += n
        assert len(calls) == n and int(run.state.t) == t
    assert t == T - 1 and captures == expected
    assert run.stats.loop == "graph" and run.stats.decode_steps == T - prefill_step
    np.testing.assert_array_equal(run.state.tokens.numpy(), whole.state.tokens.numpy())
    np.testing.assert_array_equal(run.state.final_step.numpy(), whole.state.final_step.numpy())


@pytest.mark.parametrize("max_tokens,eos_at", [(128, ()), (57, ()), (128, ((40, 0),))],
                         ids=["cap", "cap_remainder", "eos"])
def test_graph_whole_run_equals_eager(monkeypatch, max_tokens, eos_at):
    """A whole call on the graph loop (``run()``: the steps left to the cap,
    rounded up to whole replays, through the same segment runner) on a
    counting fake step: the rows and last step equal the eager run's, the
    run ends stopped, it runs the warm-up and whole 16-step replays only
    (no one-step graph is captured), less than ``GRAPH_STEPS`` steps past
    the stop."""
    cfg = tcfg.tiny_test_config()
    T = cfg.data.audio_length
    buf, prefill_step = _template(cfg, 0, seed=1)
    step = _port_step(_table(cfg, 2, seed=4, eos_at=eos_at))  # no EOS but eos_at's
    captures, stream = _fake_graph_loop(monkeypatch)
    calls = []

    def counting(*args, **kwargs):
        calls.append(1)
        return step(*args, **kwargs)

    monkeypatch.setattr(tgen, "step_function", lambda params: counting)
    runs = {}
    for loop in ("eager", "graph"):
        tokens = buf.copy()
        run = tgen.single_run({}, cfg, tokens, _dummy_cache(2, T), None,
                              torch.zeros(2, dtype=torch.int32), prefill_step, max_tokens,
                              CFG_SCALE, 0.0, TOP_P, TOP_K, None, torch.float32)
        run.loop = run.stats.loop = loop
        if loop == "graph":
            run.buffers.stream = stream()
        calls.clear()
        final = int(run.finish(tokens)[0])
        runs[loop] = tokens, final, len(calls), run
    (eager, e_final, e_steps, _), (graph, g_final, g_steps, run) = runs["eager"], runs["graph"]
    np.testing.assert_array_equal(graph, eager)
    assert g_final == e_final and bool(run.state.stop)
    assert e_steps <= g_steps < e_steps + tgen.GRAPH_STEPS
    assert captures == [tgen.GRAPH_STEPS]
    assert (g_steps - tgen.WARMUP_STEPS) % tgen.GRAPH_STEPS == 0
    assert run.stats.step_replays == 0
    assert run.stats.host_steps == tgen.WARMUP_STEPS + tgen.GRAPH_STEPS
    if not eos_at:
        assert e_steps == max_tokens - prefill_step


def _jax_dac():
    return (_unflatten_tree(load_file(str(SMALL / "dac.safetensors"))),
            load_dac_config(SMALL / "dac_config.json"))


@pytest.mark.parametrize("sizes", [(5, 40, 40, 40, 3), (100, 1, 1, 60, 60), (20,)])
def test_stream_decode_wav_equals_jax(dia, golden, sizes):
    codes = np.concatenate([golden, golden[::-1]])[: sum(sizes)]
    cuts = np.cumsum((0,) + sizes)
    chunks = [codes[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    jp, jcfg = _jax_dac()
    ref = [np.asarray(w) for w in jax_stream_decode_wav(jp, jcfg, iter(chunks))]
    out = list(stream_decode_wav(dia.dac_params, dia.dac_config, iter(chunks)))
    assert [w.shape for w in out] == [w.shape for w in ref]
    for a, b in zip(out, ref):
        assert a.dtype == np.float32
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("segment_steps", [24, 128])
def test_generate_stream_equals_generate(dia, segment_steps):
    kw = dict(max_tokens=MAX_TOKENS, temperature=1.3, seed=2)
    offline = dia.generate(TEXT, **kw)
    chunks = list(dia.generate_stream(TEXT, segment_steps=segment_steps, **kw))
    streamed = np.concatenate(chunks)
    assert streamed.shape == offline.shape
    np.testing.assert_allclose(streamed, offline, rtol=0, atol=1e-4)


def test_stream_closed_after_its_first_chunk_then_again(dia):
    """A client that leaves after the first chunk: the stream is closed, and
    the same call again streams the whole run."""
    kw = dict(max_tokens=MAX_TOKENS, temperature=1.3, seed=4)
    full = np.concatenate(list(dia.generate_stream(TEXT, segment_steps=20, **kw)))
    chunks = dia.generate_stream(TEXT, segment_steps=20, **kw)
    first = next(chunks)
    chunks.close()
    again = np.concatenate(list(dia.generate_stream(TEXT, segment_steps=20, **kw)))
    np.testing.assert_array_equal(first, full[: first.shape[0]])
    np.testing.assert_array_equal(again, full)
    assert dia.generator.lock.acquire(blocking=False)  # nothing left holding it
    dia.generator.lock.release()
