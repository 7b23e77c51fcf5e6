"""The port's continuous batcher (``cbatch.ContinuousBatcher``) on the CPU with
``trained_small``: the counterparts of tests/test_cbatch.py's single-device
tests.

* Greedy lanes equal the JAX ``ContinuousBatcher``'s lanes and the JAX solo
  ``generate_tokens``, token for token: staggered admission, more requests
  than lanes, a voice-cloned lane; and with int8 weights and KV caches.
* Seeded lanes equal the port's own solo runs with the same seed (the port
  cannot repeat ``jax.random``), whatever the admission order.
* Cancels (queued and running), a stream consumer that leaves, text over the
  window rejected, errors from prep-ahead and from a bad request delivered
  with the batcher serving on, ``generate`` equal to solo, stream chunks
  equal to ``submit``, stream errors, ``generate_stream`` equal to the
  offline decode, the HTTP server with a batcher (``/generate``, ``/stream``,
  ``/stats``, ``main --continuous-batch``), a worker failure failing the
  futures, shutdown draining the queue.

The three tensor-parallel tests of tests/test_cbatch.py (8 devices) wait
for the port's tensor-parallel code: the batcher takes no ``mesh`` yet.
The loop body against JAX ``cb_segment`` on scripted logits, and the per-row
write slot against JAX ``decode_step_scan``: tests/test_torch_cbatch_body.py.
"""

import http.client
import json
import threading
import time
from concurrent.futures import CancelledError
from pathlib import Path

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.api import Dia as JaxDia
from dia_tts_prune_tpu.cbatch import ContinuousBatcher as JaxBatcher
from dia_tts_prune_tpu.ops.quant import quantize_params_int8_packed as jax_int8
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import app
from dia_tts_prune_tpu_torch import cbatch as tcb
from dia_tts_prune_tpu_torch.cbatch import ContinuousBatcher

torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"
MT = 48
TEXTS = ["[S1] Hello there.", "[S2] A second request.", "[S1] Third arrives late.",
         "[S1] Fourth, later still.", "[S2] continue the voice"]
PROMPT_TEXT = "[S1] twelve frames"


@pytest.fixture(scope="module")
def dia():
    return Dia.from_pretrained(SMALL, device="cpu")


@pytest.fixture(scope="module")
def prompt():
    return np.load(SMALL / "golden.npz")["tokens"][:12]


def _greedy_kwargs(i, prompt):
    """Request i of ``TEXTS``: greedy; the last one voice-cloned."""
    kw = dict(temperature=0.0, seed=i)
    if i == len(TEXTS) - 1:
        kw.update(audio_prompt_codes=prompt, audio_prompt_text=PROMPT_TEXT)
    return kw


def _staggered(cb, kwargs, order, wait_after=2):
    """Submit ``order``'s requests, the ones after the first ``wait_after``
    once the batcher has run a segment; return the codes by request."""
    futs = {}
    for n, i in enumerate(order):
        if n == wait_after:
            while cb.stats["segments"] < 1:
                time.sleep(0.002)
        futs[i] = cb.submit(TEXTS[i], **kwargs(i))
    return {i: f.result(timeout=600) for i, f in futs.items()}


@pytest.fixture(scope="module")
def jax_greedy(prompt, monkeypatch_module):
    """The JAX batcher's greedy lanes (2 lanes, 5 requests staggered) and the
    JAX solo runs of the same requests, the decode step pinned to
    ``decode_step_scan`` as tests/test_cbatch.py pins it."""
    monkeypatch_module.setenv("DIA_DECODE_IMPL", "scan")
    jd = JaxDia.from_pretrained(str(SMALL))
    solo = [np.asarray(jd.generator.generate_tokens(t, max_tokens=MT, cache_len=MT,
                                                    **_greedy_kwargs(i, prompt)))
            for i, t in enumerate(TEXTS)]
    cb = JaxBatcher(jd, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        lanes = _staggered(cb, lambda i: _greedy_kwargs(i, prompt), range(len(TEXTS)))
    finally:
        cb.shutdown()
    return solo, lanes


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_greedy_lanes_equal_jax_batcher_and_jax_solo(dia, prompt, jax_greedy):
    """Five greedy requests through two lanes, three admitted mid-run, one
    voice-cloned: each lane equals the JAX batcher's lane and the JAX solo
    run, and the port's own solo run."""
    solo, jax_lanes = jax_greedy
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        lanes = _staggered(cb, lambda i: _greedy_kwargs(i, prompt), range(len(TEXTS)))
    finally:
        cb.shutdown()
    for i in range(len(TEXTS)):
        assert lanes[i].shape[0] > 0
        np.testing.assert_array_equal(lanes[i], jax_lanes[i], err_msg=f"request {i}")
        np.testing.assert_array_equal(lanes[i], solo[i], err_msg=f"request {i}")
        np.testing.assert_array_equal(
            lanes[i], dia.generate_codes(TEXTS[i], max_tokens=MT, **_greedy_kwargs(i, prompt)))
    assert cb.stats["completed"] == len(TEXTS) and cb.stats["max_live"] == 2
    assert cb.stats["captures"] == 0 and cb.loop == "eager"  # the CPU steps eagerly
    assert 0 < cb.stats["lane_segments_occupied"] <= cb.stats["lane_segments_capacity"]


SEEDED = [dict(temperature=1.1, top_p=0.9, seed=22), dict(temperature=0.0, seed=1),
          dict(temperature=1.3, top_p=0.95, cfg_scale=2.0, seed=33, max_tokens=30),
          dict(temperature=0.8, top_p=0.8, cfg_scale=4.0, seed=44)]


@pytest.mark.parametrize("order", [(0, 1, 2, 3), (3, 2, 1, 0)], ids=["forward", "reversed"])
def test_seeded_lanes_equal_solo_runs_in_any_admission_order(dia, order):
    """Greedy and seeded lanes, each with its own temperature, top_p,
    cfg_scale and cap, staggered through two lanes in either order: each
    equals the port's solo run with the same seed."""
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        lanes = _staggered(cb, lambda i: SEEDED[i], order)
    finally:
        cb.shutdown()
    for i, kw in enumerate(SEEDED):
        ref = dia.generate_codes(TEXTS[i], **{"max_tokens": MT, **kw})
        np.testing.assert_array_equal(lanes[i], ref, err_msg=f"request {i}")


def test_kv_int8_lanes_equal_jax(prompt, monkeypatch):
    """Packed int8 weights with int8 KV caches: greedy lanes equal the JAX
    batcher's lanes over the same packing (``DIA_KV_INT8=1``), and a seeded
    lane the port's solo run."""
    monkeypatch.setenv("DIA_KV_INT8", "1")
    jd = JaxDia.from_pretrained(str(SMALL))
    jd.params = jax_int8(jd.params)
    jcb = JaxBatcher(jd, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        assert jcb._quant
        ref = [jcb.submit(TEXTS[i], **_greedy_kwargs(i, prompt)) for i in (0, 4)]
        ref = [np.asarray(f.result(600)) for f in ref]
    finally:
        jcb.shutdown()
    qd = Dia.from_pretrained(SMALL, device="cpu")
    qd.quantize_int8()
    cb = ContinuousBatcher(qd, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        assert cb.kv_int8
        outs = [cb.submit(TEXTS[i], **_greedy_kwargs(i, prompt)) for i in (0, 4)]
        seeded = cb.submit(TEXTS[1], temperature=1.2, seed=4)
        outs = [f.result(600) for f in outs]
        seeded = seeded.result(600)
    finally:
        cb.shutdown()
    for out, r in zip(outs, ref):
        np.testing.assert_array_equal(out, r)
    np.testing.assert_array_equal(
        seeded, qd.generate_codes(TEXTS[1], max_tokens=MT, temperature=1.2, seed=4))


def test_cancel_queued_and_running_requests(dia):
    """A queued request is dropped at once; a running lane is freed at the
    next segment boundary and its slot serves the next request, which equals
    its solo run."""
    cb = ContinuousBatcher(dia, n_slots=1, segment_steps=4, max_tokens=MT, text_window=128)
    try:
        running = cb.submit("[S1] long running lane", temperature=0.0, seed=1)
        queued = cb.submit("[S1] never admitted", temperature=0.0, seed=2)
        assert cb.cancel(queued) and queued.cancelled()
        while cb.stats["segments"] < 1:
            time.sleep(0.002)
        assert cb.cancel(running)
        with pytest.raises(CancelledError):
            running.result(300)
        after_f = cb.submit("[S1] after cancel", temperature=1.2, seed=3)
        after = after_f.result(300)
        assert not cb.cancel(after_f)  # finished: nothing to cancel
    finally:
        cb.shutdown()
    np.testing.assert_array_equal(
        after, dia.generate_codes("[S1] after cancel", max_tokens=MT, temperature=1.2, seed=3))
    assert cb.stats["cancelled"] == 2


def test_stream_consumer_disconnect_frees_lane(dia):
    cb = ContinuousBatcher(dia, n_slots=1, segment_steps=4, max_tokens=MT, text_window=128)
    try:
        it = cb.submit_stream("[S1] stream then vanish", temperature=0.0, seed=5)
        next(it)
        it.close()
        after = cb.submit("[S1] next customer", temperature=0.0, seed=6).result(300)
    finally:
        cb.shutdown()
    assert after.shape[1] == 9 and cb.stats["cancelled"] == 1


def test_text_over_window_rejected_not_truncated(dia):
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=MT, text_window=64)
    try:
        with pytest.raises(ValueError, match="text window"):
            cb.submit("[S1] " + "word " * 40, temperature=0.0, seed=1).result(300)
        assert cb.submit("[S1] short", temperature=0.0, seed=2).result(300).shape[1] == 9
    finally:
        cb.shutdown()


def test_prep_ahead_error_delivery(dia):
    """A bad request queued behind a busy lane (prepared ahead while a
    segment runs) gets its error; the lane goes on."""
    cb = ContinuousBatcher(dia, n_slots=1, segment_steps=8, max_tokens=MT, text_window=64)
    try:
        good = cb.submit("[S1] occupies the lane", temperature=0.0, seed=1)
        bad = cb.submit("[S1] " + "word " * 40, temperature=0.0, seed=2)
        with pytest.raises(ValueError, match="text window"):
            bad.result(timeout=300)
        assert good.result(timeout=300).shape[1] == 9
    finally:
        cb.shutdown()
    assert cb.stats["completed"] == 1


def test_bad_request_delivers_exception_and_keeps_serving(dia):
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=16, max_tokens=MT, text_window=128)
    try:
        with pytest.raises(ValueError, match="audio_prompt_text"):
            cb.submit("[S1] x", audio_prompt_codes=np.zeros((4, 9), np.int32))
        failing = cb.submit("[S1] x", audio_prompt_codes=np.zeros((4, 5), np.int32),
                            audio_prompt_text="[S1] prompt")  # channels: fails at admission
        with pytest.raises(ValueError):
            failing.result(300)
        assert cb.submit("[S1] still serving", temperature=0.0, seed=0).result(600).shape[0] > 0
    finally:
        cb.shutdown()


def test_generate_waveform_equals_solo(dia):
    solo = dia.generate("[S1] end to end", max_tokens=MT, temperature=1.1, seed=2)
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=16, max_tokens=MT, text_window=128)
    try:
        wav = cb.generate("[S1] end to end", max_tokens=MT, temperature=1.1, seed=2)
        with pytest.raises(ValueError, match="cfg_filter_top_k"):
            cb.generate("[S1] x", cfg_filter_top_k=10)
    finally:
        cb.shutdown()
    np.testing.assert_array_equal(wav, solo)


def test_stream_chunks_concatenate_to_submit_result(dia):
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        solo = cb.submit("[S1] streaming lane", temperature=0.9, seed=7).result(300)
        chunks_iter = cb.submit_stream("[S1] streaming lane", temperature=0.9, seed=7)
        companion = cb.submit("[S1] companion noise lane", temperature=1.1, seed=9)
        chunks = list(chunks_iter)
        companion.result(300)
    finally:
        cb.shutdown()
    assert len(chunks) > 1
    np.testing.assert_array_equal(np.concatenate(chunks, axis=0), solo)


def test_stream_error_delivery(dia):
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        with pytest.raises(ValueError):
            cb.submit_stream("[S1] bad", temperature=0.0,
                             audio_prompt_codes=np.zeros((8, 9), np.int32))
        it = cb.submit_stream("[S1] bad", temperature=0.0,
                              audio_prompt_codes=np.zeros((8, 5), np.int32),
                              audio_prompt_text="[S1] prompt")
        with pytest.raises(ValueError):
            list(it)
        assert cb.submit("[S1] still alive", temperature=0.0, seed=1).result(300).shape[1] == 9
    finally:
        cb.shutdown()


def test_generate_stream_equals_offline_decode(dia):
    """``generate_stream``'s audio equals the offline waveform of the same
    request (the incremental codec decode), while another lane runs."""
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)
    try:
        offline = cb.generate("[S1] stream me", max_tokens=MT, temperature=0.0, seed=3)
        companion = cb.submit("[S1] other lane", temperature=0.0, seed=4)
        chunks = list(cb.generate_stream("[S1] stream me", temperature=0.0, seed=3,
                                         max_tokens=MT))
        companion.result(300)
    finally:
        cb.shutdown()
    np.testing.assert_allclose(np.concatenate(chunks), offline, rtol=0, atol=1e-4)


def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    conn.request("POST", path, body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body = resp.read()
    conn.close()
    return resp.status, body


def test_http_server_with_continuous_batching(dia):
    """Two concurrent ``/generate`` ride resident lanes and equal their solo
    audio; ``/stream`` streams from a lane and equals the in-process
    ``generate_stream``; ``/stats`` shows the batcher's counters; a text
    over the window gets a 400."""
    batcher = ContinuousBatcher(dia, n_slots=2, segment_steps=16, max_tokens=MT, text_window=64)
    server = app.make_server(dia, host="127.0.0.1", port=0, batcher=batcher)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    try:
        out, barrier = {}, threading.Barrier(2)

        def post(i):
            barrier.wait()
            out[i] = _post(port, "/generate", {"text": f"[S1] Lane {i}.", "max_new_tokens": MT,
                                               "temperature": 0.0, "seed": i})

        threads = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        for i in range(2):
            solo = dia.generate(f"[S1] Lane {i}.", max_tokens=MT, temperature=0.0, seed=i)
            assert out[i][0] == 200
            np.testing.assert_array_equal(np.frombuffer(out[i][1][44:], np.int16),
                                          (np.clip(solo, -1, 1) * 32767).astype(np.int16))
        status, body = _post(port, "/stream", {"text": "[S1] live stream", "max_new_tokens": MT,
                                               "temperature": 0.0, "seed": 5})
        chunks = list(batcher.generate_stream("[S1] live stream", max_tokens=MT,
                                              temperature=0.0, seed=5))
        assert status == 200 and body[:4] == b"RIFF"
        assert body == app._wav_stream_header(app.SAMPLE_RATE) + app._pcm16(
            np.concatenate(chunks)).tobytes()
        status, body = _post(port, "/stream", {"text": "[S1] " + "word " * 40})
        assert status == 400 and b"text window" in body
        status, _ = _post(port, "/generate", {"text": "[S1] " + "word " * 20 + "end.",
                                              "chunk_size": 256})
        assert status == 400
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        assert stats["requests"] >= 5 and stats["completed"] >= 3 and stats["captures"] == 0
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()


def test_main_continuous_batch_flags(monkeypatch):
    """``main --continuous-batch --cb-*`` hands ``serve_http`` a
    ``ContinuousBatcher`` of those shapes; with ``--dynamic-batch`` it is an
    error."""
    served = {}
    monkeypatch.setattr(app, "serve_http", lambda dia, host, port, batcher=None: served.update(
        dia=dia, batcher=batcher))
    argv = ["--model-path", str(SMALL), "--device", "cpu", "--continuous-batch", "--cb-slots", "3",
            "--cb-segment-steps", "8", "--cb-max-tokens", "40", "--cb-text-window", "64"]
    assert app.main(argv) == 0
    cb = served["batcher"]
    try:
        assert isinstance(cb, ContinuousBatcher)
        assert (cb.n_slots, cb.segment_steps, cb.max_tokens, cb.text_window) == (3, 8, 40, 64)
        assert cb.submit("[S1] Hi.", temperature=0.0).result(300).shape[1] == 9
    finally:
        cb.shutdown()
    with pytest.raises(SystemExit):
        app.main(argv + ["--dynamic-batch"])


def test_worker_failure_fails_futures_instead_of_hanging(dia, monkeypatch):
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=8, max_tokens=MT, text_window=128)

    def boom(*a, **k):
        raise RuntimeError("device went away")

    monkeypatch.setattr(tcb, "cb_segment", boom)
    f1 = cb.submit("[S1] doomed", temperature=0.0, seed=1)
    it = cb.submit_stream("[S1] doomed stream", temperature=0.0, seed=2)
    with pytest.raises(RuntimeError, match="device went away"):
        f1.result(120)
    with pytest.raises(RuntimeError, match="device went away"):
        list(it)
    with pytest.raises(RuntimeError, match="shut down"):
        cb.submit("[S1] after death")


def test_shutdown_drains_queue(dia):
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=16, max_tokens=MT, text_window=128)
    futs = [cb.submit(f"[S1] drain {i}", temperature=0.0, seed=i) for i in range(3)]
    cb.shutdown(wait=True)
    for f in futs:
        assert f.result(timeout=1).shape[1] == 9


def test_segment_steps_and_slots_are_checked(dia):
    with pytest.raises(ValueError, match="positive"):
        ContinuousBatcher(dia, n_slots=0)
    with pytest.raises(ValueError, match="n_slots must be at most 32"):
        ContinuousBatcher(dia, n_slots=33)  # 66 rows a step: past fixed_rows_matmul's 64
    cb = ContinuousBatcher(dia, n_slots=1, segment_steps=5, max_tokens=10_000)  # eager: any length
    try:
        assert cb.max_tokens == dia.config.data.audio_length
        assert cb.cache_len == dia.config.data.audio_length
    finally:
        cb.shutdown()


def test_many_threads_submit_and_cancel_at_once(dia):
    """More submitting threads than cores, a short switch interval, half of
    them cancelling what they submitted: every future resolves (codes or
    cancelled), the counters add up, and every finished request equals its
    solo run."""
    import os
    import sys

    n = 2 * (os.cpu_count() or 4)
    cb = ContinuousBatcher(dia, n_slots=3, segment_steps=4, max_tokens=24, text_window=128)
    futs, cancelled, errors = {}, {}, []
    barrier = threading.Barrier(n)

    def client(i):
        try:
            barrier.wait(timeout=60)
            futs[i] = cb.submit(f"[S1] Client {i % 3}.", temperature=0.0 if i % 2 else 1.2,
                                seed=i % 3, max_tokens=24)
            if i % 2 == 0:
                cancelled[i] = cb.cancel(futs[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not errors and not any(t.is_alive() for t in threads)
        done = {}
        for i, f in futs.items():
            try:
                done[i] = f.result(timeout=300)
            except CancelledError:
                assert cancelled.get(i), i
    finally:
        sys.setswitchinterval(interval)
        cb.shutdown()
    assert cb.stats["requests"] == n
    assert cb.stats["completed"] + cb.stats["cancelled"] == n
    for i, codes in done.items():
        ref = dia.generate_codes(f"[S1] Client {i % 3}.", max_tokens=24,
                                 temperature=0.0 if i % 2 else 1.2, seed=i % 3)
        np.testing.assert_array_equal(codes, ref, err_msg=f"client {i}")
