"""The port's dynamic batcher (``serving.DynamicBatcher``) and concurrent
calls of one model, on the CPU with ``trained_small``: the counterparts of
tests/test_serving.py, and threads that call one key at once.

* Concurrent compatible requests are coalesced, and each result equals the
  same request's solo ``Dia.generate`` (greedy and seeded: seeds ride per
  stream, so they never split a group); incompatible keys run in separate
  groups; errors reach the caller; the HTTP server coalesces concurrent
  POSTs; SIGTERM drains the server and exits 0.
* Threads calling one model at once, directly and through the server
  without a batcher, each get their solo result (``DiaGenerator.lock``).
"""

import http.client
import json
import os
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch.app import make_server, run_inference
from dia_tts_prune_tpu_torch.serving import DynamicBatcher

torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"
REPO = Path(__file__).parents[1]


@pytest.fixture(scope="module")
def dia():
    return Dia.from_pretrained(SMALL, device="cpu")


def _in_threads(fn, n, timeout=600):
    """``fn(i)`` in n threads released together; returns {i: result}."""
    results, errors = {}, []
    barrier = threading.Barrier(n)

    def run(i):
        try:
            barrier.wait(timeout=60)
            results[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads)
    if errors:
        raise errors[0]
    assert len(results) == n
    return results


def test_concurrent_requests_are_coalesced_and_equal_their_solo_runs(dia):
    batcher = DynamicBatcher(dia, max_batch=8, max_wait_ms=2000.0)
    try:
        texts = [f"[S1] Request number {i} here." for i in range(4)]
        results = _in_threads(
            lambda i: batcher.generate(texts[i], max_tokens=48, temperature=0.0, seed=0), 4)
        assert batcher.stats["requests"] == 4
        assert batcher.stats["max_group"] >= 2 and batcher.stats["batches"] < 4
        assert batcher.stats["batched_requests"] >= 2
        assert batcher.stats["captures"] == 0  # the CPU's eager loop captures nothing
        for i, text in enumerate(texts):
            solo = dia.generate(text, max_tokens=48, temperature=0.0, seed=0)
            np.testing.assert_array_equal(results[i], solo, err_msg=f"request {i}")
    finally:
        batcher.shutdown()


def test_seeded_sampling_reproducible_through_batcher(dia):
    batcher = DynamicBatcher(dia, max_batch=8, max_wait_ms=2000.0)
    try:
        texts = [f"[S1] Seeded request {i}." for i in range(3)]
        seeds = [5, 9, 5]
        results = _in_threads(lambda i: batcher.generate(texts[i], max_tokens=40,
                                                         temperature=1.1, seed=seeds[i]), 3)
        assert batcher.stats["max_group"] >= 2  # different seeds share a group
        for i in range(3):
            solo = dia.generate(texts[i], max_tokens=40, temperature=1.1, seed=seeds[i])
            np.testing.assert_array_equal(results[i], solo, err_msg=f"request {i}")
    finally:
        batcher.shutdown()


def test_incompatible_keys_run_in_separate_groups(dia):
    batcher = DynamicBatcher(dia, max_batch=8, max_wait_ms=200.0)
    try:
        temps = (0.0, 1.3)
        out = _in_threads(lambda i: batcher.generate("[S1] Hello.", max_tokens=40,
                                                     temperature=temps[i], seed=3), 2)
        assert all(v is not None for v in out.values())
        assert batcher.stats["batches"] == 2 and batcher.stats["max_group"] == 1
        for i, temp in enumerate(temps):
            solo = dia.generate("[S1] Hello.", max_tokens=40, temperature=temp, seed=3)
            np.testing.assert_array_equal(out[i], solo)
    finally:
        batcher.shutdown()


def test_errors_are_delivered_to_the_caller(dia):
    batcher = DynamicBatcher(dia, max_batch=2, max_wait_ms=10.0)
    try:
        with pytest.raises(ValueError, match="audio_prompt_text"):
            batcher.generate("[S1] Hi.", max_tokens=32, temperature=0.0,
                             audio_prompt=np.zeros((8, 9), np.int32))
        # the worker goes on serving after an error
        assert batcher.generate("[S1] Hi.", max_tokens=32, temperature=0.0) is not None
    finally:
        batcher.shutdown()
    with pytest.raises(RuntimeError, match="shut down"):
        batcher.generate("[S1] Hi.")


def _serve(dia, batcher=None):
    server = make_server(dia, host="127.0.0.1", port=0, batcher=batcher)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return server, server.server_address[1]


def _post(port, path, payload, timeout=600):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", path, body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    status, body = resp.status, resp.read()
    conn.close()
    return status, body


def _pcm(wav_bytes):
    assert wav_bytes[:4] == b"RIFF"
    return np.frombuffer(wav_bytes[44:], "<i2")


def test_http_server_with_dynamic_batching(dia):
    """Two concurrent POSTs through the HTTP server share one batch, each
    answered with its solo audio."""
    batcher = DynamicBatcher(dia, max_batch=4, max_wait_ms=1500.0)
    server, port = _serve(dia, batcher)
    try:
        texts = ["[S1] Stream 0.", "[S1] Stream 1."]
        out = _in_threads(lambda i: _post(port, "/generate", {
            "text": texts[i], "max_new_tokens": 40, "temperature": 0.0, "seed": 0}), 2)
        assert all(status == 200 for status, _ in out.values())
        for i, text in enumerate(texts):
            solo = dia.generate(text, max_tokens=40, temperature=0.0, seed=0)
            np.testing.assert_array_equal(
                _pcm(out[i][1]), (np.clip(solo, -1, 1) * 32767).astype(np.int16))
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
        assert stats["requests"] >= 2 and stats["max_group"] >= 2
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()


def test_threads_calling_one_key_at_once_get_their_solo_results(dia):
    """Eight threads, more than the cores, with a short switch interval, all
    on one key (streams, cache length, window, sampling): codes, a batched
    call and a stream each equal the same call made alone."""
    text = "[S1] One key, many threads."
    kw = dict(max_tokens=32, temperature=1.2)
    solo = {s: dia.generate_codes(text, seed=s, **kw) for s in range(4)}
    pair = dia.generator.generate_tokens_batch([text, text], seeds=[0, 1], **kw)

    def call(i):
        if i < 4:
            return dia.generate_codes(text, seed=i, **kw)
        if i < 6:
            return dia.generator.generate_tokens_batch([text, text], seeds=[0, 1], **kw)
        return np.concatenate(list(dia.generator.generate_tokens_stream(
            text, segment_steps=5, seed=i - 6, **kw)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        out = _in_threads(call, 8)
    finally:
        sys.setswitchinterval(interval)
    for i in range(4):
        np.testing.assert_array_equal(out[i], solo[i])
    for i in (4, 5):
        for a, b in zip(out[i], pair):
            np.testing.assert_array_equal(a, b)
    for i in (6, 7):
        np.testing.assert_array_equal(out[i], solo[i - 6])
    assert dia.generator.lock.acquire(blocking=False)  # nothing left holding it
    dia.generator.lock.release()


def test_threads_through_the_server_without_a_batcher(dia):
    """Two /generate (the rolling-prompt pipeline, ``run_inference``) and
    two /stream requests of one text at once, each equal to its solo run."""
    server, port = _serve(dia)
    try:
        text = "[S2] Same request, two clients."
        payload = {"text": text, "max_new_tokens": 40, "temperature": 1.3, "seed": 8}
        out = _in_threads(lambda i: _post(port, "/generate" if i < 2 else "/stream", payload), 4)
        _, whole = run_inference(dia, text, max_new_tokens=40, temperature=1.3, seed=8)
        solo = dia.generate(text, max_tokens=40, temperature=1.3, seed=8)
        streamed = (np.clip(solo, -1, 1) * 32767).astype(np.int16)
        for i in range(2):
            assert out[i][0] == 200
            np.testing.assert_array_equal(_pcm(out[i][1]), whole)
        for i in (2, 3):  # the codec decodes spans of other lengths: within 1e-4 of 1.0
            assert out[i][0] == 200
            got = _pcm(out[i][1]).astype(np.int32)
            assert got.shape == streamed.shape and np.abs(got - streamed).max() <= 4
    finally:
        server.shutdown()
        server.server_close()


def test_serve_http_sigterm_drains_and_exits(dia, tmp_path):
    """SIGTERM to ``python -m dia_tts_prune_tpu_torch.app`` (on the CPU, a
    ``save_pretrained`` model, dynamic batching) stops accepting, drains the
    batcher and exits 0."""
    model = tmp_path / "model"
    dia.save_pretrained(model)
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dia_tts_prune_tpu_torch.app", "--model-path", str(model),
         "--device", "cpu", "--compute-dtype", "float32", "--dynamic-batch", "--host",
         "127.0.0.1", "--port", "0"],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        banner = proc.stdout.readline()  # printed once the server listens
        assert "Serving Dia TTS API on http://127.0.0.1:" in banner, banner
        port = int(banner.split("127.0.0.1:")[1].split()[0])
        status, body = _post(port, "/generate", {"text": "[S1] Before the drain.",
                                                 "max_new_tokens": 24, "temperature": 0.0})
        assert status == 200 and body[:4] == b"RIFF"
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out[-2000:]
        assert "drained and stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
