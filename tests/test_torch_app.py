"""The port's serving front end (``app.py``) and its audio helpers against the
JAX package's, and its pipeline on ``trained_small``, on the CPU: the
counterparts of tests/test_app.py (its Gradio test has none: the port serves
the stdlib HTTP API only).

* The chunking helpers give the JAX helpers' output on generated texts
  (speaker and non-verbal tags, odd whitespace, long words), and pass the
  JAX test's own cases.
* ``speed_change``, ``_wav_stream_header`` and ``_wav_bytes`` equal the JAX
  functions' output, bytes for bytes.
* ``run_inference`` rolls the voice prompt from batch to batch, refuses an
  empty text, and its speed factor changes the length; the HTTP API answers
  /health, /generate, /stream and a 400; ``main`` serves int8 weights.
"""

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from dia_tts_prune_tpu import app as japp
from dia_tts_prune_tpu.utils import audio_io as jaudio
from dia_tts_prune_tpu_torch import Dia, app
from dia_tts_prune_tpu_torch.generate import decoder_is_packed
from dia_tts_prune_tpu_torch.utils.audio_io import read_wav, speed_change, write_wav

torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"

_WORDS = st.one_of(
    st.sampled_from(["[S1]", "[S2]", "[S1][S2]", "(laughs)", "(coughs)", "(sighs)", "[S3]",
                     "hello", "world", "Dia.", "a", "I'm", "e.g.,"]),
    st.text(alphabet="abcXYZ.,!?'()[]S12-é", min_size=1, max_size=80))
_TEXTS = st.lists(st.tuples(_WORDS, st.sampled_from([" ", "  ", "\n", "\t", " \n "])),
                  max_size=80).map(lambda parts: "".join(w + s for w, s in parts))


@settings(max_examples=300, deadline=None, database=None)
@given(text=_TEXTS, user=st.integers(-4, 130), budget=st.integers(1, 120),
       batch=st.integers(1, 6))
def test_chunking_equals_jax(text, user, budget, batch):
    assert app.count_effective_length(text) == japp.count_effective_length(text)
    assert app.auto_adjust_chunk_size(text, user) == japp.auto_adjust_chunk_size(text, user)
    chunks = app.split_by_words_respecting_special_tokens(text, budget)
    assert chunks == japp.split_by_words_respecting_special_tokens(text, budget)
    assert list(app.batch_chunks(chunks, batch)) == list(japp.batch_chunks(chunks, batch))


@pytest.mark.parametrize("n", [100, 1024, 1025, 2000, 4096, 4097, 5000])
def test_auto_chunk_size_budgets_equal_jax(n):
    for text in ("a" * n, "[S1]" * n, "[S1] " + "word " * (n // 5)):
        assert app.auto_adjust_chunk_size(text) == japp.auto_adjust_chunk_size(text)
    assert app.auto_adjust_chunk_size("a" * n, user_chunk_size=32) == 32


def test_chunking_cases_of_the_jax_tests():
    assert app.count_effective_length("[S1] hi") == 4
    assert app.count_effective_length("abc") == 3
    assert app.count_effective_length("[S1][S2]") == 2
    assert [app.auto_adjust_chunk_size("a" * n) for n in (100, 2000, 5000)] == [48, 64, 96]
    text = "[S1] " + " ".join(f"word{i}" for i in range(40)) + " [S2] tail"
    chunks = app.split_by_words_respecting_special_tokens(text, 48)
    assert all(app.count_effective_length(c) <= 48 or " " not in c for c in chunks)
    assert " ".join(chunks).split() == text.split()
    assert list(app.batch_chunks(list("abcdefg"), 4)) == [list("abcd"), list("efg")]


@settings(max_examples=200, deadline=None, database=None)
@given(n=st.integers(0, 3000), factor=st.floats(0.01, 7.0), seed=st.integers(0, 2 ** 16))
def test_speed_change_equals_jax(n, factor, seed):
    audio = np.random.default_rng(seed).uniform(-1, 1, n).astype(np.float32)
    out, ref = speed_change(audio, factor), jaudio.speed_change(audio, factor)
    assert out.dtype == ref.dtype
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("sr", [8000, 16000, 44100, 48000])
def test_wav_headers_and_bytes_equal_jax(sr):
    assert app._wav_stream_header(sr) == japp._wav_stream_header(sr)
    assert len(app._wav_stream_header(sr)) == 44
    pcm = np.random.default_rng(sr).integers(-32768, 32767, 777).astype(np.int16)
    assert app._wav_bytes(sr, pcm) == japp._wav_bytes(sr, pcm)
    assert app._wav_bytes(sr, pcm[:0]) == japp._wav_bytes(sr, pcm[:0])


def test_write_wav_rounds_clips_and_reads_back(tmp_path):
    audio = np.asarray([0.0, 0.5, -0.5, 1.5, -2.0, 1 / 32767], np.float32)
    write_wav(tmp_path / "a.wav", audio, 16000)
    data, sr = read_wav(tmp_path / "a.wav")
    assert sr == 16000 and data.shape == (1, 6)
    want = np.round(np.clip(audio, -1, 1) * 32767) / 32768
    np.testing.assert_array_equal(data[0], want.astype(np.float32))
    stereo = np.stack([audio, -audio])
    write_wav(tmp_path / "s.wav", (stereo * 1000).astype(np.int16))  # ints scale by their max
    data, sr = read_wav(tmp_path / "s.wav")
    assert sr == 44100 and data.shape == (2, 6)


@pytest.fixture(scope="module")
def dia():
    return Dia.from_pretrained(SMALL, device="cpu")


def test_run_inference_rolls_the_voice_prompt(dia, monkeypatch):
    """Two batches of four chunks: the second batch is prompted with the
    first one's audio (a WAV written, then DAC-encoded by ``load_audio``)
    and text, and the output is the two batches' audio with the silence
    between them.  A batch's token budget counts the prompt's rows, as in
    the JAX package, so the second batch's chunks are the longer ones; and
    the fixture never emits EOS, so its rows are lengthened to 1024 (RoPE
    positions: no weight depends on them) to hold both."""
    cfg = dia.config.model_copy(
        update={"data": dia.config.data.model_copy(update={"audio_length": 1024})})
    dia = Dia(cfg, dia.params, "float32", dia.dac_params, dia.dac_config, device="cpu")
    calls, loads = [], []
    generate, load_audio = dia.generate, dia.load_audio

    def spy_generate(text, **kw):
        audio = generate(text, **kw)
        calls.append((text, kw, audio))
        return audio

    def spy_load_audio(path):
        loads.append(read_wav(path)[0][0])
        return load_audio(path)

    monkeypatch.setattr(dia, "generate", spy_generate)
    monkeypatch.setattr(dia, "load_audio", spy_load_audio)
    text = "[S1] " + " ".join(["canoeplank"] * 4 + ["[S2] smoothplanks"] * 4)
    sr, pcm = app.run_inference(dia, text, max_new_tokens=200, temperature=0.0,
                                chunk_size=16, seed=3)
    assert sr == 44100 and pcm.dtype == np.int16
    assert len(calls) == 2
    (t1, kw1, a1), (t2, kw2, a2) = calls
    assert kw1["audio_prompt"] is None and kw2["audio_prompt_text"] == t1
    for t, kw in ((t1, kw1), (t2, kw2)):  # the per-batch budget, at least 256
        assert kw["max_tokens"] == max(256, int(200 * app.count_effective_length(t) / 16))
    assert len(loads) == 1 and loads[0].shape == a1.shape and a2 is not None
    np.testing.assert_allclose(loads[0], np.round(np.clip(a1, -1, 1) * 32767) / 32768,
                               atol=1.5 / 32768)
    silence = int(app.SAMPLE_RATE * app.SILENCE_SEC)
    want = np.concatenate([a1, np.zeros(silence, np.float32), a2])
    np.testing.assert_array_equal(pcm, (np.clip(want, -1, 1) * 32767).astype(np.int16))


def test_run_inference_empty_text_raises(dia):
    for text in ("", "   ", "\n\t"):
        with pytest.raises(ValueError, match="empty"):
            app.run_inference(dia, text)


def test_speed_factor_changes_length(dia):
    text = "[S1] short test"
    _, normal = app.run_inference(dia, text, max_new_tokens=64, temperature=0.0, seed=1)
    _, fast = app.run_inference(dia, text, max_new_tokens=64, temperature=0.0, seed=1,
                                speed_factor=2.0)
    assert normal.shape[0] > 0 and abs(fast.shape[0] - normal.shape[0] / 2) <= 2


def _request(url, payload, timeout=600):
    return urllib.request.Request(url, data=json.dumps(payload).encode(),
                                  headers={"Content-Type": "application/json"})


def test_http_api_round_trip(dia):
    server = app.make_server(dia, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{base}/health", timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        with pytest.raises(urllib.error.HTTPError) as exc:  # no batcher, no stats
            urllib.request.urlopen(f"{base}/stats", timeout=10)
        assert exc.value.code == 404

        req = {"text": "[S1] api test", "max_new_tokens": 64, "temperature": 0.0, "seed": 5}
        with urllib.request.urlopen(_request(f"{base}/generate", req), timeout=600) as r:
            wav = r.read()
        _, want = app.run_inference(dia, "[S1] api test", max_new_tokens=64, temperature=0.0,
                                    seed=5)
        assert wav == app._wav_bytes(44100, want)

        with urllib.request.urlopen(_request(f"{base}/stream", req), timeout=600) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            streamed = r.read()
        assert streamed[:44] == app._wav_stream_header(44100)
        offline = dia.generate("[S1] api test", max_tokens=64, temperature=0.0, seed=5)
        pcm = np.frombuffer(streamed[44:], "<i2").astype(np.int32)
        want = (np.clip(offline, -1, 1) * 32767).astype(np.int16)
        assert pcm.shape == want.shape and np.abs(pcm - want).max() <= 4

        for path, bad in (("/generate", {"text": " "}),
                          ("/stream", {"text": "[S1] Hi.", "audio_prompt": [[1] * 9] * 4})):
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(_request(f"{base}{path}", bad), timeout=60)
            assert exc.value.code == 400 and "error" in json.loads(exc.value.read())
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.parametrize("dynamic", [False, True], ids=["serial", "dynamic_batch"])
def test_main_serves_int8_weights(monkeypatch, dynamic):
    """``main --quantize-int8`` hands ``serve_http`` a model whose decoder is
    packed int8, which generates; ``--dynamic-batch`` adds a batcher."""
    served = {}
    monkeypatch.setattr(app, "serve_http", lambda dia, host, port, batcher=None: served.update(
        dia=dia, host=host, port=port, batcher=batcher))
    argv = ["--model-path", str(SMALL), "--device", "cpu", "--quantize-int8", "--port", "7999"]
    assert app.main(argv + (["--dynamic-batch", "--max-batch", "3"] if dynamic else [])) == 0
    dia = served["dia"]
    assert decoder_is_packed(dia.params) and served["port"] == 7999
    assert dia.generate_codes("[S1] quantized", max_tokens=40, temperature=0.0).shape[0] > 0
    if dynamic:
        assert served["batcher"].max_batch == 3
        served["batcher"].shutdown()
    else:
        assert served["batcher"] is None
