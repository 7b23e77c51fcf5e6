"""The files around the model, port against the JAX package (CPU): FLAC in and
out, ``read_audio`` / ``write_audio`` (mp3 through the in-repo decoder, ogg,
m4a and aac through the libav shim), torch DAC checkpoints, ``Dia.load_dac``
and the constructors' codec options, the prompt cache, an mp3 voice prompt's
greedy codes, ``Dia.random_init``.

* FLAC is numpy on both sides and deterministic (VERBATIM subframes), so the
  port's bytes and decoded samples equal the JAX package's exactly.
* A converted DAC's leaves equal the JAX conversion's at atol 1e-6: both fold
  weight norm in float32 numpy with the same expression, so they agree to the
  bit; the tolerance only states the contract.  Its decode is held at the
  waveform tolerance of tests/test_torch_slice.py, 1e-4 (fp32 convolutions
  sum in another order in XLA's CPU conv and in PyTorch's).
* Prompt codes are compared exactly: the encoder's nearest-code argmax gives
  the JAX codes on these inputs (tests/test_torch_data.py's reasoning).
"""

import os
import struct
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.api import Dia as JaxDia
from dia_tts_prune_tpu.checkpoint import to_torch_state_dict as jax_to_torch_state_dict
from dia_tts_prune_tpu.config import tiny_test_config as jax_tiny_config
from dia_tts_prune_tpu.models import dac as jdac
from dia_tts_prune_tpu.utils import audio_io as jaudio
from dia_tts_prune_tpu.utils import flac as jflac
from dia_tts_prune_tpu_torch import Dia, native, tiny_test_config
from dia_tts_prune_tpu_torch import api as tapi
from dia_tts_prune_tpu_torch.checkpoint import to_torch_state_dict
from dia_tts_prune_tpu_torch.models import dac as tdac
from dia_tts_prune_tpu_torch.utils import audio_io as taudio
from dia_tts_prune_tpu_torch.utils import flac as tflac
from tests.torch_native_support import jax_native

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"
MP3_PROMPT = Path(__file__).parent / "fixtures" / "torch_mp3_prompt" / "prompt.mp3"
# the tiny codec of tests/test_audio_io.py:237-239 (and of the trained fixtures)
TINY_DAC = dict(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=32, decoder_rates=(4, 2),
                n_codebooks=9, codebook_size=1024, codebook_dim=4)
WAV_TOL = 1e-4  # tests/test_torch_slice.py's waveform tolerance, and its cause


def _audio(seed, channels, n):
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(channels, n)) * 0.3).astype(np.float32)
    return a[0] if channels == 1 else a


# ---------------------------------------------------------------------------
# FLAC
# ---------------------------------------------------------------------------

FLAC_CASES = [(1, 10001, 4096), (1, 4097, 1024), (2, 5003, 4096), (2, 2049, 1024)]


@pytest.mark.parametrize("channels,n,block", FLAC_CASES)
def test_write_flac_bytes_equal_jax(tmp_path, channels, n, block):
    audio = _audio(channels * n, channels, n)
    tflac.write_flac(tmp_path / "port.flac", audio, 22050, block_size=block)
    jflac.write_flac(tmp_path / "jax.flac", audio, 22050, block_size=block)
    assert (tmp_path / "port.flac").read_bytes() == (tmp_path / "jax.flac").read_bytes()


@pytest.mark.parametrize("channels,n,block", FLAC_CASES)
def test_read_flac_equals_jax(tmp_path, channels, n, block):
    audio = _audio(channels + n, channels, n)
    p = tmp_path / "a.flac"
    jflac.write_flac(p, audio, 44100, block_size=block)
    got, sr = tflac.read_flac(p)
    want, jsr = jflac.read_flac(p)
    assert sr == jsr == 44100 and got.shape == (channels, n) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    pcm = np.round(np.clip(audio, -1, 1) * 32767.0).astype(np.int16)  # FLAC: half to even
    np.testing.assert_array_equal(np.round(got * 32768.0).astype(np.int16).reshape(pcm.shape),
                                  pcm)


def _fixed_frame_stream(pcm, sample_rate, order, k):
    """One frame of a FIXED-order subframe with a single Rice(k) partition
    (the stream tests/test_audio_io.py::_encode_fixed_frame builds): the
    decoder's prediction and Rice paths, which VERBATIM output never takes."""
    n = len(pcm)
    bw = tflac._BitWriter()
    bw.write_uint(0b11111111111110, 14)
    bw.write_uint(0, 2)
    bw.write_uint(0b0111, 4)  # 16-bit blocksize at end
    bw.write_uint(0, 4)  # rate from STREAMINFO
    bw.write_uint(0, 4)  # mono
    bw.write_uint(0b100, 3)  # 16 bps
    bw.write_uint(0, 1)
    bw.write_bytes(tflac._utf8_number(0))
    bw.write_uint(n - 1, 16)
    hdr = bw.getvalue()

    body = tflac._BitWriter()
    body.write_uint(0, 1)
    body.write_uint(8 + order, 6)  # FIXED subframe of this order
    body.write_uint(0, 1)  # no wasted bits
    for i in range(order):  # warm-up samples
        body.write_uint(int(pcm[i]) & 0xFFFF, 16)
    coeffs = tflac._FIXED_COEFFS[order]
    body.write_uint(0, 2)  # Rice method 0
    body.write_uint(0, 4)  # partition order 0: one partition
    body.write_uint(k, 4)
    for i in range(order, n):
        e = int(pcm[i]) - sum(c * int(pcm[i - 1 - j]) for j, c in enumerate(coeffs))
        u = (abs(e) << 1) - (1 if e < 0 else 0)
        body.write_uint(0, u >> k)  # quotient in unary...
        body.write_uint(1, 1)  # ...and its stop bit
        if k:
            body.write_uint(u & ((1 << k) - 1), k)
    if body._n:
        body.write_uint(0, 8 - body._n)
    frame = hdr + bytes([tflac._crc8(hdr)]) + body.getvalue()
    frame += struct.pack(">H", tflac._crc16(frame))

    streaminfo = bytearray(struct.pack(">HH", n, n)) + (0).to_bytes(3, "big") * 2
    streaminfo += ((sample_rate << 44) | (15 << 36) | n).to_bytes(8, "big") + b"\x00" * 16
    return (b"fLaC" + bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + bytes(streaminfo)
            + frame)


@pytest.mark.parametrize("order", range(5))
@pytest.mark.parametrize("k", [0, 3, 7])
def test_read_flac_fixed_rice_equals_jax(tmp_path, order, k):
    rng = np.random.default_rng(4)
    t = np.arange(600)
    pcm = (3000 * np.sin(t / 25.0) + rng.integers(-40, 40, 600)).astype(np.int64)
    p = tmp_path / "fixed.flac"
    p.write_bytes(_fixed_frame_stream(pcm, 8000, order, k))
    got, sr = tflac.read_flac(p)
    want, _ = jflac.read_flac(p)
    assert sr == 8000
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(np.round(got[0] * 32768.0).astype(np.int64), pcm)


def test_read_audio_dispatches_and_names_the_formats(tmp_path):
    audio = _audio(5, 1, 4000) * 0.5
    taudio.write_wav(tmp_path / "x.wav", audio, 16000)
    tflac.write_flac(tmp_path / "x.flac", audio, 16000)
    for name in ("x.wav", "x.flac"):
        got, sr = taudio.read_audio(tmp_path / name)
        want, jsr = jaudio.read_audio(tmp_path / name)
        assert sr == jsr == 16000
        np.testing.assert_array_equal(got, want)
    assert jax_native() is not None
    got, sr = taudio.read_audio(MP3_PROMPT)  # the in-repo mp3 decoder in both packages
    want, jsr = jaudio.read_audio(MP3_PROMPT)
    assert sr == jsr == 44100 and got.shape == want.shape == (1, 88200)
    np.testing.assert_array_equal(got, want)
    (tmp_path / "x.ogg").write_bytes(b"OggS" + bytes(60))  # no decoder reads it
    with pytest.raises(ValueError, match=r"WAV, FLAC and mp3 decode natively.*FFmpeg"):
        taudio.read_audio(tmp_path / "x.ogg")


@pytest.mark.parametrize("ext", [".wav", ".flac", ""])
def test_write_audio_round_trips(tmp_path, ext):
    audio = _audio(6, 1, 3001) * 0.5
    p = tmp_path / f"out{ext}"
    taudio.write_audio(p, audio, 24000)
    got, sr = taudio.read_audio(p)
    want, jsr = jaudio.read_audio(p)
    assert sr == jsr == 24000
    np.testing.assert_array_equal(got, want)
    # WAV: halves away from zero (native f32_to_pcm16); FLAC: half to even, in both packages
    pcm = (np.round(np.clip(audio, -1, 1) * 32767.0).astype(np.int16) if ext == ".flac"
           else taudio.f32_to_pcm16(audio))
    np.testing.assert_array_equal(np.round(got[0] * 32768.0).astype(np.int16), pcm)


@pytest.mark.parametrize("ext", [".mp3", ".ogg", ".opus", ".m4a", ".aac"])
def test_write_audio_compressed_names_the_shim(tmp_path, ext):
    """Compressed files are written through the libav shim: read back, the
    port's equals the JAX writer's file as the JAX reader reads it.  .opus at
    44.1 kHz, which libopus refuses, raises naming the shim, the codec and
    the rate (the JAX ``write_audio`` says the shim is unavailable: a pinned
    divergence)."""
    if native.load_audiodec() is None or jax_native(audiodec=True) is None:
        pytest.skip("the libav shim needs the system FFmpeg libraries")
    audio = np.stack([_audio(7, 1, 20000), _audio(8, 1, 20000)]) * 0.5  # [C, T]
    if ext == ".opus":
        with pytest.raises(ValueError, match=r"\.opus export failed: the libav shim.*"
                                             r"\.opus at 44100 Hz.*encoder refused"):
            taudio.write_audio(tmp_path / "x.opus", audio, 44100)
        with pytest.raises(ValueError, match="shim.*unavailable"):
            jaudio.write_audio(tmp_path / "j.opus", audio, 44100)
        assert not (tmp_path / "x.opus").exists()
        return
    taudio.write_audio(tmp_path / f"port{ext}", audio, 44100)
    jaudio.write_audio(tmp_path / f"jax{ext}", audio, 44100)
    got, sr = taudio.read_audio(tmp_path / f"port{ext}")
    want, jsr = jaudio.read_audio(tmp_path / f"jax{ext}")
    assert sr == jsr == 44100 and got.shape == want.shape and got.shape[0] == 2
    assert got.shape[1] >= 20000
    np.testing.assert_array_equal(got, want)


def test_write_audio_unknown_extension_raises(tmp_path):
    with pytest.raises(ValueError, match="Unsupported audio output format"):
        taudio.write_audio(tmp_path / "x.xyz", np.zeros(100, np.float32))


# ---------------------------------------------------------------------------
# torch DAC checkpoints
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_dac():
    """The tiny codec's seeded JAX params, and their export re-expressed with
    weight norm (``weight_g`` / ``weight_v``) on every conv, as the published
    checkpoints store them."""
    cfg = jdac.DACConfig(**TINY_DAC)
    jparams = jdac.init_dac_params(cfg, jax.random.PRNGKey(1))
    plain = jdac.to_dac_torch_state_dict(jparams, cfg)
    rng = np.random.default_rng(7)
    wn = {}
    for k, v in plain.items():
        v = np.array(v, np.float32)  # writable: torch.from_numpy takes it as is
        if k.endswith(".weight") and not k.endswith("codebook.weight"):
            base = k[: -len(".weight")]
            wn[f"{base}.weight_v"] = (v * rng.uniform(0.5, 2.0, size=v.shape)).astype(np.float32)
            wn[f"{base}.weight_g"] = rng.uniform(0.1, 1.0, size=(v.shape[0],) + (1,) * (
                v.ndim - 1)).astype(np.float32)
        else:
            wn[k] = v
    return cfg, jparams, wn


def _leaves(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_leaves(v, key))
        else:
            out[key] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


@pytest.mark.parametrize("as_tensors", [False, True])
def test_convert_dac_state_dict_leaves_equal_jax(tiny_dac, as_tensors):
    cfg, _, wn = tiny_dac
    sd = {k: torch.from_numpy(v) for k, v in wn.items()} if as_tensors else wn
    got = _leaves(tdac.convert_dac_torch_state_dict(sd, tdac.DACConfig(**TINY_DAC), "cpu"))
    want = _leaves(jdac.convert_dac_torch_state_dict(wn, cfg))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-6, err_msg=k)


def test_converted_dac_decodes_as_jax(tiny_dac):
    cfg, _, wn = tiny_dac
    params = tdac.convert_dac_torch_state_dict(wn, tdac.DACConfig(**TINY_DAC), "cpu")
    codes = np.random.default_rng(8).integers(0, 1024, size=(2, 37, 9)).astype(np.int32)
    got = tdac.decode_codes(params, tdac.DACConfig(**TINY_DAC), torch.from_numpy(codes))
    want = jdac.decode_codes(jdac.convert_dac_torch_state_dict(wn, cfg), cfg, jnp.asarray(codes))
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=WAV_TOL)


def test_to_dac_state_dict_equals_jax_and_round_trips(tiny_dac):
    cfg, jparams, _ = tiny_dac
    tcfg = tdac.DACConfig(**TINY_DAC)
    params = tdac.convert_dac_torch_state_dict(jdac.to_dac_torch_state_dict(jparams, cfg), tcfg,
                                               "cpu")
    got = tdac.to_dac_torch_state_dict(params, tcfg)
    want = jdac.to_dac_torch_state_dict(jparams, cfg)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    back = _leaves(tdac.convert_dac_torch_state_dict(got, tcfg, "cpu"))
    for k, v in _leaves(params).items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_convert_dac_missing_bias_raises(tiny_dac):
    _, _, wn = tiny_dac
    sd = {k: v for k, v in wn.items() if k != "decoder.model.1.block.1.bias"}
    with pytest.raises(KeyError, match="decoder.model.1.block.1.bias"):
        tdac.convert_dac_torch_state_dict(sd, tdac.DACConfig(**TINY_DAC), "cpu")


# ---------------------------------------------------------------------------
# Dia.load_dac, the constructors' codec options
# ---------------------------------------------------------------------------


def _save_pth(path, wn, wrapped):
    sd = {k: torch.from_numpy(v) for k, v in wn.items()}
    torch.save({"state_dict": sd} if wrapped else sd, path)
    return path


@pytest.fixture(scope="module")
def flac_prompt(tmp_path_factory):
    """A 24-frame FLAC prompt of the tiny codec (44.1 kHz, hop 8)."""
    p = tmp_path_factory.mktemp("prompt") / "prompt.flac"
    tflac.write_flac(p, _audio(9, 1, 24 * 8 * 40) * 0.4, 44100)
    return p


@pytest.mark.parametrize("wrapped", [True, False])
def test_load_dac_then_flac_prompt_codes_equal_jax(tmp_path, tiny_dac, flac_prompt, wrapped):
    cfg, _, wn = tiny_dac
    pth = _save_pth(tmp_path / "dac.pth", wn, wrapped)
    dia = Dia.from_pretrained(SMALL, device="cpu")
    dia.dac_config = tdac.DACConfig(**TINY_DAC)
    dia.load_dac(pth)
    jd = JaxDia.__new__(JaxDia)  # the codec half of a JAX Dia (no model weights)
    jd.dac_config, jd.dac_params, jd._audio_cache = cfg, None, {}
    JaxDia.load_dac(jd, pth)
    got = dia.load_audio(flac_prompt)
    want = JaxDia.load_audio(jd, flac_prompt)
    assert got.dtype == np.int32 and got.shape == want.shape == (40 * 24, 9)
    np.testing.assert_array_equal(got, want)


def test_constructors_take_dac_checkpoint_and_config(tmp_path, tiny_dac):
    _, _, wn = tiny_dac
    pth = _save_pth(tmp_path / "dac.pth", wn, True)
    cfg_json = tmp_path / "dac_config.json"
    cfg_json.write_text((SMALL / "dac_config.json").read_text())
    want = _leaves(tdac.convert_dac_torch_state_dict(wn, tdac.DACConfig(**TINY_DAC), "cpu"))
    local = Dia.from_local(SMALL / "config.json", SMALL / "model.safetensors",
                           dac_checkpoint=pth, dac_config=cfg_json, device="cpu")
    pretrained = Dia.from_pretrained(SMALL, dac_checkpoint=pth, dac_config=cfg_json,
                                     device="cpu")
    for dia in (local, pretrained):
        assert dia.dac_config == tdac.DACConfig(**TINY_DAC)
        got = _leaves(dia.dac_params)
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the directory's own codec when no checkpoint is given
    own = Dia.from_pretrained(SMALL, device="cpu")
    assert not np.array_equal(_leaves(own.dac_params)["decoder.stem.weight"],
                              want["decoder.stem.weight"])
    # dac_config overrides the directory's dac_config.json
    other = tmp_path / "other.json"
    other.write_text(cfg_json.read_text().replace('"sample_rate": 44100', '"sample_rate": 24000'))
    assert Dia.from_pretrained(SMALL, dac_config=other, device="cpu").dac_config.sample_rate \
        == 24000


# ---------------------------------------------------------------------------
# the prompt cache
# ---------------------------------------------------------------------------


@pytest.fixture
def counted(monkeypatch):
    dia = Dia.from_pretrained(SMALL, device="cpu")
    calls = []

    def counting(*a, **kw):
        calls.append(1)
        return tdac.encode_audio(*a, **kw)

    monkeypatch.setattr(tapi, "encode_audio", counting)
    return dia, calls


def _prompt_file(path, seed, frames=6):
    taudio.write_wav(path, _audio(seed, 1, frames * 8) * 0.5, 44100)
    return path


def test_prompt_cache_hit_and_copy(tmp_path, counted):
    dia, calls = counted
    p = _prompt_file(tmp_path / "a.wav", 1)
    first = dia.load_audio(p)
    again = dia.load_audio(str(p))
    assert len(calls) == 1
    np.testing.assert_array_equal(again, first)
    first[:] = -5  # a returned array is the caller's own
    np.testing.assert_array_equal(dia.load_audio(p), again)
    assert len(calls) == 1


@pytest.mark.parametrize("edit", ["mtime", "size"])
def test_prompt_cache_edited_file_reencodes(tmp_path, counted, edit):
    dia, calls = counted
    p = _prompt_file(tmp_path / "a.wav", 2)
    first = dia.load_audio(p)
    if edit == "mtime":
        st = p.stat()
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    else:
        _prompt_file(p, 3, frames=9)
    second = dia.load_audio(p)
    assert len(calls) == 2
    if edit == "mtime":
        np.testing.assert_array_equal(second, first)
    else:
        assert second.shape[0] == 9
    dia.load_audio(p)
    assert len(calls) == 2


def test_mp3_prompt_greedy_codes_equal_jax(tmp_path):
    """``trained_small`` with an mp3 voice prompt (24 frames of the tiny
    codec, hop 8, written by the port's libav shim): both packages decode it
    with their mp3dec to the same samples and encode equal codes, and the
    greedy codes prompted with them are the JAX ``Dia``'s."""
    if native.load_audiodec() is None or jax_native() is None:
        pytest.skip("making the mp3 needs the libav shim (the system FFmpeg libraries)")
    p = tmp_path / "prompt.mp3"
    assert native.encode_mp3(p, _audio(12, 1, 24 * 8) * 0.4, 44100)
    dia, jd = Dia.from_pretrained(SMALL, device="cpu"), JaxDia.from_pretrained(str(SMALL))
    codes, jcodes = dia.load_audio(p), np.asarray(jd.load_audio(p))
    assert codes.shape == (24, 9)
    np.testing.assert_array_equal(codes, jcodes)
    kw = dict(max_tokens=96, temperature=0.0, audio_prompt_text="[S1] An mp3 prompt.")
    got = dia.generate_codes("[S2] Then the reply.", audio_prompt_codes=codes, **kw)
    want = np.asarray(jd.generate_codes("[S2] Then the reply.", audio_prompt_codes=jcodes, **kw))
    assert got.shape[0] > 0
    np.testing.assert_array_equal(got, want)


def test_prompt_cache_evicts_the_oldest_of_17(tmp_path, counted):
    dia, calls = counted
    paths = [_prompt_file(tmp_path / f"p{i}.wav", 10 + i) for i in range(17)]
    for p in paths:
        dia.load_audio(p)
    assert len(calls) == 17 and len(dia._audio_cache) == tapi.AUDIO_CACHE == 16
    dia.load_audio(paths[16])  # the newest: kept
    dia.load_audio(paths[1])  # the oldest kept, now the newest
    assert len(calls) == 17
    dia.load_audio(paths[0])  # evicted by the 17th; evicts paths[2]
    assert len(calls) == 18
    dia.load_audio(paths[1])
    assert len(calls) == 18
    dia.load_audio(paths[2])
    assert len(calls) == 19


# ---------------------------------------------------------------------------
# Dia.random_init
# ---------------------------------------------------------------------------


def test_random_init_keys_and_shapes_equal_jax():
    got = to_torch_state_dict(Dia.random_init(tiny_test_config(), seed=0, device="cpu").params,
                              tiny_test_config())
    jcfg = jax_tiny_config()
    want = jax_to_torch_state_dict(JaxDia.random_init(jcfg, seed=0).params, jcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k


def test_random_init_is_seeded():
    a, b, c = (Dia.random_init(tiny_test_config(), seed=s, device="cpu") for s in (3, 3, 4))
    la, lb, lc = (to_torch_state_dict(d.params, d.config) for d in (a, b, c))
    for k in la:
        np.testing.assert_array_equal(la[k], lb[k], err_msg=k)
    assert any(not np.array_equal(la[k], lc[k]) for k in la if la[k].std() > 0)
    bf = Dia.random_init(tiny_test_config(), seed=3, compute_dtype="bfloat16", device="cpu")
    assert bf.params["decoder"]["logits_dense"]["kernel"].dtype == torch.bfloat16


def test_random_init_with_dac_decodes():
    dia = Dia.random_init(tiny_test_config(), seed=0, with_dac=True, device="cpu")
    assert dia.dac_config == tdac.DACConfig()
    ref = tdac.init_dac_params(tdac.DACConfig(), seed=1, device="cpu")
    np.testing.assert_array_equal(dia.dac_params["decoder"]["stem"]["weight"].numpy(),
                                  ref["decoder"]["stem"]["weight"].numpy())
    codes = np.random.default_rng(0).integers(0, 1024, size=(4, 9)).astype(np.int32)
    wav = dia._decode_waveform(codes)
    assert wav.shape == (4 * dia.dac_config.hop_length,) and np.isfinite(wav).all()
    assert Dia.random_init(tiny_test_config(), device="cpu").dac_params is None


def test_random_init_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Dia.random_init(tiny_test_config())


def test_orbax_directory_raises_a_value_error_naming_the_formats(tmp_path):
    """An orbax checkpoint directory (the JAX ``save_checkpoint`` of a tiny
    tree, which the JAX ``from_local`` restores) is refused with a
    ``ValueError`` that names the formats the port reads and the way across,
    not torch's ``IsADirectoryError``."""
    from dia_tts_prune_tpu.checkpoint import save_checkpoint

    ckpt = tmp_path / "orbax"
    save_checkpoint(ckpt, {"w": np.zeros((2, 3), np.float32)})
    assert ckpt.is_dir()
    cfg_path = tmp_path / "config.json"
    tiny_test_config().save(cfg_path)
    with pytest.raises(ValueError, match="safetensors.*torch state dict.*save_pretrained"):
        Dia.from_local(cfg_path, ckpt, device="cpu")
