"""The port's DAC encoder, audio reading, dataset pipeline, checkpoint export
and fine-tuning CLI against the JAX package (CPU, fp32).

``encode_audio`` must give the JAX package's codes exactly on the fixture's
codec for a seeded waveform: both take the argmax of the same cosine
similarities, ties going to the lowest index in both; a near-tie decided
differently by fp32 summation order would show as a mismatch (none occurs on
these inputs).
"""

import json
import wave
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file

from dia_tts_prune_tpu import checkpoint as jckpt
from dia_tts_prune_tpu import data as jdata
from dia_tts_prune_tpu.api import Dia as JaxDia
from dia_tts_prune_tpu.api import _unflatten_tree
from dia_tts_prune_tpu.api import load_dac_config as jax_load_dac_config
from dia_tts_prune_tpu.config import DiaConfig as JaxDiaConfig
from dia_tts_prune_tpu.models import dac as jdac
from dia_tts_prune_tpu.utils import audio_io as jaudio
from dia_tts_prune_tpu_torch import Dia, native
from dia_tts_prune_tpu_torch import checkpoint as tckpt
from dia_tts_prune_tpu_torch import data as tdata
from dia_tts_prune_tpu_torch.api import write_wav
from dia_tts_prune_tpu_torch.models import dac as tdac
from dia_tts_prune_tpu_torch.utils import audio_io as taudio
from dia_tts_prune_tpu_torch.utils.prefetch import prefetch
from tests.torch_native_support import jax_native

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"


@pytest.fixture(scope="module")
def codecs():
    jcfg = jax_load_dac_config(SMALL / "dac_config.json")
    jparams = _unflatten_tree(load_file(str(SMALL / "dac.safetensors")))
    dia = Dia.from_pretrained(SMALL, device="cpu")
    return jcfg, jparams, dia


def _wave(seed, n):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 44100.0
    return (0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.normal(size=n)).astype(np.float32)


@pytest.mark.parametrize("seed,frames", [(0, 40), (1, 7)])
def test_encode_audio_codes_equal_jax(codecs, seed, frames):
    jcfg, jparams, dia = codecs
    wav = np.stack([_wave(seed, jcfg.hop_length * frames), _wave(seed + 10,
                                                                 jcfg.hop_length * frames)])
    ref = np.asarray(jdac.encode_audio(jparams, jcfg, jnp.asarray(wav)))
    out = tdac.encode_audio(dia.dac_params, dia.dac_config, torch.from_numpy(wav))
    assert out.dtype == torch.int32 and tuple(out.shape) == (2, frames, jcfg.n_codebooks)
    np.testing.assert_array_equal(out.numpy(), ref)
    latent = tdac.dac_encode_latent(dia.dac_params, dia.dac_config,
                                    torch.from_numpy(wav)[:, None])
    np.testing.assert_allclose(latent.numpy(), np.asarray(jdac.dac_encode_latent(
        jparams, jcfg, jnp.asarray(wav)[:, None])), rtol=0, atol=1e-4)


def test_pad_audio_and_seeded_init():
    a = np.ones((1, 13), np.float32)
    np.testing.assert_array_equal(tdac.pad_audio(a, 8), jdac.pad_audio(a, 8))
    assert tdac.pad_audio(a[:, :8], 8).shape == (1, 8)
    cfg = tdac.DACConfig(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=32,
                         decoder_rates=(4, 2), n_codebooks=9, codebook_size=64, codebook_dim=4)
    p = tdac.init_dac_params(cfg, seed=1, device="cpu")
    j = jdac.init_dac_params(jdac.DACConfig(**cfg.__dict__), jax.random.PRNGKey(0))
    shapes = lambda t: {k: tuple(v.shape) for k, v in _flat(t).items()}  # noqa: E731
    assert shapes(p) == shapes(jax.tree.map(np.asarray, j))
    dec = tdac.init_dac_decoder_params(cfg, seed=1, device="cpu")  # the decode side is unchanged
    assert torch.equal(dec["decoder"]["head"]["weight"], p["decoder"]["head"]["weight"])
    codes = tdac.encode_audio(p, cfg, torch.from_numpy(_wave(2, 80))[None])
    assert tuple(codes.shape) == (1, 10, 9) and int(codes.max()) < 64


def _flat(tree, prefix=""):
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    out = {}
    for k, v in items:
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(_flat(v, key))
        else:
            out[key] = v
    return out


@pytest.mark.parametrize("width,channels,rate", [(2, 1, 44100), (2, 2, 22050), (3, 1, 48000),
                                                 (4, 2, 44100), (1, 1, 16000)])
def test_load_audio_mono_equals_jax(tmp_path, width, channels, rate):
    rng = np.random.default_rng(width)
    n = 2000
    hi = 1 << (8 * width - 1)
    ints = rng.integers(-hi, hi, (n, channels))
    path = tmp_path / "x.wav"
    with wave.open(str(path), "wb") as f:
        f.setnchannels(channels)
        f.setsampwidth(width)
        f.setframerate(rate)
        if width == 1:
            f.writeframes((ints + 128).astype(np.uint8).tobytes())
        elif width == 3:
            f.writeframes(b"".join(int(v).to_bytes(3, "little", signed=True)
                                   for v in ints.reshape(-1)))
        else:
            f.writeframes(ints.astype({2: "<i2", 4: "<i4"}[width]).tobytes())
    data, sr = taudio.read_wav(path)
    ref, ref_sr = jaudio.read_wav(path)
    assert sr == ref_sr == rate and data.shape == (channels, n)
    np.testing.assert_allclose(data, ref, rtol=0, atol=1e-7)
    np.testing.assert_allclose(taudio.load_audio_mono(path), jaudio.load_audio_mono(path),
                               rtol=0, atol=1e-6)


def test_other_formats_raise(tmp_path):
    p = tmp_path / "x.ogg"  # an Ogg page header and nothing after it: no decoder reads it
    p.write_bytes(b"OggS" + bytes(40))
    with pytest.raises(ValueError, match="WAV, FLAC and mp3 decode natively"):
        taudio.load_audio_mono(p)


def test_finetune_dataset_mp3_and_ogg_items_equal_jax(codecs, tmp_path):
    """A manifest with an mp3 item (the in-repo decoder in both packages) and
    an ogg item (the libav shim in both): the port's batches equal the JAX
    dataset's."""
    if native.load_audiodec() is None or jax_native(audiodec=True) is None:
        pytest.skip("the libav shim needs the system FFmpeg libraries")
    jcfg, jparams, dia = codecs
    (tmp_path / "wavs").mkdir()
    for name, seed, n in (("a0.mp3", 30, 9000), ("a1.ogg", 31, 7001)):
        assert native.encode_audio(tmp_path / "wavs" / name, _wave(seed, n), 44100)
    (tmp_path / "metadata.csv").write_text("a0.mp3|[S1] Hello there.\na1.ogg|[S2] Hi.\n")
    jds = jdata.FineTuneDataset(tmp_path / "metadata.csv", tmp_path / "wavs",
                                JaxDiaConfig.load(SMALL / "config.json"), jparams, jcfg)
    tds = tdata.FineTuneDataset(tmp_path / "metadata.csv", tmp_path / "wavs", dia.config,
                                dia.dac_params, dia.dac_config)
    jb, tb = list(jds.batches(2, shuffle=False)), list(tds.batches(2, shuffle=False))
    assert len(tb) == len(jb) == 1 and tb[0]["text_ids"].shape[0] == 2
    for key in jb[0]:
        np.testing.assert_array_equal(tb[0][key], jb[0][key], err_msg=key)


@pytest.fixture(scope="module")
def dataset_dir(codecs, tmp_path_factory):
    """A three-item LJSpeech-format dataset (one listed file is missing, one
    line is malformed)."""
    root = tmp_path_factory.mktemp("ds")
    (root / "wavs").mkdir()
    lines = []
    for i, (text, n) in enumerate([("[S1] Hello there.", 9000), ("[S2] Hi.", 5000),
                                   ("[S1] One more line.", 12345)]):
        write_wav(root / "wavs" / f"a{i}.wav", _wave(20 + i, n))
        lines.append(f"a{i}.wav|{text}")
    lines += ["missing.wav|[S1] not there", "no separator"]
    (root / "metadata.csv").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("loss_mode", ["delayed", "reference"])
def test_finetune_dataset_batches_equal_jax(codecs, dataset_dir, loss_mode):
    jcfg, jparams, dia = codecs
    jconfig = JaxDiaConfig.load(SMALL / "config.json")
    jds = jdata.FineTuneDataset(dataset_dir / "metadata.csv", dataset_dir / "wavs", jconfig,
                                jparams, jcfg, loss_mode=loss_mode)
    tds = tdata.FineTuneDataset(dataset_dir / "metadata.csv", dataset_dir / "wavs", dia.config,
                                dia.dac_params, dia.dac_config, loss_mode=loss_mode)
    assert len(tds) == len(jds) == 3
    for kw in (dict(shuffle=True, seed=5), dict(shuffle=False, drop_last=True)):
        jb, tb = list(jds.batches(2, **kw)), list(tds.batches(2, **kw))
        assert len(jb) == len(tb) == (1 if kw.get("drop_last") else 2)
        for a, b in zip(tb, jb):
            for key in b:
                np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(dia.load_audio(dataset_dir / "wavs" / "a0.wav"),
                                  tds.encode_item_audio(tds.items[0]))


def test_dataset_skips_unreadable_items(codecs, dataset_dir, tmp_path, capsys):
    _, _, dia = codecs
    (tmp_path / "wavs").mkdir()
    (tmp_path / "wavs" / "bad.wav").write_bytes(b"not audio")
    (tmp_path / "wavs" / "ok.wav").write_bytes((dataset_dir / "wavs" / "a1.wav").read_bytes())
    (tmp_path / "metadata.csv").write_text("bad.wav|[S1] x\nok.wav|[S2] Hi.\n")
    ds = tdata.FineTuneDataset(tmp_path / "metadata.csv", tmp_path / "wavs", dia.config,
                               dia.dac_params, dia.dac_config)
    batches = list(ds.batches(2, shuffle=False))
    assert len(batches) == 1 and batches[0]["text_ids"].shape[0] == 1
    assert "failed to encode" in capsys.readouterr().out
    with pytest.raises(ValueError, match="No valid items"):
        tdata.FineTuneDataset(tmp_path / "metadata.csv", tmp_path / "nowhere", dia.config,
                              dia.dac_params, dia.dac_config)


def test_prefetch_yields_in_order_and_forwards_errors():
    assert list(prefetch(iter(range(5)))) == [0, 1, 2, 3, 4]

    def failing():
        yield 1
        raise ValueError("boom")

    it = prefetch(failing())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        list(it)


def test_to_torch_state_dict_round_trip_and_equals_jax(codecs, tmp_path):
    _, _, dia = codecs
    sd = tckpt.to_torch_state_dict(dia.params, dia.config)
    ref = load_file(str(SMALL / "model.safetensors"))
    assert sorted(sd) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(sd[k], ref[k])
    jconfig = JaxDiaConfig.load(SMALL / "config.json")
    jsd = jckpt.to_torch_state_dict(jckpt.load_safetensors_checkpoint(
        SMALL / "model.safetensors", jconfig), jconfig)
    assert sorted(jsd) == sorted(sd)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "pytorch_model.bin")
    back = tckpt.load_checkpoint(tmp_path / "pytorch_model.bin", dia.config, device="cpu")
    jback = jckpt.load_torch_checkpoint(tmp_path / "pytorch_model.bin", jconfig)
    flat = tckpt.params_to_numpy(back)
    np.testing.assert_array_equal(flat["decoder"]["layers"]["mlp"]["wo"]["kernel"],
                                  np.asarray(jback["decoder"]["layers"]["mlp"]["wo"]["kernel"]))
    dia.quantize_int8()
    try:
        with pytest.raises(TypeError, match="packed kernel"):
            tckpt.to_torch_state_dict(dia.params, dia.config)
    finally:
        dia._set_params(back)


def test_save_pretrained_loads_in_both_packages(codecs, tmp_path):
    _, _, dia = codecs
    dia.save_pretrained(tmp_path / "m")
    assert sorted(p.name for p in (tmp_path / "m").iterdir()) == [
        "config.json", "dac.safetensors", "dac_config.json", "model.safetensors"]
    again = Dia.from_pretrained(tmp_path / "m", device="cpu")
    jd = JaxDia.from_pretrained(str(tmp_path / "m"))
    meta = json.loads((SMALL / "FIXTURE.json").read_text())
    golden = np.load(SMALL / "golden.npz")["tokens"]
    np.testing.assert_array_equal(
        again.generate_codes(meta["prompt"], temperature=0.0, seed=meta["seed"]), golden)
    wav = _wave(3, 4096)
    write_wav(tmp_path / "p.wav", wav)
    np.testing.assert_array_equal(again.load_audio(tmp_path / "p.wav"),
                                  jd.load_audio(tmp_path / "p.wav"))


@pytest.mark.parametrize("mode,extra", [("lora", []), ("none", ["--qat", "int8"])])
def test_finetune_cli_end_to_end(codecs, dataset_dir, tmp_path, mode, extra):
    """``finetune`` on the CPU: dataset → DAC encode → Trainer → adapter +
    pytorch_model.bin + codec files; both packages load the result."""
    from dia_tts_prune_tpu_torch.finetune import main

    out = tmp_path / "out"
    rc = main(["--model-path", str(SMALL), "--dataset-dir", str(dataset_dir), "--output-dir",
               str(out), "--device", "cpu", "--compute-dtype", "float32", "--adapter-mode", mode,
               "--epochs", "2", "--logging-steps", "1", "--save-steps", "2",
               "--learning-rate", "1e-3", *extra])
    assert rc == 0
    names = {p.name for p in out.iterdir()}
    assert {"config.json", "pytorch_model.bin", "dac.safetensors", "dac_config.json",
            "training_args.json", "checkpoints"} <= names
    assert ("adapter" in names) == (mode == "lora")
    tuned = Dia.from_pretrained(out, device="cpu")
    base = Dia.from_pretrained(SMALL, device="cpu")
    q = lambda d: d.params["decoder"]["layers"]["self_attention"]["q_proj"]["kernel"]  # noqa: E731
    assert float((q(tuned) - q(base)).abs().max()) > 0
    assert tuned.generate_codes("[S1] Hi.", max_tokens=20, temperature=0.0).shape[1] == 9
    jd = JaxDia.from_pretrained(str(out))
    np.testing.assert_array_equal(
        np.asarray(jd.params["decoder"]["layers"]["self_attention"]["q_proj"]["kernel"]),
        q(tuned).numpy())
    if mode == "lora":  # the saved adapter on the base weights is the saved model
        base.load_adapter_weights(out / "adapter")
        np.testing.assert_allclose(q(base).numpy(), q(tuned).numpy(), rtol=0, atol=1e-6)
        # resume from the periodic checkpoint
        rc = main(["--model-path", str(SMALL), "--dataset-dir", str(dataset_dir), "--output-dir",
                   str(tmp_path / "out2"), "--device", "cpu", "--compute-dtype", "float32",
                   "--adapter-mode", "lora", "--resume-from", str(out / "checkpoints")])
        assert rc == 0
