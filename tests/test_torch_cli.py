"""The port's generation CLI (``python -m dia_tts_prune_tpu_torch.cli``) with
the JAX CLI's whole flag surface, on the CPU: the four tests of
tests/test_cli.py (generate, the pruned-checkpoint path, the missing prompt
transcript, the missing model) against a tiny local model directory with a
torch DAC checkpoint, then ``--adapter-path``, a FLAC ``--audio-prompt`` and
an mp3 ``--audio-prompt`` with an mp3 ``--output`` against the same calls
made in process, the port's output against the JAX CLI's on
``tests/fixtures/trained_small``, and ``--dac-checkpoint`` on the
``finetune`` and ``app`` CLIs.
"""

import json
import wave
from dataclasses import asdict
from pathlib import Path

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu_torch import Dia, native, tiny_test_config
from dia_tts_prune_tpu_torch import api as tapi
from dia_tts_prune_tpu_torch.checkpoint import to_torch_state_dict
from dia_tts_prune_tpu_torch.cli import main
from dia_tts_prune_tpu_torch.lora import LoraConfig, init_lora, save_adapter
from dia_tts_prune_tpu_torch.models.dac import (
    DACConfig,
    init_dac_params,
    to_dac_torch_state_dict,
)
from dia_tts_prune_tpu_torch.utils.audio_io import f32_to_pcm16, read_audio, write_audio
from dia_tts_prune_tpu_torch.utils.flac import write_flac

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"
TINY_DAC = DACConfig(encoder_dim=8, encoder_rates=(2, 4), decoder_dim=32, decoder_rates=(4, 2),
                     n_codebooks=9, codebook_size=1024, codebook_dim=4)
CPU = ["--device", "cpu", "--compute-dtype", "float32"]


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A local model directory in the reference layout (config.json +
    pytorch_model.bin) with no codec files, a torch DAC checkpoint beside it
    and the codec's config as JSON."""
    d = tmp_path_factory.mktemp("model")
    cfg = tiny_test_config()
    dia = Dia.random_init(cfg, seed=0, device="cpu")
    torch.save({k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in to_torch_state_dict(dia.params, cfg).items()},
               d / "pytorch_model.bin")
    cfg.save(d / "config.json")
    dac_sd = to_dac_torch_state_dict(init_dac_params(TINY_DAC, seed=1, device="cpu"), TINY_DAC)
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in dac_sd.items()}},
               d.parent / "dac.pth")
    (d.parent / "dac_config.json").write_text(json.dumps(asdict(TINY_DAC)))
    return d


def _codec(d):
    return ["--dac-checkpoint", str(d.parent / "dac.pth"),
            "--dac-config", str(d.parent / "dac_config.json")]


def _stored(wav, out):
    """``wav`` as the writer of ``out``'s format stores it, read back as
    floats: WAV rounds halves away from zero (``f32_to_pcm16``), FLAC to
    even (``utils/flac.py``), as in the JAX package."""
    if Path(out).suffix == ".flac":
        return np.round(np.clip(wav, -1, 1) * 32767) / 32768.0
    return f32_to_pcm16(wav) / 32768.0


def _in_process(d, text, adapter=None, **kw):
    """The CLI's call made in this process: its waveform."""
    dia = Dia.from_pretrained(d, dac_checkpoint=d.parent / "dac.pth",
                              dac_config=d.parent / "dac_config.json", device="cpu")
    if adapter is not None:
        dia.load_adapter_weights(adapter)
    return dia.generate(text, temperature=0.0, **kw)


@pytest.mark.parametrize("name", ["out.wav", "out.flac"])
def test_cli_generate(model_dir, tmp_path, name):
    out = tmp_path / name
    rc = main(["[S1] CLI end to end.", "--output", str(out), "--model-path", str(model_dir),
               *_codec(model_dir), "--temperature", "0.0", "--max-tokens", "48", "--verbose",
               *CPU])
    assert rc == 0
    got, sr = read_audio(out)
    want = _in_process(model_dir, "[S1] CLI end to end.", max_tokens=48)
    assert sr == 44100 and got.shape == (1, want.shape[0])
    np.testing.assert_array_equal(got[0], _stored(want, out))


def test_cli_pruned_checkpoint_path(model_dir, tmp_path):
    out = tmp_path / "pruned.wav"
    rc = main(["[S1] pruned path.", "--output", str(out), "--model-path", str(model_dir),
               "--config", str(model_dir / "config.json"),
               "--pruned-checkpoint", str(model_dir / "pytorch_model.bin"), *_codec(model_dir),
               "--temperature", "0.0", "--max-tokens", "40", *CPU])
    assert rc == 0 and out.exists()
    with wave.open(str(out)) as f:
        assert f.getnframes() > 0


def test_cli_requires_prompt_text(model_dir):
    with pytest.raises(SystemExit):
        main(["x", "--output", "o.wav", "--model-path", str(model_dir), "--audio-prompt", "p.wav",
              *CPU])


def test_cli_missing_model_errors(tmp_path):
    rc = main(["x", "--output", str(tmp_path / "o.wav"), "--model-path", str(tmp_path / "nope"),
               *CPU])
    assert rc == 1 and not (tmp_path / "o.wav").exists()


def test_cli_pruned_checkpoint_needs_a_config(tmp_path):
    with pytest.raises(SystemExit):
        main(["x", "--output", "o.wav", "--model-path", str(tmp_path / "hub/id"),
              "--pruned-checkpoint", "w.bin", *CPU])


def test_cli_adapter_path(model_dir, tmp_path):
    dia = Dia.from_pretrained(model_dir, device="cpu")
    adapter = init_lora(dia.params, LoraConfig(), generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(3)

    def seeded_b(tree):
        for v in tree.values():
            if "b" in v:
                v["b"] = torch.from_numpy(rng.normal(size=tuple(v["b"].shape)).astype(
                    np.float32) * 0.5)
            else:
                seeded_b(v)

    seeded_b(adapter["weights"])
    save_adapter(tmp_path / "adapter", adapter)
    out = tmp_path / "adapted.wav"
    rc = main(["[S1] With an adapter.", "--output", str(out), "--model-path", str(model_dir),
               *_codec(model_dir), "--adapter-path", str(tmp_path / "adapter"),
               "--temperature", "0.0", "--max-tokens", "40", *CPU])
    assert rc == 0
    got, _ = read_audio(out)
    want = _in_process(model_dir, "[S1] With an adapter.", adapter=tmp_path / "adapter",
                       max_tokens=40)
    plain = _in_process(model_dir, "[S1] With an adapter.", max_tokens=40)
    np.testing.assert_array_equal(got[0], _stored(want, out))
    assert want.shape != plain.shape or not np.array_equal(want, plain)


def test_cli_flac_audio_prompt(model_dir, tmp_path):
    prompt = tmp_path / "prompt.flac"
    rng = np.random.default_rng(6)  # 24 frames: well inside the tiny config's audio steps
    write_flac(prompt, (rng.normal(size=24 * TINY_DAC.hop_length) * 0.2).astype(np.float32),
               44100)
    out = tmp_path / "cloned.flac"
    rc = main(["[S2] More.", "--output", str(out), "--model-path", str(model_dir),
               *_codec(model_dir), "--audio-prompt", str(prompt),
               "--audio-prompt-text", "[S1] Hello.", "--temperature", "0.0",
               "--max-tokens", "96", *CPU])
    assert rc == 0
    got, _ = read_audio(out)
    want = _in_process(model_dir, "[S2] More.", max_tokens=96, audio_prompt=prompt,
                       audio_prompt_text="[S1] Hello.")
    np.testing.assert_array_equal(got[0], _stored(want, out))


def test_cli_mp3_audio_prompt_and_output(model_dir, tmp_path):
    """``--audio-prompt x.mp3 --output y.mp3``: exit 0, and the file reads
    back as the in-process waveform written by ``write_audio`` and read back
    (libmp3lame is deterministic)."""
    if native.load_audiodec() is None:
        pytest.skip("mp3 output needs the libav shim (the system FFmpeg libraries)")
    prompt = tmp_path / "prompt.mp3"
    rng = np.random.default_rng(7)
    assert native.encode_mp3(prompt, (rng.normal(size=24 * TINY_DAC.hop_length) * 0.2).astype(
        np.float32), 44100)
    out = tmp_path / "cloned.mp3"
    rc = main(["[S2] More.", "--output", str(out), "--model-path", str(model_dir),
               *_codec(model_dir), "--audio-prompt", str(prompt),
               "--audio-prompt-text", "[S1] Hello.", "--temperature", "0.0",
               "--max-tokens", "96", *CPU])
    assert rc == 0
    got, sr = read_audio(out)
    want = _in_process(model_dir, "[S2] More.", max_tokens=96, audio_prompt=prompt,
                       audio_prompt_text="[S1] Hello.")
    write_audio(tmp_path / "in_process.mp3", want, 44100)
    ref, rsr = read_audio(tmp_path / "in_process.mp3")
    assert sr == rsr == 44100 and got.shape == ref.shape == (1, want.shape[0])
    np.testing.assert_array_equal(got, ref)


def test_cli_output_equals_jax_cli(tmp_path):
    """Greedy on ``trained_small``: both CLIs decode the same codes (the
    golden-token gates hold in both packages), so the WAVs differ only by the
    codec's fp32 convolutions, which sum in another order in XLA's CPU conv
    and in PyTorch's (up to ~3e-5, tests/test_torch_slice.py), plus the one
    16-bit rounding that a difference at a rounding boundary can tip: 1e-4."""
    from dia_tts_prune_tpu.cli import main as jax_main

    prompt = json.loads((SMALL / "FIXTURE.json").read_text())["prompt"]
    common = ["--model-path", str(SMALL), "--temperature", "0", "--max-tokens", "64",
              "--compute-dtype", "float32", "--seed", "0"]
    assert main([prompt, "--output", str(tmp_path / "port.wav"), *common,
                 "--device", "cpu"]) == 0
    assert jax_main([prompt, "--output", str(tmp_path / "jax.wav"), *common]) == 0
    got, sr = read_audio(tmp_path / "port.wav")
    want, jsr = read_audio(tmp_path / "jax.wav")
    assert sr == jsr and got.shape == want.shape and got.shape[1] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


class _Loaded(Exception):
    """Raised by the stand-in ``from_pretrained`` once it has its arguments."""


@pytest.mark.parametrize("cli", ["finetune", "app"])
def test_cli_passes_dac_checkpoint(monkeypatch, tmp_path, cli):
    seen = {}

    def fake(model_path, **kw):
        seen.update(kw, model_path=model_path)
        raise _Loaded

    monkeypatch.setattr(tapi.Dia, "from_pretrained", staticmethod(fake))
    if cli == "finetune":
        from dia_tts_prune_tpu_torch.finetune import main as cli_main

        argv = ["--model-path", "M", "--dataset-dir", str(tmp_path / "data"),
                "--output-dir", str(tmp_path / "out")]
    else:
        from dia_tts_prune_tpu_torch.app import main as cli_main

        argv = ["--model-path", "M"]
    with pytest.raises(_Loaded):
        cli_main([*argv, "--dac-checkpoint", "codec.pth", "--device", "cpu"])
    assert seen["model_path"] == "M" and seen["dac_checkpoint"] == "codec.pth"
    assert seen["device"] == "cpu"
