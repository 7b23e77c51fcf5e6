"""The port's main path end to end on the CPU, and the rules it keeps.

* Greedy tokens of both trained fixtures equal ``golden.npz["tokens"]``
  (the gates of tests/test_trained_fixture.py and tests/test_trained_deep.py).
* The ``trained_small`` waveform head matches ``golden["wav_head"]`` at
  atol 1e-4, not the JAX test's 1e-5.  Measured cause: with identical codes
  the port's DAC head differs from the golden by 2.7e-5, and that difference
  is fp32 rounding in the convolutions — a k7 dilated conv at these widths
  differs from a float64 result by ~3e-5 in XLA's CPU conv and in PyTorch's
  alike, each with its own summation order.
* No module of the port imports ``jax`` or ``dia_tts_prune_tpu``; entry
  points refuse CUDA where there is none instead of moving to the CPU.
"""

import ast
import json
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu_torch import Dia

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
REPO = Path(__file__).parents[1]


def _load(name):
    d = FIXTURES / name
    return (Dia.from_pretrained(d, device="cpu"), np.load(d / "golden.npz"),
            json.loads((d / "FIXTURE.json").read_text()))


@pytest.mark.parametrize("name", ["trained_small", "trained_deep"])
def test_greedy_tokens_match_golden(name):
    dia, golden, meta = _load(name)
    codes = dia.generate_codes(meta["prompt"], temperature=0.0, seed=meta["seed"])
    np.testing.assert_array_equal(codes, golden["tokens"])


def test_waveform_matches_golden_head():
    dia, golden, meta = _load("trained_small")
    wav = dia.generate(meta["prompt"], temperature=0.0, seed=meta["seed"])
    assert wav.shape[0] == int(golden["wav_sha_len"])
    np.testing.assert_allclose(wav[:256], golden["wav_head"], rtol=0, atol=1e-4)


def test_dac_decode_matches_jax():
    """The port's chunked codec decode against the JAX package's on the
    fixture's codec weights and golden tokens (same 1e-4 and cause)."""
    from safetensors.numpy import load_file

    from dia_tts_prune_tpu.api import Dia as JaxDia
    from dia_tts_prune_tpu.api import _unflatten_tree, load_dac_config

    d = FIXTURES / "trained_small"
    jd = JaxDia.__new__(JaxDia)
    jd.dac_config = load_dac_config(d / "dac_config.json")
    jd.dac_params = _unflatten_tree(load_file(str(d / "dac.safetensors")))
    codes = np.load(d / "golden.npz")["tokens"]
    codes = np.concatenate([codes, codes[::-1]])  # 478 frames: the chunked path
    ref = JaxDia._decode_waveform(jd, codes)
    dia, _, _ = _load("trained_small")
    out = dia._decode_waveform(codes)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-4)


def test_cli_writes_wav(tmp_path):
    from dia_tts_prune_tpu_torch.cli import main

    out = tmp_path / "x.wav"
    rc = main(["[S1] Hello.", "--output", str(out), "--model-path", str(FIXTURES / "trained_small"),
               "--device", "cpu", "--compute-dtype", "float32", "--temperature", "0",
               "--max-tokens", "64"])
    assert rc == 0
    with wave.open(str(out)) as f:
        assert f.getframerate() == 44100 and f.getsampwidth() == 2 and f.getnframes() > 0


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA; the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Dia.from_pretrained(FIXTURES / "trained_small")
    from dia_tts_prune_tpu_torch.api import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = """
import importlib, pkgutil, sys
import torch
torch.set_num_threads(1)
import dia_tts_prune_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
for name in ("ops.quant", "ops.kernels.int8_matmul", "ops.kernels.int4_gemv", "train", "lora",
             "finetune", "data", "utils.audio_io", "utils.prefetch", "checkpoint", "prune",
             "offline_prune", "ops.sparse", "ops.kernels.sparse_matmul", "utils.flac", "datagen",
             "cli", "native"):
    assert pkg.__name__ + "." + name in sys.modules, name
from dia_tts_prune_tpu_torch.utils.audio_io import read_audio
mp3, sr = read_audio("tests/fixtures/torch_mp3_prompt/prompt.mp3")  # builds and loads mp3dec
assert sr == 44100 and mp3.shape == (1, 88200)
dia = pkg.Dia.from_pretrained("tests/fixtures/trained_small", device="cpu")
from dia_tts_prune_tpu_torch.train import TrainConfig, Trainer, build_train_batch
import numpy as np
batch = build_train_batch(dia.config, np.ones((1, dia.config.data.text_length), np.int32),
                          [np.zeros((12, 9), np.int32)])
for tc in (TrainConfig(adapter_mode="lora"), TrainConfig(qat_mode="int8")):
    assert np.isfinite(Trainer(dia.params, dia.config, tc, 2).step(batch)["loss"])
dia.quantize_int8()
assert dia.generate_codes("[S1] Hi.", max_tokens=20, temperature=0.0).shape[1] == 9
sparse = pkg.Dia.from_pretrained("tests/fixtures/trained_small", device="cpu")
assert min(sparse.prune_block_sparse(0.5, (32, 64)).values()) < 1.0
assert all(c.shape[1] == 9 for c in sparse.generator.generate_tokens_batch(
    ["[S1] Hi.", "[S2] Yo."], max_tokens=20, temperature=0.0))
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "dia_tts_prune_tpu"))
print(bad)
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True).stdout
    assert out.strip() == "[]", out

    for path in [REPO / "chip_smoke.py", *(REPO / "dia_tts_prune_tpu_torch").rglob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "dia_tts_prune_tpu"), (path, n)
