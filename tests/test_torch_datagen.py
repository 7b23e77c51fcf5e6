"""The port's ``datagen`` (synthetic fine-tuning data from Harvard sentences)
against the JAX package's, on the CPU: the prompt rules of
tests/test_datagen.py, prompts equal to the JAX function's for the same seed
and bounds (both shuffle with ``random.Random(seed)``), the same
``metadata.csv`` and file names from ``generate_dataset`` with one stub model,
the CLI's checks, and a tiny-model run whose WAVs the port's dataset reads
and encodes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import datagen as jdatagen
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import api as tapi
from dia_tts_prune_tpu_torch import datagen
from dia_tts_prune_tpu_torch.data import FineTuneDataset
from dia_tts_prune_tpu_torch.datagen import HARVARD_SENTENCES, format_dialogue_prompts
from dia_tts_prune_tpu_torch.utils.audio_io import write_wav

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"


def test_prompts_alternate_speakers():
    prompts = format_dialogue_prompts(HARVARD_SENTENCES, max_len_sec=15, min_len_sec=5, seed=0)
    assert prompts
    for p in prompts:
        tags = [t for t in p.split() if t in ("[S1]", "[S2]")]
        body_tags = tags[:-1]  # the last tag is the trailing-speaker marker
        assert body_tags[0] == "[S1]"
        for a, b in zip(body_tags, body_tags[1:]):
            assert a != b, p


def test_trailing_tag_is_previous_speaker():
    """The reference appends the tag of the last sentence's speaker
    (generate_finetune_data.py:74-76)."""
    for p in format_dialogue_prompts(HARVARD_SENTENCES, max_len_sec=12, min_len_sec=4, seed=1):
        tags = [t for t in p.split() if t in ("[S1]", "[S2]")]
        assert tags[-1] == tags[-2], p


def test_duration_bounds_respected():
    max_len = 10.0
    for p in format_dialogue_prompts(HARVARD_SENTENCES, max_len_sec=max_len, min_len_sec=3,
                                     seed=2):
        words = [w for w in p.split() if w not in ("[S1]", "[S2]")]
        assert len(words) / 2.5 < max_len + 8, p  # at most one sentence over


def test_seeded_prompts_reproducible():
    a = format_dialogue_prompts(HARVARD_SENTENCES, seed=7)
    assert a == format_dialogue_prompts(HARVARD_SENTENCES, seed=7)
    assert a != format_dialogue_prompts(HARVARD_SENTENCES, seed=8)


def test_min_length_filter():
    assert format_dialogue_prompts(HARVARD_SENTENCES[:2], max_len_sec=100, min_len_sec=1000,
                                   seed=0) == []


@pytest.mark.parametrize("seed,max_len,min_len", [
    (0, 15, 5), (1, 12, 4), (42, 18, 6), (7, 10, 3), (None, 1000, 0), (3, 6, 1)])
def test_prompts_equal_jax(seed, max_len, min_len):
    assert HARVARD_SENTENCES == jdatagen.HARVARD_SENTENCES
    kw = dict(max_len_sec=max_len, min_len_sec=min_len, seed=seed)
    if seed is None:  # an unseeded shuffle: only the sentence set is comparable
        got = format_dialogue_prompts(HARVARD_SENTENCES, **kw)
        assert len(got) == 1 and sorted(got[0].split()) == sorted(
            jdatagen.format_dialogue_prompts(HARVARD_SENTENCES, **kw)[0].split())
        return
    assert format_dialogue_prompts(HARVARD_SENTENCES, **kw) == \
        jdatagen.format_dialogue_prompts(HARVARD_SENTENCES, **kw)


class StubDia:
    """A model that answers every prompt with a seeded tone, returns nothing
    for one sample and fails on another (the per-sample skip rules)."""

    def __init__(self):
        self.calls = []

    def generate(self, prompt, seed=None, audio_prompt=None, audio_prompt_text=None, **kw):
        self.calls.append((prompt, seed, audio_prompt, audio_prompt_text, kw))
        if seed == 44:
            return None
        if seed == 45:
            raise RuntimeError("planted failure")
        rng = np.random.default_rng(seed)
        return (0.3 * rng.normal(size=400 + seed)).astype(np.float32)

    def save_audio(self, path, audio, sample_rate):
        write_wav(path, audio, sample_rate)


def test_generate_dataset_equals_jax_with_one_stub(tmp_path):
    runs = {}
    for name, fn in (("port", datagen.generate_dataset), ("jax", jdatagen.generate_dataset)):
        stub = StubDia()
        rows = fn(stub, tmp_path / name, num_samples=7, seed=42, max_len_sec=8, min_len_sec=2,
                  voice_prompt_audio="v.wav", voice_prompt_text="[S1] Hi.", max_tokens=99)
        runs[name] = (rows, stub.calls)
    (rows, calls), (jrows, jcalls) = runs["port"], runs["jax"]
    assert rows == jrows and calls == jcalls
    assert [r[0] for r in rows] == [f"sample_{i:05d}.wav" for i in (0, 1, 4, 5, 6)]
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    assert (port / "metadata.csv").read_text() == (jax_ / "metadata.csv").read_text()
    assert sorted(p.name for p in (port / "wavs").iterdir()) == \
        sorted(p.name for p in (jax_ / "wavs").iterdir())
    for p in (port / "wavs").iterdir():
        assert p.read_bytes() == (jax_ / "wavs" / p.name).read_bytes()


def test_main_checks_the_prompt_pair_and_passes_the_codec(monkeypatch, tmp_path):
    with pytest.raises(SystemExit):
        datagen.main(["--output-dir", str(tmp_path), "--voice-prompt-audio", "v.wav"])
    seen = {}

    def fake(model_path, **kw):
        seen.update(kw, model_path=model_path)
        return StubDia()

    monkeypatch.setattr(tapi.Dia, "from_pretrained", staticmethod(fake))
    datagen.main(["--output-dir", str(tmp_path / "out"), "--model-name", "M",
                  "--dac-checkpoint", "codec.pth", "--num-samples", "2", "--device", "cpu",
                  "--compute-dtype", "float32"])
    assert seen == {"model_path": "M", "compute_dtype": "float32",
                    "dac_checkpoint": "codec.pth", "device": "cpu"}
    assert (tmp_path / "out" / "metadata.csv").read_text().count("\n") == 2


def test_tiny_model_dataset_reads_back(tmp_path):
    """``generate_dataset`` on the trained fixture writes WAVs that
    ``data.FineTuneDataset`` reads and DAC-encodes into train batches."""
    dia = Dia.from_pretrained(SMALL, device="cpu")
    rows = datagen.generate_dataset(dia, tmp_path, num_samples=2, max_tokens=40,
                                    temperature=0.0)
    assert len(rows) == 2 and len(list((tmp_path / "wavs").iterdir())) == 2
    ds = FineTuneDataset(tmp_path / "metadata.csv", tmp_path / "wavs", dia.config,
                         dia.dac_params, dia.dac_config)
    assert [it.text for it in ds.items] == [text for _, text in rows]
    for item in ds.items:
        codes = ds.encode_item_audio(item)
        assert codes is not None and codes.ndim == 2 and codes.shape[1] == 9
    batches = list(ds.batches(batch_size=2, shuffle=False))
    assert len(batches) == 1
