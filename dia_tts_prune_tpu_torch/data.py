"""LJSpeech-format dataset pipeline for fine-tuning.

Reference: finetune.py:36-228 (metadata.csv ``name|text`` + wavs/, per-item
DAC encode, delayed-input/target construction, failed-item skipping;
counterpart of ``dia_tts_prune_tpu/data.py``).  The DAC encode runs through
the port's codec on the codec weights' device, while WAV reading and batch
assembly stay on the host; failed items are skipped with a warning like the
reference's ``safe_collate_fn``.
"""

from __future__ import annotations

import random
from dataclasses import dataclass
from pathlib import Path
from typing import Iterator

import numpy as np
import torch

from .config import DiaConfig
from .models.dac import DACConfig, encode_audio, pad_audio
from .tokenizer import encode_text
from .train import build_train_batch
from .utils.audio_io import load_audio_mono


@dataclass
class DatasetItem:
    audio_path: Path
    text: str


def load_metadata(metadata_path: str | Path, audio_dir: str | Path) -> list[DatasetItem]:
    """Parse LJSpeech ``name|text`` metadata, keeping only existing files
    (reference: finetune.py:59-71)."""
    audio_dir = Path(audio_dir)
    items = []
    with open(metadata_path, "r", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|", 1)
            if len(parts) != 2:
                continue
            wav_name, text = parts
            path = audio_dir / wav_name
            if path.exists():
                items.append(DatasetItem(audio_path=path, text=text))
    return items


class FineTuneDataset:
    """Text + DAC-encoded audio pairs → ready train batches."""

    def __init__(
        self,
        metadata_path: str | Path,
        audio_dir: str | Path,
        config: DiaConfig,
        dac_params,
        dac_config: DACConfig,
        loss_mode: str = "delayed",
    ):
        self.items = load_metadata(metadata_path, audio_dir)
        if not self.items:
            raise ValueError(f"No valid items found in {metadata_path}")
        self.config = config
        self.dac_params = dac_params
        self.dac_config = dac_config
        self.loss_mode = loss_mode
        self._code_cache: dict[Path, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.items)

    def encode_item_audio(self, item: DatasetItem) -> np.ndarray | None:
        """WAV → DAC codes [T, C]; None on failure (skip semantics,
        reference: finetune.py:95-111, 150-153)."""
        if item.audio_path in self._code_cache:
            return self._code_cache[item.audio_path]
        try:
            mono = load_audio_mono(item.audio_path, self.dac_config.sample_rate)
            mono = pad_audio(mono[None, :], self.dac_config.hop_length)
            device = self.dac_params["encoder"]["stem"]["weight"].device
            codes = encode_audio(self.dac_params, self.dac_config,
                                 torch.from_numpy(mono).to(device))[0].cpu().numpy()
        except Exception as e:  # noqa: BLE001 — skip-and-warn by design
            print(f"Warning: failed to encode {item.audio_path}: {e}")
            return None
        self._code_cache[item.audio_path] = codes
        return codes

    def batches(
        self, batch_size: int, shuffle: bool = True, seed: int = 0, drop_last: bool = False
    ) -> Iterator[dict[str, np.ndarray]]:
        """Yield train batches; failed items are dropped (safe_collate_fn
        semantics, reference: finetune.py:208-228)."""
        order = list(range(len(self.items)))
        if shuffle:
            random.Random(seed).shuffle(order)
        d = self.config.data
        buf_text: list[np.ndarray] = []
        buf_audio: list[np.ndarray] = []
        for idx in order:
            item = self.items[idx]
            codes = self.encode_item_audio(item)
            if codes is None:
                continue
            buf_text.append(encode_text(item.text, d.text_length, d.text_pad_value))
            buf_audio.append(codes)
            if len(buf_text) == batch_size:
                yield build_train_batch(
                    self.config, np.stack(buf_text), buf_audio, self.loss_mode
                )
                buf_text, buf_audio = [], []
        if buf_text and not drop_last:
            yield build_train_batch(self.config, np.stack(buf_text), buf_audio, self.loss_mode)
