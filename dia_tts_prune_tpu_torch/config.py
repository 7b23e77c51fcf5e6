"""Configuration system for the PyTorch/CUDA Dia port.

The port's own copy of ``dia_tts_prune_tpu/config.py`` (the port imports
nothing of the JAX package): pydantic-validated, frozen configuration with a
JSON round-trip that is format-compatible with the reference ``config.json``
(reference: dia/config.py:24-207) — data constants (delay pattern, special
token ids, 128-aligned sequence lengths), encoder/decoder hyperparameters,
and master-config save/load.

``text_length`` / ``audio_length`` stay 128-aligned sequence bounds: the
generator buckets text keys and cache lengths inside them.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Annotated

from pydantic import BaseModel, BeforeValidator, Field, ValidationError


def _round_up_128(x: int) -> int:
    return (int(x) + 127) // 128 * 128


class DataConfig(BaseModel, frozen=True):
    """Data-plane constants: sequence bounds, channel count, special tokens,
    and the per-codebook delay pattern (reference: dia/config.py:24-60)."""

    text_length: Annotated[int, BeforeValidator(_round_up_128)] = Field(gt=0, multiple_of=128)
    audio_length: Annotated[int, BeforeValidator(_round_up_128)] = Field(gt=0, multiple_of=128)
    channels: int = Field(default=9, gt=0)
    text_pad_value: int = Field(default=0)
    audio_eos_value: int = Field(default=1024)
    audio_pad_value: int = Field(default=1025)
    audio_bos_value: int = Field(default=1026)
    delay_pattern: tuple[Annotated[int, Field(ge=0)], ...] = Field(
        default=(0, 8, 9, 10, 11, 12, 13, 14, 15)
    )

    @property
    def max_delay(self) -> int:
        return max(self.delay_pattern) if self.delay_pattern else 0

    def __hash__(self) -> int:
        return hash(
            (
                self.text_length,
                self.audio_length,
                self.channels,
                self.text_pad_value,
                self.audio_pad_value,
                self.audio_bos_value,
                self.audio_eos_value,
                tuple(self.delay_pattern),
            )
        )


class EncoderConfig(BaseModel, frozen=True):
    """Encoder architecture (reference: dia/config.py:63-78). MHA: n_head == kv heads."""

    n_layer: int = Field(gt=0)
    n_embd: int = Field(gt=0)
    n_hidden: int = Field(gt=0)
    n_head: int = Field(gt=0)
    head_dim: int = Field(gt=0)


class DecoderConfig(BaseModel, frozen=True):
    """Decoder architecture (reference: dia/config.py:81-102).

    Self-attention is GQA (``gqa_query_heads`` queries over ``kv_heads`` KV
    heads); cross-attention is MHA over the encoder output.
    """

    n_layer: int = Field(gt=0)
    n_embd: int = Field(gt=0)
    n_hidden: int = Field(gt=0)
    gqa_query_heads: int = Field(gt=0)
    kv_heads: int = Field(gt=0)
    gqa_head_dim: int = Field(gt=0)
    cross_query_heads: int = Field(gt=0)
    cross_head_dim: int = Field(gt=0)


class ModelConfig(BaseModel, frozen=True):
    """Model-wide hyperparameters (reference: dia/config.py:105-128)."""

    encoder: EncoderConfig
    decoder: DecoderConfig
    src_vocab_size: int = Field(default=128, gt=0)
    tgt_vocab_size: int = Field(default=1028, gt=0)
    dropout: float = Field(default=0.0, ge=0.0, lt=1.0)
    normalization_layer_epsilon: float = Field(default=1.0e-5, ge=0.0)
    weight_dtype: str = Field(default="float32")
    rope_min_timescale: int = Field(default=1)
    rope_max_timescale: int = Field(default=10_000)


class DiaConfig(BaseModel, frozen=True):
    """Master configuration (reference: dia/config.py:134-207).

    JSON round-trip is format-compatible with the reference's ``config.json``
    so checkpoints published for the torch implementation load unchanged.
    """

    version: str = Field(default="1.0")
    model: ModelConfig
    data: DataConfig
    model_type: str = Field(default="dia")
    architectures: tuple[str, ...] = Field(default=("DiaModel",))

    def __hash__(self) -> int:
        return hash(self.model_dump_json())

    def save(self, path: str | Path) -> None:
        """Save to JSON, forcing a .json suffix (reference: dia/config.py:156-172)."""
        save_path = Path(path)
        if save_path.suffix != ".json":
            save_path = save_path.with_suffix(".json")
        os.makedirs(save_path.parent, exist_ok=True)
        save_path.write_text(self.model_dump_json(indent=2), encoding="utf-8")

    @classmethod
    def load(cls, path: str | Path) -> "DiaConfig | None":
        """Load + validate from JSON; None when missing (reference: dia/config.py:174-207)."""
        load_path = Path(path)
        if not load_path.exists() or not load_path.is_file():
            return None
        try:
            return cls.model_validate_json(load_path.read_text(encoding="utf-8"))
        except ValidationError:
            raise


def dia_1_6b_config(
    weight_dtype: str = "float32",
    text_length: int = 1024,
    audio_length: int = 3072,
) -> DiaConfig:
    """Hyperparameters of the published Dia-1.6B checkpoint.

    The reference repo ships no defaults (SURVEY.md Q10); these match the
    config.json published with nari-labs/Dia-1.6B.
    """
    return DiaConfig(
        model=ModelConfig(
            encoder=EncoderConfig(n_layer=12, n_embd=1024, n_hidden=4096, n_head=16, head_dim=128),
            decoder=DecoderConfig(
                n_layer=18,
                n_embd=2048,
                n_hidden=8192,
                gqa_query_heads=16,
                kv_heads=4,
                gqa_head_dim=128,
                cross_query_heads=16,
                cross_head_dim=128,
            ),
            src_vocab_size=256,
            tgt_vocab_size=1028,
            weight_dtype=weight_dtype,
        ),
        data=DataConfig(text_length=text_length, audio_length=audio_length),
    )


def tiny_test_config(
    text_length: int = 128,
    audio_length: int = 128,
    weight_dtype: str = "float32",
) -> DiaConfig:
    """A tiny config for unit/integration tests (CPU-friendly)."""
    return DiaConfig(
        model=ModelConfig(
            encoder=EncoderConfig(n_layer=2, n_embd=64, n_hidden=128, n_head=4, head_dim=16),
            decoder=DecoderConfig(
                n_layer=2,
                n_embd=64,
                n_hidden=128,
                gqa_query_heads=4,
                kv_heads=2,
                gqa_head_dim=16,
                cross_query_heads=4,
                cross_head_dim=16,
            ),
            src_vocab_size=256,
            tgt_vocab_size=1028,
            weight_dtype=weight_dtype,
        ),
        data=DataConfig(text_length=text_length, audio_length=audio_length),
    )
