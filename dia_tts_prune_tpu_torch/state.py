"""Inference-state builders: positions, padding masks, the audio-prompt
template (counterpart of ``dia_tts_prune_tpu/state.py``; reference:
dia/state.py:42-208)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import DiaConfig
from .ops.delay import apply_audio_delay_np
from .ops.masks import create_attn_mask


class EncoderState(NamedTuple):
    """Positions and padding for the encoder pass (reference: dia/state.py:42-69).
    The padding mask doubles as the flash kernel's segment ids."""

    positions: torch.Tensor  # int64 [B, T]
    padding_mask: torch.Tensor  # bool [B, T]


def new_encoder_state(config: DiaConfig, src_ids: torch.Tensor) -> EncoderState:
    B, T = src_ids.shape
    positions = torch.arange(T, device=src_ids.device)[None, :].expand(B, T)
    return EncoderState(positions=positions, padding_mask=src_ids != config.data.text_pad_value)


def cross_attention_mask(enc_padding_mask: torch.Tensor) -> torch.Tensor:
    """Decoder→encoder mask for single-query decode: bool [B, 1, 1, S].

    Decoder queries are always non-padding (reference: dia/state.py:138-140),
    so the mask reduces to the encoder key padding — the CFG unconditional
    row is fully masked and its cross-attention output is exactly zero."""
    B = enc_padding_mask.shape[0]
    q_mask = torch.ones(B, 1, dtype=torch.bool, device=enc_padding_mask.device)
    return create_attn_mask(q_mask, enc_padding_mask, is_causal=False)


def prepare_audio_prompt(config: DiaConfig,
                         audio_codes: np.ndarray | None) -> tuple[np.ndarray, int]:
    """BOS row + prompt codes + max-delay PAD rows, then the delay transform
    (reference: dia/model.py:291-353).  Host-side; returns (delayed
    [P + max_delay, C] int32, prefill_step = 1 + len(codes)).  Takes
    pre-encoded [T, C] (or [1, T, C]) codes."""
    d = config.data
    C = d.channels
    parts = [np.full((1, C), d.audio_bos_value, dtype=np.int32)]
    prefill_step = 1
    if audio_codes is not None:
        codes = np.asarray(audio_codes, dtype=np.int32)
        if codes.ndim == 3 and codes.shape[0] == 1:
            codes = codes[0]
        if codes.ndim != 2:
            raise ValueError(f"Unexpected audio prompt shape: {codes.shape}")
        prefill_step += codes.shape[0]
        parts.append(codes)
    parts.append(np.full((d.max_delay, C), d.audio_pad_value, dtype=np.int32))
    delayed = apply_audio_delay_np(
        np.concatenate(parts, axis=0)[None], d.audio_pad_value, d.audio_bos_value,
        tuple(d.delay_pattern),
    )[0]
    return delayed, prefill_step
