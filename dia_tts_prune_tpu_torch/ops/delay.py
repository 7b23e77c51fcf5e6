"""Delay-pattern codec transforms (counterpart of ``dia_tts_prune_tpu/ops/delay.py``).

The Dia decoder emits 9 codebook streams staggered in time by a per-channel
delay (reference semantics: dia/audio.py:6-163).

Forward  (apply): ``out[t, c] = in[t - delay[c], c]`` with BOS where the
source index is negative and PAD where it runs past ``T``.
Inverse (revert): ``out[t, c] = in[min(t + delay[c], T_arr-1), c]`` with PAD
where the clamped index reaches ``T`` (the reference clamps before the PAD
comparison, so the PAD mask is active only when the caller passes a ``T``
smaller than the array length).

Tensor forms for device-side use, numpy forms for the host (prompt templates
and the final revert are tiny and built once per request).
"""

from __future__ import annotations

import numpy as np
import torch


def apply_audio_delay(audio_BxTxC: torch.Tensor, pad_value: int, bos_value: int,
                      delay_pattern) -> torch.Tensor:
    """Apply the per-channel delay pattern (reference: dia/audio.py:6-86)."""
    B, T, C = audio_BxTxC.shape
    delay = torch.as_tensor(delay_pattern, dtype=torch.int64, device=audio_BxTxC.device)
    t_idx = torch.arange(T, device=audio_BxTxC.device)[None, :, None] - delay[None, None, :]
    gathered = torch.gather(audio_BxTxC, 1, t_idx.clamp(0, T - 1).expand(B, T, C))
    out = torch.where(t_idx >= T, torch.full_like(gathered, pad_value), gathered)
    return torch.where(t_idx < 0, torch.full_like(gathered, bos_value), out)


def revert_audio_delay(audio_BxTxC: torch.Tensor, pad_value: int, delay_pattern,
                       T: int | None = None) -> torch.Tensor:
    """Invert the delay pattern (reference: dia/audio.py:88-163)."""
    B, T_arr, C = audio_BxTxC.shape
    T = T_arr if T is None else T
    delay = torch.as_tensor(delay_pattern, dtype=torch.int64, device=audio_BxTxC.device)
    t_idx = (torch.arange(T_arr, device=audio_BxTxC.device)[None, :, None]
             + delay[None, None, :]).clamp_max(T_arr - 1)
    gathered = torch.gather(audio_BxTxC, 1, t_idx.expand(B, T_arr, C))
    return torch.where(t_idx >= T, torch.full_like(gathered, pad_value), gathered)


def apply_audio_delay_np(audio_BxTxC, pad_value: int, bos_value: int, delay_pattern) -> np.ndarray:
    """Host (numpy) apply — same semantics as ``apply_audio_delay``."""
    audio = np.asarray(audio_BxTxC)
    B, T, C = audio.shape
    delay = np.asarray(delay_pattern, dtype=np.int32)
    t_idx = np.arange(T, dtype=np.int32)[None, :, None] - delay[None, None, :]
    src = np.broadcast_to(np.clip(t_idx, 0, T - 1), (B, T, C))
    gathered = np.take_along_axis(audio, src, axis=1)
    bos = np.asarray(bos_value, audio.dtype)
    pad = np.asarray(pad_value, audio.dtype)
    return np.where(t_idx < 0, bos, np.where(t_idx >= T, pad, gathered))


def revert_audio_delay_np(audio_BxTxC, pad_value: int, delay_pattern,
                          T: int | None = None) -> np.ndarray:
    """Host (numpy) revert — same semantics as ``revert_audio_delay``."""
    audio = np.asarray(audio_BxTxC)
    B, T_arr, C = audio.shape
    T = T_arr if T is None else T
    delay = np.asarray(delay_pattern, dtype=np.int32)
    t_idx = np.minimum(np.arange(T_arr, dtype=np.int32)[None, :, None] + delay[None, None, :],
                       T_arr - 1)
    gathered = np.take_along_axis(audio, np.broadcast_to(t_idx, (B, T_arr, C)), axis=1)
    return np.where(t_idx >= T, np.asarray(pad_value, audio.dtype), gathered)
