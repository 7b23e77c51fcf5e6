"""Host-side audio reading and resampling (counterpart of the reading half of
``dia_tts_prune_tpu/utils/audio_io.py``).

The reference uses torchaudio + soundfile (dia/model.py:546-595).  Here WAV
files are read with the stdlib ``wave`` module (8/16/24/32-bit PCM) and
resampled with scipy's polyphase filter — host work, no kernel.  The JAX
package's FLAC/mp3/ogg readers and its native helpers are not ported: any
other format raises, naming WAV.  (Writing: ``api.write_wav``.)
"""

from __future__ import annotations

import math
import wave
from pathlib import Path

import numpy as np

DEFAULT_SAMPLE_RATE = 44100


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file → (float32 samples [C, T] in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as f:
        n_channels = f.getnchannels()
        width = f.getsampwidth()
        rate = f.getframerate()
        raw = f.readframes(f.getnframes())

    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        a = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        val = (a[:, 0].astype(np.int32) | (a[:, 1].astype(np.int32) << 8)
               | (a[:, 2].astype(np.int32) << 16))
        val = np.where(val >= 1 << 23, val - (1 << 24), val)
        data = val.astype(np.float32) / float(1 << 23)
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    return data.reshape(-1, n_channels).T, rate  # [C, T]


def read_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Read an audio file → (float32 [C, T] in [-1, 1], sample_rate).  WAV only."""
    p = Path(path)
    with p.open("rb") as f:
        head = f.read(4)
    if head != b"RIFF":
        raise ValueError(f"Unsupported audio format for {p}: this package reads WAV only; "
                         "convert the file to .wav")
    return read_wav(p)


def to_mono(audio_CxT: np.ndarray) -> np.ndarray:
    """Channel-mean downmix (reference: dia/model.py:553-555)."""
    if audio_CxT.ndim == 1:
        return audio_CxT
    return audio_CxT.mean(axis=0)


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (replaces torchaudio.functional.resample,
    dia/model.py:557-559)."""
    if orig_sr == target_sr:
        return audio
    from scipy.signal import resample_poly

    g = math.gcd(int(orig_sr), int(target_sr))
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def load_audio_mono(path: str | Path, target_sr: int = DEFAULT_SAMPLE_RATE) -> np.ndarray:
    """Read → mono → resample to target (the reference's load_audio front half,
    dia/model.py:546-562)."""
    data, sr = read_audio(path)
    return resample(to_mono(data), sr, target_sr)
