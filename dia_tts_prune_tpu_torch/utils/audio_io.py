"""Host-side audio I/O (counterpart of ``dia_tts_prune_tpu/utils/audio_io.py``).

The reference uses torchaudio + soundfile (dia/model.py:546-595).  Here WAV
files are read and written with the stdlib ``wave`` module (8/16/24/32-bit
PCM in, 16-bit PCM out), FLAC with the in-repo codec (``utils/flac.py``), mp3
with the in-repo decoder (``native/mp3dec.cpp``), and ogg, m4a, aac, opus
and the like, in and out, through the shim over the system FFmpeg libraries
(``native/audiodec.cpp``), where they exist.  Audio is resampled with
scipy's polyphase filter and sped up or slowed down by linear interpolation
(``speed_change``) — host work, no kernel.  The JAX package's optional
``soundfile`` and ``ffmpeg``-binary readers are not ported.
"""

from __future__ import annotations

import math
import wave
from pathlib import Path

import numpy as np

DEFAULT_SAMPLE_RATE = 44100


def f32_to_pcm16(audio: np.ndarray) -> np.ndarray:
    """Float audio → int16 codes, as ``native.f32_to_pcm16`` (and the JAX
    ``write_wav`` with its native library) computes them, bit for bit:
    clipped to [-1, 1], ``v * 32767`` in float32, then 0.5 added (or
    subtracted, below zero) in float32 and truncated — halves round away
    from zero."""
    v = np.clip(np.asarray(audio, np.float32), np.float32(-1.0), np.float32(1.0))
    scaled = v * np.float32(32767.0)
    half = np.where(scaled >= 0, np.float32(0.5), np.float32(-0.5)).astype(np.float32)
    return np.trunc(scaled + half).astype(np.int16)


def write_wav(path: str | Path, audio: np.ndarray,
              sample_rate: int = DEFAULT_SAMPLE_RATE) -> None:
    """Mono or [C, T] float audio → 16-bit PCM WAV, clipped to [-1, 1]
    (reference save path semantics: dia/model.py:578-595) and rounded as
    ``f32_to_pcm16``; integer samples are scaled by their type's maximum
    first."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    if not np.issubdtype(audio.dtype, np.floating):
        audio = audio.astype(np.float32) / np.iinfo(audio.dtype).max
    pcm = f32_to_pcm16(audio.T).astype("<i2")  # [T, C]
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(pcm.shape[1])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


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


def looks_like_mp3(head: bytes, suffix: str) -> bool:
    """An ``ID3`` tag, a Layer III frame header (sync ``0xFF`` ``0xE?``, any
    MPEG version, layer bits ``01``, with or without CRC), or the ``.mp3``
    suffix."""
    frame = len(head) >= 2 and head[0] == 0xFF and (head[1] & 0xE0) == 0xE0 \
        and (head[1] >> 1) & 3 == 1
    return frame or head[:3] == b"ID3" or suffix.lower() == ".mp3"


def _read_via_mp3dec(path: Path) -> "tuple[np.ndarray, int] | None":
    """The in-repo mp3 decoder (``native/mp3dec.cpp``), for what looks like
    mp3; None for anything else and for a stream with bad frames, which goes
    on to libav for a second opinion (the JAX ``_read_via_mp3dec``)."""
    data = path.read_bytes()
    if not looks_like_mp3(data[:4], path.suffix):
        return None
    from .. import native

    got = native.decode_mp3(data)
    if got is None:
        return None
    pcm, rate, bad = got
    if bad > 0:
        return None
    return (pcm[None, :] if pcm.ndim == 1 else pcm.T), rate


def _read_via_libav(path: Path) -> "tuple[np.ndarray, int] | None":
    """The system FFmpeg libraries through ``native/audiodec.cpp``; None when
    they are missing or cannot read the file."""
    from .. import native

    got = native.decode_audio_file(path)
    if got is None:
        return None
    pcm, rate = got
    return (pcm[None, :] if pcm.ndim == 1 else pcm.T), rate


def read_audio(path: str | Path) -> tuple[np.ndarray, int]:
    """Read an audio file → (float32 [C, T] in [-1, 1], sample_rate), as the
    JAX ``read_audio`` (:153-187): ``RIFF`` is WAV, ``fLaC`` is FLAC, then the
    in-repo mp3 decoder, then libav.  Raises a ValueError naming the formats
    when no decoder can read the file."""
    p = Path(path)
    with p.open("rb") as f:
        head = f.read(4)
    if head == b"RIFF":
        return read_wav(p)
    if head == b"fLaC":
        from .flac import read_flac

        return read_flac(p)
    for reader in (_read_via_mp3dec, _read_via_libav):
        got = reader(p)
        if got is not None:
            return got
    suffix = p.suffix or "<no extension>"
    raise ValueError(
        f"Unsupported audio format {suffix!r} for {p}: WAV, FLAC and mp3 decode natively; "
        f"other formats (ogg, m4a, …) require the system FFmpeg libraries, which are not "
        f"available or cannot read this file. Convert the prompt to .wav or .flac.")


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


def speed_change(audio: np.ndarray, speed_factor: float) -> np.ndarray:
    """Linear-interpolation speed adjustment (reference: app.py:259-268):
    ``speed_factor`` clamped to [0.1, 5], the length divided by it."""
    speed_factor = max(0.1, min(speed_factor, 5.0))
    if speed_factor == 1.0 or audio.size == 0:
        return audio
    n_out = int(audio.shape[-1] / speed_factor)
    if n_out <= 0:
        return audio
    x_out = np.linspace(0, audio.shape[-1] - 1, n_out)
    x_in = np.arange(audio.shape[-1])
    return np.interp(x_out, x_in, audio).astype(np.float32)


def write_audio(path: str | Path, audio: np.ndarray,
                sample_rate: int = DEFAULT_SAMPLE_RATE) -> None:
    """Write audio by extension (the JAX ``write_audio``, :229-260): .wav
    (or none) as 16-bit PCM WAV, .flac with the in-repo codec, .mp3, .ogg,
    .opus, .m4a and .aac through the libav shim (``native.encode_audio``).
    A failed encode raises a ValueError naming the codec and rate (libopus
    refuses 44.1 kHz, for one); any other extension raises too."""
    p = Path(path)
    ext = p.suffix.lower()
    if ext in ("", ".wav"):
        write_wav(p, audio, sample_rate)
        return
    if ext == ".flac":
        from .flac import write_flac

        write_flac(p, np.asarray(audio), sample_rate)
        return
    if ext in (".mp3", ".ogg", ".opus", ".m4a", ".aac"):
        from .. import native

        a = np.asarray(audio, np.float32)
        if a.ndim == 2 and a.shape[0] in (1, 2) and a.shape[0] < a.shape[1]:
            a = a.T  # [C, T] -> [T, C]
        p.parent.mkdir(parents=True, exist_ok=True)
        if native.encode_audio(p, np.clip(a, -1.0, 1.0), sample_rate):
            return
        why = ("the shim did not build: it needs the system FFmpeg libraries"
               if native.load_audiodec() is None else "the encoder refused it")
        raise ValueError(f"{ext} export failed: the libav shim (native/audiodec.cpp) could not "
                         f"encode {ext} at {sample_rate} Hz ({why}); write {p.stem}.wav or "
                         f"{p.stem}.flac instead")
    raise ValueError(f"Unsupported audio output format {ext!r}: use .wav, .flac, .mp3, "
                     ".ogg, .opus or .m4a")
