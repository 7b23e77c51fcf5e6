"""Native host-side audio libraries (C++), loaded with ctypes: the port's own
copy of ``dia_tts_prune_tpu/native/``, with the same functions and return
conventions.

* ``libaudioproc`` (``audioproc.cpp``): PCM conversion, downmix, windowed-sinc
  resampling, peak/RMS metering.
* ``libmp3dec`` (``mp3dec.cpp``): the in-repo from-scratch Layer III decoder,
  every MPEG version, mono and stereo.
* ``libaudiodec`` (``audiodec.cpp``): a shim over the system FFmpeg libraries
  (libavformat, libavcodec, libavutil, libswresample) that decodes ogg, m4a,
  aac, opus, ... and encodes mp3, ogg, m4a, aac, opus.

Each library is compiled with g++ on first use into
``dia_tts_prune_tpu_torch/_build/native/`` (git-ignored), named by a hash of
its sources and flags, so an edited source rebuilds and an unchanged one is
reused.  A build holds an ``fcntl`` lock of its own and ends with
``os.replace``, so concurrent processes never load half a file.  ``mp3dec``
and ``audioproc`` need only g++: a failure to build or load them raises with
the compiler's output.  ``audiodec`` also needs the FFmpeg development
libraries and stays optional: where it cannot be built, ``load_audiodec``
returns None, ``decode_audio_file`` None and ``encode_audio`` False
(``build_all`` returns the compiler's output).  Nothing is built at import
time.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build" / "native"
# -ffp-contract=off: no fused multiply-add, so the float results are the same
# bits on every host (x86-64 g++ emits none without -mfma anyway)
COMMON_FLAGS = ("-std=c++17", "-shared", "-fPIC", "-ffp-contract=off")
# name -> (sources, the first one compiled; optimisation; link libraries)
LIBRARIES = {
    "audioproc": (("audioproc.cpp",), "-O3", ()),
    "mp3dec": (("mp3dec.cpp", "mp3_tables.h", "mp3_synth_window.h"), "-O2", ()),
    "audiodec": (("audiodec.cpp",), "-O2",
                 ("-lavformat", "-lavcodec", "-lavutil", "-lswresample")),
}
BUILD_TIMEOUT_S = 300

_lock = threading.Lock()  # guards _loaded and _audiodec_failed
_loaded: dict[str, ctypes.CDLL] = {}
_audiodec_failed = False  # one failed build a process: not tried again


def compiler() -> str:
    """The C++ compiler (``g++`` on ``PATH``); raises if there is none."""
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the native audio libraries cannot be built")
    return found


def _command(name: str, out: str) -> list[str]:
    sources, opt, libs = LIBRARIES[name]
    return [compiler(), opt, *COMMON_FLAGS, "-o", out, str(NATIVE_DIR / sources[0]), *libs]


def library_path(name: str) -> Path:
    """``_build/native/lib<name>-<digest>.so``: the digest covers the sources,
    the flags and the link libraries."""
    sources, opt, libs = LIBRARIES[name]
    h = hashlib.sha256()
    for src in sources:
        h.update((NATIVE_DIR / src).read_bytes())
    h.update(" ".join((opt, *COMMON_FLAGS, *libs)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> dict:
    """Compile ``lib<name>`` unless it is on disk.  Returns {"path",
    "seconds", "cached"}; raises RuntimeError with the compiler's output when
    the build fails.  Concurrent callers, in threads or processes, wait on one
    lock file a library: one compiles, the others find the library."""
    out = library_path(name)
    if out.exists():
        return {"path": str(out), "seconds": 0.0, "cached": True}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(out.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or the process dies
        if out.exists():
            return {"path": str(out), "seconds": 0.0, "cached": True}
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(_command(name, tmp), capture_output=True, text=True,
                                  timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(f"building lib{name} failed (g++ exited {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        finally:
            Path(tmp).unlink(missing_ok=True)
    return {"path": str(out), "seconds": time.perf_counter() - t0, "cached": False}


def build_all(names=tuple(LIBRARIES)) -> dict[str, dict]:
    """Build the named libraries, one g++ each, all at once.  Returns {name:
    build(name)'s record, or {"error": the compiler's output}}: the caller
    decides which failure is fatal (``audiodec``'s is not)."""
    def one(name):
        try:
            return build(name)
        except (RuntimeError, OSError, subprocess.SubprocessError) as e:
            return {"error": str(e)}

    with ThreadPoolExecutor(len(names)) as pool:
        return dict(zip(names, pool.map(one, names)))


def _declare_audioproc(lib: ctypes.CDLL) -> None:
    i64 = ctypes.c_int64
    f32p = ctypes.POINTER(ctypes.c_float)
    i16p = ctypes.POINTER(ctypes.c_int16)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.pcm16_to_f32.argtypes = [i16p, f32p, i64]
    lib.pcm16_to_f32.restype = None
    lib.f32_to_pcm16.argtypes = [f32p, i16p, i64]
    lib.f32_to_pcm16.restype = None
    lib.pcm24_to_f32.argtypes = [u8p, f32p, i64]
    lib.pcm24_to_f32.restype = None
    lib.downmix_mean.argtypes = [f32p, f32p, i64, ctypes.c_int]
    lib.downmix_mean.restype = None
    lib.resample_sinc.argtypes = [f32p, i64, f32p, i64, ctypes.c_int, ctypes.c_int,
                                  ctypes.c_int]
    lib.resample_sinc.restype = i64
    lib.audio_stats.argtypes = [f32p, i64, f32p, f32p]
    lib.audio_stats.restype = None


def _declare_mp3dec(lib: ctypes.CDLL) -> None:
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.mp3_selftest.argtypes = []
    lib.mp3_selftest.restype = ctypes.c_int
    lib.mp3_probe.argtypes = [u8p, i64, i32p, i32p, i32p]
    lib.mp3_probe.restype = i64
    lib.mp3_decode.argtypes = [u8p, i64, f32p, i64, i32p, i32p, i32p]
    lib.mp3_decode.restype = i64
    rc = lib.mp3_selftest()
    if rc != 0:
        raise RuntimeError(f"libmp3dec's huffman tables failed their self-test (mask {rc})")


def _declare_audiodec(lib: ctypes.CDLL) -> None:
    i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.adec_probe.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, i32p, i32p]
    lib.adec_probe.restype = i64
    lib.adec_decode_file.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, f32p, i64,
                                     i32p, i32p]
    lib.adec_decode_file.restype = i64
    lib.adec_encode_file.argtypes = [ctypes.c_char_p, f32p, i64, ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_char_p]
    lib.adec_encode_file.restype = ctypes.c_int


_DECLARE = {"audioproc": _declare_audioproc, "mp3dec": _declare_mp3dec,
            "audiodec": _declare_audiodec}


def _load(name: str) -> ctypes.CDLL:
    """Build (if needed), load and declare ``lib<name>``, once a process;
    raises on failure."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name)["path"])
            _DECLARE[name](lib)
            _loaded[name] = lib
    return lib


def load() -> ctypes.CDLL:
    """``libaudioproc``, built on first use; raises when it cannot be."""
    return _load("audioproc")


def load_mp3dec() -> ctypes.CDLL:
    """``libmp3dec``, built on first use and self-tested; raises when it
    cannot be."""
    return _load("mp3dec")


def load_audiodec() -> ctypes.CDLL | None:
    """``libaudiodec``, built on first use; None where the FFmpeg libraries
    are missing."""
    global _audiodec_failed
    if _audiodec_failed:
        return None
    try:
        return _load("audiodec")
    except (RuntimeError, OSError, subprocess.SubprocessError):
        with _lock:
            _audiodec_failed = True
        return None


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def pcm16_to_f32(pcm: np.ndarray) -> np.ndarray:
    """int16 PCM → float32 ``pcm / 32768``, same shape."""
    lib = load()
    pcm = np.ascontiguousarray(pcm, dtype=np.int16)
    out = np.empty(pcm.size, np.float32)
    lib.pcm16_to_f32(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), _fptr(out), pcm.size)
    return out.reshape(pcm.shape)


def f32_to_pcm16(x: np.ndarray) -> np.ndarray:
    """float → int16 PCM: clipped to [-1, 1], ``v * 32767`` in float32, half
    away from zero, same shape."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    out = np.empty(x.size, np.int16)
    lib.f32_to_pcm16(_fptr(x), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)), x.size)
    return out.reshape(x.shape)


def resample_sinc(x: np.ndarray, in_rate: int, out_rate: int, zeros: int = 16) -> np.ndarray:
    """Windowed-sinc resampling of mono float32 audio from ``in_rate`` to
    ``out_rate`` (``zeros`` zero crossings a side)."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    cap = int(np.floor(x.size * out_rate / in_rate)) + 1
    out = np.empty(cap, np.float32)
    n = lib.resample_sinc(_fptr(x), x.size, _fptr(out), cap, in_rate, out_rate, zeros)
    return out[:n]


def audio_stats(x: np.ndarray) -> tuple[float, float]:
    """(peak, RMS) of float32 audio."""
    lib = load()
    x = np.ascontiguousarray(x, dtype=np.float32)
    peak = ctypes.c_float()
    rms = ctypes.c_float()
    lib.audio_stats(_fptr(x), x.size, ctypes.byref(peak), ctypes.byref(rms))
    return float(peak.value), float(rms.value)


def decode_mp3(data: bytes):
    """Decode an mp3 byte stream with the in-repo decoder.

    Returns ``(samples, sample_rate, bad_frames)`` — samples [n] mono or
    [n, 2] stereo — or None when the bytes hold no Layer III frame.  The
    buffer has room for two channels whatever the first frame says (it may
    be a mono tag frame before stereo audio)."""
    lib = load_mp3dec()
    buf = np.frombuffer(data, np.uint8)
    u8 = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    sr, ch, spf = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    frames = lib.mp3_probe(u8, buf.size, ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(spf))
    if frames <= 0:
        return None
    out = np.zeros(2 * int(frames + 2) * int(spf.value), np.float32)
    bad = ctypes.c_int()
    n = lib.mp3_decode(u8, buf.size, _fptr(out), out.size, ctypes.byref(sr), ctypes.byref(ch),
                       ctypes.byref(bad))
    if n <= 0:
        return None
    nch = max(ch.value, 1)
    pcm = out[: int(n) * nch]
    if nch > 1:
        pcm = pcm.reshape(-1, nch)
    return pcm, int(sr.value), int(bad.value)


def decode_audio_file(path, target_sr: int = 0, mono: bool = False):
    """Decode any compressed audio file via libav to float32 PCM.

    Returns ``(samples, sample_rate)`` — samples shaped [n] when mono or the
    source is mono, else [n, channels] — or None when the libav libraries
    are unavailable or the file cannot be decoded."""
    lib = load_audiodec()
    if lib is None:
        return None
    p = str(path).encode()
    sr, ch = ctypes.c_int(), ctypes.c_int()
    n = lib.adec_probe(p, target_sr, int(mono), ctypes.byref(sr), ctypes.byref(ch))
    if n <= 0:
        return None
    buf = np.empty(int(n) * max(ch.value, 1), np.float32)
    m = lib.adec_decode_file(p, target_sr, int(mono), _fptr(buf), buf.size, ctypes.byref(sr),
                             ctypes.byref(ch))
    if m <= 0:
        return None
    nch = max(ch.value, 1)
    out = buf[: int(m) * nch]
    if nch > 1:
        out = out.reshape(-1, nch)
    return out, int(sr.value)


def encode_mp3(path, pcm: np.ndarray, sample_rate: int, bitrate_kbps: int = 128) -> bool:
    """Encode float PCM ([n] mono or [n, ch]) to .mp3 with libmp3lame
    (through libavcodec).  Returns False when unavailable or on failure."""
    return encode_audio(path, pcm, sample_rate, bitrate_kbps, codec="libmp3lame")


def encode_audio(path, pcm: np.ndarray, sample_rate: int, bitrate_kbps: int = 128,
                 codec: str = "") -> bool:
    """Encode float PCM ([n] mono or [n, ch]) to any container libavformat
    can guess from the filename (.mp3/.ogg/.opus/.m4a/.aac/...), with the
    container's default codec unless ``codec`` names one (mp3, opus and ogg
    take libmp3lame, libopus and libvorbis, as in the JAX package).  Returns
    False when libav is unavailable or the encode fails."""
    lib = load_audiodec()
    if lib is None:
        return False
    if not codec:
        ext = str(path).rsplit(".", 1)[-1].lower()
        codec = {"mp3": "libmp3lame", "opus": "libopus", "ogg": "libvorbis"}.get(ext, "")
    x = np.ascontiguousarray(pcm, np.float32)
    nch = 1 if x.ndim == 1 else int(x.shape[1])
    flat = np.ascontiguousarray(x.reshape(-1))
    rc = lib.adec_encode_file(str(path).encode(), _fptr(flat), x.shape[0], sample_rate, nch,
                              bitrate_kbps, codec.encode())
    return rc == 0
