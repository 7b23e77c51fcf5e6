"""The port's native audio libraries (``dia_tts_prune_tpu_torch/native/``)
against the JAX package's (``dia_tts_prune_tpu/native/``), on the CPU.

* ``mp3dec``: the port's copy decodes every well-formed stream to the same
  bits as the JAX copy (the LAME matrix of tests/test_native.py, the
  committed voice prompt), with the same bad-frame count.  Its repairs are
  held apart: a mono tag frame before stereo audio, the stream that made the
  JAX copy write past its buffer, runs clean under AddressSanitizer through
  the port's copy and overflows through the JAX copy; a file cut inside its
  Xing tag runs clean; eight threads making the first decodes of a process
  equal a serial decode; random and bit-flipped streams never crash it.
* ``audioproc``: its six functions equal the JAX library's bit for bit, and
  the port's numpy ``write_wav`` rounding equals its ``f32_to_pcm16``.
* ``audiodec``: libav decodes equal the JAX shim's; the tests that need the
  FFmpeg libraries skip where they are missing, as the JAX tests do.

The JAX libraries are loaded through ``tests/torch_native_support.py``,
which outlasts their build race (ROADMAP C).
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import native as jn
from dia_tts_prune_tpu.utils import audio_io as jaudio
from dia_tts_prune_tpu_torch import native
from dia_tts_prune_tpu_torch.utils import audio_io as taudio
from tests.torch_native_support import jax_native

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
FIXTURE = Path(__file__).parent / "fixtures" / "torch_mp3_prompt"
JAX_NATIVE = REPO / "dia_tts_prune_tpu" / "native"


@pytest.fixture(scope="module")
def jnative():
    """The JAX package's native module with libaudioproc and libmp3dec loaded."""
    if jax_native() is None:
        pytest.skip("the JAX package's native libraries did not load")
    return jn


@pytest.fixture(scope="module")
def libav(jnative):
    """Both packages' libav shims; skips where the FFmpeg libraries are missing."""
    if native.load_audiodec() is None:
        pytest.skip("the libav shim needs the system FFmpeg libraries")
    if jax_native(audiodec=True) is None:
        pytest.skip("the JAX package's libav shim did not load")
    return jn


# ---------------------------------------------------------------------------
# mp3 streams
# ---------------------------------------------------------------------------

_MPEG1_KBPS = (0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320)
_MPEG1_RATES = (44100, 48000, 32000)


def _strip_id3(data: bytes) -> bytes:
    if data[:3] != b"ID3":
        return data
    size = (data[6] & 0x7F) << 21 | (data[7] & 0x7F) << 14 | (data[8] & 0x7F) << 7 | data[9] & 0x7F
    return data[10 + size:]


def _mpeg1_frames(data: bytes) -> list[bytes]:
    """The MPEG-1 Layer III frames of a stream without ID3 tag, in order."""
    frames, i = [], 0
    while i + 4 <= len(data) and data[i] == 0xFF and (data[i + 1] & 0xFE) == 0xFA:
        size = (144000 * _MPEG1_KBPS[data[i + 2] >> 4] // _MPEG1_RATES[(data[i + 2] >> 2) & 3]
                + ((data[i + 2] >> 1) & 1))
        frames.append(data[i: i + size])
        i += size
    return frames


def _is_tag_frame(frame: bytes) -> bool:
    return b"Xing" in frame[:64] or b"Info" in frame[:64]


def _mono_tag_stereo_audio() -> bytes:
    """``prompt.mp3``'s mono Xing/Info tag frame, then ``stereo.mp3``'s audio
    frames (44.1 kHz MPEG-1 both)."""
    mono = _mpeg1_frames(_strip_id3((FIXTURE / "prompt.mp3").read_bytes()))
    stereo = _mpeg1_frames(_strip_id3((FIXTURE / "stereo.mp3").read_bytes()))
    assert _is_tag_frame(mono[0]) and (mono[0][3] >> 6) == 3  # mono
    assert _is_tag_frame(stereo[0]) and all((f[3] >> 6) != 3 for f in stereo[1:])
    return mono[0] + b"".join(stereo[1:])


def _xing_truncated() -> bytes:
    """``prompt.mp3`` without its ID3 tag, cut two bytes into the flags word
    that follows the tag frame's ``Info`` magic."""
    data = _strip_id3((FIXTURE / "prompt.mp3").read_bytes())
    at = data.index(b"Info") if b"Info" in data[:64] else data.index(b"Xing")
    return data[: at + 6]


LAME_CASES = [  # tests/test_native.py:148-158: (sr, nch, kbps)
    (44100, 1, 128), (44100, 2, 160), (48000, 1, 128), (32000, 1, 96), (22050, 1, 64),
    (16000, 1, 48), (24000, 2, 64), (12000, 1, 32), (8000, 1, 24)]


def _lame_signal(sr, nch):
    rng = np.random.default_rng(sr + nch)
    t = np.arange(int(sr * 1.2)) / sr
    sig = (0.3 * np.sin(2 * np.pi * 440 * t)
           + 0.2 * np.sin(2 * np.pi * 1330 * t * (1 + 0.3 * np.sin(2 * np.pi * 2 * t)))
           + 0.05 * rng.standard_normal(len(t))).astype(np.float32)
    return sig if nch == 1 else np.stack([sig, np.roll(sig, 50) * 0.8], 1)


@pytest.mark.parametrize("sr,nch,kbps", LAME_CASES)
def test_decode_mp3_equals_jax_on_lame_matrix(tmp_path, libav, sr, nch, kbps):
    path = tmp_path / f"m_{sr}_{nch}.mp3"
    assert native.encode_mp3(path, _lame_signal(sr, nch), sr, kbps)
    data = path.read_bytes()
    got, want = native.decode_mp3(data), jn.decode_mp3(data)
    assert got[1:] == want[1:] == (sr, 0)
    assert got[0].dtype == np.float32 and got[0].shape == want[0].shape
    assert got[0].ndim == (1 if nch == 1 else 2)
    np.testing.assert_array_equal(got[0], want[0])


def test_fixture_record_equals_jax_decode(jnative):
    """``decoded.npz`` / ``decoded.json`` are the JAX decode of ``prompt.mp3``,
    and the port's decode has the same float32 bits."""
    record = json.loads((FIXTURE / "decoded.json").read_text())
    data = (FIXTURE / "prompt.mp3").read_bytes()
    for pcm, sr, bad in (jn.decode_mp3(data), native.decode_mp3(data)):
        assert (pcm.shape[0], sr, bad, pcm.ndim) == (record["length"], record["sample_rate"],
                                                    record["bad_frames"], 1)
        assert hashlib.sha256(pcm.tobytes()).hexdigest() == record["sha256_float32"]
        np.testing.assert_array_equal(
            np.clip(np.round(pcm.astype(np.float64) * 32768.0), -32768, 32767).astype(np.int16),
            np.load(FIXTURE / "decoded.npz")["pcm16"])


def test_decode_mp3_mono_tag_before_stereo_audio():
    """The port sizes its buffer for two channels and the decoder bounds its
    writes by it: the spliced stream decodes whole, as stereo, its samples
    those of ``stereo.mp3``'s own decode (the trims come from the other
    file's tag, so the two are compared over their common length)."""
    pcm, sr, bad = native.decode_mp3(_mono_tag_stereo_audio())
    ref, rsr, rbad = native.decode_mp3((FIXTURE / "stereo.mp3").read_bytes())
    assert (sr, bad, pcm.ndim, pcm.shape[1]) == (rsr, rbad, 2, 2) == (44100, 0, 2, 2)
    n = min(len(pcm), len(ref))
    assert n > 0.45 * sr
    np.testing.assert_array_equal(pcm[:n], ref[:n])


# ---------------------------------------------------------------------------
# The memory and thread faults of the JAX copy
# ---------------------------------------------------------------------------

ASAN_PROBE = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
extern "C" {
int64_t mp3_probe(const uint8_t*, int64_t, int*, int*, int*);
int64_t mp3_decode(const uint8_t*, int64_t, float*, int64_t, int*, int*, int*);
}
// Decode argv[1] as both packages' Python wrappers drive the decoder, into a
// buffer sized from the probe's channel count; the input sits in a buffer of
// exactly its size, so a read or write past either one is caught.
int main(int argc, char** argv) {
  FILE* f = fopen(argv[1], "rb");
  if (!f) return 2;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  uint8_t* data = (uint8_t*)malloc(n);
  if (fread(data, 1, n, f) != (size_t)n) return 2;
  fclose(f);
  int sr = 0, ch = 0, spf = 0, bad = 0;
  int64_t frames = mp3_probe(data, n, &sr, &ch, &spf);
  int64_t got = -1;
  if (frames > 0) {
    int64_t cap = (frames + 2) * spf;
    float* out = (float*)malloc(sizeof(float) * cap * ch);
#ifdef CAPACITY_IN_FLOATS
    got = mp3_decode(data, n, out, cap * ch, &sr, &ch, &bad);  // the port's contract
#else
    got = mp3_decode(data, n, out, cap, &sr, &ch, &bad);  // the JAX copy's: samples a channel
#endif
    free(out);
  }
  printf("frames %lld decoded %lld channels %d rate %d bad %d\n", (long long)frames,
         (long long)got, ch, sr, bad);
  free(data);
  return 0;
}
"""
ASAN_FLAGS = ["-std=c++17", "-O1", "-g", "-fsanitize=address", "-fno-omit-frame-pointer"]
ASAN_ENV = {**os.environ, "ASAN_OPTIONS": "detect_leaks=0:abort_on_error=0"}


@pytest.fixture(scope="module")
def asan_probes(tmp_path_factory):
    """The probe program linked with the port's ``mp3dec.cpp`` and with the JAX
    copy, both under AddressSanitizer; skips only where it does not link."""
    d = tmp_path_factory.mktemp("asan")
    (d / "empty.cpp").write_text("int main() { return 0; }\n")
    gxx = native.compiler()
    probe = subprocess.run([gxx, *ASAN_FLAGS, str(d / "empty.cpp"), "-o", str(d / "empty")],
                           capture_output=True, text=True, timeout=120)
    if probe.returncode != 0:
        pytest.skip(f"-fsanitize=address does not link here: {probe.stderr[-300:]}")
    (d / "probe.cpp").write_text(ASAN_PROBE)
    builds = {
        "port": ["-DCAPACITY_IN_FLOATS", str(native.NATIVE_DIR / "mp3dec.cpp")],
        "jax": [str(JAX_NATIVE / "mp3dec.cpp")],
    }
    procs = {k: subprocess.Popen([gxx, *ASAN_FLAGS, str(d / "probe.cpp"), *v, "-o",
                                  str(d / k)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for k, v in builds.items()}
    for k, p in procs.items():
        log, _ = p.communicate(timeout=180)
        assert p.returncode == 0, log.decode(errors="replace")
    return d


def _run_probe(probes, which, data: bytes):
    src = probes / f"in_{which}_{hashlib.sha256(data).hexdigest()[:8]}.mp3"
    src.write_bytes(data)
    return subprocess.run([str(probes / which), str(src)], capture_output=True, text=True,
                          timeout=120, env=ASAN_ENV)


@pytest.mark.parametrize("stream", ["mono_tag_stereo_audio", "xing_truncated"])
def test_port_mp3dec_runs_clean_under_asan(asan_probes, stream):
    data = {"mono_tag_stereo_audio": _mono_tag_stereo_audio, "xing_truncated": _xing_truncated}
    r = _run_probe(asan_probes, "port", data[stream]())
    assert r.returncode == 0 and "AddressSanitizer" not in r.stderr, r.stderr[-2000:]
    if stream == "mono_tag_stereo_audio":  # the probe said mono: half the stereo samples fit
        fields = r.stdout.split()
        assert int(fields[3]) > 0 and fields[5] == "2", r.stdout


def test_jax_mp3dec_overflows_under_asan(asan_probes):
    """The same stream through the JAX copy writes past the buffer its own
    wrapper sizes (``dia_tts_prune_tpu/native/mp3dec.cpp:1246``): the case
    reaches the fault that the port's copy repairs."""
    r = _run_probe(asan_probes, "jax", _mono_tag_stereo_audio())
    assert r.returncode != 0 and "heap-buffer-overflow" in r.stderr, (r.returncode,
                                                                      r.stderr[-1000:])
    assert "WRITE" in r.stderr and "mp3_decode" in r.stderr


THREADS_SCRIPT = r"""
import ctypes, sys, threading
import numpy as np
lib = ctypes.CDLL(sys.argv[1])  # loaded bare: no self-test has built the tables
i64, i32p = ctypes.c_int64, ctypes.POINTER(ctypes.c_int)
u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
lib.mp3_probe.argtypes = [u8p, i64, i32p, i32p, i32p]
lib.mp3_probe.restype = i64
lib.mp3_decode.argtypes = [u8p, i64, f32p, i64, i32p, i32p, i32p]
lib.mp3_decode.restype = i64
buf = np.frombuffer(open(sys.argv[2], "rb").read(), np.uint8)
ptr = buf.ctypes.data_as(u8p)

def decode():
    sr, ch, spf, bad = ctypes.c_int(), ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    frames = lib.mp3_probe(ptr, buf.size, ctypes.byref(sr), ctypes.byref(ch), ctypes.byref(spf))
    out = np.zeros(2 * (frames + 2) * spf.value, np.float32)
    n = lib.mp3_decode(ptr, buf.size, out.ctypes.data_as(f32p), out.size, ctypes.byref(sr),
                       ctypes.byref(ch), ctypes.byref(bad))
    return out[: n * ch.value].tobytes(), sr.value, ch.value, bad.value

start = threading.Barrier(8)
results = [None] * 8

def worker(i):
    start.wait()
    results[i] = decode()

threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=120)
assert not any(t.is_alive() for t in threads)
serial = decode()
print(sum(r == serial for r in results), len(serial[0]))
"""


def test_first_decodes_on_eight_threads_equal_a_serial_decode():
    """A fresh process, the library loaded bare: eight threads make the first
    decodes at once (the tables are built under ``std::call_once``), and each
    equals a decode made after them."""
    so = native.build("mp3dec")["path"]
    r = subprocess.run([sys.executable, "-c", THREADS_SCRIPT, so, str(FIXTURE / "prompt.mp3")],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-1000:]
    equal, nbytes = map(int, r.stdout.split())
    assert equal == 8 and nbytes == 4 * 88200


FUZZ_SCRIPT = r"""
import numpy as np, sys
sys.path.insert(0, sys.argv[1])
from dia_tts_prune_tpu_torch import native
rng = np.random.default_rng(7)
real = open(sys.argv[2], "rb").read()
for i in range(40):
    if i % 3 == 0:
        buf = rng.integers(0, 256, rng.integers(10, 3000), dtype=np.uint8).tobytes()
    elif i % 3 == 1:
        buf = bytes([0xFF, 0xFB, int(rng.integers(0, 256)), int(rng.integers(0, 256))]) \
              + rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    else:
        b = bytearray(real)
        for _ in range(20):
            b[int(rng.integers(0, len(b)))] = int(rng.integers(0, 256))
        buf = bytes(b)
    native.decode_mp3(buf)
print("ok")
"""


def test_mp3dec_fuzz_no_crash():
    """tests/test_native.py::test_mp3dec_fuzz_no_crash on the port's decoder:
    random bytes and bit-flipped real frames (the committed prompt) never
    crash it; in a subprocess, so that a crash fails this test only."""
    r = subprocess.run([sys.executable, "-c", FUZZ_SCRIPT, str(REPO),
                        str(FIXTURE / "prompt.mp3")], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0 and "ok" in r.stdout, r.stderr[-500:]


BUILD_SCRIPT = r"""
import ctypes, sys
from pathlib import Path
from dia_tts_prune_tpu_torch import native
native.BUILD_DIR = Path(sys.argv[1])
rec = native.build("audioproc")
ctypes.CDLL(rec["path"]).audio_stats  # a whole library: it loads and has its symbols
print(rec["cached"], rec["path"])
"""


def test_concurrent_builds_share_one_library(tmp_path):
    """Four processes build ``audioproc`` into one empty directory at once:
    one compiles under the library's lock, every one loads the same whole
    file, and no temporary file is left."""
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_SCRIPT, str(tmp_path / "b")],
                              cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-500:] for _, err in outs]
    lines = [out.split() for out, _ in outs]
    assert sorted(cached for cached, _ in lines) == ["False", "True", "True", "True"]
    assert len({path for _, path in lines}) == 1
    assert [p.name for p in (tmp_path / "b").glob("*.so")] == [Path(lines[0][1]).name]


def test_load_failure_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A library that does not build raises with g++'s output; it is never
    turned into None (``audiodec``, which needs the FFmpeg libraries, is
    the one optional library)."""
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", tmp_path)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setitem(native.LIBRARIES, "mp3dec", (("broken.cpp",), "-O2", ()))
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match=r"building libmp3dec failed[\s\S]*broken\.cpp"):
        native.load_mp3dec()
    assert not list((tmp_path / "build").glob("*.so"))


# ---------------------------------------------------------------------------
# audioproc and the WAV writer's rounding
# ---------------------------------------------------------------------------


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _pcm24(lib, raw):
    out = np.empty(raw.size // 3, np.float32)
    lib.pcm24_to_f32(_ptr(raw, ctypes.c_uint8), _ptr(out, ctypes.c_float), out.size)
    return out


def _downmix(lib, x):
    out = np.empty(x.shape[0], np.float32)
    lib.downmix_mean(_ptr(x, ctypes.c_float), _ptr(out, ctypes.c_float), x.shape[0], x.shape[1])
    return out


AUDIOPROC = {
    "pcm16_to_f32": lambda m, lib, rng: m.pcm16_to_f32(
        rng.integers(-32768, 32768, 5001).astype(np.int16)),
    "f32_to_pcm16": lambda m, lib, rng: m.f32_to_pcm16(
        (rng.normal(size=(2, 4001)) * 0.7).astype(np.float32)),
    "pcm24_to_f32": lambda m, lib, rng: _pcm24(lib, rng.integers(0, 256, 3 * 3001,
                                                                 dtype=np.uint8)),
    "downmix_mean": lambda m, lib, rng: _downmix(lib, rng.normal(size=(3001, 3)).astype(
        np.float32)),
    "resample_sinc": lambda m, lib, rng: np.concatenate([
        m.resample_sinc(rng.normal(size=2205).astype(np.float32), a, b)
        for a, b in ((22050, 44100), (44100, 16000), (48000, 44100), (24000, 24000))]),
    "audio_stats": lambda m, lib, rng: np.asarray(m.audio_stats(
        rng.normal(size=9999).astype(np.float32)), np.float32),
}


@pytest.mark.parametrize("name", list(AUDIOPROC))
def test_audioproc_equals_jax(jnative, name):
    got = AUDIOPROC[name](native, native.load(), np.random.default_rng(3))
    want = AUDIOPROC[name](jn, jn.load(), np.random.default_rng(3))
    assert got.dtype == want.dtype and got.shape == want.shape and got.size > 0
    np.testing.assert_array_equal(got, want)


# (k + 0.5) / 32767 for even k < 2000: v * 32767 lands exactly on k + 0.5 in float32
TIES = ((np.arange(0, 2000, 2) + 0.5) / 32767).astype(np.float32)


def test_numpy_pcm16_equals_the_native_rounding():
    rng = np.random.default_rng(11)
    x = np.concatenate([TIES, -TIES, (rng.normal(size=20000) * 0.6).astype(np.float32),
                        np.array([0.0, -0.0, 1.0, -1.0, 1.5, -7.0, 0.5, -0.5, 1e-30,
                                  0.5 / 32767, -0.5 / 32767, np.nextafter(1, 0)], np.float32)])
    np.testing.assert_array_equal(taudio.f32_to_pcm16(x), native.f32_to_pcm16(x))
    assert (np.round(TIES * 32767) != native.f32_to_pcm16(TIES)).all()  # half to even differs


@pytest.mark.parametrize("case", ["ties", "random_mono", "random_stereo_float64"])
def test_write_wav_bytes_equal_jax(tmp_path, jnative, case):
    """The port's WAV has the JAX ``write_wav``'s bytes (its native rounding:
    halves away from zero), the tie values included."""
    rng = np.random.default_rng(5)
    audio = {"ties": np.concatenate([TIES, -TIES]),
             "random_mono": (rng.normal(size=7001) * 0.5).astype(np.float32),
             "random_stereo_float64": rng.normal(size=(2, 3001)) * 0.8}[case]
    taudio.write_wav(tmp_path / "port.wav", audio, 22050)
    jaudio.write_wav(tmp_path / "jax.wav", audio, 22050)
    assert (tmp_path / "port.wav").read_bytes() == (tmp_path / "jax.wav").read_bytes()


# ---------------------------------------------------------------------------
# libav and the reader chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ext", [".ogg", ".m4a", ".aac", ".mp3"])
def test_decode_audio_file_equals_jax(tmp_path, libav, ext):
    sig = _lame_signal(44100, 2)[:30000]
    path = tmp_path / f"x{ext}"
    assert native.encode_audio(path, sig, 44100, 128)
    for kw in (dict(), dict(target_sr=16000, mono=True)):
        got, want = native.decode_audio_file(path, **kw), jn.decode_audio_file(path, **kw)
        assert got[1] == want[1] and got[0].shape == want[0].shape and got[0].size > 0
        np.testing.assert_array_equal(got[0], want[0])


def test_raw_mpeg25_goes_through_mp3dec_where_jax_takes_libav(tmp_path, libav):
    """A raw MPEG-2.5 stream (8 kHz, no ``ID3``, no ``.mp3`` suffix): the
    port's sniff (the header mask) sends it to mp3dec; the JAX sniff matches
    four exact header pairs, misses it and reads it through libav.  A pinned
    divergence: the two decodes agree to 90 dB."""
    assert native.encode_mp3(tmp_path / "a.mp3", _lame_signal(8000, 1), 8000, 24)
    raw = _strip_id3((tmp_path / "a.mp3").read_bytes())
    assert raw[:2] == b"\xff\xe3"
    p = tmp_path / "prompt.bin"
    p.write_bytes(raw)
    got, sr = taudio.read_audio(p)
    want, jsr = jaudio.read_audio(p)
    assert sr == jsr == 8000 and got.shape == want.shape and got.shape[0] == 1
    np.testing.assert_array_equal(got[0], native.decode_mp3(raw)[0])  # mp3dec
    assert jaudio._read_via_mp3dec(p) is None
    np.testing.assert_array_equal(want[0], jn.decode_audio_file(p)[0])  # libav
    err = got - want
    snr = 10 * np.log10(float((want ** 2).sum()) / max(float((err ** 2).sum()), 1e-30))
    assert snr >= 90.0, snr


@pytest.mark.parametrize("head,suffix,want", [
    (b"\xff\xfb\x90\x00", ".bin", True), (b"\xff\xfa\x90\x00", "", True),  # MPEG-1, CRC
    (b"\xff\xf3\x90\x00", ".x", True), (b"\xff\xe3\x90\x00", ".x", True),  # MPEG-2, 2.5
    (b"\xff\xe2\x90\x00", "", True), (b"ID3\x04", ".ogg", True), (b"OggS", ".mp3", True),
    (b"\xff\xfd\x90\x00", ".x", False),  # layer II
    (b"\xff\xf1\x50\x80", ".aac", False),  # ADTS AAC
    (b"OggS", ".ogg", False), (b"\xff", "", False)])
def test_mp3_sniff(head, suffix, want):
    assert taudio.looks_like_mp3(head, suffix) is want
