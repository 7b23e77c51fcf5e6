"""Dependency-free FLAC read/write (host-side audio I/O; a copy of
``dia_tts_prune_tpu/utils/flac.py``, which the port may not import — numpy
only, no kernel).

The reference loads voice-clone prompts through torchaudio, which decodes any
libsox/ffmpeg format (dia/model.py:551-559).  The port depends on neither
torchaudio nor soundfile: mp3 decodes with the in-repo ``native/mp3dec.cpp``,
other compressed formats through the system FFmpeg libraries
(``native/audiodec.cpp``) where they exist, and FLAC, the one lossless,
fully-specified format that is practical to implement exactly, here in
numpy.

* ``read_flac`` is a complete subset decoder: STREAMINFO parsing, frame
  headers (fixed + variable blocking), all four subframe types (CONSTANT,
  VERBATIM, FIXED orders 0-4, LPC), Rice/Rice2 residual partitions with
  escape codes, wasted bits, and all stereo decorrelation modes
  (left/side, right/side, mid/side).  Bit plumbing is numpy-vectorized
  (``np.unpackbits`` + index math): this is prompt I/O, not a kernel path.
* ``write_flac`` emits VERBATIM subframes: bit-exact lossless storage of
  int16 PCM in a fully spec-conformant stream (correct CRC-8/CRC-16 and
  STREAMINFO MD5) that any FLAC decoder — including ``read_flac`` — accepts.
  It is deterministic: the JAX package's copy writes the same bytes.

mp3, ogg and m4a wait for a native codec shim (``audio_io`` says so when
asked for one).
"""

from __future__ import annotations

import hashlib
import struct
from pathlib import Path

import numpy as np

_FIXED_COEFFS = {
    0: (),
    1: (1,),
    2: (2, -1),
    3: (3, -3, 1),
    4: (4, -6, 4, -1),
}

_SAMPLE_SIZE_BITS = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}

_BLOCK_SIZES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                13: 8192, 14: 16384, 15: 32768}


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


_CRC16_TABLE = None


def _crc16(data: bytes) -> int:
    global _CRC16_TABLE
    if _CRC16_TABLE is None:
        table = []
        for i in range(256):
            crc = i << 8
            for _ in range(8):
                crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 else (crc << 1) & 0xFFFF
            table.append(crc)
        _CRC16_TABLE = table
    crc = 0
    t = _CRC16_TABLE
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ t[((crc >> 8) ^ b) & 0xFF]
    return crc


class _Bits:
    """MSB-first bit reader over the whole stream (numpy-backed)."""

    def __init__(self, data: bytes):
        self.data = data
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.ones = np.flatnonzero(self.bits)
        self.pos = 0
        self._pows = [
            (1 << np.arange(n - 1, -1, -1, dtype=np.int64)) for n in range(0, 65)
        ]

    def read_uint(self, n: int) -> int:
        if n == 0:
            return 0
        v = int(self.bits[self.pos : self.pos + n] @ self._pows[n])
        self.pos += n
        return v

    def read_int(self, n: int) -> int:
        v = self.read_uint(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_uint_array(self, count: int, width: int) -> np.ndarray:
        """count values of width bits each (bulk, for VERBATIM/warmup)."""
        seg = self.bits[self.pos : self.pos + count * width].reshape(count, width)
        self.pos += count * width
        return seg @ self._pows[width]

    def read_int_array(self, count: int, width: int) -> np.ndarray:
        v = self.read_uint_array(count, width)
        return np.where(v >= (1 << (width - 1)), v - (1 << width), v)

    def read_unary(self) -> int:
        i = int(np.searchsorted(self.ones, self.pos))
        stop = int(self.ones[i])
        q = stop - self.pos
        self.pos = stop + 1
        return q

    def read_rice_array(self, count: int, k: int) -> np.ndarray:
        """count Rice(k)-coded signed residuals (zigzag)."""
        out = np.empty(count, np.int64)
        bits, ones, pows = self.bits, self.ones, self._pows
        pos = self.pos
        i = int(np.searchsorted(ones, pos))
        kp = pows[k] if k else None
        for j in range(count):
            stop = int(ones[i])
            q = stop - pos
            pos = stop + 1
            if k:
                u = (q << k) | int(bits[pos : pos + k] @ kp)
                pos += k
                i = int(np.searchsorted(ones, pos, side="left"))
            else:
                u = q
                i += 1
            out[j] = (u >> 1) ^ -(u & 1)
        self.pos = pos
        return out

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7

    def byte_pos(self) -> int:
        return self.pos // 8


def _read_utf8_number(br: _Bits) -> int:
    first = br.read_uint(8)
    if first < 0x80:
        return first
    n = 0
    mask = 0x40
    while first & mask:
        n += 1
        mask >>= 1
    v = first & (mask - 1)
    for _ in range(n):
        cont = br.read_uint(8)
        if cont & 0xC0 != 0x80:
            raise ValueError("FLAC: invalid UTF-8 coded frame number")
        v = (v << 6) | (cont & 0x3F)
    return v


def _read_residual(br: _Bits, blocksize: int, order: int) -> np.ndarray:
    method = br.read_uint(2)
    if method > 1:
        raise ValueError(f"FLAC: reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read_uint(4)
    n_part = 1 << po
    if blocksize % n_part:
        raise ValueError("FLAC: partition order does not divide block size")
    out = np.empty(blocksize - order, np.int64)
    at = 0
    for p in range(n_part):
        n = blocksize // n_part - (order if p == 0 else 0)
        k = br.read_uint(plen)
        if k == escape:  # raw binary partition
            width = br.read_uint(5)
            vals = (br.read_int_array(n, width) if width
                    else np.zeros(n, np.int64))
        else:
            vals = br.read_rice_array(n, k)
        out[at : at + n] = vals
        at += n
    return out


def _decode_subframe(br: _Bits, blocksize: int, bps: int) -> np.ndarray:
    if br.read_uint(1):
        raise ValueError("FLAC: subframe header padding bit set")
    stype = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = br.read_unary() + 1
        bps -= wasted

    if stype == 0:  # CONSTANT
        out = np.full(blocksize, br.read_int(bps), np.int64)
    elif stype == 1:  # VERBATIM
        out = br.read_int_array(blocksize, bps)
    elif 8 <= stype <= 12:  # FIXED order 0-4
        order = stype - 8
        warm = br.read_int_array(order, bps) if order else np.empty(0, np.int64)
        resid = _read_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        coeffs = _FIXED_COEFFS[order]
        if order == 0:
            out[:] = resid
        else:
            o = out
            for i in range(order, blocksize):
                o[i] = resid[i - order] + sum(
                    c * o[i - 1 - j] for j, c in enumerate(coeffs))
    elif stype >= 32:  # LPC, order = stype - 31
        order = stype - 31
        warm = br.read_int_array(order, bps)
        precision = br.read_uint(4) + 1
        if precision == 16:
            raise ValueError("FLAC: invalid LPC precision escape")
        shift = br.read_int(5)
        coeffs = [br.read_int(precision) for _ in range(order)]
        resid = _read_residual(br, blocksize, order)
        out = np.empty(blocksize, np.int64)
        out[:order] = warm
        for i in range(order, blocksize):
            acc = 0
            for j, c in enumerate(coeffs):
                acc += c * out[i - 1 - j]
            out[i] = resid[i - order] + (acc >> shift)
    else:
        raise ValueError(f"FLAC: reserved subframe type {stype}")

    if wasted:
        out = out << wasted
    return out


def read_flac(path: str | Path) -> tuple[np.ndarray, int]:
    """Decode a FLAC file → (float32 samples [C, T] in [-1, 1], sample_rate)."""
    data = Path(path).read_bytes()
    if data[:4] != b"fLaC":
        raise ValueError(f"{path}: not a FLAC stream (bad magic)")
    # ---- metadata blocks ----
    off = 4
    info = None
    while True:
        hdr = data[off]
        btype, last = hdr & 0x7F, bool(hdr & 0x80)
        length = int.from_bytes(data[off + 1 : off + 4], "big")
        if btype == 0:  # STREAMINFO
            body = data[off + 4 : off + 4 + length]
            raw = int.from_bytes(body[10:18], "big")
            info = {
                "min_block": struct.unpack(">H", body[0:2])[0],
                "max_block": struct.unpack(">H", body[2:4])[0],
                "sample_rate": raw >> 44,
                "channels": ((raw >> 41) & 0x7) + 1,
                "bps": ((raw >> 36) & 0x1F) + 1,
                "total": raw & ((1 << 36) - 1),
            }
        off += 4 + length
        if last:
            break
    if info is None:
        raise ValueError(f"{path}: missing STREAMINFO")

    br = _Bits(data)
    br.pos = off * 8
    channels_out: list[np.ndarray] = []
    total = 0
    n_bits = len(br.bits)
    while br.pos + 32 <= n_bits:
        frame_start = br.byte_pos()
        sync = br.read_uint(14)
        if sync != 0b11111111111110:
            raise ValueError(f"{path}: lost frame sync at byte {frame_start}")
        br.read_uint(1)  # reserved
        br.read_uint(1)  # blocking strategy
        bs_bits = br.read_uint(4)
        sr_bits = br.read_uint(4)
        chan_bits = br.read_uint(4)
        size_bits = br.read_uint(3)
        br.read_uint(1)  # reserved
        _read_utf8_number(br)
        if bs_bits == 6:
            blocksize = br.read_uint(8) + 1
        elif bs_bits == 7:
            blocksize = br.read_uint(16) + 1
        elif bs_bits in _BLOCK_SIZES:
            blocksize = _BLOCK_SIZES[bs_bits]
        else:
            raise ValueError(f"{path}: reserved block size code {bs_bits}")
        if sr_bits == 12:
            br.read_uint(8)
        elif sr_bits in (13, 14):
            br.read_uint(16)
        crc_expect = br.read_uint(8)
        hdr_bytes = data[frame_start : br.byte_pos() - 1]
        if _crc8(hdr_bytes) != crc_expect:
            raise ValueError(f"{path}: frame header CRC-8 mismatch at byte {frame_start}")
        bps = info["bps"] if size_bits == 0 else _SAMPLE_SIZE_BITS[size_bits]

        if chan_bits < 8:
            n_ch = chan_bits + 1
            subs = [_decode_subframe(br, blocksize, bps) for _ in range(n_ch)]
        elif chan_bits == 8:  # left/side
            left = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            subs = [left, left - side]
        elif chan_bits == 9:  # right/side
            side = _decode_subframe(br, blocksize, bps + 1)
            right = _decode_subframe(br, blocksize, bps)
            subs = [side + right, right]
        elif chan_bits == 10:  # mid/side
            mid = _decode_subframe(br, blocksize, bps)
            side = _decode_subframe(br, blocksize, bps + 1)
            m2 = (mid << 1) | (side & 1)
            subs = [(m2 + side) >> 1, (m2 - side) >> 1]
        else:
            raise ValueError(f"{path}: reserved channel assignment {chan_bits}")

        br.align()
        br.read_uint(16)  # frame CRC-16 (structure already validated via CRC-8)
        channels_out.append(np.stack(subs))
        total += blocksize
        if info["total"] and total >= info["total"]:
            break

    pcm = np.concatenate(channels_out, axis=1)
    if info["total"]:
        pcm = pcm[:, : info["total"]]
    scale = float(1 << (info["bps"] - 1))
    return (pcm.astype(np.float32) / scale), info["sample_rate"]


class _BitWriter:
    def __init__(self):
        self.chunks: list[bytes] = []
        self._acc = 0
        self._n = 0

    def write_uint(self, value: int, n: int) -> None:
        self._acc = (self._acc << n) | (value & ((1 << n) - 1))
        self._n += n
        while self._n >= 8:
            self._n -= 8
            self.chunks.append(bytes([(self._acc >> self._n) & 0xFF]))
        self._acc &= (1 << self._n) - 1

    def write_bytes(self, b: bytes) -> None:
        assert self._n == 0, "write_bytes requires byte alignment"
        self.chunks.append(b)

    def getvalue(self) -> bytes:
        assert self._n == 0
        return b"".join(self.chunks)


def _utf8_number(v: int) -> bytes:
    """UTF-8-style coded number (FLAC frame index)."""
    if v < 0x80:
        return bytes([v])
    # smallest n continuation bytes with v < 2^(6n + (6-n)) payload bits
    for n in range(1, 7):
        if v < (1 << (6 * n + (6 - n))):
            break
    out = [((0xFF << (7 - n)) & 0xFF) | (v >> (6 * n))]
    for i in range(n - 1, -1, -1):
        out.append(0x80 | ((v >> (6 * i)) & 0x3F))
    return bytes(out)


def write_flac(path: str | Path, audio: np.ndarray, sample_rate: int = 44100,
               block_size: int = 4096) -> None:
    """Write float audio ([C, T] or [T]) as a 16-bit FLAC stream.

    VERBATIM subframes: lossless vs the int16 quantization, spec-conformant
    (valid CRC-8/CRC-16, STREAMINFO MD5), accepted by any FLAC decoder."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    if np.issubdtype(audio.dtype, np.floating):
        pcm = np.round(np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    else:
        pcm = audio.astype(np.int16)
    C, T = pcm.shape
    if not 1 <= C <= 8:
        raise ValueError(f"FLAC supports 1-8 channels, got {C}")

    md5 = hashlib.md5(np.ascontiguousarray(pcm.T).astype("<i2").tobytes()).digest()
    bps = 16
    header = bytearray()
    header += b"fLaC"
    streaminfo = bytearray()
    streaminfo += struct.pack(">HH", block_size, block_size)
    streaminfo += (0).to_bytes(3, "big") * 2  # min/max frame size unknown
    raw = (sample_rate << 44) | ((C - 1) << 41) | ((bps - 1) << 36) | T
    streaminfo += raw.to_bytes(8, "big")
    streaminfo += md5
    header += bytes([0x80]) + len(streaminfo).to_bytes(3, "big") + bytes(streaminfo)

    frames = bytearray()
    n_frames = (T + block_size - 1) // block_size
    for f in range(n_frames):
        start = f * block_size
        n = min(block_size, T - start)
        bw = _BitWriter()
        bw.write_uint(0b11111111111110, 14)
        bw.write_uint(0, 1)  # reserved
        bw.write_uint(0, 1)  # fixed block size
        bs_code = 0b0111 if n != block_size else {
            192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5, 256: 8, 512: 9,
            1024: 10, 2048: 11, 4096: 12, 8192: 13, 16384: 14, 32768: 15,
        }.get(block_size, 0b0111)
        bw.write_uint(bs_code, 4)
        bw.write_uint(0, 4)  # sample rate: from STREAMINFO
        bw.write_uint(C - 1, 4)  # independent channels
        bw.write_uint(0b100, 3)  # 16-bit
        bw.write_uint(0, 1)
        bw.write_bytes(_utf8_number(f))
        if bs_code == 0b0111:
            bw.write_uint(n - 1, 16)
        hdr = bw.getvalue()
        body = _BitWriter()
        for c in range(C):
            body.write_uint(0b00000010, 8)  # VERBATIM subframe header
            body.write_bytes(
                np.ascontiguousarray(pcm[c, start : start + n]).astype(">i2").tobytes())
        frame = hdr + bytes([_crc8(hdr)]) + body.getvalue()
        frame += struct.pack(">H", _crc16(frame))
        frames += frame

    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_bytes(bytes(header) + bytes(frames))
