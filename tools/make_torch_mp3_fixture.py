#!/usr/bin/env python3
"""Make ``tests/fixtures/torch_mp3_prompt/``: an mp3 voice prompt and the
record of its decode.

* ``prompt.mp3``: the waveform that the port's published-shape codec
  (``DACConfig()``, hop 512, ``init_dac_params`` seed 1: the files phase's
  codec draws) decodes from ``trained_small``'s golden tokens (239 frames,
  2.77 s at 44.1 kHz), cut to its first 2 s, scaled by ``GAIN`` and encoded
  mono at 128 kbps by the port's ``native.encode_mp3`` (libmp3lame through
  the libav shim).  The fixture's own tiny codec has a hop of 8: 1912
  samples, 43 ms.  Random codec weights saturate tanh, and at full scale the
  mp3 decode overshoots to 2.3: at ``GAIN`` every decoded sample lies in
  [-1, 1], so that the int16 record clips none.
* ``stereo.mp3``: the same waveform's first 0.5 s in two channels (the
  second one 50 samples later, x 0.8), stereo at 128 kbps: with
  ``prompt.mp3``'s mono tag frame before its audio frames it is the stream
  that made the JAX copy of ``mp3dec.cpp`` write past its buffer
  (``tests/test_torch_native.py``).
* ``decoded.npz``: ``pcm16``, the JAX package's ``native.decode_mp3`` of
  ``prompt.mp3`` as int16 codes (``round(x * 32768)``, clipped).
* ``decoded.json``: that decode's float32 sha256, length, rate, channels
  and bad frames.

``chip_smoke.py`` (files phase) and ``tests/test_torch_native.py`` hold the
port's decoder to this record.  Run from the repository root, on the CPU:
``JAX_PLATFORMS=cpu python tools/make_torch_mp3_fixture.py``.
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

SOURCE = ROOT / "tests" / "fixtures" / "trained_small"
OUT = ROOT / "tests" / "fixtures" / "torch_mp3_prompt"
SECONDS = 2.0
KBPS = 128
GAIN = 0.25


def pcm16(x: np.ndarray) -> np.ndarray:
    """Float samples → the record's int16 codes."""
    return np.clip(np.round(x.astype(np.float64) * 32768.0), -32768, 32767).astype(np.int16)


def main() -> int:
    import torch

    from dia_tts_prune_tpu import native as jax_native
    from dia_tts_prune_tpu_torch import native
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, decode_codes, init_dac_params

    cfg = DACConfig()
    tokens = torch.from_numpy(np.load(SOURCE / "golden.npz")["tokens"])[None]
    with torch.no_grad():
        wav = decode_codes(init_dac_params(cfg, seed=1, device="cpu"), cfg, tokens)[0].numpy()
    rate = cfg.sample_rate
    wav = np.ascontiguousarray(GAIN * wav[: int(SECONDS * rate)], np.float32)
    OUT.mkdir(parents=True, exist_ok=True)
    if not native.encode_mp3(OUT / "prompt.mp3", wav, rate, KBPS):
        raise RuntimeError("encode_mp3 failed: the libav shim needs the FFmpeg libraries")
    head = wav[: int(0.5 * rate)]
    stereo = np.ascontiguousarray(np.stack([head, 0.8 * np.roll(head, 50)], 1), np.float32)
    if not native.encode_mp3(OUT / "stereo.mp3", stereo, rate, KBPS):
        raise RuntimeError("encode_mp3 failed")
    pcm, sr, bad = jax_native.decode_mp3((OUT / "prompt.mp3").read_bytes())
    if np.abs(pcm).max() > 1.0:
        raise RuntimeError(f"the decode peaks at {np.abs(pcm).max()}: lower GAIN")
    np.savez_compressed(OUT / "decoded.npz", pcm16=pcm16(pcm))
    record = {"sha256_float32": hashlib.sha256(np.ascontiguousarray(pcm, np.float32).tobytes())
              .hexdigest(), "length": int(pcm.shape[0]), "sample_rate": sr,
              "channels": 1 if pcm.ndim == 1 else int(pcm.shape[1]), "bad_frames": bad,
              "source": f"trained_small golden tokens, DACConfig() seed 1, first {SECONDS} s, "
                        f"x {GAIN}, libmp3lame {KBPS} kbps mono; decoded by the JAX native.decode_mp3"}
    (OUT / "decoded.json").write_text(json.dumps(record, indent=2) + "\n")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
