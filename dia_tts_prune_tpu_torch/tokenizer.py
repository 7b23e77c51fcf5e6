"""Byte-level text tokenizer with speaker-tag mapping.

The port's own copy of ``dia_tts_prune_tpu/tokenizer.py``.  Behavioral
parity with the reference (dia/model.py:254-289 for encoding and
dia/model.py:686-696 for the trailing-speaker-tag heuristic), implemented as
host-side pure functions that emit fixed-shape numpy arrays — the only
host→device transfer of the text path.
"""

from __future__ import annotations

import numpy as np

S1_BYTE = 0x01
S2_BYTE = 0x02


def encode_text(text: str, max_len: int, pad_value: int = 0) -> np.ndarray:
    """Encode text as UTF-8 bytes with [S1]→0x01 / [S2]→0x02, pad/truncate.

    Returns an int32 array of shape [max_len].
    (reference: dia/model.py:254-289)
    """
    byte_text = text.encode("utf-8")
    replaced = byte_text.replace(b"[S1]", bytes([S1_BYTE])).replace(b"[S2]", bytes([S2_BYTE]))
    tokens = list(replaced)
    if len(tokens) > max_len:
        tokens = tokens[:max_len]
    out = np.full((max_len,), pad_value, dtype=np.int32)
    if tokens:
        out[: len(tokens)] = np.asarray(tokens, dtype=np.int32)
    return out


def build_effective_text(text: str, audio_prompt_text: str | None = None) -> str:
    """Combine prompt transcript + text and apply the trailing-tag heuristic.

    The heuristic appends the *opposite* speaker tag when the text does not
    already end with the expected terminal tag, which empirically improves
    utterance endings (reference: dia/model.py:686-696).
    """
    if audio_prompt_text:
        effective = audio_prompt_text.strip() + " " + text.strip()
    else:
        effective = text.strip()

    last_s1 = effective.rfind("[S1]")
    last_s2 = effective.rfind("[S2]")
    if last_s1 > last_s2 and not effective.endswith("[S2]"):
        effective += " [S2]"
    elif last_s2 > last_s1 and not effective.endswith("[S1]"):
        effective += " [S1]"
    elif last_s1 == -1 and last_s2 == -1 and effective:
        effective += " [S2]"
    return effective


def encode_cfg_batch(text: str, max_len: int, pad_value: int = 0) -> np.ndarray:
    """Build the classifier-free-guidance input pair ``[uncond; cond]``.

    Row 0 is all padding (the unconditional branch), row 1 the conditional
    text (reference: dia/model.py:360-362).  Returns int32 [2, max_len].
    """
    cond = encode_text(text, max_len, pad_value)
    uncond = np.full_like(cond, pad_value)
    return np.stack([uncond, cond], axis=0)
