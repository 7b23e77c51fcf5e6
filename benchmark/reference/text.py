"""The text and token layout of a request, as the published model reads it
(nari-labs/dia, ``dia/model.py``): the script's bytes with ``[S1]`` / ``[S2]``
as bytes 1 / 2, after the trailing-speaker-tag rule; the delayed token rows
of the decode loop.  Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def effective_text(text: str) -> str:
    """Append the speaker tag that does not end the script (reference:
    dia/model.py:686-696), for a request without a voice prompt."""
    t = text.strip()
    s1, s2 = t.rfind("[S1]"), t.rfind("[S2]")
    if s1 > s2 and not t.endswith("[S2]"):
        t += " [S2]"
    elif s2 > s1 and not t.endswith("[S1]"):
        t += " [S1]"
    elif s1 == -1 and s2 == -1 and t:
        t += " [S2]"
    return t


def text_ids(text: str, max_len: int) -> np.ndarray:
    """The conditional row's non-pad bytes (at most ``max_len``)."""
    b = effective_text(text).encode("utf-8").replace(b"[S1]", b"\x01").replace(b"[S2]", b"\x02")
    return np.frombuffer(b[:max_len], dtype=np.uint8).astype(np.int64)


def template(data: dict) -> np.ndarray:
    """Rows ``0 .. max_delay - 1`` of a request without a voice prompt: row
    t, channel c is BOS while ``t <= delay[c]`` and PAD after (the delay
    pattern applied to one BOS row followed by PAD rows)."""
    delay = np.asarray(data["delay_pattern"])
    M = int(delay.max())
    t = np.arange(M)[:, None]
    return np.where(t <= delay[None, :], data["audio_bos_value"],
                    data["audio_pad_value"]).astype(np.int64)


def input_rows(codes: np.ndarray, data: dict) -> tuple[np.ndarray, list]:
    """The delayed rows the decode loop fed while producing ``codes [T, C]``
    (undelayed, as served): rows ``0 .. T - 1``.  Rows below ``max_delay``
    are the template; row r >= max_delay, channel c is
    ``codes[r - 1 - delay[c], c]``.  Returns (rows, the (row, channel) pairs
    that the served codes do not hold: a channel whose delay is the largest
    drops its first token, at row ``max_delay``)."""
    delay = np.asarray(data["delay_pattern"])
    M = int(delay.max())
    T, C = codes.shape
    rows = np.zeros((T, C), np.int64)
    rows[:M] = template(data)[: min(M, T)]
    missing = []
    for r in range(M, T):
        for c in range(C):
            j = r - 1 - int(delay[c])
            if j >= 0:
                rows[r, c] = codes[j, c]
            else:
                missing.append((r, c))
    return rows, missing


def served_positions(codes: np.ndarray, data: dict) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The (row, channel, token) of every token that the decode loop chose
    (rows ``max_delay .. T``) and the served codes hold: the row whose
    prediction it is, its channel and the token."""
    delay = np.asarray(data["delay_pattern"])
    M = int(delay.max())
    T, C = codes.shape
    r = np.arange(M, T + 1)[:, None].repeat(C, 1)
    c = np.arange(C)[None, :].repeat(len(r), 0)
    j = r - 1 - delay[None, :]
    keep = j >= 0
    return r[keep], c[keep], codes[j[keep], c[keep]]
