"""The one request generator: every traffic mix is a data file of parameters
(``traffic/<mix>.json``) that this module reads.

Every seed gets the same work in another order.  A mix fixes a set of
``count`` audio lengths (the quantiles of a lognormal at (i + 1/2) / count,
clipped).  Requests come in cycles of ``count``: each cycle is a permutation
of the same lengths, drawn from the seed, so any seed's cycle holds the same sizes.  What a seed
draws beyond the order is content: the words of each script, each sampled
request's sampling seed.  Which length slots decode greedily is fixed by the
slot (every ``greedy_every``-th, the longest among them), so each seed has
the same greedy requests, whose tokens the correctness check can judge.

A script is a two-speaker dialogue (``[S1]`` / ``[S2]`` turns of 4-12 words)
whose length in bytes is ``text_bytes_per_s`` x the request's audio
seconds, clipped to ``[text_min, text_max]``; the request asks for that many
seconds of audio (``max_tokens`` frames at the codec's frame rate).  Under
seeded random weights a sampled request runs to that length; a greedy one
may end earlier on EOS under some seeds' weights.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from statistics import NormalDist

import numpy as np

FRAME_RATE = 44100.0 / 512.0  # codec frames per second of audio

WORDS = (
    "the a and to of in it is you that we he she they was for on are with as at be this have "
    "from or one had by word but not what all were when your can said there use an each which "
    "do how their if will up other about out many then them these so some her would make like "
    "him into time has look two more write go see number no way could people my than first "
    "water been call who oil its now find long down day did get come made may part over new "
    "sound take only little work know place year live me back give most very after thing our "
    "just name good sentence man think say great where help through much before line right too "
    "mean old any same tell boy follow came want show also around form three small set put end "
    "does another well large must big even such because turn here why ask went men read need "
    "land different home us move try kind hand picture again change off play spell air away "
    "animal house point page letter mother answer found study still learn should world high "
    "every near add food between own below country plant last school father keep tree never "
    "start city earth eye light thought head under story saw left few while along might close "
    "something seem next hard open example begin life always those both paper together got "
    "group often run important until children side feet car mile night walk white sea began "
    "grow took river four carry state once book hear stop without second later miss idea "
    "enough eat face watch far really almost let above girl sometimes mountain cut young talk "
    "soon list song being leave family"
).split()


@dataclass(frozen=True)
class Request:
    """One request of a mix: its place in the sequence, its slot in the
    fixed set, its script and what it asks for."""

    index: int
    slot: int
    text: str
    audio_s: float  # the seconds of audio asked for
    max_tokens: int  # the same, in codec frames
    greedy: bool
    seed: int  # the request's sampling seed (unused when greedy)


def lengths_s(mix: dict) -> list[float]:
    """The mix's fixed set of audio lengths in seconds, ascending."""
    spec = mix["lengths"]
    n = spec["count"]
    dist = NormalDist(math.log(spec["median_s"]), spec["sigma"])
    return [min(spec["max_s"], max(spec["min_s"], math.exp(dist.inv_cdf((i + 0.5) / n))))
            for i in range(n)]


def greedy_slots(mix: dict) -> set[int]:
    """The length slots that decode greedily: every ``greedy_every``-th,
    counted down from the longest, so the longest request is one of them."""
    n, every = mix["lengths"]["count"], mix["greedy_every"]
    return {i for i in range(n) if (n - 1 - i) % every == 0}


def text_bytes(mix: dict, audio_s: float) -> int:
    t = mix["text"]
    return int(min(t["max"], max(t["min"], round(t["bytes_per_s"] * audio_s))))


def script(rng: np.random.Generator, n_bytes: int) -> str:
    """A two-speaker dialogue of exactly ``n_bytes`` ASCII bytes."""
    parts, speaker, size = [], 0, 0
    while size < n_bytes:
        turn = [WORDS[i] for i in rng.integers(0, len(WORDS), int(rng.integers(4, 13)))]
        piece = ("[S1] " if speaker == 0 else "[S2] ") + " ".join(turn).capitalize() + ". "
        parts.append(piece)
        size += len(piece)
        speaker ^= 1
    text = "".join(parts)[:n_bytes].rstrip()
    return text + "." * (n_bytes - len(text))


def requests(mix: dict, seed: int):
    """The mix's requests for ``seed``, without end (cycles of ``count``)."""
    rng = np.random.default_rng(int(seed) & ((1 << 63) - 1))
    lengths, greedy = lengths_s(mix), greedy_slots(mix)
    n = len(lengths)
    index = 0
    while True:
        order = rng.permutation(n)
        for slot in order:
            slot = int(slot)
            audio_s = lengths[slot]
            yield Request(index=index, slot=slot,
                          text=script(rng, text_bytes(mix, audio_s)), audio_s=audio_s,
                          max_tokens=int(round(audio_s * FRAME_RATE)),
                          greedy=slot in greedy, seed=int(rng.integers(0, 2**31 - 1)))
            index += 1


def sampling_args(mix: dict, req: Request) -> dict:
    """The sampling keyword arguments of a request: the mix's (the API's
    defaults), temperature 0 for a greedy one."""
    s = mix["sampling"]
    return {"cfg_scale": s["cfg_scale"], "temperature": 0.0 if req.greedy else s["temperature"],
            "top_p": s["top_p"], "seed": req.seed}
