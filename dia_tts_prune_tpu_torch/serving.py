"""Dynamic request batching for concurrent serving (counterpart of
``dia_tts_prune_tpu/serving.py``).

A decode step reads every weight once whatever the number of streams, so N
concurrent requests decoded together cost little more than one: concurrent
requests are coalesced into one ``Dia.generate_batch`` call.

* Requests queue with a compatibility key, the sampling configuration one
  batched loop shares: (max_tokens, cfg_scale, temperature, top_p,
  cfg_filter_top_k).  Seeds are not part of it: each stream samples from its
  own generator inside the batched loop, so a seeded request returns its
  single-stream audio whatever shares its batch.
* One worker thread takes the oldest request, waits up to ``max_wait_ms``
  for compatible companions, and runs the group: ``Dia.generate`` for a lone
  request, ``Dia.generate_batch`` otherwise (per-stream seeds and voice
  prompts ride along).  Results and exceptions go back through per-request
  events.
* ``stats`` counts requests, groups, batched requests and the largest group,
  and the CUDA graph captures the groups made (``captures``,
  ``capture_seconds``): a group's stream count and sampling scalars are part
  of the decode loop's graph key, and only ``generate.GRAPH_CACHE`` keys
  are kept.

One worker is enough: the card runs one call's device work at a time
(``DiaGenerator.lock``), so more workers would only queue there.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class _Request:
    text: str
    key: tuple
    kwargs: dict[str, Any]
    audio_prompt: Any = None
    audio_prompt_text: str | None = None
    done: threading.Event = field(default_factory=threading.Event)
    result: np.ndarray | None = None
    error: BaseException | None = None


class DynamicBatcher:
    """Coalesce concurrent ``generate`` calls into batched decode loops."""

    def __init__(self, dia, max_batch: int = 8, max_wait_ms: float = 50.0):
        self._dia = dia
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self._q: deque[_Request] = deque()
        self._cond = threading.Condition()
        self._running = True
        self.stats = {"requests": 0, "batches": 0, "batched_requests": 0, "max_group": 0,
                      "captures": 0, "capture_seconds": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dia-dynamic-batcher")
        self._worker.start()

    def generate(
        self,
        text: str,
        max_tokens: int = 1024,
        cfg_scale: float = 3.0,
        temperature: float = 1.3,
        top_p: float = 0.95,
        cfg_filter_top_k: int = 35,
        audio_prompt=None,
        audio_prompt_text: str | None = None,
        seed: int | None = None,
        timeout: float = 600.0,
    ) -> np.ndarray | None:
        """Blocking generate; safe to call from many threads at once.
        Requests whose (max_tokens, cfg_scale, temperature, top_p, top_k)
        match may share one batched decode; others run in their own groups."""
        if not self._running:
            raise RuntimeError("batcher is shut down")
        key = (int(max_tokens), float(cfg_scale), float(temperature), float(top_p),
               int(cfg_filter_top_k))
        req = _Request(
            text=text, key=key,
            kwargs=dict(max_tokens=int(max_tokens), cfg_scale=float(cfg_scale),
                        temperature=float(temperature), top_p=float(top_p),
                        cfg_filter_top_k=int(cfg_filter_top_k), seed=seed),
            audio_prompt=audio_prompt, audio_prompt_text=audio_prompt_text)
        with self._cond:
            self._q.append(req)
            self.stats["requests"] += 1
            self._cond.notify_all()
        if not req.done.wait(timeout):
            raise TimeoutError("generation timed out")
        if req.error is not None:
            raise req.error
        return req.result

    def shutdown(self) -> None:
        """Stop taking requests once the queue is empty, and join the worker."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        self._worker.join(timeout=5)

    def _take_group(self) -> list[_Request] | None:
        """The oldest request plus compatible companions, waiting up to
        ``max_wait_s`` for stragglers (None once shut down and drained)."""
        with self._cond:
            while self._running and not self._q:
                self._cond.wait(timeout=0.2)
            if not self._running and not self._q:
                return None
            head = self._q.popleft()
            deadline = time.monotonic() + self.max_wait_s
            group = [head]
            while len(group) < self.max_batch:
                rest = deadline - time.monotonic()
                took = False
                for r in list(self._q):  # already-queued compatible requests first
                    if r.key == head.key and len(group) < self.max_batch:
                        self._q.remove(r)
                        group.append(r)
                        took = True
                if len(group) >= self.max_batch or rest <= 0:
                    break
                if not took:
                    self._cond.wait(timeout=min(rest, 0.01))
            return group

    def _run(self) -> None:
        while (group := self._take_group()) is not None:
            self._execute(group)

    def _execute(self, group: list[_Request]) -> None:
        self.stats["batches"] += 1
        self.stats["max_group"] = max(self.stats["max_group"], len(group))
        try:
            with self._dia.generator.lock:  # last_stats below is this group's
                if len(group) == 1:
                    r = group[0]
                    r.result = self._dia.generate(
                        r.text, audio_prompt=r.audio_prompt,
                        audio_prompt_text=r.audio_prompt_text, **r.kwargs)
                else:
                    self.stats["batched_requests"] += len(group)
                    kw = dict(group[0].kwargs)
                    kw.pop("seed", None)  # seeds are per stream, not per batch
                    prompts = [r.audio_prompt for r in group]
                    have_prompts = any(p is not None for p in prompts)
                    outs = self._dia.generate_batch(
                        [r.text for r in group],
                        audio_prompts=prompts if have_prompts else None,
                        audio_prompt_texts=([r.audio_prompt_text for r in group] if have_prompts
                                            else None),
                        seeds=[r.kwargs.get("seed") for r in group],
                        **kw)
                    for r, out in zip(group, outs):
                        r.result = out
                run = self._dia.generator.last_stats
                if run is not None:
                    self.stats["captures"] += run.captures
                    self.stats["capture_seconds"] += run.capture_seconds
        except Exception as e:  # noqa: BLE001 — delivered to each caller
            for r in group:
                r.error = e
        finally:
            for r in group:
                r.done.set()
