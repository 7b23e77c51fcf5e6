"""Host-side pipeline prefetching.

The reference leans on torch DataLoader workers to hide per-item DAC encoding
(finetune.py:414-421).  Here a background thread prepares the next batches
(WAV read, resample, DAC encode, delay transforms) while the accelerator runs
the current train step.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(iterable: Iterable[T], buffer_size: int = 2) -> Iterator[T]:
    """Yield from ``iterable`` with up to ``buffer_size`` items prepared ahead
    on a daemon thread.  Exceptions in the producer re-raise at the consumer.
    """
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    error: list[BaseException] = []

    def producer():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 — forwarded to consumer
            error.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if error:
                raise error[0]
            return
        yield item
