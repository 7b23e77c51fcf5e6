"""The traced window of a ``--trace 1`` run: one ``torch.profiler`` session
(CPU and CUDA activity) over a stretch of the cell's load just after the
measured window has closed, reduced to what the per-layer metrics read.

The profiler is kept out of the measured window, whose counters the other
per-layer metrics read: preparing it takes 9-13 s on the card, reducing its
record as long again, and while it records, its instrumentation of the
kernels inside CUDA graphs makes every graph launch 20-40 ms slower (the
``cudaGraphLaunch`` gaps of the traced breakdown).  So the traced window's
idle share counts that overhead as idle; its kernels' own device times are
as measured.

From the profiler's CUDA activity: every kernel, copy and set with its start
and length (the kernels inside CUDA graph replays included, where the
profiler reports them); the device's busy time is the union of those
intervals inside the traced window.  The window's ends are those of the
harness's own ``bench.traced`` span.  An idle gap (a stretch of the window
with nothing running on the device) is named by the innermost host event
that covers its middle.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

SPAN = "bench.traced"


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


@dataclass
class Summary:
    """What the traced window held: device intervals [(name, start, end)]
    in ns, host events likewise, and the window's ends."""

    start: int
    end: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.end - self.start) / 1e9

    def busy_s(self) -> float:
        """Seconds in which some device activity ran, inside the window."""
        total, cur_s, cur_e = 0, None, None
        for _, s, e in sorted(self.device, key=lambda t: t[1]):
            s, e = max(s, self.start), min(e, self.end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total / 1e9

    def kernels(self, part: str) -> list[tuple[int, int]]:
        """(start, length) in ns of every device activity whose name holds ``part``."""
        return [(s, e - s) for n, s, e in self.device if part in n]

    def top_ops(self, k: int = 10) -> list:
        by: dict[str, int] = {}
        for n, s, e in self.device:
            by[n] = by.get(n, 0) + (e - s)
        top = sorted(by.items(), key=lambda t: -t[1])[:k]
        return [[_short(n), v / 1e9] for n, v in top]

    def idle_gaps(self, k: int = 10) -> list:
        """The ``k`` longest stretches with no device activity, each named by
        the innermost host event covering its middle."""
        iv = sorted((max(s, self.start), min(e, self.end)) for _, s, e in self.device)
        gaps, at = [], self.start
        for s, e in iv:
            if s > at:
                gaps.append((s - at, at, s))
            at = max(at, e)
        if self.end > at:
            gaps.append((self.end - at, at, self.end))
        gaps.sort(reverse=True)
        if not gaps:
            return []
        hs = np.array([s for _, s, _ in self.host], dtype=np.int64)
        he = np.array([e for _, _, e in self.host], dtype=np.int64)
        out = []
        for length, s, e in gaps[:k]:
            mid = (s + e) // 2
            name = "no host event"
            if len(hs):
                cover = np.nonzero((hs <= mid) & (he >= mid))[0]
                if len(cover):
                    name = self.host[int(cover[np.argmin((he - hs)[cover])])][0]
            out.append([_short(name), length / 1e9])
        return out


def _annotation(ev) -> bool:
    f = getattr(ev, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _short(name: str) -> str:
    return name if len(name) <= 96 else name[:93] + "..."


class Tracer:
    """One profiler session a process (a second session may see no device
    activity).  ``arm`` (in set-up) prepares the profiler, which is the slow
    part of starting it; ``start`` / ``stop`` bracket the traced window;
    ``summary`` reduces it.  Disabled, every call does nothing."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.prof = None
        self.span = None
        self.active = False
        self.done = False
        self.timings: dict = {}

    def arm(self) -> None:
        if not self.enabled or self.prof is not None:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        self.prof = torch.profiler.profile(
            activities=acts, schedule=torch.profiler.schedule(wait=0, warmup=1, active=1))
        self.prof.start()  # the warm-up phase: the profiler prepared, nothing kept
        self.timings["arm_s"] = time.perf_counter() - t0

    def start(self) -> None:
        if not self.enabled or self.active or self.done:
            return
        self.arm()
        t0 = time.perf_counter()
        self.prof.step()  # warm-up to recording
        self.span = torch.profiler.record_function(SPAN)
        self.span.__enter__()
        self.active = True
        self.timings["start_s"] = time.perf_counter() - t0

    def stop(self) -> None:
        if not self.active:
            return
        t0 = time.perf_counter()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.stop()
        self.active, self.done = False, True
        self.timings["stop_s"] = time.perf_counter() - t0

    def summary(self) -> Summary | None:
        if not self.done:
            return None
        events = self.prof.profiler.kineto_results.events()
        device, host, start, end = [], [], None, None
        for ev in events:
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            name = ev.name()
            if str(ev.device_type()).endswith("CPU"):
                if name == SPAN:
                    start, end = s, e
                elif not name.startswith("ProfilerStep"):  # the profiler's own step span
                    host.append((name, s, e))
            elif name != SPAN and not _annotation(ev):  # a span's mark on the device's
                device.append((name, s, e))             # timeline is no device work
        if start is None:
            return None
        return Summary(start=start, end=end, device=device, host=host)
