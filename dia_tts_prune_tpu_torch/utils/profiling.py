"""Profiling and observability helpers (counterpart of
``dia_tts_prune_tpu/utils/profiling.py``).

* ``trace(...)`` — context manager around a ``torch.profiler`` session (CPU
  and, where there is one, CUDA activity), exported as a Chrome trace;
* ``annotate(name)`` — ``torch.profiler.record_function``, labelling
  conditioning / prefill / decode regions inside a trace;
* ``GenerationStats`` — tokens/s and realtime-factor counters computed on the
  host from step counts, and what the decode loop reports of itself: which
  loop ran (``eager`` or ``graph``), the steps whose launches the host issued,
  the CUDA graph replays, capture seconds and the device time of the replays;
* ``memory_stats()`` — per-device allocator statistics of the CUDA devices
  (``torch.cuda.memory_stats``); an empty list without one, as the JAX
  function returns no stats where its backend reports none.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

DAC_FRAME_RATE = 44100.0 / 512.0


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace"):
    """Profile the enclosed block; the Chrome trace goes to
    ``log_dir/trace.json``.  Yields the profiler (``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region inside a profiler trace (a no-op outside one)."""
    return torch.profiler.record_function(name)


@dataclass
class GenerationStats:
    """Host-side throughput counters for a generation call, and the decode
    loop's account of itself (``decode_loop`` fills them)."""

    start_time: float = field(default_factory=time.perf_counter)
    prefill_steps: int = 0
    decode_steps: int = 0
    end_time: float | None = None
    loop: str = ""  # "eager" or "graph"
    host_steps: int = 0  # steps whose kernels the host launched: eager, and captured
    graph_steps: int = 0  # steps a captured CUDA graph holds
    replays: int = 0  # of the graph_steps graph
    step_replays: int = 0  # of the one-step graph (the rest of a stream's segment)
    captures: int = 0
    capture_seconds: float = 0.0
    # CUDA events around each replay; the stream is empty when one is launched,
    # so this includes the device's wait for the launch (replay_launch_seconds)
    replay_device_seconds: float = 0.0
    replay_launch_seconds: float = 0.0  # host time inside CUDAGraph.replay()

    def finish(self, decode_steps: int, prefill_steps: int = 0) -> "GenerationStats":
        self.decode_steps = decode_steps
        self.prefill_steps = prefill_steps
        self.end_time = time.perf_counter()
        return self

    @property
    def wall_seconds(self) -> float:
        return (self.end_time or time.perf_counter()) - self.start_time

    @property
    def tokens_per_second(self) -> float:
        return self.decode_steps / max(self.wall_seconds, 1e-9)

    @property
    def realtime_factor(self) -> float:
        return self.tokens_per_second / DAC_FRAME_RATE

    @property
    def device_ms_per_replayed_step(self) -> float | None:
        """Device time of one step inside a replay (a replay runs
        ``graph_steps`` steps, those past the stop included, or one)."""
        steps = self.replays * self.graph_steps + self.step_replays
        return 1e3 * self.replay_device_seconds / steps if steps else None

    def as_dict(self) -> dict:
        return {
            "decode_steps": self.decode_steps,
            "prefill_steps": self.prefill_steps,
            "wall_seconds": round(self.wall_seconds, 4),
            "tokens_per_second": round(self.tokens_per_second, 2),
            "realtime_factor": round(self.realtime_factor, 4),
            "loop": self.loop,
            "host_steps": self.host_steps,
            "graph_steps": self.graph_steps,
            "replays": self.replays,
            "step_replays": self.step_replays,
            "captures": self.captures,
            "capture_seconds": round(self.capture_seconds, 4),
            "replay_launch_seconds": round(self.replay_launch_seconds, 4),
            "device_ms_per_replayed_step": self.device_ms_per_replayed_step,
        }


def memory_stats() -> list[dict]:
    """Per-device memory stats of the CUDA devices (none on the CPU)."""
    out = []
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        })
    return out
