"""One run of one cell: set-up, the measured window, the per-layer metrics,
the comparison that decides ``correct``, and the result line.

Everything a cell is made of is found by name: its entry in
``BENCHMARK.json``, its configuration ``configs/<config>.json``, its traffic
mix ``traffic/<mix>.json``, the mix's driver ``drivers/<driver>.py`` (one a
kind of loop) and each per-layer metric's reader ``metrics/<metric>.py``.
A new cell, mix or metric is a new file and a new entry.

The program is the port, ``dia_tts_prune_tpu_torch``; the benchmark makes
the weights and the requests and hands them to it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dia_tts_prune_tpu")


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def load_module(path: Path, name: str):
    """A module of the benchmark from its file (metric files carry dots in
    their names, so they are loaded by path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not Path(path).is_file():
        raise FileNotFoundError(f"no benchmark module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name (the part before the first
    dot, compared whole) is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs() -> None:
    """Every cache of the program at a fixed path inside the checkout (the
    port's kernels already build into ``dia_tts_prune_tpu_torch/_build/``)."""
    cache = BENCH_DIR / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def host_load() -> dict:
    """A reading of the host's pace: the time (ms) a fixed Python loop takes
    on the calling thread, this process's CPU seconds, and the clock."""
    t0 = time.perf_counter()
    x = 0
    for i in range(200_000):
        x += i * i
    return {"t": time.perf_counter(), "probe_ms": 1e3 * (time.perf_counter() - t0),
            "cpu_s": time.process_time()}


def host_note(before: dict) -> str:
    """The host's pace between ``before`` (``host_load()``) and now: the
    probe at both ends, and the CPU seconds a second that this process took
    (near 1 where one interpreter thread paces a cell)."""
    after = host_load()
    wall = after["t"] - before["t"]
    return (f"host: probe {before['probe_ms']:.2f} -> {after['probe_ms']:.2f} ms, this process "
            f"{(after['cpu_s'] - before['cpu_s']) / max(wall, 1e-9):.2f} CPU s/s over "
            f"{wall:.1f} s")


@dataclass
class Cell:
    name: str
    entry: dict
    spec: dict
    config: dict
    mix: dict


def load_cell(name: str, spec_path: Path | None = None, traffic_dir: Path | None = None) -> Cell:
    """Cell ``name`` of ``BENCHMARK.json`` (or of another spec, whose
    configuration files are relative to its folder), with its configuration
    and its mix (``traffic_dir``, default ``benchmark/traffic``)."""
    spec_path = Path(spec_path or ROOT / "BENCHMARK.json")
    spec = read_json(spec_path)
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in {spec_path.name}")
    cfg = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = read_json(spec_path.parent / cfg["file"])
    mix = read_json(Path(traffic_dir or BENCH_DIR / "traffic") / f"{entry['traffic']}.json")
    return Cell(name, entry, spec, config, mix)


def build_dia(config: dict, seed: int, device, route: dict | None = None):
    """The program's model on the seed's weights, on ``route`` (the
    configuration's unless a control's is given): ``Dia`` in the route's
    compute dtype, then the route's packing."""
    import torch

    from dia_tts_prune_tpu_torch.api import Dia
    from dia_tts_prune_tpu_torch.config import DiaConfig
    from dia_tts_prune_tpu_torch.models.dac import DACConfig

    import weights

    route = route or config["route"]
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[route["compute_dtype"]]
    params = weights.dia_weights(config["dia"], seed, dtype, device)
    dac = dict(config["dac"])
    dac_cfg = DACConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in dac.items()})
    dia = Dia(DiaConfig.model_validate(config["dia"]), params, route["compute_dtype"],
              dac_params=weights.dac_weights(dac, seed, device), dac_config=dac_cfg,
              device=device)
    del params
    q = route.get("quantize", "none")
    if q == "int8":
        dia.quantize_int8(fused=route.get("fused", False),
                          fused_mlp_int4=route.get("fused_mlp_int4", False))
    elif q == "int4":
        dia.quantize_int4(group=route.get("group", 128))
    elif q != "none":
        raise ValueError(f"unknown packing {q!r}")
    return dia


@dataclass
class Window:
    """What a driver hands back: the window's ends, the end-to-end numbers,
    the requests as served, the counts, and the raw inputs of the per-layer
    metrics (``layer``)."""

    t_open: float
    end_to_end: dict
    served: list
    attempted: int
    failed: int
    layer: dict = field(default_factory=dict)
    notes: list = field(default_factory=list)


@dataclass
class Context:
    """What a driver and a metric reader are given."""

    cell: Cell
    seed: int
    seconds: int
    trace: bool
    device: object
    tracer: object = None
    window: Window | None = None
    summary: object = None  # trace.Summary of the traced window

    @property
    def mix(self) -> dict:
        return self.cell.mix

    @property
    def config(self) -> dict:
        return self.cell.config


def per_layer_names(cell: Cell) -> list[str]:
    """The per-layer metrics this cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(cell))
    out = []
    for m in cell.spec["per_layer"]:
        listed = m.get("workloads")
        if (listed is not None and cell.name in listed) or (listed is None and m["moves"] in e2e):
            out.append(m["name"])
    return out


def end_to_end_names(cell: Cell) -> list[str]:
    return [m["name"] for m in cell.spec["end_to_end"]
            if m.get("workloads") is None or cell.name in m["workloads"]]


def unit_of(cell: Cell, name: str) -> str:
    for m in cell.spec["end_to_end"] + cell.spec["per_layer"]:
        if m["name"] == name:
            return m["unit"]
    raise KeyError(name)


def device_info(device, peak: int) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
            "memory_peak_bytes": peak}


def run(name: str, seed: int, seconds: int, trace: bool, t_start: float, device=None,
        spec_path: Path | None = None, traffic_dir: Path | None = None,
        log=print) -> tuple[dict, dict]:
    """One run of cell ``name``.  Returns (the result line's object, the
    numbers compared with their limits)."""
    import torch

    import correctness
    from tracing import Tracer

    device = torch.device(device or "cuda")
    cell = load_cell(name, spec_path, traffic_dir)
    driver = load_module(BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py",
                         f"bench_driver_{cell.mix['driver']}")
    ctx = Context(cell=cell, seed=int(seed), seconds=int(seconds), trace=bool(trace),
                  device=device, tracer=Tracer(bool(trace)))
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    dia = build_dia(cell.config, ctx.seed, device)
    window = driver.run(ctx, dia)
    ctx.window = window
    for note in window.notes:
        log(note)
    setup_s = window.t_open - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    result_device = device_info(device, int(peak))
    breakdown = None
    if trace:
        ctx.summary = ctx.tracer.summary()
        for m in per_layer_names(cell):
            mod = load_module(BENCH_DIR / "metrics" / f"{m}.py", "bench_metric_" + m.replace(".", "_"))
            value = mod.read(ctx)
            if value is not None:
                metrics[m] = {"value": float(value), "unit": unit_of(cell, m)}
        if ctx.summary is not None:
            result_device["busy_s"] = ctx.summary.busy_s()
            result_device["window_s"] = ctx.summary.window_s
            breakdown = {"device_ops": ctx.summary.top_ops(),
                         "idle_gaps": ctx.summary.idle_gaps()}
        else:
            log("trace: the profiler saw no traced window")
    else:
        for m in end_to_end_names(cell):
            value = setup_s if m == "setup_s" else window.end_to_end.get(m)
            if value is not None:
                metrics[m] = {"value": float(value), "unit": unit_of(cell, m)}
    served, attempted, failed = window.served, window.attempted, window.failed
    ctx.window = None
    del dia, window
    ctx.tracer = None
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    chosen = correctness.sample(served, ctx.seed, cell.mix["check"]["requests"])
    readings = correctness.judge(cell.config, cell.mix, ctx.seed, chosen, device)
    ok, shown = correctness.verdict(readings, cell.config["check"], failed)
    log(f"readings: {readings}; the check took {time.perf_counter() - t_check:.3f} s")
    result = {"correct": bool(ok), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": result_device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = shown
    return result, shown
