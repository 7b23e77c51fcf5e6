"""Readings for the limits of ``correct``: the program's and the control's.

    python3 benchmark/control.py --workload <cell> --seconds <s> \
        [--seeds 11,12,...] [--control-seeds 21,22,23] [--out FILE]

For each seed of ``--seeds`` one run of the cell as ``run.py`` makes it
(weights, requests, warm-up, a window of ``--seconds``), then the
comparison's readings (``logit_gap``, ``wave_diff``) against the plain
reference; for each seed of ``--control-seeds`` the same with the control
in the program's place: the program's own path one precision step below the
configuration's (the configuration's ``control``: int8 weights and caches
for the bf16 route, the fused pack with an int4 MLP where the route is the
int8 fused one), judged against the configuration's reference.  Each run is put through the harness's own
verdict under the configuration's ``check``: the program's runs have to come
out correct and the control's not, else the command exits 1.  One process,
so the kernels build once; one JSON line a reading on standard output (and
appended to ``--out``).  The benchmark's own runs never run the control.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def readings(cell_name: str, seed: int, seconds: int, control: bool, device,
             spec_path=None, traffic_dir=None) -> dict:
    """One run's readings (and its end-to-end numbers), the control's route
    in the program's place when ``control``."""
    import torch

    import correctness
    import harness
    from tracing import Tracer

    cell = harness.load_cell(cell_name, spec_path, traffic_dir)
    route = cell.config["control"] if control else None
    driver = harness.load_module(BENCH_DIR / "drivers" / f"{cell.mix['driver']}.py",
                                 f"bench_driver_{cell.mix['driver']}")
    ctx = harness.Context(cell=cell, seed=seed, seconds=seconds, trace=False,
                          device=torch.device(device), tracer=Tracer(False))
    t0 = time.perf_counter()
    dia = harness.build_dia(cell.config, seed, ctx.device, route)
    window = driver.run(ctx, dia)
    served, e2e, failed = window.served, window.end_to_end, window.failed
    del dia, window
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    chosen = correctness.sample(served, seed, cell.mix["check"]["requests"])
    r = correctness.judge(cell.config, cell.mix, seed, chosen, ctx.device, codec_control=control)
    ok, _ = correctness.verdict(r, cell.config["check"], failed)
    return {"workload": cell_name, "seed": seed, "kind": "control" if control else "program",
            "correct": ok, "route": route or cell.config["route"], "failed": failed,
            "e2e": e2e, "seconds": time.perf_counter() - t0, **r}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import harness

    harness.set_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    plan = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    wrong = 0
    for seed, control in plan:
        r = readings(args.workload, seed, args.seconds, control, "cuda")
        wrong += r["correct"] == control
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    if wrong:
        print(f"control: {wrong} run(s) on the wrong side of the limits", file=sys.stderr)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
