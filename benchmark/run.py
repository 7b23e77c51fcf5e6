"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's weights and requests from ``--seed``, builds the program
(``dia_tts_prune_tpu_torch``) on one CUDA device, warms every shape the
cell's traffic uses, measures for ``--seconds`` seconds, checks what the
timed path produced against the plain reference, and prints one JSON object
as the last line of standard output: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics from a profiled
part of the window.  The numbers compared and their limits are the last lines
of standard error and the last key of the result.  Exits non-zero, with no
result, where there is no CUDA device, or where JAX or the JAX package was
loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH_DIR = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH_DIR), str(BENCH_DIR.parent)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=int, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import harness

    harness.set_cache_dirs()
    import torch

    cell = harness.load_cell(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"run: this cell needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, shown = harness.run(args.workload, args.seed, args.seconds, bool(args.trace),
                                T_START, device="cuda", log=log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"run: modules of JAX or the JAX package were loaded: {', '.join(bad)}")
        return 3
    for name, v in shown.items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
