#!/usr/bin/env python3
"""What running every float decode contraction at a fixed 64 rows costs.

``ops/modules.py::fixed_rows_matmul`` computes each float contraction of up
to 64 rows on the card at exactly 64 rows (zero rows padded on), so that
cuBLAS sums a row in one order whatever the batch.  This A/B runs
``chip_smoke.py``'s full-width float model (``dia_1_6b_config()`` in bf16
with the seed weights) single-stream and greedy on the graph loop with three
versions of that function, each in turn, in one process:

* ``pad``   — the port's own (``F.pad`` to 64 rows, then the product);
* ``none``  — the plain ``x2 @ w2`` at the call's own row count;
* ``empty`` — the rows copied into a fresh ``torch.empty`` of 64 rows (the
  other rows left as they are: a row's sums never read another row).

Each version's keys are captured anew; its last ``--runs`` calls of
``--tokens`` tokens are timed.  The order is ABC then CBA, so a drift of the
card's clocks shows as a difference between a version's two readings.  Per
reading: host ms a step (the call's wall time over its steps), device ms a
replayed step (CUDA events around the replays), nodes a step in the 16-step
graph, and whether the codes equal the first reading of each version run so
far (``pad`` and ``empty`` sum each row at 64 rows alike; ``none`` sums in
cuBLAS's order for its own row count, so its greedy codes may part at a near
tie).  Prints one JSON line a reading, one of all readings, then the card's
name and power limit.

Run on the card from the repository root:
``python3 tools/torch_float_rows_ab.py [--tokens 512] [--runs 3]``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ORDER = ("none", "pad", "empty", "empty", "pad", "none")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # noqa: E402  (the seed weights, the text, graph node counts)
    import numpy as np
    import torch

    import dia_tts_prune_tpu_torch.ops.modules as modules
    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.generate import GRAPH_STEPS

    if not torch.cuda.is_available():
        print("torch_float_rows_ab: CUDA is not available", file=sys.stderr)
        return 1
    pad = modules.fixed_rows_matmul

    def empty(x2, w2):
        x = torch.empty((modules.MAX_ROWS, x2.shape[1]), dtype=x2.dtype, device=x2.device)
        x[: x2.shape[0]] = x2
        return (x @ w2)[: x2.shape[0]]

    versions = {"pad": pad, "none": lambda x2, w2: x2 @ w2, "empty": empty}
    cfg = dia_1_6b_config()
    dia = Dia(cfg, chip_smoke.seed_weights(torch, cfg), "bfloat16", device="cuda")
    gen = dia.generator
    first, readings = {}, {}
    try:
        for name in ORDER:
            modules.fixed_rows_matmul = versions[name]
            gen._graphs.clear()
            torch.cuda.synchronize()
            codes = dia.generate_codes(chip_smoke.FULL_WIDTH_TEXT, max_tokens=args.tokens,
                                       temperature=0.0)  # captures this version's graphs
            host, dev = [], []
            for _ in range(args.runs):
                codes = dia.generate_codes(chip_smoke.FULL_WIDTH_TEXT, max_tokens=args.tokens,
                                           temperature=0.0)
                st = gen.last_stats
                host.append(1e3 * st.wall_seconds / st.decode_steps)
                dev.append(st.device_ms_per_replayed_step)
            buffers = next(reversed(gen._graphs.values()))
            first.setdefault(name, codes)
            rec = {"version": name, "ms_per_step": statistics.median(host),
                   "device_ms_per_step": statistics.median(dev),
                   "nodes_per_step": chip_smoke.graph_nodes(torch, buffers.graph) / GRAPH_STEPS,
                   "codes_equal": {k: bool(np.array_equal(codes, v)) for k, v in first.items()}}
            readings.setdefault(name, []).append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        modules.fixed_rows_matmul = pad
    print(json.dumps({"tokens": args.tokens, "runs": args.runs, "readings": readings}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
