#!/usr/bin/env python3
"""The float decode step before and after the dense-rows and RMSNorm kernels,
across captures.

A float decode step sends its 145 contractions through ``dense_general(...,
decode=True)`` and its 55 norms through ``rms_norm``.  This A/B runs
``chip_smoke.py``'s full-width float model (``dia_1_6b_config()`` in bf16
with the seed weights) single-stream and greedy on the graph loop with three
versions of those two functions, each in turn, in one process:

* ``kernels`` — the port's own: ``ops.kernels.dense_rows`` and
  ``ops.kernels.rms_norm`` (a row's bits independent of the row count);
* ``before`` — the route these kernels replaced: cuBLAS at the call's rows
  padded with zero rows to 64 (``fixed_rows_matmul``), the mean of squares
  as the mean of 16 partial means (ATen reductions);
* ``cublas`` — cuBLAS at the call's own row count and the plain ATen norm
  (their bits depend on the row count: a library reference only).

Each reading of a version captures its graphs ``--captures`` times anew (the
kept graphs dropped before each), and times ``--runs`` calls of ``--tokens``
tokens from each capture, so the spread across captures shows apart from the
spread across replays of one capture.  The order is ABC then CBA, so a drift
of the card's clocks shows as a difference between a version's two readings.
Per capture: device ms a replayed step (CUDA events around the replays), host
ms a step (the call's wall time over its steps); per reading: nodes a step in
the 16-step graph, and whether the codes equal the first reading of each
version run so far (the versions sum in other orders, so their greedy codes
may part at a near tie).  Prints one JSON line a reading, one of all
readings, then the card's name and power limit.

Run on the card from the repository root:
``python3 tools/torch_float_rows_ab.py [--tokens 512] [--runs 3] [--captures 3]``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ORDER = ("before", "kernels", "cublas", "cublas", "kernels", "before")
PAD_ROWS = 64  # the retired route's row count
NORM_PARTS = 16  # the retired norm's partial means


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--captures", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # noqa: E402  (the seed weights, the text, graph node counts)
    import numpy as np
    import torch
    import torch.nn.functional as F

    import dia_tts_prune_tpu_torch.models.dia as mdia
    import dia_tts_prune_tpu_torch.ops.modules as modules
    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.generate import GRAPH_STEPS
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    if not torch.cuda.is_available():
        print("torch_float_rows_ab: CUDA is not available", file=sys.stderr)
        return 1

    def pad(x2, w2):
        rows = x2.shape[0]
        if rows > PAD_ROWS:
            raise ValueError(f"the retired route took at most {PAD_ROWS} rows, got {rows}")
        return (F.pad(x2, (0, 0, 0, PAD_ROWS - rows)) @ w2)[:rows]

    def parts_norm(x, scale, eps):
        D = x.shape[-1]
        x32 = x.float()
        var = x32.square().unflatten(-1, (NORM_PARTS, D // NORM_PARTS)).mean(-1).mean(
            -1, keepdim=True)
        return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)

    def plain_norm(x, scale, eps):
        x32 = x.float()
        var = x32.square().mean(-1, keepdim=True)
        return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)

    own = (modules.dense_rows, mdia.rms_norm)
    versions = {"kernels": own, "before": (pad, parts_norm),
                "cublas": (lambda x2, w2: x2 @ w2, plain_norm)}
    cfg = dia_1_6b_config()
    dia = Dia(cfg, chip_smoke.seed_weights(torch, cfg), "bfloat16", device="cuda")
    gen = dia.generator
    first, readings = {}, {}

    def call():
        return dia.generate_codes(chip_smoke.FULL_WIDTH_TEXT, max_tokens=args.tokens,
                                  temperature=0.0)

    try:
        for name in ORDER:
            modules.dense_rows, mdia.rms_norm = versions[name]
            captures = []
            for _ in range(args.captures):
                gen._graphs.clear()
                torch.cuda.synchronize()
                reset_launch_counts()
                codes = call()  # captures this version's graphs
                counts = launch_counts()
                host, dev = [], []
                for _ in range(args.runs):
                    codes = call()
                    st = gen.last_stats
                    host.append(1e3 * st.wall_seconds / st.decode_steps)
                    dev.append(st.device_ms_per_replayed_step)
                captures.append({"device_ms_per_step": statistics.median(dev),
                                 "device_ms_runs": dev, "ms_per_step": statistics.median(host),
                                 "capturing_call_launches": {
                                     k: counts[k] for k in ("dense_rows", "rms_norm")}})
            buffers = next(reversed(gen._graphs.values()))
            first.setdefault(name, codes)
            dev_caps = [c["device_ms_per_step"] for c in captures]
            rec = {"version": name, "captures": captures,
                   "device_ms_per_step_by_capture": dev_caps,
                   "capture_spread_ms": max(dev_caps) - min(dev_caps),
                   "replay_spread_ms": max(max(c["device_ms_runs"]) - min(c["device_ms_runs"])
                                           for c in captures),
                   "nodes_per_step": chip_smoke.graph_nodes(torch, buffers.graph) / GRAPH_STEPS,
                   "codes_equal": {k: bool(np.array_equal(codes, v)) for k, v in first.items()}}
            readings.setdefault(name, []).append(rec)
            print(json.dumps(rec), flush=True)
    finally:
        modules.dense_rows, mdia.rms_norm = own
    print(json.dumps({"tokens": args.tokens, "runs": args.runs, "captures": args.captures,
                      "readings": readings}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
