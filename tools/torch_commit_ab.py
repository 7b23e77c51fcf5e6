#!/usr/bin/env python3
"""What the decode step's K/V commit costs, by the way it indexes the cache.

``models/dia.py::decode_step`` writes each row's K/V at that row's own slot
(``write_slots``, ``_commit``).  This A/B runs ``chip_smoke.py``'s
full-width model (``dia_1_6b_config()`` in bf16 with the seed weights)
single-stream and greedy on the graph loop with two versions of the commit,
each in turn, in one process:

* ``flat`` — the port's own: the cache's row and slot axes viewed as one,
  one ``index_copy_`` a cache tensor at ``b * cache_len + slot[b]``;
* ``put``  — ``index_put_`` at the (row, slot) pairs, the rows an
  ``arange`` made once a step.

Both write the same values, so the codes must be equal.  The float route
runs first, then the same model after ``quantize_int8()`` (int8 caches: four
cache tensors a layer).  The order within a route is put, flat, flat, put,
twice, so a drift of the card's clocks shows as a difference between a
version's readings.  Each version's keys are captured anew; its last ``--runs`` calls
of ``--tokens`` tokens are timed.  Per reading: host ms a step, device ms a
replayed step (CUDA events around the replays), nodes a step in the 16-step
graph, and whether the codes equal the route's first reading.  Prints one
JSON line a reading, one of all readings, then the card's name and power
limit.

Run on the card from the repository root:
``python3 tools/torch_commit_ab.py [--tokens 512] [--runs 3]``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
ORDER = ("put", "flat", "flat", "put") * 2


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # noqa: E402  (the seed weights, the text, graph node counts)
    import numpy as np
    import torch

    import dia_tts_prune_tpu_torch.models.dia as model
    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.generate import GRAPH_STEPS

    if not torch.cuda.is_available():
        print("torch_commit_ab: CUDA is not available", file=sys.stderr)
        return 1
    flat = (model.write_slots, model._commit)

    def put_slots(write_slot, batch, cache_len, device):
        slots = flat[0](write_slot, batch, cache_len, device)[0]
        return slots, (torch.arange(batch, device=device), slots)

    def put_commit(cache, layer, rows_slots, k, v):
        at = slice(None) if layer is None else layer
        if isinstance(cache, model.QuantKVCache):
            (kq, ks), (vq, vs) = model.quantize_kv(k), model.quantize_kv(v)
            pairs = ((cache.k, kq), (cache.ks, ks), (cache.v, vq), (cache.vs, vs))
        else:
            pairs = ((cache.k, k), (cache.v, v))
        for dst, src in pairs:
            dst[(at, *rows_slots)] = src.to(dst.dtype)

    versions = {"flat": flat, "put": (put_slots, put_commit)}
    cfg = dia_1_6b_config()
    dia = Dia(cfg, chip_smoke.seed_weights(torch, cfg), "bfloat16", device="cuda")
    readings: dict = {}
    try:
        for route in ("bf16", "int8"):
            if route == "int8":
                dia.quantize_int8()
            gen = dia.generator  # quantizing builds the model's generator anew
            first = None
            for name in ORDER:
                model.write_slots, model._commit = versions[name]
                gen._graphs.clear()
                torch.cuda.synchronize()
                codes = dia.generate_codes(chip_smoke.FULL_WIDTH_TEXT, max_tokens=args.tokens,
                                           temperature=0.0)  # captures this version's graphs
                host, dev = [], []
                for _ in range(args.runs):
                    codes = dia.generate_codes(chip_smoke.FULL_WIDTH_TEXT,
                                               max_tokens=args.tokens, temperature=0.0)
                    st = gen.last_stats
                    host.append(1e3 * st.wall_seconds / st.decode_steps)
                    dev.append(st.device_ms_per_replayed_step)
                buffers = next(reversed(gen._graphs.values()))
                first = codes if first is None else first
                rec = {"route": route, "version": name, "ms_per_step": statistics.median(host),
                       "device_ms_per_step": statistics.median(dev),
                       "nodes_per_step": chip_smoke.graph_nodes(torch, buffers.graph)
                       / GRAPH_STEPS,
                       "codes_equal_first": bool(np.array_equal(codes, first))}
                readings.setdefault(route, []).append(rec)
                print(json.dumps(rec), flush=True)
    finally:
        model.write_slots, model._commit = flat
    print(json.dumps({"tokens": args.tokens, "runs": args.runs, "readings": readings}),
          flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no card")
    ok = all(r["codes_equal_first"] for rs in readings.values() for r in rs)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
