#!/usr/bin/env python3
"""Find the op at which a batched stream leaves its single-stream run.

Builds ``chip_smoke.py``'s pruned full-width model (``dia_1_6b_config()`` in
bf16 with the seed weights, ``prune_block_sparse(0.5, (256, 256),
scope="module")``; with ``--float`` the float model, unpruned) and, for each
named lane of the first ``--streams`` of the four texts of its ``batched``
path, runs ``chip_smoke.batch_lane_probe``: the greedy batched run
and the lane's single-stream run recorded op by op over the conditioning and
the first decode steps, the lane's rows compared bit for bit.  Prints one JSON
line per lane (the first differing op, its largest difference, every op that
differs), and with ``--frames`` one more: for how many frames each batched lane
equals its single-stream run over ``--max-tokens`` tokens; then the card's
name and power limit.

``--root PATH`` imports the package from another tree (for the parent commit:
``git archive HEAD dia_tts_prune_tpu_torch | tar -x -C _parent``, a git-ignored
directory), so the parent's and this tree's runs can share one call.

Run on the card from the repository root:
``python3 tools/torch_batch_lane_probe.py [--root _parent] [--float] [--streams 2]
[--lanes 0 1] [--frames]``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=Path, default=REPO,
                    help="tree whose dia_tts_prune_tpu_torch is probed")
    ap.add_argument("--lanes", type=int, nargs="+", default=[2])
    ap.add_argument("--steps", type=int, default=None, help="decode steps compared op by op")
    ap.add_argument("--frames", action="store_true",
                    help="also compare every lane's codes with its single-stream run")
    ap.add_argument("--max-tokens", type=int, default=192)
    ap.add_argument("--float", action="store_true", help="the float model, not pruned")
    ap.add_argument("--streams", type=int, default=4, choices=(2, 3, 4))
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # noqa: E402  (the probe, the seed weights, the texts' settings)

    sys.path.insert(0, str(args.root.resolve()))
    import numpy as np
    import torch

    import dia_tts_prune_tpu_torch
    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config

    if not torch.cuda.is_available():
        print("torch_batch_lane_probe: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dia_1_6b_config()
    dia = Dia(cfg, chip_smoke.seed_weights(torch, cfg), "bfloat16", device="cuda")
    if not args.float:
        dia.prune_block_sparse(0.5, chip_smoke.SPARSE_BLOCK, scope="module")
    texts = [chip_smoke.FULL_WIDTH_TEXT, *chip_smoke.BATCHED_TEXTS][: args.streams]
    root = str(Path(dia_tts_prune_tpu_torch.__file__).resolve().parents[1])
    for lane in args.lanes:
        kw = {} if args.steps is None else {"steps": args.steps}
        rec = chip_smoke.batch_lane_probe(torch, dia, texts, lane, **kw)
        print(json.dumps({"root": root, "float": args.float, "streams": len(texts), **rec}),
              flush=True)
    if args.frames:
        kw = dict(max_tokens=args.max_tokens, temperature=0.0)
        batch = dia.generator.generate_tokens_batch(texts, **kw)
        equal = []
        for b, t in zip(batch, texts):
            s = dia.generate_codes(t, **kw)
            n = min(b.shape[0], s.shape[0])
            diff = np.flatnonzero((b[:n] != s[:n]).any(axis=1))
            equal.append(int(diff[0]) if diff.size else n)
        print(json.dumps({"root": root, "frames": [int(b.shape[0]) for b in batch],
                          "frames_equal_single_stream": equal}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
