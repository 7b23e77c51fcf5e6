#!/usr/bin/env python3
"""Time the bf16 dense-rows kernel over its cluster plans and edited copies.

At the five weight shapes of a Dia-1.6B decode step (bf16 weight and x from
a seed) and each row count of ``--rows``, calls the kernel's C entry through
``ops.kernels.dense_rows.launch`` with clusters of 1, 2, 4, 8 and 16 blocks
(each block's K slice the whole stages that cover K), on the route the
wrapper picks for the shape, and prints one JSON line a case: the device µs
of each cluster (CUDA-graph replays over copies of the weight that together
exceed the L2, as a decode step finds them cold; ``chip_smoke.graph_ms``),
the cluster ``row_plan`` picks and the byte bound; then the card's name and
power limit.  ``row_plan``'s constants (``PLAN_BLOCKS``, ``MIN_SLICE``) come
from this sweep.

``--variants``: edited copies of ``csrc/dense_rows.cu``, each built by nvcc
into a library of its own and called through the same C entry at the
planned cluster only, in turns (base, a, b, ..., b, a, base), one JSON line
a case with each one's µs.  Probes of where the time goes (wrong outputs):
``empty`` — every block returns once set up; ``no_mma`` — no wgmma runs;
``no_merge`` — the ranks' partials are never merged or written; ``no_x`` —
x's TMA box is left out.  ``ring96`` — 96 KB of stages instead of 128.
``--old PATH``: an earlier ``dense_rows.cu`` (in a git-ignored directory)
timed beside them as ``old``, through the same entry and plan.

Run on the card from the repository root:
``python3 tools/torch_dense_rows_sweep.py [--rows 2 80] [--variants base empty ...]``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
CLUSTERS = (1, 2, 4, 8, 16)
# (old, new) text edits of csrc/dense_rows.cu
VARIANTS = {
    "base": [],
    "empty": [("  const int n_chunks = (k1 - k0 + KC - 1) / KC;\n",
               "  const int n_chunks = (k1 - k0 + KC - 1) / KC;\n  if (n_chunks >= 0) return;\n")],
    "no_mma": [("          wgmma<ROW_TILE * TB>(acc[t],", "          if (K < 0) wgmma<ROW_TILE * TB>(acc[t],")],
    "no_merge": [("  const int cpr = STRIP / n_ranks;\n", "  if (n_ranks > 0) return;\n  const int cpr = STRIP / n_ranks;\n")],
    "no_x": [("          bar_expect_tx(full + s, S::STAGE);", "          bar_expect_tx(full + s, W_BYTES);"),
             ("          tma_load(st + W_BYTES, &xmap, k, g0, full + s);\n", "")],
    "ring96": [("constexpr int RING_BYTES = 128 * 1024;", "constexpr int RING_BYTES = 96 * 1024;")],
}


def build_variants(names, old: Path | None = None) -> dict:
    """{name: the C entry of csrc/dense_rows.cu edited by VARIANTS[name]}, and
    ``old`` built from that source: one nvcc a library, all at once, into the
    build directory's ``sweep/``."""
    import ctypes
    import importlib

    from dia_tts_prune_tpu_torch.ops.kernels import _build

    dr = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.dense_rows")
    src = (_build.CSRC_DIR / "dense_rows.cu").read_text()
    out = _build.BUILD_DIR / "sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    texts = {"old": old.read_text()} if old else {}
    for name in names:
        text = src
        for a, b in VARIANTS[name]:
            if text.count(a) != 1:
                raise RuntimeError(f"variant {name}: edit anchor not found once: {a!r}")
            text = text.replace(a, b)
        texts[name] = text
    for name, text in texts.items():
        (out / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o",
             str(out / f"lib{name}.so"), str(out / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed\n{log.decode(errors='replace')}")
        fn = ctypes.CDLL(str(out / f"lib{name}.so")).dense_rows_fwd
        fn.argtypes, fn.restype = dr._ARGTYPES, ctypes.c_int
        fns[name] = fn
    return fns


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, nargs="+", default=[2, 80])
    ap.add_argument("--variants", nargs="+", default=None, choices=sorted(VARIANTS))
    ap.add_argument("--old", type=Path, default=None, help="an earlier dense_rows.cu")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke  # noqa: E402  (graph timing, the shapes, the bound)
    import torch

    if not torch.cuda.is_available():
        print("torch_dense_rows_sweep: CUDA is not available", file=sys.stderr)
        return 1
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    dr = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.dense_rows")
    fns = build_variants(args.variants or [], args.old) if args.variants or args.old else {}
    key = ("dense_rows", "dense_rows_fwd")
    g = torch.Generator(device="cuda").manual_seed(1)
    for name, (K, N) in chip_smoke.GEMV_SHAPES.items():
        n = max(2, min(64, -(-chip_smoke.COLD_BYTES // (2 * K * N))))
        ws = [(torch.randn(K, N, generator=g, device="cuda") / K ** 0.5).bfloat16()
              for _ in range(n)]
        for M in args.rows:
            x = torch.randn(M, K, generator=g, device="cuda").bfloat16()
            vec = dr.weight_route(N, ws[0].data_ptr())
            if vec == dr.TMA and not dr.x_by_tma(K, x.data_ptr()):
                vec = 8
            bound, _ = chip_smoke.bound(2 * (K * N + M * K + M * N), 2.0 * M * K * N, "bfloat16")
            rec = {"shape": name, "M": M, "vec": vec, "planned": list(dr.row_plan(K, N)),
                   "bound_us": 1e3 * bound}

            def time_at(cl, sl):
                turn = iter(range(1 << 30))
                return 1e3 * chip_smoke.graph_ms(
                    torch, lambda: dr.launch(x, ws[next(turn) % n], vec, cl, sl), iters=2 * n)

            if fns:
                order = [*fns, *reversed(fns)]
                us = {v: [] for v in fns}
                for v in order:
                    _build._functions[key] = fns[v]
                    us[v].append(time_at(*rec["planned"]))
                _build._functions.pop(key)
                rec["us_by_variant"] = us
            else:
                rec["us_by_cluster"] = {
                    cl: time_at(cl, -(-K // (cl * dr.STAGE_ROWS)) * dr.STAGE_ROWS)
                    for cl in CLUSTERS}
            print(json.dumps(rec), flush=True)
        del ws
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no card")
    return 0


if __name__ == "__main__":
    sys.exit(main())
