#!/usr/bin/env python3
"""The float decode step with the dense-rows and RMSNorm kernels against an
earlier source of them and against the routes they replaced, across captures.

A float decode step sends its 145 contractions through ``dense_general(...,
decode=True)`` and its 55 norms through ``rms_norm``.  This A/B runs
``chip_smoke.py``'s full-width float model (``dia_1_6b_config()`` in bf16
with the seed weights) single-stream and greedy on the graph loop with
versions of those two functions (``--versions``), each in turn, in one
process:

* ``kernels`` — the port's own: ``ops.kernels.dense_rows`` and
  ``ops.kernels.rms_norm`` (a row's bits independent of the row count);
* ``parent`` — the same two kernels built from an earlier source (``--old``,
  default the copies under ``_parent/``, a git-ignored directory into which
  the caller unpacks the parent commit with ``git archive``: the cluster
  design with 8-byte loads and byte permutes over 64-row groups, planned by
  ``int8_matmul.cluster_plan``, and the norm of one block a row), called
  through their C entries with that source's plan;
* ``before`` — the route these kernels replaced: cuBLAS at the call's rows
  padded with zero rows to 64 (``fixed_rows_matmul``), the mean of squares
  as the mean of 16 partial means (ATen reductions);
* ``cublas`` — cuBLAS at the call's own row count and the plain ATen norm
  (their bits depend on the row count: a library reference only).

Each reading of a version captures its graphs ``--captures`` times anew (the
kept graphs dropped before each), and times ``--runs`` calls of ``--tokens``
tokens from each capture, so the spread across captures shows apart from the
spread across replays of one capture.  The order is the versions, then the
same in reverse, so a drift of the card's clocks shows as a difference
between a version's two readings.
Per capture: device ms a replayed step (CUDA events around the replays), host
ms a step (the call's wall time over its steps); per reading: nodes a step in
the 16-step graph, and whether the codes equal the first reading of each
version run so far (the versions sum in other orders, so their greedy codes
may part at a near tie).  Prints one JSON line a reading, one of all
readings, then the card's name and power limit.

Before the readings, with ``parent`` among the versions: the fp32 routes of
both kernels, earlier source against this one, on the seed inputs of
``FP32_CASES`` (``fp32_digests``): one JSON line with each case's output
digest from each build and whether they are bit-equal; ``--fp32-digests
PATH`` writes the earlier build's digests to PATH (the card test
``test_fp32_rows_equal_the_earlier_kernels`` holds the kernels to the file
``tests/fixtures/torch_fp32_rows_digests.json``).

Run on the card from the repository root, after ``git archive <parent>
dia_tts_prune_tpu_torch | tar -x -C _parent``:
``python3 tools/torch_float_rows_ab.py [--tokens 512] [--runs 3] [--captures 3]
[--versions parent kernels cublas] [--old PATH] [--fp32-digests PATH]``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
OLD_DIR = REPO / "_parent" / "dia_tts_prune_tpu_torch" / "csrc"
PAD_ROWS = 64  # the retired route's row count
NORM_PARTS = 16  # the retired norm's partial means
# fp32 seed inputs whose outputs must keep their bits: dense_rows (M, K, N),
# the norm (rows, D, scale dtype); numpy-made, so any machine makes the same
FP32_CASES = {"dense_rows": [(2, 2048, 2048), (2, 2048, 9252), (3, 8192, 2048), (80, 2048, 512),
                             (130, 1000, 1027)],
              "rms_norm": [(2, 2048, "float32"), (64, 1024, "bfloat16"), (3, 20, "float32"),
                           (2048, 2048, "bfloat16")]}


def fp32_digests(torch, dense, norm) -> dict:
    """{case: sha256 of the fp32 output bytes} of ``dense(x, w)`` and
    ``norm(x, scale, 1e-5)`` on the card, inputs from ``numpy`` seeds."""
    import numpy as np

    out = {}
    for M, K, N in FP32_CASES["dense_rows"]:
        rng = np.random.default_rng(M * K + N)
        w = torch.from_numpy(rng.normal(size=(K, N)).astype(np.float32) / K ** 0.5).cuda()
        x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).cuda()
        y = dense(x, w).cpu().numpy()
        out[f"dense_rows_{M}x{K}x{N}"] = hashlib.sha256(y.tobytes()).hexdigest()
    for rows, D, sdt in FP32_CASES["rms_norm"]:
        rng = np.random.default_rng(rows * D)
        x = torch.from_numpy(rng.normal(size=(rows, D)).astype(np.float32)).cuda()
        scale = torch.from_numpy(1.0 + 0.1 * rng.normal(size=D).astype(np.float32))
        y = norm(x, scale.to(getattr(torch, sdt)).cuda(), 1e-5).cpu().numpy()
        out[f"rms_norm_{rows}x{D}_{sdt}"] = hashlib.sha256(y.tobytes()).hexdigest()
    return out


def old_kernels(torch, old: Path):
    """(dense, norm): the earlier source's two C entries, built by nvcc into
    libraries of their own and called with that source's plan (bf16: the
    int8 matmul's ``cluster_plan`` and 16-, 4- or 2-byte copies; fp32: the
    unchanged ``vector_width`` and ``split_plan``)."""
    import importlib

    from dia_tts_prune_tpu_torch.ops.kernels import _build

    dr = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.dense_rows")
    rn = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.rms_norm")
    i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
    out_dir = _build.BUILD_DIR / "old"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in ("dense_rows", "rms_norm"):
        src = old / f"{name}.cu"
        lib = out_dir / f"lib{name}-{hashlib.sha256(src.read_bytes()).hexdigest()[:16]}.so"
        if not lib.exists():
            subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{old}", "-o", str(lib),
                            str(src)], check=True, capture_output=True)
        libs[name] = ctypes.CDLL(str(lib))
    dense_fn, norm_fn = libs["dense_rows"].dense_rows_fwd, libs["rms_norm"].rms_norm_fwd
    dense_fn.argtypes, dense_fn.restype = dr._ARGTYPES, ctypes.c_int
    norm_fn.argtypes, norm_fn.restype = rn._ARGTYPES, ctypes.c_int

    def dense(x, w):
        M, K = x.shape
        N = w.shape[1]
        out = torch.empty(M, N, dtype=x.dtype, device=x.device)
        part = None
        p = w.data_ptr()
        if x.dtype == torch.bfloat16:
            vec = 16 if p % 16 == 0 and N % 4 == 0 else 4 if N % 2 == 0 and p % 4 == 0 else 2
            n_split, slice_rows = i8.cluster_plan(K, N)
        else:
            vec = dr.vector_width(N, p)
            n_split = i8.split_plan(K, N, vec)
            slice_rows = -(-K // n_split)
            if n_split > 1:
                part = torch.empty(n_split * M * N, dtype=torch.float32, device=x.device)
        err = dense_fn(x.data_ptr(), p, out.data_ptr(), None if part is None else part.data_ptr(),
                       M, K, N, vec, n_split, slice_rows, {torch.float32: 0, torch.bfloat16: 1}[
                           x.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier dense_rows: cudaError {err}")
        return out

    def norm(x, scale, eps):
        D = x.shape[-1]
        x2, s = x.reshape(-1, D).contiguous(), scale.contiguous()
        out = torch.empty_like(x2)
        err = norm_fn(x2.data_ptr(), s.data_ptr(), out.data_ptr(), x2.shape[0], D, float(eps),
                      rn._X_CODES[x.dtype], rn._S_CODES[scale.dtype],
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"earlier rms_norm: cudaError {err}")
        return out.view(x.shape)

    return dense, norm


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tokens", type=int, default=512)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--captures", type=int, default=3)
    ap.add_argument("--versions", nargs="+", default=["parent", "kernels", "cublas"],
                    choices=["parent", "kernels", "before", "cublas"])
    ap.add_argument("--old", type=Path, default=OLD_DIR,
                    help="the earlier csrc/ (default: its copy under _parent/)")
    ap.add_argument("--fp32-digests", type=Path, default=None,
                    help="write the earlier build's fp32 digests to this file")
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
    if "parent" in args.versions:
        versions["parent"] = old_kernels(torch, args.old)
        digests = {"earlier": fp32_digests(torch, *versions["parent"]),
                   "kernels": fp32_digests(torch, *own)}
        print(json.dumps({"fp32_digests": digests,
                          "bit_equal": digests["earlier"] == digests["kernels"]}), flush=True)
        if args.fp32_digests:
            args.fp32_digests.write_text(json.dumps(digests["earlier"], indent=1) + "\n")
    order = [*args.versions, *reversed(args.versions)]
    cfg = dia_1_6b_config()
    dia = Dia(cfg, chip_smoke.seed_weights(torch, cfg), "bfloat16", device="cuda")
    gen = dia.generator
    first, readings = {}, {}

    def call():
        return dia.generate_codes(chip_smoke.FULL_WIDTH_TEXT, max_tokens=args.tokens,
                                  temperature=0.0)

    try:
        for name in order:
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
