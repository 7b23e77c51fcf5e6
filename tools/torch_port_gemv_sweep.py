#!/usr/bin/env python3
"""Sweep the launch plan of the port's int8-matmul and int4-GEMV kernels.

For each packed weight shape of a Dia-1.6B decode step (B = 2 rows, bf16
activations) it times the int8 kernel over its weight copy widths and cluster
sizes (1 to 16 blocks, each slice a whole number of 64-row stages), beside
the plan the wrapper picks (``cluster_plan``), and the int4 kernel over both
load widths and a range of K-slice counts, beside its plan (``split_plan``),
each beside cuBLAS on the bf16 weight.  Each timing loop cycles through copies of the weight that
together exceed the L2 cache, as a decode step finds its weights cold.  Prints
one JSON line per shape and kernel, then the card's name and power limit.

Run on the card: ``python3 tools/torch_port_gemv_sweep.py``.
"""

from __future__ import annotations

import importlib
import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

SHAPES = [(2048, 2048), (2048, 512), (2048, 16384), (8192, 2048), (2048, 9252)]
COLD_BYTES = 128 << 20


def main() -> int:
    import torch

    from dia_tts_prune_tpu_torch.api import resolve_device
    from dia_tts_prune_tpu_torch.ops import quant

    # by module path: the package's namespace holds the wrapper functions under these names
    i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
    i4 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int4_gemv")

    resolve_device("cuda")

    def cuda_ms(fn, iters):
        """Device time of one call: ``iters`` calls captured into a CUDA graph
        and replayed (eager calls would measure the host's enqueue rate)."""
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(5):
            graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (5 * iters)

    g = torch.Generator(device="cuda").manual_seed(5)
    for K, N in SHAPES:
        w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
        x = torch.randn(2, K, generator=g, device="cuda").bfloat16()
        q8 = quant.quantize_int8(w)
        q4 = quant.quantize_int4(w, group=128, halfsplit=True)
        for name, qk, scale, widths, max_slice, launch in (
            ("int8_matmul", q8, q8.scale.reshape(N), (16, 4, 1), None,
             lambda v, s, vec, n: i8.launch(x, v, s, vec, n,
                                            -(-K // (i8.STAGE_ROWS * n)) * i8.STAGE_ROWS)),
            ("int4_gemv", q4, q4.scale, (4, 1), i4.MAX_SLICE,
             lambda v, s, vec, n: i4.launch(x, v, s, "halfsplit", K, 128, vec, n)),
        ):
            rows = qk.values.shape[0]
            n_copies = max(2, min(64, -(-COLD_BYTES // qk.values.numel())))
            vals = [qk.values.clone() for _ in range(n_copies)]
            turn = iter(range(1 << 30))
            iters = 2 * n_copies
            table = {}
            for vec in widths:
                if N % (4 if max_slice is None and vec == 16 else vec):  # int8: 16 needs N % 4
                    continue
                if max_slice is None:  # int8: clusters of 1 to 16 blocks
                    splits = (1, 2, 4, 8, 16)
                else:
                    lo = -(-rows // max_slice)
                    splits = sorted({lo, *(n for n in (1, 2, 4, 8, 16, 32, 64) if n >= lo),
                                     i8.split_plan(rows, N, vec, max_slice)})
                for n_split in splits:
                    table[f"vec{vec}_split{n_split}"] = cuda_ms(
                        lambda: launch(vals[next(turn) % n_copies], scale, vec, n_split), iters)
            if max_slice is None:
                planned = (f"vec{i8.copy_width(N, qk.values.data_ptr())}"
                           f"_split{i8.cluster_plan(K, N)[0]}")
            else:
                vec = i8.vector_width(N, qk.values.data_ptr())
                planned = f"vec{vec}_split{i8.split_plan(rows, N, vec, max_slice)}"
            wl = [w.bfloat16() for _ in range(max(2, n_copies // 2))]
            print(json.dumps({
                "tool": "torch_port_gemv_sweep", "kernel": name, "K": K, "N": N, "B": 2,
                "dtype": "bfloat16", "planned": planned,
                "ms": table, "best": min(table, key=table.get),
                "cublas_bf16_ms": cuda_ms(lambda: torch.matmul(x, wl[next(turn) % len(wl)]), iters),
                "weight_bytes": qk.values.numel(),
                "bytes_bound_ms": 1e3 * (qk.values.numel() + 4 * scale.numel()) / 3.35e12,
            }), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
