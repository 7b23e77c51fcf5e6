#!/usr/bin/env python3
"""Time the int8-matmul kernel against an earlier source of itself, edited
copies of its current source, and cuBLAS on the bf16 weight.

Builds ``csrc/int8_matmul.cu`` as it is and as each named variant edits it (a
list of (old, new) text edits, and optionally another launch plan), each by
nvcc into a library of its own called through the C entry the wrapper calls.
It builds an earlier copy of the source too, given by ``--old`` (default: the
copy in ``_parent/``, a git-ignored directory into which the caller unpacks
the parent commit with ``git archive``), whose C entry takes the split-K
design's signature (``int8_matmul_fwd(x, w, scale, out, part, B, K, N, vec,
n_split, dtype, stream)`` with an fp32 scratch of ``n_split * B * N``
floats, planned by ``vector_width`` and ``split_plan``).  At the five packed
weight shapes of a Dia-1.6B decode step and B = 2, 8 and 64 (bf16, weight and
x from a seed; each timing loop cycles through copies of the weight that
together exceed the L2, as a decode step finds them cold) it prints one JSON
line per case: the device time of each (CUDA-graph replay, in turns old, a,
b, ..., b, a, old), each one's ratio to the old kernel's, cuBLAS's time on
the dequantized bf16 weight, the byte bound, each output's error against the
plain version over ``chip_smoke.py``'s GEMV gate (must be <= 1), and whether
each output is bit-identical over two runs; then the card's name and power
limit.

Variants (``--variants``, default ``base``): ``base`` — the source and plan
as they are; ``ring48`` / ``ring96`` — 48 / 96 KB of stages instead of 64;
``c8`` — clusters of at most 8 blocks (the portable size) instead of 16;
``wide`` / ``narrow`` — the plan aims for 4 / 2 blocks an SM instead of 3;
``ring32``, ``wide8`` — 32 KB of stages, 8 blocks an SM; ``cvt`` / ``alu`` —
int8 widened by the conversion unit / by ALU instructions at every slice
length (the source picks by slice length); ``fp32`` — by the fp32 exponent
trick; ``p2`` / ``p8`` — 2 / 8 copying warps instead of 4; ``s256`` —
strips of 256 columns (8 multiplying, 8 copying warps; the plan as for 128).  Probes of where the time goes (wrong outputs,
not gated): ``empty`` — the kernel returns at once; ``no_mma`` — no k-step
runs; ``no_weight`` — the weight's 16-byte copies are left out; ``no_widen`` — the
int8 words go to the tensor cores unwidened; ``no_merge``
— the blocks sync but add no partials and write nothing; ``timeline`` — each
block stamps clock64 (its thread 0, a multiplying thread) at the end of each
phase (set-up, waiting for the first stage, the rest of the loop, the barrier
that every block has started, pushing the sums, the cluster sync, the merge)
and globaltimer at start and end, read after one eager call.

Run on the card from the repository root:
``python3 tools/torch_gemv_ab.py [--old PATH] [--variants base st4 ...] [--rows 2 8 64]``.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OLD_DEFAULT = REPO / "_parent" / "dia_tts_prune_tpu_torch" / "csrc" / "int8_matmul.cu"
OLD_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
SHAPES = [(2048, 2048), (2048, 512), (2048, 16384), (8192, 2048), (2048, 9252)]
ROWS = (2, 8, 64)


def _const(name: str, old: int, new: int) -> tuple[str, str]:
    return f"constexpr int {name} = {old};", f"constexpr int {name} = {new};"


# int8 -> bf16 by the fp32 exponent trick (byte ^ 0x80 in the mantissa of 2^23, minus
# 2^23 + 128) instead of bf16 halves
FP32 = [("""      v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&hi),
                  *reinterpret_cast<const __nv_bfloat162*>(&base));""",
         "      const uint32_t ua = a ^ 0x80808080u, ub = b ^ 0x80808080u;\n"
         "      const float fa = __uint_as_float(__byte_perm(ua, 0x4B000000u, 0x7540 | j));\n"
         "      const float fb = __uint_as_float(__byte_perm(ub, 0x4B000000u, 0x7540 | j));\n"
         "      v = __floats2bfloat162_rn(fa - 8388736.f, fb - 8388736.f);")]
KERNEL_TOP = "  using S = Smem<TB>;\n  extern __shared__"
# name: (source edits, (max cluster, blocks aimed for): None keeps the wrapper's)
VARIANTS = {
    "base": ([], None),
    "ring48": ([("constexpr int RING_BYTES = 64 * 1024;", "constexpr int RING_BYTES = 48 * 1024;")],
               None),
    "ring96": ([("constexpr int RING_BYTES = 64 * 1024;", "constexpr int RING_BYTES = 96 * 1024;")],
               None),
    "ring32": ([("constexpr int RING_BYTES = 64 * 1024;", "constexpr int RING_BYTES = 32 * 1024;")],
               None),
    "wide8": ([], (None, 8 * 132)),
    "c8": ([], (8, None)),
    "wide": ([], (None, 4 * 132)),
    "narrow": ([], (None, 2 * 132)),
    "cvt": ([_const("CVT_SLICE", 512, 0)], None),
    "alu": ([_const("CVT_SLICE", 512, 1 << 30)], None),
    "fp32": (FP32 + [_const("CVT_SLICE", 512, 1 << 30)], None),
    "s256": ([_const("STRIP", 128, 256), _const("CWARPS", 4, 8), _const("PWARPS", 4, 8)], None),
    "p2": ([_const("PWARPS", 4, 2)], None),
    "p8": ([_const("PWARPS", 4, 8)], None),
}
# probes of where the time goes; their outputs are wrong and not gated
PROBES = {
    "no_widen": ([("    o[j] = *reinterpret_cast<const uint32_t*>(&v);\n  }\n}",
                   "    o[j] = a ^ (b << j);\n  }\n}")], None),
    "empty": ([(KERNEL_TOP, "  if (B > 0) return;\n" + KERNEL_TOP)], None),
    "no_mma": ([("      for (int kk = 0; kk < STEPS; ++kk) {\n        uint32_t lo[4], hi[4];",
                 "      for (int kk = 0; kk < 0; ++kk) {\n        uint32_t lo[4], hi[4];")], None),
    "no_weight": ([("                       \"l\"(n > 0 ? w + at : w), \"r\"(n));",
                    "                       \"l\"(w), \"r\"(0));")], None),
    "no_merge": ([("    for (int i0 = tid; i0 < B * cpr; i0 += ROWS_AT_ONCE * NT) {",
                   "    for (int i0 = tid; i0 < 0; i0 += ROWS_AT_ONCE * NT) {")], None),
}
# per-block timestamps (clock64 at eight points, globaltimer at start and
# end) into a device array, read by an entry of their own after one call
TL_HEAD = """namespace cg = cooperative_groups;
__device__ long long g_tl[16384][10];
__device__ __forceinline__ long long gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TL(i) if (threadIdx.x == 0) g_tl[blockIdx.y * gridDim.x + blockIdx.x][i] = clock64();
extern "C" int int8_matmul_timeline(void* dst, int n) {
  return cudaMemcpyFromSymbol(dst, g_tl, (size_t)n * 10 * sizeof(long long));
}
"""
TIMELINE = [
    ("namespace cg = cooperative_groups;\n", TL_HEAD),
    ("  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n  const int col0",
     "  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;\n  TL(0)\n"
     "  if (threadIdx.x == 0) g_tl[blockIdx.y * gridDim.x + blockIdx.x][8] = gtime();\n"
     "  const int col0"),
    ("  __syncthreads();\n  // the other blocks' inboxes",
     "  __syncthreads();\n  TL(1)\n  // the other blocks' inboxes"),
    ("      bar_wait(full + s, (c / STAGES) & 1);\n",
     "      bar_wait(full + s, (c / STAGES) & 1);\n      if (c == 0) { TL(2) }\n"),
    ("  }\n  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n",
     "  }\n  TL(3)\n  asm volatile(\"barrier.cluster.wait.aligned;\\n\" ::: \"memory\");\n"
     "  TL(4)\n"),
    ("  cluster.sync();  // every block's sums are in their owners' inboxes\n",
     "  TL(5)\n  cluster.sync();  // every block's sums are in their owners' inboxes\n  TL(6)\n"),
    ("__float2bfloat16(v * col_scale);\n      }\n    }\n  }\n}",
     "__float2bfloat16(v * col_scale);\n      }\n    }\n  }\n  TL(7)\n"
     "  if (threadIdx.x == 0) g_tl[blockIdx.y * gridDim.x + blockIdx.x][9] = gtime();\n}"),
]
PROBES["timeline"] = (TIMELINE, None)
TL_PHASES = ("init", "first_stage_wait", "loop_rest", "start_barrier", "push", "cluster_sync",
             "merge")
VARIANTS.update(PROBES)


def timeline(torch, lib, blocks: int) -> dict:
    """Per-phase cycles (median, max over blocks) and the blocks' globaltimer
    span (ns) of the timeline probe's last call."""
    import numpy as np

    fn = lib.int8_matmul_timeline
    fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    buf = np.zeros((blocks, 10), dtype=np.int64)
    torch.cuda.synchronize()
    if fn(buf.ctypes.data, blocks) != 0:
        raise RuntimeError("int8_matmul_timeline failed")
    d = np.diff(buf[:, :8], axis=1)
    return {"cycles": {ph: [int(np.median(d[:, i])), int(d[:, i].max())]
                       for i, ph in enumerate(TL_PHASES)},
            "total_cycles": [int(np.median(buf[:, 7] - buf[:, 0])),
                             int((buf[:, 7] - buf[:, 0]).max())],
            "span_ns": int(buf[:, 9].max() - buf[:, 8].min()),
            "start_spread_ns": int(buf[:, 8].max() - buf[:, 8].min()),
            "end_spread_ns": int(buf[:, 9].max() - buf[:, 9].min())}


def build(sources: dict, out_dir: Path) -> dict:
    """{name: ctypes library}: one nvcc per source text, all at once."""
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    running = {}
    for name, text in sources.items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        running[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC_DIR}", "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def plan(i8, K, N, override):
    """(cluster, slice) of the wrapper's plan, or of the plan with another
    largest cluster or block target."""
    if override is None:
        return i8.cluster_plan(K, N)
    saved = i8.MAX_CLUSTER, i8.CLUSTER_BLOCKS
    i8.MAX_CLUSTER = override[0] or saved[0]
    i8.CLUSTER_BLOCKS = override[1] or saved[1]
    try:
        return i8.cluster_plan(K, N)
    finally:
        i8.MAX_CLUSTER, i8.CLUSTER_BLOCKS = saved


def caller(torch, i8, lib, x, vals, scale, old: bool, override=None):
    """fn() launching ``lib``'s entry on x and the next weight copy into a
    fixed output."""
    fn = lib.int8_matmul_fwd
    fn.argtypes, fn.restype = (OLD_ARGTYPES if old else i8._ARGTYPES), ctypes.c_int
    B, K = x.shape
    N = vals[0].shape[1]
    out = torch.empty(B, N, dtype=x.dtype, device="cuda")
    if old:
        vec = i8.vector_width(N, vals[0].data_ptr())
        n_split = i8.split_plan(K, N, vec)
    else:
        args = [B, K, N, i8.copy_width(N, vals[0].data_ptr()), *plan(i8, K, N, override)]
    turn = iter(range(1 << 30))

    def run(i=None):
        w = vals[next(turn) % len(vals) if i is None else i]
        if old:  # a scratch per call, as the earlier wrapper allocated it
            part = torch.empty(max(1, n_split * B * N), dtype=torch.float32, device="cuda")
            head = [part.data_ptr(), B, K, N, vec, n_split]
        else:
            head = [None, *args]
        err = fn(x.data_ptr(), w.data_ptr(), scale.data_ptr(), out.data_ptr(), *head, 1,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"int8_matmul_fwd failed (cudaError {err})")
        return out

    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--old", type=Path, default=OLD_DEFAULT)
    p.add_argument("--variants", nargs="+", default=["base"],
                   help=f"names of {sorted(VARIANTS)}, or several joined by '+'")
    p.add_argument("--rows", nargs="+", type=int, default=list(ROWS))
    args = p.parse_args(argv)

    import torch

    from chip_smoke import COLD_BYTES, GEMV_SUM_TOL, TOL, bound, graph_ms
    from dia_tts_prune_tpu_torch.ops import quant
    from dia_tts_prune_tpu_torch.ops.kernels import _build, int8_matmul_plain

    if not torch.cuda.is_available():
        print("torch_gemv_ab: no CUDA device", file=sys.stderr)
        return 1
    # by module path: the package's namespace holds the wrapper function under this name
    i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
    for name in args.variants:  # a joined name: the parts' edits, the last plan given
        if name not in VARIANTS:
            parts = [VARIANTS[part] for part in name.split("+")]
            VARIANTS[name] = ([e for edits, _ in parts for e in edits],
                              next((o for _, o in reversed(parts) if o is not None), None))
    source = (_build.CSRC_DIR / "int8_matmul.cu").read_text()
    sources = {"old": args.old.read_text()}
    for name in args.variants:
        text = source
        for old, new in VARIANTS[name][0]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = text
    g = torch.Generator(device="cuda").manual_seed(4)
    with tempfile.TemporaryDirectory(prefix="gemv_ab_") as tmp:
        libs = build(sources, Path(tmp))
        order = ["old", *args.variants]
        for K, N in SHAPES:
            w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
            qk = quant.quantize_int8(w)
            scale = qk.scale.reshape(N)
            n = max(2, min(64, -(-COLD_BYTES // qk.values.numel())))
            vals = [qk.values.clone() for _ in range(n)]
            deq = quant.dequantize(qk)
            wlib = [deq.bfloat16() for _ in range(max(2, n // 2))]
            for B in args.rows:
                x = torch.randn(B, K, generator=g, device="cuda").bfloat16()
                calls = {name: caller(torch, i8, libs[name], x, vals, scale, name == "old",
                                      VARIANTS.get(name, (None, None))[1])
                         for name in order}
                for fn in calls.values():
                    fn(0)
                torch.cuda.synchronize()
                outs = {name: fn(0).clone() for name, fn in calls.items()}
                tl = None
                if "timeline" in calls:
                    cl, _ = plan(i8, K, N, None)
                    tl = timeline(torch, libs["timeline"], cl * -(-N // i8.STRIP))
                repeat = {name: torch.equal(calls[name](0), outs[name]) for name in order}
                ref = int8_matmul_plain(x.float(), qk.values, scale)
                tol = (GEMV_SUM_TOL * (x.float().abs() @ deq.abs())
                       + TOL["bfloat16"]["rtol"] * ref.abs())
                gate = {name: ((o.float() - ref).abs() / tol).max().item()
                        for name, o in outs.items()}
                times = {name: [] for name in order}
                for name in order + order[::-1]:
                    print(f"# K={K} N={N} B={B} {name}", file=sys.stderr, flush=True)
                    times[name].append(graph_ms(torch, calls[name], iters=2 * n))
                ms = {name: sum(t) / len(t) for name, t in times.items()}
                turn = iter(range(1 << 30))
                cublas = graph_ms(torch, lambda: torch.matmul(x, wlib[next(turn) % len(wlib)]),
                                  iters=4 * len(wlib))
                nbytes = qk.values.numel() + 4 * N + 2 * (B * K + B * N)
                print(json.dumps({
                    "tool": "torch_gemv_ab", "K": K, "N": N, "B": B, "dtype": "bfloat16",
                    "plan": {name: list(plan(i8, K, N, VARIANTS[name][1])) for name in order
                             if name != "old"},
                    "ms": ms, "ms_each_turn": times,
                    "ratio_to_old": {name: ms[name] / ms["old"] for name in order},
                    "cublas_bf16_ms": cublas,
                    "ratio_to_cublas": {name: ms[name] / cublas for name in order},
                    "bound_ms": bound(nbytes, 2.0 * B * K * N, "bfloat16")[0],
                    "err_over_gate": gate, "bit_identical_over_two_runs": repeat,
                    "timeline": tl,
                    "weight_copies": n}), flush=True)
                if max(v for name, v in gate.items()
                       if not any(part in PROBES for part in name.split("+"))) > 1.0:
                    raise RuntimeError(f"K={K} N={N} B={B}: an output misses the gate: {gate}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
