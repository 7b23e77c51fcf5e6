#!/usr/bin/env python3
"""Time the fused decode-step kernel against the parent commit's source, and
take a per-phase timeline of either.

Builds, each by nvcc into a library of its own, called through the C entry
the wrapper calls (``fused_step_fwd``, with the workspace its own
``fused_step_workspace_bytes`` asks for):

* ``old`` — the parent's ``csrc/fused_step.cu``, from ``--old`` (default: the
  copy under ``_parent/``, a git-ignored directory into which the caller
  unpacks the parent commit with ``git archive``);
* ``old_timeline`` — that source with clock64 stamps (``OLD_TIMELINE``): its
  thread 0 of every block adds the cycles of each stretch of each phase
  (A qkv, B self-attention, C o_proj, D cq, E cross-attention, F co_proj, G
  gate/up, H wm) to one of ``OLD_CATEGORIES`` — ``row_rstd``, the GEMV items
  (``stage_x`` + the weight loads and FMAs), the epilogue with its ticket,
  attention, the grid barrier's wait — summed over the 18 layers;
* ``base`` — ``csrc/fused_step.cu`` as it is;
* ``timeline`` — the same source compiled with ``-DFUSED_TIMELINE``, its own
  stamps (``NEW_CATEGORIES``: a consuming thread and a copying thread of
  every block);
* ``--variants``: edited copies of the source, timed beside ``base``:
  ``pwarps4`` — 4 copying warps instead of 2; ``noprefetch`` — no L2
  prefetch of the attention chunks' K/V.

At each fused case of ``chip_smoke.py`` (int8 and int4-MLP packs, bf16 and
int8 caches, B = 2 and 8, and B = 20 with the int8 pack and caches, at
Dia-1.6B widths) it prints one JSON line: each build's output against the
plain version (``chip_smoke.fused_gate``, must be <= 1), whether two runs are
bit-identical, the timed builds' ms (CUDA events around 20 back-to-back
launches, in turns old, base, base, old), the ratio to the old kernel, the
byte bound, and each timeline build's split: per category and per (phase,
category), the median and the largest over the blocks, in µs (cycles over
the blocks' median clock rate, from %globaltimer and clock64 at start and
end).  Then the card's name and power limit.  ``base`` is built as the
wrapper builds it (``_build``, into the git-ignored build directory), so
that a later run of the card tests reuses it.

Run on the card from the repository root:
``python3 tools/torch_fused_ab.py [--builds old old_timeline base timeline]
[--variants pwarps4 noprefetch ...] [--cases int8_bf16_2 ...]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OLD_DIR = REPO / "_parent" / "dia_tts_prune_tpu_torch" / "csrc"
BUILDS = ("old", "old_timeline", "base", "timeline")
TIMED = ("old", "base")
PHASES = ("A_qkv", "B_self_attention", "C_o_proj", "D_cq", "E_cross_attention", "F_co_proj",
          "G_gate_up", "H_wm")
OLD_CATEGORIES = ("row_rstd", "gemv_items", "epilogue_and_ticket", "attention", "barrier_wait")
NEW_CATEGORIES = ("dependency_wait", "grid_barrier", "x_staging", "ring_wait", "mma",
                  "partial_and_arrival", "finalize", "attention", "copy_ring_full", "copy_issue",
                  "attention_loads")
MAX_BLOCKS = 4096
VARIANTS = {
    "pwarps4": [("constexpr int PWARPS = 2;", "constexpr int PWARPS = 4;")],
    "noprefetch": [("  if (gph == GA || gph == GD) prefetch_chunks(p, l, gph == GA);", "")],
}
# (pack, caches, B): the fused cases of chip_smoke.phase_fused_kernels
CASES = {f"{'int4' if int4 else 'int8'}_{'bf16' if kind == 'bfloat16' else 'int8'}_{B}":
         (int4, kind, B)
         for int4 in (False, True) for kind in ("bfloat16", "int8")
         for B in ((2, 8) if int4 or kind == "bfloat16" else (2, 8, 20))}

# clock64 stamps in the parent's source (the first design's kernel): thread 0 of each
# block adds the cycles of each stretch to g_tl[block][phase][category]
OLD_TL_HEAD = """namespace cg = cooperative_groups;
__device__ long long g_tl[4096][8][5];
__device__ long long g_span[4096][4];
__device__ int g_ph[4096];
__device__ __forceinline__ long long tl_gtime() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TL_ADD(cat, t0) \\
  if (threadIdx.x == 0) g_tl[blockIdx.x][g_ph[blockIdx.x]][cat] += clock64() - (t0);
#define TL_PH(ph) if (threadIdx.x == 0) g_ph[blockIdx.x] = (ph);
extern "C" int fused_step_timeline(void* tl, void* span, int n) {
  cudaError_t e = cudaMemcpyFromSymbol(tl, g_tl, (size_t)n * 8 * 5 * sizeof(long long));
  if (e != cudaSuccess) return e;
  return cudaMemcpyFromSymbol(span, g_span, (size_t)n * 4 * sizeof(long long));
}
extern "C" int fused_step_timeline_reset() {
  static long long zero[4096 * 4] = {};
  return cudaMemcpyToSymbol(g_span, zero, sizeof(zero));
}
"""
OLD_TIMELINE = [
    ("namespace cg = cooperative_groups;\n", OLD_TL_HEAD),
    ("  float* work = smem + rstd_floats(p.B);    // phases' own scratch\n",
     "  float* work = smem + rstd_floats(p.B);    // phases' own scratch\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int a = 0; a < 8; ++a)\n"
     "      for (int c = 0; c < 5; ++c) g_tl[blockIdx.x][a][c] = 0;\n"
     "    g_ph[blockIdx.x] = 0;\n"
     "    g_span[blockIdx.x][0] = tl_gtime();\n"
     "    g_span[blockIdx.x][2] = clock64();\n"
     "  }\n"),
    ("  grid.sync();\n\n  const int D = p.D",
     "  { long long ts = clock64(); grid.sync(); TL_ADD(4, ts) }\n\n  const int D = p.D"),
    ("    grid.sync();\n", "    { long long ts = clock64(); grid.sync(); TL_ADD(4, ts) }\n"),
    ("    // A: qkv\n", "    // A: qkv\n    TL_PH(0)\n"),
    ("    // B: self-attention\n", "    // B: self-attention\n    TL_PH(1)\n"),
    ("    // C: o_proj + residual\n", "    // C: o_proj + residual\n    TL_PH(2)\n"),
    ("    // D: cq\n", "    // D: cq\n    TL_PH(3)\n"),
    ("    // E: cross-attention\n", "    // E: cross-attention\n    TL_PH(4)\n"),
    ("    // F: co_proj + residual\n", "    // F: co_proj + residual\n    TL_PH(5)\n"),
    ("    // G: gate, up -> h\n", "    // G: gate, up -> h\n    TL_PH(6)\n"),
    ("    // H: wm + residual\n", "    // H: wm + residual\n    TL_PH(7)\n"),
    ("  }\n}\n\n// --------------------------------------------------------------------------\n"
     "// host side",
     "  }\n  if (threadIdx.x == 0) {\n    g_span[blockIdx.x][1] = tl_gtime();\n"
     "    g_span[blockIdx.x][3] = clock64();\n  }\n}\n\n"
     "// --------------------------------------------------------------------------\n"
     "// host side"),
    ("  if (in.src == nullptr && blockIdx.x < n_items) row_rstd(p, in.rstd, smem);\n",
     "  {\n    long long tr = clock64();\n"
     "    if (in.src == nullptr && blockIdx.x < n_items) row_rstd(p, in.rstd, smem);\n"
     "    TL_ADD(0, tr)\n  }\n"),
    ("    const int strip = item % j0.nstrips, sl = item / j0.nstrips;\n",
     "    long long ti = clock64();\n"
     "    const int strip = item % j0.nstrips, sl = item / j0.nstrips;\n"),
    ("    if (!last_of(p.cnt + strip, j0.nsl, flag)) continue;\n",
     "    TL_ADD(1, ti)\n    ti = clock64();\n"
     "    if (!last_of(p.cnt + strip, j0.nsl, flag)) {\n      TL_ADD(2, ti)\n      continue;\n"
     "    }\n"),
    ("        *o = bf16r(v / (1.f + expf(-v)) * u);\n      }\n    }\n  }\n}\n",
     "        *o = bf16r(v / (1.f + expf(-v)) * u);\n      }\n    }\n    TL_ADD(2, ti)\n  }\n}\n"),
    ("    attention(p, l, true, work);\n",
     "    { long long ta = clock64(); attention(p, l, true, work); TL_ADD(3, ta) }\n"),
    ("    attention(p, l, false, work);\n",
     "    { long long ta = clock64(); attention(p, l, false, work); TL_ADD(3, ta) }\n"),
]


def apply_edits(text: str, edits, name: str) -> str:
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


def build(sources: dict, out_dir: Path) -> dict:
    """{name: ctypes library}: one nvcc per (source text, extra flags), all at
    once; ``base`` by the wrapper's own build."""
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    running = {}
    for name, (text, flags) in sources.items():
        if name == "base":
            running[name] = (None, None)
            continue
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        running[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, f"-I{_build.CSRC_DIR}", "-o",
             str(lib), str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    if "base" in running:
        libs["base"] = ctypes.CDLL(_build.build_all(("fused_step",))["fused_step"]["path"])
    for name, (lib, proc) in running.items():
        if name == "base":
            continue
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def caller(torch, lib, pack, inp):
    """fn() launching ``lib``'s fused_step_fwd on the step inputs, as the
    wrapper does; returns (x, k_new, v_new) in the wrapper's dtypes."""
    from dia_tts_prune_tpu_torch.ops.kernels.fused_step import _ARGTYPES, _CACHE_CODES
    from dia_tts_prune_tpu_torch.ops.modules import _inv_freq

    fwd, size = lib.fused_step_fwd, lib.fused_step_workspace_bytes
    fwd.argtypes, size.argtypes = _ARGTYPES, [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fwd.restype = size.restype = ctypes.c_int
    sk = inp["self_k"]
    L, B, T, Nkv, H = sk.shape
    S, Ncq = inp["cross_k"].shape[2], inp["cross_k"].shape[3]
    D, F, Nq = inp["x_emb"].shape[1], pack.wg.shape[2], pack.wo.shape[1] // H
    shapes = (B, D, F, Nq, Nkv, Ncq, H, T, S, int(pack.mlp_int4), pack.mlp_tiles)
    need = ctypes.c_longlong(0)
    if size(*shapes, ctypes.byref(need)) != 0:
        raise RuntimeError(f"fused_step_workspace_bytes refused {shapes}")
    dev = sk.device
    work = torch.empty(need.value, dtype=torch.uint8, device=dev)
    x = torch.empty(B, D, dtype=torch.float32, device=dev)
    kv = torch.empty(2, L, B, Nkv, H, dtype=torch.float32, device=dev)
    inv_freq = _inv_freq(H, 1.0, 10000.0, dev)
    x_in = inp["x_emb"].float().contiguous()
    scales = [inp[k] for k in ("self_ks", "self_vs", "cross_ks", "cross_vs")]
    ptrs = [t.data_ptr() for t in pack[:14]] + [
        t.data_ptr() for t in (x_in, inp["position"], inp["valid_from"], inp["cross_ends"],
                               inp["write_slot"], inv_freq, sk, inp["self_v"], inp["cross_k"],
                               inp["cross_v"])]
    ptrs += [0 if s is None else s.data_ptr() for s in scales]
    ptrs += [x.data_ptr(), kv.data_ptr(), work.data_ptr()]
    tail = [L, B, D, F, Nq, Nkv, Ncq, H, T, S, _CACHE_CODES[sk.dtype],
            int(pack.mlp_int4), pack.mlp_tiles, work.numel(), 1e-5]
    out_dt = torch.float32 if sk.dtype == torch.int8 else sk.dtype

    def run():
        err = fwd(*ptrs, *tail, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused_step_fwd failed (cudaError {err})")
        return x, kv[0].to(out_dt), kv[1].to(out_dt)

    return run


def timeline(torch, lib, run, categories) -> dict:
    """One call of a timeline build: per category and per (phase, category),
    [median, max] over the blocks in µs; the blocks' span."""
    import numpy as np

    reset, read = lib.fused_step_timeline_reset, lib.fused_step_timeline
    reset.argtypes, reset.restype = [], ctypes.c_int
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    torch.cuda.synchronize()
    if reset() != 0:
        raise RuntimeError("fused_step_timeline_reset failed")
    run()
    torch.cuda.synchronize()
    nc = len(categories)
    tl = np.zeros((MAX_BLOCKS, 8, nc), dtype=np.int64)
    span = np.zeros((MAX_BLOCKS, 4), dtype=np.int64)
    if read(tl.ctypes.data, span.ctypes.data, MAX_BLOCKS) != 0:
        raise RuntimeError("fused_step_timeline failed")
    ran = span[:, 1] > 0
    tl, span = tl[ran], span[ran]
    ns_per_cycle = float(np.median((span[:, 1] - span[:, 0]) / np.maximum(1, span[:, 3] - span[:, 2])))
    us = tl * ns_per_cycle / 1e3

    def mm(a):
        return [round(float(np.median(a)), 3), round(float(a.max()), 3)]

    return {"blocks": int(ran.sum()), "ns_per_cycle": ns_per_cycle,
            "span_us": round(float(span[:, 1].max() - span[:, 0].min()) / 1e3, 3),
            "per_category_us": {c: mm(us[:, :, i].sum(axis=1)) for i, c in enumerate(categories)},
            "per_phase_us": {ph: {c: mm(us[:, j, i]) for i, c in enumerate(categories)
                                  if us[:, j, i].max() > 0}
                             for j, ph in enumerate(PHASES)}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--old", type=Path, default=None,
                   help="the parent's fused_step.cu (default: its copy under _parent/)")
    p.add_argument("--builds", nargs="+", choices=BUILDS, default=list(BUILDS))
    p.add_argument("--cases", nargs="+", choices=sorted(CASES), default=list(CASES))
    p.add_argument("--variants", nargs="*", choices=sorted(VARIANTS), default=[],
                   help="edited copies of the source to time beside base")
    args = p.parse_args(argv)

    import torch

    from chip_smoke import bound, cuda_ms, fused_bytes, fused_gate, fused_inputs, fused_pack
    from dia_tts_prune_tpu_torch.ops.kernels import _build, fused_decode_step_plain

    if not torch.cuda.is_available():
        print("torch_fused_ab: no CUDA device", file=sys.stderr)
        return 1
    old_text = (args.old or OLD_DIR / "fused_step.cu").read_text()
    new_text = (_build.CSRC_DIR / "fused_step.cu").read_text()
    sources = {"old": (old_text, []),
               "old_timeline": (apply_edits(old_text, OLD_TIMELINE, "old_timeline"), []),
               "base": (new_text, []), "timeline": (new_text, ["-DFUSED_TIMELINE"])}
    sources = {k: v for k, v in sources.items() if k in args.builds}
    for name in args.variants:
        sources[name] = (apply_edits(new_text, VARIANTS[name], name), [])
    builds = list(sources)
    timed = [b for b in TIMED if b in args.builds] + list(args.variants)
    with tempfile.TemporaryDirectory(prefix="fused_ab_") as tmp:
        libs = build(sources, Path(tmp))
        packs = {}
        for name in args.cases:
            int4, kind, B = CASES[name]
            if int4 not in packs:
                packs.clear()
                packs[int4] = fused_pack(torch, int4)
            pack = packs[int4]
            inp = fused_inputs(torch, B, kind)
            calls = {b: caller(torch, libs[b], pack, inp) for b in builds}
            ref = fused_decode_step_plain(pack, **inp)
            gate, repeat = {}, {}
            for b, fn in calls.items():
                out = [t.clone() for t in fn()]
                torch.cuda.synchronize()
                gate[b] = fused_gate(out, ref)["err_over_tol"]
                repeat[b] = all(torch.equal(a, c) for a, c in zip(fn(), out))
            times = {b: [] for b in timed}
            for b in timed + timed[::-1]:
                print(f"# {name} {b}", file=sys.stderr, flush=True)
                times[b].append(cuda_ms(torch, calls[b], iters=20))
            ms = {b: sum(t) / len(t) for b, t in times.items()}
            tls = {}
            for b, cats in (("old_timeline", OLD_CATEGORIES), ("timeline", NEW_CATEGORIES)):
                if b in calls:
                    tls[b] = timeline(torch, libs[b], calls[b], cats)
            nbytes = fused_bytes(pack, inp)
            print(json.dumps({
                "tool": "torch_fused_ab", "case": name, "mlp_int4": int4, "caches": kind, "B": B,
                "ms": ms, "ms_each_turn": times,
                "ratio_to_old": {b: ms[b] / ms["old"] for b in ms} if "old" in ms else None,
                "bound_ms": bound(nbytes, 0.0, "bfloat16")[0], "bytes": nbytes,
                "err_over_tol": gate, "bit_identical_over_two_runs": repeat,
                "timeline": tls}), flush=True)
            if max(gate.values()) > 1.0 or not all(repeat.values()):
                raise RuntimeError(f"{name}: an output misses the gate or does not repeat: "
                                   f"{gate} {repeat}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
