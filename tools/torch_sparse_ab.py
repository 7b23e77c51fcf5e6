#!/usr/bin/env python3
"""Time the block-sparse matmul kernel against an earlier source of itself,
and against edited copies of its current source.

Builds ``csrc/block_sparse_matmul.cu`` as it is and as each named variant
edits it (a list of (old, new) text edits, as ``tools/torch_flash_variants.py``
does), each by nvcc into a library of its own called through the C entry the
wrapper calls, with the wrapper's plan (``ops/kernels/sparse_matmul.py``:
load width, slices, tile and slice map; ``--routes`` also times the other
tiles and slice maps at 64 and more rows).  It builds an earlier copy of the
source too, given by ``--old`` (default: the copy in ``_parent/``, a
git-ignored directory into which the caller unpacks the parent commit with
``git archive``), whose C entry takes the port's first signature
(``block_sparse_matmul_fwd(x, w, indices, counts, out, part, M, K, N, block_k,
block_n, max_blocks, vec, n_split, dtype, stream)``), planned as its wrapper
planned it: bf16 pairs where N, the tile width and the address allow, 32
lanes x vec columns a strip.  At the five weight shapes of a Dia-1.6B decode
step at B = 2 and at the MLP input projection at 8, 64 and 512 rows, block
density 0.5 (per-module 256 x 256 ranking, weights from a seed), bf16, it
prints one JSON line per case: the device time of each (CUDA-graph replay
over copies of the weight that together exceed the L2, in turns old, a, b,
..., b, a, old), each one's ratio to the old kernel's, and the largest
difference between the old and the current outputs; then the card's name and
power limit.

Variants (``--variants``, default ``base``): ``base`` — the source as it is;
``s128`` / ``s256`` — the 16-row tile's strip 128 / 256 columns wide (32 rows
a stage); ``w128`` — 128 columns with 64 rows a stage, ``w256t`` 256
columns, three stages, slices aimed at 2112 blocks; ``s_st6`` — six stages in
its ring; ``t1056`` / ``t264`` — slices aimed at 1056 / 264 blocks instead of
528; ``m128`` — the 64-row tile 128 columns wide; ``l_k32`` — 32 rows a stage
in the 128-row tile's ring, three stages; ``l_st5`` — five stages of 64 rows
there.  Timing only (wrong results): ``no_x``,
``no_w``, ``no_mma`` — a stage without its x copies, its weight copies or
its MMAs.

Run on the card from the repository root:
``python3 tools/torch_sparse_ab.py [--old PATH] [--variants base s256 ...] [--routes]``.
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

OLD_DEFAULT = REPO / "_parent" / "dia_tts_prune_tpu_torch" / "csrc" / "block_sparse_matmul.cu"
OLD_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
SMALL = "using Small = Cfg<1, 4, 1, 2, 64, 4>;"
MEDIUM = "using Medium = Cfg<4, 1, 1, 8, 64, 3>;"
LARGE = "using Large = Cfg<4, 2, 2, 8, 64, 4>;"
XCOPY = ("        copy8<VEC == 8>(xs + r * (C::KC + PAD) + kv, "
         "n > 0 ? x + (size_t)m * K + k : x, n);\n")
WCOPY = """        copy8<VEC == 8>(ws + r * (C::SN + PAD) + (i % WPR) * 8,
                        n > 0 ? w + (size_t)k * N + col : w, max(n, 0));
"""
MMA = """          mma_bf16(acc[tm][2 * np], a[tm], b[0], b[1]);
          mma_bf16(acc[tm][2 * np + 1], a[tm], b[2], b[3]);
"""
# name: (source edits, blocks the slices aim for: None keeps split_plan's)
VARIANTS = {
    "base": ([], None),
    "s128": ([(SMALL, "using Small = Cfg<1, 4, 1, 4, 32, 4>;")], None),
    "s256": ([(SMALL, "using Small = Cfg<1, 4, 1, 8, 32, 4>;")], None),
    "s_st6": ([(SMALL, "using Small = Cfg<1, 4, 1, 2, 64, 6>;")], None),
    "w128": ([(SMALL, "using Small = Cfg<1, 4, 1, 4, 64, 4>;")], None),
    "w256t": ([(SMALL, "using Small = Cfg<1, 4, 1, 8, 64, 3>;")], 2112),
    "t1056": ([], 1056),
    "t264": ([], 264),
    "m128": ([(MEDIUM, "using Medium = Cfg<4, 1, 1, 16, 32, 4>;")], None),
    "l_k32": ([(LARGE, "using Large = Cfg<4, 2, 2, 8, 32, 3>;")], None),
    "l_st5": ([(LARGE, "using Large = Cfg<4, 2, 2, 8, 64, 5>;")], None),
    # timing only, wrong results: what each part of a stage costs
    "no_x": ([(XCOPY, "")], None),
    "no_w": ([(WCOPY, "")], None),
    "no_mma": ([(MMA, "")], None),
}
# (case, M, K, N)
CASES = [("attn_2048x2048", 2, 2048, 2048), ("self_kv_2048x512", 2, 2048, 512),
         ("mlp_wi_2048x16384", 2, 2048, 16384), ("mlp_wo_8192x2048", 2, 8192, 2048),
         ("logits_2048x9252", 2, 2048, 9252), ("mlp_wi_B8", 8, 2048, 16384),
         ("mlp_wi_B64", 64, 2048, 16384), ("mlp_wi_M512", 512, 2048, 16384)]


def old_plan(N, block_k, block_n, max_blocks, data_ptr):
    """(vec, n_split) as the first wrapper chose them for bf16."""
    from dia_tts_prune_tpu_torch.ops.kernels import sparse_matmul as tsm

    vec = 2 if N % 2 == 0 and block_n % 2 == 0 and data_ptr % 4 == 0 else 1
    return vec, tsm.split_plan(N, block_k, block_n, max_blocks, 32 * vec)


def build(sources: dict, out_dir: Path) -> dict:
    """{name: ctypes library}: one nvcc per source text, all at once."""
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    running = {}
    for name, text in sources.items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        running[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-o", str(lib),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--old", type=Path, default=OLD_DEFAULT, help="the earlier source")
    p.add_argument("--variants", nargs="*", default=["base"], choices=list(VARIANTS))
    p.add_argument("--routes", action="store_true",
                   help="at 64+ rows also time the other tiles and slice maps")
    args = p.parse_args(argv)
    import torch

    from chip_smoke import COLD_BYTES, SPARSE_BLOCK, graph_ms, sparse_plan, sparse_weight
    from dia_tts_prune_tpu_torch.ops.kernels import _build
    from dia_tts_prune_tpu_torch.ops.kernels import sparse_matmul as tsm

    if not torch.cuda.is_available():
        print("torch_sparse_ab: CUDA is not available", file=sys.stderr)
        return 1
    if not args.old.exists():
        print(f"torch_sparse_ab: no earlier source at {args.old}", file=sys.stderr)
        return 1
    current = (_build.CSRC_DIR / "block_sparse_matmul.cu").read_text()
    sources = {"old": args.old.read_text()}
    for name in args.variants:
        text = current
        for old, new in VARIANTS[name][0]:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        sources[name] = text
    with tempfile.TemporaryDirectory(prefix="sparse_ab_") as tmp:
        libs = build(sources, Path(tmp))
        fns = {}
        for name, lib in libs.items():
            fn = lib.block_sparse_matmul_fwd
            fn.argtypes = OLD_ARGTYPES if name == "old" else tsm._ARGTYPES
            fn.restype = ctypes.c_int
            fns[name] = fn

        def call(name, x, values, indices, counts, route=None):
            (M, K), N = x.shape, values.shape[1]
            stream = torch.cuda.current_stream().cuda_stream
            if name == "old":
                vec, n_split = old_plan(N, *SPARSE_BLOCK, indices.shape[1], values.data_ptr())
                tail, fused = (1, stream), False
            else:
                vec = tsm.vector_width(x.dtype, K, N, *SPARSE_BLOCK, x.data_ptr(),
                                       values.data_ptr())
                target, tsm._BF16_TARGET_BLOCKS = tsm._BF16_TARGET_BLOCKS, (
                    VARIANTS[name][1] or tsm._BF16_TARGET_BLOCKS)
                n_split = tsm.bf16_split(N, *SPARSE_BLOCK, indices.shape[1])
                tsm._BF16_TARGET_BLOCKS = target
                tile, fused = route or tsm.mma_plan(M, N, SPARSE_BLOCK[1], vec, n_split)
                tail = (1, tile, int(fused), stream)
            out = torch.empty(M, N, dtype=x.dtype, device="cuda")
            part = torch.empty(n_split * M * N if n_split > 1 and not fused else 1,
                               device="cuda")
            err = fns[name](x.data_ptr(), values.data_ptr(), indices.data_ptr(),
                            counts.data_ptr(), out.data_ptr(), part.data_ptr(), M, K, N,
                            *SPARSE_BLOCK, indices.shape[1], vec, n_split, *tail)
            if err != 0:
                raise RuntimeError(f"{name} {route}: launch failed ({err})")
            return out

        for case, M, K, N in CASES:
            sk = sparse_weight(torch, K, N, 0.5, torch.bfloat16)
            x = torch.randn(M, K, generator=torch.Generator(device="cuda").manual_seed(7),
                            device="cuda").bfloat16()
            plan = (sk.indices, sk.counts)
            n = max(2, min(64, -(-COLD_BYTES // (2 * K * N))))
            vals = [sk.values.clone() for _ in range(n)]
            turn = iter(range(1 << 30))
            routes = [None]
            if args.routes and M >= 64:
                routes = [None, (0, False), (1, False), (1, True), (2, False), (2, True)]
            runs = ["old"] + [(v, r) for v in args.variants for r in routes]
            times = {str(r): [] for r in runs}
            for r in runs + runs[::-1]:
                name, route = (r, None) if r == "old" else r
                times[str(r)].append(graph_ms(torch, lambda: call(
                    name, x, vals[next(turn) % n], *plan, route=route), iters=2 * n) * 1e3)
            best = {k: min(v) for k, v in times.items()}
            diff = (call("old", x, sk.values, *plan).float()
                    - call(args.variants[0], x, sk.values, *plan).float()).abs().max().item()
            print(json.dumps({"case": case, "shape": {"M": M, "K": K, "N": N},
                              "density": sk.density, "plan": sparse_plan(torch, x, sk),
                              "us": times, "over_old": {k: v / best["old"]
                                                        for k, v in best.items()},
                              "max_abs_diff_old_vs_current": diff}), flush=True)
            del vals
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no card listed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
