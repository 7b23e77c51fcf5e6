#!/usr/bin/env python3
"""Time the bf16 tensor-core flash kernels against edited copies of themselves.

Each variant is a list of (old, new) text edits of ``csrc/flash_attention.cu``
(forward with log-sum-exp rows) or ``csrc/flash_attention_bwd.cu`` (dK/dV and
dQ), built by nvcc into a library of its own and called through the same C
entry points as the wrappers.  At the attention sites of a
Dia-1.6B training step (E, S, C) and of serving (encoder, prefill) it prints,
per site, kernel and variant, the device time (CUDA-graph replay, the
variants in turns a b b a) and the gate ratio
``max(|out - ref| - 2^-8 |ref|) / atol`` against the plain version in fp32
(atol 1e-5 forward, 1e-4 dK/dV and dQ, as in ``chip_smoke.py``; the gate
passes at <= 1), the registers and spills ptxas reports, then the card's name
and power limit.

Variants:

* ``base`` — the sources as they are;
* ``one_bf16_rounding`` — P (forward), P^T, dS^T (dK/dV) and dS (dQ) enter
  their MMAs once, rounded to bf16, instead of as hi + lo pairs: the time the
  split costs, and the gate it would miss;
* ``qs16`` — dK/dV computes S^T and dP^T 16 queries at a time instead of 32
  (fewer live registers, more reloads of the K/V fragments);
* ``ks64`` — dQ computes S and dP for all 64 keys of a tile at once instead
  of 32 at a time (more live registers, fewer passes).

Run on the card: ``python3 tools/torch_flash_variants.py [variant ...]``.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

FWD, BWD = "flash_attention", "flash_attention_bwd"
LO_FWD = ["      mma_bf16(acc[2 * dp], lo, b[0], b[1]);\n",
          "      mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);\n"]
LO_BWD = ["        mma_bf16(dv[2 * dp], p_lo, b[0], b[1]);\n",
          "        mma_bf16(dv[2 * dp + 1], p_lo, b[2], b[3]);\n",
          "        mma_bf16(dk[2 * dp], s_lo, b[0], b[1]);\n",
          "        mma_bf16(dk[2 * dp + 1], s_lo, b[2], b[3]);\n",
          "        mma_bf16(dq[2 * hp], lo, b[0], b[1]);\n",
          "        mma_bf16(dq[2 * hp + 1], lo, b[2], b[3]);\n"]
VARIANTS = {
    "base": {FWD: [], BWD: []},
    "one_bf16_rounding": {FWD: [(line, "") for line in LO_FWD],
                          BWD: [(line, "") for line in LO_BWD]},
    "qs16": {BWD: [("constexpr int QS = 32;", "constexpr int QS = 16;")]},
    "ks64": {BWD: [("constexpr int KS = 32;", "constexpr int KS = 64;")]},
}
# B, Tq, Tk, Nq, Nkv, H, causal, real lengths of q and kv per batch row (None: all real)
SITES = {
    "encoder": (2, 1024, 1024, 16, 16, 128, False, [0, 300], [0, 300]),
    "prefill": (2, 512, 512, 16, 4, 128, True, [499, 499], [499, 499]),
    "E": (2, 1024, 1024, 16, 16, 128, False, [700, 300], [700, 300]),
    "S": (2, 3072, 3072, 16, 4, 128, True, None, None),
    "C": (2, 3072, 1024, 16, 16, 128, False, None, [700, 300]),
}


def build(variants: dict, out_dir: Path) -> dict:
    """{(variant, source): (ctypes library, ptxas report)}, one nvcc each, all at once."""
    from chip_smoke import ptxas_report
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    running = {}
    for name, edits_by_source in variants.items():
        for source, edits in edits_by_source.items():
            text = (_build.CSRC_DIR / f"{source}.cu").read_text()
            for old, new in edits:
                if text.count(old) < 1:
                    raise RuntimeError(f"variant {name}: {old!r} is not in {source}.cu")
                text = text.replace(old, new)
            src = out_dir / f"{name}_{source}.cu"
            src.write_text(text)
            lib = out_dir / f"lib{name}_{source}.so"
            running[name, source] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC_DIR), "-Xptxas",
                 "-v", "-o", str(lib), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT))
    built = {}
    for key, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {key}: nvcc failed\n{log.decode(errors='replace')}")
        report = {k: v for k, v in ptxas_report(log.decode(errors="replace")).items()
                  if re.search("mma", k)}
        built[key] = (ctypes.CDLL(str(lib)), report)
    return built


def main() -> int:
    import torch

    from chip_smoke import graph_ms

    fa = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.flash_attention")
    if not torch.cuda.is_available():
        print("torch_flash_variants: CUDA is not available", file=sys.stderr)
        return 1
    names = sys.argv[1:] or list(VARIANTS)
    unknown = set(names) - set(VARIANTS)
    if unknown:
        print(f"unknown variants {sorted(unknown)}; known: {list(VARIANTS)}", file=sys.stderr)
        return 1
    with tempfile.TemporaryDirectory(prefix="flash_variants_") as tmp:
        built = build({n: VARIANTS[n] for n in names}, Path(tmp))
        for (name, source), (_, report) in built.items():
            print(json.dumps({"variant": name, "source": source, "ptxas": report}), flush=True)

        def call(name, kernel, q, k, v, qs, ks, causal, lse=None, dout=None, dd=None):
            lib = built[name, FWD if kernel == "forward_lse" else BWD][0]
            B, Tq, Nq, H = q.shape
            Tk, Nkv = k.shape[1], k.shape[2]
            stream = torch.cuda.current_stream().cuda_stream
            if kernel == "forward_lse":
                fn, argtypes = lib.flash_attention_fwd_lse, fa._LSE_ARGTYPES
                out = (torch.empty_like(q), torch.empty(B, Nq, Tq, device="cuda"))
                ptrs = (q, k, v, qs, ks, *out)
            elif kernel == "bwd_kv":
                fn, argtypes = lib.flash_attention_bwd_kv, fa._BWD_KV_ARGTYPES
                out = (torch.empty_like(k), torch.empty_like(v))
                ptrs = (q, k, v, dout, lse, dd, qs, ks, *out)
            else:
                fn, argtypes = lib.flash_attention_bwd_q, fa._BWD_Q_ARGTYPES
                out = (torch.empty_like(q),)
                ptrs = (q, k, v, dout, lse, dd, qs, ks, *out)
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
            err = fn(*(t.data_ptr() for t in ptrs), B, Tq, Tk, Nq, Nkv, H, 1, int(causal),
                     stream)
            if err != 0:
                raise RuntimeError(f"variant {name} {kernel}: launch failed ({err})")
            return out

        def gate(got, ref, atol):
            return (((got.float() - ref).abs() - 2.0 ** -8 * ref.abs()).max() / atol).item()

        for site, (B, Tq, Tk, Nq, Nkv, H, causal, q_real, kv_real) in SITES.items():
            g = torch.Generator(device="cuda").manual_seed(5)
            q, k, v, dout = (torch.randn(*s, generator=g, device="cuda").bfloat16() for s in (
                (B, Tq, Nq, H), (B, Tk, Nkv, H), (B, Tk, Nkv, H), (B, Tq, Nq, H)))

            def seg(T, real):
                if real is None:
                    return torch.ones(B, T, dtype=torch.int32, device="cuda")
                return (torch.arange(T, device="cuda")[None] < torch.tensor(
                    real, device="cuda")[:, None]).to(torch.int32).contiguous()

            qs, ks = seg(Tq, q_real), seg(Tk, kv_real)
            wide = (q.float(), k.float(), v.float())
            ref_out, lse = fa.flash_attention_lse_plain(*wide, qs, ks, causal)
            out = ref_out.bfloat16()
            dd = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            ref_dq, ref_dk, ref_dv = fa.flash_attention_bwd_plain(
                *wide, qs, ks, out.float(), lse, dout.float(), causal)
            refs = {"forward_lse": ((ref_out, 1e-5),), "bwd_kv": ((ref_dk, 1e-4), (ref_dv, 1e-4)),
                    "bwd_q": ((ref_dq, 1e-4),)}
            for kernel, source in (("forward_lse", FWD), ("bwd_kv", BWD), ("bwd_q", BWD)):
                runs = [n for n in names if (n, source) in built]
                times = {n: [] for n in runs}
                for n in runs + runs[::-1]:  # in turns: a b b a
                    args = (n, kernel, q, k, v, qs, ks, causal, lse, dout, dd)
                    times[n].append(graph_ms(torch, lambda: call(*args), iters=8) * 1e3)
                for n in runs:
                    got = call(n, kernel, q, k, v, qs, ks, causal, lse, dout, dd)
                    ratio = max(gate(g, ref, atol) for g, (ref, atol) in zip(got, refs[kernel]))
                    print(json.dumps({"site": site, "kernel": kernel, "variant": n,
                                      "us": times[n], "gate_ratio": ratio}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no card listed", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
