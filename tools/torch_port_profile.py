#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port.

Builds the Dia-1.6B shapes (bf16, weights from a numpy seed), conditions on a
two-speaker text, then runs decode steps of ``models.dia.decode_step`` as the
generation loop does, including the per-step read-back of the sampled codes.
``--quant int8|int4`` packs the decoder first (``ops/quant.py``) and keeps both
KV caches int8, as ``Dia.quantize_int8()`` / ``quantize_int4()`` then
``generate`` do.  ``--prune module|global`` zeroes half of the 256 x 256
weight blocks (``prune.block_masks`` with that ranking) and packs the
decoder as ``BlockSparseKernel``s, as ``Dia.prune_block_sparse(0.5,
scope=...)`` does.  ``--streams N`` runs N streams' 2N CFG rows per step, as
``generate_tokens_batch`` does.  ``--fused [--fused-int4]`` packs int8 with
the fused-step pack (``Dia.quantize_int8(fused=True[, fused_mlp_int4=True])``)
and measures the fused step (``models.dia.decode_step_fused``: one kernel
launch for the decoder stack) and, in the same call on the same weights and
caches, the unfused int8 ``decode_step``; ``fused_kernel_ms_per_step`` and
``other_ms_per_step`` split the fused step's device time.  Prints one JSON
line:

* ``host_ms_per_step``  — wall time per step (host clock, synchronised);
* ``device_ms_per_step`` — summed CUDA kernel time per step (torch.profiler);
* ``device_idle_share`` — 1 - device / host time;
* ``top_kernels``       — kernel names by device time per step;
* ``decode_attention_ms_per_step`` and ``decode_attention_launches_per_step``
  — the decode-attention kernel's share (36 launches an unfused step);
* ``int8_matmul_ms_per_step`` and ``int8_matmul_launches_per_step`` — the
  int8-matmul kernels' share (145 calls a packed int8 step);
* ``int4_gemv_ms_per_step`` and ``int4_gemv_launches_per_step`` — the int4
  GEMV kernels' share (145 calls a packed int4 step; the cluster kernel, or
  the split-K design's kernel and finish pass of older sources);
* the card's name and power limit.

Run on the card: ``python3 tools/torch_port_profile.py [--steps 64] [--quant int8]
[--prune module] [--streams 4] [--fused [--fused-int4]]``.
``--tiny --device cpu`` rehearses the script on the CPU (no device numbers).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="tiny_test_config (rehearsal)")
    p.add_argument("--quant", choices=("none", "int8", "int4"), default="none",
                   help="pack the decoder's kernels and keep the KV caches int8")
    p.add_argument("--prune", choices=("none", "module", "global"), default="none",
                   help="block-prune half the 256 x 256 blocks with this ranking, then "
                        "serve the decoder block-sparse")
    p.add_argument("--streams", type=int, default=1, help="streams decoded together")
    p.add_argument("--fused", action="store_true",
                   help="int8 with the fused-step pack; also times the unfused int8 step")
    p.add_argument("--fused-int4", action="store_true", help="the fused pack's MLP in int4")
    args = p.parse_args(argv)
    if args.fused_int4:
        args.fused = True
    if args.fused:
        args.quant = "int8"

    import numpy as np
    import torch

    from dia_tts_prune_tpu_torch.api import resolve_device
    from dia_tts_prune_tpu_torch.config import dia_1_6b_config, tiny_test_config
    from dia_tts_prune_tpu_torch.generate import _cross_window_for, conditioning
    from dia_tts_prune_tpu_torch.models.dia import (
        decode_step,
        decode_step_fused,
        init_params,
        new_self_cache,
        quantize_cache,
    )
    from dia_tts_prune_tpu_torch.ops.quant import (
        quantize_params_int4_packed,
        quantize_params_int8_packed,
    )
    from dia_tts_prune_tpu_torch.ops.sparse import sparsify_params_block, sparsity_summary
    from dia_tts_prune_tpu_torch.prune import apply_masks, block_masks
    from dia_tts_prune_tpu_torch.tokenizer import encode_cfg_batch

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cfg = tiny_test_config(audio_length=256) if args.tiny else dia_1_6b_config()
    dtype = torch.float32 if args.tiny else torch.bfloat16
    d = cfg.data
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    quant = args.quant != "none"
    if args.quant == "int8":
        params = quantize_params_int8_packed(params, fused=args.fused,
                                             fused_mlp_int4=args.fused_int4)
    elif args.quant == "int4":
        params = quantize_params_int4_packed(params, halfsplit=True)
    if args.prune != "none":
        blocks = (32, 64) if args.tiny else (256, 256)
        params = apply_masks(params, block_masks(params, 0.5, blocks, scope=args.prune))
        params = sparsify_params_block(params, block_k=blocks[0], block_n=blocks[1])
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    N = args.streams
    rows = 2 * N  # [uncond x N; cond x N]
    enc = encode_cfg_batch("[S1] Dia is an open weights text to dialogue model. [S2] Wow.",
                           d.text_length, d.text_pad_value)
    enc = np.concatenate([enc[:1]] * N + [enc[1:]] * N)
    with torch.no_grad():
        cross, _, ends = conditioning(params, cfg, torch.from_numpy(enc).to(dev), dtype,
                                      _cross_window_for(enc, cfg))
    if quant:
        cross = quantize_cache(cross)
    cache = new_self_cache(params, cfg, rows, min(1024, d.audio_length), dtype, dev, quant=quant)
    tok = np.full((d.channels,), d.audio_bos_value, np.int32)

    def step(t, fn):
        tgt = torch.from_numpy(tok).to(dev)[None, None].expand(rows, 1, -1)
        pos = torch.full((rows, 1), t, dtype=torch.int64, device=dev)
        logits = fn(params, cfg, tgt, pos, t - 1, cache, cross, ends, dtype)[:, 0]
        guided = logits[N:] + 3.0 * (logits[N:] - logits[:N])  # cfg_combine per stream
        return torch.argmax(guided, dim=-1).cpu().numpy()  # the loop's one read-back

    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def measure(fn) -> dict:
        """Host and device time of ``args.steps`` steps of ``fn``."""
        with torch.no_grad():
            for t in range(1, 9):  # warm-up
                step(t, fn)
            sync()
            t0 = time.perf_counter()
            for t in range(9, 9 + args.steps):
                step(t, fn)
            sync()
            host_ms = 1e3 * (time.perf_counter() - t0) / args.steps
            out = {"host_ms_per_step": host_ms}
            if not cuda:
                return out
            from torch.autograd import DeviceType
            from torch.profiler import ProfilerActivity, profile

            n_prof = min(16, args.steps)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for t in range(9 + args.steps, 9 + args.steps + n_prof):
                    step(t, fn)
                sync()
        kernels = []
        for ev in prof.key_averages():  # kernel rows only: op rows repeat their time
            if ev.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = ev.self_cuda_time_total
            kernels.append((ev.key, dev_us / n_prof / 1e3, ev.count / n_prof))
        kernels.sort(key=lambda r: -r[1])
        device_ms = sum(r[1] for r in kernels)
        fused_ms = sum(r[1] for r in kernels if "fused_step_kernel" in r[0])
        # the decode-attention kernel (and the split-K design's two kernels, for older sources)
        attn = [r for r in kernels
                if any(n in r[0] for n in ("decode_attention_kernel", "decode_partial_kernel",
                                           "decode_combine_kernel"))]
        # the int8-matmul kernels (the cluster kernel; the split-K design's kernel
        # and finish pass, for older sources)
        gemv8 = [r for r in kernels if "int8_matmul" in r[0]]
        gemv4 = [r for r in kernels if "int4_gemv" in r[0]]
        out.update({
            "device_ms_per_step": device_ms,
            "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
            "launches_per_step": sum(r[2] for r in kernels),
            "decode_attention_ms_per_step": sum(r[1] for r in attn),
            "decode_attention_launches_per_step": sum(r[2] for r in attn),
            "int8_matmul_ms_per_step": sum(r[1] for r in gemv8),
            "int8_matmul_launches_per_step": sum(r[2] for r in gemv8),
            "int4_gemv_ms_per_step": sum(r[1] for r in gemv4),
            "int4_gemv_launches_per_step": sum(r[2] for r in gemv4),
            "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": c}
                            for k, ms, c in kernels[:12]],
        })
        if fused_ms:
            out.update({"fused_kernel_ms_per_step": fused_ms,
                        "other_ms_per_step": device_ms - fused_ms})
        return out

    result = {"tool": "torch_port_profile", "config": "tiny" if args.tiny else "dia_1_6b bf16",
              "quant": args.quant, "prune": args.prune, "streams": N,
              "cache_len": cache.k.shape[2], "steps": args.steps}
    if args.fused:
        result["fused"] = "int4-MLP" if args.fused_int4 else "int8"
        result["pack_weight_bytes"] = params["decoder"]["fused_pack"].weight_bytes()
        result.update(measure(decode_step_fused))
        result["unfused_int8"] = measure(decode_step)
    else:
        result.update(measure(decode_step))
    if cuda:
        result.update({
            "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
            "card": subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                capture_output=True, text=True, check=True).stdout.strip(),
        })
    if args.prune != "none":
        result["block_density"] = sparsity_summary(params)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
