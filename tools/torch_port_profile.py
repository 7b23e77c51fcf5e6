#!/usr/bin/env python3
"""Where a decode step's time goes in the PyTorch/CUDA port.

Builds the Dia-1.6B shapes (bf16, weights from a numpy seed), conditions on a
two-speaker text, then runs decode steps of ``models.dia.decode_step`` as the
generation loop does, including the per-step read-back of the sampled codes.
Prints one JSON line:

* ``host_ms_per_step``  — wall time per step (host clock, synchronised);
* ``device_ms_per_step`` — summed CUDA kernel time per step (torch.profiler);
* ``device_idle_share`` — 1 - device / host time;
* ``top_kernels``       — kernel names by device time per step;
* the card's name and power limit.

Run on the card: ``python3 tools/torch_port_profile.py [--steps 64]``.
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
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from dia_tts_prune_tpu_torch.api import resolve_device
    from dia_tts_prune_tpu_torch.config import dia_1_6b_config, tiny_test_config
    from dia_tts_prune_tpu_torch.generate import CFG_BATCH, _cross_window_for, conditioning
    from dia_tts_prune_tpu_torch.models.dia import decode_step, init_params, new_self_cache
    from dia_tts_prune_tpu_torch.ops.sampling import apply_constraints, cfg_combine
    from dia_tts_prune_tpu_torch.tokenizer import encode_cfg_batch

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cfg = tiny_test_config(audio_length=256) if args.tiny else dia_1_6b_config()
    dtype = torch.float32 if args.tiny else torch.bfloat16
    d = cfg.data
    params = init_params(cfg, seed=0, dtype=dtype, device=dev)
    enc = encode_cfg_batch("[S1] Dia is an open weights text to dialogue model. [S2] Wow.",
                           d.text_length, d.text_pad_value)
    with torch.no_grad():
        cross, _, ends = conditioning(params, cfg, torch.from_numpy(enc).to(dev), dtype,
                                      _cross_window_for(enc, cfg))
    cache = new_self_cache(cfg, CFG_BATCH, min(1024, d.audio_length), dtype, dev)
    tok = np.full((d.channels,), d.audio_bos_value, np.int32)

    def step(t):
        tgt = torch.from_numpy(tok).to(dev)[None, None].expand(CFG_BATCH, 1, -1)
        pos = torch.full((CFG_BATCH, 1), t, dtype=torch.int64, device=dev)
        logits = decode_step(params, cfg, tgt, pos, t - 1, cache, cross, ends, dtype)
        guided = apply_constraints(cfg_combine(logits[:, -1], 3.0), d.audio_eos_value,
                                   d.audio_pad_value, d.audio_bos_value)
        return torch.argmax(guided, dim=-1).cpu().numpy()  # the loop's one read-back

    sync = torch.cuda.synchronize if cuda else (lambda: None)
    with torch.no_grad():
        for t in range(1, 9):  # warm-up
            step(t)
        sync()
        t0 = time.perf_counter()
        for t in range(9, 9 + args.steps):
            step(t)
        sync()
        host_ms = 1e3 * (time.perf_counter() - t0) / args.steps
        result = {"tool": "torch_port_profile", "config": "tiny" if args.tiny else "dia_1_6b bf16",
                  "cache_len": cache.k.shape[2], "steps": args.steps,
                  "host_ms_per_step": host_ms}
        if cuda:
            from torch.profiler import ProfilerActivity, profile

            n_prof = min(16, args.steps)
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for t in range(9 + args.steps, 9 + args.steps + n_prof):
                    step(t)
                sync()
            from torch.autograd import DeviceType

            rows = []
            for ev in prof.key_averages():  # kernel rows only: op rows repeat their time
                if ev.device_type != DeviceType.CUDA:
                    continue
                dev_us = getattr(ev, "self_device_time_total", None)
                if dev_us is None:
                    dev_us = ev.self_cuda_time_total
                rows.append((ev.key, dev_us / n_prof / 1e3, ev.count / n_prof))
            rows.sort(key=lambda r: -r[1])
            device_ms = sum(r[1] for r in rows)
            result.update({
                "device_ms_per_step": device_ms,
                "device_idle_share": max(0.0, 1.0 - device_ms / host_ms),
                "launches_per_step": sum(r[2] for r in rows),
                "top_kernels": [{"name": k[:80], "ms_per_step": ms, "calls_per_step": c}
                                for k, ms, c in rows[:12]],
                "card": subprocess.run(
                    ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                    capture_output=True, text=True, check=True).stdout.strip(),
            })
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
