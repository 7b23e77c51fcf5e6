"""Offline pruning CLI of the port (counterpart of
``dia_tts_prune_tpu/offline_prune.py``; reference: offline_prune.py:28-178).

load → prune (unstructured global L1 | structured per-layer Ln | block L1 |
physical FFN or head shrink) → sparsity report → save a checkpoint in the
reference key schema: ``config.json``, ``prune_report.json`` and
``pytorch_model.bin`` (or ``model.safetensors``), which this package, the JAX
package and the torch reference load.  Block-pruned output serves sparse
after ``Dia.from_pretrained(out).sparsify_block(block)``.  Runs on CUDA
unless ``--device cpu`` is given.

Run: ``python -m dia_tts_prune_tpu_torch.offline_prune --model-path … --output-dir …
--prune-mode unstructured --prune-amount 0.6``
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Offline pruning for the PyTorch/CUDA Dia port")
    p.add_argument("--model-path", type=str, required=True,
                   help="Local model dir (config.json + weights).")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--prune-mode", type=str, required=True,
                   choices=["unstructured", "structured", "block", "shrink-ffn", "shrink-heads"])
    p.add_argument("--prune-amount", type=float, required=True,
                   help="Fraction of weights/structures to prune (0, 1).")
    p.add_argument("--prune-dim", type=int, default=0,
                   help="Structured mode: dimension of the per-module weight to prune along.")
    p.add_argument("--prune-norm", type=int, default=2, choices=[1, 2])
    p.add_argument("--block-size", type=int, nargs=2, default=[256, 256], metavar=("BK", "BN"),
                   help="block mode: block granularity (the block-sparse matmul's tiles)")
    p.add_argument("--compute-dtype", type=str, default="float32", choices=["float32"])
    p.add_argument("--save-format", type=str, default="auto",
                   choices=["auto", "torch", "safetensors"],
                   help="auto = torch (pytorch_model.bin), as the JAX CLI picks where torch "
                        "is installed")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda).")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if not 0.0 < args.prune_amount < 1.0:
        parser.error("--prune-amount must be in (0.0, 1.0) exclusive.")

    import numpy as np
    import torch

    from .api import Dia
    from .checkpoint import to_torch_state_dict
    from .prune import (
        apply_masks,
        block_masks,
        shrink_ffn,
        shrink_heads,
        sparsity_report,
        structured_masks,
        unstructured_masks,
    )

    t0 = time.time()
    dia = Dia.from_pretrained(args.model_path, compute_dtype=args.compute_dtype,
                              device=args.device)
    config, params = dia.config, dia.params
    print(f"Loaded model from {args.model_path} in {time.time() - t0:.1f}s")

    mode = args.prune_mode
    if mode == "unstructured":
        pruned = apply_masks(params, unstructured_masks(params, args.prune_amount))
    elif mode == "structured":
        pruned = apply_masks(params, structured_masks(params, args.prune_amount,
                                                      dim=args.prune_dim, n=args.prune_norm))
    elif mode == "block":
        pruned = apply_masks(params, block_masks(params, args.prune_amount,
                                                 block=tuple(args.block_size)))
    elif mode == "shrink-heads":
        pruned, config = shrink_heads(params, config, keep_fraction=1.0 - args.prune_amount)
    else:  # shrink-ffn: physically smaller shapes
        pruned, config = shrink_ffn(params, config, keep_fraction=1.0 - args.prune_amount)

    report = sparsity_report(pruned)
    print(f"Sparsity: {report['sparsity']:.4f} "
          f"({report['zero_params']}/{report['total_params']} zero parameters)")

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    config.save(out / "config.json")
    (out / "prune_report.json").write_text(
        json.dumps({k: v for k, v in report.items() if k != "per_module"}, indent=2))

    sd = to_torch_state_dict(pruned, config)
    if args.save_format == "safetensors":
        from safetensors.numpy import save_file

        save_file(sd, str(out / "model.safetensors"))
        print(f"Saved pruned checkpoint to {out / 'model.safetensors'}")
    else:
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()},
                   out / "pytorch_model.bin")
        print(f"Saved pruned checkpoint to {out / 'pytorch_model.bin'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
