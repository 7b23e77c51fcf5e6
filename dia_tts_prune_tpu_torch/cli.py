"""Command-line generation front-end of the port.

Run: ``python -m dia_tts_prune_tpu_torch.cli --model-path DIR --text "[S1] Hello." --out x.wav``
where DIR holds config.json, model.safetensors, dac_config.json and
dac.safetensors.  Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Generate dialogue audio with the PyTorch/CUDA Dia port.")
    p.add_argument("--text", required=True, help="Input text, e.g. '[S1] Hello. [S2] Hi!'")
    p.add_argument("--out", required=True, help="Output WAV path.")
    p.add_argument("--model-path", required=True,
                   help="Local model directory (config.json, model.safetensors, dac files).")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda).")
    p.add_argument("--compute-dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--max-tokens", type=int, default=None)
    p.add_argument("--cfg-scale", type=float, default=3.0)
    p.add_argument("--temperature", type=float, default=1.3)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--cfg-filter-top-k", type=int, default=35)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--verbose", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from .api import Dia

    try:
        dia = Dia.from_pretrained(args.model_path, compute_dtype=args.compute_dtype,
                                  device=args.device)
    except FileNotFoundError as e:
        print(f"Error loading model: {e}", file=sys.stderr)
        return 1
    audio = dia.generate(args.text, max_tokens=args.max_tokens, cfg_scale=args.cfg_scale,
                         temperature=args.temperature, top_p=args.top_p,
                         cfg_filter_top_k=args.cfg_filter_top_k, seed=args.seed,
                         verbose=args.verbose)
    if audio is None:
        print("Generation produced no audio.", file=sys.stderr)
        return 1
    dia.save_audio(args.out, audio, dia.dac_config.sample_rate)
    if args.verbose:
        print(f"Saved {audio.shape[-1] / dia.dac_config.sample_rate:.2f}s of audio to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
