"""Command-line generation front-end of the port (the JAX ``cli.py``;
reference: cli.py:35-233).

Flag-compatible with the JAX CLI: text + ``--output``, model loading
(``--model-path`` / ``--config`` / ``--pruned-checkpoint`` /
``--adapter-path``, the codec from ``--dac-checkpoint`` / ``--dac-config``),
voice cloning (``--audio-prompt`` / ``--audio-prompt-text``: WAV, FLAC, mp3,
or ogg / m4a / … where the system FFmpeg libraries are), sampling parameters,
dtype, seeding.  Runs on CUDA unless ``--device cpu`` is given; the output's
extension picks the format (``utils/audio_io.py::write_audio``).

Run: ``python -m dia_tts_prune_tpu_torch.cli "[S1] Hello." --output out.wav
--model-path DIR`` where DIR holds config.json and model.safetensors (or
pytorch_model.bin), and the codec as dac_config.json + dac.safetensors unless
``--dac-checkpoint`` names a torch DAC checkpoint.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Generate dialogue audio with the PyTorch/CUDA Dia port.")
    parser.add_argument("text", type=str,
                        help="Input text to generate (not the prompt transcript).")
    parser.add_argument("--output", type=str, required=True,
                        help="Output audio path (.wav, .flac; .mp3, .ogg, .opus, .m4a, "
                             ".aac through the system FFmpeg libraries).")

    model_group = parser.add_argument_group("Model Loading")
    model_group.add_argument("--model-path", type=str, default="nari-labs/Dia-1.6B",
                             help="Local model directory (config.json + weights).")
    model_group.add_argument("--config", type=str, default=None,
                             help="Path to a local config.json (overrides --model-path's).")
    model_group.add_argument("--pruned-checkpoint", type=str, default=None,
                             help="Path to a (pruned) checkpoint file; requires --config "
                                  "unless --model-path is a local dir.")
    model_group.add_argument("--adapter-path", type=str, default=None,
                             help="LoRA adapter directory (fused into the base weights).")
    model_group.add_argument("--dac-checkpoint", type=str, default=None,
                             help="Path to a torch DAC checkpoint (.pth) for the codec.")
    model_group.add_argument("--dac-config", type=str, default=None,
                             help="JSON file overriding the DAC architecture "
                                  "(defaults to the published 44.1 kHz model).")

    prompt_group = parser.add_argument_group("Audio Prompting (Voice Cloning)")
    prompt_group.add_argument("--audio-prompt", type=str, default=None,
                              help="Audio prompt (WAV, FLAC, mp3; ogg, m4a, ... through "
                                   "the system FFmpeg libraries) for voice cloning "
                                   "(5-10 s recommended).")
    prompt_group.add_argument("--audio-prompt-text", type=str, default=None,
                              help="Required: exact transcript of --audio-prompt.")

    gen_group = parser.add_argument_group("Generation Parameters")
    gen_group.add_argument("--max-tokens", type=int, default=None)
    gen_group.add_argument("--cfg-scale", type=float, default=3.0)
    gen_group.add_argument("--temperature", type=float, default=1.3)
    gen_group.add_argument("--top-p", type=float, default=0.95)
    gen_group.add_argument("--cfg-filter-top-k", type=int, default=35)
    gen_group.add_argument("--seed", type=int, default=None)

    infra_group = parser.add_argument_group("Infrastructure")
    infra_group.add_argument("--device", type=str, default="cuda",
                             help="torch device (default: cuda).")
    infra_group.add_argument("--compute-dtype", type=str, default="bfloat16",
                             choices=["bfloat16", "float32"])
    infra_group.add_argument("--verbose", action="store_true")
    return parser


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)

    if args.audio_prompt and not args.audio_prompt_text:
        parser.error("--audio-prompt-text is required when --audio-prompt is used "
                     "(it must contain the exact transcript of the prompt audio).")
    if args.pruned_checkpoint and not args.config and not Path(args.model_path).is_dir():
        parser.error("--pruned-checkpoint requires --config (or a local --model-path dir).")

    from .api import Dia

    try:
        if args.pruned_checkpoint:
            config_path = args.config or str(Path(args.model_path) / "config.json")
            dia = Dia.from_local(config_path, args.pruned_checkpoint,
                                 compute_dtype=args.compute_dtype,
                                 dac_checkpoint=args.dac_checkpoint,
                                 dac_config=args.dac_config, device=args.device)
        else:
            dia = Dia.from_pretrained(args.model_path, compute_dtype=args.compute_dtype,
                                      dac_checkpoint=args.dac_checkpoint,
                                      dac_config=args.dac_config, device=args.device)
    except FileNotFoundError as e:
        print(f"Error loading model: {e}", file=sys.stderr)
        return 1

    if args.adapter_path:
        dia.load_adapter_weights(args.adapter_path)

    audio = dia.generate(
        args.text,
        max_tokens=args.max_tokens,
        cfg_scale=args.cfg_scale,
        temperature=args.temperature,
        top_p=args.top_p,
        cfg_filter_top_k=args.cfg_filter_top_k,
        audio_prompt=args.audio_prompt,
        audio_prompt_text=args.audio_prompt_text,
        seed=args.seed,
        verbose=args.verbose,
    )
    if audio is None:
        print("Generation produced no audio.", file=sys.stderr)
        return 1
    dia.save_audio(args.output, audio, dia.dac_config.sample_rate)
    if args.verbose:
        print(f"Saved {audio.shape[-1] / dia.dac_config.sample_rate:.2f}s of audio "
              f"to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
