"""Synthetic fine-tuning data from Harvard sentences (the JAX ``datagen.py``;
reference: generate_finetune_data.py).

Groups phonetically balanced sentences into [S1]/[S2]-alternating dialogue
prompts (trailing-previous-speaker-tag rule, ~2.5 words/s duration estimate,
:42-96; ``random.Random(seed)`` as in the JAX package, so one seed gives the
same prompts in both), synthesizes each prompt with ``Dia.generate``, and
writes LJSpeech-format ``wavs/`` + ``metadata.csv`` (:157-206), which
``data.FineTuneDataset`` and the ``finetune`` CLI read.

Run: ``python -m dia_tts_prune_tpu_torch.datagen --output-dir DATA
--model-name DIR [--dac-checkpoint DAC.pth] [--num-samples 50]`` (on CUDA
unless ``--device cpu`` is given).
"""

from __future__ import annotations

import argparse
import random
from pathlib import Path

import numpy as np

# Harvard sentences (phonetically balanced, public domain) — same sample set
# the reference uses (generate_finetune_data.py:18-40).
HARVARD_SENTENCES = [
    "The birch canoe slid on the smooth planks.",
    "Glue the sheet to the dark blue background.",
    "It's easy to tell the depth of a well.",
    "These days a chicken leg is a rare dish.",
    "Rice is often served in round bowls.",
    "The juice of lemons makes fine punch.",
    "The box was thrown beside the parked truck.",
    "The hogs were fed chopped corn and garbage.",
    "Four hours of steady work faced us.",
    "Large size in stockings is hard to sell.",
    "The boy was there when the sun rose.",
    "A rod is used to catch pink salmon.",
    "The source of the huge river is the clear spring.",
    "Kick the ball straight and follow through.",
    "Help the woman get back to her feet.",
    "A pot of tea helps to pass the evening.",
    "Smoky fires lack flame and heat.",
    "The soft cushion broke the man's fall.",
    "The salt breeze came across the sea.",
    "The girl at the booth sold fifty bonds.",
]


def format_dialogue_prompts(
    sentences: list[str],
    max_len_sec: float = 15,
    min_len_sec: float = 5,
    seed: int | None = None,
) -> list[str]:
    """Group sentences into speaker-alternating dialogue prompts
    (reference semantics: generate_finetune_data.py:42-96)."""
    prompts: list[str] = []
    current: list[str] = []
    speaker = 1
    est = 0.0
    words_per_sec = 2.5
    rng = random.Random(seed)
    shuffled = rng.sample(sentences, len(sentences))

    def finalize():
        nonlocal current, speaker, est
        if current and est >= min_len_sec:
            final_tag = f"[S{2 if speaker == 1 else 1}]"
            prompts.append((" ".join(current) + f" {final_tag}").strip())
        current, speaker, est = [], 1, 0.0

    for sentence in shuffled:
        sentence = sentence.strip().rstrip(".")
        inc = len(sentence.split()) / words_per_sec
        if est + inc > max_len_sec and current:
            finalize()
        current.append(f"[S{speaker}] {sentence}.")
        est += inc
        speaker = 2 if speaker == 1 else 1
    finalize()
    return prompts


def generate_dataset(
    dia,
    output_dir: str | Path,
    num_samples: int = 50,
    min_len_sec: float = 6,
    max_len_sec: float = 18,
    seed: int = 42,
    voice_prompt_audio: str | None = None,
    voice_prompt_text: str | None = None,
    sample_rate: int = 44100,
    **generate_kwargs,
) -> list[tuple[str, str]]:
    """Synthesize prompts → wavs/ + metadata.csv (LJSpeech layout).

    Returns the (wav_name, text) metadata rows. Per-sample failures are
    skipped with a warning (reference: generate_finetune_data.py:195-198).
    """
    output_dir = Path(output_dir)
    wav_dir = output_dir / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)

    prompts = format_dialogue_prompts(
        HARVARD_SENTENCES, max_len_sec=max_len_sec, min_len_sec=min_len_sec, seed=seed
    )
    while 0 < len(prompts) < num_samples:
        prompts = prompts + prompts  # cycle to reach the requested count
    prompts = prompts[:num_samples]

    metadata: list[tuple[str, str]] = []
    for i, prompt in enumerate(prompts):
        try:
            wav = dia.generate(
                prompt,
                seed=seed + i,
                audio_prompt=voice_prompt_audio,
                audio_prompt_text=voice_prompt_text,
                **generate_kwargs,
            )
            if wav is None or np.size(wav) == 0:
                print(f"Warning: empty generation for sample {i}; skipping.")
                continue
            name = f"sample_{i:05d}.wav"
            dia.save_audio(wav_dir / name, wav, sample_rate)
            metadata.append((name, prompt))
        except Exception as e:  # noqa: BLE001 — per-sample skip by design
            print(f"Warning: generation failed for sample {i}: {e}")

    with open(output_dir / "metadata.csv", "w", encoding="utf-8") as f:
        for name, text in metadata:
            f.write(f"{name}|{text}\n")
    return metadata


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Generate fine-tuning data with the PyTorch/CUDA Dia port + Harvard sentences"
    )
    parser.add_argument("--output-dir", type=str, required=True)
    parser.add_argument("--model-name", type=str, default="nari-labs/Dia-1.6B",
                        help="Local model directory (config.json + weights).")
    parser.add_argument("--dac-checkpoint", type=str, default=None)
    parser.add_argument("--num-samples", type=int, default=50)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--min-len-sec", type=float, default=6)
    parser.add_argument("--max-len-sec", type=float, default=18)
    parser.add_argument("--compute-dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--voice-prompt-audio", type=str, default=None)
    parser.add_argument("--voice-prompt-text", type=str, default=None)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda).")
    args = parser.parse_args(argv)

    if args.voice_prompt_audio and not args.voice_prompt_text:
        parser.error("--voice-prompt-text is required with --voice-prompt-audio")

    from .api import Dia

    dia = Dia.from_pretrained(args.model_name, compute_dtype=args.compute_dtype,
                              dac_checkpoint=args.dac_checkpoint, device=args.device)
    rows = generate_dataset(
        dia, args.output_dir, num_samples=args.num_samples, seed=args.seed,
        min_len_sec=args.min_len_sec, max_len_sec=args.max_len_sec,
        voice_prompt_audio=args.voice_prompt_audio,
        voice_prompt_text=args.voice_prompt_text,
    )
    print(f"Wrote {len(rows)} samples to {args.output_dir}")


if __name__ == "__main__":
    main()
