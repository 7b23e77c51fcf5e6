"""Fine-tuning CLI of the port (counterpart of ``dia_tts_prune_tpu/finetune.py``;
reference: finetune.py:266-623).

Full, LoRA or quantization-aware fine-tuning over an LJSpeech-format dataset
(``metadata.csv`` with ``name|text`` lines, ``wavs/``), with periodic
checkpointing (:563-581), resume, and a final save (:588-621): the LoRA
adapter, ``pytorch_model.bin`` in the reference key schema (loadable by this
package, the JAX package and the torch reference), ``config.json`` and the
codec files.  ``--prune-before unstructured|structured`` prunes the weights
first (``prune.py``, as the JAX CLI at its finetune.py:119-128) and trains the
masked dense weights.  Runs on CUDA unless ``--device cpu`` is given.

The codec comes from the model directory's ``dac.safetensors``, or from a
torch DAC checkpoint given by ``--dac-checkpoint``.

``--mesh-data D --mesh-model M [--fsdp]`` trains under a (D, M) mesh (the
JAX CLI's flags, its finetune.py:79-85, 160-168): the command starts D x M
ranks (``parallel/ranks.py``; one card a rank over NCCL, or with ``--device
cpu`` gloo processes), each shards the loaded weights
(``sharding.shard_params(fsdp=)``) and runs ``Trainer(mesh=)`` over the same
shuffled batches, keeping its own rows.  Rank 0 prints, and writes the
checkpoints, the adapter, ``pytorch_model.bin`` and the codec files from the
whole tree.  Asking for more ranks than there are cards exits 2.

Run: ``python -m dia_tts_prune_tpu_torch.finetune --model-path … --dataset-dir …
--output-dir … --adapter-mode lora``
"""

from __future__ import annotations

import argparse
import json
import math
import time
from pathlib import Path


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Fine-tune the PyTorch/CUDA Dia port")
    p.add_argument("--model-path", type=str, required=True)
    p.add_argument("--dac-checkpoint", type=str, default=None,
                   help="torch DAC checkpoint (.pth) for the codec, in place of the model "
                        "directory's dac.safetensors")
    p.add_argument("--dataset-dir", type=str, required=True,
                   help="Directory containing metadata.csv and wavs/")
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda).")

    t = p.add_argument_group("Training")
    t.add_argument("--epochs", type=int, default=1)
    t.add_argument("--batch-size", type=int, default=2)
    t.add_argument("--learning-rate", type=float, default=1e-5)
    t.add_argument("--gradient-accumulation-steps", type=int, default=1)
    t.add_argument("--max-grad-norm", type=float, default=1.0)
    t.add_argument("--weight-decay", type=float, default=0.0)
    t.add_argument("--lr-scheduler-type", type=str, default="cosine",
                   choices=["linear", "cosine", "step", "constant"])
    t.add_argument("--warmup-steps", type=int, default=0)
    t.add_argument("--seed", type=int, default=42)
    t.add_argument("--compute-dtype", type=str, default="bfloat16",
                   choices=["float32", "bfloat16"])
    t.add_argument("--loss-mode", type=str, default="delayed", choices=["delayed", "reference"])
    t.add_argument("--qat", type=str, default="none",
                   choices=["none", "int8", "int4", "int4_hybrid"],
                   help="Quantization-aware training: run the forward through "
                        "the serving quantizer (decoder-scope fake-quant, "
                        "straight-through gradients) so int8/int4 export is "
                        "near-lossless. Full fine-tune only.")
    t.add_argument("--no-remat", action="store_true")
    t.add_argument("--logging-steps", type=int, default=10)
    t.add_argument("--save-steps", type=int, default=200)
    t.add_argument("--resume-from", type=str, default=None,
                   help="checkpoint dir (or its parent) written by a previous run")

    a = p.add_argument_group("Adapters (LoRA)")
    a.add_argument("--adapter-mode", type=str, default="none", choices=["none", "lora"])
    a.add_argument("--merge-adapter", type=str, default=None,
                   help="merge a saved LoRA adapter dir (native save_adapter "
                        "format, or a torch-peft dir) into the base weights "
                        "before training starts.  The tested route from an "
                        "adapter to int4 serving: "
                        "--merge-adapter <dir> --qat int4 (QAT trains the "
                        "merged model against the serving quantizer's exact "
                        "numerics; QAT+LoRA directly is rejected — the fp "
                        "adapter over a fake-quant base would train against "
                        "different numerics than it serves)")
    a.add_argument("--lora-r", type=int, default=8)
    a.add_argument("--lora-alpha", type=float, default=16.0)
    a.add_argument("--lora-dropout", type=float, default=0.0)
    a.add_argument("--lora-target-modules", type=str, nargs="+",
                   default=["q_proj", "v_proj"])

    pr = p.add_argument_group("Pruning before fine-tuning")
    pr.add_argument("--prune-before", type=str, default=None,
                    choices=["unstructured", "structured"])
    pr.add_argument("--prune-amount", type=float, default=0.5)
    pr.add_argument("--prune-dim", type=int, default=0)

    m = p.add_argument_group("Parallelism")
    m.add_argument("--mesh-data", type=int, default=None,
                   help="ranks on the data axis (the batch is split over them)")
    m.add_argument("--mesh-model", type=int, default=None,
                   help="ranks on the model axis (heads and the FFN split over them)")
    m.add_argument("--fsdp", action="store_true",
                   help="also shard parameter and optimizer storage over the data axis "
                        "(ZeRO-style; fp32 AdamW state of the 1.6B model alone is ~12.8 GB)")
    m.add_argument("--mesh-rank", type=int, default=0, help=argparse.SUPPRESS)
    m.add_argument("--mesh-init", default=None, help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    world = 0
    if args.mesh_data or args.mesh_model:
        world = (args.mesh_data or 1) * (args.mesh_model or 1)
        import torch

        if torch.device(args.device).type == "cuda":
            found = torch.cuda.device_count() if torch.cuda.is_available() else 0
            if found < world:
                parser.error(f"a {args.mesh_data or 1} x {args.mesh_model or 1} mesh needs "
                             f"{world} CUDA devices, found {found}")
            args.device = f"cuda:{args.mesh_rank}"
    elif args.fsdp:
        parser.error("--fsdp needs a mesh (--mesh-data / --mesh-model)")
    if not world:
        return train(args)

    import sys

    from .parallel.ranks import end_ranks, join, start_ranks

    followers = []
    if args.mesh_init is None:
        args.mesh_init, followers = start_ranks(
            "dia_tts_prune_tpu_torch.finetune", list(sys.argv[1:] if argv is None else argv),
            world, "--mesh-rank", "--mesh-init")
    joined = done = False
    try:
        join(args.mesh_init, world, args.mesh_rank, args.device)
        joined = True
        rc = train(args)
        done = True
    finally:
        failed = end_ranks(followers, joined, wait=done)
    return 1 if failed else rc


def train(args) -> int:
    """The fine-tuning run of ``main``, one rank's under a mesh (the process
    group joined)."""
    import numpy as np
    import torch

    from .api import Dia, flatten_tree
    from .checkpoint import to_torch_state_dict
    from .data import FineTuneDataset
    from .lora import LoraConfig, load_adapter, lora_param_count, merge_lora, save_adapter
    from .train import TrainConfig, Trainer
    from .utils.prefetch import prefetch

    mesh = None
    if args.mesh_init is not None:
        from .parallel.sharding import make_mesh

        mesh = make_mesh(data=args.mesh_data or 1, model=args.mesh_model or 1,
                         device=torch.device(args.device).type)
    lead = args.mesh_rank == 0  # the rank that prints and writes

    def say(*a):
        if lead:
            print(*a, flush=True)

    out = Path(args.output_dir)
    out.mkdir(parents=True, exist_ok=True)
    if lead:
        (out / "training_args.json").write_text(json.dumps(vars(args), indent=2, default=str))

    # full fine-tuning trains float32 master weights: load them unrounded
    load_dtype = args.compute_dtype if args.adapter_mode == "lora" else "float32"
    dia = Dia.from_pretrained(args.model_path, compute_dtype=load_dtype,
                              dac_checkpoint=args.dac_checkpoint, device=args.device)
    params, config = dia.params, dia.config

    if args.merge_adapter:
        adapter = load_adapter(args.merge_adapter, dia.device)
        params = merge_lora(params, adapter)
        say(f"Merged adapter {args.merge_adapter} into base weights "
            f"({lora_param_count(adapter)} adapter params)")

    if args.prune_before:
        from .prune import apply_masks, sparsity_report, structured_masks, unstructured_masks

        if args.prune_before == "unstructured":
            masks = unstructured_masks(params, args.prune_amount)
        else:
            masks = structured_masks(params, args.prune_amount, dim=args.prune_dim)
        params = apply_masks(params, masks)
        say(f"Pruned before fine-tuning: sparsity={sparsity_report(params)['sparsity']:.4f}")

    dia._require_dac()
    dataset = FineTuneDataset(
        Path(args.dataset_dir) / "metadata.csv", Path(args.dataset_dir) / "wavs",
        config, dia.dac_params, dia.dac_config, loss_mode=args.loss_mode,
    )
    steps_per_epoch = max(1, len(dataset) // args.batch_size)
    num_training_steps = args.epochs * steps_per_epoch

    tc = TrainConfig(
        learning_rate=args.learning_rate,
        epochs=args.epochs,
        batch_size=args.batch_size,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        max_grad_norm=args.max_grad_norm,
        lr_scheduler_type=args.lr_scheduler_type,
        warmup_steps=args.warmup_steps,
        weight_decay=args.weight_decay,
        adapter_mode=args.adapter_mode,
        lora=LoraConfig(r=args.lora_r, alpha=args.lora_alpha, dropout=args.lora_dropout,
                        target_modules=tuple(args.lora_target_modules)),
        loss_mode=args.loss_mode,
        qat_mode=args.qat,
        remat=not args.no_remat,
        compute_dtype=args.compute_dtype,
        seed=args.seed,
        logging_steps=args.logging_steps,
        save_steps=args.save_steps,
    )

    if mesh is not None:
        from .parallel.sharding import axis_size, batch_axes, shard_params

        params = shard_params(params, mesh, config=config, fsdp=args.fsdp)
        say(f"Sharded params over mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}"
            + (" (FSDP storage)" if args.fsdp else ""))
    trainer = Trainer(params, config, tc, num_training_steps, mesh=mesh)
    if args.resume_from:
        step = trainer.restore(args.resume_from)
        say(f"Resumed from step {step} ({args.resume_from})")

    say(f"Fine-tuning: {len(dataset)} items, {num_training_steps} steps, "
        f"mode={args.adapter_mode}" + (f", qat={args.qat}" if args.qat != "none" else ""))
    t0 = time.time()
    window: list[float] = []
    rows_split = 1 if mesh is None else math.prod(axis_size(mesh, a) for a in batch_axes(mesh))
    for epoch in range(args.epochs):
        # prepare batches (WAV read + DAC encode + delay transforms) on a
        # background thread while the card runs the train step
        for batch in prefetch(
            dataset.batches(args.batch_size, shuffle=True, seed=args.seed + epoch)
        ):
            if len(batch["text_ids"]) % rows_split:
                say(f"skipped a last batch of {len(batch['text_ids'])} items: it does not "
                    f"split over {rows_split} data ranks")
                continue
            metrics = trainer.step(batch)
            window.append(metrics["loss"])
            step = metrics["step"]
            if step % args.logging_steps == 0:
                say(f"step {step}/{num_training_steps} "
                    f"loss={np.mean(window):.4f} ({time.time() - t0:.1f}s)")
                window.clear()
            if args.save_steps > 0 and step % args.save_steps == 0:
                trainer.save(out / "checkpoints", step=step)

    # Final save (reference: finetune.py:588-621); under a mesh every rank
    # gathers the whole tree, rank 0 writes it
    adapter = trainer.adapter()
    trained = trainer.trained_params()
    if not lead:
        return 0
    config.save(out / "config.json")
    if adapter is not None:
        save_adapter(out / "adapter", adapter)
        print(f"Saved LoRA adapter to {out / 'adapter'}")
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in to_torch_state_dict(trained, config).items()}
    torch.save(sd, out / "pytorch_model.bin")
    print(f"Saved fine-tuned model to {out / 'pytorch_model.bin'}")
    # keep the output dir self-contained, like save_pretrained: the codec
    # weights were needed to fine-tune, so the result generates without them
    # being found again
    from dataclasses import asdict

    from safetensors.numpy import save_file

    save_file(flatten_tree(dia.dac_params), str(out / "dac.safetensors"))
    (out / "dac_config.json").write_text(json.dumps(asdict(dia.dac_config), indent=2))
    print(f"Bundled DAC weights into {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
