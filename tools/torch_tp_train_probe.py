#!/usr/bin/env python3
"""The ``tp`` phase's training under a mesh alone, without its serving work.

Runs what ``chip_smoke.py``'s ``tp`` phase runs for training, in the same
order and through the same functions: one process's runs
(``chip_smoke.tp_train_refs``), two spawned gloo ranks on the one card
(``chip_smoke.tp_train_rank``: the exact gate (a), the planted fault (d),
the bf16 readings (b)), the gates (``tp_training_gates``), then a one-rank
NCCL mesh in this process (``tp_training_one_rank``) and the finetune CLI
with ``--mesh-model 1`` and ``2`` (``tp_training_cli``).  With
``--kernels`` it first runs the three training kernels at a rank's shape
(``chip_smoke.flash_train_case``, both dtypes, timed).

Prints one JSON line of the training record (its readings on lines of their
own), with ``--out PATH`` writes the whole record there, then the card's
name and power limit; exits 1 if a gate failed.

Run on the card from the repository root:
``python3 tools/torch_tp_train_probe.py [--kernels] [--out PATH]``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import multiprocessing
import subprocess
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def rank(r: int, init: str, tmp: str) -> None:
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, world_size=2, rank=r,
                            timeout=datetime.timedelta(seconds=300))
    try:
        t = time.perf_counter()
        res = cs.tp_train_rank(torch, Path(tmp))
        res["seconds"]["total"] = time.perf_counter() - t
        torch.save(res, Path(tmp) / f"tp_rank{r}.pt")
    finally:
        dist.destroy_process_group()


def main() -> int:
    import torch.distributed as dist

    from dia_tts_prune_tpu_torch.parallel.sharding import make_mesh

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--kernels", action="store_true")
    p.add_argument("--out", type=Path, default=None, help="write the whole record here (JSON)")
    args = p.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    train = {"phase": "tp", "part": "training", "seconds": {}}
    tmp = Path(tempfile.mkdtemp(prefix="tp_train_probe_"))
    train["weights_file"] = str(tmp / "tp_train_weights.pt")
    if args.kernels:
        for dtype in ("float32", "bfloat16"):
            cs.flash_train_case(torch, "rank_decoder_self", dtype, 1, 3072, 3072, 8, 2, 128,
                                True, None, None)
        train["seconds"]["kernels"] = time.perf_counter() - t0
    t = time.perf_counter()
    refs = cs.tp_train_refs(torch, tmp)
    train["seconds"]["refs"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    t = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank, args=(r, f"file://{tmp}/rendezvous", str(tmp)))
             for r in (0, 1)]
    for proc in procs:
        proc.start()
    for proc in procs:
        proc.join(900)
    for proc in procs:
        if proc.is_alive():
            proc.kill()
            proc.join()
    train["seconds"]["ranks"] = time.perf_counter() - t
    if any(proc.exitcode != 0 for proc in procs):
        print(f"a rank failed: exit codes {[proc.exitcode for proc in procs]}", file=sys.stderr)
        return 1
    got = [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False) for r in (0, 1)]
    failures = cs.tp_training_gates(torch, train, refs, got)

    t = time.perf_counter()
    cli_dir = cs.tp_cli_inputs(torch, tmp)
    finetune = [sys.executable, "-m", "dia_tts_prune_tpu_torch.finetune", "--model-path",
                str(cli_dir / "model"), "--dataset-dir", str(cli_dir / "dataset"),
                "--adapter-mode", "lora", "--compute-dtype", "bfloat16", "--batch-size", "2",
                "--learning-rate", "1e-4", "--logging-steps", "1", "--save-steps", "1"]
    cli_runs = {m: subprocess.Popen(finetune + ["--output-dir", str(cli_dir / f"out{m}"),
                                                "--mesh-model", m],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for m in ("1", "2")}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{cs._free_port()}",
                            world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
    try:
        failures += cs.tp_training_one_rank(torch, train, make_mesh(data=1, model=1,
                                                                    device="cuda"))
    finally:
        dist.destroy_process_group()
    failures += cs.tp_training_cli(torch, train, cli_runs, cli_dir)
    train["seconds"]["one_rank_and_cli"] = time.perf_counter() - t
    train["seconds"]["total"] = time.perf_counter() - t0
    train["failures"] = failures
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(train, indent=1, default=str))
    reading = train.pop("reading", {})
    cs.emit(train)
    for name, one in reading.items():
        cs.emit({"reading": name, **one})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
