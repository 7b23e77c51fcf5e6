"""The ranks of a multi-process command (``app --tp``, ``finetune
--mesh-data/--mesh-model``): the command that a user runs is rank 0; it
starts ranks 1..N-1 as child processes running the same command with their
rank and a rendezvous added, and every rank joins one process group over
it.  Nothing on a machine tells a process of a cluster, so the rendezvous is
a free local port: one host, one card a rank (NCCL), or the CPU (gloo)."""

from __future__ import annotations

import subprocess
import sys


def start_ranks(module: str, argv: list[str], world: int, rank_flag: str,
                init_flag: str) -> tuple[str, list]:
    """Rank 0's start: a rendezvous on a free local port (returned), and
    ranks 1..``world``-1 as ``python -m module *argv rank_flag r init_flag
    init``, their standard output discarded (rank 0's is the command's),
    each ended if rank 0's process ends."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        init = f"tcp://127.0.0.1:{s.getsockname()[1]}"
    procs = [subprocess.Popen([sys.executable, "-m", module, *argv, rank_flag, str(r),
                               init_flag, init], stdout=subprocess.DEVNULL,
                              preexec_fn=_end_with_parent)
             for r in range(1, world)]
    return init, procs


def _end_with_parent() -> None:
    """In a started rank, before it runs: SIGTERM when rank 0's process
    ends, however it ends (Linux ``prctl(PR_SET_PDEATHSIG)``)."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGTERM)


def join(init: str, world: int, rank: int, device) -> None:
    """This rank's process group: NCCL with one card a rank on CUDA (the
    card ``device`` names becomes the current one), gloo on the CPU; every
    collective ends with an error after ``sharding.TIMEOUT``."""
    import torch
    import torch.distributed as dist

    from .sharding import TIMEOUT

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=init,
                            world_size=world, rank=rank, timeout=TIMEOUT)


def end_ranks(followers: list, joined: bool, wait: bool) -> bool:
    """After the work (``wait``), wait for the other ranks and stop any that
    does not end; after a failure, stop them now.  Then leave the process
    group (if ``joined``).  True if a rank failed."""
    failed = not wait
    for proc in followers:
        try:
            failed |= proc.wait(timeout=120 if wait else 0) != 0
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            failed = True
    if joined:
        import torch.distributed as dist

        dist.destroy_process_group()
    return failed
