"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper counts its own launches (``<wrapper>.launches``) so a
run can show that the main path went through the kernel."""

from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import flash_attention, flash_attention_plain

KERNEL_WRAPPERS = {"flash_attention": flash_attention, "decode_attention": decode_attention}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "KERNEL_WRAPPERS", "decode_attention", "decode_attention_plain", "flash_attention",
    "flash_attention_plain", "launch_counts", "reset_launch_counts",
]
