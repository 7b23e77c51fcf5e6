"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version.  A wrapper counts its own launches (``<wrapper>.launches``) so a
run can show that the main path went through the kernel."""

from .decode_attention import decode_attention, decode_attention_plain
from .flash_attention import (
    flash_attention,
    flash_attention_bwd_kv,
    flash_attention_bwd_plain,
    flash_attention_bwd_q,
    flash_attention_lse,
    flash_attention_lse_plain,
    flash_attention_plain,
    flash_attention_trainable,
)
from .fused_step import fused_decode_step, fused_decode_step_plain
from .int4_gemv import int4_gemv, int4_gemv_plain
from .int8_matmul import int8_matmul, int8_matmul_plain
from .sparse_matmul import block_sparse_matmul, block_sparse_matmul_plain

KERNEL_WRAPPERS = {"flash_attention": flash_attention, "decode_attention": decode_attention,
                   "int8_matmul": int8_matmul, "int4_gemv": int4_gemv,
                   "flash_attention_lse": flash_attention_lse,
                   "flash_attention_bwd_kv": flash_attention_bwd_kv,
                   "flash_attention_bwd_q": flash_attention_bwd_q,
                   "block_sparse_matmul": block_sparse_matmul,
                   "fused_decode_step": fused_decode_step}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


__all__ = [
    "KERNEL_WRAPPERS", "block_sparse_matmul", "block_sparse_matmul_plain", "decode_attention",
    "decode_attention_plain", "flash_attention", "flash_attention_bwd_kv",
    "flash_attention_bwd_plain", "flash_attention_bwd_q", "flash_attention_lse",
    "flash_attention_lse_plain", "flash_attention_plain", "flash_attention_trainable",
    "fused_decode_step", "fused_decode_step_plain", "int4_gemv", "int4_gemv_plain",
    "int8_matmul", "int8_matmul_plain", "launch_counts", "reset_launch_counts",
]
