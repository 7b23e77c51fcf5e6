"""RMSNorm in one launch with a fixed sum order: CUDA kernel wrapper, its
plain PyTorch version and its gradient.

Kernel: ``csrc/rms_norm.cu`` (hand-written for sm_90a, loaded with ctypes).
It replaces no Pallas kernel: the JAX package computes RMSNorm with XLA
(``dia_tts_prune_tpu/ops/modules.py::rms_norm``).  It exists so that a row's
bits depend on its own values, the scale and the width only: a CUDA reduction
of ATen picks its launch shape, and with it the order a row's mean of
squares sums in, by the number of rows, so a batched row would leave its
single-stream run.  bf16 rows of a width that is a multiple of 8, up to
8192 (the model's): ``row_warps(D)`` warps a row, several rows a block, each
lane holding its 16-byte units in registers and summing their squares in
order, a fixed XOR shuffle tree, the warps in warp order.  fp32 rows and
other widths: one block a row, ``threads(D)`` threads, each summing a fixed
strided set of the row, a fixed shuffle tree adds a warp's sums, the warps
add in warp order.

Under autograd (training) the card's route is ``RmsNormFunction``: the
kernel forward, and the RMSNorm gradient written in torch ops.
"""

from __future__ import annotations

import ctypes

import torch

_X_CODES = {torch.float32: 0, torch.bfloat16: 1}
_S_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_int] * 2 \
    + [ctypes.c_void_p]
PER_THREAD = 8  # csrc: PER_THREAD
MAX_THREADS = 1024  # csrc: MAX_THREADS
LANE_UNITS = 8  # csrc: LANE_UNITS (16-byte units a lane holds on the bf16 route)
NORM_THREADS = 128  # csrc: NORM_THREADS


def threads(D: int) -> int:
    """Threads of a row's block for width ``D`` (csrc: ``threads_for``): the
    launch shape, from the width alone."""
    per_row = -(-D // PER_THREAD)
    return min(MAX_THREADS, max(32, -(-per_row // 32) * 32))


def row_warps(D: int, dtype: torch.dtype) -> int:
    """Warps of a row on the bf16 route (csrc: ``row_warps``), or 0 where a
    row takes the block-a-row route (fp32, or a width that is not a multiple
    of 8 or exceeds 8192)."""
    if dtype != torch.bfloat16 or D % 8 or D > 8192:
        return 0
    return 1 if D <= 2048 else 2 if D <= 4096 else 4


def rms_norm_plain(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Plain PyTorch version, the JAX ``rms_norm``: the mean of squares of
    the fp32 values over the last axis, ``x32 * rsqrt(var + eps) * scale32``,
    one rounding to ``x.dtype``.  The mean is summed in float64 and rounded
    once to fp32: the reference the kernel's fp32 sum is held to is the
    exact mean to one rounding, in no particular summation order."""
    x32 = x.float()
    var = x32.double().square().mean(-1, keepdim=True).float()
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _check(x, scale):
    if x.dtype not in _X_CODES or scale.dtype not in _S_CODES:
        raise TypeError(f"rms_norm takes float32 or bfloat16 x and a float scale, got "
                        f"{x.dtype}, {scale.dtype}")
    if x.dim() < 1 or scale.shape != (x.shape[-1],) or x.shape[-1] == 0:
        raise ValueError(f"rms_norm shapes: x {tuple(x.shape)}, scale {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError("rms_norm inputs must be on one device")


def launch(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """Launch the kernel on checked CUDA inputs (any leading shape)."""
    from ._build import kernel_function

    fn = kernel_function("rms_norm", "rms_norm_fwd", _ARGTYPES)
    D = x.shape[-1]
    x2 = x.reshape(-1, D).contiguous()
    s = scale.contiguous()
    if row_warps(D, x.dtype):  # the bf16 route loads 16 bytes at once: aligned copies
        x2 = x2 if x2.data_ptr() % 16 == 0 else x2.clone()
        s = s if s.data_ptr() % 16 == 0 else s.clone()
    out = torch.empty_like(x2)
    if x2.shape[0]:
        with torch.cuda.device(x.device):
            err = fn(x2.data_ptr(), s.data_ptr(), out.data_ptr(), x2.shape[0], D, float(eps),
                     _X_CODES[x.dtype], _S_CODES[scale.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"rms_norm kernel launch failed (cudaError {err})")
        rms_norm.launches += 1
    return out.view(x.shape)


def rms_norm_backward(grad: torch.Tensor, x: torch.Tensor, scale: torch.Tensor,
                      eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The RMSNorm gradient in torch ops, in fp32 (float64 for float64
    inputs): with ``r = rsqrt(mean(x^2) + eps)``, ``x̂ = x r`` and ``gs = g ·
    scale``, ``dx = r (gs − x̂ mean(gs x̂))`` and ``dscale = Σ_rows g x̂``; each
    in its input's dtype."""
    D = x.shape[-1]
    dt = torch.promote_types(x.dtype, torch.float32)
    g32, x32, s32 = grad.to(dt), x.to(dt), scale.to(dt)
    rstd = torch.rsqrt(x32.square().mean(-1, keepdim=True) + eps)
    xhat = x32 * rstd
    gs = g32 * s32
    dx = rstd * (gs - xhat * (gs * xhat).mean(-1, keepdim=True))
    ds = (g32 * xhat).reshape(-1, D).sum(0)
    return dx.to(x.dtype), ds.to(scale.dtype)


class RmsNormFunction(torch.autograd.Function):
    """The card's RMSNorm under autograd: the kernel forward, the gradient of
    ``rms_norm_backward``."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return launch(x, scale, eps)

    @staticmethod
    def backward(ctx, grad):
        x, scale = ctx.saved_tensors
        dx, ds = rms_norm_backward(grad, x, scale, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                ds if ctx.needs_input_grad[1] else None, None)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis in ``x.dtype``.  CPU tensors take the plain
    version (autograd through its torch ops); CUDA tensors launch the kernel
    — through ``RmsNormFunction`` where autograd needs a gradient — or
    raise."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    _check(x, scale)
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RmsNormFunction.apply(x, scale, eps)
    return launch(x, scale, eps)


rms_norm.launches = 0
