"""Plain PyTorch reference of the 44.1 kHz DAC decoder (descript-audio-codec,
``dac/model/dac.py``): codes to waveform in float32, TF32 off.

Per-codebook embedding lookups, each through its 1 x 1 out-projection, summed
into the latent; a k7 conv stem; per upsampling block Snake, a transposed
conv (kernel 2 x stride, padding ceil(stride / 2)) and three residual units
(Snake, dilated k7 conv, Snake, 1 x 1 conv, skip) at dilations 1, 3, 9; Snake,
a k7 conv to one channel, tanh.  The whole sequence in one pass.  Imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .dia import fp32_matmuls


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)


def residual(p: dict, x: torch.Tensor, dilation: int) -> torch.Tensor:
    y = F.conv1d(snake(x, p["snake1"]["alpha"]), p["conv1"]["weight"], p["conv1"]["bias"],
                 padding=3 * dilation, dilation=dilation)
    return x + F.conv1d(snake(y, p["snake2"]["alpha"]), p["conv2"]["weight"], p["conv2"]["bias"])


@torch.no_grad()
def decode(params: dict, dac: dict, codes: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Codes ``[T, C]`` (int) to the waveform ``[T x hop]`` (float32), computed
    in ``dtype`` (float32; bfloat16 is the codec's control)."""
    if dtype != torch.float32:
        params = _cast(params, dtype)
    with fp32_matmuls():
        z = None
        for i, q in enumerate(params["quantizer"]["quantizers"][: dac["n_codebooks"]]):
            e = q["codebook"]["embedding"][codes[:, i].long()].T[None]  # [1, D, T]
            zi = F.conv1d(e, q["out_proj"]["weight"], q["out_proj"]["bias"])
            z = zi if z is None else z + zi
        p = params["decoder"]
        x = F.conv1d(z, p["stem"]["weight"], p["stem"]["bias"], padding=3)
        for block, stride in zip(p["blocks"], dac["decoder_rates"]):
            x = snake(x, block["snake"]["alpha"])
            x = F.conv_transpose1d(x, block["conv_t"]["weight"], block["conv_t"]["bias"],
                                   stride=stride, padding=math.ceil(stride / 2))
            for name, dil in (("res1", 1), ("res2", 3), ("res3", 9)):
                x = residual(block[name], x, dil)
        x = F.conv1d(snake(x, p["snake"]["alpha"]), p["head"]["weight"], p["head"]["bias"],
                     padding=3)
        return torch.tanh(x)[0, 0].float()


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)
