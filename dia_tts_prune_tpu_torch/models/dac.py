"""Descript Audio Codec (DAC), decode side (counterpart of
``dia_tts_prune_tpu/models/dac.py``).

Codes → waveform for the 44.1 kHz model: per-codebook embedding lookup and
1×1 out-projection summed into the latent (RVQ ``from_codes``), then the
decoder: Conv1d stem → upsampling blocks {Snake → ConvTranspose1d → 3
dilated ResidualUnits} → Snake → Conv1d → tanh.  Arrays are [B, C, T] as in
torch.  The convolutions are ``torch.nn.functional`` calls, as the JAX
package leaves them to XLA.  A float32 decode keeps cuDNN off TF32 so that
fp32 means fp32, as the JAX package's HIGHEST-precision convs do.

Weights come from the flattened ``dac.safetensors`` a model directory
carries (the JAX package's ``save_pretrained`` layout) or from a numpy seed.
Encoding audio into codes (voice cloning from a file) is not ported yet.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

Params = dict[str, Any]

DEFAULT_SAMPLE_RATE = 44100


@dataclass(frozen=True)
class DACConfig:
    """Architecture of the published 44.1 kHz DAC model."""

    encoder_dim: int = 64
    encoder_rates: tuple[int, ...] = (2, 4, 8, 8)
    decoder_dim: int = 1536
    decoder_rates: tuple[int, ...] = (8, 8, 4, 2)
    n_codebooks: int = 9
    codebook_size: int = 1024
    codebook_dim: int = 8
    sample_rate: int = DEFAULT_SAMPLE_RATE

    @property
    def latent_dim(self) -> int:
        return self.encoder_dim * (2 ** len(self.encoder_rates))

    @property
    def hop_length(self) -> int:
        return int(np.prod(self.encoder_rates))


def conv1d(x, w, b, stride: int = 1, padding: int = 0, dilation: int = 1):
    """w: [O, I, K]."""
    return F.conv1d(x, w, b, stride=stride, padding=padding, dilation=dilation)


def conv_transpose1d(x, w, b, stride: int, padding: int, output_padding: int = 0):
    """w: [I, O, K]; out_len = (in-1)*stride - 2*padding + K + output_padding."""
    return F.conv_transpose1d(x, w, b, stride=stride, padding=padding,
                              output_padding=output_padding)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake activation: x + sin²(αx)/α, α per channel [1, C, 1]."""
    a = alpha.float()
    x32 = x.float()
    return (x32 + torch.sin(a * x32) ** 2 / (a + 1e-9)).to(x.dtype)


def _res_unit(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    """ResidualUnit: Snake → dilated k7 conv → Snake → 1×1 conv, plus skip."""
    y = snake(x, p["snake1"]["alpha"])
    y = conv1d(y, p["conv1"]["weight"], p["conv1"]["bias"], padding=3 * dilation,
               dilation=dilation)
    y = snake(y, p["snake2"]["alpha"])
    return x + conv1d(y, p["conv2"]["weight"], p["conv2"]["bias"])


def rvq_from_codes(params: Params, config: DACConfig, codes_BxNxT: torch.Tensor) -> torch.Tensor:
    """codes [B, N, T] → latent z_q [B, latent_dim, T]."""
    z_q = None
    for i, q in enumerate(params["quantizer"]["quantizers"][: config.n_codebooks]):
        z_p = q["codebook"]["embedding"][codes_BxNxT[:, i].long()].transpose(1, 2)
        zi = conv1d(z_p, q["out_proj"]["weight"], q["out_proj"]["bias"])
        z_q = zi if z_q is None else z_q + zi
    return z_q


def dac_decode_latent(params: Params, config: DACConfig, z: torch.Tensor) -> torch.Tensor:
    """Latent [B, latent_dim, T] → waveform [B, 1, T*hop]."""
    p = params["decoder"]
    x = conv1d(z, p["stem"]["weight"], p["stem"]["bias"], padding=3)
    for block, stride in zip(p["blocks"], config.decoder_rates):
        x = snake(x, block["snake"]["alpha"])
        x = conv_transpose1d(x, block["conv_t"]["weight"], block["conv_t"]["bias"],
                             stride=stride, padding=math.ceil(stride / 2))
        x = _res_unit(block["res1"], x, 1)
        x = _res_unit(block["res2"], x, 3)
        x = _res_unit(block["res3"], x, 9)
    x = snake(x, p["snake"]["alpha"])
    x = conv1d(x, p["head"]["weight"], p["head"]["bias"], padding=3)
    return torch.tanh(x)


@torch.no_grad()
def decode_codes(params: Params, config: DACConfig, codes_BxTxC: torch.Tensor) -> torch.Tensor:
    """Codec tokens [B, T, C] → waveform [B, T*hop] (reference: dia/audio.py:166-185)."""
    with torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                    benchmark=torch.backends.cudnn.benchmark,
                                    deterministic=torch.backends.cudnn.deterministic,
                                    allow_tf32=False):
        z = rvq_from_codes(params, config, codes_BxTxC.transpose(1, 2))
        return dac_decode_latent(params, config, z)[:, 0, :]


def _unflatten(flat: dict[str, np.ndarray], device) -> Params:
    """Dotted keys → nested dicts; all-numeric levels become lists."""
    root: dict = {}
    for key, value in flat.items():
        *parents, leaf = key.split(".")
        node = root
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = torch.from_numpy(np.asarray(value, np.float32)).to(device)

    def fix(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [fix(node[str(i)]) for i in range(len(node))]
        return {k: fix(v) for k, v in node.items()}

    return fix(root)


def load_dac_safetensors(path: str | Path, device: str | torch.device = "cuda") -> Params:
    """DAC params from a flattened ``dac.safetensors`` (keys such as
    ``decoder.blocks.0.conv_t.weight``, ``quantizer.quantizers.3.codebook.embedding``)."""
    from safetensors.numpy import load_file

    return _unflatten(load_file(str(path)), device)


def init_dac_decoder_params(config: DACConfig, seed: int = 0,
                            device: str | torch.device = "cuda") -> Params:
    """Random decode-side weights from a numpy seed (normal / sqrt(fan_in)
    kernels, zero biases, unit snake alphas), for runs without a checkpoint."""
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    def conv(o, i, k, transpose=False):
        shape = (i, o, k) if transpose else (o, i, k)
        w = rng.standard_normal(size=shape, dtype=np.float32) / np.float32(math.sqrt(i * k))
        return {"weight": t(w), "bias": t(np.zeros(o))}

    def alpha(dim):
        return {"alpha": t(np.ones((1, dim, 1)))}

    def res(dim):
        return {"snake1": alpha(dim), "conv1": conv(dim, dim, 7),
                "snake2": alpha(dim), "conv2": conv(dim, dim, 1)}

    dd = config.decoder_dim
    blocks = []
    for i, stride in enumerate(config.decoder_rates):
        in_d, out_d = dd // 2 ** i, dd // 2 ** (i + 1)
        blocks.append({"snake": alpha(in_d), "conv_t": conv(out_d, in_d, 2 * stride, True),
                       "res1": res(out_d), "res2": res(out_d), "res3": res(out_d)})
    final_d = dd // 2 ** len(config.decoder_rates)
    quantizers = [{
        "out_proj": conv(config.latent_dim, config.codebook_dim, 1),
        "codebook": {"embedding": t(rng.standard_normal(
            size=(config.codebook_size, config.codebook_dim), dtype=np.float32))},
    } for _ in range(config.n_codebooks)]
    return {
        "decoder": {"stem": conv(dd, config.latent_dim, 7), "blocks": blocks,
                    "snake": alpha(final_d), "head": conv(1, final_d, 7)},
        "quantizer": {"quantizers": quantizers},
    }
