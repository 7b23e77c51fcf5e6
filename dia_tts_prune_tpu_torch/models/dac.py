"""Descript Audio Codec (DAC), decode and encode (counterpart of
``dia_tts_prune_tpu/models/dac.py``).

Codes → waveform for the 44.1 kHz model: per-codebook embedding lookup and
1×1 out-projection summed into the latent (RVQ ``from_codes``), then the
decoder: Conv1d stem → upsampling blocks {Snake → ConvTranspose1d → 3
dilated ResidualUnits} → Snake → Conv1d → tanh.  Arrays are [B, C, T] as in
torch.  The convolutions are ``torch.nn.functional`` calls, as the JAX
package leaves them to XLA.  A float32 decode keeps cuDNN off TF32 so that
fp32 means fp32, as the JAX package's HIGHEST-precision convs do.

Waveform → codes (voice-cloning prompts, fine-tuning data): the encoder, a
Conv1d stem → strided blocks {3 ResidualUnits → Snake → strided Conv1d} →
Snake → Conv1d, then residual VQ with an L2-normalized nearest-neighbour
lookup per codebook.  The same fp32 rule holds (TF32 off).

Weights come from the flattened ``dac.safetensors`` a model directory
carries (the JAX package's ``save_pretrained`` layout), from a published
torch DAC checkpoint (``convert_dac_torch_state_dict``: descript-audio-codec
naming, weight norm folded on the host in float32) or from a numpy seed.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Mapping

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


def _fp32_convs():
    """cuDNN kept off TF32, so that a float32 convolution is float32."""
    return torch.backends.cudnn.flags(enabled=torch.backends.cudnn.enabled,
                                      benchmark=torch.backends.cudnn.benchmark,
                                      deterministic=torch.backends.cudnn.deterministic,
                                      allow_tf32=False)


@torch.no_grad()
def decode_codes(params: Params, config: DACConfig, codes_BxTxC: torch.Tensor) -> torch.Tensor:
    """Codec tokens [B, T, C] → waveform [B, T*hop] (reference: dia/audio.py:166-185)."""
    with _fp32_convs():
        z = rvq_from_codes(params, config, codes_BxTxC.transpose(1, 2))
        return dac_decode_latent(params, config, z)[:, 0, :]


def dac_encode_latent(params: Params, config: DACConfig, audio: torch.Tensor) -> torch.Tensor:
    """Waveform [B, 1, T] → continuous latent [B, latent_dim, T/hop]."""
    p = params["encoder"]
    x = conv1d(audio, p["stem"]["weight"], p["stem"]["bias"], padding=3)
    for block, stride in zip(p["blocks"], config.encoder_rates):
        x = _res_unit(block["res1"], x, 1)
        x = _res_unit(block["res2"], x, 3)
        x = _res_unit(block["res3"], x, 9)
        x = snake(x, block["snake"]["alpha"])
        x = conv1d(x, block["conv"]["weight"], block["conv"]["bias"], stride=stride,
                   padding=math.ceil(stride / 2))
    x = snake(x, p["snake"]["alpha"])
    return conv1d(x, p["head"]["weight"], p["head"]["bias"], padding=1)


def _nearest_code(codebook_VxD: torch.Tensor, z_e_BxDxT: torch.Tensor) -> torch.Tensor:
    """L2-normalized nearest-neighbour lookup (DAC decode_latents semantics):
    argmin ||e - c||² over normalized vectors == argmax cosine similarity.
    Ties go to the lowest index, as in the JAX package's argmax."""
    enc = z_e_BxDxT.transpose(1, 2)  # [B, T, D]
    enc_n = enc / torch.linalg.vector_norm(enc, dim=-1, keepdim=True).clamp_min(1e-12)
    cb_n = codebook_VxD / torch.linalg.vector_norm(
        codebook_VxD, dim=-1, keepdim=True).clamp_min(1e-12)
    sim = torch.einsum("btd,vd->btv", enc_n, cb_n)
    return torch.argmax(sim, dim=-1).to(torch.int32)  # [B, T]


@torch.no_grad()
def encode_audio(params: Params, config: DACConfig, audio_BxT: torch.Tensor) -> torch.Tensor:
    """Waveform [B, T] → codec tokens int32 [B, T/hop, C] (DAC encode + RVQ;
    reference: dia/model.py:546-576).  The caller pads T to a multiple of
    ``config.hop_length`` (see ``pad_audio``)."""
    with _fp32_convs():
        residual = dac_encode_latent(params, config, audio_BxT.float()[:, None, :])
        codes = []
        for q in params["quantizer"]["quantizers"][: config.n_codebooks]:
            z_e = conv1d(residual, q["in_proj"]["weight"], q["in_proj"]["bias"])
            idx = _nearest_code(q["codebook"]["embedding"], z_e)  # [B, T]
            z_p = q["codebook"]["embedding"][idx.long()].transpose(1, 2)  # [B, D, T]
            residual = residual - conv1d(z_p, q["out_proj"]["weight"], q["out_proj"]["bias"])
            codes.append(idx)
        return torch.stack(codes, dim=-1)


def pad_audio(audio: np.ndarray, hop_length: int) -> np.ndarray:
    """Right-pad to a hop multiple (DAC preprocess semantics)."""
    pad = (-audio.shape[-1]) % hop_length
    if pad == 0:
        return audio
    return np.pad(audio, [(0, 0)] * (audio.ndim - 1) + [(0, pad)])


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


class _SeededInit:
    """Weight draws from one numpy stream: normal / sqrt(fan_in) kernels, zero
    biases, unit snake alphas."""

    def __init__(self, rng: np.random.Generator, device):
        self.rng, self.device = rng, device

    def t(self, a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(self.device)

    def conv(self, o, i, k, transpose=False):
        shape = (i, o, k) if transpose else (o, i, k)
        w = self.rng.standard_normal(size=shape, dtype=np.float32) / np.float32(math.sqrt(i * k))
        return {"weight": self.t(w), "bias": self.t(np.zeros(o))}

    def alpha(self, dim):
        return {"alpha": self.t(np.ones((1, dim, 1)))}

    def res(self, dim):
        return {"snake1": self.alpha(dim), "conv1": self.conv(dim, dim, 7),
                "snake2": self.alpha(dim), "conv2": self.conv(dim, dim, 1)}


def init_dac_decoder_params(config: DACConfig, seed: int = 0,
                            device: str | torch.device = "cuda") -> Params:
    """Random decode-side weights from a numpy seed, for runs without a checkpoint."""
    init = _SeededInit(np.random.default_rng(seed), device)
    dd = config.decoder_dim
    blocks = []
    for i, stride in enumerate(config.decoder_rates):
        in_d, out_d = dd // 2 ** i, dd // 2 ** (i + 1)
        blocks.append({"snake": init.alpha(in_d),
                       "conv_t": init.conv(out_d, in_d, 2 * stride, True),
                       "res1": init.res(out_d), "res2": init.res(out_d), "res3": init.res(out_d)})
    final_d = dd // 2 ** len(config.decoder_rates)
    quantizers = [{
        "out_proj": init.conv(config.latent_dim, config.codebook_dim, 1),
        "codebook": {"embedding": init.t(init.rng.standard_normal(
            size=(config.codebook_size, config.codebook_dim), dtype=np.float32))},
    } for _ in range(config.n_codebooks)]
    return {
        "decoder": {"stem": init.conv(dd, config.latent_dim, 7), "blocks": blocks,
                    "snake": init.alpha(final_d), "head": init.conv(1, final_d, 7)},
        "quantizer": {"quantizers": quantizers},
    }


def init_dac_params(config: DACConfig, seed: int = 0,
                    device: str | torch.device = "cuda") -> Params:
    """Random weights for both directions: ``init_dac_decoder_params(seed)``
    (the same decode-side draws) plus the encoder and the quantizers'
    in-projections, drawn from a second stream of the seed."""
    params = init_dac_decoder_params(config, seed, device)
    init = _SeededInit(np.random.default_rng([seed, 1]), device)
    d = config.encoder_dim
    blocks = []
    for stride in config.encoder_rates:
        blocks.append({"res1": init.res(d), "res2": init.res(d), "res3": init.res(d),
                       "snake": init.alpha(d), "conv": init.conv(2 * d, d, 2 * stride)})
        d *= 2
    params["encoder"] = {"stem": init.conv(config.encoder_dim, 1, 7), "blocks": blocks,
                         "snake": init.alpha(d), "head": init.conv(config.latent_dim, d, 3)}
    for q in params["quantizer"]["quantizers"]:
        q["in_proj"] = init.conv(config.codebook_dim, config.latent_dim, 1)
    return params


# ---------------------------------------------------------------------------
# torch DAC checkpoints (the JAX package's models/dac.py:338-488)
# ---------------------------------------------------------------------------


def _host(v) -> np.ndarray:
    """A checkpoint value (tensor of any float dtype, or array) as float32 numpy."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _fold_weight_norm(sd: Mapping[str, np.ndarray], prefix: str) -> np.ndarray:
    """torch ``weight_norm`` (``weight_g``, ``weight_v``) folded into one
    kernel: W = g · v / max(‖v‖, 1e-12), the norm over every axis but 0, in
    float32 (the JAX ``_fold_weight_norm``, :338)."""
    g = np.asarray(sd[f"{prefix}.weight_g"])
    v = np.asarray(sd[f"{prefix}.weight_v"])
    norm = np.sqrt(np.sum(v ** 2, axis=tuple(range(1, v.ndim)), keepdims=True))
    return (g * v / np.maximum(norm, 1e-12)).astype(np.float32)


def _conv_from_sd(sd, prefix, t) -> Params:
    w = (_fold_weight_norm(sd, prefix) if f"{prefix}.weight_g" in sd
         else np.asarray(sd[f"{prefix}.weight"], np.float32))
    bias_key = f"{prefix}.bias"
    if bias_key not in sd:
        # every conv of the published checkpoints has one; Conv1d and
        # ConvTranspose1d keep their output channels on different axes, so a
        # zero bias cannot be shaped from the kernel alone
        raise KeyError(f"Missing DAC checkpoint key: {bias_key}")
    return {"weight": t(w), "bias": t(sd[bias_key])}


def _alpha_from_sd(sd, prefix, t) -> Params:
    return {"alpha": t(sd[f"{prefix}.alpha"])}


def _res_from_sd(sd, prefix, t) -> Params:
    return {"snake1": _alpha_from_sd(sd, f"{prefix}.block.0", t),
            "conv1": _conv_from_sd(sd, f"{prefix}.block.1", t),
            "snake2": _alpha_from_sd(sd, f"{prefix}.block.2", t),
            "conv2": _conv_from_sd(sd, f"{prefix}.block.3", t)}


def convert_dac_torch_state_dict(state_dict: Mapping[str, Any], config: DACConfig,
                                 device: str | torch.device = "cuda") -> Params:
    """A published torch DAC checkpoint (descript-audio-codec naming:
    ``encoder.block.{i}``, ``decoder.model.{i}``, ``quantizer.quantizers.{i}``;
    plain or weight-norm convs) → this module's param tree, float32 tensors
    on ``device`` in the layout ``decode_codes`` / ``encode_audio`` take (the
    JAX ``convert_dac_torch_state_dict``, :429).  Weight norm is folded on
    the host first."""
    sd = {k: _host(v) for k, v in state_dict.items()}

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)  # a copy: writable, own

    n_enc, n_dec = len(config.encoder_rates), len(config.decoder_rates)
    enc_blocks = [{"res1": _res_from_sd(sd, f"encoder.block.{b + 1}.block.0", t),
                   "res2": _res_from_sd(sd, f"encoder.block.{b + 1}.block.1", t),
                   "res3": _res_from_sd(sd, f"encoder.block.{b + 1}.block.2", t),
                   "snake": _alpha_from_sd(sd, f"encoder.block.{b + 1}.block.3", t),
                   "conv": _conv_from_sd(sd, f"encoder.block.{b + 1}.block.4", t)}
                  for b in range(n_enc)]
    dec_blocks = [{"snake": _alpha_from_sd(sd, f"decoder.model.{b + 1}.block.0", t),
                   "conv_t": _conv_from_sd(sd, f"decoder.model.{b + 1}.block.1", t),
                   "res1": _res_from_sd(sd, f"decoder.model.{b + 1}.block.2", t),
                   "res2": _res_from_sd(sd, f"decoder.model.{b + 1}.block.3", t),
                   "res3": _res_from_sd(sd, f"decoder.model.{b + 1}.block.4", t)}
                  for b in range(n_dec)]
    quantizers = [{"in_proj": _conv_from_sd(sd, f"quantizer.quantizers.{i}.in_proj", t),
                   "out_proj": _conv_from_sd(sd, f"quantizer.quantizers.{i}.out_proj", t),
                   "codebook": {"embedding": t(sd[f"quantizer.quantizers.{i}.codebook.weight"])}}
                  for i in range(config.n_codebooks)]
    return {
        "encoder": {"stem": _conv_from_sd(sd, "encoder.block.0", t), "blocks": enc_blocks,
                    "snake": _alpha_from_sd(sd, f"encoder.block.{n_enc + 1}", t),
                    "head": _conv_from_sd(sd, f"encoder.block.{n_enc + 2}", t)},
        "decoder": {"stem": _conv_from_sd(sd, "decoder.model.0", t), "blocks": dec_blocks,
                    "snake": _alpha_from_sd(sd, f"decoder.model.{n_dec + 1}", t),
                    "head": _conv_from_sd(sd, f"decoder.model.{n_dec + 2}", t)},
        "quantizer": {"quantizers": quantizers},
    }


def to_dac_torch_state_dict(params: Params, config: DACConfig) -> dict[str, np.ndarray]:
    """The inverse of ``convert_dac_torch_state_dict``: this module's params
    in descript-audio-codec naming, plain weights (no weight norm), float32
    numpy (the JAX ``to_dac_torch_state_dict``, :379)."""
    sd: dict[str, np.ndarray] = {}

    def put_conv(prefix, p):
        sd[f"{prefix}.weight"] = _host(p["weight"])
        sd[f"{prefix}.bias"] = _host(p["bias"])

    def put_res(prefix, p):
        sd[f"{prefix}.block.0.alpha"] = _host(p["snake1"]["alpha"])
        put_conv(f"{prefix}.block.1", p["conv1"])
        sd[f"{prefix}.block.2.alpha"] = _host(p["snake2"]["alpha"])
        put_conv(f"{prefix}.block.3", p["conv2"])

    enc = params["encoder"]
    put_conv("encoder.block.0", enc["stem"])
    for b, blk in enumerate(enc["blocks"]):
        pre = f"encoder.block.{b + 1}"
        put_res(f"{pre}.block.0", blk["res1"])
        put_res(f"{pre}.block.1", blk["res2"])
        put_res(f"{pre}.block.2", blk["res3"])
        sd[f"{pre}.block.3.alpha"] = _host(blk["snake"]["alpha"])
        put_conv(f"{pre}.block.4", blk["conv"])
    n_enc = len(config.encoder_rates)
    sd[f"encoder.block.{n_enc + 1}.alpha"] = _host(enc["snake"]["alpha"])
    put_conv(f"encoder.block.{n_enc + 2}", enc["head"])

    dec = params["decoder"]
    put_conv("decoder.model.0", dec["stem"])
    for b, blk in enumerate(dec["blocks"]):
        pre = f"decoder.model.{b + 1}"
        sd[f"{pre}.block.0.alpha"] = _host(blk["snake"]["alpha"])
        put_conv(f"{pre}.block.1", blk["conv_t"])
        put_res(f"{pre}.block.2", blk["res1"])
        put_res(f"{pre}.block.3", blk["res2"])
        put_res(f"{pre}.block.4", blk["res3"])
    n_dec = len(config.decoder_rates)
    sd[f"decoder.model.{n_dec + 1}.alpha"] = _host(dec["snake"]["alpha"])
    put_conv(f"decoder.model.{n_dec + 2}", dec["head"])

    for i, q in enumerate(params["quantizer"]["quantizers"]):
        pre = f"quantizer.quantizers.{i}"
        put_conv(f"{pre}.in_proj", q["in_proj"])
        put_conv(f"{pre}.out_proj", q["out_proj"])
        sd[f"{pre}.codebook.weight"] = _host(q["codebook"]["embedding"])
    return sd
