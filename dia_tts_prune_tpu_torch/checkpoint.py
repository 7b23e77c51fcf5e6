"""Checkpoint loading into the port's params dict (counterpart of
``dia_tts_prune_tpu/checkpoint.py``).

The reference ``DenseGeneral`` stores kernels as ``in_shapes + out_features``
(dia/layers.py:19-53), so a reference state dict converts by renaming keys
and stacking per-layer tensors on a leading ``L`` axis — the JAX package's
layout, which the port keeps.  ``lora_`` keys are dropped as in the reference
loader (dia/model.py:172).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .config import DiaConfig

Params = dict[str, Any]

_ATTN_KEYS = ("q_proj", "k_proj", "v_proj", "o_proj")


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):  # numpy has no bfloat16: widen first
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def convert_torch_state_dict(state_dict: Mapping[str, Any], config: DiaConfig,
                             dtype=torch.float32, device: str | torch.device = "cuda") -> Params:
    """Reference-schema state dict (``encoder.layers.{i}.…``,
    ``decoder.embeddings.{c}.weight``, …; tensors or numpy) → stacked params."""
    sd = {k: v for k, v in state_dict.items() if "lora_" not in k}

    def get(key):
        if key not in sd:
            raise KeyError(f"Missing checkpoint key: {key}")
        return _to_numpy(sd[key])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    def stack(fmt, L):
        return t(np.stack([get(fmt.format(i=i)) for i in range(L)]))

    def attn(prefix, name, L):
        return {p: {"kernel": stack(f"{prefix}.layers.{{i}}.{name}.{p}.weight", L)}
                for p in _ATTN_KEYS}

    def norm(prefix, name, L):
        return {"scale": stack(f"{prefix}.layers.{{i}}.{name}.weight", L)}

    def mlp(prefix, L):
        return {"wi_fused": {"kernel": stack(f"{prefix}.layers.{{i}}.mlp.wi_fused.weight", L)},
                "wo": {"kernel": stack(f"{prefix}.layers.{{i}}.mlp.wo.weight", L)}}

    enc_L = config.model.encoder.n_layer
    dec_L = config.model.decoder.n_layer
    C = config.data.channels
    return {
        "encoder": {
            "embedding": {"embedding": t(get("encoder.embedding.weight"))},
            "layers": {
                "pre_sa_norm": norm("encoder", "pre_sa_norm", enc_L),
                "self_attention": attn("encoder", "self_attention", enc_L),
                "post_sa_norm": norm("encoder", "post_sa_norm", enc_L),
                "mlp": mlp("encoder", enc_L),
            },
            "norm": {"scale": t(get("encoder.norm.weight"))},
        },
        "decoder": {
            "embeddings": {"embedding": t(np.stack(
                [get(f"decoder.embeddings.{c}.weight") for c in range(C)]))},
            "layers": {
                "pre_sa_norm": norm("decoder", "pre_sa_norm", dec_L),
                "self_attention": attn("decoder", "self_attention", dec_L),
                "pre_ca_norm": norm("decoder", "pre_ca_norm", dec_L),
                "cross_attention": attn("decoder", "cross_attention", dec_L),
                "pre_mlp_norm": norm("decoder", "pre_mlp_norm", dec_L),
                "mlp": mlp("decoder", dec_L),
            },
            "norm": {"scale": t(get("decoder.norm.weight"))},
            "logits_dense": {"kernel": t(get("decoder.logits_dense.weight"))},
        },
    }


def load_safetensors_checkpoint(path: str | Path, config: DiaConfig, dtype=torch.float32,
                                device: str | torch.device = "cuda") -> Params:
    """Load a safetensors checkpoint with the reference key schema."""
    from safetensors.numpy import load_file

    return convert_torch_state_dict(load_file(str(path)), config, dtype=dtype, device=device)


def params_from_jax(numpy_tree: Any, dtype=torch.float32,
                    device: str | torch.device = "cuda") -> Any:
    """The JAX package's params, given as a tree of numpy arrays (nested
    dicts and lists), as the port's params: the same tree of tensors.  The
    layouts are identical, so this is a leaf-by-leaf copy."""
    if isinstance(numpy_tree, dict):
        return {k: params_from_jax(v, dtype, device) for k, v in numpy_tree.items()}
    if isinstance(numpy_tree, (list, tuple)):
        return [params_from_jax(v, dtype, device) for v in numpy_tree]
    # a float32 copy: bfloat16 arrives as an ml_dtypes type torch cannot
    # read, and arrays exported from JAX are read-only
    a = np.array(numpy_tree, dtype=np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)
