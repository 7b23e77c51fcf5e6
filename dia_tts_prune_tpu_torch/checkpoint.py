"""Checkpoint loading into, and export from, the port's params dict
(counterpart of ``dia_tts_prune_tpu/checkpoint.py``).

The reference ``DenseGeneral`` stores kernels as ``in_shapes + out_features``
(dia/layers.py:19-53), so a reference state dict converts by renaming keys
and stacking per-layer tensors on a leading ``L`` axis — the JAX package's
layout, which the port keeps.  ``lora_`` keys are dropped as in the reference
loader (dia/model.py:172).  ``to_torch_state_dict`` is the inverse, so weights
trained by either package load in the other.  Optimizer checkpoints
(``train.Trainer.save``) are this package's own files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch

from .config import DiaConfig
from .ops.kernels.fused_step import FusedPack
from .ops.quant import Quantized4Kernel, QuantizedKernel
from .ops.sparse import BlockSparseKernel

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


def to_torch_state_dict(params: Params, config: DiaConfig) -> dict[str, np.ndarray]:
    """Inverse conversion: stacked params → reference-schema flat dict of
    float32 numpy arrays (the JAX package's ``to_torch_state_dict`` :116)."""
    out: dict[str, np.ndarray] = {}
    enc, dec = params["encoder"], params["decoder"]
    out["encoder.embedding.weight"] = _to_numpy(enc["embedding"]["embedding"])
    out["encoder.norm.weight"] = _to_numpy(enc["norm"]["scale"])
    out["decoder.norm.weight"] = _to_numpy(dec["norm"]["scale"])
    out["decoder.logits_dense.weight"] = _to_numpy(dec["logits_dense"]["kernel"])
    embeddings = _to_numpy(dec["embeddings"]["embedding"])
    for c in range(config.data.channels):
        out[f"decoder.embeddings.{c}.weight"] = embeddings[c]

    def unstack(prefix, tree, L):
        for path, arr in _flatten_reference(tree).items():
            arr = _to_numpy(arr)
            for i in range(L):
                out[f"{prefix}.{i}.{path}"] = arr[i]

    unstack("encoder.layers", enc["layers"], config.model.encoder.n_layer)
    unstack("decoder.layers", dec["layers"], config.model.decoder.n_layer)
    return out


def _flatten_reference(tree: Params, prefix: str = "") -> dict[str, Any]:
    """Flatten a params subtree to reference key names (kernel/scale/embedding → weight)."""
    flat = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            flat.update(_flatten_reference(v, f"{prefix}.{k}" if prefix else k))
        elif isinstance(v, (QuantizedKernel, Quantized4Kernel, BlockSparseKernel)):
            raise TypeError(f"{prefix}.{k} is a packed kernel: export float weights, "
                            "then quantize or sparsify after loading")
        else:
            name = {"kernel": "weight", "scale": "weight", "embedding": "weight"}.get(k, k)
            flat[f"{prefix}.{name}" if prefix else name] = v
    return flat


def load_torch_checkpoint(path: str | Path, config: DiaConfig, dtype=torch.float32,
                          device: str | torch.device = "cuda") -> Params:
    """Load a reference ``pytorch_model.bin`` / ``.pth`` state dict
    (reference load path: dia/model.py:139-187)."""
    state_dict = torch.load(str(path), map_location="cpu", weights_only=True)
    return convert_torch_state_dict(state_dict, config, dtype=dtype, device=device)


def load_checkpoint(path: str | Path, config: DiaConfig, dtype=torch.float32,
                    device: str | torch.device = "cuda") -> Params:
    """A safetensors or torch checkpoint, by suffix."""
    if Path(path).suffix == ".safetensors":
        return load_safetensors_checkpoint(path, config, dtype=dtype, device=device)
    return load_torch_checkpoint(path, config, dtype=dtype, device=device)


def params_to_numpy(tree: Any) -> Any:
    """A tree of tensors (params, an adapter's weights, gradients, optimizer
    moments; nested dicts and lists) as the same tree of float32 numpy arrays
    — what the JAX package takes through ``jnp.asarray``."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return _to_numpy(tree)


def load_safetensors_checkpoint(path: str | Path, config: DiaConfig, dtype=torch.float32,
                                device: str | torch.device = "cuda") -> Params:
    """Load a safetensors checkpoint with the reference key schema."""
    from safetensors.numpy import load_file

    return convert_torch_state_dict(load_file(str(path)), config, dtype=dtype, device=device)


def params_from_jax(numpy_tree: Any, dtype=torch.float32,
                    device: str | torch.device = "cuda") -> Any:
    """The JAX package's params, given as a tree of numpy arrays (nested
    dicts and lists), as the port's params: the same tree of tensors.  The
    layouts are identical, so this is a leaf-by-leaf copy.  A packed kernel
    of the JAX package (recognised by its class name and fields: nothing of
    that package is imported) becomes the port's container with the very
    same bytes: int8 values and fp32 scales keep their types; a block-sparse
    kernel keeps its int32 plan and takes ``dtype`` for its values."""
    packed = type(numpy_tree).__name__
    if packed == "BlockSparseKernel":
        src = numpy_tree
        return BlockSparseKernel(
            torch.from_numpy(np.array(src.values, dtype=np.float32)).to(device=device,
                                                                        dtype=dtype),
            torch.from_numpy(np.array(src.indices, dtype=np.int32)).to(device),
            torch.from_numpy(np.array(src.counts, dtype=np.int32)).to(device),
            src.block_k, src.block_n, src.in_shape, src.out_shape)
    if packed in ("QuantizedKernel", "Quantized4Kernel"):
        src = numpy_tree
        scale = torch.from_numpy(np.array(src.scale, dtype=np.float32)).to(device)
        values = np.asarray(src.values)
        if packed == "QuantizedKernel":
            return QuantizedKernel(torch.from_numpy(np.array(values, dtype=np.int8)).to(device),
                                   scale, src.in_shape, src.out_shape)
        if getattr(src, "layout", "kgn") != "kgn":
            raise ValueError("params_from_jax: the 'kng' int4 layout serves XLA's 4-bit dtype "
                             "and has no counterpart in the port")
        if not src.nibble:  # XLA 4-bit values, [K, N] or grouped [K/G, G, N]: one per byte, flat
            n_lead = values.ndim - (2 if src.group is None else 3)
            values = values.astype(np.int8).reshape(*values.shape[:n_lead], -1, values.shape[-1])
        return Quantized4Kernel(torch.from_numpy(np.array(values, dtype=np.int8)).to(device),
                                scale, src.in_shape, src.out_shape, src.group, src.nibble,
                                src.halfsplit)
    if isinstance(numpy_tree, dict):
        return {k: _fused_pack_from_jax(v, device) if k == "fused_pack"
                else params_from_jax(v, dtype, device) for k, v in numpy_tree.items()}
    if isinstance(numpy_tree, (list, tuple)):
        return [params_from_jax(v, dtype, device) for v in numpy_tree]
    # a float32 copy: bfloat16 arrives as an ml_dtypes type torch cannot
    # read, and arrays exported from JAX are read-only
    a = np.array(numpy_tree, dtype=np.float32)
    return torch.from_numpy(a).to(device=device, dtype=dtype)


def _fused_pack_from_jax(pack, device) -> FusedPack:
    """A JAX ``FusedPack`` (fields in its order) as the port's: int8 weights
    and fp32 scales; its RoPE swap matrices (``jq``, ``jk``) are dropped, as
    the port's kernel does not read them."""
    fields = list(pack)
    if len(fields) != len(FusedPack._fields):
        raise ValueError(f"fused_pack has {len(fields)} fields, expected "
                         f"{len(FusedPack._fields)}")
    return FusedPack(*(torch.from_numpy(np.array(a, dtype=np.int8 if name[0] == "w" else
                                                 np.float32)).to(device)
                       for name, a in zip(FusedPack._fields[:14], fields)))
