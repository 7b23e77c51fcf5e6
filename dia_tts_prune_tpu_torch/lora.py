"""LoRA adapters over the stacked params dict (counterpart of
``dia_tts_prune_tpu/lora.py``).

The reference delegates LoRA to the ``peft`` library wrapping torch modules
(finetune.py:374-396, default targets ["q_proj", "v_proj"]); here, as in the
JAX package, adapters are plain trees of tensors:

* ``init_lora(params, config)`` creates A/B factors per targeted kernel, with
  the layer axis stacked like the base params.
* ``merge_lora(params, adapter)`` fuses ``W + (alpha/r)·A@B`` into the base
  kernels — the "adapter fusion for inference" requirement (BASELINE.json):
  fused inference runs the exact base-model code path at zero overhead.
* Training applies the merge *inside* the loss on detached base weights, so
  gradients flow only to A/B (see train.py).

A is initialized normal / sqrt(fan_in), B zero — the merged delta starts at
0, matching peft semantics.  The saved formats (``adapter_config.json`` +
``adapter_weights.npz``, and the torch-peft directory layout) are the JAX
package's: an adapter written by either package loads in the other.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

Params = dict[str, Any]

# target name -> (#input axes, #output axes) of the kernel *after* the stacked
# layer axis (reference DenseGeneral layouts, dia/layers.py:204-227, 77-90, 622-628)
_TARGET_SPLITS = {
    "q_proj": 1,
    "k_proj": 1,
    "v_proj": 1,
    "o_proj": 2,
    "wi_fused": 1,
    "wo": 1,
    "logits_dense": 1,
}


@dataclass(frozen=True)
class LoraConfig:
    """Mirrors the reference CLI surface (finetune.py:374-396)."""

    r: int = 8
    alpha: float = 16.0
    dropout: float = 0.0
    target_modules: tuple[str, ...] = ("q_proj", "v_proj")

    @property
    def scale(self) -> float:
        return self.alpha / self.r


def _split_in_out(name: str, shape: tuple[int, ...], stacked: bool) -> tuple[int, int, int]:
    """Return (L or 1, fan_in, fan_out) for a kernel."""
    n_in = _TARGET_SPLITS[name]
    dims = shape[1:] if stacked else shape
    fan_in = int(np.prod(dims[:n_in]))
    fan_out = int(np.prod(dims[n_in:]))
    L = shape[0] if stacked else 1
    return L, fan_in, fan_out


def init_lora(params: Params, config: LoraConfig, generator: torch.Generator | None = None,
              dtype=torch.float32, device=None) -> Params:
    """Build the adapter tree: mirrors params, with {'a','b'} at targets, on
    ``device`` (default: the device of each target kernel).  A is drawn on
    the CPU from ``generator`` (a ``torch.Generator``; the draws differ from
    ``jax.random``'s for the same seed), target by target in the sorted
    order of their paths, so the adapter does not depend on the tree's key
    order.  Only the kernels' shapes are read: under a mesh, pass the whole
    model's shapes (e.g. meta tensors) and a device, then ``shard_lora`` (so
    the adapter equals the unsharded one)."""

    def walk(tree, path):
        out = {}
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                if k in config.target_modules and "kernel" in v and k in _TARGET_SPLITS:
                    stacked = "layers" in path
                    L, fan_in, fan_out = _split_in_out(k, v["kernel"].shape, stacked)
                    a_shape = (L, fan_in, config.r) if stacked else (fan_in, config.r)
                    b_shape = (L, config.r, fan_out) if stacked else (config.r, fan_out)
                    dev = v["kernel"].device if device is None else device
                    a = torch.randn(a_shape, generator=generator, dtype=torch.float32)
                    a = (a / np.sqrt(fan_in)).to(device=dev, dtype=dtype)
                    out[k] = {"a": a, "b": torch.zeros(b_shape, dtype=dtype, device=dev)}
                else:
                    sub = walk(v, path + (k,))
                    if sub:
                        out[k] = sub
        return out

    weights = walk(params, ())
    return {"config": _config_leaves(config), "weights": weights}


def _config_leaves(config: LoraConfig) -> dict:
    return {
        "r": config.r,
        "alpha": config.alpha,
        "dropout": config.dropout,
        "target_modules": list(config.target_modules),
    }


# Under a mesh (parallel/sharding.py) the factor that meets a kernel's
# model-sharded axis is sharded with it: B's columns on a column-parallel
# target (the q/k/v heads, wi_fused's F within each of its two halves), A's
# rows on a row-parallel one (o_proj's heads, wo's F).  The other factor is
# replicated, and its gradient on each rank is that rank's part of a sum.
_COLUMN_TARGETS = ("q_proj", "k_proj", "v_proj", "wi_fused")
_ROW_TARGETS = ("o_proj", "wo")


def factor_layout(name: str, factor: str) -> tuple[int | None, bool]:
    """(the dimension of factor ``factor`` ('a' or 'b') of target ``name``
    that is sharded over the model axis — None for a replicated factor —,
    whether a replicated factor's gradient is a partial sum over the model
    axis)."""
    sharded = (name in _COLUMN_TARGETS and factor == "b") or (name in _ROW_TARGETS
                                                              and factor == "a")
    if sharded:
        return (-1 if factor == "b" else -2), False
    return None, name in _COLUMN_TARGETS + _ROW_TARGETS


def _halves(name: str, factor: str) -> bool:
    """Whether the factor is wi_fused's B, whose columns are [2, F] (gate
    and up): a rank's columns are its F slice of each half."""
    return (name, factor) == ("wi_fused", "b")


def shard_factor(x: torch.Tensor, name: str, factor: str, mesh) -> torch.Tensor:
    """This rank's part of factor ``factor`` of target ``name``
    (``factor_layout``) on the model axis of ``mesh``."""
    from .parallel.sharding import AXIS_MODEL, P, axis_size, local_shard

    dim, _ = factor_layout(name, factor)
    if dim is None or axis_size(mesh, AXIS_MODEL) == 1:
        return x
    v = x.unflatten(-1, (2, -1)) if _halves(name, factor) else x
    spec = P(*[AXIS_MODEL if d == v.dim() + dim else None for d in range(v.dim())])
    out = local_shard(v, spec, mesh, f"{name}.{factor}")
    return out.flatten(-2) if _halves(name, factor) else out


@torch.no_grad()
def gather_factor(x: torch.Tensor, name: str, factor: str, mesh) -> torch.Tensor:
    """The whole factor from every rank's part (``shard_factor``'s inverse).
    A collective call."""
    from .parallel.sharding import AXIS_MODEL, all_gather_dim, axis_size

    dim, _ = factor_layout(name, factor)
    if dim is None or axis_size(mesh, AXIS_MODEL) == 1:
        return x
    v = x.unflatten(-1, (2, -1)) if _halves(name, factor) else x
    out = all_gather_dim(v, v.dim() + dim, mesh.get_group(AXIS_MODEL))
    return out.flatten(-2) if _halves(name, factor) else out


def _map_factors(fn, weights: Params, name=None) -> Params:
    """``fn(x, target name, factor)`` over an adapter's factors."""
    return {k: _map_factors(fn, v, k) if isinstance(v, dict) else fn(v, name, k)
            for k, v in weights.items()}


def shard_lora(weights: Params, mesh) -> Params:
    """Each rank's part of an adapter's factors (``shard_factor``)."""
    return _map_factors(lambda x, name, f: shard_factor(x, name, f, mesh), weights)


def gather_lora(weights: Params, mesh) -> Params:
    """The whole adapter from every rank's factors.  A collective call."""
    return _map_factors(lambda x, name, f: gather_factor(x, name, f, mesh), weights)


def lora_delta(name: str, ab: Params, kernel_shape: tuple[int, ...], scale: float,
               stacked: bool) -> torch.Tensor:
    """(alpha/r)·A@B reshaped to the kernel's layout (a rank's own under a
    mesh, with its factors from ``shard_lora``)."""
    a, b = ab["a"], ab["b"]
    delta = torch.bmm(a, b) if stacked else a @ b
    return (scale * delta).reshape(kernel_shape)


def merge_lora(params: Params, adapter: Params, sign: float = 1.0) -> Params:
    """Fuse the adapter into base kernels: W + sign·(alpha/r)·A@B.

    ``sign=-1`` un-merges (exact inverse in fp32).  Packed (quantized)
    kernels cannot take a delta: merge first, then quantize."""
    cfg = adapter["config"]
    scale = cfg["alpha"] / cfg["r"]
    weights = adapter["weights"]

    def walk(tree, sub, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                if k in sub and "a" in sub[k]:
                    stacked = "layers" in path
                    kernel = v["kernel"]
                    if not isinstance(kernel, torch.Tensor):
                        raise TypeError(
                            f"cannot merge a LoRA adapter into the packed kernel "
                            f"{'.'.join(path + (k,))}: merge into float weights, then quantize")
                    delta = lora_delta(k, sub[k], kernel.shape, scale, stacked)
                    out[k] = {"kernel": kernel + sign * delta.to(device=kernel.device,
                                                                 dtype=kernel.dtype)}
                elif k in sub:
                    out[k] = walk(v, sub[k], path + (k,))
                else:
                    out[k] = v
            else:
                out[k] = v
        return out

    return walk(params, weights, ())


def save_adapter(path: str | Path, adapter: Params) -> None:
    """Persist as adapter_config.json + adapter_weights.npz (peft-style layout,
    reference: finetune.py:574,605)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "adapter_config.json").write_text(json.dumps(adapter["config"], indent=2))
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                flat[f"{prefix}{k}"] = _np(v)

    walk(adapter["weights"], "")
    np.savez(path / "adapter_weights.npz", **flat)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def load_adapter(path: str | Path, device: str | torch.device = "cpu") -> Params:
    """Load an adapter directory — either this framework's native format
    (adapter_weights.npz) or a torch-peft LoRA directory
    (adapter_model.safetensors / adapter_model.bin with lora_A/lora_B keys),
    the format the reference consumes and produces
    (reference: cli.py:166-174 ``PeftModel.from_pretrained``,
    finetune.py:574 ``save_pretrained``).  Tensors land on ``device``;
    ``merge_lora`` moves a delta to its kernel's device anyway."""
    path = Path(path)
    if not (path / "adapter_weights.npz").exists() and (
        (path / "adapter_model.safetensors").exists()
        or (path / "adapter_model.bin").exists()
    ):
        return load_peft_adapter(path, device)
    config = json.loads((path / "adapter_config.json").read_text())
    data = np.load(path / "adapter_weights.npz")
    weights: Params = {}
    for key in data.files:
        parts = key.split(".")
        node = weights
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.from_numpy(np.array(data[key], np.float32)).to(device)
    return {"config": config, "weights": weights}


# ---------------------------------------------------------------------------
# torch-peft interop
#
# peft stores one pair per wrapped nn.Linear:
#   base_model.model.<module path>.lora_A.weight   [r, fan_in]
#   base_model.model.<module path>.lora_B.weight   [fan_out, r]
# with module paths in the reference schema (encoder.layers.{i}.self_attention
# .q_proj, ...; dia/layers.py:419-814).  Linear computes y = x W^T and merges
# W' = W + scale·B@A; the kernels here are W^T reshaped
# (in_shapes + out_features, dia/layers.py:19-53), so the native factors are
# the transposes: a[i] = A_i^T [fan_in, r], b[i] = B_i^T [r, fan_out] —
# then scale·a@b == (scale·B@A)^T, the same delta in kernel layout.
# ---------------------------------------------------------------------------


def _load_peft_tensors(path: Path) -> dict[str, np.ndarray]:
    st = path / "adapter_model.safetensors"
    if st.exists():
        from safetensors.numpy import load_file

        return load_file(str(st))
    obj = torch.load(str(path / "adapter_model.bin"), map_location="cpu",
                     weights_only=True)
    return {k: _np(v) for k, v in obj.items()}


def load_peft_adapter(path: str | Path, device: str | torch.device = "cpu") -> Params:
    """torch-peft LoRA directory → native adapter tree (stacked L axis)."""
    path = Path(path)
    pc = json.loads((path / "adapter_config.json").read_text())
    tensors = _load_peft_tensors(path)

    # group keys by (module path without layer index, layer index)
    pairs: dict[tuple[str, ...], dict[int, dict[str, np.ndarray]]] = {}
    for key, arr in tensors.items():
        m = key
        for prefix in ("base_model.model.", "base_model."):
            if m.startswith(prefix):
                m = m[len(prefix):]
                break
        parts = m.split(".")
        if parts[-1] != "weight" or parts[-2] not in ("lora_A", "lora_B"):
            continue
        ab = "a" if parts[-2] == "lora_A" else "b"
        mod_path = parts[:-2]
        # peft>=0.7 inserts the adapter name: ...lora_A.default.weight
        if mod_path and mod_path[-1] in ("default",):
            mod_path = mod_path[:-1]
        layer = None
        tree_path = []
        for p in mod_path:
            if p.isdigit() and tree_path and tree_path[-1] == "layers":
                layer = int(p)
            else:
                tree_path.append(p)
        target = tuple(tree_path)
        pairs.setdefault(target, {}).setdefault(
            layer if layer is not None else -1, {})[ab] = np.asarray(arr)

    weights: Params = {}
    targets = set()
    for target, by_layer in pairs.items():
        name = target[-1]
        targets.add(name)
        if name not in _TARGET_SPLITS:
            raise ValueError(f"Unsupported peft LoRA target module: {'.'.join(target)}")
        stacked = set(by_layer) != {-1}
        if stacked:
            L = max(by_layer) + 1
            missing = [i for i in range(L) if i not in by_layer]
            if missing:
                raise ValueError(
                    f"peft adapter misses layers {missing} for {'.'.join(target)}")
            a = np.stack([by_layer[i]["a"].T for i in range(L)])  # [L, fan_in, r]
            b = np.stack([by_layer[i]["b"].T for i in range(L)])  # [L, r, fan_out]
        else:
            a = by_layer[-1]["a"].T
            b = by_layer[-1]["b"].T
        node = weights
        for p in target[:-1]:
            node = node.setdefault(p, {})
        node[name] = {"a": torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device),
                      "b": torch.from_numpy(np.ascontiguousarray(b, np.float32)).to(device)}

    config = _config_leaves(LoraConfig(
        r=int(pc["r"]),
        alpha=float(pc.get("lora_alpha", pc["r"])),
        dropout=float(pc.get("lora_dropout", 0.0) or 0.0),
        target_modules=tuple(sorted(targets)),
    ))
    return {"config": config, "weights": weights}


def save_peft_adapter(path: str | Path, adapter: Params) -> None:
    """Native adapter tree → torch-peft LoRA directory
    (adapter_config.json in peft schema + adapter_model.safetensors),
    loadable by ``peft.PeftModel.from_pretrained`` against the torch
    reference model (reference consumption point: cli.py:166-174)."""
    from safetensors.numpy import save_file

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    cfg = adapter["config"]
    peft_cfg = {
        "peft_type": "LORA",
        "task_type": None,
        "r": int(cfg["r"]),
        "lora_alpha": float(cfg["alpha"]),
        "lora_dropout": float(cfg.get("dropout", 0.0)),
        "target_modules": list(cfg["target_modules"]),
        "bias": "none",
        "fan_in_fan_out": False,
        "inference_mode": True,
        "base_model_name_or_path": None,
    }
    (path / "adapter_config.json").write_text(json.dumps(peft_cfg, indent=2))

    tensors: dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if not isinstance(v, dict):
                continue
            if "a" in v and "b" in v and not isinstance(v["a"], dict):
                a, b = _np(v["a"]), _np(v["b"])
                base = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
                if a.ndim == 3:  # stacked layers → per-layer peft keys
                    # prefix ends with the container ("...layers"); peft paths
                    # index it: encoder.layers.{i}.self_attention.q_proj
                    parts = base.split(".")
                    li = parts.index("layers")
                    for i in range(a.shape[0]):
                        mod = ".".join(parts[: li + 1] + [str(i)] + parts[li + 1:])
                        tensors[f"base_model.model.{mod}.lora_A.weight"] = \
                            np.ascontiguousarray(a[i].T)
                        tensors[f"base_model.model.{mod}.lora_B.weight"] = \
                            np.ascontiguousarray(b[i].T)
                else:
                    tensors[f"base_model.model.{base}.lora_A.weight"] = \
                        np.ascontiguousarray(a.T)
                    tensors[f"base_model.model.{base}.lora_B.weight"] = \
                        np.ascontiguousarray(b.T)
            else:
                walk(v, f"{prefix}{k}" if not prefix else f"{prefix}.{k}")

    walk(adapter["weights"], "")
    save_file(tensors, str(path / "adapter_model.safetensors"))


def lora_param_count(adapter: Params) -> int:
    def count(tree):
        return sum(count(v) if isinstance(v, dict) else int(v.numel()) for v in tree.values())

    return count(adapter["weights"])
