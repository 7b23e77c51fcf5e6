"""Magnitude pruning as mask trees (counterpart of ``dia_tts_prune_tpu/prune.py``;
reference: dia/pruning_utils.py).

* **Unstructured**: one global L1 threshold over every dense kernel
  (reference: dia/pruning_utils.py:42-62).
* **Structured**: per-module (per-layer) Ln ranking of slices along a
  dimension of the per-layer weight (torch ``prune.ln_structured``,
  dia/pruning_utils.py:64-119); modules that lack the dimension are kept.
* **Block**: (block_k, block_n) blocks of each module's ``[first in-dim,
  rest]`` view ranked by L1 norm, globally or per module — the zeros the
  block-sparse matmul skips (``ops/sparse.py``).
* ``apply_masks`` = ``weight * mask`` (reference ``make_pruning_permanent``);
  ``sparsity_report`` counts zeros over the prunable population.
* ``shrink_heads`` / ``shrink_ffn`` remove attention heads and FFN channels
  for real and return the smaller config.

A mask tree has the params' structure: a bool tensor beside every kernel,
``None`` beside every other leaf.  The masks equal the JAX package's for the
same weights, element for element: the same thresholds (exact k-th smallest
values), the same stable orderings, the same ``int(round(amount * n))``
counts.  Norms are reduced on the weights' device; only block-norm grids and
per-slice norms come to the host.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from .config import DiaConfig

Params = dict[str, Any]

# Dense kernels are the prunable population (reference: DenseGeneral modules);
# embeddings and norm scales are not (dia/pruning_utils.py:11).
_PRUNABLE_LEAF = "kernel"


def prunable_items(params: Params) -> list[tuple[tuple[str, ...], torch.Tensor]]:
    """All (path, kernel) pairs in the prunable population, in tree order."""
    return list(_kernel_items(params, ()))


def _kernel_items(tree: Params, path: tuple[str, ...]):
    # a module-level generator, not a closure that calls itself: such a
    # closure is a reference cycle, and the kernels it collected would live
    # until the garbage collector ran — a whole extra copy of the weights
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _kernel_items(v, path + (k,))
        elif k == _PRUNABLE_LEAF:
            yield path + (k,), v


def _mask_tree_like(params: Params, fn: Callable[[tuple[str, ...], torch.Tensor], torch.Tensor],
                    path: tuple[str, ...] = ()) -> Params:
    """The params' structure with ``fn(path, kernel)`` beside every kernel and
    None beside every other leaf."""
    return {k: (_mask_tree_like(v, fn, path + (k,)) if isinstance(v, dict)
                else fn(path + (k,), v) if k == _PRUNABLE_LEAF else None)
            for k, v in params.items()}


def _kth_smallest(values: np.ndarray, k: int) -> float:
    """The threshold of a magnitude ranking: the k-th smallest value (torch
    zeroes exactly the k smallest), -inf when nothing is pruned."""
    return -np.inf if k <= 0 else np.partition(values, k - 1)[k - 1]


def unstructured_masks(params: Params, amount: float) -> Params:
    """Global L1 masks: the ``amount`` fraction of smallest |w| over all
    prunable kernels together (torch ``prune.global_unstructured`` +
    ``L1Unstructured``, dia/pruning_utils.py:42-62)."""
    if not 0.0 <= amount < 1.0:
        raise ValueError(f"amount must be in [0, 1): {amount}")
    items = prunable_items(params)
    if amount == 0.0:
        return _mask_tree_like(params, lambda p, w: torch.ones_like(w, dtype=torch.bool))
    mags = np.concatenate([w.detach().abs().float().cpu().numpy().ravel() for _, w in items])
    threshold = _kth_smallest(mags, int(round(amount * mags.size)))
    return _mask_tree_like(params, lambda p, w: w.detach().float().abs() > float(threshold))


def structured_masks(params: Params, amount: float, dim: int, n: int = 2,
                     stacked_layer_axis: bool = True) -> Params:
    """Per-module Ln structured masks along ``dim`` of the per-layer weight
    (torch ``prune.ln_structured``, dia/pruning_utils.py:64-119): in each
    layer the ``round(amount * size)`` slices with the smallest norms are
    zeroed.  Kernels whose per-layer rank is <= ``dim`` are kept whole, as
    the reference skips them (dia/pruning_utils.py:91-94)."""

    def masks(w, lead):  # w: [*lead, per-layer dims]; ranked per leading index
        if dim >= w.dim() - lead:
            return torch.ones_like(w, dtype=torch.bool)
        d = dim + lead
        axes = tuple(a for a in range(lead, w.dim()) if a != d)
        norms = (w.detach().float().abs() ** n).sum(dim=axes) ** (1.0 / n)  # [*lead, size]
        size = norms.shape[-1]
        k = int(round(amount * size))
        if k <= 0:
            return torch.ones_like(w, dtype=torch.bool)
        order = torch.argsort(norms, dim=-1, stable=True)[..., :k]
        keep = torch.ones_like(norms, dtype=torch.bool).scatter(-1, order, False)
        shape = [1] * w.dim()
        shape[:lead] = w.shape[:lead]
        shape[d] = size
        return keep.reshape(shape).expand(w.shape).clone()

    return _mask_tree_like(params, lambda path, w: masks(
        w, 1 if stacked_layer_axis and "layers" in path else 0))


def apply_masks(params: Params, masks: Params) -> Params:
    """Permanent pruning: weight * mask (reference ``make_pruning_permanent``)."""
    out = {}
    for k, v in params.items():
        m = masks.get(k) if masks is not None else None
        if isinstance(v, dict):
            out[k] = apply_masks(v, m)
        else:
            out[k] = v if m is None else v * m.to(v.dtype)
    return out


def sparsity_report(params: Params) -> dict[str, float | int]:
    """Zero-count sparsity over the prunable population
    (reference: dia/pruning_utils.py:153-179)."""
    total = zeros = 0
    per_module = {}
    for path, w in prunable_items(params):
        wz = int((w == 0).sum())
        total += w.numel()
        zeros += wz
        per_module[".".join(path[:-1])] = wz / w.numel()
    return {"total_params": total, "zero_params": zeros,
            "sparsity": zeros / total if total else 0.0, "per_module": per_module}


def block_masks(params: Params, amount: float, block: tuple[int, int] = (256, 256),
                scope: str = "global") -> Params:
    """Block-granular L1 masks.

    Each module is viewed as 2-D ``[K, N]`` with K its FIRST in-dim and N
    the rest (per layer for stacked kernels), cut into (block_k, block_n)
    blocks, ragged at the edges, and the ``amount`` fraction of blocks with
    the smallest L1 norms is zeroed — over all modules together (``scope=
    "global"``) or within each module.

    That view is the JAX package's, and its consequence is kept: an
    ``o_proj`` kernel ``[Nq, H, D]`` is ranked as ``[Nq, H·D]``, whose blocks
    hold Nq rows only, so their norms are small next to the other modules'
    and a global ranking spends most of its budget there — in slabs that
    fill no block of the ``[Nq·H, D]`` view the block-sparse matmul reads.
    ``scope="module"`` zeroes the same share of every module's blocks (in
    this view; ``o_proj`` still keeps every block of the kernel's)."""
    if not 0.0 <= amount < 1.0:
        raise ValueError(f"amount must be in [0, 1): {amount}")
    bk, bn = block

    def norms_of(w):  # [L, K, N] → [L, nk, nn] fp32 block L1 norms, on the host
        L, K, N = w.shape
        nk, nn = -(-K // bk), -(-N // bn)
        grids = []
        for w2 in w:  # one layer's fp32 temporaries at a time
            padded = torch.zeros(nk * bk, nn * bn, dtype=torch.float32, device=w.device)
            padded[:K, :N] = w2.detach().float().abs()
            grids.append(padded.reshape(nk, bk, nn, bn).sum(dim=(1, 3)).cpu().numpy())
        return np.stack(grids)

    metas = []
    for path, w in prunable_items(params):
        ws = w if "layers" in path else w[None]
        w3 = ws.reshape(ws.shape[0], ws.shape[1], -1)
        g = norms_of(w3)
        metas.append((path, tuple(w3.shape), g))

    threshold = None
    if scope == "global":
        all_norms = np.concatenate([g.ravel() for _, _, g in metas])
        threshold = _kth_smallest(all_norms, int(round(amount * all_norms.size)))
    keeps = {}
    for path, shape, g in metas:
        n = g.ravel()
        thr = threshold if threshold is not None else _kth_smallest(
            n, int(round(amount * n.size)))
        keeps[path] = (n > thr).reshape(g.shape), shape

    def fn(path, w):
        keep, (L, K, N) = keeps[path]
        m = torch.from_numpy(keep).to(w.device)
        m = m.repeat_interleave(bk, dim=1)[:, :K].repeat_interleave(bn, dim=2)[:, :, :N]
        return m.reshape(w.shape)  # [L, K, N], L = 1 for an unstacked kernel

    return _mask_tree_like(params, fn)


# ---------------------------------------------------------------------------
# Physical structured shrinking
# ---------------------------------------------------------------------------


def shrink_heads(params: Params, config: DiaConfig, keep_fraction: float
                 ) -> tuple[Params, DiaConfig]:
    """Remove the least important attention heads for real.

    In the decoder's self-attention a KV head goes with its whole query
    group (the group size stays); encoder and cross attention drop single
    heads.  Importance = squared L2 norm of the head's q/k/v/o slices summed
    over the layer stack (one head count for every layer keeps the stacked
    layout).  At least one head is kept.  Returns (params, config)."""
    if not 0.0 < keep_fraction <= 1.0:
        raise ValueError(f"keep_fraction must be in (0, 1]: {keep_fraction}")

    def shrink_attn(attn: Params, group: int, keep_kv: int) -> Params:
        # kernels: q [L, D, Nq, H], k/v [L, Dk, Nkv, H], o [L, Nq, H, D]
        q, k, v, o = (attn[p]["kernel"] for p in ("q_proj", "k_proj", "v_proj", "o_proj"))
        nkv = k.shape[2]
        imp = ((q.float() ** 2).sum(dim=(0, 1, 3)).reshape(nkv, group).sum(dim=1)
               + (o.float() ** 2).sum(dim=(0, 2, 3)).reshape(nkv, group).sum(dim=1)
               + (k.float() ** 2).sum(dim=(0, 1, 3)) + (v.float() ** 2).sum(dim=(0, 1, 3)))
        order = torch.sort(torch.argsort(-imp, stable=True)[:keep_kv]).values
        q_ids = (order[:, None] * group + torch.arange(group, device=order.device)).reshape(-1)
        return {"q_proj": {"kernel": q.index_select(2, q_ids)},
                "k_proj": {"kernel": k.index_select(2, order)},
                "v_proj": {"kernel": v.index_select(2, order)},
                "o_proj": {"kernel": o.index_select(1, q_ids)}}

    m = config.model
    enc, dec = m.encoder, m.decoder
    enc_keep = max(1, int(round(keep_fraction * enc.n_head)))
    dec_group = dec.gqa_query_heads // dec.kv_heads
    dec_kv_keep = max(1, int(round(keep_fraction * dec.kv_heads)))
    cross_keep = max(1, int(round(keep_fraction * dec.cross_query_heads)))

    enc_layers = dict(params["encoder"]["layers"])
    enc_layers["self_attention"] = shrink_attn(enc_layers["self_attention"], 1, enc_keep)
    dec_layers = dict(params["decoder"]["layers"])
    dec_layers["self_attention"] = shrink_attn(dec_layers["self_attention"], dec_group,
                                               dec_kv_keep)
    dec_layers["cross_attention"] = shrink_attn(dec_layers["cross_attention"], 1, cross_keep)
    new_params = {k: dict(v) for k, v in params.items()}
    new_params["encoder"] = dict(params["encoder"], layers=enc_layers)
    new_params["decoder"] = dict(params["decoder"], layers=dec_layers)

    new_config = config.model_copy(update={"model": m.model_copy(update={
        "encoder": enc.model_copy(update={"n_head": enc_keep}),
        "decoder": dec.model_copy(update={"gqa_query_heads": dec_kv_keep * dec_group,
                                          "kv_heads": dec_kv_keep,
                                          "cross_query_heads": cross_keep}),
    })})
    return new_params, new_config


def shrink_ffn(params: Params, config: DiaConfig, keep_fraction: float
               ) -> tuple[Params, DiaConfig]:
    """Remove the least important FFN hidden channels for real.

    Importance of a channel = squared L2 norm of its gate and up columns
    (``wi_fused`` [L, D, 2, F]) and its ``wo`` row ([L, F, D]), per layer;
    every layer keeps the same count, a multiple of 128 (at least 128, at
    most F), and its own best channels in their original order.  Returns
    (params, config)."""
    if not 0.0 < keep_fraction <= 1.0:
        raise ValueError(f"keep_fraction must be in (0, 1]: {keep_fraction}")

    def shrink_stack(layers: Params) -> tuple[Params, int]:
        wi = layers["mlp"]["wi_fused"]["kernel"]  # [L, D, 2, F]
        wo = layers["mlp"]["wo"]["kernel"]  # [L, F, D]
        f_dim = wi.shape[-1]
        keep = min(max(128, int(round(keep_fraction * f_dim / 128)) * 128), f_dim)
        importance = (wi.float() ** 2).sum(dim=(1, 2)) + (wo.float() ** 2).sum(dim=2)  # [L, F]
        order = torch.sort(torch.argsort(-importance, dim=1, stable=True)[:, :keep], dim=1).values
        L, D = wi.shape[0], wi.shape[1]
        wi_s = torch.gather(wi, 3, order[:, None, None, :].expand(L, D, 2, keep))
        wo_s = torch.gather(wo, 1, order[:, :, None].expand(L, keep, wo.shape[2]))
        new_layers = dict(layers)
        new_layers["mlp"] = {"wi_fused": {"kernel": wi_s}, "wo": {"kernel": wo_s}}
        return new_layers, keep

    enc_layers, enc_hidden = shrink_stack(params["encoder"]["layers"])
    dec_layers, dec_hidden = shrink_stack(params["decoder"]["layers"])
    new_params = {k: dict(v) for k, v in params.items()}
    new_params["encoder"] = dict(params["encoder"], layers=enc_layers)
    new_params["decoder"] = dict(params["decoder"], layers=dec_layers)
    m = config.model
    new_config = config.model_copy(update={"model": m.model_copy(update={
        "encoder": m.encoder.model_copy(update={"n_hidden": enc_hidden}),
        "decoder": m.decoder.model_copy(update={"n_hidden": dec_hidden}),
    })})
    return new_params, new_config
