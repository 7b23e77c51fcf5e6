"""Teacher-forced fine-tuning, full and LoRA (counterpart of
``dia_tts_prune_tpu/train.py``).

The same corrected semantics as the JAX package's trainer:

* decoder input  = delay(BOS + audio[:-1])  (finetune.py:190-204);
* loss target    = delay(audio) — next-token prediction of the **delayed**
  stream, as inference generates it; ``loss_mode="reference"`` replicates the
  reference's undelayed target (finetune.py:208) for comparisons;
* CE loss with pad-token masking (finetune.py:446-451, 520-526) and a
  NaN-loss skip (finetune.py:529-532);
* AdamW + global-norm clipping + {linear, cosine, step, constant} schedules
  with a real warmup + gradient accumulation.  The JAX package builds these
  from optax; here they are written out (``Optimizer``), because the
  obvious PyTorch calls differ from optax in small ways — the clip scale, the
  schedule count under accumulation and under skipped steps —
  and the tests hold this module to optax step by step;
* LoRA mode: the base params are detached and the adapter is merged inside
  the loss, so gradients flow only to A/B (lora.py);
* rematerialization of every layer in the backward pass
  (``torch.utils.checkpoint``): a 3072-step teacher-forced pass of the 1.6B
  model keeps only each layer's input;
* training under a mesh (``Trainer(mesh=)``, the JAX ``train.py:280-341``):
  where the JAX package lets GSPMD derive every gradient collective from the
  shardings, each rank here holds local shards (``parallel/sharding.py``)
  and the collectives are written out: the model axis's forward sums and
  their gradient partners (``ops.modules.model_psum`` / ``model_copy``), the
  FSDP gathers (``sharding.data_gather``), the mask count and the
  gradients summed over the batch axes, the global norm over exactly the
  axes each leaf is sharded on (``MeshPlan``).

Every attention of the loss runs the trainable flash kernels on the card
(``ops/kernels/flash_attention.py``).  Unlike the JAX functions, which return
new trees, ``train_step`` and ``lora_train_step`` update the trained tensors
and the optimizer state in place.

Full fine-tuning keeps float32 master weights and moments whatever the
compute dtype; with ``compute_dtype="bfloat16"`` the loss runs on a bfloat16
cast of them (gradients flow back through the cast).  Compute dtypes are
float32 and bfloat16, the kernels' dtypes; float16 raises.
"""

from __future__ import annotations

import json
import math
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable

import numpy as np
import torch
import torch.nn.functional as F

from .config import DiaConfig
from .lora import (
    LoraConfig,
    factor_layout,
    gather_factor,
    init_lora,
    merge_lora,
    shard_factor,
    shard_lora,
)
from .models.dia import decoder_forward, encoder_forward, param_shapes
from .ops.delay import apply_audio_delay_np
from .parallel import sharding

Params = dict[str, Any]

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _compute_dtype(name: str) -> torch.dtype:
    if name not in COMPUTE_DTYPES:
        raise ValueError(f"compute dtype {name!r} is not supported: the attention kernels take "
                         f"{sorted(COMPUTE_DTYPES)}")
    return COMPUTE_DTYPES[name]


@dataclass(frozen=True)
class TrainConfig:
    """Mirrors the reference CLI surface (finetune.py:267-305)."""

    learning_rate: float = 1e-5
    epochs: int = 1
    batch_size: int = 2
    gradient_accumulation_steps: int = 1
    max_grad_norm: float = 1.0
    lr_scheduler_type: str = "cosine"  # linear | cosine | step | constant
    warmup_steps: int = 0
    weight_decay: float = 0.0
    adapter_mode: str = "none"  # none | lora
    lora: LoraConfig = LoraConfig()
    loss_mode: str = "delayed"  # delayed (inference-consistent) | reference
    qat_mode: str = "none"  # none | int8 | int4 | int4_hybrid (decoder-scope STE fake-quant)
    remat: bool = True
    compute_dtype: str = "float32"
    seed: int = 42
    logging_steps: int = 10
    save_steps: int = 200


# ---------------------------------------------------------------------------
# Batch construction (host, numpy; reference: finetune.py:113-204)
# ---------------------------------------------------------------------------


def build_train_batch(
    config: DiaConfig,
    text_ids: np.ndarray,  # [B, T_text] int
    audio_codes_list: list[np.ndarray],  # B × [T_i, C] int
    loss_mode: str = "delayed",
) -> dict[str, np.ndarray]:
    """Pad/truncate audio, build delayed decoder inputs + targets."""
    d = config.data
    B = text_ids.shape[0]
    T, C = d.audio_length, d.channels
    audio = np.full((B, T, C), d.audio_pad_value, dtype=np.int32)
    for i, codes in enumerate(audio_codes_list):
        n = min(codes.shape[0], T)
        audio[i, :n] = codes[:n]

    bos = np.full((B, 1, C), d.audio_bos_value, dtype=np.int32)
    pad_row = np.full((B, 1, C), d.audio_pad_value, dtype=np.int32)
    delay = tuple(d.delay_pattern)
    # decoder input: delay(BOS + audio[:-1]) (finetune.py:190-204)
    dec_in_raw = np.concatenate([bos, audio[:, :-1], pad_row], axis=1)  # [B, T+1, C]
    dec_in = apply_audio_delay_np(dec_in_raw, d.audio_pad_value, d.audio_bos_value, delay)[:, :T]

    if loss_mode == "reference":
        targets = audio  # undelayed (finetune.py:208 — reference as written)
    else:
        targets = apply_audio_delay_np(np.concatenate([audio, pad_row], axis=1),
                                       d.audio_pad_value, d.audio_bos_value, delay)[:, :T]
    return {
        "text_ids": text_ids.astype(np.int32),
        "decoder_input_ids": dec_in.astype(np.int32),
        "target_ids": targets.astype(np.int32),
    }


# ---------------------------------------------------------------------------
# Loss
# ---------------------------------------------------------------------------


def compute_loss(
    params: Params,
    config: DiaConfig,
    batch: dict[str, torch.Tensor],
    compute_dtype=torch.float32,
    remat: bool = False,
    qat_mode: str = "none",
    group=None,
    mesh=None,
) -> torch.Tensor:
    """Teacher-forced CE with pad masking (finetune.py:446-451, 517-526).

    ``qat_mode`` != "none" runs the forward through the serving quantizer's
    numerics (decoder-scope fake-quant, straight-through gradients — see
    ops/quant.py::fake_quant_params_ste).  ``group``: a mesh's model group
    over local shards, the whole batch on every rank.  ``mesh``: a training
    mesh (``Trainer(mesh=)``): ``params`` are local shards whole along the
    data axis, ``batch`` this rank's rows, the model group is the mesh's, and
    the masked sum is divided by the mask count summed over the batch axes
    (the JAX ``train.py:157`` divides by the global batch's), so that the
    ranks' losses add up to the global batch's loss."""
    if mesh is not None:
        group = sharding.model_group(mesh)
    if qat_mode != "none":
        from .ops.quant import fake_quant_params_ste

        params = fake_quant_params_ste(params, qat_mode, model_group=group)
    d = config.data
    text_ids = batch["text_ids"]
    B, T_text = text_ids.shape
    dev = text_ids.device
    enc_padding = text_ids != d.text_pad_value
    positions = torch.arange(T_text, device=dev)[None].expand(B, T_text)
    enc_out = encoder_forward(params, config, text_ids, positions, compute_dtype, remat=remat,
                              group=group)

    T = batch["decoder_input_ids"].shape[1]
    dec_positions = torch.arange(T, device=dev)[None].expand(B, T)
    logits = decoder_forward(params, config, batch["decoder_input_ids"], enc_out, positions,
                             dec_positions, enc_padding, compute_dtype, remat=remat,
                             group=group)
    # [B, T, C, V] fp32

    targets = batch["target_ids"].long()
    mask = (targets != d.audio_pad_value).float()
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1),
                         reduction="none").reshape(targets.shape)
    count = mask.sum()
    if mesh is not None:
        for axis in sharding.batch_axes(mesh):
            _sum_over(count, mesh, axis)
    return (ce * mask).sum() / count.clamp_min(1.0)


def _sum_over(t: torch.Tensor, mesh, axis: str) -> None:
    """``t`` summed in place over the ranks of ``axis`` (nothing on one rank)."""
    if sharding.axis_size(mesh, axis) > 1:
        import torch.distributed as dist

        dist.all_reduce(t, group=mesh.get_group(axis))


# ---------------------------------------------------------------------------
# Schedules and optimizer (what the JAX package takes from optax)
# ---------------------------------------------------------------------------


def make_schedule(tc: TrainConfig, num_training_steps: int) -> Callable[[int], float]:
    """LR schedules matching the reference set (finetune.py:232-262), with a
    real linear warmup joined in front: ``schedule(count)`` is the rate of the
    update applied after ``count`` earlier ones.  The formulas are optax's
    (``linear_schedule``, ``cosine_decay_schedule``,
    ``piecewise_constant_schedule``, ``join_schedules``)."""
    base = tc.learning_rate
    steps = max(1, num_training_steps)
    kind = tc.lr_scheduler_type
    if kind == "step":
        b1 = max(1, steps // 3)
        b2 = max(b1 + 1, 2 * steps // 3)  # keep two distinct staged decays
    elif kind not in ("linear", "cosine", "constant"):
        raise ValueError(f"Unknown scheduler: {kind}")

    def main(count: int) -> float:
        if kind == "linear":
            return base * (1.0 - min(max(count, 0), steps) / steps)
        if kind == "cosine":
            return base * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))
        if kind == "step":
            return base * (0.1 if count >= b1 else 1.0) * (0.1 if count >= b2 else 1.0)
        return base

    warmup = tc.warmup_steps
    if warmup <= 0:
        return main

    def joined(count: int) -> float:
        if count < warmup:
            return base * min(max(count, 0), warmup) / warmup
        return main(count - warmup)

    return joined


def _flatten(tree: Params, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dict of tensors → {dotted path: tensor}, in tree order."""
    flat: dict[str, torch.Tensor] = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _map_tree(fn, tree: Params) -> Params:
    return {k: _map_tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over a list of tensors, in fp32 (``optax.global_norm``)."""
    return torch.stack([t.float().square().sum() for t in tensors]).sum().sqrt()


class Optimizer:
    """``optax.chain(clip_by_global_norm, adamw(schedule))`` under
    ``optax.MultiSteps(k)``, over a flat dict of leaf tensors which it updates
    in place.

    * accumulation keeps the running mean of ``k`` micro-gradients; clipping
      acts on that mean; moments and the schedule count advance once per ``k``;
    * clip: gradients are scaled by ``max_norm / norm`` only when
      ``norm >= max_norm`` (no epsilon in the divisor);
    * AdamW: ``p <- p - lr * (m_hat / (sqrt(v_hat) + 1e-8) + wd * p)`` with
      ``b1 = 0.9``, ``b2 = 0.999``, ``lr = schedule(count of applied updates)``.

    State lives in fp32 on the leaves' device: ``mu``, ``nu``, the accumulator
    (only when ``k > 1``) and the integer counters.  Under a mesh the leaves
    are local shards, so the state is shard-sized (ZeRO), the arithmetic
    unchanged; the gradients come reduced and ``norm`` is the mesh's."""

    B1, B2, EPS = 0.9, 0.999, 1e-8

    def __init__(self, tc: TrainConfig, num_training_steps: int, leaves: dict[str, torch.Tensor],
                 norm=None):
        # the global norm of a gradient dict (a mesh's: ``MeshPlan.norm``)
        self.norm = norm or (lambda grads: global_norm(grads.values()))
        self.schedule = make_schedule(tc, num_training_steps)
        self.max_grad_norm = float(tc.max_grad_norm)
        self.weight_decay = float(tc.weight_decay)
        self.k = max(1, int(tc.gradient_accumulation_steps))
        self.leaves = leaves
        self.mu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()}
        self.nu = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()}
        self.acc = ({n: torch.zeros_like(p, dtype=torch.float32) for n, p in leaves.items()}
                    if self.k > 1 else {})
        self.count = 0  # applied updates
        self.mini_step = 0  # micro-gradients in the accumulator

    @torch.no_grad()
    def update(self, grads: dict[str, torch.Tensor]) -> None:
        """Take one (micro-)gradient; apply an update when ``k`` have come."""
        if self.k > 1:
            for n, g in grads.items():
                self.acc[n] += (g.float() - self.acc[n]) / (self.mini_step + 1)
            self.mini_step += 1
            if self.mini_step < self.k:
                return
            grads = self.acc
        scale = None
        if self.max_grad_norm > 0:
            norm = self.norm(grads)
            scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                                self.max_grad_norm / norm)
        lr = self.schedule(self.count)
        self.count += 1
        bc1 = 1.0 - self.B1 ** self.count
        bc2 = 1.0 - self.B2 ** self.count
        for n, p in self.leaves.items():
            g = grads[n].float()
            if scale is not None:
                g = g * scale
            mu, nu = self.mu[n], self.nu[n]
            mu.mul_(self.B1).add_(g, alpha=1.0 - self.B1)
            nu.mul_(self.B2).addcmul_(g, g, value=1.0 - self.B2)
            step = (mu / bc1) / ((nu / bc2).sqrt_() + self.EPS)
            if self.weight_decay:
                step.add_(p.float(), alpha=self.weight_decay)
            p.sub_((lr * step).to(p.dtype))
        if self.k > 1:
            for a in self.acc.values():
                a.zero_()
            self.mini_step = 0

    def state_tensors(self) -> dict[str, torch.Tensor]:
        out = {}
        for group, tree in (("mu", self.mu), ("nu", self.nu), ("acc", self.acc)):
            out.update({f"{group}/{n}": t for n, t in tree.items()})
        return out

    def load_state_tensors(self, tensors: dict[str, torch.Tensor]) -> None:
        for group, tree in (("mu", self.mu), ("nu", self.nu), ("acc", self.acc)):
            for n, t in tree.items():
                t.copy_(tensors[f"{group}/{n}"])


# ---------------------------------------------------------------------------
# Train steps (update the trained tensors and the optimizer in place)
# ---------------------------------------------------------------------------


def _cast_tree(tree: Params, dtype: torch.dtype) -> Params:
    """Floating leaves as ``dtype`` (differentiable; leaves already there are
    shared, not copied)."""
    return _map_tree(lambda w: w.to(dtype) if w.is_floating_point() else w, tree)


def _grads(loss_fn, optimizer: Optimizer, plan=None) -> tuple[torch.Tensor, dict]:
    """The loss and the gradient of every optimizer leaf (zeros for an unused
    one), reduced over the mesh by ``plan`` (``MeshPlan.reduce``)."""
    names = list(optimizer.leaves)
    loss = loss_fn()
    grads = torch.autograd.grad(loss, [optimizer.leaves[n] for n in names], allow_unused=True)
    grads = {n: torch.zeros_like(optimizer.leaves[n]) if g is None else g.contiguous()
             for n, g in zip(names, grads)}
    loss = loss.detach()
    if plan is not None:
        loss, grads = plan.reduce(loss, grads)
    return loss, grads


def _step(loss_fn, optimizer: Optimizer, plan=None) -> tuple[torch.Tensor, torch.Tensor]:
    loss, grads = _grads(loss_fn, optimizer, plan)
    grad_norm = optimizer.norm(grads)  # before clipping
    # NaN-loss skip (reference: finetune.py:529-532): params, moments and
    # counters stay untouched.  The one read-back of the step; under a mesh
    # loss and norm are reduced, so every rank decides the same.
    if bool(torch.isfinite(loss) & torch.isfinite(grad_norm)):
        optimizer.update(grads)
    return loss, grad_norm


def _full_loss(params: Params, batch, config: DiaConfig, dtype, remat: bool, qat_mode: str,
               plan=None):
    """The loss of a full fine-tune as a closure (FSDP leaves gathered inside)."""
    def loss_fn():
        p = _cast_tree(params, dtype)
        if plan is not None:
            p = plan.gather(p)
        return compute_loss(p, config, batch, dtype, remat=remat, qat_mode=qat_mode,
                            mesh=None if plan is None else plan.mesh)

    return loss_fn


def _lora_loss(base_params: Params, adapter_weights: Params, adapter_static: tuple, batch,
               config: DiaConfig, dtype, remat: bool, plan=None):
    """The loss of a LoRA step as a closure: the merge inside, on detached
    base weights (gathered first under FSDP)."""
    r, alpha = adapter_static
    adapter = {"config": {"r": r, "alpha": alpha, "dropout": 0.0, "target_modules": []},
               "weights": adapter_weights}
    base = _map_tree(lambda w: w.detach(), base_params)

    def loss_fn():
        merged = merge_lora(base if plan is None else plan.gather(base), adapter)
        return compute_loss(_cast_tree(merged, dtype), config, batch, dtype, remat=remat,
                            mesh=None if plan is None else plan.mesh)

    return loss_fn


def train_step(
    params: Params,
    optimizer: Optimizer,
    batch: dict[str, torch.Tensor],
    config: DiaConfig,
    compute_dtype_name: str = "float32",
    remat: bool = True,
    qat_mode: str = "none",
    plan=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One full-fine-tune update of ``params`` (leaves with
    ``requires_grad``, the optimizer's leaves).  Returns (loss, grad_norm).
    ``plan``: a ``MeshPlan`` for local shards and this rank's rows."""
    dtype = _compute_dtype(compute_dtype_name)
    return _step(_full_loss(params, batch, config, dtype, remat, qat_mode, plan), optimizer, plan)


def lora_train_step(
    base_params: Params,
    adapter_weights: Params,
    adapter_static: tuple,  # (r, alpha)
    optimizer: Optimizer,
    batch: dict[str, torch.Tensor],
    config: DiaConfig,
    compute_dtype_name: str = "float32",
    remat: bool = True,
    plan=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One LoRA update: only A/B receive gradients (reference peft wrap:
    finetune.py:374-396); the merge happens inside the loss."""
    dtype = _compute_dtype(compute_dtype_name)
    return _step(_lora_loss(base_params, adapter_weights, adapter_static, batch, config, dtype,
                            remat, plan), optimizer, plan)


# ---------------------------------------------------------------------------
# Training under a mesh
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class _Leaf:
    """A trained leaf on a mesh: the axes it is sharded over, whether its
    gradient on a rank is a partial sum over the model axis (a replicated
    LoRA factor whose use lies inside a shard), and the maps between its
    whole value and this rank's block."""

    axes: tuple[str, ...]
    partial: bool
    local: Callable[[torch.Tensor], torch.Tensor]
    whole: Callable[[torch.Tensor], torch.Tensor]


class MeshPlan:
    """What a ``Trainer`` does on a mesh beyond one process's step.

    * ``gather``: FSDP leaves (a ``data`` axis in their storage spec) whole
      along the data axis before use (``sharding.data_gather``: the
      gradient comes back reduce-scattered, already summed over data);
    * ``reduce``: every gradient summed over the batch axes (replica and
      data; an FSDP leaf's over replica only), a partial one over the model
      axis, and the loss summed over the batch axes;
    * ``norm``: each leaf's local sum of squares summed over exactly the
      axes it is sharded on (a replicated leaf counts once), then the root
      of their sum, in the one-process ``global_norm``'s order.  On a mesh
      whose every axis has one rank the step's arithmetic is one process's.

    Every collective is issued in tree order, the same on every rank."""

    def __init__(self, mesh, specs: Params, leaves: dict[str, _Leaf]):
        self.mesh, self.specs, self.leaves = mesh, specs, leaves

    def gather(self, tree: Params) -> Params:
        if sharding.axis_size(self.mesh, sharding.AXIS_DATA) == 1:
            return tree
        group = self.mesh.get_group(sharding.AXIS_DATA)
        return sharding.map_specs(
            lambda spec, x, path: sharding.data_gather(x, spec.index(sharding.AXIS_DATA), group)
            if sharding.AXIS_DATA in spec else x, self.specs, tree)

    def reduce(self, loss: torch.Tensor, grads: dict) -> tuple[torch.Tensor, dict]:
        for n, g in grads.items():
            leaf = self.leaves[n]
            if leaf.partial:
                _sum_over(g, self.mesh, sharding.AXIS_MODEL)
            for axis in sharding.batch_axes(self.mesh):
                if not (axis == sharding.AXIS_DATA and axis in leaf.axes):
                    _sum_over(g, self.mesh, axis)
        loss = loss.reshape(1).clone()
        for axis in sharding.batch_axes(self.mesh):
            _sum_over(loss, self.mesh, axis)
        return loss.reshape(()), grads

    def norm(self, grads: dict) -> torch.Tensor:
        names = list(grads)
        sq = torch.stack([grads[n].float().square().sum() for n in names])
        for axis in (sharding.AXIS_MODEL, sharding.AXIS_DATA):
            on = [axis in self.leaves[n].axes for n in names]
            if sharding.axis_size(self.mesh, axis) > 1 and any(on):
                mask = torch.tensor(on, device=sq.device)
                part = torch.where(mask, sq, torch.zeros_like(sq))
                _sum_over(part, self.mesh, axis)
                sq = torch.where(mask, part, sq)
        return sq.sum().sqrt()


def storage_specs(config: DiaConfig, params: Params, mesh) -> Params:
    """The spec tree under which ``params`` are this rank's local shards of
    ``config``'s model: the tensor-parallel plan (``shard_params``,
    ``Dia.shard``) or the FSDP one (``shard_params(fsdp=True)``), told apart
    by the local shapes.  Raises for any other tree."""
    shapes = param_shapes(config)
    meta = _map_tree(lambda shape: torch.empty(shape, device="meta"), shapes)

    def at(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    for specs in (sharding.param_specs(config),
                  sharding.fsdp_param_specs(config, meta, mesh)):
        try:
            fits = sharding.map_specs(lambda spec, x, path: torch.is_tensor(x) and tuple(
                x.shape) == sharding.local_shape(at(shapes, path), spec, mesh), specs, params)
        except ValueError:
            break
        if all(_flatten(fits).values()):
            return specs
    raise ValueError("Trainer(mesh=): the params are not this rank's local shards of the "
                     "config's model under the tensor-parallel or the FSDP layout "
                     "(parallel/sharding.py::shard_params)")


# ---------------------------------------------------------------------------
# Trainer
# ---------------------------------------------------------------------------


def latest_step_dir(directory: str | Path) -> Path | None:
    """The newest ``step_{N}`` subdirectory, for resume."""
    directory = Path(directory)
    if not directory.exists():
        return None
    best, best_step = None, -1
    for p in directory.iterdir():
        m = re.fullmatch(r"step_(\d+)", p.name)
        if m and int(m.group(1)) > best_step:
            best, best_step = p, int(m.group(1))
    return best


class Trainer:
    """Epoch-loop state with logging counters and checkpointing (reference:
    finetune.py:458-585), plus the optimizer-state save/resume the reference
    lacks.  Full mode trains a private float32 copy of ``params``; LoRA mode
    leaves ``params`` as they are (any float dtype) and trains the adapter.

    ``mesh`` (the JAX ``Trainer(mesh=)``, :280-341): a ``DeviceMesh`` from
    ``parallel.sharding.make_mesh``, ``params`` this rank's local shards —
    ``shard_params(..., fsdp=)`` or ``Dia.shard`` — and every rank makes the
    same calls.  ``step`` takes the global numpy batch and keeps its own rows
    (``shard_batch``: over data, and replica on a hybrid mesh; the params
    are replicated over replica) and returns the same loss and grad_norm on
    every rank.  The layout is read from the local shapes
    (``storage_specs``).  The adapter of LoRA mode is drawn at
    the whole model's shapes, then sharded (``lora.shard_lora``), so it
    equals the unsharded one.  ``trained_params`` and ``adapter`` return the
    whole tree, and ``save`` / ``restore`` write and read the unsharded file
    layout, so a checkpoint crosses between meshes and one process."""

    def __init__(self, params: Params, config: DiaConfig, tc: TrainConfig,
                 num_training_steps: int, mesh=None):
        self.config = config
        self.tc = tc
        self.mesh = mesh
        self.global_step = 0
        _compute_dtype(tc.compute_dtype)

        if tc.qat_mode != "none" and tc.adapter_mode == "lora":
            raise ValueError(
                "QAT composes with full fine-tuning only: at serving the "
                "adapter is merged THEN quantized, so fake-quanting a frozen "
                "base under fp LoRA deltas would train against different "
                "numerics than it serves. Merge first, then QAT-finetune.")
        self.specs = None if mesh is None else storage_specs(config, params, mesh)
        generator = torch.Generator().manual_seed(tc.seed)
        if tc.adapter_mode == "lora":
            self.base_params = params
            if mesh is None:
                adapter = init_lora(params, tc.lora, generator)
            else:
                whole = _map_tree(lambda shape: torch.empty(shape, device="meta"),
                                  param_shapes(config))
                adapter = init_lora(whole, tc.lora, generator,
                                    device=next(iter(_flatten(params).values())).device)
                adapter["weights"] = shard_lora(adapter["weights"], mesh)
            self.adapter_cfg = adapter["config"]
            self.adapter_weights = adapter["weights"]
            trained = self.adapter_weights
        else:
            self.params = _map_tree(lambda w: w.detach().float().clone(), params)
            trained = self.params
        self._leaves = _flatten(trained)
        for leaf in self._leaves.values():
            leaf.requires_grad_(True)
        self.plan = None if mesh is None else MeshPlan(mesh, self.specs, self._mesh_leaves())
        self.optimizer = Optimizer(tc, num_training_steps, self._leaves,
                                   norm=None if self.plan is None else self.plan.norm)

    def _mesh_leaves(self) -> dict[str, _Leaf]:
        mesh = self.mesh
        if self.tc.adapter_mode == "lora":
            out = {}
            for n in self._leaves:
                name, factor = n.split(".")[-2:]
                dim, partial = factor_layout(name, factor)
                out[n] = _Leaf((sharding.AXIS_MODEL,) if dim is not None else (), partial,
                               lambda t, a=name, f=factor: shard_factor(t, a, f, mesh),
                               lambda t, a=name, f=factor: gather_factor(t, a, f, mesh))
            return out
        specs = _flatten(self.specs)
        return {n: _Leaf(tuple(a for a in spec if a is not None), False,
                         lambda t, s=spec, n=n: sharding.local_shard(t, s, mesh, n),
                         lambda t, s=spec: sharding.gather_leaf(t, s, mesh))
                for n, spec in ((n, specs[n]) for n in self._leaves)}

    def _batch(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        dev = next(iter(self._leaves.values())).device
        batch = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        if self.mesh is not None:
            batch = sharding.shard_batch(batch, self.mesh)
        return {k: v.to(dev) for k, v in batch.items()}

    def _loss_fn(self, batch: dict[str, torch.Tensor]):
        dtype = _compute_dtype(self.tc.compute_dtype)
        if self.tc.adapter_mode == "lora":
            return _lora_loss(self.base_params, self.adapter_weights,
                              (self.adapter_cfg["r"], self.adapter_cfg["alpha"]), batch,
                              self.config, dtype, self.tc.remat, self.plan)
        return _full_loss(self.params, batch, self.config, dtype, self.tc.remat,
                          self.tc.qat_mode, self.plan)

    def step(self, batch: dict[str, np.ndarray]) -> dict[str, float]:
        loss, gnorm = _step(self._loss_fn(self._batch(batch)), self.optimizer, self.plan)
        self.global_step += 1
        return {"loss": float(loss), "grad_norm": float(gnorm), "step": self.global_step}

    def gradients(self, batch: dict[str, np.ndarray]) -> tuple[float, dict[str, torch.Tensor]]:
        """The loss and the gradient of every trained leaf (dotted path)
        that ``step`` would apply, reduced as ``step`` reduces them (a rank's
        block under a mesh); nothing is updated."""
        loss, grads = _grads(self._loss_fn(self._batch(batch)), self.optimizer, self.plan)
        return float(loss), grads

    # ---- persistence -------------------------------------------------

    def trained_params(self) -> Params:
        """The trained weights as a detached tree: the merged model in LoRA
        mode, the float32 master weights otherwise; the whole model under a
        mesh (a collective call)."""
        if self.tc.adapter_mode == "lora":
            base = self.base_params
            if self.mesh is not None:
                base = sharding.gather_params(base, self.mesh, self.specs)
            with torch.no_grad():
                return merge_lora(base, self.adapter())
        if self.mesh is not None:
            return sharding.gather_params(self.params, self.mesh, self.specs)
        return _map_tree(lambda w: w.detach(), self.params)

    def adapter(self) -> Params | None:
        """The adapter (the whole one under a mesh: a collective call)."""
        if self.tc.adapter_mode != "lora":
            return None
        weights = _map_tree(lambda w: w.detach(), self.adapter_weights)
        if self.mesh is not None:
            from .lora import gather_lora

            weights = gather_lora(weights, self.mesh)
        return {"config": self.adapter_cfg, "weights": weights}

    def save(self, directory, step: int | None = None) -> None:
        """Write ``state.safetensors`` (trained tensors, moments, accumulator)
        and ``state.json`` (step and counters) under ``directory`` or its
        ``step_{N}`` subdirectory.  The files are this package's own: the JAX
        package's orbax checkpoints are not read, nor these by it.  Under a
        mesh every tensor is written whole, by rank 0 (a collective call)."""
        from safetensors.torch import save_file

        tensors = {f"trained/{n}": t.detach() for n, t in self._leaves.items()}
        tensors.update(self.optimizer.state_tensors())
        if self.mesh is not None:
            tensors = {k: self.plan.leaves[k.split("/", 1)[1]].whole(t)
                       for k, t in tensors.items()}
        path = Path(directory)
        if step is not None:
            path = path / f"step_{step}"
        if self.mesh is None or _rank() == 0:
            path.mkdir(parents=True, exist_ok=True)
            save_file({k: v.contiguous().cpu() for k, v in tensors.items()},
                      str(path / "state.safetensors"))
            (path / "state.json").write_text(json.dumps({
                "step": self.global_step, "count": self.optimizer.count,
                "mini_step": self.optimizer.mini_step, "adapter_mode": self.tc.adapter_mode}))
        if self.mesh is not None:
            import torch.distributed as dist

            dist.barrier()  # the files are whole before any rank reads them

    def restore(self, directory) -> int:
        """Resume trained tensors, optimizer state and step from a directory
        written by ``save`` (or the newest ``step_{N}`` under it), with or
        without a mesh on either side.  Returns the restored global step."""
        from safetensors.torch import load_file

        path = latest_step_dir(directory) or Path(directory)
        meta = json.loads((path / "state.json").read_text())
        if meta["adapter_mode"] != self.tc.adapter_mode:
            raise ValueError(f"checkpoint {path} was written in adapter mode "
                             f"{meta['adapter_mode']!r}, this trainer runs "
                             f"{self.tc.adapter_mode!r}")
        tensors = load_file(str(path / "state.safetensors"))
        if self.mesh is not None:
            tensors = {k: self.plan.leaves[k.split("/", 1)[1]].local(t)
                       for k, t in tensors.items()}
        with torch.no_grad():
            for n, t in self._leaves.items():
                t.copy_(tensors[f"trained/{n}"])
        self.optimizer.load_state_tensors(tensors)
        self.optimizer.count = int(meta["count"])
        self.optimizer.mini_step = int(meta["mini_step"])
        self.global_step = int(meta["step"])
        return self.global_step


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank()
