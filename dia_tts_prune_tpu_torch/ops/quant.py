"""Int8 and int4 weight quantization of the dense kernels (counterpart of
``dia_tts_prune_tpu/ops/quant.py``).

Symmetric per-output-column int8, and symmetric int4 with per-column or
grouped scales, packed for the decode loop: the loop streams every decoder
weight once per token, so its cost is weight bytes, and a packed kernel is
consumed as it is stored by ``ops/kernels/int8_matmul.py`` and
``ops/kernels/int4_gemv.py``.

The packed formats are byte for byte the JAX packers': ``values`` and
``scale`` of the same float input are equal, so a kernel packed by either
package serves the other (``checkpoint.params_from_jax``).  That rests on
the same fp32 order of operations: ``max(absmax, 1e-12) / qmax``, then
``w / scale``, round half to even, clip.

Packed layout: values are pre-flattened to 2-D ``[K, N]`` (``[L, K, N]`` in
the stacked per-layer trees), K = contracted dims, N = output columns, with
the logical kernel dims kept as metadata.

Not here: the JAX package's ``unpack_to_s4`` / ``unpack_params_s4`` and its
``kng`` layout serve XLA's 4-bit dtype, which PyTorch lacks — int4 values stay
nibble bytes.  The fused-step weight pack (``repack_decoder_fused``, built
here on request) lives beside its kernel in ``ops/kernels/fused_step.py``.

Quantization-aware training (``fake_quant_ste``, ``fake_quant_params_ste``)
is built on the same packers, so its forward sees exactly the weights a
packed model serves with, while gradients pass straight through to the float
weights.

Under a mesh (``parallel/sharding.py``) the packers take a rank's local
shards and the mesh's ``model_group``, and give each rank the packed form of
its own slice of the unsharded pack: unpacked, its values and scales are the
matching rows or columns of the whole kernel's, byte for byte.  A
column-parallel kernel (q/k/v, ``wi_fused``) holds whole columns, so nothing
changes.  A row-parallel one (``o_proj``, ``wo``) holds a slice of K: a
per-column scale takes its absolute maximum over the whole K (one all-reduce,
max), grouped scales stay on the whole kernel's grid only when the groups
tile the slice, and a halfsplit byte pairs the slice's own halves (row k
with row k + K/(2·tp)) — its rows are still the slice's.  The int4 format
(grouped or per column, halfsplit or parity) is chosen for the whole kernel;
a shard that cannot hold that format raises.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

Params = dict[str, Any]


class QuantizedKernel:
    """Packed int8 dense kernel: 2-D values + per-output-column scales.

    values: int8 ``[K, N]`` (``[L, K, N]`` stacked); scale: fp32 ``[1, N]``
    (``[L, 1, N]`` stacked); in_shape/out_shape: the kernel's logical
    contracted/output dims (``K = prod(in_shape)``, ``N = prod(out_shape)``).
    Indexing (``kernel[i]``) takes layer ``i`` of a stacked kernel."""

    __slots__ = ("values", "scale", "in_shape", "out_shape")

    def __init__(self, values, scale, in_shape, out_shape):
        self.values = values
        self.scale = scale
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)

    def __getitem__(self, i) -> "QuantizedKernel":
        return QuantizedKernel(self.values[i], self.scale[i], self.in_shape, self.out_shape)

    def to(self, device) -> "QuantizedKernel":
        return QuantizedKernel(self.values.to(device), self.scale.to(device), self.in_shape,
                               self.out_shape)

    def __repr__(self):
        return (f"QuantizedKernel(values={tuple(self.values.shape)}, "
                f"in_shape={self.in_shape}, out_shape={self.out_shape})")


class Quantized4Kernel:
    """Packed int4 dense kernel (weight-only, grouped or per-column scales).

    scale: fp32 ``[N]`` (group None) or ``[K//G, N]`` (``[L, ...]`` stacked).

    nibble: values are int8 bytes ``[K//2, N]`` holding two int4 rows each,
    two's complement.  With ``halfsplit`` byte k2 = row k2 (low nibble) |
    row k2 + K/2 (high), so both planes meet contiguous activation halves;
    otherwise byte k2 = rows 2·k2 | 2·k2+1 (row parity).  Same grid and
    scales either way.  ``nibble=False`` occurs only for an odd K, which has
    no byte pairing: values are then int8 ``[K, N]``, one int4 value each."""

    __slots__ = ("values", "scale", "in_shape", "out_shape", "group", "nibble", "halfsplit")

    def __init__(self, values, scale, in_shape, out_shape, group, nibble=True, halfsplit=False):
        self.values = values
        self.scale = scale
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.group = group
        self.nibble = bool(nibble)
        self.halfsplit = bool(halfsplit)

    @property
    def layout(self) -> str:
        """The value layout as ``ops/kernels/int4_gemv.py`` names it."""
        if not self.nibble:
            return "unpacked"
        return "halfsplit" if self.halfsplit else "parity"

    def __getitem__(self, i) -> "Quantized4Kernel":
        return Quantized4Kernel(self.values[i], self.scale[i], self.in_shape, self.out_shape,
                                self.group, self.nibble, self.halfsplit)

    def to(self, device) -> "Quantized4Kernel":
        return Quantized4Kernel(self.values.to(device), self.scale.to(device), self.in_shape,
                                self.out_shape, self.group, self.nibble, self.halfsplit)

    def __repr__(self):
        return (f"Quantized4Kernel(values={tuple(self.values.shape)}, group={self.group}, "
                f"nibble={self.nibble}, halfsplit={self.halfsplit}, "
                f"in_shape={self.in_shape}, out_shape={self.out_shape})")


PACKED_TYPES = (QuantizedKernel, Quantized4Kernel)


def _is_block_sparse(w) -> bool:
    """A ``BlockSparseKernel`` (``ops/sparse.py``, which imports this module):
    the packers leave pruned kernels as they are, like the JAX packer."""
    from .sparse import BlockSparseKernel

    return isinstance(w, BlockSparseKernel)


def _per_layer(fn, w: torch.Tensor, stacked: bool):
    """Apply ``fn`` to each layer of a stacked kernel and stack the parts:
    scales are per layer anyway, and the fp32 temporaries stay one layer
    large instead of the whole stack."""
    if not stacked:
        return fn(w)
    parts = [fn(w[i]) for i in range(w.shape[0])]
    return tuple(torch.stack(p) for p in zip(*parts))


def _split_shape(w: torch.Tensor, n_in: int, stacked: bool):
    lead = 1 if stacked else 0
    return tuple(w.shape[lead: lead + n_in]), tuple(w.shape[lead + n_in:])


def _max_over(t: torch.Tensor, model_group) -> torch.Tensor:
    """``t``'s elementwise maximum over the ranks of ``model_group`` (None: ``t``)."""
    if model_group is not None:
        import torch.distributed as dist

        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=model_group)
    return t


def _k_shards(model_group) -> int:
    if model_group is None:
        return 1
    import torch.distributed as dist

    return dist.get_world_size(model_group)


def quantize_int8(w: torch.Tensor, n_in: int = 1, stacked: bool = False,
                  model_group=None) -> QuantizedKernel:
    """Symmetric per-output-column int8: q = round(w / s), s = max|w| / 127.
    ``n_in`` leading kernel axes are contracted, the rest are flattened into
    N columns with one scale each; ``stacked`` kernels carry a leading
    per-layer axis, kept on values and scales.  ``model_group``: ``w`` is a
    rank's slice of K (a row-parallel kernel under a mesh), and each
    column's maximum is taken over every rank's slice."""
    in_shape, out_shape = _split_shape(w, n_in, stacked)
    K, N = math.prod(in_shape), math.prod(out_shape)

    def one(w1):
        w2 = w1.float().reshape(K, N)
        amax = _max_over(w2.abs().amax(dim=-2, keepdim=True), model_group)
        scale = amax.clamp_min(1e-12) / 127.0  # [1, N]
        return torch.round(w2 / scale).clamp(-127, 127).to(torch.int8), scale

    values, scale = _per_layer(one, w, stacked)
    return QuantizedKernel(values, scale, in_shape, out_shape)


def dequantize(qk: QuantizedKernel, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the kernel at its logical shape."""
    w2 = qk.values.float() * qk.scale
    return w2.reshape(*w2.shape[:-2], *qk.in_shape, *qk.out_shape).to(dtype)


def _map_kernels(params: Params, fn) -> Params:
    def walk(tree, path):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, path + (k,))
            elif k == "kernel":
                out[k] = fn(v, path + (k,))
            else:
                out[k] = v
        return out

    return walk(params, ())


def _map_scope(params: Params, scope: str | None, fn) -> Params:
    """``_map_kernels`` over one top-level subtree (the rest is shared, not
    copied), or over the whole tree."""
    if scope is not None and scope in params:
        out = dict(params)
        out[scope] = _map_kernels(params[scope], lambda w, p: fn(w, (scope,) + p))
        return out
    return _map_kernels(params, fn)


def _quant_args_for(path: tuple[str, ...]) -> dict:
    """Kernel-layout metadata by tree position: ``o_proj`` kernels contract
    two axes ([N, H, D], dense_general axis=(-2, -1)), everything else one;
    kernels under a ``layers`` node are per-layer stacked."""
    return {"n_in": 2 if "o_proj" in path else 1, "stacked": "layers" in path}


def _row_group(path: tuple[str, ...], model_group):
    """``model_group`` for a row-parallel kernel (``o_proj``, ``wo``: K is
    sharded over the model axis), None for every other kernel."""
    return model_group if ("o_proj" in path or "wo" in path) else None


def quantize_params_int8(params: Params) -> Params:
    """Fake-quantize every dense kernel (int8 precision, original dtype)."""
    return _map_kernels(params, lambda w, path: dequantize(
        quantize_int8(w, **_quant_args_for(path)), dtype=w.dtype))


def fake_quant_ste(w: torch.Tensor, fq: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: the forward sees ``fq``, the backward sees
    ``w`` (round() has zero gradient almost everywhere, so
    d(loss)/d(w) := d(loss)/d(fq))."""
    return w + (fq.to(w.dtype) - w).detach()


def fake_quant_params_ste(params: Params, mode: str, scope: str | None = "decoder",
                          group: int | None = 128, model_group=None) -> Params:
    """Quantization-aware-training view of the params: every dense kernel
    inside ``scope`` is replaced by its fake-quantized value behind a
    straight-through estimator.  The values are those of
    ``quantize_params_int8_packed`` / ``quantize_params_int4_packed`` on the
    same weights (the same per-column / per-group grids, recomputed from the
    live weights every step).  ``mode``: ``int8`` | ``int4`` (grouped,
    ``group`` rows per scale) | ``int4_hybrid`` (int4 MLP kernels, int8
    elsewhere).  ``scope`` defaults to ``decoder``, the serving quantizers'
    scope.  ``model_group``: ``params`` are a rank's local shards under a
    mesh (whole along the data axis), quantized as the packers quantize them
    there: a row-parallel kernel's per-column scales span every rank's slice
    of K, group scales stay within a rank's slice."""
    if mode not in ("int8", "int4", "int4_hybrid"):
        raise ValueError(f"Unknown QAT mode: {mode!r}")

    def fq(w, path):
        a = _quant_args_for(path)
        with torch.no_grad():
            rows = _row_group(path, model_group)
            if mode == "int4" or (mode == "int4_hybrid" and "mlp" in path):
                deq = dequantize4(quantize_int4(w, group=group, model_group=rows, **a),
                                  dtype=w.dtype)
            else:
                deq = dequantize(quantize_int8(w, model_group=rows, **a), dtype=w.dtype)
        return fake_quant_ste(w, deq)

    return _map_scope(params, scope, fq)


def quantize_params_int8_packed(params: Params, scope: str | None = "decoder",
                                fused: bool = False, fused_mlp_int4: bool = False,
                                mlp_tiles: int = 4, model_group=None) -> Params:
    """Pack dense kernels as ``QuantizedKernel``s (int8 + scales).

    ``scope`` limits packing to one top-level subtree — default ``"decoder"``:
    the decode loop streams the decoder's weights every step, the encoder
    runs once per call as a large matrix product.  ``scope=None`` packs the
    whole tree.  Kernels already packed (the int4-MLP hybrid) and
    block-sparse kernels (``ops/sparse.py``) are kept.

    ``fused`` also builds ``params["decoder"]["fused_pack"]``
    (``ops/kernels/fused_step.py``) from the float weights before they are
    packed, and the decode loop then runs the fused whole-decoder-step kernel;
    ``fused_mlp_int4`` stores its MLP matrices nibble-int4, paired within
    ``mlp_tiles`` K-tiles for wm (the JAX package's ``DIA_FUSED_INT4`` and
    ``DIA_FUSED_MT``).  The JAX packer builds the pack by default and uses it
    only under ``DIA_FUSED=1``; here asking for the pack is the opt-in, so the
    default costs no memory beside the packed tree.  A decoder whose kernels
    are not all float tensors (block-sparse after pruning, or already packed)
    gets no pack: the pack is quantized from float weights with the norm
    gains folded in, which such kernels no longer hold (the JAX packer's
    ``except`` at :209 skips the same trees).

    ``model_group``: ``params`` are a rank's local shards under a mesh
    (module docstring); ``fused`` then raises, the fused step having no
    tensor-parallel form."""
    if fused and model_group is not None:
        raise NotImplementedError("the fused-step pack has no tensor-parallel form")

    def pk(w, path):
        if isinstance(w, PACKED_TYPES) or _is_block_sparse(w):
            return w
        return quantize_int8(w, **_quant_args_for(path), model_group=_row_group(path, model_group))

    pack = None
    if fused and "decoder" in params and all(
            isinstance(w, torch.Tensor) for _, w in _decoder_layer_kernels(params)):
        from .kernels.fused_step import repack_decoder_fused

        pack = repack_decoder_fused(params, mlp_int4=fused_mlp_int4, mlp_tiles=mlp_tiles)
    out = _map_scope(params, scope, pk)
    if pack is not None:
        out["decoder"] = dict(out["decoder"], fused_pack=pack)
    return out


def _decoder_layer_kernels(params: Params):
    """(path, kernel) of every dense kernel in the decoder's layers."""
    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from walk(v, path + (k,))
            elif k == "kernel":
                yield path, v

    return walk(params["decoder"]["layers"], ())


def _pack_nibble_rows(q: torch.Tensor) -> torch.Tensor:
    """int8 rows in [-7, 7] ``[K, N]`` → bytes ``[K//2, N]``, row parity."""
    return _pack(q[0::2], q[1::2])


def _pack_nibble_rows_halfsplit(q: torch.Tensor) -> torch.Tensor:
    """int8 rows in [-7, 7] ``[K, N]`` → bytes ``[K//2, N]``, pairing row k
    (low nibble) with row k + K/2 (high)."""
    K = q.shape[-2]
    return _pack(q[: K // 2], q[K // 2:])


def _pack(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    # in int32: (hi << 4) | (lo & 15) lies in [-112, 127], so the narrowing is exact
    return ((hi.to(torch.int32) << 4) | (lo.to(torch.int32) & 0x0F)).to(torch.int8)


def _int4_format(K: int, group: int | None, halfsplit: bool) -> tuple[bool, int | None, bool]:
    """(nibble, group, halfsplit) of an int4 pack over K rows, asked for
    ``group`` and ``halfsplit`` (``quantize_int4``'s fallbacks)."""
    nibble = K % 2 == 0
    if group is not None:
        group = min(group, K)
        if K % group or (nibble and group % 2):
            group = None
    if halfsplit and not (nibble and (group is None or (K // 2) % group == 0)):
        halfsplit = False
    return nibble, group, halfsplit


def quantize_int4(
    w: torch.Tensor, n_in: int = 1, stacked: bool = False, group: int | None = 128,
    nibble: bool = True, halfsplit: bool = False, model_group=None,
) -> Quantized4Kernel:
    """Symmetric int4: q = round(w / s) in [-7, 7].

    ``group`` rows of the contracted K axis share one scale per output column
    (``None``: one scale per column).  An indivisible or odd group falls back
    to per-column scales.  ``halfsplit`` pairs contraction halves per byte
    instead of adjacent rows; it falls back to row parity when
    ``(K/2) % group != 0``.  An odd K cannot be paired at all and is stored
    one value per byte (``nibble=False`` on the result).

    ``nibble=False`` as an argument is refused: in the JAX package it selects
    XLA's 4-bit dtype, and PyTorch has no int4 tensor to store it in.

    ``model_group``: ``w`` is a rank's slice of K (a row-parallel kernel
    under a mesh).  The format is the whole kernel's; a slice that cannot
    hold it (groups that do not tile it, halves that do not) raises.
    Per-column maxima are taken over every rank's slice."""
    if not nibble:
        raise ValueError("quantize_int4: nibble=False selects XLA's 4-bit dtype, which PyTorch "
                         "does not have; int4 values are stored as nibble bytes only")
    in_shape, out_shape = _split_shape(w, n_in, stacked)
    K, N = math.prod(in_shape), math.prod(out_shape)
    shards = _k_shards(model_group)
    nibble, group, halfsplit = fmt = _int4_format(K * shards, group, halfsplit)
    if shards > 1 and _int4_format(K, group, halfsplit) != fmt:
        raise ValueError(
            f"quantize_int4: the whole kernel (K = {K * shards}) packs as (nibble, group, "
            f"halfsplit) = {fmt}, which a rank's slice of K = {K} cannot hold; pick a group "
            f"that K/{shards} and K/{2 * shards} are multiples of")
    pack = _pack_nibble_rows_halfsplit if halfsplit else _pack_nibble_rows

    def one(w1):
        wg = w1.float().reshape(K, N) if group is None else w1.float().reshape(K // group, group, N)
        amax = wg.abs().amax(dim=-2, keepdim=True)
        if group is None:  # a column's maximum spans every rank's slice of K
            amax = _max_over(amax, model_group)
        scale = amax.clamp_min(1e-12) / 7.0
        q = torch.round(wg / scale).clamp(-7, 7).to(torch.int8).reshape(K, N)
        return (pack(q) if nibble else q), scale.squeeze(-2)

    values, scale = _per_layer(one, w, stacked)
    return Quantized4Kernel(values, scale, in_shape, out_shape, group, nibble, halfsplit)


def unpack_nibble_rows(b: torch.Tensor, halfsplit: bool = False) -> torch.Tensor:
    """Bytes ``[*, K//2, N]`` → int8 rows ``[*, K, N]`` (sign-extended)."""
    b32 = b.to(torch.int32)
    lo = ((b32 << 28) >> 28).to(torch.int8)
    hi = (b32 >> 4).to(torch.int8)
    if halfsplit:
        return torch.cat([lo, hi], dim=-2)
    return torch.stack([lo, hi], dim=-2).reshape(*b.shape[:-2], 2 * b.shape[-2], b.shape[-1])


def dequantize4(qk: Quantized4Kernel, dtype=torch.float32) -> torch.Tensor:
    """Reconstruct the kernel at its logical shape."""
    v = (unpack_nibble_rows(qk.values, qk.halfsplit) if qk.nibble else qk.values).float()
    lead, (K, N) = v.shape[:-2], v.shape[-2:]
    if qk.group is None:
        w2 = v * qk.scale.reshape(*lead, 1, N)
    else:
        vg = v.reshape(*lead, K // qk.group, qk.group, N)
        w2 = (vg * qk.scale.reshape(*lead, K // qk.group, 1, N)).reshape(*lead, K, N)
    return w2.reshape(*lead, *qk.in_shape, *qk.out_shape).to(dtype)


def quantize_params_int4_packed(
    params: Params, scope: str | None = "decoder", group: int | None = 128,
    mlp_only: bool = False, halfsplit: bool = False, model_group=None,
) -> Params:
    """Pack dense kernels as ``Quantized4Kernel``s (int4 + grouped scales),
    scoped as ``quantize_params_int8_packed``.  ``mlp_only`` packs only the
    MLP kernels (wi_fused/wo) and leaves the rest for the caller; compose
    with the int8 packer for the hybrid:
    ``quantize_params_int8_packed(quantize_params_int4_packed(p, mlp_only=True))``.
    Block-sparse kernels are kept, as the int8 packer keeps them.
    ``model_group`` as in ``quantize_params_int8_packed``."""

    def pk(w, path):
        if (mlp_only and "mlp" not in path) or _is_block_sparse(w):
            return w
        return quantize_int4(w, group=group, halfsplit=halfsplit, **_quant_args_for(path),
                             model_group=_row_group(path, model_group))

    return _map_scope(params, scope, pk)


def quantization_error(params: Params) -> float:
    """Max relative RMS error introduced by int8 quantization (diagnostics)."""
    worst = 0.0

    def visit(w, path):
        nonlocal worst
        w32 = w.detach().float().cpu()
        deq = dequantize(quantize_int8(w32))
        rms = float(np.sqrt(((w32 - deq) ** 2).mean().item())
                    / (np.sqrt((w32 ** 2).mean().item()) + 1e-12))
        worst = max(worst, rms)
        return w

    _map_kernels(params, visit)
    return worst
