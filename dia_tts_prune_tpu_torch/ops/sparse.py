"""Block-sparse dense kernels for pruned inference (counterpart of
``dia_tts_prune_tpu/ops/sparse.py``).

A block-pruned kernel is stored as a ``BlockSparseKernel``: its values
flattened to 2-D ``[K, N]`` (``[L, K, N]`` stacked per layer), pruned blocks
kept as zeros, plus the compressed nonzero-block structure — per output tile
of ``block_n`` columns, the list of its nonzero K-blocks of ``block_k`` rows.
``ops.modules.dense_general`` sends such a kernel to the block-sparse matmul
(``ops/kernels/sparse_matmul.py``), which reads only the listed blocks: the
decode loop's weight bytes, its bound, scale with block density.

Build with ``sparsify_params_block`` after ``prune.block_masks`` +
``prune.apply_masks`` (block-granular pruning guarantees whole-block zeros;
element-level masks rarely give any).  The plans equal the JAX package's:
``indices`` and ``counts`` of the same weight are the same integers.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from .quant import _map_scope, _quant_args_for

Params = dict[str, Any]


class BlockSparseKernel:
    """Block-pruned dense kernel: 2-D values + compressed block structure.

    values: ``[K, N]`` (``[L, K, N]`` stacked) in the compute dtype, pruned
    blocks stored as zeros.  indices: int32 ``[nn, max_blocks]``
    (``[L, nn, max_blocks]``) nonzero K-block ids per N-tile, padded by
    repeating the last real id.  counts: int32 ``[nn]`` (``[L, nn]``).
    Indexing (``kernel[i]``) takes layer ``i`` of a stacked kernel."""

    __slots__ = ("values", "indices", "counts", "block_k", "block_n", "in_shape", "out_shape")

    def __init__(self, values, indices, counts, block_k, block_n, in_shape, out_shape):
        self.values = values
        self.indices = indices
        self.counts = counts
        self.block_k = int(block_k)
        self.block_n = int(block_n)
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)

    def _with(self, values, indices, counts) -> "BlockSparseKernel":
        return BlockSparseKernel(values, indices, counts, self.block_k, self.block_n,
                                 self.in_shape, self.out_shape)

    def __getitem__(self, i) -> "BlockSparseKernel":
        return self._with(self.values[i], self.indices[i], self.counts[i])

    def to(self, device) -> "BlockSparseKernel":
        return self._with(self.values.to(device), self.indices.to(device),
                          self.counts.to(device))

    def __repr__(self):
        return (f"BlockSparseKernel(values={tuple(self.values.shape)}, "
                f"block=({self.block_k},{self.block_n}), in_shape={self.in_shape}, "
                f"out_shape={self.out_shape})")

    @property
    def density(self) -> float:
        """Fraction of weight blocks the kernel actually reads."""
        counts = self.counts.detach().cpu().numpy().astype(np.float64)
        nk = -(-math.prod(self.in_shape) // self.block_k)
        return float(counts.sum() / (counts.size * nk))


def _plan_one(w2: torch.Tensor, block_k: int, block_n: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-block structure of one [K, N] weight: (nonzero [nk, nn] bool,
    counts int32 [nn]).  The map is reduced where the weight lies; only the
    small block map comes to the host."""
    K, N = w2.shape
    nk, nn = -(-K // block_k), -(-N // block_n)
    padded = torch.zeros(nk * block_k, nn * block_n, dtype=torch.bool, device=w2.device)
    padded[:K, :N] = w2 != 0
    nonzero = padded.reshape(nk, block_k, nn, block_n).any(dim=3).any(dim=1).cpu().numpy()
    return nonzero, nonzero.sum(axis=0).astype(np.int32)


def _pack_indices(nonzero: np.ndarray, counts: np.ndarray, max_blocks: int) -> np.ndarray:
    """[nk, nn] block map → [nn, max_blocks] index lists, padded with the
    last real id (the kernel never reads a slot past its tile's count)."""
    nk, nn = nonzero.shape
    indices = np.zeros((nn, max_blocks), np.int32)
    for j in range(nn):
        ids = np.nonzero(nonzero[:, j])[0]
        indices[j, : len(ids)] = ids
        if len(ids):
            indices[j, len(ids):] = ids[-1]
    return indices


def sparse_kernel_from_weight(w: torch.Tensor, n_in: int, stacked: bool, block_k: int = 256,
                              block_n: int = 256) -> BlockSparseKernel:
    """Pack one (possibly layer-stacked) pruned kernel.  A stacked kernel's
    per-layer plans are padded to a shared ``max_blocks``, so that every
    layer's slice has one shape."""
    lead = tuple(w.shape[:1]) if stacked else ()
    in_shape = tuple(w.shape[len(lead): len(lead) + n_in])
    out_shape = tuple(w.shape[len(lead) + n_in:])
    K, N = math.prod(in_shape), math.prod(out_shape)
    values = w.reshape(*lead, K, N)
    plans = [_plan_one(w2, block_k, block_n) for w2 in values.reshape(-1, K, N)]
    max_blocks = max(1, max(int(c.max(initial=0)) for _, c in plans))
    indices = np.stack([_pack_indices(nz, c, max_blocks) for nz, c in plans])
    counts = np.stack([c for _, c in plans])
    if not lead:
        indices, counts = indices[0], counts[0]
    return BlockSparseKernel(
        values=values, indices=torch.from_numpy(indices).to(w.device),
        counts=torch.from_numpy(counts).to(w.device), block_k=block_k, block_n=block_n,
        in_shape=in_shape, out_shape=out_shape)


def sparsify_params_block(params: Params, scope: str | None = "decoder", block_k: int = 256,
                          block_n: int = 256) -> Params:
    """Swap (already block-pruned) dense kernels for ``BlockSparseKernel``s.

    ``scope`` defaults to the decoder — the decode loop re-reads its weights
    every token, so that is where skipped blocks save bytes; the encoder runs
    once per call.  ``scope=None`` packs the whole tree.  Usage::

        masks = prune.block_masks(params, amount=0.5, block=(256, 256))
        sparse = sparsify_params_block(prune.apply_masks(params, masks))
    """

    def pack(w, path):
        if isinstance(w, BlockSparseKernel):
            return w
        return sparse_kernel_from_weight(w, block_k=block_k, block_n=block_n,
                                         **_quant_args_for(path))

    return _map_scope(params, scope, pack)


def sparsity_summary(params: Params) -> dict[str, float]:
    """Block density of every ``BlockSparseKernel`` in a tree, by dotted path
    (``decoder.layers.mlp.wo.kernel``)."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            elif isinstance(v, BlockSparseKernel):
                out[".".join(path + (k,))] = v.density

    walk(params, ())
    return out
