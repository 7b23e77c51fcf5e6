"""The yardstick: operations and bytes of a decode step and of its kernels,
from the configuration's shapes, and the chip's published peaks.

Bytes count each input read once and each output written once, whatever a
kernel reads again; operations are the products' multiply-adds (two each)
and the attention's.  ``peaks.json`` holds the published H100 peaks.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


@dataclass(frozen=True)
class Dims:
    """The decoder's widths as a step uses them."""

    L: int  # decoder layers
    D: int  # model width
    F: int  # MLP hidden width
    Nq: int  # self-attention query heads
    Nkv: int  # self-attention K/V heads
    H: int  # head size
    Ncq: int  # cross-attention heads
    C: int  # codebook channels
    V: int  # vocabulary a channel

    @classmethod
    def of(cls, model: dict) -> "Dims":
        m, d = model["model"], model["data"]
        dec = m["decoder"]
        return cls(L=dec["n_layer"], D=dec["n_embd"], F=dec["n_hidden"],
                   Nq=dec["gqa_query_heads"], Nkv=dec["kv_heads"], H=dec["gqa_head_dim"],
                   Ncq=dec["cross_query_heads"], C=d["channels"], V=m["tgt_vocab_size"])


def decoder_products(d: Dims) -> list[tuple[int, int]]:
    """(K, N) of the 8 L + 1 products of an unfused decode step, in order:
    q, k, v, o, cross q, cross o, gate/up, down a layer, then the logits head."""
    layer = [(d.D, d.Nq * d.H), (d.D, d.Nkv * d.H), (d.D, d.Nkv * d.H), (d.Nq * d.H, d.D),
             (d.D, d.Ncq * d.H), (d.Ncq * d.H, d.D), (d.D, 2 * d.F), (d.F, d.D)]
    return layer * d.L + [(d.D, d.C * d.V)]


def dense_rows_bytes(M: int, K: int, N: int) -> int:
    """A bf16 ``dense_rows`` call: the weight, x and the bf16 output."""
    return 2 * K * N + 2 * M * K + 2 * M * N


def product_flops(M: int, K: int, N: int) -> int:
    return 2 * M * K * N


def kv_slot_bytes(d: Dims, kv_int8: bool) -> int:
    """Bytes of one cache slot of one row over every layer, K and V: int8
    values with an fp32 scale a head, or bf16 values."""
    per_head = d.H + 4 if kv_int8 else 2 * d.H
    return d.L * 2 * d.Nkv * per_head


def cross_key_bytes(d: Dims, kv_int8: bool) -> int:
    """Bytes of one text key of one row over every layer, K and V."""
    per_head = d.H + 4 if kv_int8 else 2 * d.H
    return d.L * 2 * d.Ncq * per_head


def attention_flops(d: Dims, self_len: int, cross_len: int) -> int:
    """One row's attention over every layer: QK and PV of each query head."""
    return d.L * 4 * d.H * (d.Nq * self_len + d.Ncq * cross_len)


@dataclass(frozen=True)
class Route:
    """What a step streams: ``weights`` ``bf16`` (the float route) or
    ``fused`` (the fused step's int8 pack plus the int8 logits head); int8
    or bf16 caches."""

    weights: str
    kv_int8: bool


def step_weight_bytes(d: Dims, route: Route) -> int:
    """The weight bytes a step reads once: every decoder product (values
    and scales), the norms' scales, and the embedding rows are counted
    with the rows (``step_work``)."""
    prods = decoder_products(d)
    if route.weights == "bf16":
        w = sum(2 * K * N for K, N in prods)
    else:  # the fused pack: int8 values + an fp32 scale a column of the same matrices
        w = sum(K * N + 4 * N for K, N in prods)
    norms = (3 * d.L + 1) * d.D * 2
    return w + norms


def step_work(d: Dims, route: Route, rows: int, self_slots: float, cross_keys: float) -> tuple:
    """(operations, bytes) of one decode step of ``rows`` rows whose self
    attention reads ``self_slots`` cache slots in all (summed over the rows)
    and whose cross attention reads ``cross_keys`` text keys in all: the
    weights once, each row's embeddings, activations in and out of every
    product, the caches read, this step's K/V written, the fp32 logits."""
    prods = decoder_products(d)
    flops = sum(product_flops(rows, K, N) for K, N in prods)
    flops += attention_flops(d, self_slots, cross_keys)
    act = 2 if route.weights != "fused" else 0  # the fused step keeps its activations on chip
    b = step_weight_bytes(d, route)
    b += rows * d.C * d.D * 2  # embedding rows
    b += act * sum(rows * (K + N) for K, N in prods[:-1])
    b += rows * d.D * 2 + rows * d.C * d.V * 4  # the head's x and fp32 logits
    b += self_slots * kv_slot_bytes(d, route.kv_int8)
    b += cross_keys * cross_key_bytes(d, route.kv_int8)
    b += rows * kv_slot_bytes(d, route.kv_int8)  # this step's K/V written
    return flops, b


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 tensor-core peak and bytes over the memory's peak.  Every
    product of every route multiplies in bf16 (the int8 kernels widen their
    weights to bf16 before the tensor cores), so the int8 peak never
    applies."""
    return max(flops / PEAKS["bf16_flops_per_s"], nbytes / PEAKS["hbm_bytes_per_s"])


def solo_call_work(d: Dims, route: Route, steps: int, cross_len: int) -> tuple:
    """(operations, bytes) of the needed steps of one stream's call: step t
    (1-based) attends t self slots on both CFG rows, the conditional row
    ``cross_len`` text keys, the unconditional row none."""
    flops = nbytes = 0.0
    for t in range(1, steps + 1):
        f, b = step_work(d, route, 2, 2 * t, cross_len)
        flops += f
        nbytes += b
    return flops, nbytes
