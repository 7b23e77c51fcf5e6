"""What the per-layer metrics read: the decode step's device time and its
share of the chip's peaks, and a kernel's share of its roofline.
Each metric file (``metrics/<metric>.py``) calls one of these with the
cell's context; each returns None where its source saw nothing.
"""

from __future__ import annotations

import counts


def _route(ctx) -> counts.Route:
    if ctx.config["route"].get("fused"):
        return counts.Route(weights="fused", kv_int8=True)
    return counts.Route(weights="bf16", kv_int8=False)


def _steps(calls: list) -> int:
    return sum(c["replays"] * c["graph_steps"] + c["step_replays"] for c in calls)


def step_device_ms(ctx) -> float | None:
    """Device ms a replayed decode step over the window's calls."""
    calls = ctx.window.layer.get("calls") or []
    steps = _steps(calls)
    if steps <= 0:
        return None
    return 1e3 * sum(c["replay_device_seconds"] for c in calls) / steps


def step_mfu(ctx) -> float | None:
    """Percent: the least time of the window's needed steps (each call's
    steps 1..n exactly) over the device time of the steps replayed."""
    calls = ctx.window.layer.get("calls") or []
    device = sum(c["replay_device_seconds"] for c in calls)
    if device <= 0:
        return None
    d, route = counts.Dims.of(ctx.config["dia"]), _route(ctx)
    least = 0.0
    for c in calls:
        flops, nbytes = counts.solo_call_work(d, route, int(c["decode_steps"]), int(c["cross_len"]))
        least += counts.least_seconds(flops, nbytes)
    return 100.0 * least / device


def dense_rows_roofline(ctx) -> float | None:
    """Percent: the byte bound of the traced ``dense_rows`` launches (a
    stream's 2 rows) over their device time.  The step's products run in a
    fixed order, so n launches hold n / 145 of each product's shape."""
    s = ctx.summary
    if s is None:
        return None
    launches = s.kernels("dense_rows")
    if not launches:
        return None
    prods = counts.decoder_products(counts.Dims.of(ctx.config["dia"]))
    per_launch = sum(counts.dense_rows_bytes(2, K, N) for K, N in prods) / len(prods)
    least = len(launches) * per_launch / counts.PEAKS["hbm_bytes_per_s"]
    return 100.0 * least / (sum(n for _, n in launches) / 1e9)


def fused_roofline(ctx) -> float | None:
    """Percent: the fused step kernel's launches in the traced request, each
    against its own least time, over their device time."""
    s, call = ctx.summary, ctx.window.layer.get("traced_call")
    if s is None or call is None:
        return None
    launches = s.kernels("fused_step")
    if not launches:
        return None
    d = counts.Dims.of(ctx.config["dia"])
    prods = counts.decoder_products(d)[:-1]  # the head runs outside the fused kernel
    pack = sum(K * N + 4 * N for K, N in prods)
    n = int(call["decode_steps"])
    slot, key = counts.kv_slot_bytes(d, True), counts.cross_key_bytes(d, True)
    cross = int(call["cross_len"])
    prod_flops = sum(counts.product_flops(2, K, N) for K, N in prods)
    least = 0.0
    for i in range(len(launches)):
        t = min(i + 1, n)  # step t reads t - 1 cached slots a row, writes one, on both rows
        nbytes = pack + 2 * t * slot + cross * key + 2 * 2 * d.D * 4  # x in and out, fp32
        least += counts.least_seconds(prod_flops + counts.attention_flops(d, 2 * t, cross),
                                      nbytes)
    return 100.0 * least / (sum(length for _, length in launches) / 1e9)
