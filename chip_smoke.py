#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dia_tts_prune_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card).  Naming phases (``python3 chip_smoke.py kernels training``) runs the
build and only those, for work on one of them, and prints no result line.  Phases, each printing one JSON line; any failure raises and the
script exits non-zero:

1. build     — compile every CUDA kernel from ``dia_tts_prune_tpu_torch/csrc``
               and the planted-fault copies of the fused step (one nvcc per
               source, all at once), and report the registers and spills of
               the flash, block-sparse, decode-attention and bf16 int8-matmul
               kernels (``nvcc -Xptxas -v``);
2. kernels   — each kernel against its plain PyTorch version at the main
               paths' shapes, fp32 and bf16: max abs error beside the stated
               tolerance, kernel and library times (device time: calls
               replayed from a CUDA graph), the plain version's time and the
               kernel's eager time (events around Python calls), the least
               time the card could take, launches.  The attention
               kernels (float and int8 caches), the int8-matmul (B = 2, 8,
               64; bf16 calls one kernel each, by the profiler) and int4-GEMV
               (B = 2, 64) kernels at the five weight shapes of a decode step
               and a few odd ones (one with an unaligned weight), and the
               three training kernels (flash forward with log-sum-exp,
               dK/dV, dQ) at the three attention
               shapes of a Dia-1.6B training step and odd ones (ragged
               lengths, head dims 32/64, segment ids t % 3 that no tile
               skip may drop), dK/dV and dQ bit-identical over two runs, each
               flash record with its route (``mma_bf16`` tensor cores or
               ``fma_fp32`` CUDA cores), whether P enters as hi + lo bf16
               pairs and the share of tiles skipped; the block-sparse matmul at the
               five decode shapes at block density 0.5 (per-module 256 x 256
               ranking) and 1.0, fp32, 8, 64 and 512 rows, each record with
               its route and plan, NaN in every unlisted block, bit-identical
               runs, rows independent of M (2, 8, 16 against 64; 2 against a
               512-row product whose blocks each run every slice);
               the fused decode step at Dia-1.6B widths (int8 and int4-MLP
               packs, bf16 and int8 caches, B = 2 and 8, and 20), rows of
               B = 20 equal to B = 2 and 8 runs, NaN where nothing may be
               read, the plain version's own spread (host against card, 2
               rows against 8) and four planted faults, built from edited
               copies of the source, each of which the gate must reject;
3. fixtures  — the trained fixtures through ``Dia.from_pretrained(...,
               device="cuda")`` in fp32: greedy tokens equal ``golden.npz``,
               waveform length and head as recorded; then packed int8 and
               int4: teacher-forced logits on the card (kernels) against the
               CPU (plain versions) on the same packed bytes;
               ``prune_block_sparse(0.5, (32, 64))`` (both fixtures),
               ``shrink_heads`` / ``shrink_ffn`` (``trained_small``): greedy
               tokens on the card equal the CPU's; two batched streams with
               voice prompts of different lengths equal their
               single-stream runs; ``quantize_int8(fused=True)`` (int8 and
               int4 MLP): teacher-forced fused steps card vs CPU, greedy
               tokens equal up to a near tie, and a greedy run on the card
               driven by the CPU's logits, the card's logits held to them
               at every step; then a few
               full, LoRA and QAT-int8 optimizer steps on ``trained_small``,
               the loss after each step on the card against the CPU run;
4. full_width — Dia-1.6B shapes in bf16 and the 44.1 kHz DAC with weights
               from a numpy seed, three paths, each with the launch counts
               zeroed just before and read just after: (a) float weights — a
               greedy and a seeded-sampled ``generate`` and a voice-prompted
               ``generate_codes`` (the causal-flash prefill); (b)
               ``quantize_int8()`` then a greedy ``generate`` (int8 weights,
               int8 KV caches); (c) a fresh model, ``quantize_int4()``, a
               greedy ``generate``; (d) ``pruned``: a fresh model, per-module
               block ranking at 0.5 (and the global ranking's densities,
               reported), ``sparsify_block``, a greedy ``generate``; (e)
               ``batched``: four greedy streams on it against their
               single-stream runs; (f) ``prune_cli``: ``offline_prune
               --prune-mode block`` at 2 + 2 layers, ``from_pretrained``,
               ``sparsify_block``, generate; (g) ``fused_int8``,
               ``fused_int4``, ``fused_batched`` (four streams): one fused
               launch and no decode-attention launch per step.  Every kernel
               of a path must have launched, the GEMV and block-sparse
               kernels once per contraction of every step;
5. training  — teacher-forced fine-tuning at the same full width (bf16
               compute, ``audio_length`` 3072, batch 2, every layer
               rematerialized): three LoRA steps, two full fine-tune steps
               (fp32 master weights and AdamW moments), one QAT-int8 step,
               each step under the profiler (loss, gradient norm, wall and
               device time, device time by kind of kernel) with the three
               launch counts exactly layers x attention sites x 2 for the
               forward and x 1 for each backward kernel; then the
               ``finetune`` CLI end to end at two layers per stack on a
               three-item dataset the script synthesizes (generate -> WAV ->
               metadata.csv), and ``Dia.from_pretrained`` of its output
               generates.

Then a ``kernels`` line, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
CUDA is unavailable or the package is not beside this file.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # fp32 CUDA cores; bf16 dense tensor cores
# Kernel vs plain version, |out - ref| <= atol + rtol * |ref|.  The reference is
# the plain version in fp32 on the same input values (bf16 inputs widened
# exactly), so the only differences are fp32 summation order (measured <= 7.5e-7
# on the card) and, for bf16, the kernel's one rounding of its fp32 result to
# bf16: at most half an ulp, i.e. <= 2^-8 of the value.  A dropped or
# mis-weighted 128-slot chunk moves outputs of size ~0.05 by far more.
TOL = {"float32": {"rtol": 0.0, "atol": 1e-5}, "bfloat16": {"rtol": 2.0 ** -8, "atol": 1e-5}}
# The GEMV kernels sum K <= 8192 fp32 products per output in another order than
# the plain version's matmul, so their rounding error scales with the sum of the
# products' magnitudes, not with the output: |out - ref| <= GEMV_SUM_TOL *
# (|x| @ |w|) + rtol * |ref|, rtol as in TOL (the one rounding to bf16).  1e-6 is
# ~17 fp32 ulps of that sum (measured on the card: at most 0.2e-6 of it); one
# dropped row or a wrong group scale is off by ~1e-2 of it.
GEMV_SUM_TOL = 1e-6
# Packed fixtures, card (kernels) against CPU (plain versions) on the same bytes,
# as a share of the largest |logit|: with float KV caches only fp32 summation
# order differs; with int8 caches a K/V value on a rounding boundary may take the
# neighbouring code on one side (one step of 1/127 of its head row's range).
PACKED_LOGIT_TOL = {"kv_float": 1e-4, "kv_int8": 1e-2}
# Gradients of the flash backward kernels against the plain version in fp32 on the
# same values (the forward kernel's own out and lse included): a gradient element
# sums up to 3072 fp32 products in another order, so fp32 differs by summation
# order only (atol 1e-4 on gradients of size ~1, the JAX package's own limit for its
# backward kernels) and bf16 also by the one rounding of the fp32 result to bf16.
GRAD_TOL = {"float32": {"rtol": 1e-5, "atol": 1e-4}, "bfloat16": {"rtol": 2.0 ** -8, "atol": 1e-4}}
LSE_ATOL = 2e-5  # log-sum-exp rows, fp32 in both dtypes: summation order
# Optimizer steps on a fixture, card against CPU, fp32: the loss of step i depends on
# every earlier AdamW update, which is lr * g / (|g| + 1e-8) at first, so gradient
# elements within fp32 noise of zero move their weights differently on the two
# devices; fake-quant adds weights that round to the neighbouring code on one side.
TRAIN_LOSS_RTOL = {"full": 2e-4, "lora": 2e-4, "qat_int8": 2e-3}
COLD_BYTES = 128 << 20  # a timing loop cycles through copies of the weight larger than the L2
DECODER_GEMVS = 145  # packed contractions of one Dia-1.6B decode step: 8 * 18 + the logits head
WAV_TOL = 1e-4  # cuDNN fp32 convs sum in another order than XLA's (the CPU test's cause)


PHASES = ("kernels", "fixtures", "full_width", "training")  # after the build, in this order


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, iters: int = 48, replays: int = 5) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured into a CUDA graph
    and replayed, so the calls run back to back on the card with no host
    between them.  Events around eager calls (``cuda_ms``) measure the rate at
    which Python can enqueue instead, wherever a call's device time is below
    the ~10-30 us its launch costs the host."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def check(torch, what, dtype, out, plain, args) -> dict:
    """Hold a kernel's output against ``plain(*args)`` in fp32 (``TOL``);
    also read the plain version run in the kernel's own dtype, which rounds
    its softmax weights to bf16 as the model's reference does."""
    ref = plain(*(a.float() if a.is_floating_point() else a for a in args)).float()
    diff = (out.float() - ref).abs()
    tol = TOL[dtype]
    excess = (diff - tol["rtol"] * ref.abs()).max().item()
    rec = {"max_abs_err": diff.max().item(), "tol": tol, "max_err_less_rtol": excess,
           "max_abs_err_vs_plain_in_dtype": (out.float() - plain(*args).float()).abs().max().item()}
    if not excess <= tol["atol"]:
        raise RuntimeError(f"{what} {dtype}: kernel disagrees with its plain version: {rec}")
    return rec


def core_route(dtype: str) -> str:
    """The flash and block-sparse kernels run bf16 on the tensor cores
    (``mma.sync``), fp32 on the CUDA cores (true fp32 FMAs)."""
    return "mma_bf16" if dtype == "bfloat16" else "fma_fp32"


def flash_tiles(torch, route, q_seg, kv_seg, causal) -> dict:
    """A flash kernel's route, whether its fp32 P (and dS) enter the MMAs as
    hi + lo bf16 pairs, and the share of its (query tile, key tile) pairs that
    it skips whole: 64 x 64 tiles by ``tile_visits`` on the tensor-core route,
    32 x 32 tiles above the causal diagonal on the CUDA cores."""
    from dia_tts_prune_tpu_torch.ops.kernels import tile_visits

    if route == "mma_bf16":
        skipped = 1.0 - tile_visits(q_seg, kv_seg, causal).float().mean().item()
    elif causal:
        n_q, n_k = -(-q_seg.shape[1] // 32), -(-kv_seg.shape[1] // 32)
        skipped = 1.0 - torch.ones(n_q, n_k).tril().mean().item()
    else:
        skipped = 0.0
    return {"route": route, "p_split": route == "mma_bf16", "tiles_skipped": skipped}


# registers and spills reported
PTXAS_SOURCES = ("flash_attention", "flash_attention_bwd", "block_sparse_matmul",
                 "decode_attention", "int8_matmul")


def ptxas_report(log: str) -> dict:
    """{kernel<args>: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output: the flash kernels by head dim, the bf16
    block-sparse kernel by tile (rows x columns), load width and slice map,
    the decode kernel at head dim 128 by q and cache type and query heads held,
    the bf16 int8-matmul kernel by n-tiles of 8 rows and weight copy width."""
    import re

    report, name = {}, None
    entry = re.compile(r"Function properties for \S*?\d(flash_[a-z_]+?_kernel)I(\w*?)Li(\d+)E")
    bsm = re.compile(r"Function properties for \S*?bsm_mma_kernelI\w*?CfgI" + r"Li(\d+)E" * 6
                     + r"EELi(\d+)ELb([01])E")
    dec = re.compile(r"Function properties for \S*?decode_attention_kernelI(\w*?)Li128ELi(\d)E")
    i8 = re.compile(r"Function properties for \S*?int8_matmul_mma_kernelILi(\d+)ELi(\d+)ELb([01])E")
    types = {"13__nv_bfloat16S1_": "bf16, bf16", "13__nv_bfloat16a": "bf16, int8",
             "ff": "float, float", "fa": "float, int8"}
    for line in log.splitlines():
        if m := i8.search(line):
            name = (f"int8_matmul_mma_kernel<{m.group(1)} n-tiles, copies of {m.group(2)} B, "
                    f"{'conversion unit' if m.group(3) == '1' else 'ALU'}>")
            report[name] = {}
        elif m := dec.search(line):
            name = f"decode_attention_kernel<{types.get(m.group(1), m.group(1))}, 128, G {m.group(2)}>"
            report[name] = {}
        elif m := entry.search(line):
            kind = {"f": "float, ", "13__nv_bfloat16": "bf16, "}.get(m.group(2), "")
            name = f"{m.group(1)}<{kind}{m.group(3)}>"
            report[name] = {}
        elif m := bsm.search(line):
            wr, wc, tm, tn, _, _, vec, fused = (int(g) for g in m.groups())
            name = f"bsm_mma_kernel<{wr * tm * 16}x{wc * tn * 8}, vec {vec}, fused {fused}>"
            report[name] = {}
        elif name and (m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            report[name]["registers"] = int(m.group(1))
            name = None
    return report


def phase_build() -> dict:
    """Every kernel, and the planted-fault copies of the fused step (``FUSED_FAULTS``),
    one nvcc each, all at once; returns {fault: library path}."""
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    faults_dir = _build.BUILD_DIR / "faults"
    faults_dir.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC_DIR / "fused_step.cu").read_text()
    running = {}
    for name, (old, new) in FUSED_FAULTS.items():
        if source.count(old) != 1:
            raise RuntimeError(f"fault {name}: its line is not in fused_step.cu once")
        src, lib = faults_dir / f"{name}.cu", faults_dir / f"lib{name}.so"
        src.write_text(source.replace(old, new))
        running[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                                           str(src)], stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT), lib)
    flags = [f for f in _build.NVCC_FLAGS if f != "-shared"]
    verbose = {name: subprocess.Popen(
        [_build.nvcc_path(), *flags, "-Xptxas", "-v", "-cubin", "-o",
         str(faults_dir / f"{name}.cubin"), str(_build.CSRC_DIR / f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for name in PTXAS_SOURCES}
    libs = _build.build_all()
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"fault {name}: nvcc failed\n{log.decode(errors='replace')}")
    ptxas = {}
    for name, proc in verbose.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc -Xptxas -v failed\n{log.decode(errors='replace')}")
        ptxas.update(ptxas_report(log.decode(errors="replace")))
    emit({"phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 3),
          "nvcc": _build.nvcc_path(), "libs": libs, "planted_faults": sorted(running),
          "ptxas": ptxas})
    return {name: lib for name, (_, lib) in running.items()}


def flash_case(torch, name, dtype, B, T, Nq, Nkv, H, causal, real_len):
    import torch.nn.functional as F

    from dia_tts_prune_tpu_torch.ops.kernels import flash_attention, flash_attention_plain

    g = torch.Generator(device="cuda").manual_seed(1)
    dt = getattr(torch, dtype)
    q = torch.randn(B, T, Nq, H, generator=g, device="cuda").to(dt)
    k = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    v = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    seg = (torch.arange(T, device="cuda")[None] < torch.tensor(real_len, device="cuda")[:, None])
    seg = seg.to(torch.int32).contiguous()
    before = flash_attention.launches
    out = flash_attention(q, k, v, seg, seg, causal)
    launches = flash_attention.launches - before
    errs = check(torch, f"flash_attention {name}", dtype, out,
                 lambda *a: flash_attention_plain(*a, causal), (q, k, v, seg, seg))
    kernel_ms = graph_ms(torch, lambda: flash_attention(q, k, v, seg, seg, causal), iters=8)
    eager_ms = cuda_ms(torch, lambda: flash_attention(q, k, v, seg, seg, causal))
    plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, seg, seg, causal), iters=5)
    mask = seg[:, :, None] == seg[:, None, :]
    if causal:
        mask &= torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    pairs = mask.sum().item()
    qh, kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // x.shape[2], dim=1) for x in (q, k, v))
    library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask[:, None]), iters=8)
    e = q.element_size()
    nbytes = e * (2 * B * T * Nq * H + 2 * B * T * Nkv * H) + 4 * 2 * B * T
    bound_ms, bound_by = bound(nbytes, 4.0 * H * Nq * pairs, dtype)
    rec = {"phase": "kernels", "kernel": "flash_attention", "case": name, "dtype": dtype,
           "shape": {"B": B, "T": T, "Nq": Nq, "Nkv": Nkv, "H": H, "causal": causal,
                     "real_len": real_len},
           **flash_tiles(torch, core_route(dtype), seg, seg, causal),
           **errs, "ms": kernel_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launches}
    emit(rec)
    return rec


def flash_train_case(torch, name_, dtype, B, Tq, Tk, Nq, Nkv, H, causal, q_real, kv_real,
                     time_it=True, interleaved=False):
    """The three training kernels at one attention site: forward with LSE
    against ``flash_attention_lse_plain``, dK/dV and dQ against
    ``flash_attention_bwd_plain`` on the kernel forward's own out and lse.
    ``q_real`` / ``kv_real``: real lengths per batch row (None = all real);
    ``interleaved``: ids t % 3 instead, every id in every tile, so that no tile
    may be skipped by its segment range; query row 5 of batch row 0 is fully
    masked.  Returns one record per kernel."""
    import torch.nn.functional as F

    from dia_tts_prune_tpu_torch.ops.kernels import (
        flash_attention_bwd_kv, flash_attention_bwd_plain, flash_attention_bwd_q,
        flash_attention_lse, flash_attention_lse_plain)

    g = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    q, k, v, dout = (torch.randn(*s, generator=g, device="cuda").to(dt) for s in (
        (B, Tq, Nq, H), (B, Tk, Nkv, H), (B, Tk, Nkv, H), (B, Tq, Nq, H)))

    def seg_of(T, real):
        if interleaved:
            return (torch.arange(T, device="cuda") % 3).to(torch.int32)[None].repeat(B, 1)
        if real is None:
            return torch.ones(B, T, dtype=torch.int32, device="cuda")
        return (torch.arange(T, device="cuda")[None]
                < torch.tensor(real, device="cuda")[:, None]).to(torch.int32).contiguous()

    q_seg, kv_seg = seg_of(Tq, q_real), seg_of(Tk, kv_real)
    q_seg[0, 5] = 7  # matches no key: a fully masked row
    wide = lambda *a: tuple(x.float() if x.is_floating_point() else x for x in a)  # noqa: E731

    counts = lambda: (flash_attention_lse.launches, flash_attention_bwd_kv.launches,  # noqa: E731
                      flash_attention_bwd_q.launches)
    n0 = counts()
    out, lse = flash_attention_lse(q, k, v, q_seg, kv_seg, causal)
    dd = (dout.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, causal, dd)
    dq = flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, causal, dd)
    launches = [b - a for a, b in zip(n0, counts())]
    dk2, dv2 = flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, causal, dd)
    dq2 = flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, causal, dd)
    torch.cuda.synchronize()
    repeatable = bool(torch.equal(dk, dk2) and torch.equal(dv, dv2))
    repeatable_q = bool(torch.equal(dq, dq2))

    ref_out, ref_lse = flash_attention_lse_plain(*wide(q, k, v), q_seg, kv_seg, causal)
    ref_dq, ref_dk, ref_dv = flash_attention_bwd_plain(
        *wide(q, k, v), q_seg, kv_seg, out.float(), lse, dout.float(), causal)

    def err(got, ref, tol):
        diff = (got.float() - ref).abs()
        return {"max_abs_err": diff.max().item(), "tol": tol,
                "max_err_less_rtol": (diff - tol["rtol"] * ref.abs()).max().item()}

    errs = {"flash_attention_lse": err(out, ref_out, TOL[dtype]),
            "flash_attention_bwd_kv": max((err(dk, ref_dk, GRAD_TOL[dtype]),
                                           err(dv, ref_dv, GRAD_TOL[dtype])),
                                          key=lambda e: e["max_err_less_rtol"]),
            "flash_attention_bwd_q": err(dq, ref_dq, GRAD_TOL[dtype])}
    errs["flash_attention_lse"]["lse_max_abs_err"] = (lse - ref_lse).abs().max().item()
    errs["flash_attention_bwd_kv"]["bit_identical_over_two_runs"] = repeatable
    errs["flash_attention_bwd_q"]["bit_identical_over_two_runs"] = repeatable_q
    masked_ok = bool((out[0, 5] == 0).all() and (dq[0, 5] == 0).all())
    del ref_out, ref_lse, ref_dq, ref_dk, ref_dv, dk2, dv2, dq2

    mask = q_seg[:, :, None] == kv_seg[:, None, :]
    if causal:
        mask &= torch.ones(Tq, Tk, dtype=torch.bool, device="cuda").tril()
    pairs = mask.sum().item()
    e = q.element_size()
    seg_bytes = 4 * B * (Tq + Tk)
    stat_bytes = 4 * B * Nq * Tq  # one fp32 row statistic [B, Nq, Tq]
    qo, kv = e * B * Tq * Nq * H, e * B * Tk * Nkv * H
    # per kernel: (bytes in + out, tile products it needs: each is 2 * H * Nq * pairs flops)
    work = {"flash_attention_lse": (2 * qo + 2 * kv + seg_bytes + stat_bytes, 2),
            "flash_attention_bwd_kv": (2 * qo + 4 * kv + seg_bytes + 2 * stat_bytes, 4),
            "flash_attention_bwd_q": (3 * qo + 2 * kv + seg_bytes + 2 * stat_bytes, 3)}
    calls = {"flash_attention_lse": lambda: flash_attention_lse(q, k, v, q_seg, kv_seg, causal),
             "flash_attention_bwd_kv": lambda: flash_attention_bwd_kv(
                 q, k, v, q_seg, kv_seg, out, lse, dout, causal, dd),
             "flash_attention_bwd_q": lambda: flash_attention_bwd_q(
                 q, k, v, q_seg, kv_seg, out, lse, dout, causal, dd)}
    times = {name: {} for name in calls}
    if time_it:
        for name, fn in calls.items():
            times[name]["ms"] = graph_ms(torch, fn, iters=4)
        times["flash_attention_lse"]["plain_ms"] = cuda_ms(
            torch, lambda: flash_attention_lse_plain(q, k, v, q_seg, kv_seg, causal),
            iters=2, warmup=1)
        bwd_plain = cuda_ms(torch, lambda: flash_attention_bwd_plain(
            q, k, v, q_seg, kv_seg, out, lse, dout, causal), iters=2, warmup=1)
        # the library call: SDPA forward, and its whole backward (dq, dk and dv in one call)
        qh, kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // x.shape[2], dim=1)
                      .detach().requires_grad_(True) for x in (q, k, v))
        doh = dout.transpose(1, 2)
        sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh, attn_mask=mask[:, None])  # noqa: E731
        with torch.no_grad():
            lib_fwd = graph_ms(torch, sdpa, iters=4)
        lib_both = graph_ms(torch, lambda: torch.autograd.grad(sdpa(), (qh, kh, vh), doh),
                            iters=4)
        times["flash_attention_lse"]["library_ms"] = lib_fwd
        for name in ("flash_attention_bwd_kv", "flash_attention_bwd_q"):
            times[name].update({"plain_ms": bwd_plain, "library_ms": lib_both - lib_fwd,
                                "plain_and_library_cover": "dq, dk and dv together"})
    recs = {}
    for name, launched in zip(calls, launches):
        nbytes, products = work[name]
        bound_ms, bound_by = bound(nbytes, products * 2.0 * H * Nq * pairs, dtype)
        rec = {"phase": "kernels", "kernel": name, "case": name_, "dtype": dtype,
               "shape": {"B": B, "Tq": Tq, "Tk": Tk, "Nq": Nq, "Nkv": Nkv, "H": H,
                         "causal": causal, "q_real": q_real, "kv_real": kv_real,
                         "ids": "t % 3" if interleaved else "prefix"},
               **flash_tiles(torch, core_route(dtype), q_seg, kv_seg, causal),
               **errs[name], "fully_masked_row_exact_zero": masked_ok, **times[name],
               "bound_ms": bound_ms, "bound_by": bound_by, "tile_products": products,
               "launches": launched}
        emit(rec)
        if not rec["max_err_less_rtol"] <= rec["tol"]["atol"]:
            raise RuntimeError(f"{name} {name_} {dtype}: kernel disagrees with its plain "
                               f"version: {rec}")
        recs[name] = rec
    if not (errs["flash_attention_lse"]["lse_max_abs_err"] <= LSE_ATOL and repeatable
            and repeatable_q and masked_ok and launches == [1, 1, 1]):
        raise RuntimeError(f"training flash kernels {name_} {dtype}: lse, repeatability, the "
                           f"masked row or the launch counts are off: {recs}")
    return recs


def decode_bits(torch, name, dtype, args, out, launches) -> dict:
    """The decode kernel's bit-level gates: one launch per call, the same bits
    on a second run, and every pair of rows (2b, 2b + 1) of a batch of more
    than two equal to the same rows called as a batch of two."""
    from dia_tts_prune_tpu_torch.ops.kernels import decode_attention
    from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import DESIGN

    repeatable = torch.equal(decode_attention(*args), out)
    B = out.shape[0]
    pairs_equal = None
    if B > 2:
        pairs_equal = all(torch.equal(
            decode_attention(*(a[i:i + 2].contiguous() for a in args)), out[i:i + 2])
            for i in range(0, B - 1, 2))
    rec = {"launches_per_call": launches, "design": DESIGN, "repeatable": repeatable,
           "rows_equal_batch_of_2": pairs_equal}
    if launches != 1 or not repeatable or pairs_equal is False:
        raise RuntimeError(f"decode_attention {name} {dtype}: launches, repeatability or rows "
                           f"against a batch of two are off: {rec}")
    return rec


def decode_case(torch, name, dtype, B, T, Nq, Nkv, H, ends, starts=None):
    import torch.nn.functional as F

    from dia_tts_prune_tpu_torch.ops.kernels import decode_attention, decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Nq, H, generator=g, device="cuda").to(dt)
    k = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    v = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    starts = [0] * B if starts is None else starts
    start = torch.tensor(starts, dtype=torch.int32, device="cuda")
    end = torch.tensor(ends, dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    out = decode_attention(q, k, v, start, end)
    launches = decode_attention.launches - before
    errs = check(torch, f"decode_attention {name}", dtype, out, decode_attention_plain,
                 (q, k, v, start, end))
    for b, e_b in enumerate(ends):
        if e_b <= starts[b] and not bool((out[b] == 0).all()):
            raise RuntimeError(f"decode_attention {name} {dtype}: empty row {b} is not exactly 0")
    bits = decode_bits(torch, name, dtype, (q, k, v, start, end), out, launches)
    kernel_ms = graph_ms(torch, lambda: decode_attention(q, k, v, start, end))
    eager_ms = cuda_ms(torch, lambda: decode_attention(q, k, v, start, end), iters=100)
    plain_ms = cuda_ms(torch, lambda: decode_attention_plain(q, k, v, start, end))
    slots = torch.arange(T, device="cuda")
    mask = (slots[None] >= start[:, None]) & (slots[None] < end[:, None])
    qh = q[:, :, None]
    kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // Nkv, dim=1) for x in (k, v))
    library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask[:, None, None]))
    valid = sum(max(e_b - s_b, 0) for s_b, e_b in zip(starts, ends))
    e = q.element_size()
    nbytes = e * (2 * B * Nq * H + 2 * valid * Nkv * H) + 4 * 2 * B
    bound_ms, bound_by = bound(nbytes, 4.0 * H * Nq * valid, dtype)
    rec = {"phase": "kernels", "kernel": "decode_attention", "case": name, "dtype": dtype,
           "shape": {"B": B, "T": T, "Nq": Nq, "Nkv": Nkv, "H": H, "ends": list(ends),
                     **({"starts": list(starts)} if any(starts) else {})},
           **errs, **bits, "ms": kernel_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launches}
    emit(rec)
    return rec


def decode_int8_case(torch, name, dtype, B, T, Nq, Nkv, H, ends, with_new):
    """The decode kernel over an int8 cache with slot scales; ``with_new``
    adds the step's own unquantized K/V (the self-attention form)."""
    import torch.nn.functional as F

    from dia_tts_prune_tpu_torch.models.dia import quantize_kv
    from dia_tts_prune_tpu_torch.ops.kernels import decode_attention, decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(3)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Nq, H, generator=g, device="cuda").to(dt)
    k8, ks = quantize_kv(torch.randn(B, T, Nkv, H, generator=g, device="cuda"))
    v8, vs = quantize_kv(torch.randn(B, T, Nkv, H, generator=g, device="cuda"))
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    end = torch.tensor(ends, dtype=torch.int32, device="cuda")
    args = [q, k8, v8, start, end, ks, vs]
    if with_new:
        args += [torch.randn(B, Nkv, H, generator=g, device="cuda").to(dt) for _ in range(2)]
    before = decode_attention.launches
    out = decode_attention(*args)
    launches = decode_attention.launches - before
    errs = check(torch, f"decode_attention {name}", dtype, out, decode_attention_plain, args)
    for b, e_b in enumerate(ends):
        if e_b == 0 and not with_new and not bool((out[b] == 0).all()):
            raise RuntimeError(f"decode_attention {name} {dtype}: end=0 row {b} is not exactly 0")
    bits = decode_bits(torch, name, dtype, args, out, launches)
    kernel_ms = graph_ms(torch, lambda: decode_attention(*args))
    eager_ms = cuda_ms(torch, lambda: decode_attention(*args), iters=100)
    plain_ms = cuda_ms(torch, lambda: decode_attention_plain(*args))
    # the library call: SDPA over the dequantized cache, the new token in slot end[b]
    kd, vd = (k8.float() * ks[..., None]).to(dt), (v8.float() * vs[..., None]).to(dt)
    lib_end = end.clone()
    if with_new:
        rows = torch.arange(B, device="cuda")
        kd[rows, end.long()], vd[rows, end.long()] = args[7], args[8]
        lib_end += 1
    slots = torch.arange(T, device="cuda")
    mask = slots[None] < lib_end[:, None]
    kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // Nkv, dim=1) for x in (kd, vd))
    library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        q[:, :, None], kh, vh, attn_mask=mask[:, None, None]))
    valid = sum(ends)
    e = q.element_size()
    nbytes = (e * 2 * B * Nq * H + 2 * valid * Nkv * (H + 4) + 4 * 2 * B
              + (e * 2 * B * Nkv * H if with_new else 0))
    bound_ms, bound_by = bound(nbytes, 4.0 * H * Nq * (valid + (B if with_new else 0)), dtype)
    rec = {"phase": "kernels", "kernel": "decode_attention", "case": name, "dtype": dtype,
           "cache": "int8", "current_token": with_new,
           "shape": {"B": B, "T": T, "Nq": Nq, "Nkv": Nkv, "H": H, "ends": list(ends)},
           **errs, **bits, "ms": kernel_ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launches}
    emit(rec)
    return rec


def kernels_per_call(torch, fn) -> int:
    """CUDA kernels that one ``fn()`` runs, by ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages() if ev.device_type == DeviceType.CUDA)


def gemv_case(torch, kernel, dtype, B, K, N, group=None, layout=None, time_it=True, offset=0):
    """``int8_matmul`` (layout None) or ``int4_gemv`` on a weight packed from
    seed-made floats, against its plain version; times over copies of the
    weight that together exceed the L2, as a decode step finds them cold.
    ``offset`` > 0 (int8): the weight starts that many bytes into its storage,
    so its address is not 16-byte aligned."""
    from dia_tts_prune_tpu_torch.ops import quant
    from dia_tts_prune_tpu_torch.ops.kernels import KERNEL_WRAPPERS
    from dia_tts_prune_tpu_torch.ops.kernels import int4_gemv_plain, int8_matmul_plain

    g = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, dtype)
    w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
    x = torch.randn(B, K, generator=g, device="cuda").to(dt)
    if kernel == "int8_matmul":
        qk = quant.quantize_int8(w)
        scale, extra, plain, deq = qk.scale.reshape(N), (), int8_matmul_plain, quant.dequantize(qk)
    else:
        qk = quant.quantize_int4(w, group=group, halfsplit=layout == "halfsplit")
        if qk.layout != layout or qk.group != group:
            raise RuntimeError(f"packer gave {qk.layout}/{qk.group} for {layout}/{group} at K={K}")
        scale, extra, plain, deq = qk.scale, (layout,), int4_gemv_plain, quant.dequantize4(qk)
    if offset:
        values = torch.empty(K * N + offset, dtype=torch.int8, device="cuda")[offset:].view(K, N)
        values.copy_(qk.values)
        qk = quant.QuantizedKernel(values, qk.scale, qk.in_shape, qk.out_shape)
    fn = KERNEL_WRAPPERS[kernel]
    before = fn.launches
    out = fn(x, qk.values, scale, *extra)
    launches = fn.launches - before
    torch.cuda.synchronize()
    ref = plain(x.float(), qk.values, scale, *extra)
    diff = (out.float() - ref).abs()
    sum_abs = x.float().abs() @ deq.abs()
    tol = GEMV_SUM_TOL * sum_abs + TOL[dtype]["rtol"] * ref.abs()
    rec = {"phase": "kernels", "kernel": kernel, "dtype": dtype,
           "shape": {"B": B, "K": K, "N": N, "group": group, "layout": layout},
           "max_abs_err": diff.max().item(), "max_err_over_tol": (diff / tol).max().item(),
           "tol": {"sum_abs": GEMV_SUM_TOL, "rtol": TOL[dtype]["rtol"]}, "launches": launches}
    if not rec["max_err_over_tol"] <= 1.0:
        raise RuntimeError(f"{kernel}: kernel disagrees with its plain version: {rec}")
    if kernel == "int8_matmul":
        import importlib

        i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
        rec["weight_offset"] = offset
        if dtype == "bfloat16":  # one cluster launch, no finish pass
            rec["route"] = "mma_bf16"
            rec["plan"] = {"copy_bytes": i8.copy_width(N, qk.values.data_ptr()),
                           "cluster_slice": list(i8.cluster_plan(K, N))}
            rec["kernels_per_call"] = kernels_per_call(torch, lambda: fn(x, qk.values, scale))
            if rec["kernels_per_call"] != 1:
                raise RuntimeError(f"int8_matmul bf16: {rec['kernels_per_call']} kernels a call")
        else:
            vec = i8.vector_width(N, qk.values.data_ptr())
            rec["route"] = "fma_fp32"
            rec["plan"] = {"vec": vec, "n_split": i8.split_plan(K, N, vec)}
    nbytes = (qk.values.numel() + 4 * scale.numel() + x.element_size() * (B * K + B * N))
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * B * K * N, dtype)
    if time_it:
        n = max(2, min(64, -(-COLD_BYTES // qk.values.numel())))
        vals = [qk.values.clone() for _ in range(n)]
        wlib = [deq.to(dt) for _ in range(max(2, n // 2 if dt == torch.bfloat16 else n // 4))]
        turn = iter(range(1 << 30))
        rec["ms"] = graph_ms(torch, lambda: fn(x, vals[next(turn) % n], scale, *extra), iters=2 * n)
        rec["eager_ms"] = cuda_ms(torch, lambda: fn(x, vals[next(turn) % n], scale, *extra),
                                  iters=max(32, 2 * n))
        rec["plain_ms"] = cuda_ms(
            torch, lambda: plain(x, vals[next(turn) % n], scale, *extra), iters=4, warmup=1)
        rec["library_ms"] = graph_ms(
            torch, lambda: torch.matmul(x, wlib[next(turn) % len(wlib)]), iters=4 * len(wlib))
        rec["weight_copies"] = n
    emit(rec)
    return rec


# the packed weights one Dia-1.6B decode step contracts against (K, N)
GEMV_SHAPES = {"attn_2048x2048": (2048, 2048), "self_kv_2048x512": (2048, 512),
               "mlp_wi_2048x16384": (2048, 16384), "mlp_wo_8192x2048": (8192, 2048),
               "logits_2048x9252": (2048, 9252)}
INT4_FORMS = [(128, "halfsplit"), (None, "halfsplit"), (128, "parity"), (None, "parity")]


SPARSE_BLOCK = (256, 256)  # the offline CLI's and Dia.prune_block_sparse's default blocks


def sparse_weight(torch, K, N, density, dtype, seed=6):
    """A [K, N] weight from a seed, pruned by the per-module block ranking to
    ``density`` of its 256 x 256 blocks (1.0: unpruned), packed with its plan."""
    from dia_tts_prune_tpu_torch.ops.sparse import sparse_kernel_from_weight
    from dia_tts_prune_tpu_torch.prune import apply_masks, block_masks

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = (torch.randn(K, N, generator=g, device="cuda") / K ** 0.5).to(dtype)
    if density < 1.0:
        tree = {"w": {"kernel": w}}
        w = apply_masks(tree, block_masks(tree, 1.0 - density, SPARSE_BLOCK,
                                          scope="module"))["w"]["kernel"]
    return sparse_kernel_from_weight(w, 1, False, *SPARSE_BLOCK)


def listed_elements(torch, sk) -> int:
    """Weight entries in the listed blocks of a (possibly stacked)
    BlockSparseKernel: what the kernel must read."""
    from dia_tts_prune_tpu_torch.ops.kernels.sparse_matmul import listed_mask

    K, N = sk.values.shape[-2:]
    idx = sk.indices.reshape(-1, *sk.indices.shape[-2:])
    cnt = sk.counts.reshape(-1, sk.counts.shape[-1])
    return sum(int(listed_mask(i, c, K, N, sk.block_k, sk.block_n).sum()) for i, c in zip(idx, cnt))


def sparse_plan(torch, x, sk) -> dict:
    """The wrapper's plan for ``x @ sk``: the route, and in bf16 the tile
    (rows x columns), whether each block runs every slice, the load width
    and the slices."""
    from dia_tts_prune_tpu_torch.ops.kernels import sparse_matmul as tsm

    dtype = str(x.dtype).removeprefix("torch.")
    plan = {"route": core_route(dtype)}
    if dtype == "bfloat16":
        (M, K), N = x.shape, sk.values.shape[1]
        vec = tsm.vector_width(x.dtype, K, N, *SPARSE_BLOCK, x.data_ptr(), sk.values.data_ptr())
        n_split = tsm.bf16_split(N, *SPARSE_BLOCK, sk.indices.shape[-1])
        tile, fused = tsm.mma_plan(M, N, SPARSE_BLOCK[1], vec, n_split)
        plan.update(tile="%dx%d" % tsm.MMA_TILES[tile], every_slice_in_one_block=fused, vec=vec,
                    slices=n_split)
    return plan


def sparse_case(torch, dtype, M, K, N, density, time_it=True, poison=False):
    """``block_sparse_matmul`` against its plain version (fp32, same values),
    within the GEMV tolerance; bit-identical over two runs; with ``poison``
    NaN in every unlisted block must change nothing.  Times over copies of
    the weight that together exceed the L2, as a decode step finds them cold;
    the library time is cuBLAS on the zero-filled values (the same function,
    reading every block)."""
    from dia_tts_prune_tpu_torch.ops.kernels import block_sparse_matmul, block_sparse_matmul_plain
    from dia_tts_prune_tpu_torch.ops.kernels.sparse_matmul import listed_mask

    dt = getattr(torch, dtype)
    sk = sparse_weight(torch, K, N, density, dt)
    x = torch.randn(M, K, generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda").to(dt)
    plan = (sk.indices, sk.counts, *SPARSE_BLOCK)
    before = block_sparse_matmul.launches
    out = block_sparse_matmul(x, sk.values, *plan)
    launches = block_sparse_matmul.launches - before
    again = block_sparse_matmul(x, sk.values, *plan)
    torch.cuda.synchronize()
    listed = listed_mask(*plan[:2], K, N, *SPARSE_BLOCK)
    ref = block_sparse_matmul_plain(x.float(), sk.values.float(), *plan)
    diff = (out.float() - ref).abs()
    sum_abs = x.float().abs() @ torch.where(listed, sk.values.float().abs(), 0.0)
    tol = GEMV_SUM_TOL * sum_abs + TOL[dtype]["rtol"] * ref.abs()
    rec = {"phase": "kernels", "kernel": "block_sparse_matmul", "dtype": dtype,
           "shape": {"M": M, "K": K, "N": N, "block": list(SPARSE_BLOCK)},
           **sparse_plan(torch, x, sk), "density": sk.density, "max_abs_err": diff.max().item(),
           "max_err_over_tol": torch.where(diff > 0, diff / tol, 0.0).max().item(),
           "tol": {"sum_abs": GEMV_SUM_TOL, "rtol": TOL[dtype]["rtol"]},
           "bit_identical_over_two_runs": bool(torch.equal(out, again)), "launches": launches,
           "empty_tiles": int((sk.counts == 0).sum())}
    ok = rec["max_err_over_tol"] <= 1.0 and rec["bit_identical_over_two_runs"] and launches == 1
    if poison:
        poisoned = torch.where(listed, sk.values, float("nan"))
        p_out = block_sparse_matmul(x, poisoned, *plan)
        rec["poison_finite"] = bool(torch.isfinite(p_out).all())
        rec["poison_equals_clean"] = bool(torch.equal(p_out, out))
        ok = ok and rec["poison_finite"] and rec["poison_equals_clean"]
        del poisoned, p_out
    n_listed = int(listed.sum())
    e = x.element_size()
    nbytes = e * (n_listed + M * K + M * N) + 4 * (sk.indices.numel() + sk.counts.numel())
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * M * n_listed, dtype)
    rec["listed_weight_bytes"] = e * n_listed
    if time_it:
        n = max(2, min(64, -(-COLD_BYTES // (e * K * N))))
        vals = [sk.values.clone() for _ in range(n)]
        turn = iter(range(1 << 30))
        rec["ms"] = graph_ms(torch, lambda: block_sparse_matmul(x, vals[next(turn) % n], *plan),
                             iters=2 * n)
        rec["eager_ms"] = cuda_ms(torch, lambda: block_sparse_matmul(
            x, vals[next(turn) % n], *plan), iters=max(32, 2 * n))
        rec["plain_ms"] = cuda_ms(torch, lambda: block_sparse_matmul_plain(
            x, vals[next(turn) % n], *plan), iters=4, warmup=1)
        rec["library_ms"] = graph_ms(torch, lambda: torch.matmul(x, vals[next(turn) % n]),
                                     iters=2 * n)
        rec["weight_copies"] = n
        del vals
    emit(rec)
    if not ok:
        raise RuntimeError(f"block_sparse_matmul: kernel disagrees with its plain version, "
                           f"is not repeatable, or reads an unlisted block: {rec}")
    return rec


def sparse_rows_case(torch) -> None:
    """Each row of a 64-row product equals the same row computed 2, 8 and 16
    rows at a time, and each row of a 512-row product at the MLP input
    projection (bf16: 128-row tiles whose blocks run every slice) its 2-row
    result: the slices never depend on the row count, and no tile shape
    changes a row's sum."""
    from dia_tts_prune_tpu_torch.ops.kernels import block_sparse_matmul

    for dtype in ("float32", "bfloat16"):
        for M, N, parts in ((64, 2048, (2, 8, 16)), (512, 16384, (2,))):
            sk = sparse_weight(torch, 2048, N, 0.5, getattr(torch, dtype))
            x = torch.randn(M, 2048, generator=torch.Generator(device="cuda").manual_seed(8),
                            device="cuda").to(sk.values.dtype)
            plan = (sk.indices, sk.counts, *SPARSE_BLOCK)
            full = block_sparse_matmul(x, sk.values, *plan)
            same = {m: all(torch.equal(block_sparse_matmul(x[r:r + m].contiguous(), sk.values,
                                                           *plan), full[r:r + m])
                           for r in range(0, M, m)) for m in parts}
            emit({"phase": "kernels", "kernel": "block_sparse_matmul", "dtype": dtype,
                  "case": "rows independent of M", "shape": {"M": M, "K": 2048, "N": N},
                  "plan": sparse_plan(torch, x, sk),
                  "plans_of_parts": {m: sparse_plan(torch, x[:m], sk) for m in parts},
                  "rows_equal_at_M": same})
            if not all(same.values()):
                raise RuntimeError(f"block_sparse_matmul {dtype}: a row depends on the row count")


def phase_sparse_kernels(torch) -> dict:
    """The block-sparse matmul at the five decode shapes (B = 2, bf16) at
    density 0.5 and 1.0, fp32, B = 8 and 64, a prefill-sized product, the
    poison cases and the row-count check; returns the record of the MLP input
    projection at 0.5 for the kernels line."""
    for name, (K, N) in GEMV_SHAPES.items():
        for density in (0.5, 1.0):
            rec = sparse_case(torch, "bfloat16", 2, K, N, density)
            if name == "mlp_wi_2048x16384" and density == 0.5:
                picked = rec
    sparse_case(torch, "float32", 2, 2048, 2048, 0.5)
    for M in (8, 64, 512):  # 512: a prompt prefill's rows on the MLP input projection
        sparse_case(torch, "bfloat16", M, 2048, 16384, 0.5)
    for dtype in ("float32", "bfloat16"):
        sparse_case(torch, dtype, 3, 2048, 9252, 0.5, time_it=False, poison=True)
    sparse_rows_case(torch)
    return picked


# Fused decode step, kernel against plain version: |out - ref| <= FUSED_TOL *
# (max |ref| + |ref|), the JAX package's kernel gate (rtol = atol = 2e-2) with
# atol taken relative to the output's size (the JAX test's outputs are O(1)).
# Both round xn, sa, ca and h (and the RoPE partner) to bf16 before their
# dots, so fp32 sums taken in another order put some values on the other side
# of a bf16 step, and 18 layers carry those flips on: the plain version run on
# the host, or on fewer rows, is as far from itself (``fused_spread_case``).
# ``fused_fault_cases`` plants faults in the kernel that the gate must reject.
FUSED_TOL = 2e-2
# One-line edits of csrc/fused_step.cu, each built beside the real kernel: the
# last K slice of every GEMV left out of its sum; o_proj reading 64 of its
# 2048 K rows fewer (half a head); the last 32-slot chunk of every attention
# left out of the combine; the int4 MLP's low- and high-nibble scales swapped.
FUSED_FAULTS = {
    "k_slice_dropped": (
        "for (int s = 0; s < nsl; ++s) v += __ldcg(part + s * stride + off);",
        "for (int s = 0; s < nsl - 1; ++s) v += __ldcg(part + s * stride + off);"),
    "o_proj_64_rows_short": (
        "make_job(p, 1, l, NqH, D, 0, D)", "make_job(p, 1, l, NqH - 64, D, 0, D)"),
    "attention_chunk_dropped": (
        "for (int k = 0; k < nch; ++k) {\n        const float f",
        "for (int k = 0; k < nch - 1; ++k) {\n        const float f"),
    "int4_scales_swapped": (
        "j.s[(size_t)(tile * 2) * j.n + col + c] +\n                v2 * j.s[(size_t)(tile * 2 + 1)",
        "j.s[(size_t)(tile * 2 + 1) * j.n + col + c] +\n                v2 * j.s[(size_t)(tile * 2)"),
}
# Fused fixtures, card against CPU: teacher-forced logits within 2e-2 (the JAX
# package's kernel gate) as a share of the
# largest |logit| (the flips above, through 4 or 18 layers and int8 K/V codes),
# and greedy tokens equal, or equal up to the first step whose two picks are a
# near tie: a guided-logit margin below FUSED_NEAR_TIE on the card's logits.
FUSED_LOGIT_TOL = 2e-2
FUSED_NEAR_TIE = 0.1
FUSED_DIMS = dict(L=18, D=2048, F=8192, Nq=16, Nkv=4, Ncq=16, H=128)  # dia_1_6b_config()


def fused_pack(torch, int4, dims=FUSED_DIMS, device="cuda", seed=11):
    """A fused-step pack at the given widths, repacked on the device
    (``repack_decoder_fused``) from decoder weights drawn as ``init_params``
    draws them (normal / sqrt(fan_in), unit norm gains), from a torch seed."""
    from dia_tts_prune_tpu_torch.ops.kernels.fused_step import repack_decoder_fused

    g = torch.Generator(device=device).manual_seed(seed)
    L, D, F, Nq, Nkv, Ncq, H = (dims[k] for k in ("L", "D", "F", "Nq", "Nkv", "Ncq", "H"))

    def dense(*shape, fan_in):
        return {"kernel": torch.randn(L, *shape, generator=g, device=device) / fan_in ** 0.5}

    ones = {"scale": torch.ones(L, D, device=device)}
    params = {"decoder": {"layers": {
        "pre_sa_norm": ones, "pre_ca_norm": ones, "pre_mlp_norm": ones,
        "self_attention": {"q_proj": dense(D, Nq, H, fan_in=D), "k_proj": dense(D, Nkv, H, fan_in=D),
                           "v_proj": dense(D, Nkv, H, fan_in=D),
                           "o_proj": dense(Nq, H, D, fan_in=Nq * H)},
        "cross_attention": {"q_proj": dense(D, Ncq, H, fan_in=D),
                            "o_proj": dense(Ncq, H, D, fan_in=Ncq * H)},
        "mlp": {"wi_fused": dense(D, 2, F, fan_in=D), "wo": dense(F, D, fan_in=F)}}}}
    return repack_decoder_fused(params, mlp_int4=int4)


def fused_inputs(torch, B, kind, dims=FUSED_DIMS, T=1024, S=128, write_slot=512, device="cuda",
                 seed=12):
    """One decode step's inputs: caches of ``kind`` (bfloat16 / int8), CFG row
    pairs (uncond rows first, ``cross_ends == 0``), per-row positions and
    first valid slots when B > 2 (left-padded voice prompts)."""
    from dia_tts_prune_tpu_torch.models.dia import quantize_kv

    g = torch.Generator(device=device).manual_seed(seed)
    L, D, Nkv, Ncq, H = (dims[k] for k in ("L", "D", "Nkv", "Ncq", "H"))

    def r(*shape):
        return torch.randn(*shape, generator=g, device=device)

    caches = [r(L, B, T, Nkv, H), r(L, B, T, Nkv, H), r(L, B, S, Ncq, H), r(L, B, S, Ncq, H)]
    scales = [None] * 4
    if kind == "int8":
        q = [quantize_kv(c) for c in caches]
        caches, scales = [c for c, _ in q], [s for _, s in q]
    else:
        caches = [c.to(getattr(torch, kind)) for c in caches]
    n = B // 2
    off = [0 if B == 2 else (7 * i) % 40 for i in range(n)] * 2
    ends = [0] * n + [S - 67 + (13 * i) % 67 for i in range(n)]
    i32 = dict(dtype=torch.int32, device=device)
    return dict(x_emb=0.02 * r(B, D), position=torch.tensor([write_slot + 1 - o for o in off], **i32),
                write_slot=write_slot, self_k=caches[0], self_v=caches[1], cross_k=caches[2],
                cross_v=caches[3], cross_ends=torch.tensor(ends, **i32),
                valid_from=torch.tensor(off, **i32), self_ks=scales[0], self_vs=scales[1],
                cross_ks=scales[2], cross_vs=scales[3])


def fused_bytes(pack, inp) -> int:
    """Bytes one step must move: the pack's weights and scales, the cache
    slots and text keys each row reads (K and V, with their scales), x in,
    x and this token's K/V out."""
    L, B, T, Nkv, H = inp["self_k"].shape
    Ncq = inp["cross_k"].shape[3]
    per = inp["self_k"].element_size() + (4 / H if inp["self_ks"] is not None else 0)
    slots = sum(max(0, inp["write_slot"] - int(v)) for v in inp["valid_from"])
    keys = int(inp["cross_ends"].sum())
    return int(pack.weight_bytes() + 2 * L * H * per * (slots * Nkv + keys * Ncq)
               + inp["x_emb"].numel() * 4 * 2 + 2 * L * B * Nkv * H * 4)


def fused_gate(out, ref) -> dict:
    """The FUSED_TOL comparison of (x, k, v) against the plain version's:
    each output's max |error| and max |ref|, and ``err_over_tol``, the
    largest |out - ref| / (FUSED_TOL * (max|ref| + |ref|)): the gate passes
    at <= 1."""
    errs, tops, ratio = [], [], 0.0
    for o, r in zip(out, ref):
        o, r = o.float().cpu(), r.float().cpu()
        top = float(r.abs().max())
        errs.append(float((o - r).abs().max()))
        tops.append(top)
        ratio = max(ratio, float(((o - r).abs() / (FUSED_TOL * (top + r.abs()))).max())
                    if bool(o.isfinite().all()) else float("inf"))
    return {"max_abs_err_x_k_v": errs, "max_abs_x_k_v": tops, "err_over_tol": ratio}


def fused_case(torch, int4, kind, B, pack=None, time_it=True) -> dict:
    """The fused step at Dia-1.6B widths against its plain version (FUSED_TOL
    of each output's largest |value|), repeated bit for bit; timed with CUDA
    events around back-to-back launches (a launch is a few ms of device work,
    so the host's enqueue hides behind it)."""
    from dia_tts_prune_tpu_torch.ops.kernels import fused_decode_step, fused_decode_step_plain

    pack = pack if pack is not None else fused_pack(torch, int4)
    inp = fused_inputs(torch, B, kind)
    out = fused_decode_step(pack, **inp)
    again = fused_decode_step(pack, **inp)
    ref = fused_decode_step_plain(pack, **inp)
    torch.cuda.synchronize()
    gate = fused_gate(out, ref)
    rec = {"phase": "kernels", "kernel": "fused_decode_step", "dtype": kind,
           "case": f"{'int4-MLP' if int4 else 'int8'} pack, {kind} caches",
           "shape": {"B": B, **FUSED_DIMS, "T": inp["self_k"].shape[2],
                     "S": inp["cross_k"].shape[2], "write_slot": inp["write_slot"]},
           "max_abs_err": max(gate["max_abs_err_x_k_v"]), **gate,
           "tol": f"{FUSED_TOL} * (max|ref| + |ref|)",
           "repeat_bit_identical": all(torch.equal(a, b) for a, b in zip(out, again))}
    if not rec["repeat_bit_identical"] or not gate["err_over_tol"] <= 1:
        raise RuntimeError(f"fused_decode_step: kernel disagrees with its plain version: {rec}")
    if time_it:
        nbytes = fused_bytes(pack, inp)
        flops = 2 * B * sum(t.numel() * (2 if int4 and i >= 4 else 1)
                            for i, t in enumerate(pack[:14:2]))  # int4: 2 weights a byte
        b_ms, b_by = bound(nbytes, flops, "float32")
        rec.update({"ms": cuda_ms(torch, lambda: fused_decode_step(pack, **inp), iters=20),
                    "timing": "CUDA events around 20 back-to-back launches",
                    "plain_ms": cuda_ms(torch, lambda: fused_decode_step_plain(pack, **inp),
                                        iters=3, warmup=1),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "library_ms": None,
                    "library": "none: no single PyTorch call computes a decoder step"})
    emit(rec)
    return rec


def fused_rows(torch, inp, rows) -> dict:
    """The step inputs of the listed rows only."""
    idx = torch.tensor(rows, device=inp["self_k"].device)
    per_row = ("x_emb", "position", "cross_ends", "valid_from")
    return {k: (v.index_select(0, idx).contiguous() if k in per_row else
                v.index_select(1, idx).contiguous() if isinstance(v, torch.Tensor) else v)
            for k, v in inp.items()}


def fused_rows_and_poison_case(torch, pack, kind) -> None:
    """Rows of a 20-row step (ten streams: two groups of the kernel's 16
    staged rows) equal the same rows run 2 and 8 at a time, bit for bit; NaN
    in every self slot outside [valid_from, write_slot), in the text keys
    past each row's end and in the unconditional rows' whole cross cache
    leaves every output bit-identical (int8 caches: NaN in their scales)."""
    from dia_tts_prune_tpu_torch.ops.kernels import fused_decode_step

    B = 20
    inp = fused_inputs(torch, B, kind, device=pack.wo.device)
    dev = inp["self_k"].device
    full = fused_decode_step(pack, **inp)
    same = True
    for rows in ([0, 10], [9, 19], [5, 16], [0, 1, 2, 3, 10, 11, 12, 13], [4, 6, 8, 9, 14, 16, 17, 19]):
        idx = torch.tensor(rows, device=dev)
        part = fused_decode_step(pack, **fused_rows(torch, inp, rows))
        same &= torch.equal(part[0], full[0][idx]) and all(
            torch.equal(p, f[:, idx]) for p, f in zip(part[1:], full[1:]))
    poisoned = dict(inp)
    T, S = inp["self_k"].shape[2], inp["cross_k"].shape[2]
    slot, key = torch.arange(T, device=dev), torch.arange(S, device=dev)
    names = ("self_ks", "self_vs", "cross_ks", "cross_vs") if kind == "int8" else (
        "self_k", "self_v", "cross_k", "cross_v")
    for n in names:
        t = poisoned[n].clone()
        for b in range(B):
            if n.startswith("self"):
                bad = (slot < int(inp["valid_from"][b])) | (slot >= inp["write_slot"])
            else:
                bad = key >= int(inp["cross_ends"][b])
            t[:, b, bad] = float("nan")
        poisoned[n] = t
    harmless = all(torch.equal(a, b) for a, b in zip(fused_decode_step(pack, **poisoned), full))
    rec = {"phase": "kernels", "kernel": "fused_decode_step", "dtype": kind,
           "case": "rows of B = 20 equal B = 2 and B = 8 runs; NaN where nothing may be read",
           "rows_bit_identical_across_B": bool(same), "nan_poison_harmless": bool(harmless)}
    emit(rec)
    if not (same and harmless):
        raise RuntimeError(f"fused_decode_step: a row depends on the others or reads poison: {rec}")


def fused_spread_case(torch, pack, int4) -> dict:
    """How far the plain version is from itself at B = 8 (bf16 caches): the
    same function and rounding points run on the host (other fp32 summation
    orders) and on the rows two at a time, beside the kernel's distance from
    it, each as ``err_over_tol`` and per row as a share of max |x|."""
    from dia_tts_prune_tpu_torch.ops.kernels import fused_decode_step, fused_decode_step_plain

    inp = fused_inputs(torch, 8, "bfloat16")
    out, ref = fused_decode_step(pack, **inp), fused_decode_step_plain(pack, **inp)
    host = fused_decode_step_plain(pack.to("cpu"), **{
        k: v.cpu() if isinstance(v, torch.Tensor) else v for k, v in inp.items()})
    pairs = [fused_decode_step_plain(pack, **fused_rows(torch, inp, [i, i + 4])) for i in range(4)]
    order = [0, 4, 1, 5, 2, 6, 3, 7]
    paired = [torch.cat([p[0] for p in pairs])[torch.tensor(order).argsort()]]
    paired += [torch.cat([p[j] for p in pairs], dim=1)[:, torch.tensor(order).argsort()]
               for j in (1, 2)]
    top = float(ref[0].abs().max())
    rec = {"phase": "kernels", "kernel": "fused_decode_step", "dtype": "bfloat16",
           "case": f"{'int4-MLP' if int4 else 'int8'} pack, B = 8: the plain version's own spread",
           "kernel_vs_plain": fused_gate(out, ref)["err_over_tol"],
           "plain_host_vs_card": fused_gate(host, ref)["err_over_tol"],
           "plain_2_rows_vs_8_rows": fused_gate(paired, ref)["err_over_tol"],
           "per_row_share_of_max_x": {
               "kernel_vs_plain": [float((out[0][b] - ref[0][b]).abs().max()) / top for b in range(8)],
               "plain_host_vs_card": [float((host[0][b] - ref[0][b].cpu()).abs().max()) / top
                                      for b in range(8)]},
           "valid_from": inp["valid_from"].tolist(), "cross_ends": inp["cross_ends"].tolist()}
    emit(rec)
    return rec


def fused_fault_cases(torch, pack, int4, faults: dict) -> list:
    """Each planted fault (``FUSED_FAULTS``) run through the wrapper at B = 2
    (int8 pack, or the int4 pack for the swapped scales), bf16 caches,
    against the plain version: the gate must reject it.  Returns each
    fault's ``err_over_tol``."""
    from dia_tts_prune_tpu_torch.ops.kernels import _build, fused_decode_step, fused_decode_step_plain
    from dia_tts_prune_tpu_torch.ops.kernels.fused_step import _ARGTYPES

    inp = fused_inputs(torch, 2, "bfloat16")
    ref = fused_decode_step_plain(pack, **inp)
    real = {k: _build._functions.get(k) for k in (("fused_step", "fused_step_fwd"),
                                                   ("fused_step", "fused_step_workspace_bytes"))}
    ratios = []
    for name, lib in faults.items():
        if (name == "int4_scales_swapped") != int4:
            continue
        cdll = ctypes.CDLL(str(lib))
        fwd, size = cdll.fused_step_fwd, cdll.fused_step_workspace_bytes
        fwd.argtypes, size.argtypes = _ARGTYPES, [ctypes.c_int] * 11 + [ctypes.c_void_p]
        fwd.restype = size.restype = ctypes.c_int
        _build._functions[("fused_step", "fused_step_fwd")] = fwd
        _build._functions[("fused_step", "fused_step_workspace_bytes")] = size
        try:
            gate = fused_gate(fused_decode_step(pack, **inp), ref)
        finally:
            for k, fn in real.items():
                _build._functions[k] = fn
        rec = {"phase": "kernels", "kernel": "fused_decode_step", "dtype": "bfloat16",
               "case": f"planted fault {name}", "rejected": gate["err_over_tol"] > 1, **gate}
        emit(rec)
        if not rec["rejected"]:
            raise RuntimeError(f"fused_decode_step: the gate lets a planted fault pass: {rec}")
        ratios.append(gate["err_over_tol"])
    return ratios


def phase_fused_kernels(torch, faults: dict) -> dict:
    """The fused step with int8 and int4-MLP packs, bf16 and int8 caches, at
    B = 2 and B = 8 (and 20 rows for the int8 pack and caches), rows across
    B, NaN poison, the plain version's own spread and the planted faults;
    returns the int8-pack, int8-cache, B = 2 record (the main path's) for the
    kernels line."""
    sound, spread, caught = [], [], []
    for int4 in (False, True):
        pack = fused_pack(torch, int4)
        for kind in ("bfloat16", "int8"):
            for B in (2, 8) if int4 or kind == "bfloat16" else (2, 8, 20):
                rec = fused_case(torch, int4, kind, B, pack)
                sound.append(rec["err_over_tol"])
                if not int4 and kind == "int8" and B == 2:
                    picked = rec
            fused_rows_and_poison_case(torch, pack, kind)
        sp = fused_spread_case(torch, pack, int4)
        spread += [sp["plain_host_vs_card"], sp["plain_2_rows_vs_8_rows"]]
        caught += fused_fault_cases(torch, pack, int4, faults)
        del pack
    emit({"phase": "kernels", "kernel": "fused_decode_step",
          "case": "the gate's margins, as err_over_tol (the gate passes at <= 1)",
          "sound_runs_max": max(sound), "plain_own_spread_max": max(spread),
          "planted_faults_min": min(caught), "planted_faults": len(caught)})
    return picked


def phase_kernels(torch, faults: dict) -> dict:
    """Every kernel at the main paths' shapes; returns the bf16 record of
    each kernel's heaviest use for the final ``kernels`` line."""
    picked = {}
    for dtype in ("float32", "bfloat16"):
        enc = flash_case(torch, "encoder", dtype, 2, 1024, 16, 16, 128, False, [0, 300])
        flash_case(torch, "prefill", dtype, 2, 512, 16, 4, 128, True, [499, 499])
        for ends in ([1, 3072], [1537, 1537]):
            rec = decode_case(torch, "self", dtype, 2, 3072, 16, 4, 128, ends)
        decode_case(torch, "cross_S1024", dtype, 2, 1024, 16, 16, 128, [0, 700])
        decode_case(torch, "cross_S128", dtype, 2, 128, 16, 16, 128, [0, 61])
        # four CFG streams (each pair of rows against a batch of two), and start > 0
        decode_case(torch, "self_B8", dtype, 8, 3072, 16, 4, 128, [1537] * 8)
        decode_case(torch, "start_gt_0", dtype, 4, 1024, 16, 16, 128, [700, 1024, 61, 5],
                    starts=[100, 1000, 0, 5])
        for ends in ([0, 3071], [1537, 1537]):
            rec8 = decode_int8_case(torch, "self_int8", dtype, 2, 3072, 16, 4, 128, ends, True)
        decode_int8_case(torch, "self_int8_B8", dtype, 8, 3072, 16, 4, 128, [1537] * 8, True)
        decode_int8_case(torch, "cross_S1024_int8", dtype, 2, 1024, 16, 16, 128, [0, 700], False)
        decode_int8_case(torch, "cross_S128_int8", dtype, 2, 128, 16, 16, 128, [0, 61], False)
        for name, (K, N) in GEMV_SHAPES.items():
            for B in (2, 8, 64):  # one stream, four streams, the most rows the kernels take
                r8 = gemv_case(torch, "int8_matmul", dtype, B, K, N)
                if B == 8:
                    continue
                r4 = [gemv_case(torch, "int4_gemv", dtype, B, K, N, g, lay)
                      for g, lay in INT4_FORMS]
                if name == "mlp_wi_2048x16384" and B == 2:
                    mlp8, mlp4 = r8, r4[0]
        # odd shapes: K not a multiple of 256 (of 16: 1000, 40), N a multiple of 8
        # only / of nothing, an odd K; a weight whose address is 4 bytes past 16
        for K, N in ((1000, 520), (1000, 1027)):
            gemv_case(torch, "int8_matmul", dtype, 3, K, N, time_it=False)
            gemv_case(torch, "int4_gemv", dtype, 3, K, N, 100, "halfsplit", time_it=False)
            gemv_case(torch, "int4_gemv", dtype, 3, K, N, 50, "parity", time_it=False)
        gemv_case(torch, "int8_matmul", dtype, 3, 40, 7, time_it=False)
        gemv_case(torch, "int8_matmul", dtype, 3, 2048, 512, time_it=False, offset=4)
        gemv_case(torch, "int4_gemv", dtype, 3, 1023, 520, 33, "unpacked", time_it=False)
        gemv_case(torch, "int4_gemv", dtype, 3, 1023, 520, None, "unpacked", time_it=False)
        # the three attention sites of a Dia-1.6B training step, and an odd shape
        flash_train_case(torch, "encoder_self", dtype, 2, 1024, 1024, 16, 16, 128, False,
                         [700, 300], [700, 300])
        train = flash_train_case(torch, "decoder_self", dtype, 2, 3072, 3072, 16, 4, 128, True,
                                 None, None)
        flash_train_case(torch, "decoder_cross", dtype, 2, 3072, 1024, 16, 16, 128, False,
                         None, [700, 300])
        for causal in (False, True):
            flash_train_case(torch, "odd", dtype, 2, 320, 320, 4, 2, 64, causal, [320, 250],
                             [320, 250], time_it=False)
            flash_train_case(torch, "interleaved", dtype, 2, 1000, 1000, 8, 2, 128, causal,
                             None, None, time_it=False, interleaved=True)
        flash_train_case(torch, "h32", dtype, 2, 320, 250, 4, 1, 32, False, [320, 200],
                         [250, 100], time_it=False)
        flash_train_case(torch, "h64", dtype, 2, 77, 77, 8, 2, 64, True, [77, 50], [77, 50],
                         time_it=False)
        picked = {"flash_attention": enc, "decode_attention": rec, "decode_attention_int8": rec8,
                  "int8_matmul": mlp8, "int4_gemv": mlp4, **train}
    picked["block_sparse_matmul"] = phase_sparse_kernels(torch)
    picked["fused_decode_step"] = phase_fused_kernels(torch, faults)
    return picked


def phase_fixtures(torch, repo: Path) -> None:
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia

    for name in ("trained_small", "trained_deep"):
        d = repo / "tests" / "fixtures" / name
        golden = np.load(d / "golden.npz")
        meta = json.loads((d / "FIXTURE.json").read_text())
        dia = Dia.from_pretrained(d, compute_dtype="float32", device="cuda")
        codes = dia.generate_codes(meta["prompt"], temperature=0.0, seed=meta["seed"])
        tokens_equal = bool(np.array_equal(codes, golden["tokens"]))
        wav = dia.generate(meta["prompt"], temperature=0.0, seed=meta["seed"])
        head_err = float(np.abs(wav[:256] - golden["wav_head"]).max())
        rec = {"phase": "fixtures", "fixture": name, "tokens_equal_golden": tokens_equal,
               "tokens_shape": list(codes.shape), "wav_len": int(wav.shape[0]),
               "golden_wav_len": int(golden["wav_sha_len"]), "wav_head_max_abs_err": head_err,
               "wav_head_tol": WAV_TOL}
        emit(rec)
        length_ok = wav.shape[0] == int(golden["wav_sha_len"])
        if not (tokens_equal and length_ok and head_err <= WAV_TOL):
            raise RuntimeError(f"fixture {name} disagrees with golden.npz: {rec}")
        for mode in ("int8", "int4"):
            packed_fixture(torch, d, name, mode, golden["tokens"], meta)
        fused_fixture(torch, d, name, meta, golden["tokens"])
        pruned_fixture(torch, d, name, meta)
    batched_fixture(torch, repo / "tests" / "fixtures" / "trained_small")


def params_to(tree, device):
    """A params tree (tensors and packed kernels) on another device."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def pruned_fixture(torch, d, name, meta) -> None:
    """The fixture pruned on the CPU (``prune_block_sparse(0.5, (32, 64))``)
    and, on ``trained_small``, shrunk (``shrink_heads(0.5)``,
    ``shrink_ffn(0.5)``); the same weights generate greedy tokens on the card
    (kernels) and on the CPU (plain versions), which must be equal."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts
    from dia_tts_prune_tpu_torch.prune import shrink_ffn, shrink_heads

    cpu = Dia.from_pretrained(d, compute_dtype="float32", device="cpu")
    base_params, base_cfg = cpu.params, cpu.config
    variants = {"prune_block_sparse(0.5, (32, 64))": lambda dia: dia.prune_block_sparse(
        0.5, (32, 64))}
    if name == "trained_small":
        for shrink in (shrink_heads, shrink_ffn):
            variants[f"{shrink.__name__}(0.5)"] = lambda dia, f=shrink: f(dia.params, dia.config,
                                                                           0.5)
    kw = dict(temperature=0.0, seed=meta["seed"])
    for variant, make in variants.items():
        cpu = Dia(base_cfg, base_params, "float32", device="cpu")
        made = make(cpu)
        if isinstance(made, tuple):  # a shrink: new params and a new config
            cpu = Dia(made[1], made[0], "float32", device="cpu")
        gpu = Dia(cpu.config, params_to(cpu.params, "cuda"), "float32", device="cuda")
        n0 = launch_counts()
        card = gpu.generate_codes(meta["prompt"], **kw)
        launched = {k: v - n0[k] for k, v in launch_counts().items() if v != n0[k]}
        host = cpu.generate_codes(meta["prompt"], **kw)
        rec = {"phase": "fixtures", "fixture": name, "variant": variant,
               "greedy_tokens_equal_card_cpu": bool(np.array_equal(card, host)),
               "frames": int(card.shape[0]), "launches_on_card": launched}
        if isinstance(made, dict):
            rec["block_density"] = {k: round(v, 4) for k, v in made.items()}
        emit(rec)
        sparse = isinstance(made, dict)
        if not rec["greedy_tokens_equal_card_cpu"] or card.shape[0] == 0 or (
                sparse and launched.get("block_sparse_matmul", 0) <= 0):
            raise RuntimeError(f"fixture {name} {variant}: card and CPU disagree: {rec}")


def batched_fixture(torch, d) -> None:
    """Two streams with voice prompts of 20 and 40 frames through
    ``generate_tokens_batch`` and ``Dia.generate_batch`` on the card: each
    lane's codes equal its single-stream run on the card."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia

    dia = Dia.from_pretrained(d, compute_dtype="float32", device="cuda")
    golden = np.load(d / "golden.npz")["tokens"]
    texts = ["[S1] The birch canoe slid. [S2]", "[S2] Hello there, friend."]
    prompts, prompt_texts = [golden[:20], golden[50:90]], ["[S1] A voice.", "[S2] Another one."]
    kw = dict(max_tokens=96, temperature=0.0)
    batch = dia.generator.generate_tokens_batch(texts, audio_prompt_codes=prompts,
                                                audio_prompt_texts=prompt_texts, **kw)
    singles = [dia.generate_codes(t, audio_prompt_codes=p, audio_prompt_text=pt, **kw)
               for t, p, pt in zip(texts, prompts, prompt_texts)]
    wavs = dia.generate_batch(texts, audio_prompts=prompts, audio_prompt_texts=prompt_texts, **kw)
    rec = {"phase": "fixtures", "fixture": d.name, "batched": "2 streams, prompts of 20 and 40 "
           "frames", "lanes_equal_single_stream": [bool(np.array_equal(b, s))
                                                   for b, s in zip(batch, singles)],
           "frames": [int(b.shape[0]) for b in batch],
           "waveform_samples": [0 if w is None else int(w.shape[0]) for w in wavs]}
    emit(rec)
    if not all(rec["lanes_equal_single_stream"]) or min(rec["frames"]) == 0 or any(
            w is None or w.shape[0] != f * dia.dac_config.hop_length
            for w, f in zip(wavs, rec["frames"])):
        raise RuntimeError(f"batched fixture: a lane differs from its single-stream run: {rec}")


def packed_fixture(torch, d, name, mode, tokens, meta, steps=96) -> None:
    """A fixture packed once on the CPU; the same bytes then run teacher-forced
    on the card (kernels) and on the CPU (plain versions): a prompt prefill
    over the first ``steps`` golden frames (more than 64 rows: the matmul
    route) and then one decode step per frame (the kernels), with float and
    with int8 KV caches."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.generate import CFG_BATCH, conditioning
    from dia_tts_prune_tpu_torch.models import dia as model
    from dia_tts_prune_tpu_torch.tokenizer import encode_cfg_batch

    cpu = Dia.from_pretrained(d, compute_dtype="float32", device="cpu")
    if mode == "int8":
        cpu.quantize_int8()
    else:
        cpu.quantize_int4()
    gpu = Dia(cpu.config, params_to(cpu.params, "cuda"), "float32", device="cuda")
    cfg, dd = cpu.config, cpu.config.data
    enc = encode_cfg_batch(meta["prompt"], dd.text_length, dd.text_pad_value)
    frames = np.ascontiguousarray(tokens[:steps]).astype(np.int64)
    rec = {"phase": "fixtures", "fixture": name, "packed": mode, "teacher_forced_steps": steps,
           "tol_share_of_max_logit": PACKED_LOGIT_TOL}

    def run(dia, kv_int8):
        dev = dia.device
        with torch.no_grad():
            cross, padding, ends = conditioning(dia.params, cfg, torch.from_numpy(enc).to(dev),
                                                torch.float32, None)
            tgt = torch.from_numpy(frames).to(dev)[None].expand(CFG_BATCH, -1, -1)
            rows = torch.arange(steps, device=dev)[None].expand(CFG_BATCH, -1)
            cache = model.new_self_cache(cfg, CFG_BATCH, 128, torch.float32, dev, quant=kv_int8)
            pre = model.decoder_prefill(dia.params, cfg, tgt, rows, cross, cache,
                                        torch.ones_like(rows, dtype=torch.int32),
                                        padding.to(torch.int32))
            cache = model.new_self_cache(cfg, CFG_BATCH, 128, torch.float32, dev, quant=kv_int8)
            if kv_int8:
                cross = model.quantize_cache(cross)
            out = [model.decode_step(dia.params, cfg, tgt[:, t - 1:t], rows[:, t:t + 1], t - 1,
                                     cache, cross, ends) for t in range(1, steps)]
        return pre.cpu(), torch.cat(out, dim=1).cpu()

    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts

    for kv_int8 in (False, True):
        n0 = launch_counts()
        pre_g, dec_g = run(gpu, kv_int8)
        launched = {k: v - n0[k] for k, v in launch_counts().items()}
        pre_c, dec_c = run(cpu, kv_int8)
        key = "kv_int8" if kv_int8 else "kv_float"
        top = float(dec_c.abs().max())
        rec[key] = {"decode_max_abs_diff": float((dec_g - dec_c).abs().max()),
                    "prefill_max_abs_diff": float((pre_g - pre_c).abs().max()),
                    "max_abs_logit": top, "launches_on_card": launched}
        worst = max(rec[key]["decode_max_abs_diff"], rec[key]["prefill_max_abs_diff"])
        gemv = "int8_matmul" if mode == "int8" else "int4_gemv"
        if not worst <= PACKED_LOGIT_TOL[key] * top or launched[gemv] <= 0:
            raise RuntimeError(f"packed fixture {name} {mode}: card and CPU disagree: {rec}")
    kw = dict(temperature=0.0, seed=meta["seed"])
    rec["greedy_tokens_equal_card_cpu"] = bool(np.array_equal(
        gpu.generate_codes(meta["prompt"], **kw), cpu.generate_codes(meta["prompt"], **kw)))
    emit(rec)


def greedy_until_near_tie(torch, dias, text, **kw) -> tuple:
    """Greedy generation on each of ``dias`` (card first), keeping the loop's
    raw token rows and the guided logits of every step.  Equal rows, or rows
    equal up to the first step where the runs' picks part, with the card's
    margin between the two picks under FUSED_NEAR_TIE there: the runs had the
    same tokens so far, so only summation-order noise can part them, and
    only at a near tie.  Returns (record, the second run's codes)."""
    import numpy as np

    import dia_tts_prune_tpu_torch.generate as gen
    from dia_tts_prune_tpu_torch.ops.sampling import apply_constraints, cfg_combine

    real_step, real_loop = gen.step_function, gen.decode_loop
    runs = []
    for dia in dias:
        logs, bufs = [], []
        d = dia.config.data

        def step(params, config, *args, **kwargs):
            logits = real_step(params)(params, config, *args, **kwargs)
            logs.append(apply_constraints(cfg_combine(logits[:, -1].float().cpu(), 3.0),
                                          d.audio_eos_value, d.audio_pad_value, d.audio_bos_value))
            return logits

        def loop(params, config, tokens_buf, *args):
            out = real_loop(params, config, tokens_buf, *args)
            bufs.append((tokens_buf.copy(), args[3]))  # rows, first loop row (prefill_step)
            return out

        gen.step_function, gen.decode_loop = (lambda params: step), loop
        try:
            codes = dia.generate_codes(text, temperature=0.0, **kw)
        finally:
            gen.step_function, gen.decode_loop = real_step, real_loop
        runs.append((codes, bufs[0][0], bufs[0][1], logs))
    (card, rows_c, first, logs_c), (host, rows_h, _, _) = runs
    differ = np.argwhere(rows_c != rows_h)
    rec = {"frames": int(card.shape[0]), "tokens_equal": bool(np.array_equal(card, host)),
           "steps": len(logs_c)}
    if len(differ):
        row = int(differ[0, 0])
        g = logs_c[row - first]
        margins = [float(g[c, int(rows_c[row, c])] - g[c, int(rows_h[row, c])])
                   for c in np.flatnonzero(rows_c[row] != rows_h[row])]
        rec.update({"first_differing_step": row - first, "margins": margins,
                    "near_tie": FUSED_NEAR_TIE})
        if row - first >= len(logs_c) or max(margins) >= FUSED_NEAR_TIE:
            raise RuntimeError(f"greedy runs part at more than a near tie: {rec}")
    return rec, host


def cpu_driven_greedy(torch, gpu, cpu, text, cpu_codes, **kw) -> dict:
    """The card's greedy run with the CPU model's beside it: conditioning,
    self cache, prefill and every decode step also run on the CPU, on its own
    caches and the same tokens, and the loop goes on with the CPU's logits.
    At every step of the whole run the card's logits lie within
    FUSED_LOGIT_TOL of the largest |CPU logit|, and the codes are the CPU's
    own greedy codes."""
    import numpy as np

    import dia_tts_prune_tpu_torch.generate as gen

    names = ("conditioning", "new_self_cache", "run_prefill", "quantize_cache", "step_function")
    real = {n: getattr(gen, n) for n in names}
    host, shares = {}, []

    def conditioning(params, config, enc_input, dtype, window):
        host["cross"], host["pad"], host["ends"] = real["conditioning"](
            cpu.params, config, enc_input.cpu(), dtype, window)
        return real["conditioning"](params, config, enc_input, dtype, window)

    def new_self_cache(config, batch, max_len, dtype, device, quant):
        host["self"] = real["new_self_cache"](config, batch, max_len, dtype, "cpu", quant=quant)
        return real["new_self_cache"](config, batch, max_len, dtype, device, quant=quant)

    def run_prefill(params, config, buf, window, offsets, steps, cross, pad, cache, dtype):
        real["run_prefill"](cpu.params, config, buf, window, offsets, steps, host["cross"],
                            host["pad"], host["self"], dtype)
        return real["run_prefill"](params, config, buf, window, offsets, steps, cross, pad, cache,
                                   dtype)

    def quantize_cache(cache):
        host["cross"] = real["quantize_cache"](host["cross"])
        return real["quantize_cache"](cache)

    def step(params, config, tgt, position, ws, self_cache, cross_cache, ends, dtype,
             valid_from=None):
        mine = real["step_function"](params)(params, config, tgt, position, ws, self_cache,
                                             cross_cache, ends, dtype, valid_from=valid_from)
        ref = real["step_function"](cpu.params)(
            cpu.params, config, tgt.cpu(), position.cpu(), ws, host["self"], host["cross"],
            host["ends"], dtype, valid_from=None if valid_from is None else valid_from.cpu())
        shares.append(float((mine.cpu() - ref).abs().max()) / float(ref.abs().max()))
        return ref.to(mine.device)

    for n, fn in (("conditioning", conditioning), ("new_self_cache", new_self_cache),
                  ("run_prefill", run_prefill), ("quantize_cache", quantize_cache),
                  ("step_function", lambda params: step)):
        setattr(gen, n, fn)
    try:
        codes = gpu.generate_codes(text, temperature=0.0, **kw)
    finally:
        for n in names:
            setattr(gen, n, real[n])
    rec = {"steps": len(shares), "max_logit_diff_share_of_max": max(shares),
           "tol": FUSED_LOGIT_TOL, "codes_equal_cpu_greedy": bool(np.array_equal(codes, cpu_codes))}
    if not (rec["max_logit_diff_share_of_max"] <= FUSED_LOGIT_TOL and rec["codes_equal_cpu_greedy"]):
        raise RuntimeError(f"CPU-driven card run: logits or codes disagree: {rec}")
    return rec


def fused_fixture(torch, d, name, meta, tokens, steps=64) -> None:
    """``quantize_int8(fused=True)`` and ``fused_mlp_int4=True`` on the CPU;
    the same bytes on the card: teacher-forced decode steps (the fused kernel
    against the plain version, each on its own caches, int8 and float) within
    FUSED_LOGIT_TOL of the largest |logit|, one kernel launch a step and no
    decode-attention launch, then greedy tokens card = CPU up to a near tie,
    and the card's logits at every step of a CPU-driven greedy run."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.generate import CFG_BATCH, conditioning
    from dia_tts_prune_tpu_torch.models import dia as model
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts
    from dia_tts_prune_tpu_torch.tokenizer import encode_cfg_batch

    for int4 in (False, True):
        cpu = Dia.from_pretrained(d, compute_dtype="float32", device="cpu")
        cpu.quantize_int8(fused=True, fused_mlp_int4=int4)
        gpu = Dia(cpu.config, params_to(cpu.params, "cuda"), "float32", device="cuda")
        cfg, dd = cpu.config, cpu.config.data
        enc = encode_cfg_batch(meta["prompt"], dd.text_length, dd.text_pad_value)
        frames = np.ascontiguousarray(tokens[:steps]).astype(np.int64)
        rec = {"phase": "fixtures", "fixture": name, "packed": "fused int4-MLP" if int4
               else "fused int8", "teacher_forced_steps": steps - 1,
               "tol_share_of_max_logit": FUSED_LOGIT_TOL}

        def run(dia, kv_int8):
            dev = dia.device
            with torch.no_grad():
                cross, _, ends = conditioning(dia.params, cfg, torch.from_numpy(enc).to(dev),
                                              torch.float32, None)
                tgt = torch.from_numpy(frames).to(dev)[None].expand(CFG_BATCH, -1, -1)
                pos = torch.arange(steps, device=dev)[None].expand(CFG_BATCH, -1)
                cache = model.new_self_cache(cfg, CFG_BATCH, 128, torch.float32, dev,
                                             quant=kv_int8)
                if kv_int8:
                    cross = model.quantize_cache(cross)
                out = [model.decode_step_fused(dia.params, cfg, tgt[:, t - 1:t], pos[:, t:t + 1],
                                               t - 1, cache, cross, ends)
                       for t in range(1, steps)]
            return torch.cat(out, dim=1).cpu()

        for kv_int8 in (False, True):
            n0 = launch_counts()
            dec_g = run(gpu, kv_int8)
            launched = {k: v - n0[k] for k, v in launch_counts().items() if v != n0[k]}
            dec_c = run(cpu, kv_int8)
            key = "kv_int8" if kv_int8 else "kv_float"
            top = float(dec_c.abs().max())
            rec[key] = {"decode_max_abs_diff": float((dec_g - dec_c).abs().max()),
                        "max_abs_logit": top, "launches_on_card": launched}
            if not rec[key]["decode_max_abs_diff"] <= FUSED_LOGIT_TOL * top or launched.get(
                    "fused_decode_step") != steps - 1 or launched.get("decode_attention", 0):
                raise RuntimeError(f"fused fixture {name}: card and CPU disagree: {rec}")
        kw = dict(max_tokens=128, seed=meta["seed"])
        rec["greedy"], cpu_codes = greedy_until_near_tie(torch, [gpu, cpu], meta["prompt"], **kw)
        rec["cpu_driven"] = cpu_driven_greedy(torch, gpu, cpu, meta["prompt"], cpu_codes, **kw)
        emit(rec)


_SEED_WEIGHTS = {}


def seed_weights(torch, cfg):
    """Fresh Dia-1.6B bf16 weights on the card, ``init_params(cfg, seed=0)``:
    drawn once on the host (numpy's normals for 1.6 G weights take ~30 s),
    then copied to the card for every model that needs fresh ones."""
    from dia_tts_prune_tpu_torch.models.dia import init_params

    if "host" not in _SEED_WEIGHTS:
        _SEED_WEIGHTS["host"] = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    return params_to(_SEED_WEIGHTS["host"], "cuda")


def phase_full_width(torch) -> dict:
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_decoder_params
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    cfg = dia_1_6b_config()
    dac_cfg = DACConfig()
    dac_params = init_dac_decoder_params(dac_cfg, seed=1, device="cuda")

    def new_model():
        return Dia(cfg, seed_weights(torch, cfg), "bfloat16", dac_params=dac_params,
                   dac_config=dac_cfg, device="cuda")

    dia = new_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    text = ("[S1] Dia is an open weights text to dialogue model. [S2] You get full control "
            "over scripts and voices. [S1] Wow. Amazing.")
    runs = []

    def describe(runs):
        return [describe_run(*r) for r in runs]

    def describe_run(name, frames, steps, gen_s, dec_s, w):
        total_s = gen_s + (dec_s or 0.0)
        rec = {"run": name, "frames": int(frames), "decode_steps": int(steps),
               "wall_s": total_s, "ms_per_step": 1e3 * gen_s / max(steps, 1),
               "tokens_per_s": steps / gen_s if gen_s else None}
        if w is not None:
            finite = bool(np.isfinite(w).all())
            rec.update({"audio_s": w.shape[0] / dac_cfg.sample_rate, "waveform_finite": finite,
                        "rtf": (w.shape[0] / dac_cfg.sample_rate) / total_s})
            if not finite or w.shape[0] != frames * dac_cfg.hop_length:
                raise RuntimeError(f"full-width {name}: bad waveform {rec}")
        if dec_s is not None:
            rec["codec_decode_s"] = dec_s
        return rec

    def timed(fn):
        """(result, seconds, decode steps run): every step launches the decode
        kernel twice per decoder layer, or the fused step kernel once."""
        def steps_so_far():
            n = launch_counts()
            return (n["decode_attention"] // (2 * cfg.model.decoder.n_layer)
                    + n["fused_decode_step"])

        torch.cuda.synchronize()
        n0, t = steps_so_far(), time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t, steps_so_far() - n0

    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    # greedy: generate_codes then the codec decode — the two halves of generate()
    codes, gen_s, n1 = timed(
        lambda: dia.generate_codes(text, max_tokens=512, temperature=0.0, seed=0))
    wav, dec_s, _ = timed(lambda: dia._decode_waveform(codes))
    runs.append(("greedy", codes.shape[0], n1, gen_s, dec_s, wav))
    wav2, s2, n2 = timed(lambda: dia.generate(text, max_tokens=512, temperature=1.3, seed=1234))
    f2 = 0 if wav2 is None else wav2.shape[0] // dac_cfg.hop_length
    runs.append(("sampled", f2, n2, s2, None, wav2))
    pcodes, s3, n3 = timed(lambda: dia.generate_codes(
        "[S2] And it clones voices from a prompt.", max_tokens=codes.shape[0] + 1 + 256,
        temperature=0.0, audio_prompt_codes=codes, audio_prompt_text=text))
    runs.append(("prompted_codes", pcodes.shape[0], n3, s3, None, None))
    torch.cuda.synchronize()
    if codes.shape[0] == 0 or pcodes.shape[0] == 0:
        raise RuntimeError("full-width run generated no frames")
    paths = {"bf16": {"runs": describe(runs), "launches": launch_counts(),
                      "peak_memory_bytes": int(torch.cuda.max_memory_allocated())}}

    # the quantized paths: int8 on the model that just ran (its float decoder
    # kernels are freed), int4 on a fresh one
    def quantized_path(name, dia, quantize, gemv):
        t = time.perf_counter()
        quantize(dia)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        codes, gen_s, steps = timed(
            lambda: dia.generate_codes(text, max_tokens=512, temperature=0.0, seed=0))
        wav, dec_s, _ = timed(lambda: dia._decode_waveform(codes))
        counts = launch_counts()
        paths[name] = {"runs": describe([("greedy", codes.shape[0], steps, gen_s, dec_s, wav)]),
                       "launches": counts, "quantize_s": quantize_s,
                       "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
                       "memory_allocated_bytes": int(torch.cuda.memory_allocated())}
        other = "int4_gemv" if gemv == "int8_matmul" else "int8_matmul"
        if steps <= 0 or counts[gemv] != DECODER_GEMVS * steps or counts[other] != 0:
            raise RuntimeError(f"full-width {name}: expected {DECODER_GEMVS} {gemv} launches in "
                               f"each of {steps} steps and none of {other}: {counts}")

    quantized_path("int8", dia, lambda d: d.quantize_int8(), "int8_matmul")
    del dia
    quantized_path("int4", new_model(), lambda d: d.quantize_int4(), "int4_gemv")
    paths.update(pruned_paths(torch, new_model(), text, timed, describe))
    paths.update(fused_paths(torch, new_model, text, timed, describe))

    rec = {"phase": "full_width", "config": "dia_1_6b_config() bf16, DACConfig(), seed weights",
           "init_s": init_s, "paths": paths}
    emit(rec)
    kernel_of = {"int8": "int8_matmul", "int4": "int4_gemv", "pruned": "block_sparse_matmul",
                 "batched": "block_sparse_matmul", "prune_cli": "block_sparse_matmul",
                 "fused_int8": "fused_decode_step", "fused_int4": "fused_decode_step",
                 "fused_batched": "fused_decode_step"}
    for name, path in paths.items():
        attention = () if name.startswith("fused") else ("decode_attention",)
        ran = ("flash_attention", *attention, *([kernel_of[name]] if name in kernel_of else []))
        missing = [k for k in ran if path["launches"][k] <= 0]
        if missing:
            raise RuntimeError(f"the {name} path never launched {missing}: {path['launches']}")
    return rec


def fused_paths(torch, new_model, text, timed, describe) -> dict:
    """The fused decode step at full width, each path on a fresh model:
    ``fused_int8`` (``quantize_int8(fused=True)``, int8 caches),
    ``fused_int4`` (``fused_mlp_int4=True``), ``fused_batched`` (the int8
    pack, four greedy streams in one batched run).  Each is a greedy
    512-token run whose every decode step launches the fused kernel once and
    the decode-attention kernel never (counts zeroed just before the run)."""
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    out = {}
    for name, int4, streams in (("fused_int8", False, 1), ("fused_int4", True, 1),
                                ("fused_batched", False, 4)):
        dia = new_model()
        t = time.perf_counter()
        dia.quantize_int8(fused=True, fused_mlp_int4=int4)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t
        pack = dia.params["decoder"]["fused_pack"]
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        if streams == 1:
            codes, gen_s, steps = timed(
                lambda: dia.generate_codes(text, max_tokens=512, temperature=0.0, seed=0))
            wav, dec_s, _ = timed(lambda: dia._decode_waveform(codes))
            runs = describe([("greedy", codes.shape[0], steps, gen_s, dec_s, wav)])
        else:
            texts = [text, "[S2] A second voice. [S1] Yes.", "[S1] Third.", "[S2] And a fourth."]
            batch, gen_s, steps = timed(lambda: dia.generator.generate_tokens_batch(
                texts, max_tokens=512, temperature=0.0))
            runs = describe([(f"greedy {streams} streams", sum(b.shape[0] for b in batch), steps,
                              gen_s, None, None)])
            runs[0]["tokens_per_s"] = streams * steps / gen_s
        counts = launch_counts()
        out[name] = {"runs": runs, "launches": counts, "quantize_s": quantize_s,
                     "pack_weight_bytes": pack.weight_bytes(),
                     "port_kernel_launches_per_step": sum(counts.values()) / max(steps, 1),
                     "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
                     "memory_allocated_bytes": int(torch.cuda.memory_allocated())}
        if steps <= 0 or counts["fused_decode_step"] != steps or counts["decode_attention"]:
            raise RuntimeError(f"full-width {name}: expected one fused launch in each of {steps} "
                               f"steps and no decode-attention launch: {counts}")
        del dia, pack
    return out


def pruned_paths(torch, dia, text, timed, describe) -> dict:
    """Pruned serving at full width on a fresh model: (d) ``pruned`` — the
    per-module block ranking at 0.5 with 256 x 256 blocks, ``apply_masks``,
    ``sparsify_block``, a greedy ``generate`` whose block-sparse launches
    must equal the count derived from the code; what the global ranking
    (``prune_block_sparse(0.5)``) gives on the same weights, reported only;
    (e) ``batched`` — four greedy streams on the pruned model, and for how
    many frames each lane equals its single-stream run (recorded: random
    weights give near-ties); (f) ``prune_cli`` — ``offline_prune
    --prune-mode block`` at 2 + 2 layers, ``from_pretrained``,
    ``sparsify_block``, generate."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.models.dia import init_params
    from dia_tts_prune_tpu_torch.offline_prune import main as prune_main
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dia_tts_prune_tpu_torch.ops.sparse import sparsify_params_block, sparsity_summary
    from dia_tts_prune_tpu_torch.prune import apply_masks, block_masks

    cfg = dia.config
    L = cfg.model.decoder.n_layer
    paths = {}
    allocated = {"at_entry": int(torch.cuda.memory_allocated())}
    t = time.perf_counter()
    global_tree = apply_masks(dia.params, block_masks(dia.params, 0.5, SPARSE_BLOCK))
    global_density = sparsity_summary(sparsify_params_block(global_tree, block_k=256,
                                                            block_n=256))
    del global_tree
    allocated["after_global_ranking"] = int(torch.cuda.memory_allocated())
    # block_masks(scope="module") -> apply_masks -> sparsify_block
    density = dia.prune_block_sparse(0.5, SPARSE_BLOCK, scope="module")
    torch.cuda.synchronize()
    prune_s = time.perf_counter() - t
    allocated["after_pruning"] = int(torch.cuda.memory_allocated())
    # weight bytes one decode step reads: every decoder kernel but the cross
    # K/V projections, which run once per request
    step_kernels = [(k, v) for k, v in _decoder_kernels(dia.params) if "cross_attention.k_proj"
                    not in k and "cross_attention.v_proj" not in k]
    e = 2  # bf16
    step_bytes = sum(e * listed_elements(torch, v) for _, v in step_kernels)
    dense_bytes = sum(e * v.values.numel() for _, v in step_kernels)

    torch.cuda.empty_cache()
    reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    codes, gen_s, steps = timed(
        lambda: dia.generate_codes(text, max_tokens=512, temperature=0.0, seed=0))
    wav, dec_s, _ = timed(lambda: dia._decode_waveform(codes))
    counts = launch_counts()
    # 8 contractions in each decoder layer and the logits head per step, and the
    # cross K/V projections of every layer once (there is no prompt prefill)
    expected = (8 * L + 1) * steps + 2 * L  # 145 per step at 18 layers (DECODER_GEMVS)
    paths["pruned"] = {
        "runs": describe([("greedy", codes.shape[0], steps, gen_s, dec_s, wav)]),
        "launches": counts, "expected_block_sparse_launches": expected,
        "prune_and_pack_s": prune_s, "block_density": density,
        "global_ranking_block_density": global_density,
        "weight_bytes_per_step": step_bytes, "dense_weight_bytes_per_step": dense_bytes,
        "bound_ms_per_step_weights": 1e3 * step_bytes / HBM_BYTES_PER_S,
        "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
        "memory_allocated_bytes": allocated}
    emit({"phase": "full_width", "path": "pruned", **paths["pruned"]})
    if steps <= 0 or counts["block_sparse_matmul"] != expected or counts["int8_matmul"] != 0 \
            or counts["int4_gemv"] != 0:
        raise RuntimeError(f"full-width pruned: expected {expected} block_sparse_matmul launches "
                           f"({steps} steps) and no GEMV launches: {counts}")

    texts = [text, "[S2] Four streams share every weight read. [S1] Do they?",
             "[S1] Batched serving on a pruned model.", "[S2] The last of the four. [S1] Yes."]
    reset_launch_counts()
    batch, batch_s, bsteps = timed(lambda: dia.generator.generate_tokens_batch(
        texts, max_tokens=192, temperature=0.0))
    bcounts = launch_counts()
    singles, single_s, single_steps = [], 0.0, 0
    for t_ in texts:
        c, s_, n_ = timed(lambda: dia.generate_codes(t_, max_tokens=192, temperature=0.0))
        singles.append(c)
        single_s, single_steps = single_s + s_, single_steps + n_

    def same_frames(a, b):
        n = min(a.shape[0], b.shape[0])
        diff = np.flatnonzero((a[:n] != b[:n]).any(axis=1))
        return int(diff[0]) if diff.size else n

    paths["batched"] = {
        "streams": len(texts), "decode_steps": bsteps, "wall_s": batch_s,
        "ms_per_step": 1e3 * batch_s / max(bsteps, 1),
        "aggregate_tokens_per_s": len(texts) * bsteps / batch_s,
        "single_stream_ms_per_step": 1e3 * single_s / max(1, single_steps),
        "frames": [int(b.shape[0]) for b in batch],
        "frames_equal_single_stream": [same_frames(b, s_) for b, s_ in zip(batch, singles)],
        "launches": bcounts}
    emit({"phase": "full_width", "path": "batched", **paths["batched"]})
    if bsteps <= 0 or min(paths["batched"]["frames"]) == 0:
        raise RuntimeError(f"full-width batched: no frames: {paths['batched']}")
    del dia, batch, singles
    torch.cuda.empty_cache()

    # the offline CLI (global ranking, as the JAX CLI) at 2 + 2 layers of full width
    m = cfg.model
    small = cfg.model_copy(update={"model": m.model_copy(update={
        "encoder": m.encoder.model_copy(update={"n_layer": 2}),
        "decoder": m.decoder.model_copy(update={"n_layer": 2})})})
    with tempfile.TemporaryDirectory(prefix="chip_smoke_prune_") as tmp:
        src, out = Path(tmp) / "model", Path(tmp) / "pruned"
        Dia(small, init_params(small, seed=3, dtype=torch.bfloat16, device="cuda"), "bfloat16",
            device="cuda").save_pretrained(src)
        t = time.perf_counter()
        rc = prune_main(["--model-path", str(src), "--output-dir", str(out), "--prune-mode",
                         "block", "--prune-amount", "0.5"])
        torch.cuda.synchronize()
        cli_s = time.perf_counter() - t
        files = sorted(p.name for p in out.iterdir())
        report = json.loads((out / "prune_report.json").read_text())
        pruned = Dia.from_pretrained(out, compute_dtype="bfloat16", device="cuda")
        cli_density = pruned.sparsify_block(SPARSE_BLOCK)
        reset_launch_counts()
        codes = pruned.generate_codes("[S1] Pruned offline.", max_tokens=64, temperature=0.0)
        torch.cuda.synchronize()
    paths["prune_cli"] = {"config": "dia_1_6b_config() widths, 2 + 2 layers, seed weights",
                          "return_code": rc, "seconds": cli_s, "output_files": files,
                          "report": report, "block_density": cli_density,
                          "frames": int(codes.shape[0]), "launches": launch_counts()}
    emit({"phase": "full_width", "path": "prune_cli", **paths["prune_cli"]})
    if rc != 0 or codes.shape[0] == 0 or "pytorch_model.bin" not in files:
        raise RuntimeError(f"the offline_prune CLI run failed its checks: {paths['prune_cli']}")
    return paths


def _decoder_kernels(params):
    """(dotted path, kernel) of every decoder kernel."""
    from dia_tts_prune_tpu_torch.prune import prunable_items

    return [(".".join(path), k) for path, k in prunable_items({"decoder": params["decoder"]})]


def train_launch_counts():
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts

    c = launch_counts()
    return {k: c[k] for k in ("flash_attention", "flash_attention_lse",
                              "flash_attention_bwd_kv", "flash_attention_bwd_q")}


def expected_train_launches(cfg, steps, remat=True):
    """Attention sites of one loss: one per encoder layer, two per decoder
    layer.  The LSE forward runs once per site and once more under
    rematerialization, each backward kernel once, the forward-only kernel never."""
    sites = cfg.model.encoder.n_layer + 2 * cfg.model.decoder.n_layer
    return {"flash_attention": 0, "flash_attention_lse": steps * sites * (2 if remat else 1),
            "flash_attention_bwd_kv": steps * sites, "flash_attention_bwd_q": steps * sites}


def phase_train_fixture(torch, repo: Path) -> None:
    """A few optimizer steps on ``trained_small`` in fp32, on the card
    (kernels both ways, every layer rematerialized) and on the CPU (plain
    versions under autograd): the losses must agree step by step."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.lora import LoraConfig
    from dia_tts_prune_tpu_torch.ops.kernels import reset_launch_counts
    from dia_tts_prune_tpu_torch.tokenizer import encode_text
    from dia_tts_prune_tpu_torch.train import TrainConfig, Trainer, build_train_batch

    d = repo / "tests" / "fixtures" / "trained_small"
    tokens = np.load(d / "golden.npz")["tokens"].astype(np.int32)
    meta = json.loads((d / "FIXTURE.json").read_text())
    cpu = Dia.from_pretrained(d, compute_dtype="float32", device="cpu")
    cfg, dd = cpu.config, cpu.config.data
    texts = np.stack([encode_text(t, dd.text_length, dd.text_pad_value)
                      for t in (meta["prompt"], "[S2] A second, shorter line.")])
    batches = [build_train_batch(cfg, texts, [tokens, tokens[::-1][:150]]),
               build_train_batch(cfg, texts[::-1].copy(), [tokens[40:], tokens[:90]])]
    modes = {"full": {}, "lora": {"adapter_mode": "lora", "lora": LoraConfig(r=4, alpha=8.0)},
             "qat_int8": {"qat_mode": "int8"}}
    steps = 3
    for mode, kw in modes.items():
        tc = TrainConfig(learning_rate=1e-4, remat=True, compute_dtype="float32", **kw)
        logs = {}
        for device in ("cuda", "cpu"):
            params = params_to(cpu.params, device)
            trainer = Trainer(params, cfg, tc, 10)
            reset_launch_counts()
            logs[device] = [trainer.step(batches[i % 2]) for i in range(steps)]
            if device == "cuda":
                launched = train_launch_counts()
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"])
               for a, b in zip(logs["cuda"], logs["cpu"])]
        rec = {"phase": "fixtures", "fixture": "trained_small", "training": mode, "steps": steps,
               "loss_card": [x["loss"] for x in logs["cuda"]],
               "loss_cpu": [x["loss"] for x in logs["cpu"]],
               "grad_norm_card": [x["grad_norm"] for x in logs["cuda"]],
               "grad_norm_cpu": [x["grad_norm"] for x in logs["cpu"]],
               "loss_max_rel_diff": max(rel), "loss_rtol": TRAIN_LOSS_RTOL[mode],
               "launches_on_card": launched}
        emit(rec)
        if not max(rel) <= TRAIN_LOSS_RTOL[mode] or launched != expected_train_launches(cfg, steps):
            raise RuntimeError(f"fixture training {mode}: card and CPU disagree, or the launch "
                               f"counts are not {expected_train_launches(cfg, steps)}: {rec}")
        if not logs["cuda"][-1]["loss"] < logs["cuda"][0]["loss"]:
            raise RuntimeError(f"fixture training {mode}: the loss did not fall: {rec}")


KERNEL_KINDS = (("attention_forward", ("flash_fwd_kernel", "flash_fwd_mma_kernel")),
                ("attention_bwd_kv", ("flash_bwd_kv_kernel", "flash_bwd_kv_mma_kernel")),
                ("attention_bwd_q", ("flash_bwd_q_kernel", "flash_bwd_q_mma_kernel")),
                ("gemm", ("gemm", "cutlass", "cublas", "nvjet", "xmma", "wgmma", "gemv")))


def profiled(torch, fn):
    """``fn()`` under ``torch.profiler``: (result, wall ms, device ms — the sum
    of the kernels' own times —, device ms by kind of kernel with the largest
    kernels of no kind by name, kernel count)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kinds = {kind: 0.0 for kind, _ in KERNEL_KINDS}
    kinds["other"] = 0.0
    count, others = 0, []
    for ev in prof.key_averages():  # kernel rows only: op rows repeat their time
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        key = ev.key.lower()
        kind = next((kind for kind, words in KERNEL_KINDS if any(w in key for w in words)), "other")
        kinds[kind] += us / 1e3
        count += ev.count
        if kind == "other":
            others.append((us / 1e3, ev.count, ev.key[:60]))
    device_ms = sum(kinds.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    kinds["largest_other"] = [{"ms": ms, "calls": n, "name": name}
                              for ms, n, name in sorted(others, reverse=True)[:6]]
    return out, wall_ms, device_ms, kinds, count


def phase_training(torch, tmp: Path) -> dict:
    """Teacher-forced fine-tuning at full width through ``Trainer`` and the
    ``finetune`` CLI; returns {path: {"launches": ...}} for the kernels line."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.finetune import main as finetune_main
    from dia_tts_prune_tpu_torch.lora import LoraConfig
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_params
    from dia_tts_prune_tpu_torch.models.dia import init_params
    from dia_tts_prune_tpu_torch.ops.kernels import reset_launch_counts
    from dia_tts_prune_tpu_torch.train import TrainConfig, Trainer, build_train_batch, global_norm

    cfg = dia_1_6b_config()
    dd = cfg.data
    rng = np.random.default_rng(7)
    text = rng.integers(1, 256, (2, dd.text_length)).astype(np.int32)
    text[0, 700:] = dd.text_pad_value
    text[1, 300:] = dd.text_pad_value
    codes = [rng.integers(0, 1024, (n, dd.channels)).astype(np.int32) for n in (3072, 2000)]
    batch = build_train_batch(cfg, text, codes)
    params = seed_weights(torch, cfg)
    paths = {}

    def run(name, steps, **kw):
        tc = TrainConfig(learning_rate=1e-4, compute_dtype="bfloat16", remat=True, **kw)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer = Trainer(params, cfg, tc, 10)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        log, total = [], {k: 0 for k in train_launch_counts()}
        for _ in range(steps):
            reset_launch_counts()
            out, wall_ms, device_ms, kinds, kernels = profiled(torch, lambda: trainer.step(batch))
            launched = train_launch_counts()
            log.append({**out, "wall_ms": wall_ms, "device_ms": device_ms,
                        "device_ms_by_kind": kinds, "device_idle_share":
                        max(0.0, 1.0 - device_ms / wall_ms), "kernels": kernels,
                        "launches": launched})
            total = {k: total[k] + launched[k] for k in total}
            if launched != expected_train_launches(cfg, 1):
                raise RuntimeError(f"training {name}: launches {launched}, expected "
                                   f"{expected_train_launches(cfg, 1)}")
            if not (np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])):
                raise RuntimeError(f"training {name}: non-finite step {out}")
        rec = {"phase": "training", "path": name, "config": "dia_1_6b_config() bf16 compute, "
               "audio_length 3072, batch 2, remat", "trainer_init_s": init_s, "steps": log,
               "launches": total, "peak_memory_bytes": int(torch.cuda.max_memory_allocated())}
        return trainer, rec

    trainer, rec = run("train_lora", 3, adapter_mode="lora",
                       lora=LoraConfig(r=8, alpha=16.0, target_modules=("q_proj", "v_proj")))
    b = trainer.adapter()["weights"]["decoder"]["layers"]["self_attention"]["q_proj"]["b"]
    rec["lora_b_max_abs"] = float(b.abs().max())
    emit(rec)
    if not rec["lora_b_max_abs"] > 0:
        raise RuntimeError("training train_lora: LoRA's B never left zero")
    paths["train_lora"] = rec
    del trainer, b

    trainer, rec = run("train_full", 2)
    # the optimizer's share: one more update (zero gradients) between events
    zeros = {n: torch.zeros_like(p) for n, p in trainer.optimizer.leaves.items()}
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    norm = global_norm(zeros.values())
    trainer.optimizer.update(zeros)
    end.record()
    torch.cuda.synchronize()
    rec["optimizer_update_ms"] = start.elapsed_time(end)
    rec["trained_parameters"] = sum(p.numel() for p in trainer.optimizer.leaves.values())
    emit(rec)
    paths["train_full"] = rec
    del trainer, zeros, norm

    trainer, rec = run("train_qat_int8", 1, qat_mode="int8")
    emit(rec)
    paths["train_qat_int8"] = rec
    del trainer, params
    torch.cuda.empty_cache()

    # the finetune CLI end to end, two layers per stack at full width
    m = cfg.model
    small = cfg.model_copy(update={"model": m.model_copy(update={
        "encoder": m.encoder.model_copy(update={"n_layer": 2}),
        "decoder": m.decoder.model_copy(update={"n_layer": 2})})})
    dac_cfg = DACConfig()
    dia = Dia(small, init_params(small, seed=2, dtype=torch.bfloat16, device="cuda"), "bfloat16",
              dac_params=init_dac_params(dac_cfg, seed=1, device="cuda"), dac_config=dac_cfg,
              device="cuda")
    model_dir, data_dir, out_dir = tmp / "model", tmp / "dataset", tmp / "finetuned"
    (data_dir / "wavs").mkdir(parents=True)
    lines = []
    for i, line in enumerate(("[S1] Hello there.", "[S2] Hi, how are you?", "[S1] One more.")):
        wav = dia.generate(line, max_tokens=48 + 16 * i, temperature=0.0, seed=i)
        dia.save_audio(data_dir / "wavs" / f"item{i}.wav", wav, dac_cfg.sample_rate)
        lines.append(f"item{i}.wav|{line}")
    (data_dir / "metadata.csv").write_text("\n".join(lines) + "\n")
    dia.save_pretrained(model_dir)
    del dia
    reset_launch_counts()
    t0 = time.perf_counter()
    rc = finetune_main(["--model-path", str(model_dir), "--dataset-dir", str(data_dir),
                        "--output-dir", str(out_dir), "--adapter-mode", "lora",
                        "--compute-dtype", "bfloat16", "--batch-size", "2", "--epochs", "1",
                        "--learning-rate", "1e-4", "--logging-steps", "1", "--save-steps", "1"])
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launched = train_launch_counts()
    steps = 2  # three items in batches of two
    tuned = Dia.from_pretrained(out_dir, compute_dtype="bfloat16", device="cuda")
    wav = tuned.generate("[S1] Hello again.", max_tokens=48, temperature=0.0, seed=0)
    files = sorted(p.name for p in out_dir.iterdir())
    rec = {"phase": "training", "path": "finetune_cli", "config": "dia_1_6b_config() widths, 2 + 2 "
           "layers, DACConfig(), seed weights, 3 synthesized items", "return_code": rc,
           "seconds": cli_s, "launches": launched, "output_files": files,
           "adapter_files": sorted(p.name for p in (out_dir / "adapter").iterdir()),
           "generated_samples": 0 if wav is None else int(wav.shape[0]),
           "waveform_finite": bool(wav is not None and np.isfinite(wav).all())}
    emit(rec)
    want = {"adapter", "pytorch_model.bin", "config.json", "dac.safetensors", "dac_config.json"}
    if rc != 0 or not want <= set(files) or launched != expected_train_launches(small, steps) \
            or not rec["waveform_finite"] or rec["generated_samples"] <= 0:
        raise RuntimeError(f"the finetune CLI run failed its checks (expected launches "
                           f"{expected_train_launches(small, steps)}): {rec}")
    paths["finetune_cli"] = rec
    return paths


def main() -> int:
    repo = Path(__file__).resolve().parent
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(repo))
    try:
        import dia_tts_prune_tpu_torch  # noqa: F401  (present beside this file?)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # every phase, unless the caller names some (a partial run prints no result line)
    only = set(sys.argv[1:])
    unknown = only - set(PHASES)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}; known: {PHASES}", file=sys.stderr)
        return 1
    wanted = lambda name: not only or name in only  # noqa: E731

    t0 = time.perf_counter()
    faults = phase_build()
    picked = phase_kernels(torch, faults) if wanted("kernels") else None
    if wanted("fixtures"):
        phase_fixtures(torch, repo)
        phase_train_fixture(torch, repo)
    full = phase_full_width(torch) if wanted("full_width") else None
    if wanted("training"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            training = phase_training(torch, Path(tmp))
    if only:
        print(f"# chip_smoke partial run {sorted(only)}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        return 0
    paths = {**full["paths"], **training}

    csrc, jax_kernels = "dia_tts_prune_tpu_torch/csrc/", "dia_tts_prune_tpu/ops/kernels/"
    SOURCES = {"flash_attention_lse": "flash_attention",
               "flash_attention_bwd_kv": "flash_attention_bwd",
               "flash_attention_bwd_q": "flash_attention_bwd",
               "fused_decode_step": "fused_step"}
    # (kernel, its record of the kernels phase, the path whose launches it reports, replaces)
    lines = [("flash_attention", "flash_attention", "bf16", "flash_attention.py:157"),
             ("flash_attention_lse", "flash_attention_lse", "train_lora", "flash_attention.py:359"),
             ("flash_attention_bwd_kv", "flash_attention_bwd_kv", "train_lora",
              "flash_attention.py:456"),
             ("flash_attention_bwd_q", "flash_attention_bwd_q", "train_lora",
              "flash_attention.py:481"),
             ("decode_attention", "decode_attention", "bf16", "decode_attention.py:133"),
             ("decode_attention", "decode_attention_int8", "int8", "decode_attention.py:133"),
             ("int8_matmul", "int8_matmul", "int8", "int8_matmul.py:53"),
             ("int4_gemv", "int4_gemv", "int4", "int4_gemv.py:129"),
             ("block_sparse_matmul", "block_sparse_matmul", "pruned", "sparse_matmul.py:121"),
             ("fused_decode_step", "fused_decode_step", "fused_int8", "fused_step.py:1018")]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"{csrc}{SOURCES.get(name, name)}.cu",
         "core_route": rec.get("route"), "replaces": jax_kernels + replaces,
         "launches": paths[path]["launches"][name], "max_abs_err": rec["max_abs_err"],
         "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
         "case": f"{rec.get('case', '')} {json.dumps(rec['shape'])} {rec['dtype']}"
                 f"{' density %.3f' % rec['density'] if 'density' in rec else ''}".strip(),
         "path": path}
        for name, pick, path, replaces in lines for rec in (picked[pick],)]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no card listed", flush=True)
    print(f"# chip_smoke total {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
