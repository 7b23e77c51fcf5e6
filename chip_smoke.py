#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dia_tts_prune_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card).  Naming phases (``python3 chip_smoke.py kernels training``) runs the
build and only those, for work on one of them, and prints no result line.  Phases, each printing one JSON line; any failure raises and the
script exits non-zero:

1. build     — compile every CUDA kernel from ``dia_tts_prune_tpu_torch/csrc``
               and the planted-fault copies of the fused step (one nvcc per
               source, all at once), and report the registers and spills of
               the flash, block-sparse, decode-attention, bf16 int8-matmul,
               int4-GEMV and fused-step kernels (``nvcc -Xptxas -v``);
2. kernels   — each kernel against its plain PyTorch version at the main
               paths' shapes, fp32 and bf16: max abs error beside the stated
               tolerance, kernel and library times (device time: calls
               replayed from a CUDA graph), the plain version's time and the
               kernel's eager time (events around Python calls), the least
               time the card could take, launches.  The attention
               kernels (float and int8 caches), the int8-matmul and int4-GEMV
               kernels (B = 2, 8, 64; bf16 calls one kernel each, counted as
               the nodes of a CUDA graph that captures a call; int4 in four
               forms) at the five weight shapes of a
               decode step and a few odd ones (unaligned weights), and the
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
               packs, bf16 and int8 caches, B = 2 and 8, and 20 and 66; one
               kernel a call, counted in a captured CUDA graph), rows of
               B = 20 equal to B = 2 and 8 runs, NaN where nothing may be
               read, the plain version's own spread (host against card, 2
               rows against 8) and four planted faults, built from edited
               copies of the source, each of which the gate must reject;
3. fixtures  — the trained fixtures through ``Dia.from_pretrained(...,
               device="cuda")`` in fp32: greedy tokens equal ``golden.npz``,
               waveform length and head as recorded; then packed int8 and
               int4: teacher-forced logits on the card (kernels) against the
               CPU (plain versions) on the same packed bytes, and greedy
               tokens card = CPU up to a near tie;
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
               from a numpy seed, every serving route on the CUDA-graph
               decode loop (``graphed_route``; each call with the launch
               counts zeroed just before and read just after): an eager
               reference call at 192 tokens whose codes the graph loop must
               equal bit for bit, then a call that captures at 512 and three
               from the kept graph — ms/step (median, spread), host against
               device ms/step, capture seconds, graph nodes per step against
               the decode step's own, peak memory, RTF, aggregate tokens/s.
               Routes: (a) float weights — ``bf16`` greedy, ``sampled``
               (seeded), ``prompted`` (a voice prompt: the causal-flash
               prefill); (b) ``int8`` (``quantize_int8()``, int8 KV caches);
               (c) ``int4`` (a fresh model, ``quantize_int4()``); (d)
               ``pruned``: a fresh model, per-module block ranking at 0.5
               (and the global ranking's densities, reported),
               ``sparsify_block``; (e) ``batched``: four greedy streams on
               it, each equal to its single-stream run frame for frame on
               the graph loop and, by the batched-lane probe (eager), op for
               op (the first differing op is printed, or none); (f)
               ``prune_cli``: ``offline_prune --prune-mode block`` at 2 + 2
               layers, ``from_pretrained``, ``sparsify_block``, generate; (g)
               ``fused_int8``, ``fused_int4``, ``fused_batched`` (four
               streams): one fused launch and no decode-attention launch per
               step.  Every kernel of a path must have launched, the GEMV
               and block-sparse kernels once per contraction of every step
               the host issued (eager, warm-up and captured steps);
5. serving   — the serving front end at the same full width, the DAC's
               encoder too: the stdlib HTTP server (``app.make_server``)
               with a ``DynamicBatcher`` on a thread, the launch counts zeroed
               before each group of served requests and read right after it
               (flash and decode attention must have launched in each
               group).  Four concurrent single-chunk
               ``/generate`` requests (two greedy, two seeded) whose PCM
               equals their solo ``Dia.generate``, two sharing a group;
               ``generate_tokens_stream`` codes equal to ``generate_tokens`` on
               the graph loop at 128- and 20-step segments, greedy and seeded;
               ``/stream`` on a cold key and a warm one (time to the first PCM
               byte, captures; the served bytes equal to the in-process
               stream's, the PCM within ``PCM_LSB_TOL`` of the offline
               waveform's), chunk gaps against their audio seconds; a client
               that leaves after one chunk, then the same request again, equal
               to the first; one long-form ``/generate`` whose second batch is
               prompted with the first's audio through ``load_audio``;
6. cbatch    — continuous batching at the same full width
               (``cbatch.ContinuousBatcher``: 4 lanes, 64-step segments,
               256 tokens, a 256-byte text window; a fresh batcher a group,
               built inside its group's launch count, one capture each): six
               requests in two waves (greedy and seeded lanes with their own
               sampling values, a voice prompt, a shorter cap so that a
               queued request swaps in mid-run), a cancelled lane whose slot
               a queued request takes, the HTTP app with the batcher (two
               ``/generate``, one ``/stream``), and two lanes after
               ``quantize_int8()`` with int8 caches: every lane's codes
               equal its solo graph-loop run bit for bit, the served PCM
               equals the solo waveform, the ``/stream`` bytes the in-process
               ``generate_stream``'s;
7. training  — teacher-forced fine-tuning at the same full width (bf16
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
import math
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
# the same bound on 16-bit PCM: two samples within WAV_TOL truncate to codes at
# most ceil(WAV_TOL * 32767) apart
PCM_LSB_TOL = math.ceil(WAV_TOL * 32767)


# after the build, in this order
PHASES = ("kernels", "fixtures", "full_width", "serving", "cbatch", "training")


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
                 "decode_attention", "int8_matmul", "int4_gemv", "fused_step")


def ptxas_report(log: str) -> dict:
    """{kernel<args>: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output: the flash kernels by head dim, the bf16
    block-sparse kernel by tile (rows x columns), load width and slice map,
    the decode kernel at head dim 128 by q and cache type and query heads held,
    the bf16 int8-matmul kernel by n-tiles of 8 rows and weight copy width, the
    bf16 int4 GEMV by n-tiles, layout, copy width and whether scale segments
    may end inside a k-step, the fused step by n-tiles of x a pass."""
    import re

    report, name = {}, None
    entry = re.compile(r"Function properties for \S*?\d(flash_[a-z_]+?_kernel)I(\w*?)Li(\d+)E")
    bsm = re.compile(r"Function properties for \S*?bsm_mma_kernelI\w*?CfgI" + r"Li(\d+)E" * 6
                     + r"EELi(\d+)ELb([01])E")
    dec = re.compile(r"Function properties for \S*?decode_attention_kernelI(\w*?)Li128ELi(\d)E")
    i8 = re.compile(r"Function properties for \S*?int8_matmul_mma_kernelILi(\d+)ELi(\d+)ELb([01])E")
    i4 = re.compile(r"Function properties for \S*?int4_gemv_mma_kernelILi(\d+)ELi([01])ELi(\d+)"
                    r"ELb([01])E")
    fs = re.compile(r"Function properties for \S*?fused_step_kernelILi(\d+)E")
    types = {"13__nv_bfloat16S1_": "bf16, bf16", "13__nv_bfloat16a": "bf16, int8",
             "ff": "float, float", "fa": "float, int8"}
    for line in log.splitlines():
        if m := fs.search(line):
            name = f"fused_step_kernel<{m.group(1)} n-tiles>"
            report[name] = {}
        elif m := i4.search(line):
            name = (f"int4_gemv_mma_kernel<{m.group(1)} n-tiles, "
                    f"{('halfsplit', 'parity')[int(m.group(2))]}, copies of {m.group(3)} B"
                    f"{', segments inside k-steps' if m.group(4) == '1' else ''}>")
            report[name] = {}
        elif m := i8.search(line):
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
        # the faults run at B = 2: one row tiling is enough (FUSED_TB)
        running[name] = (subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS,
                                           f"-I{_build.CSRC_DIR}", "-DFUSED_TB=1", "-o", str(lib),
                                           str(src)],
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT), lib)
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
    """CUDA work items (kernels, memsets, copies) that one ``fn()`` enqueues:
    the nodes of a CUDA graph that captures one call (``cuGraphGetNodes``)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    return graph_nodes(torch, graph)


def gemv_case(torch, kernel, dtype, B, K, N, group=None, layout=None, time_it=True, offset=0):
    """``int8_matmul`` (layout None) or ``int4_gemv`` on a weight packed from
    seed-made floats, against its plain version; times over copies of the
    weight that together exceed the L2, as a decode step finds them cold.
    ``offset`` > 0: the weight starts that many bytes into its storage, so
    its address is not 16-byte aligned."""
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
    values = qk.values
    if offset:
        values = torch.empty(values.numel() + offset, dtype=torch.int8, device="cuda")
        values = values[offset:].view(qk.values.shape)
        values.copy_(qk.values)
    fn = KERNEL_WRAPPERS[kernel]
    before = fn.launches
    out = fn(x, values, scale, *extra)
    launches = fn.launches - before
    torch.cuda.synchronize()
    ref = plain(x.float(), values, scale, *extra)
    diff = (out.float() - ref).abs()
    sum_abs = x.float().abs() @ deq.abs()
    tol = GEMV_SUM_TOL * sum_abs + TOL[dtype]["rtol"] * ref.abs()
    rec = {"phase": "kernels", "kernel": kernel, "dtype": dtype,
           "shape": {"B": B, "K": K, "N": N, "group": group, "layout": layout},
           "max_abs_err": diff.max().item(), "max_err_over_tol": (diff / tol).max().item(),
           "tol": {"sum_abs": GEMV_SUM_TOL, "rtol": TOL[dtype]["rtol"]}, "launches": launches,
           "weight_offset": offset}
    if not rec["max_err_over_tol"] <= 1.0:
        raise RuntimeError(f"{kernel}: kernel disagrees with its plain version: {rec}")
    if kernel == "int8_matmul":
        import importlib

        i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
        if dtype == "bfloat16":  # one cluster launch, no finish pass
            rec["route"] = "mma_bf16"
            rec["plan"] = {"copy_bytes": i8.copy_width(N, values.data_ptr()),
                           "cluster_slice": list(i8.cluster_plan(K, N))}
            rec["kernels_per_call"] = kernels_per_call(torch, lambda: fn(x, values, scale))
            if rec["kernels_per_call"] != 1:
                raise RuntimeError(f"int8_matmul bf16: {rec['kernels_per_call']} kernels a call")
        else:
            vec = i8.vector_width(N, values.data_ptr())
            rec["route"] = "fma_fp32"
            rec["plan"] = {"vec": vec, "n_split": i8.split_plan(K, N, vec)}
    else:
        import importlib

        i4 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int4_gemv")
        R = values.shape[0]
        if i4.uses_mma(dt, layout):  # one cluster launch, no finish pass
            rec["route"] = "mma_bf16"
            rec["plan"] = {"copy_bytes": i4.copy_width(N, values.data_ptr()),
                           "cluster_slice": list(i4.cluster_plan(R, N))}
            rec["kernels_per_call"] = kernels_per_call(torch, lambda: fn(x, values, scale,
                                                                         *extra))
            if rec["kernels_per_call"] != 1:
                raise RuntimeError(f"int4_gemv bf16: {rec['kernels_per_call']} kernels a call")
        else:
            vec = i4.vector_width(N, values.data_ptr())
            rec["route"] = "fma_fp32" if dtype == "float32" else "fma_bf16"
            rec["plan"] = {"vec": vec,
                           "n_split": i4.split_plan(R, N, vec, max_slice=i4.MAX_SLICE)}
    nbytes = (values.numel() + 4 * scale.numel() + x.element_size() * (B * K + B * N))
    rec["bound_ms"], rec["bound_by"] = bound(nbytes, 2.0 * B * K * N, dtype)
    if time_it:
        n = max(2, min(64, -(-COLD_BYTES // values.numel())))
        vals = [values.clone() for _ in range(n)]
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
# last K slice of every GEMV left out of its strip's sum; o_proj reading 64
# of its 2048 K rows fewer (half a head: its plan, and so its layers' offsets,
# as for 1984 rows); the last 32-slot chunk of every attention left out of
# the combine (its weight zero); the int4 MLP's low- and high-nibble scale
# rows swapped.
FUSED_FAULTS = {
    "k_slice_dropped": (
        "for (int s = 0; s < nsl; ++s) v += __ldcg(part + s * stride + off);",
        "for (int s = 0; s < nsl - 1; ++s) v += __ldcg(part + s * stride + off);"),
    "o_proj_64_rows_short": (
        "case M_O: return {Nq * H, D, 0, D};", "case M_O: return {Nq * H - 64, D, 0, D};"),
    "attention_chunk_dropped": (
        "const float f = expf(cm[g * nch + k] - mx);",
        "const float f = k + 1 < nch ? expf(cm[g * nch + k] - mx) : 0.f;"),
    "int4_scales_swapped": (
        "slo[j] = __ldg(s_lo + j), shi[j] = __ldg(s_hi + j);",
        "slo[j] = __ldg(s_hi + j), shi[j] = __ldg(s_lo + j);"),
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
    first valid slots when B > 2 (left-padded voice prompts), the write slot
    in device memory (int32 [1]), as the graph-replayed decode loop gives it."""
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
                write_slot=torch.tensor([write_slot], **i32), self_k=caches[0],
                self_v=caches[1], cross_k=caches[2],
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
    slots = sum(max(0, int(inp["write_slot"]) - int(v)) for v in inp["valid_from"])
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
                     "S": inp["cross_k"].shape[2], "write_slot": int(inp["write_slot"])},
           "max_abs_err": max(gate["max_abs_err_x_k_v"]), **gate,
           "tol": f"{FUSED_TOL} * (max|ref| + |ref|)",
           "repeat_bit_identical": all(torch.equal(a, b) for a, b in zip(out, again))}
    if not rec["repeat_bit_identical"] or not gate["err_over_tol"] <= 1:
        raise RuntimeError(f"fused_decode_step: kernel disagrees with its plain version: {rec}")
    if time_it:
        nbytes = fused_bytes(pack, inp)
        flops = 2 * B * sum(t.numel() * (2 if int4 and i >= 4 else 1)
                            for i, t in enumerate(pack[:14:2]))  # int4: 2 weights a byte
        b_ms, b_by = bound(nbytes, flops, "bfloat16")  # mma.sync on bf16 x and widened weights
        rec.update({"ms": cuda_ms(torch, lambda: fused_decode_step(pack, **inp), iters=20),
                    "timing": "CUDA events around 20 back-to-back launches",
                    "plain_ms": cuda_ms(torch, lambda: fused_decode_step_plain(pack, **inp),
                                        iters=3, warmup=1),
                    "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "library_ms": None,
                    "library": "none: no single PyTorch call computes a decoder step"})
        # one kernel a step; float caches add the wrapper's two casts of k_new, v_new
        rec["kernels_per_call"] = kernels_per_call(torch, lambda: fused_decode_step(pack, **inp))
        if rec["kernels_per_call"] != (1 if kind == "int8" else 3):
            raise RuntimeError(f"fused_decode_step: {rec['kernels_per_call']} kernels a call")
    emit(rec)
    return rec


def fused_rows(torch, inp, rows) -> dict:
    """The step inputs of the listed rows only (the write slot is every row's)."""
    idx = torch.tensor(rows, device=inp["self_k"].device)
    per_row = ("x_emb", "position", "cross_ends", "valid_from")
    return {k: (v.index_select(0, idx).contiguous() if k in per_row else
                v.index_select(1, idx).contiguous() if isinstance(v, torch.Tensor)
                and k != "write_slot" else v)
            for k, v in inp.items()}


def fused_rows_and_poison_case(torch, pack, kind) -> None:
    """Rows of a 20-row step (ten streams: three of the kernel's n-tiles of 8
    rows) equal the same rows run 2 and 8 at a time, bit for bit; NaN
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
    from dia_tts_prune_tpu_torch.ops.kernels.fused_step import _ARGTYPES, _STATIC

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
        _STATIC.clear()  # the workspace size comes from the fault's own layout
        try:
            gate = fused_gate(fused_decode_step(pack, **inp), ref)
        finally:
            for k, fn in real.items():
                _build._functions[k] = fn
            _STATIC.clear()
        rec = {"phase": "kernels", "kernel": "fused_decode_step", "dtype": "bfloat16",
               "case": f"planted fault {name}", "rejected": gate["err_over_tol"] > 1, **gate}
        emit(rec)
        if not rec["rejected"]:
            raise RuntimeError(f"fused_decode_step: the gate lets a planted fault pass: {rec}")
        ratios.append(gate["err_over_tol"])
    return ratios


def phase_fused_kernels(torch, faults: dict) -> dict:
    """The fused step with int8 and int4-MLP packs, bf16 and int8 caches, at
    B = 2 and B = 8 (and 20 rows for the int8 pack and caches; 66, untimed),
    rows across B, NaN poison, the plain version's own spread and the planted faults;
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
        if not int4:  # 66 rows: two passes of the kernel's 64, the weight streamed twice
            sound.append(fused_case(torch, int4, "int8", 66, pack, time_it=False)["err_over_tol"])
        sp = fused_spread_case(torch, pack, int4)
        spread += [sp["plain_host_vs_card"], sp["plain_2_rows_vs_8_rows"]]
        caught += fused_fault_cases(torch, pack, int4, faults)
        del pack
    emit({"phase": "kernels", "kernel": "fused_decode_step",
          "case": "the gate's margins, as err_over_tol (the gate passes at <= 1)",
          "sound_runs_max": max(sound), "plain_own_spread_max": max(spread),
          "planted_faults_min": min(caught), "planted_faults": len(caught)})
    return picked


MIXED_ENDS = [1, 17, 300, 700, 1537, 2048, 3000, 3071]  # eight self rows, each its own end


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
        # four continuous-batching lanes, each on its own timeline: rows at mixed ends
        mixed = decode_case(torch, "self_B8_mixed_ends", dtype, 8, 3072, 16, 4, 128, MIXED_ENDS)
        mixed8 = decode_int8_case(torch, "self_int8_B8_mixed_ends", dtype, 8, 3072, 16, 4, 128,
                                  MIXED_ENDS, True)
        for ends in ([0, 3071], [1537, 1537]):
            rec8 = decode_int8_case(torch, "self_int8", dtype, 2, 3072, 16, 4, 128, ends, True)
        decode_int8_case(torch, "self_int8_B8", dtype, 8, 3072, 16, 4, 128, [1537] * 8, True)
        decode_int8_case(torch, "cross_S1024_int8", dtype, 2, 1024, 16, 16, 128, [0, 700], False)
        decode_int8_case(torch, "cross_S128_int8", dtype, 2, 128, 16, 16, 128, [0, 61], False)
        for name, (K, N) in GEMV_SHAPES.items():
            for B in (2, 8, 64):  # one stream, four streams, the most rows the kernels take
                r8 = gemv_case(torch, "int8_matmul", dtype, B, K, N)
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
        # int4 bytes 4 and 1 bytes past a 16-byte boundary at the logits width
        for offset in (4, 1):
            gemv_case(torch, "int4_gemv", dtype, 8, 2048, 9252, 128, "halfsplit", time_it=False,
                      offset=offset)
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
                  "decode_attention_mixed_ends": mixed, "decode_attention_int8_mixed_ends": mixed8,
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
    with int8 KV caches; then greedy codes card = CPU up to a near tie
    (``greedy_until_near_tie``)."""
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
    # greedy codes card = CPU up to a near tie, as the fused fixture's: on an
    # H100 trained_small's int4 pack parts at step 236 of 255 by a margin of 0.0013
    rec["greedy"], _ = greedy_until_near_tie(torch, [gpu, cpu], meta["prompt"], seed=meta["seed"])
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

        def loop(params, config, tokens_buf, *args, **kwargs):
            out = real_loop(params, config, tokens_buf, *args, **kwargs)
            bufs.append((tokens_buf.copy(), args[3]))  # rows, first loop row (prefill_step)
            return out

        gen.step_function, gen.decode_loop = (lambda params: step), loop
        try:  # the eager loop: the step reads every step's logits back
            codes = dia.generate_codes(text, temperature=0.0, loop="eager", **kw)
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
            cpu.params, config, tgt.cpu(), position.cpu(), ws.cpu(), host["self"], host["cross"],
            host["ends"], dtype, valid_from=None if valid_from is None else valid_from.cpu())
        shares.append(float((mine.cpu() - ref).abs().max()) / float(ref.abs().max()))
        return ref.to(mine.device)

    for n, fn in (("conditioning", conditioning), ("new_self_cache", new_self_cache),
                  ("run_prefill", run_prefill), ("quantize_cache", quantize_cache),
                  ("step_function", lambda params: step)):
        setattr(gen, n, fn)
    try:  # the eager loop: every step goes on with logits read back from the CPU
        codes = gpu.generate_codes(text, temperature=0.0, loop="eager", **kw)
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


FULL_WIDTH_TEXT = ("[S1] Dia is an open weights text to dialogue model. [S2] You get full "
                   "control over scripts and voices. [S1] Wow. Amazing.")
# the other three streams of the batched path (the first is FULL_WIDTH_TEXT)
BATCHED_TEXTS = ("[S2] Four streams share every weight read. [S1] Do they?",
                 "[S1] Batched serving on a pruned model.", "[S2] The last of the four. [S1] Yes.")


def graph_nodes(torch, graph) -> int:
    """Nodes (kernels, memsets, copies) of a captured ``torch.cuda.CUDAGraph``
    kept with ``keep_graph=True`` (``cuGraphGetNodes``)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {err})")
    return n.value


def step_and_loop_nodes(torch, dia, key, buffers) -> dict:
    """A route's loop split in two on its kept buffers, after its last call:
    the decode step alone (``step_function``; its nodes in a captured graph)
    and the rest of the loop body — CFG, bans, sampling, state machine —
    around a stub step that hands back fixed logits (its nodes, and its
    device ms a step, ``graph_ms``, on a copy of the loop state)."""
    import dia_tts_prune_tpu_torch.generate as gen

    st, cache = buffers.held["state"], buffers.held["self"]
    cross, ends = buffers.held["cross"], buffers.held["ends"]
    dtype = gen.DTYPES[dia.compute_dtype]
    step = gen.step_function(dia.params)

    def one():
        step(dia.params, dia.config, torch.cat([st.prev_tok, st.prev_tok])[:, None],
             (st.t + 1 - st.offsets2)[:, None], st.t.clamp(0, cache.k.shape[2] - 1), cache,
             cross, ends, dtype, valid_from=st.valid_from)

    copy = gen.LoopState(*(t.clone() for t in st))
    d = dia.config
    logits = torch.zeros(2 * copy.caps.shape[0], 1, d.data.channels, d.model.tgt_vocab_size,
                         device=cache.k.device)

    def rest():  # the default generator: graph_ms registers no other
        gen.loop_step(copy, lambda *a, **k: logits, dia.params, d, cache, cross, ends,
                      key[-1].cfg_filter_top_k, None, dtype)

    return {"decode_step_nodes": kernels_per_call(torch, one),
            "loop_nodes": kernels_per_call(torch, rest),
            "loop_device_ms": graph_ms(torch, rest, iters=16, replays=3)}


EAGER_TOKENS = 192  # a route's eager reference: the graph loop's codes must equal it
GRAPH_TOKENS = 512  # a route's timed graph calls
GRAPH_RUNS = 3  # timed graph calls of a route, after the one that captures


def graphed_route(torch, dia, name, run, expect, decode=None, streams=1) -> tuple[dict, list]:
    """One serving route at full width on the CUDA-graph decode loop, each
    call with the launch counts zeroed just before and read just after:
    ``run(loop, steps)`` (one call; returns each stream's codes) first with
    the eager loop at ``EAGER_TOKENS``, then on the graph loop at the same
    length, whose codes must equal the eager ones bit for bit; then at
    ``GRAPH_TOKENS`` once to capture and ``GRAPH_RUNS`` times from the kept
    graph (no capture, codes equal to the capturing call's): ms/step as the
    median and spread of those runs, host (the call's wall time) against
    device (CUDA events around the replays) ms per step, capture seconds,
    graph nodes per step against the decode step's own, peak memory, RTF
    (``decode``: the codec on the first timed run's codes) and, for N
    streams, aggregate tokens/s.  ``expect(counts, stats)`` checks each
    call's kernel launches against the steps its host issued.  Returns the
    record and the graph loop's codes at ``EAGER_TOKENS``."""
    import numpy as np

    from dia_tts_prune_tpu_torch.generate import GRAPH_STEPS, WARMUP_STEPS
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    gen = dia.generator
    total: dict[str, int] = {}

    def call(loop, steps):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = run(loop, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts, stats = launch_counts(), gen.last_stats
        expect(counts, stats)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, wall, stats

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eager, eager_s, eager_stats = call("eager", EAGER_TOKENS)
    graph, _, graph_stats = call(None, EAGER_TOKENS)
    frames = [int(c.shape[0]) for c in eager]
    equal = [bool(np.array_equal(a, b)) for a, b in zip(eager, graph)]
    first, first_s, first_stats = call(None, GRAPH_TOKENS)
    timed = [call(None, GRAPH_TOKENS) for _ in range(GRAPH_RUNS)]
    key, buffers = next(reversed(gen._graphs.items()))  # the key of the timed calls
    nodes = graph_nodes(torch, buffers.graph)
    split = step_and_loop_nodes(torch, dia, key, buffers)
    ms = [1e3 * wall / s.decode_steps for _, wall, s in timed]
    dev_ms = [s.device_ms_per_replayed_step for _, _, s in timed]
    rec = {"phase": "full_width", "path": name, "streams": streams,
           "eager": {"max_tokens": EAGER_TOKENS, "decode_steps": eager_stats.decode_steps,
                     "frames": frames, "ms_per_step": 1e3 * eager_s / eager_stats.decode_steps},
           "graph_codes_equal_eager": equal,
           "graph": {"max_tokens": GRAPH_TOKENS, "decode_steps": timed[0][2].decode_steps,
                     "frames": [int(c.shape[0]) for c in timed[0][0]],
                     "ms_per_step_runs": ms, "ms_per_step": float(np.median(ms)),
                     "ms_per_step_spread": max(ms) - min(ms),
                     "device_ms_per_step_runs": dev_ms,
                     "device_ms_per_step": float(np.median(dev_ms)),
                     "replays": timed[0][2].replays, "graph_steps": GRAPH_STEPS,
                     "replay_launch_ms": [1e3 * s.replay_launch_seconds / s.replays
                                          for _, _, s in timed],
                     "capture_s": {"eager_tokens": graph_stats.capture_seconds,
                                   "graph_tokens": first_stats.capture_seconds},
                     "capturing_call_ms_per_step": 1e3 * first_s / first_stats.decode_steps,
                     "nodes_per_step": nodes / GRAPH_STEPS, **split,
                     "tokens_per_s": [streams * s.decode_steps / wall for _, wall, s in timed]},
           "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
           "memory_allocated_bytes": int(torch.cuda.memory_allocated()),
           "launches": total}
    if decode is not None:
        torch.cuda.synchronize()
        t = time.perf_counter()
        wav = decode(timed[0][0][0])
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t
        finite = bool(np.isfinite(wav).all())
        audio_s = wav.shape[0] / dia.dac_config.sample_rate
        rec["graph"].update({"codec_decode_s": dec_s, "audio_s": audio_s,
                             "waveform_finite": finite,
                             "rtf": audio_s / (timed[0][1] + dec_s)})
        if not finite or wav.shape[0] != timed[0][0][0].shape[0] * dia.dac_config.hop_length:
            raise RuntimeError(f"full-width {name}: bad waveform {rec}")
    emit(rec)
    repeat = all(np.array_equal(a, b) for out, _, _ in timed for a, b in zip(out, first))
    hosted = [s.host_steps for _, _, s in timed]
    if not all(equal) or min(frames) == 0 or not repeat or any(hosted) \
            or graph_stats.host_steps != WARMUP_STEPS + GRAPH_STEPS:
        raise RuntimeError(f"full-width {name}: graph codes differ from the eager loop's, a "
                           f"timed call captured again, or no frames: {rec} (timed calls' host "
                           f"steps {hosted}, codes repeat {repeat})")
    return rec, graph


def phase_full_width(torch) -> dict:
    """Every serving route at full width (``graphed_route``), then the
    offline prune CLI."""
    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_decoder_params

    t0 = time.perf_counter()
    cfg = dia_1_6b_config()
    L = cfg.model.decoder.n_layer
    dac_cfg = DACConfig()
    dac_params = init_dac_decoder_params(dac_cfg, seed=1, device="cuda")

    def new_model():
        return Dia(cfg, seed_weights(torch, cfg), "bfloat16", dac_params=dac_params,
                   dac_config=dac_cfg, device="cuda")

    dia = new_model()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    text = FULL_WIDTH_TEXT
    paths = {}

    def single(model, **kw):
        return lambda loop, n: [model.generate_codes(text, max_tokens=n, loop=loop, **kw)]

    def unfused(gemv=None):
        """Every step: two decode-attention calls a layer, and with packed
        weights the 145 contractions on the GEMV kernel and none on the other."""
        other = {"int8_matmul": "int4_gemv", "int4_gemv": "int8_matmul"}.get(gemv)

        def expect(counts, stats):
            ok = counts["decode_attention"] == 2 * L * stats.host_steps
            if gemv:
                ok &= counts[gemv] == DECODER_GEMVS * stats.host_steps and counts[other] == 0
            if not ok:
                raise RuntimeError(f"full width: expected {2 * L} decode-attention "
                                   f"{f'and {DECODER_GEMVS} {gemv} ' if gemv else ''}launches "
                                   f"in each of {stats.host_steps} host steps: {counts}")
        return expect

    # float weights: greedy, seeded-sampled, voice-prompted
    paths["bf16"], eager_codes = graphed_route(
        torch, dia, "bf16", single(dia, temperature=0.0, seed=0), unfused(),
        decode=dia._decode_waveform)
    paths["sampled"], _ = graphed_route(
        torch, dia, "sampled", single(dia, temperature=1.3, seed=1234), unfused(),
        decode=dia._decode_waveform)
    prompt = eager_codes[0]
    paths["prompted"], _ = graphed_route(
        torch, dia, "prompted", lambda loop, n: [dia.generate_codes(
            "[S2] And it clones voices from a prompt.", max_tokens=prompt.shape[0] + 1 + n,
            temperature=0.0, audio_prompt_codes=prompt, audio_prompt_text=text, loop=loop)],
        unfused())

    # the quantized paths: int8 on the model that just ran (its float decoder
    # kernels are freed), int4 on a fresh one, each alone on the card
    models = [dia]
    del dia
    for name, quantize, gemv in (("int8", lambda d: d.quantize_int8(), "int8_matmul"),
                                 ("int4", lambda d: d.quantize_int4(), "int4_gemv")):
        model = models.pop() if models else new_model()
        t = time.perf_counter()
        quantize(model)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t
        paths[name], _ = graphed_route(torch, model, name, single(model, temperature=0.0, seed=0),
                                       unfused(gemv), decode=model._decode_waveform)
        paths[name]["quantize_s"] = quantize_s
        del model
    paths.update(pruned_paths(torch, new_model(), text))
    paths.update(fused_paths(torch, new_model, text))

    rec = {"phase": "full_width", "config": "dia_1_6b_config() bf16, DACConfig(), seed weights",
           "init_s": init_s, "seconds": time.perf_counter() - t0,
           "paths": {k: {"ms_per_step": v["graph"]["ms_per_step"],
                         "device_ms_per_step": v["graph"]["device_ms_per_step"],
                         "nodes_per_step": v["graph"]["nodes_per_step"]}
                     for k, v in paths.items() if "graph" in v}}
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
    return {"paths": paths}


def fused_paths(torch, new_model, text) -> dict:
    """The fused decode step at full width, each path on a fresh model:
    ``fused_int8`` (``quantize_int8(fused=True)``, int8 caches),
    ``fused_int4`` (``fused_mlp_int4=True``), ``fused_batched`` (the int8
    pack, four greedy streams in one batched run): every host-issued decode
    step launches the fused kernel once and the decode-attention kernel never."""
    out = {}
    texts = [text, "[S2] A second voice. [S1] Yes.", "[S1] Third.", "[S2] And a fourth."]
    for name, int4, streams in (("fused_int8", False, 1), ("fused_int4", True, 1),
                                ("fused_batched", False, 4)):
        dia = new_model()
        t = time.perf_counter()
        dia.quantize_int8(fused=True, fused_mlp_int4=int4)
        torch.cuda.synchronize()
        quantize_s = time.perf_counter() - t
        pack = dia.params["decoder"]["fused_pack"]

        def expect(counts, stats):
            if counts["fused_decode_step"] != stats.host_steps or counts["decode_attention"]:
                raise RuntimeError(f"full-width {name}: expected one fused launch in each of "
                                   f"{stats.host_steps} host steps and no decode-attention "
                                   f"launch: {counts}")

        def run(loop, n, dia=dia, streams=streams):
            if streams == 1:
                return [dia.generate_codes(text, max_tokens=n, temperature=0.0, seed=0,
                                           loop=loop)]
            return dia.generator.generate_tokens_batch(texts, max_tokens=n, temperature=0.0,
                                                       loop=loop)
        out[name], _ = graphed_route(torch, dia, name, run, expect, streams=streams,
                                     decode=dia._decode_waveform if streams == 1 else None)
        out[name].update({"quantize_s": quantize_s, "pack_weight_bytes": pack.weight_bytes()})
        del dia, pack, run
    return out


def pruned_paths(torch, dia, text) -> dict:
    """Pruned serving at full width on a fresh model: (d) ``pruned`` — the
    per-module block ranking at 0.5 with 256 x 256 blocks, ``apply_masks``,
    ``sparsify_block``, the greedy route, whose block-sparse launches must
    equal the count derived from the code; what the global ranking
    (``prune_block_sparse(0.5)``) gives on the same weights, reported only;
    (e) ``batched`` — four greedy streams on the pruned model, each of which
    must equal its single-stream run for every frame on the graph loop, and
    the batched-lane probe (``batch_lane_probe``, eager) on the first lane
    that does not (lane 2 when all do), which must find no differing op; (f)
    ``prune_cli`` — ``offline_prune --prune-mode block`` at 2 + 2 layers,
    ``from_pretrained``, ``sparsify_block``, generate."""
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

    def sparse(streams):
        """8 contractions in each decoder layer and the logits head per step,
        and the cross K/V projections of every layer once a stream (no
        prompt prefill); no GEMV launch."""
        def expect(counts, stats):
            want = (8 * L + 1) * stats.host_steps + 2 * L * streams  # 145 a step at 18 layers
            if counts["block_sparse_matmul"] != want or counts["int8_matmul"] \
                    or counts["int4_gemv"]:
                raise RuntimeError(f"full-width pruned: expected {want} block_sparse_matmul "
                                   f"launches ({stats.host_steps} host steps, {streams} "
                                   f"streams) and no GEMV launches: {counts}")
        return expect

    paths["pruned"], _ = graphed_route(
        torch, dia, "pruned", lambda loop, n: [dia.generate_codes(
            text, max_tokens=n, temperature=0.0, seed=0, loop=loop)], sparse(1),
        decode=dia._decode_waveform)
    paths["pruned"].update({
        "prune_and_pack_s": prune_s, "block_density": density,
        "global_ranking_block_density": global_density,
        "weight_bytes_per_step": step_bytes, "dense_weight_bytes_per_step": dense_bytes,
        "bound_ms_per_step_weights": 1e3 * step_bytes / HBM_BYTES_PER_S,
        "memory_allocated_bytes": allocated})

    texts = [text, *BATCHED_TEXTS]
    paths["batched"], batch = graphed_route(
        torch, dia, "batched", lambda loop, n: dia.generator.generate_tokens_batch(
            texts, max_tokens=n, temperature=0.0, loop=loop), sparse(len(texts)),
        streams=len(texts))
    singles = [dia.generate_codes(t_, max_tokens=EAGER_TOKENS, temperature=0.0) for t_ in texts]

    def same_frames(a, b):
        n = min(a.shape[0], b.shape[0])
        diff = np.flatnonzero((a[:n] != b[:n]).any(axis=1))
        return int(diff[0]) if diff.size else n

    equal = [same_frames(b, s_) for b, s_ in zip(batch, singles)]
    frames = [int(b.shape[0]) for b in batch]
    # the op whose rows first leave the single-stream run, for the first lane
    # that does (lane 2 when all agree)
    lane = next((i for i, (e, f) in enumerate(zip(equal, frames)) if e < f), 2)
    probe = batch_lane_probe(torch, dia, texts, lane)
    rec = {"phase": "full_width", "path": "batched lanes", "loop": "graph",
           "max_tokens": EAGER_TOKENS, "frames": frames, "frames_equal_single_stream": equal,
           "first_differing_op": probe["first_differing_op"] or "none", "probe": probe}
    emit(rec)
    paths["batched"]["lanes"] = rec
    # every lane is its single-stream run, bit for bit: frame for frame on the
    # graph loop, and op for op over the conditioning and the first decode steps
    if min(frames) == 0 or equal != frames or probe["first_differing_op"] is not None:
        raise RuntimeError(f"full-width batched: a lane left its single-stream run: {rec}")
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


# ops the batched-lane probe records: (module, function names); each output
# is compared at a lane's rows between a batched run and its single-stream run
PROBE_OPS = {"dia_tts_prune_tpu_torch.generate": ("encoder_forward", "precompute_cross_cache"),
             "dia_tts_prune_tpu_torch.models.dia": (
                 "rms_norm", "attention", "mlp_block", "_embed_channels", "attention_qkv",
                 "decode_attention", "attention_out", "dense_general", "rope")}
PROBE_STEPS = 40  # decode steps the probe compares op by op (frame 14 + the largest delay)


class _ProbeDone(Exception):
    pass


def batch_lane_probe(torch, dia, texts, lane, steps=PROBE_STEPS, max_tokens=192) -> dict:
    """Lane ``lane`` of a greedy ``generate_tokens_batch(texts)`` against its
    ``generate_codes`` run, op by op: the outputs of the conditioning (each
    encoder layer's norms, attention and MLP, the encoder output, the cross
    K/V) and of the first ``steps`` decode steps (the embedding, each layer's
    norms, projections, attention and MLP outputs, the logits) are recorded in
    both runs, in call order, and the lane's rows compared bit for bit (over
    the common extent where a key axis differs).  Batched conditioning that
    runs once per stream is compared call for call.  Returns the first op
    whose rows differ — None when all agree — with its largest difference,
    and every op that differs."""
    import importlib

    records, phase = [], ["conditioning"]
    originals = []

    def wrap(mod, name):
        fn = getattr(mod, name)

        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            outs = list(out) if isinstance(out, tuple) else [out]
            # the cross K/V are [L, B, S, ...]: their batch axis is 1
            dim = 1 if name == "precompute_cross_cache" else 0
            records.append((name, phase[0], [(t, dim) for t in outs if torch.is_tensor(t)]))
            return out

        originals.append((mod, name, fn))
        setattr(mod, name, recorded)

    gen = importlib.import_module("dia_tts_prune_tpu_torch.generate")
    step_fn = gen.decode_step

    def counted_step(*args, **kwargs):
        n = int(phase[0].split()[-1]) + 1 if phase[0].startswith("step") else 1
        if n > steps:
            raise _ProbeDone
        phase[0] = f"step {n}"
        return step_fn(*args, **kwargs)

    def run(fn):
        records.clear()
        phase[0] = "conditioning"
        try:
            fn()
        except _ProbeDone:
            pass
        return list(records)

    try:
        for mod_name, names in PROBE_OPS.items():
            mod = importlib.import_module(mod_name)
            for name in names:
                wrap(mod, name)
        originals.append((gen, "decode_step", step_fn))
        gen.decode_step = counted_step
        # the eager loop: the records are read as each op runs
        batch = run(lambda: dia.generator.generate_tokens_batch(
            texts, max_tokens=max_tokens, temperature=0.0, loop="eager"))
        single = run(lambda: dia.generate_codes(texts[lane], max_tokens=max_tokens,
                                                temperature=0.0, loop="eager"))
    finally:
        for mod, name, fn in reversed(originals):
            setattr(mod, name, fn)

    N = len(texts)
    cond_b = [r for r in batch if r[1] == "conditioning"]
    cond_s = [r for r in single if r[1] == "conditioning"]
    if len(cond_b) == N * len(cond_s):  # one conditioning per stream: the lane's own
        pairs = list(zip(cond_b[lane * len(cond_s):(lane + 1) * len(cond_s)], cond_s))
        cond_rows = [0, 1]
    elif len(cond_b) == len(cond_s):
        pairs, cond_rows = list(zip(cond_b, cond_s)), [lane, N + lane]
    else:
        raise RuntimeError(f"batched-lane probe: {len(cond_b)} conditioning records against "
                           f"{len(cond_s)}")
    steps_b = [r for r in batch if r[1] != "conditioning"]
    steps_s = [r for r in single if r[1] != "conditioning"]
    if len(steps_b) != len(steps_s):
        raise RuntimeError(f"batched-lane probe: {len(steps_b)} step records against "
                           f"{len(steps_s)}")
    first, differing, compared = None, {}, 0
    calls = {}
    for (rb, rs), rows in ([(p, cond_rows) for p in pairs]
                           + [(p, [lane, N + lane]) for p in zip(steps_b, steps_s)]):
        (name, where, outs_b), (name_s, where_s, outs_s) = rb, rs
        if (name, where) != (name_s, where_s) or len(outs_b) != len(outs_s):
            raise RuntimeError(f"batched-lane probe: {name} at {where} against {name_s} at "
                               f"{where_s}")
        calls[(name, where)] = calls.get((name, where), 0) + 1
        for (tb, dim), (ts, _) in zip(outs_b, outs_s):
            a = tb.index_select(dim, torch.tensor(rows, device=tb.device))
            cut = tuple(slice(0, min(i, j)) for i, j in zip(a.shape, ts.shape))
            a, b = a[cut], ts[cut]
            compared += 1
            if torch.equal(a, b):
                continue
            label = f"{name} ({where}, call {calls[(name, where)]})"
            differing[name] = differing.get(name, 0) + 1
            if first is None:
                first = {"op": label, "max_abs_diff": (a.float() - b.float()).abs().max().item(),
                         "shape": list(a.shape)}
    return {"lane": lane, "steps": steps, "outputs_compared": compared,
            "first_differing_op": first["op"] if first else None, "first_difference": first,
            "differing_ops": differing}


SERVING_TOKENS = 512  # max_new_tokens of the served single-chunk requests
# the four concurrent /generate requests: two greedy, two seeded (another batcher key)
SERVING_SEEDS = ((0.0, 0), (0.0, 0), (1.3, 5), (1.3, 9))
# a long-form request: eight chunks of at most 48 effective characters, two
# batches of four.  A batch's token budget counts its voice prompt's rows (as in
# the JAX package) and random weights never emit EOS, so the first batch's
# chunks are short (one long word each) and the prompted second batch's budget
# (477 rows) outgrows its prompt (320 frames)
LONG_FORM_TEXT = ("[S1] " + " ".join(["Supercalifragilisticexpia"] * 4) + " [S2] Four streams "
                  "share every weight read, and the card runs them in one loop. [S1] Then the "
                  "codec turns each stream's codes into audio. [S2] A second batch follows the "
                  "first, prompted with its audio and text.")


def _post(port: int, path: str, payload: dict, stop_after: int | None = None) -> dict:
    """One request to the server on ``port``: its status, body, seconds to
    the whole response and to its first bytes past a WAV header.
    ``stop_after``: close the connection once that many body bytes came."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.perf_counter()
    conn.request("POST", path, body=json.dumps(payload).encode(),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    body, first = b"", None
    while part := resp.read1(1 << 16):
        body += part
        if first is None and len(body) > 44:
            first = time.perf_counter() - t0
        if stop_after is not None and len(body) >= stop_after:
            break
    conn.close()
    return {"status": resp.status, "body": body, "seconds": time.perf_counter() - t0,
            "first_audio_s": first}


def phase_serving(torch) -> dict:
    """The serving front end at full width (``dia_1_6b_config()``, bf16, seed
    weights; ``DACConfig()`` with the encoder, for the rolling prompt): the
    stdlib HTTP server (``app.make_server``) with a ``DynamicBatcher`` of up
    to 4 streams, on a thread.  The launch counts are zeroed just before
    each group of served requests ((a), (c), (d)) and read just after it,
    before any in-process call: flash and decode attention must have
    launched in each group.
    (a) Four concurrent single-chunk ``/generate`` requests, two greedy and
    two seeded: each response's PCM equals the solo ``Dia.generate`` of the
    request, and two requests shared a group; latencies, aggregate tokens/s,
    captures.  (b) ``generate_tokens_stream`` codes equal
    ``generate_tokens`` on the graph loop at 128- and 20-step segments,
    greedy and seeded.  (c) ``/stream`` on a cold key and again on it warm:
    time to the first PCM byte, captures; the served bytes equal the WAV
    header and PCM of the in-process ``Dia.generate_stream``, whose waveform
    is within WAV_TOL of ``Dia.generate``'s, and the served PCM within
    PCM_LSB_TOL of the offline waveform's; in-process chunks' gaps against
    their audio seconds.  Then a client that leaves after its first chunk,
    and the same request again: the bytes of the first full one.  (d) One
    long-form ``/generate``: ``run_inference``'s two batches, the second
    prompted through ``load_audio`` on the card."""
    import threading

    import numpy as np

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.app import (
        SAMPLE_RATE,
        SILENCE_SEC,
        _wav_bytes,
        _wav_stream_header,
        auto_adjust_chunk_size,
        make_server,
        split_by_words_respecting_special_tokens,
    )
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_params
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dia_tts_prune_tpu_torch.serving import DynamicBatcher

    t0 = time.perf_counter()
    cfg = dia_1_6b_config()
    dac_cfg = DACConfig()
    dia = Dia(cfg, seed_weights(torch, cfg), "bfloat16",
              dac_params=init_dac_params(dac_cfg, seed=1, device="cuda"), dac_config=dac_cfg,
              device="cuda")
    gen, n = dia.generator, SERVING_TOKENS
    # the four clients start together: a quarter second gathers them, where the
    # app's 50 ms default could split a pair on a busy host
    batcher = DynamicBatcher(dia, max_batch=4, max_wait_ms=250.0)
    server = make_server(dia, "127.0.0.1", 0, batcher=batcher)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()
    torch.cuda.synchronize()
    rec = {"phase": "serving", "config": "dia_1_6b_config() bf16, DACConfig() with encoder, "
           "seed weights; DynamicBatcher(max_batch=4, max_wait_ms=250)", "max_new_tokens": n,
           "init_s": time.perf_counter() - t0, "wav_tol": WAV_TOL}

    def pcm16(wav):
        return (np.clip(wav, -1, 1) * 32767).astype(np.int16)

    def lsb(body, wav):  # streamed PCM against the offline waveform, in 16-bit steps
        got = np.frombuffer(body[44:], "<i2").astype(np.int32)
        want = pcm16(wav).astype(np.int32)
        return int(np.abs(got - want).max()) if got.shape == want.shape else None

    def served_kernels(group, counts):
        """Flash attention (the encoder, the prompt prefill) and decode
        attention (the warm-up and captured steps of each new key: a group
        starts on a key no call has captured) launched in a group of served
        requests; the counts zeroed just before the group and read just
        after, before any in-process call."""
        missing = [k for k in ("flash_attention", "decode_attention") if counts[k] <= 0]
        if missing:
            raise RuntimeError(f"serving: the {group} requests never launched {missing}: "
                               f"{counts}")
        return counts

    launched = {}
    try:
        # (a) four concurrent single-chunk /generate requests
        texts = (FULL_WIDTH_TEXT, *BATCHED_TEXTS)
        reqs = [{"text": t, "max_new_tokens": n, "chunk_size": 256, "temperature": temp,
                 "seed": seed} for t, (temp, seed) in zip(texts, SERVING_SEEDS)]
        if any(len(split_by_words_respecting_special_tokens(
                t, auto_adjust_chunk_size(t, 256))) != 1 for t in texts):
            raise RuntimeError("serving: a concurrent request is not a single chunk")
        out = [None] * len(reqs)
        barrier = threading.Barrier(len(reqs))

        def client(i):
            barrier.wait()
            out[i] = _post(port, "/generate", reqs[i])

        reset_launch_counts()
        t = time.perf_counter()
        clients = [threading.Thread(target=client, args=(i,)) for i in range(len(reqs))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        burst_s = time.perf_counter() - t
        launched["generate"] = served_kernels("concurrent /generate", launch_counts())
        stats = dict(batcher.stats)
        solo = [dia.generate(r["text"], max_tokens=n, temperature=r["temperature"],
                             seed=r["seed"]) for r in reqs]
        equal = [o is not None and o["status"] == 200 and o["body"] == _wav_bytes(
            SAMPLE_RATE, pcm16(w)) for o, w in zip(out, solo)]
        rec["generate"] = {
            "requests": len(reqs), "pcm_equal_solo": equal, "batcher_stats": stats,
            "latency_s": [o and o["seconds"] for o in out], "burst_s": burst_s,
            "aggregate_tokens_per_s": len(reqs) * (n - 1) / burst_s,
            "solo_ms_per_step_last": 1e3 * gen.last_stats.wall_seconds / (n - 1)}
        emit({"phase": "serving", "part": "generate", "record": rec["generate"]})
        if not all(equal) or stats["max_group"] < 2:
            raise RuntimeError(f"serving: concurrent /generate responses differ from their solo "
                               f"runs or were not coalesced: {rec['generate']}")

        # (b) streamed codes on the graph loop, in process
        codes = []
        for temp, seed in ((0.0, 0), (1.3, 5)):
            offline = gen.generate_tokens(FULL_WIDTH_TEXT, max_tokens=n, temperature=temp,
                                          seed=seed)
            for seg in (128, 20):
                chunks = list(gen.generate_tokens_stream(
                    FULL_WIDTH_TEXT, segment_steps=seg, max_tokens=n, temperature=temp,
                    seed=seed))
                st = gen.last_stats
                codes.append({"temperature": temp, "segment_steps": seg, "chunks": len(chunks),
                              "equal": bool(np.array_equal(np.concatenate(chunks), offline)),
                              "loop": st.loop, "replays": st.replays,
                              "step_replays": st.step_replays, "captures": st.captures,
                              "capture_s": st.capture_seconds, "host_steps": st.host_steps})
        rec["stream_codes"] = codes
        emit({"phase": "serving", "part": "stream_codes", "record": rec["stream_codes"]})
        if not all(c["equal"] and c["loop"] == "graph" for c in codes):
            raise RuntimeError(f"serving: streamed codes differ from generate_tokens: {codes}")

        # (c) /stream on a cold key and again warm, then a client that leaves after
        # its first chunk and the same request again; a key no call has captured:
        # greedy with another top_p
        stream_req = {"text": FULL_WIDTH_TEXT, "max_new_tokens": n, "temperature": 0.0,
                      "top_p": 0.9, "seed": 0}
        reset_launch_counts()
        cold = _post(port, "/stream", stream_req)
        cold_stats = gen.last_stats
        warm = _post(port, "/stream", stream_req)
        warm_stats = gen.last_stats
        left = _post(port, "/stream", stream_req, stop_after=44 + 2 * 81 * dac_cfg.hop_length)
        again = _post(port, "/stream", stream_req)
        launched["stream"] = served_kernels("stream", launch_counts())
        offline = dia.generate(FULL_WIDTH_TEXT, max_tokens=n, temperature=0.0, top_p=0.9)
        t = time.perf_counter()
        marks, chunks = [], []
        for chunk in dia.generate_stream(FULL_WIDTH_TEXT, max_tokens=n, temperature=0.0,
                                         top_p=0.9, seed=0):
            marks.append(time.perf_counter() - t)
            chunks.append(chunk)
        streamed = np.concatenate(chunks)
        wav_err = (float(np.abs(streamed - offline).max()) if streamed.shape == offline.shape
                   else None)
        lsb_diff = {"cold_key": lsb(cold["body"], offline), "warm_key": lsb(warm["body"], offline)}
        rec["stream"] = {
            "first_audio_s": {"cold_key": cold["first_audio_s"], "warm_key": warm["first_audio_s"],
                              "in_process_warm": marks[0]},
            "request_s": {"cold_key": cold["seconds"], "warm_key": warm["seconds"]},
            "captures": {"cold_key": cold_stats.captures, "warm_key": warm_stats.captures},
            "capture_s": {"cold_key": cold_stats.capture_seconds,
                          "warm_key": warm_stats.capture_seconds},
            "chunks": len(chunks), "chunk_gap_s": np.diff(marks).tolist(),
            "chunk_audio_s": [c.shape[0] / SAMPLE_RATE for c in chunks],
            "wav_max_abs_diff_offline": wav_err,
            "pcm_max_lsb_diff_offline": lsb_diff, "pcm_lsb_tol": PCM_LSB_TOL,
            "served_bytes_equal_in_process": cold["body"] == _wav_stream_header(SAMPLE_RATE)
            + pcm16(streamed).tobytes(),
            "warm_bytes_equal_cold": cold["body"] == warm["body"]}
        emit({"phase": "serving", "part": "stream", "record": rec["stream"]})
        if cold["status"] != 200 or wav_err is None or wav_err > WAV_TOL \
                or not rec["stream"]["served_bytes_equal_in_process"] \
                or not rec["stream"]["warm_bytes_equal_cold"] \
                or any(v is None or v > PCM_LSB_TOL for v in lsb_diff.values()):
            raise RuntimeError(f"serving: /stream disagrees with the offline waveform: "
                               f"{rec['stream']}")
        rec["disconnect"] = {"bytes_read_before_leaving": len(left["body"]),
                             "again_equals_first": again["body"] == cold["body"],
                             "again_s": again["seconds"]}
        emit({"phase": "serving", "part": "disconnect", "record": rec["disconnect"]})
        if not rec["disconnect"]["again_equals_first"]:
            raise RuntimeError(f"serving: the request after a disconnect differs: "
                               f"{rec['disconnect']}")

        # (d) one long-form request: run_inference's two batches, the second prompted
        calls = {"load_audio": 0, "generate": []}
        load_audio, generate = dia.load_audio, dia.generate

        def counted_load(path):
            calls["load_audio"] += 1
            return load_audio(path)

        def recorded_generate(text, **kw):
            wav = generate(text, **kw)
            calls["generate"].append(None if wav is None else int(wav.shape[0]))
            return wav

        dia.load_audio, dia.generate = counted_load, recorded_generate
        reset_launch_counts()
        try:
            long = _post(port, "/generate", {"text": LONG_FORM_TEXT, "max_new_tokens": 128,
                                             "temperature": 0.0, "seed": 0})
        finally:
            del dia.load_audio, dia.generate
        launched["long_form"] = served_kernels("long_form", launch_counts())
        parts = calls["generate"]
        samples = (len(long["body"]) - 44) // 2
        rec["long_form"] = {"status": long["status"], "seconds": long["seconds"],
                            "load_audio_calls": calls["load_audio"], "batch_samples": parts,
                            "samples": samples}
        emit({"phase": "serving", "part": "long_form", "record": rec["long_form"]})
        if long["status"] != 200 or calls["load_audio"] != 1 or len(parts) != 2 \
                or None in parts or samples != sum(parts) + int(SAMPLE_RATE * SILENCE_SEC):
            raise RuntimeError(f"serving: the long-form request failed: {rec['long_form']}")
        rec["launches"] = launched
    finally:
        server.shutdown()
        server.server_close()
        batcher.shutdown()
    rec["seconds"] = time.perf_counter() - t0
    emit({k: v for k, v in rec.items() if k in ("phase", "config", "max_new_tokens", "init_s",
                                                 "wav_tol", "launches", "seconds")})
    del dia, gen, batcher, server
    torch.cuda.empty_cache()
    return rec


CB_TOKENS = 256  # the continuous batcher's max_tokens (its self-cache length)
CB_PROMPT_FRAMES = 100  # the voice-prompted request's prompt: codes from a numpy seed
# the cbatch phase's six requests: (text, max_tokens, temperature, top_p, cfg_scale, seed,
# voice-prompted); the first four fill the four lanes, the last two queue behind them
CB_REQUESTS = ((FULL_WIDTH_TEXT, CB_TOKENS, 0.0, 0.95, 3.0, 0, False),
               (BATCHED_TEXTS[0], 96, 0.0, 0.95, 3.0, 1, False),  # the shorter cap
               (BATCHED_TEXTS[1], CB_TOKENS, 1.3, 0.95, 3.0, 5, False),
               (BATCHED_TEXTS[2], CB_TOKENS, 1.1, 0.9, 2.5, 9, True),
               (BATCHED_TEXTS[1], CB_TOKENS, 0.0, 0.95, 3.0, 2, False),
               (FULL_WIDTH_TEXT, CB_TOKENS, 0.9, 0.8, 4.0, 13, False))


def phase_cbatch(torch) -> dict:
    """Continuous batching at full width (``dia_1_6b_config()``, bf16, seed
    weights, ``DACConfig()``): ``ContinuousBatcher(n_slots=4,
    segment_steps=64, max_tokens=256, text_window=256)``, a fresh batcher a
    group, each built inside its group's launch count (its warm-up and
    capture are the decode steps the host issues; segments are replays).
    (a) The six ``CB_REQUESTS`` in two waves, the second after the first
    segment: three greedy, three seeded with their own temperature, top_p and
    cfg_scale, one voice-prompted, one with a shorter cap so that a queued
    request swaps in mid-run; each lane's codes equal its solo graph-loop
    ``generate_tokens`` bit for bit.  (c) A running lane cancelled: the
    queued request that takes its slot equals its solo run, as do the
    others.  (d) The HTTP app with a batcher: two concurrent ``/generate``
    whose PCM equals their solo waveforms, one ``/stream`` whose bytes equal
    the in-process ``generate_stream``'s.  (b) After ``quantize_int8()``,
    int8 KV caches: a greedy and a seeded lane equal their solo runs.  One
    capture a batcher; flash and decode attention launched in each group,
    ``int8_matmul`` in (b).  Recorded: capture seconds, device and host ms a
    step with four live lanes, aggregate tokens/s, admission delay, request
    latencies, occupancy, graph nodes a step, and beside them the same
    width in lockstep (``generate_tokens_batch``, four streams) and one
    stream alone."""
    import threading

    import numpy as np

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.app import SAMPLE_RATE, _wav_bytes, _wav_stream_header, make_server
    from dia_tts_prune_tpu_torch.cbatch import ContinuousBatcher
    from dia_tts_prune_tpu_torch.generate import GRAPH_STEPS
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_decoder_params
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    cfg = dia_1_6b_config()
    dac_cfg = DACConfig()
    dia = Dia(cfg, seed_weights(torch, cfg), "bfloat16",
              dac_params=init_dac_decoder_params(dac_cfg, seed=1, device="cuda"),
              dac_config=dac_cfg, device="cuda")
    max_delay = cfg.data.max_delay
    prompt = np.random.default_rng(3).integers(0, 1024, (CB_PROMPT_FRAMES, cfg.data.channels))
    prompt_text = "[S1] A voice to follow, its codes from a seed."
    shape = dict(n_slots=4, segment_steps=64, max_tokens=CB_TOKENS, text_window=256)
    rec = {"phase": "cbatch", "config": "dia_1_6b_config() bf16, DACConfig(), seed weights; "
           f"ContinuousBatcher({', '.join(f'{k}={v}' for k, v in shape.items())})"}

    def kwargs(r):
        text, mt, temp, top_p, cfg_scale, seed, prompted = r
        return dict(max_tokens=mt, temperature=temp, top_p=top_p, cfg_scale=cfg_scale, seed=seed,
                    audio_prompt_codes=prompt if prompted else None,
                    audio_prompt_text=prompt_text if prompted else None)

    def solo_codes(requests):
        return [dia.generator.generate_tokens(r[0], **kwargs(r)) for r in requests]

    def step_ms(stats):  # a graph-loop call's device and host ms a step
        return {"device_ms_per_step": stats.device_ms_per_replayed_step,
                "host_ms_per_step": 1e3 * stats.wall_seconds / stats.decode_steps}

    def new_batcher(n_slots=4):
        reset_launch_counts()
        cb = ContinuousBatcher(dia, **{**shape, "n_slots": n_slots})
        if cb.stats["captures"] != 1 or cb.loop != "graph":
            raise RuntimeError(f"cbatch: a batcher captured {cb.stats['captures']} graphs "
                               f"on the {cb.loop} loop")
        return cb

    def submit(cb, r, times):
        t = time.perf_counter()
        fut = cb.submit(r[0], **kwargs(r))
        fut.add_done_callback(lambda f: times.append(time.perf_counter() - t))
        return fut

    def wait_segments(cb, n):
        while cb.stats["segments"] < n:
            time.sleep(0.005)

    def report(group, cb, futs, solo, wall, need, **extra):
        counts = launch_counts()
        outs = [f.result() if not f.cancelled() else None for f in futs]
        equal = [o is not None and np.array_equal(o, s) for o, s in zip(outs, solo)
                 if s is not None]
        log = [e for e in cb.segment_log if e[0] == cb.n_slots]
        steps = sum(e[1] for e in log)
        st = dict(cb.stats)
        out = {"lanes_equal_solo": equal, "frames": [None if o is None else int(o.shape[0])
                                                     for o in outs],
               "captures": st["captures"], "capture_s": st["capture_seconds"],
               "full_lanes_host_ms_per_step": 1e3 * sum(e[2] for e in log) / steps if steps
               else None,
               "full_lanes_device_ms_per_step": 1e3 * sum(e[3] for e in log) / steps if steps
               else None,
               "wall_s": wall,
               "aggregate_tokens_per_s": sum(o.shape[0] + max_delay for o in outs
                                             if o is not None) / wall,
               "admission_wait_mean_s": st["admission_wait_s"] / max(1, st["admitted"]),
               "admission_wait_max_s": st["admission_wait_max_s"],
               "occupancy": st["lane_segments_occupied"] / max(1, st["lane_segments_capacity"]),
               "batcher_stats": st, "launches": counts, **extra}
        emit({"phase": "cbatch", "part": group, "record": out})
        missing = [k for k in need if counts[k] <= 0]
        if not all(equal) or missing or st["captures"] != 1 or st["replays"] <= 0:
            raise RuntimeError(f"cbatch {group}: a lane differs from its solo run, a kernel "
                               f"never launched ({missing}), or captures are off: {out}")
        return out

    attention = ("flash_attention", "decode_attention")
    solo = solo_codes(CB_REQUESTS)
    solo_codes(CB_REQUESTS[5:])  # again, from its kept graph: one seeded stream's step
    solo_step = step_ms(dia.generator.last_stats)
    # (a) six requests through four lanes, in two waves
    cb = new_batcher()
    times: list = []
    t = time.perf_counter()
    futs = [submit(cb, r, times) for r in CB_REQUESTS[:4]]
    wait_segments(cb, 1)
    futs += [submit(cb, r, times) for r in CB_REQUESTS[4:]]
    for f in futs:
        f.result(600)
    rec["mixed"] = report("mixed", cb, futs, solo, time.perf_counter() - t, attention,
                          latency_s=sorted(times))
    rec["mixed"]["nodes_per_step"] = graph_nodes(torch, cb._buffers.graph) / GRAPH_STEPS
    cb.shutdown()
    # beside the lanes: the same width in lockstep (four streams of one call,
    # the second call of its key) and one stream alone
    texts = [r[0] for r in CB_REQUESTS[:4]]
    for _ in range(2):
        dia.generator.generate_tokens_batch(texts, max_tokens=CB_TOKENS, temperature=0.0)
    rec["mixed"]["lockstep_4_streams"] = {
        **step_ms(dia.generator.last_stats),
        "nodes_per_step": graph_nodes(torch, next(reversed(
            dia.generator._graphs.values())).graph) / GRAPH_STEPS}
    rec["mixed"]["one_seeded_stream"] = solo_step
    emit({"phase": "cbatch", "part": "mixed_beside", "record": {
        k: rec["mixed"][k] for k in ("nodes_per_step", "lockstep_4_streams",
                                     "one_seeded_stream")}})

    # (c) a running lane cancelled; the queued request takes its slot
    cb = new_batcher()
    order = (0, 2, 4, 5, 1)  # four lanes, then the queued one
    t = time.perf_counter()
    futs = [submit(cb, CB_REQUESTS[i], []) for i in order]
    wait_segments(cb, 1)
    cancelled = cb.cancel(futs[2])
    for i, f in enumerate(futs):
        if i != 2:
            f.result(600)
    rec["cancel"] = report("cancel", cb, futs, [solo[i] if k != 2 else None
                                               for k, i in enumerate(order)],
                           time.perf_counter() - t, attention)
    rec["cancel"]["cancel_returned"] = cancelled
    if not cancelled or not futs[2].cancelled() or cb.stats["cancelled"] != 1:
        raise RuntimeError(f"cbatch cancel: the running lane was not cancelled: {rec['cancel']}")
    cb.shutdown()

    # (d) the HTTP app: two concurrent /generate and one /stream
    cb = new_batcher()
    server = make_server(dia, "127.0.0.1", 0, batcher=cb)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def pcm16(wav):
        return (np.clip(wav, -1, 1) * 32767).astype(np.int16)

    def payload(i):
        r = CB_REQUESTS[i]
        return {"text": r[0], "max_new_tokens": r[1], "temperature": r[2], "top_p": r[3],
                "cfg_scale": r[4], "seed": r[5], "chunk_size": 256}

    try:
        served = {}

        def client(name, path, i):
            served[name] = _post(port, path, payload(i))

        t = time.perf_counter()
        clients = [threading.Thread(target=client, args=args)
                   for args in (("g1", "/generate", 1), ("g2", "/generate", 2),
                                ("s0", "/stream", 0))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        wall = time.perf_counter() - t
        counts = launch_counts()
        stats = dict(cb.stats)
        r0 = CB_REQUESTS[0]
        in_process = list(cb.generate_stream(r0[0], **{k: v for k, v in kwargs(r0).items()
                                                       if not k.startswith("audio")}))
        streamed = np.concatenate(in_process)
        offline = {i: dia._decode_waveform(solo[i]) for i in (0, 1, 2)}
        wav_err = (float(np.abs(streamed - offline[0]).max())
                   if streamed.shape == offline[0].shape else None)
        rec["http"] = {
            "status": {k: v["status"] for k, v in served.items()},
            "generate_pcm_equal_solo": [served[k]["body"] == _wav_bytes(SAMPLE_RATE,
                                                                        pcm16(offline[i]))
                                        for k, i in (("g1", 1), ("g2", 2))],
            "stream_bytes_equal_in_process": served["s0"]["body"] == _wav_stream_header(
                SAMPLE_RATE) + pcm16(streamed).tobytes(),
            "stream_wav_max_abs_diff_offline": wav_err, "wav_tol": WAV_TOL,
            "latency_s": {k: v["seconds"] for k, v in served.items()},
            "stream_first_audio_s": served["s0"]["first_audio_s"], "wall_s": wall,
            "batcher_stats": stats, "launches": counts}
        emit({"phase": "cbatch", "part": "http", "record": rec["http"]})
        h = rec["http"]
        if any(v != 200 for v in h["status"].values()) or not all(h["generate_pcm_equal_solo"]) \
                or not h["stream_bytes_equal_in_process"] or wav_err is None \
                or wav_err > WAV_TOL or stats["captures"] != 1 \
                or any(counts[k] <= 0 for k in attention):
            raise RuntimeError(f"cbatch http: served audio differs or a kernel never "
                               f"launched: {h}")
    finally:
        server.shutdown()
        server.server_close()
        cb.shutdown()
    del cb, server
    torch.cuda.empty_cache()

    # (b) int8 weights and KV caches: a greedy and a seeded lane
    dia.quantize_int8()
    pair = (CB_REQUESTS[0], CB_REQUESTS[2])
    solo8 = solo_codes(pair)
    cb = new_batcher(n_slots=2)
    t = time.perf_counter()
    futs = [submit(cb, r, []) for r in pair]
    for f in futs:
        f.result(600)
    rec["int8"] = report("int8", cb, futs, solo8, time.perf_counter() - t,
                         attention + ("int8_matmul",))
    rec["int8"]["kv_int8"] = cb.kv_int8
    cb.shutdown()
    if not cb.kv_int8:
        raise RuntimeError("cbatch int8: the batcher's caches are not int8")
    rec["seconds"] = time.perf_counter() - t0
    emit({k: v for k, v in rec.items() if k in ("phase", "config", "seconds")})
    del dia, cb
    torch.cuda.empty_cache()
    return rec


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

    def lap(name):  # each phase's seconds, on stderr
        print(f"# chip_smoke {name} done at {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)

    faults = phase_build()
    lap("build")
    picked = phase_kernels(torch, faults) if wanted("kernels") else None
    lap("kernels")
    if wanted("fixtures"):
        phase_fixtures(torch, repo)
        phase_train_fixture(torch, repo)
        lap("fixtures")
    full = phase_full_width(torch) if wanted("full_width") else None
    lap("full_width")
    if wanted("serving"):
        phase_serving(torch)
        lap("serving")
    if wanted("cbatch"):
        phase_cbatch(torch)
        lap("cbatch")
    if wanted("training"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            training = phase_training(torch, Path(tmp))
        lap("training")
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
