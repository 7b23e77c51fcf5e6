#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dia_tts_prune_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card).  Naming phases (``python3 chip_smoke.py kernels training``) runs the
build and only those, for work on one of them, and prints no result line.  Phases, each printing one JSON line; any failure raises and the
script exits non-zero:

1. build     — compile every CUDA kernel from ``dia_tts_prune_tpu_torch/csrc``
               and the planted-fault copies of the fused step (one nvcc per
               source) and the native audio libraries of
               ``dia_tts_prune_tpu_torch/native`` (one g++ each; the libav
               shim where the FFmpeg libraries are), all at once, and report
               g++'s seconds and the registers and spills of
               the flash, block-sparse, decode-attention, bf16 int8-matmul,
               int4-GEMV, fused-step and dense-rows kernels (``nvcc -Xptxas
               -v``);
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
               decode kernel's window form (B = 2 cache rows x W = 8 query
               rows, T = 3072, ends 1537-1544: bit-equal to eight one-query
               calls, SDPA on the same masked window); the two kernels of the
               port's own (no Pallas counterpart): ``dense_rows`` (bf16 and
               fp32 at the five decode shapes, 2, 8, 64, 80 and 130 rows,
               beside cuBLAS at those rows and padded to 64-row groups; odd
               shapes, unaligned weights) and ``rms_norm`` (D = 2048 and
               1024 at 2, 64 and 2048 rows, beside the ATen composition and
               ``F.rms_norm``); a row-bits probe (the same bf16 rows 130 at
               once and 128, 80, 64, 16, 2 and 1 at a time through
               ``dense_rows``, ``rms_norm``, the int8 matmul, the int4 GEMV
               and the block-sparse matmul: bit-equal, or not, per op; the
               first two must be); the
               three training kernels (flash forward with log-sum-exp,
               dK/dV, dQ) at the three attention
               shapes of a Dia-1.6B training step, decoder self-attention at
               one rank's shape under a two-rank mesh (B 1, 8/2 heads), and
               odd ones (ragged
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
               at every step (the packed, fused and pruned fixtures' CPU
               sides run in worker processes while the kernels build);
               then a few
               full, LoRA and QAT-int8 optimizer steps on ``trained_small``,
               the loss after each step on the card against the CPU run;
4. full_width — Dia-1.6B shapes in bf16 and the 44.1 kHz DAC with weights
               from a numpy seed, every serving route on the CUDA-graph
               decode loop (``graphed_route``; each call with the launch
               counts zeroed just before and read just after; every norm on
               the norm kernel, every float contraction of a step on the
               dense-rows kernel, every packed one on its GEMV kernel): an eager
               reference call at 96 tokens whose codes the graph loop must
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
               ``generate_stream``'s; 40 bf16 lanes (80 rows a step): the
               first, middle and last equal their solo runs; 33 int8 lanes:
               the last equals its solo run (ms a step, tokens/s, graph
               nodes a step);
7. files     — the files a user brings to the model and takes away, at
               the same full width, four layers a stack (``FILES_LAYERS``,
               ``Dia.random_init`` weights): a torch
               DAC checkpoint with weight norm (``dac.pth``) through
               ``Dia.load_dac`` — the checkpoint's own weights (g·v/‖v‖,
               within 2 ulp of the original params) and their decode, codes
               equal to the original params' —; a model directory (a bf16
               ``pytorch_model.bin``) and a LoRA adapter; a FLAC voice
               prompt written and read back equal as 16-bit PCM; the
               committed mp3 prompt (``tests/fixtures/torch_mp3_prompt``)
               through the port's mp3dec within 1 LSB of its record; the
               generation CLI in a subprocess with ``--dac-checkpoint``,
               ``--adapter-path`` and the mp3 ``--audio-prompt``, its WAV
               within PCM_LSB_TOL of the same call made in process, flash
               and decode attention launched in it; the prompt cache (a
               second ``load_audio`` of the FLAC and of the mp3 prompt
               encodes nothing); where the libav shim built, .ogg and .mp3
               outputs written and read back; three ``datagen``
               samples read back and encoded by ``data.FineTuneDataset``;
8. speculative — speculative decoding at the same full width
               (``Dia.generate_codes(speculative=W, spec_draft_layers=Ld)``,
               256 tokens, each window one CUDA graph replay; the launch
               counts zeroed before each call and read after it, one-query
               decode attention exactly the loop's host steps' and the
               host-issued drafts', the window form the host-issued verify
               and q passes'): (a) W = 8, Ld = 6 greedy codes equal the
               graphed loop's bit for bit, a second call captures nothing,
               eager speculation equals graphed; (b) Ld = 18: equal, alpha 1.0;
               (f) W = 40 (80 verify rows), Ld = 18: equal, alpha 1.0;
               (e) seeded sampled: codes in range, a seed repeats; (c) a
               voice prompt, W = 6: equal; (d) ``quantize_int8()`` against
               the int8 loop with float caches: equal.  Device ms of a
               window, the verify pass, a draft step and a full step, the
               loop's ms a step, alpha and the break-even alpha;
9. training  — teacher-forced fine-tuning at the same full width (bf16
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
               generates;
10. tp       — tensor-parallel serving at the same full width on the one
               card (``phase_tp``), at full width and four layers a stack
               (``TP_LAYERS``): (a) two spawned ranks over gloo, float /
               int8 / int4 after ``Dia.shard``, 40 greedy eager tokens each:
               the ranks equal each other and their in-process emulation bit
               for bit, the first 8 steps' logits within TP_LOGIT_TOL of the
               single process's (planted missing all-reduces read above
               it), each rank's kernels launched, ms a step beside the single
               process's; (b) ``ContinuousBatcher(mesh=make_mesh(1, 1))`` over
               NCCL, graphed: two lanes equal the unsharded batcher's bit for
               bit; (c) ``app --tp 1 --continuous-batch`` answers a greedy
               ``/generate`` within PCM_LSB_TOL of (b)'s waveform, ``app --tp
               2`` exits with the parser error naming the one card.  Then
               training under a mesh (``Trainer(mesh=)``), the same two
               ranks after their serving work: (a) fp32 at Dia-1.6B widths,
               2 + 2 layers, two steps each of full, LoRA and QAT-int8 on
               (1, 2) and full FSDP on (2, 1), against one process's steps
               (step 1's loss and grad_norm at the JAX tests' tolerances,
               every updated leaf at 2e-3 / 1e-5 but a 1e-5 share); (d) a
               planted fault (the last decoder layer's MLP input without
               ``model_copy``'s backward all-reduce), which (a) must reject;
               (b) bf16 readings at 2 + 2 layers: LoRA on (1, 2) and full
               FSDP on (2, 1), one step each: the ranks
               equal bit for bit (loss, grad_norm, replicated leaves), the
               loss within TP_TRAIN_BF16_RTOL of one process's, a rank's
               flash launches one process's, wall and device ms, peak memory
               and collectives a step; (c) ``Trainer(mesh=make_mesh(1, 1))``
               over NCCL, one LoRA step at 2 + 2 layers bit for bit the
               Trainer without a mesh, ``finetune --mesh-model 1`` at 2 + 2
               layers writes a model that generates, ``--mesh-model 2``
               exits 2.

Then a ``kernels`` line, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
CUDA is unavailable or the package is not beside this file.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import math
import multiprocessing
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
PHASES = ("kernels", "fixtures", "full_width", "serving", "cbatch", "files", "speculative",
          "training", "tp")


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
                 "decode_attention", "int8_matmul", "int4_gemv", "fused_step", "dense_rows")


def ptxas_report(log: str) -> dict:
    """{kernel<args>: {"registers", "spill_stores", "spill_loads"}} from
    ``nvcc -Xptxas -v`` output: the flash kernels by head dim, the bf16
    block-sparse kernel by tile (rows x columns), load width and slice map,
    the decode kernel at head dim 128 by q and cache type and query heads held,
    the bf16 int8-matmul kernel by n-tiles of 8 rows and weight copy width, the
    bf16 int4 GEMV by n-tiles, layout, copy width and whether scale segments
    may end inside a k-step, the fused step by n-tiles of x a pass, the
    bf16 dense-rows kernel by row tiles of 16 and weight route."""
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
    dr = re.compile(r"Function properties for \S*?dense_rows_wgmma_kernelILi(\d+)ELi(\d+)E")
    types = {"13__nv_bfloat16S1_": "bf16, bf16", "13__nv_bfloat16a": "bf16, int8",
             "ff": "float, float", "fa": "float, int8"}
    for line in log.splitlines():
        if m := dr.search(line):
            route = ("TMA", "8-byte copies, x by TMA", "thread copies")[int(m.group(2))]
            name = f"dense_rows_wgmma_kernel<{m.group(1)} row tiles, {route}>"
            report[name] = {}
        elif m := fs.search(line):
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
    one nvcc each, and the three native audio libraries, one g++ each, all at once;
    returns {fault: library path}.  ``mp3dec`` and ``audioproc`` must build;
    ``audiodec`` builds where the FFmpeg development libraries are, and the line
    says whether it did."""
    from dia_tts_prune_tpu_torch import native
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    gxx = concurrent.futures.ThreadPoolExecutor(1)
    host_libs = gxx.submit(native.build_all)  # g++ beside nvcc
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
    libs = _build.build_all()  # each with its compiler's -Xptxas -v output
    for name, (proc, lib) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"fault {name}: nvcc failed\n{log.decode(errors='replace')}")
    native_libs = host_libs.result()
    gxx.shutdown()
    for name in ("audioproc", "mp3dec"):
        if "error" in native_libs[name]:
            raise RuntimeError(f"native lib{name}: {native_libs[name]['error']}")
    audiodec_error = native_libs["audiodec"].pop("error", None)
    if audiodec_error:  # the first lines of g++'s output say which header or library is missing
        native_libs["audiodec"]["error"] = audiodec_error.splitlines()[:4]
    ptxas = {}
    for name in PTXAS_SOURCES:
        ptxas.update(ptxas_report(libs[name].pop("log")))
    emit({"phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 3),
          "nvcc": _build.nvcc_path(), "libs": libs, "planted_faults": sorted(running),
          "gxx": native.compiler(), "native_libs": native_libs,
          "audiodec_built": audiodec_error is None, "ptxas": ptxas})
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


WINDOW_ENDS = list(range(1537, 1545))  # the verify pass's eight query rows of a cache row


def decode_window_case(torch, dtype, B=2, W=8, T=3072, Nq=16, Nkv=4, H=128) -> dict:
    """The decode kernel's window form (``queries_per_row`` = W; the
    speculative verify pass's self-attention: B cache rows, W query rows
    each, row i ending at ``WINDOW_ENDS[i]``): against its plain version
    (``TOL``), bit-equal to W one-query calls, one launch a call, the same
    bits twice; device, plain and SDPA times on the same masked window; the
    bound from the bytes it must move (q and out once, each cache row's
    slots once for its W query rows)."""
    import torch.nn.functional as F

    from dia_tts_prune_tpu_torch.ops.kernels import decode_attention, decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(9)
    dt = getattr(torch, dtype)
    q = torch.randn(B * W, Nq, H, generator=g, device="cuda").to(dt)
    k = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    v = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    start = torch.zeros(B * W, dtype=torch.int32, device="cuda")
    end = torch.tensor(WINDOW_ENDS[:W] * B, dtype=torch.int32, device="cuda")
    args = (q, k, v, start, end)
    call = lambda: decode_attention(*args, queries_per_row=W)  # noqa: E731
    before = decode_attention.window_launches
    out = call()
    launches = decode_attention.window_launches - before
    errs = check(torch, "decode_attention window", dtype, out,
                 lambda *a: decode_attention_plain(*a, queries_per_row=W), args)
    singles = [decode_attention(q.view(B, W, Nq, H)[:, i].contiguous(), k, v,
                                start.view(B, W)[:, i].contiguous(),
                                end.view(B, W)[:, i].contiguous()) for i in range(W)]
    equal_singles = all(torch.equal(out.view(B, W, Nq, H)[:, i], o) for i, o in enumerate(singles))
    repeatable = torch.equal(call(), out)
    kernel_ms = graph_ms(torch, call)
    eager_ms = cuda_ms(torch, call, iters=100)
    plain_ms = cuda_ms(torch, lambda: decode_attention_plain(*args, queries_per_row=W))
    single_ms = graph_ms(torch, lambda: decode_attention(q[:B].contiguous(), k, v, start[:B],
                                                          end[:B]))
    slots = torch.arange(T, device="cuda")
    mask = (slots[None] >= start[:, None]) & (slots[None] < end[:, None])  # [B·W, T]
    qh = q.view(B, W, Nq, H).transpose(1, 2)  # [B, Nq, W, H]
    kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // Nkv, dim=1) for x in (k, v))
    library_ms = graph_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask.view(B, 1, W, T)))
    e = q.element_size()
    unique = B * max(WINDOW_ENDS[:W])  # the slots a cache row's W queries read, once
    nbytes = e * (2 * B * W * Nq * H + 2 * unique * Nkv * H) + 4 * 2 * B * W
    bound_ms, bound_by = bound(nbytes, 4.0 * H * Nq * B * sum(WINDOW_ENDS[:W]), dtype)
    rec = {"phase": "kernels", "kernel": "decode_attention", "case": "window", "dtype": dtype,
           "form": "window", "shape": {"B": B, "W": W, "T": T, "Nq": Nq, "Nkv": Nkv, "H": H,
                                       "ends": WINDOW_ENDS[:W]},
           **errs, "launches_per_call": launches, "repeatable": repeatable,
           "equal_to_single_calls": equal_singles, "ms": kernel_ms, "eager_ms": eager_ms,
           "plain_ms": plain_ms, "single_query_call_ms": single_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "launches": launches}
    emit(rec)
    if launches != 1 or not repeatable or not equal_singles:
        raise RuntimeError(f"decode_attention window {dtype}: launches, repeatability or "
                           f"equality with one-query calls are off: {rec}")
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


# each count of rows against 130 at once: one row, a decode step's, the W = 8
# verify pass's, the int8 matmul's 64-row group, 40 lanes', the dense-rows
# kernel's 128-row group (and two groups at 130)
PROBE_ROWS = (1, 2, 16, 64, 80, 128, 130)
PROBE_SHAPES = {"attn_2048x2048": (2048, 2048), "mlp_wi_2048x16384": (2048, 16384),
                "mlp_wo_8192x2048": (8192, 2048), "logits_2048x9252": (2048, 9252)}


def row_bits_probe(torch) -> dict:
    """The verify pass and continuous-batching lanes send more rows through
    the ops a decode step sends 2 rows through: do a row's bits depend on the
    row count?  The same bf16 x rows, 130 at once (two groups for the kernels
    that cut rows so), and 128, 80, 64, 16, 2 and one at a time, through ``dense_rows``,
    ``rms_norm`` (width 2048), the int8 matmul, the int4 GEMV (group 128,
    halfsplit: ``quantize_int4()``'s default) and the block-sparse matmul
    (0.5 of 256 x 256 blocks) at the decode step's widths.  The float gates
    of the ``speculative`` and ``cbatch`` phases rest on the first two (the
    script fails if they differ); the int8 routes' gates read the int8
    result."""
    from dia_tts_prune_tpu_torch.ops import quant
    from dia_tts_prune_tpu_torch.ops.kernels import (
        block_sparse_matmul,
        dense_rows,
        int4_gemv,
        int8_matmul,
        rms_norm,
    )

    g = torch.Generator(device="cuda").manual_seed(12)
    dt = torch.bfloat16
    most = PROBE_ROWS[-1]

    def same(fn, x):
        full = fn(x)
        return all(torch.equal(fn(x[r:r + m].contiguous()), full[r:r + m])
                   for m in PROBE_ROWS[:-1] for r in range(0, most, m))

    result: dict = {"rms_norm": {}}
    scale = 1.0 + 0.1 * torch.randn(2048, generator=g, device="cuda")
    result["rms_norm"]["2048"] = same(lambda x: rms_norm(x, scale, 1e-5),
                                      torch.randn(most, 2048, generator=g, device="cuda").to(dt))
    for op in ("dense_rows", "int8_matmul", "int4_gemv", "block_sparse_matmul"):
        result[op] = {}
    for name, (K, N) in PROBE_SHAPES.items():
        w = torch.randn(K, N, generator=g, device="cuda") / K ** 0.5
        x = torch.randn(most, K, generator=g, device="cuda").to(dt)
        wb = w.to(dt)
        result["dense_rows"][name] = same(lambda a: dense_rows(a, wb), x)
        q8 = quant.quantize_int8(w)
        result["int8_matmul"][name] = same(
            lambda a: int8_matmul(a, q8.values, q8.scale.reshape(N)), x)
        q4 = quant.quantize_int4(w, group=128, halfsplit=True)
        result["int4_gemv"][name] = same(
            lambda a: int4_gemv(a, q4.values, q4.scale, q4.layout), x)
        sk = sparse_weight(torch, K, N, 0.5, dt)
        result["block_sparse_matmul"][name] = same(
            lambda a: block_sparse_matmul(a, sk.values, sk.indices, sk.counts, *SPARSE_BLOCK), x)
        del w, wb, q8, q4, sk
    verdict = {op: all(v.values()) for op, v in result.items()}
    emit({"phase": "kernels", "case": "row bits at 1 to 128 rows against 130",
          "dtype": "bfloat16",
          "rows": list(PROBE_ROWS), "equal": result, "all_equal": verdict})
    if not (verdict["dense_rows"] and verdict["rms_norm"]):
        raise RuntimeError(f"row-bits probe: a float op's row depends on the row count: {result}")
    return verdict


# one stream, four streams, the int8 matmul's 64-row group, 40 lanes, two 128-row groups
DENSE_ROWS = (2, 8, 64, 80, 130)


def dense_rows_case(torch, dtype, M, K, N, time_it=True, offset=0) -> dict:
    """``dense_rows`` on a seed-made [K, N] weight against its plain version
    (fp32, same values), within the GEMV gate; bit-identical over two runs;
    bf16 one kernel a call.  Times over copies of the weight that together
    exceed the L2, as a decode step finds them cold; beside it cuBLAS
    (``torch.matmul``, the library call) at the real M and at M padded to
    whole groups of 64 rows (the retired ``fixed_rows_matmul``'s padding).
    ``offset`` > 0: the weight starts that many values into its storage."""
    import importlib

    from dia_tts_prune_tpu_torch.ops.kernels import dense_rows, dense_rows_plain

    dr = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.dense_rows")
    i8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
    g = torch.Generator(device="cuda").manual_seed(13)
    dt = getattr(torch, dtype)
    w = (torch.randn(K, N, generator=g, device="cuda") / K ** 0.5).to(dt)
    if offset:
        w = torch.empty(K * N + offset, dtype=dt, device="cuda")[offset:].view(K, N)
        w.copy_((torch.randn(K, N, generator=g, device="cuda") / K ** 0.5).to(dt))
    x = torch.randn(M, K, generator=g, device="cuda").to(dt)
    before = dense_rows.launches
    out = dense_rows(x, w)
    launches = dense_rows.launches - before
    again = dense_rows(x, w)
    torch.cuda.synchronize()
    ref = dense_rows_plain(x.float(), w.float())
    diff = (out.float() - ref).abs()
    tol = GEMV_SUM_TOL * (x.float().abs() @ w.float().abs()) + TOL[dtype]["rtol"] * ref.abs()
    rec = {"phase": "kernels", "kernel": "dense_rows", "dtype": dtype,
           "shape": {"M": M, "K": K, "N": N}, "max_abs_err": diff.max().item(),
           "max_err_over_tol": (diff / tol).max().item(),
           "tol": {"sum_abs": GEMV_SUM_TOL, "rtol": TOL[dtype]["rtol"]}, "launches": launches,
           "bit_identical_over_two_runs": bool(torch.equal(out, again)),
           "weight_offset_values": offset}
    if dtype == "bfloat16":
        route = dr.weight_route(N, w.data_ptr())
        x_tma = dr.x_by_tma(K, x.data_ptr())
        if route == dr.TMA and not x_tma:
            route = 8
        rec["route"] = "wgmma_bf16"
        rec["plan"] = {"weight": "tma" if route == dr.TMA else f"copies of {route} B",
                       "x": "tma" if x_tma and route in (dr.TMA, 8) else "copies",
                       "cluster_slice": list(dr.row_plan(K, N)),
                       "row_groups": -(-M // dr.GROUP_ROWS)}
        rec["kernels_per_call"] = kernels_per_call(torch, lambda: dense_rows(x, w))
    else:
        vec = dr.vector_width(N, w.data_ptr())
        rec["route"] = "fma_fp32"
        rec["plan"] = {"vec": vec, "n_split": i8.split_plan(K, N, vec)}
    ok = (rec["max_err_over_tol"] <= 1.0 and rec["bit_identical_over_two_runs"]
          and launches == 1 and rec.get("kernels_per_call", 1) == 1)
    e = w.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(e * (K * N + M * K + M * N), 2.0 * M * K * N, dtype)
    if time_it:
        n = max(2, min(64, -(-COLD_BYTES // (e * K * N))))
        ws = [w.clone() for _ in range(n)]
        padded = torch.zeros(-(-M // 64) * 64, K, dtype=dt, device="cuda")
        padded[:M] = x
        turn = iter(range(1 << 30))
        rec["ms"] = graph_ms(torch, lambda: dense_rows(x, ws[next(turn) % n]), iters=2 * n)
        rec["eager_ms"] = cuda_ms(torch, lambda: dense_rows(x, ws[next(turn) % n]),
                                  iters=max(32, 2 * n))
        rec["plain_ms"] = cuda_ms(torch, lambda: dense_rows_plain(x, ws[next(turn) % n]),
                                  iters=max(32, 2 * n))
        rec["library_ms"] = graph_ms(torch, lambda: torch.matmul(x, ws[next(turn) % n]),
                                     iters=2 * n)
        rec["library_padded_ms"] = graph_ms(
            torch, lambda: torch.matmul(padded, ws[next(turn) % n]), iters=2 * n)
        rec["library_padded_rows"] = padded.shape[0]
        rec["weight_copies"] = n
        del ws, padded
    emit(rec)
    if not ok:
        raise RuntimeError(f"dense_rows: kernel disagrees with its plain version, is not "
                           f"repeatable or is not one launch: {rec}")
    return rec


def rms_norm_case(torch, dtype, rows, D, time_it=True) -> dict:
    """The RMSNorm kernel on seed-made rows (a bf16 scale, as the model's
    bf16 weights carry) against its plain version in fp32 (``TOL``), bit-
    identical over two runs, one launch; times from graph replays beside
    the plain ATen composition's (graph replays and eager) and one
    ``torch.nn.functional.rms_norm`` call's (the library call)."""
    import torch.nn.functional as F

    from dia_tts_prune_tpu_torch.ops.kernels import rms_norm, rms_norm_plain

    g = torch.Generator(device="cuda").manual_seed(14)
    dt = getattr(torch, dtype)
    x = torch.randn(rows, D, generator=g, device="cuda").to(dt)
    scale = (1.0 + 0.1 * torch.randn(D, generator=g, device="cuda")).to(torch.bfloat16)
    before = rms_norm.launches
    out = rms_norm(x, scale, 1e-5)
    launches = rms_norm.launches - before
    again = rms_norm(x, scale, 1e-5)
    torch.cuda.synchronize()
    rec = {"phase": "kernels", "kernel": "rms_norm", "dtype": dtype,
           "shape": {"rows": rows, "D": D}, "launches": launches,
           "bit_identical_over_two_runs": bool(torch.equal(out, again)),
           **check(torch, "rms_norm", dtype, out, lambda a, s: rms_norm_plain(a, s, 1e-5),
                   (x, scale))}
    e = x.element_size()
    rec["bound_ms"], rec["bound_by"] = bound(2 * e * rows * D + 2 * D, 4.0 * rows * D, dtype)
    if time_it:
        sx = scale.to(dt)
        rec["ms"] = graph_ms(torch, lambda: rms_norm(x, scale, 1e-5))
        rec["eager_ms"] = cuda_ms(torch, lambda: rms_norm(x, scale, 1e-5), iters=64)
        rec["plain_ms"] = cuda_ms(torch, lambda: rms_norm_plain(x, scale, 1e-5), iters=64)
        rec["plain_graph_ms"] = graph_ms(torch, lambda: rms_norm_plain(x, scale, 1e-5))
        rec["plain_kernels_per_call"] = kernels_per_call(
            torch, lambda: rms_norm_plain(x, scale, 1e-5))
        rec["library_ms"] = graph_ms(torch, lambda: F.rms_norm(x, (D,), sx, 1e-5))
    emit(rec)
    if launches != 1 or not rec["bit_identical_over_two_runs"]:
        raise RuntimeError(f"rms_norm: not one launch or not repeatable: {rec}")
    return rec


def phase_row_kernels(torch) -> dict:
    """The two kernels of the port's own (no Pallas counterpart): ``dense_rows``
    at the five decode shapes, bf16 and fp32, at ``DENSE_ROWS`` rows (fp32 at
    130 checked, not timed: the parity fixtures run 2 rows), and odd shapes
    (K not a multiple of 16, N a multiple of 4 or of nothing, a weight that
    starts 8 or 2 bytes past a 16-byte boundary, 130 rows); ``rms_norm``
    at D = 2048 and 1024, at 2, 64 and 2048 rows.  Returns the bf16 records of
    the MLP input projection at 2 rows and of the decoder's norm at 2 rows."""
    for dtype in ("float32", "bfloat16"):
        for name, (K, N) in GEMV_SHAPES.items():
            for M in DENSE_ROWS:
                rec = dense_rows_case(torch, dtype, M, K, N, time_it=dtype == "bfloat16" or M < 130)
                if dtype == "bfloat16" and name == "mlp_wi_2048x16384" and M == 2:
                    dense = rec
        for M, K, N, offset in ((3, 1000, 1027, 0), (3, 40, 7, 0), (130, 1000, 520, 0),
                                (5, 2048, 9252, 4), (5, 1000, 1042, 1)):
            dense_rows_case(torch, dtype, M, K, N, time_it=False, offset=offset)
        for D in (2048, 1024):
            for rows in (2, 64, 2048):
                rec = rms_norm_case(torch, dtype, rows, D)
                if dtype == "bfloat16" and D == 2048 and rows == 2:
                    norm = rec
        rms_norm_case(torch, dtype, 3, 20, time_it=False)
    return {"dense_rows": dense, "rms_norm": norm}


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
        # the speculative verify pass: eight query rows a cache row
        window = decode_window_case(torch, dtype)
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
        # decoder self-attention at one rank's shape under a two-rank mesh (the tp
        # phase's training): half the heads of a (1, 2) mesh, one row of a (2, 1) one
        if dtype == "bfloat16":
            flash_train_case(torch, "rank_decoder_self", dtype, 1, 3072, 3072, 8, 2, 128, True,
                             None, None)
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
                  "decode_attention_window": window,
                  "int8_matmul": mlp8, "int4_gemv": mlp4, **train}
    picked.update(phase_row_kernels(torch))
    picked["row_bits"] = row_bits_probe(torch)
    picked["block_sparse_matmul"] = phase_sparse_kernels(torch)
    picked["fused_decode_step"] = phase_fused_kernels(torch, faults)
    return picked


FIXTURES = ("trained_small", "trained_deep")
# The fixtures' CPU sides run in worker processes, spawned before the build,
# each on HOST_THREADS threads: the small models gain nothing from more (the
# same bits at 2 as at 8, and faster), and nvcc needs the cores.
HOST_WORKERS, HOST_THREADS = 3, 2
HOST_KINDS = ("int8", "int4", "pruned", "fused int8", "fused int4-MLP")


def fixture_host_item(repo: str, name: str, kind: str):
    """One fixture's CPU side (``packed_host``, ``pruned_host`` or
    ``fused_host``), in a worker process: no card, ``HOST_THREADS``."""
    import numpy as np

    sys.path.insert(0, repo)
    import torch

    torch.set_num_threads(HOST_THREADS)
    d = Path(repo) / "tests" / "fixtures" / name
    tokens = np.load(d / "golden.npz")["tokens"]
    meta = json.loads((d / "FIXTURE.json").read_text())
    if kind == "pruned":
        return pruned_host(d, name, meta)
    if kind.startswith("fused"):
        return fused_host(torch, d, kind == "fused int4-MLP", tokens, meta)
    return packed_host(torch, d, kind, tokens, meta)


def fixture_host_runs(pool, repo: Path) -> dict:
    """The CPU sides of the packed, fused and pruned fixtures, the slowest
    part of the fixtures phase, submitted to ``pool`` (worker processes that
    run beside nvcc); the phase runs the card sides against them.
    {(fixture, kind): future}, trained_deep's first (the longest)."""
    return {(name, kind): pool.submit(fixture_host_item, str(repo), name, kind)
            for name in reversed(FIXTURES) for kind in HOST_KINDS}


def phase_fixtures(torch, repo: Path, host: dict) -> None:
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia

    for name in FIXTURES:
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
            packed_fixture(torch, name, mode, meta, host[name, mode])
        for mode in ("fused int8", "fused int4-MLP"):
            fused_fixture(torch, name, mode, meta, host[name, mode])
        pruned_fixture(torch, name, meta, host[name, "pruned"])
    batched_fixture(torch, repo / "tests" / "fixtures" / "trained_small")


def params_to(tree, device):
    """A params tree (tensors and packed kernels) on another device."""
    if isinstance(tree, dict):
        return {k: params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def pruned_host(d, name, meta) -> list:
    """The CPU side of ``pruned_fixture``: the fixture pruned on the CPU
    (``prune_block_sparse(0.5, (32, 64))``) and, on ``trained_small``, shrunk
    (``shrink_heads(0.5)``, ``shrink_ffn(0.5)``), each variant's greedy codes
    on the CPU (plain versions).  [(variant, params, config, block densities
    or None, codes)]."""
    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.prune import shrink_ffn, shrink_heads

    cpu = Dia.from_pretrained(d, compute_dtype="float32", device="cpu")
    base_params, base_cfg = cpu.params, cpu.config
    variants = {"prune_block_sparse(0.5, (32, 64))": lambda dia: dia.prune_block_sparse(
        0.5, (32, 64))}
    if name == "trained_small":
        for shrink in (shrink_heads, shrink_ffn):
            variants[f"{shrink.__name__}(0.5)"] = lambda dia, f=shrink: f(dia.params, dia.config,
                                                                           0.5)
    runs = []
    for variant, make in variants.items():
        cpu = Dia(base_cfg, base_params, "float32", device="cpu")
        made = make(cpu)
        if isinstance(made, tuple):  # a shrink: new params and a new config
            cpu = Dia(made[1], made[0], "float32", device="cpu")
        codes = cpu.generate_codes(meta["prompt"], temperature=0.0, seed=meta["seed"])
        runs.append((variant, cpu.params, cpu.config, made if isinstance(made, dict) else None,
                     codes))
    return runs


def pruned_fixture(torch, name, meta, host: list) -> None:
    """Each pruned or shrunk variant of ``pruned_host`` generates greedy
    tokens on the card (kernels) from the same weights: they must equal the
    CPU's (plain versions)."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts

    for variant, params, config, density, codes in host:
        gpu = Dia(config, params_to(params, "cuda"), "float32", device="cuda")
        n0 = launch_counts()
        card = gpu.generate_codes(meta["prompt"], temperature=0.0, seed=meta["seed"])
        launched = {k: v - n0[k] for k, v in launch_counts().items() if v != n0[k]}
        rec = {"phase": "fixtures", "fixture": name, "variant": variant,
               "greedy_tokens_equal_card_cpu": bool(np.array_equal(card, codes)),
               "frames": int(card.shape[0]), "launches_on_card": launched}
        if density is not None:
            rec["block_density"] = {k: round(v, 4) for k, v in density.items()}
        emit(rec)
        if not rec["greedy_tokens_equal_card_cpu"] or card.shape[0] == 0 or (
                density is not None and launched.get("block_sparse_matmul", 0) <= 0):
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


def packed_teacher_forced(torch, dia, enc, frames, kv_int8) -> tuple:
    """A prompt prefill over the golden ``frames`` (more than 64 rows: the
    matmul route) and then one decode step per frame (the kernels) on
    ``dia``'s device, with float or int8 KV caches: (prefill logits, decode
    logits), both on the CPU."""
    from dia_tts_prune_tpu_torch.generate import CFG_BATCH, conditioning
    from dia_tts_prune_tpu_torch.models import dia as model

    cfg, dev, steps = dia.config, dia.device, frames.shape[0]
    with torch.no_grad():
        cross, padding, ends = conditioning(dia.params, cfg, torch.from_numpy(enc).to(dev),
                                            torch.float32, None)
        tgt = torch.from_numpy(frames).to(dev)[None].expand(CFG_BATCH, -1, -1)
        rows = torch.arange(steps, device=dev)[None].expand(CFG_BATCH, -1)
        cache = model.new_self_cache(dia.params, cfg, CFG_BATCH, 128, torch.float32, dev,
                                     quant=kv_int8)
        pre = model.decoder_prefill(dia.params, cfg, tgt, rows, cross, cache,
                                    torch.ones_like(rows, dtype=torch.int32),
                                    padding.to(torch.int32))
        cache = model.new_self_cache(dia.params, cfg, CFG_BATCH, 128, torch.float32, dev,
                                     quant=kv_int8)
        if kv_int8:
            cross = model.quantize_cache(cross)
        out = [model.decode_step(dia.params, cfg, tgt[:, t - 1:t], rows[:, t:t + 1], t - 1,
                                 cache, cross, ends) for t in range(1, steps)]
    return pre.cpu(), torch.cat(out, dim=1).cpu()


def packed_host(torch, d, mode, tokens, meta, steps=96) -> dict:
    """The CPU side of ``packed_fixture``: the fixture packed once on the
    CPU, its teacher-forced logits over the first ``steps`` golden frames
    with float and with int8 KV caches (plain versions), and its greedy
    trace (``greedy_trace``)."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.tokenizer import encode_cfg_batch

    cpu = Dia.from_pretrained(d, compute_dtype="float32", device="cpu")
    if mode == "int8":
        cpu.quantize_int8()
    else:
        cpu.quantize_int4()
    dd = cpu.config.data
    enc = encode_cfg_batch(meta["prompt"], dd.text_length, dd.text_pad_value)
    frames = np.ascontiguousarray(tokens[:steps]).astype(np.int64)
    return {"params": cpu.params, "config": cpu.config, "enc": enc, "frames": frames,
            "teacher": {kv: packed_teacher_forced(torch, cpu, enc, frames, kv)
                        for kv in (False, True)},
            "greedy": greedy_trace(torch, cpu, meta["prompt"], seed=meta["seed"])}


def packed_fixture(torch, name, mode, meta, host: dict) -> None:
    """The bytes ``packed_host`` packed on the CPU run on the card (kernels)
    teacher-forced, with float and with int8 KV caches, within
    PACKED_LOGIT_TOL of the CPU's logits; then greedy codes card = CPU up to
    a near tie (``greedy_until_near_tie``)."""
    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts

    gpu = Dia(host["config"], params_to(host["params"], "cuda"), "float32", device="cuda")
    rec = {"phase": "fixtures", "fixture": name, "packed": mode,
           "teacher_forced_steps": int(host["frames"].shape[0]),
           "tol_share_of_max_logit": PACKED_LOGIT_TOL}
    for kv_int8 in (False, True):
        n0 = launch_counts()
        pre_g, dec_g = packed_teacher_forced(torch, gpu, host["enc"], host["frames"], kv_int8)
        launched = {k: v - n0[k] for k, v in launch_counts().items()}
        pre_c, dec_c = host["teacher"][kv_int8]
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
    rec["greedy"], _ = greedy_until_near_tie(torch, gpu, host["greedy"], meta["prompt"],
                                             seed=meta["seed"])
    emit(rec)


def greedy_trace(torch, dia, text, **kw) -> tuple:
    """Greedy generation on ``dia`` through the eager loop, keeping the
    loop's raw token rows and the guided logits of every step: (codes, rows,
    the first loop row, the logits)."""
    import dia_tts_prune_tpu_torch.generate as gen
    from dia_tts_prune_tpu_torch.ops.sampling import apply_constraints, cfg_combine

    real_step, real_loop = gen.step_function, gen.decode_loop
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
    return codes, bufs[0][0], bufs[0][1], logs


def greedy_until_near_tie(torch, gpu, host_trace: tuple, text, **kw) -> tuple:
    """Greedy generation on the card's ``gpu`` (``greedy_trace``) against
    ``host_trace``, the CPU's trace of the same text and ``kw``.  Equal rows, or
    rows equal up to the first step where the runs' picks part, with the
    card's margin between the two picks under FUSED_NEAR_TIE there: the runs
    had the same tokens so far, so only summation-order noise can part them,
    and only at a near tie.  Returns (record, the CPU's codes)."""
    import numpy as np

    card, rows_c, first, logs_c = greedy_trace(torch, gpu, text, **kw)
    host, rows_h = host_trace[:2]
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

    def conditioning(params, config, enc_input, dtype, window, group=None):
        host["cross"], host["pad"], host["ends"] = real["conditioning"](
            cpu.params, config, enc_input.cpu(), dtype, window)
        return real["conditioning"](params, config, enc_input, dtype, window, group=group)

    def new_self_cache(params, config, batch, max_len, dtype, device, quant):
        host["self"] = real["new_self_cache"](cpu.params, config, batch, max_len, dtype, "cpu",
                                              quant=quant)
        return real["new_self_cache"](params, config, batch, max_len, dtype, device, quant=quant)

    def run_prefill(params, config, buf, window, offsets, steps, cross, pad, cache, dtype,
                    group=None):
        real["run_prefill"](cpu.params, config, buf, window, offsets, steps, host["cross"],
                            host["pad"], host["self"], dtype)
        return real["run_prefill"](params, config, buf, window, offsets, steps, cross, pad, cache,
                                   dtype, group=group)

    def quantize_cache(cache):
        host["cross"] = real["quantize_cache"](host["cross"])
        return real["quantize_cache"](cache)

    def step(params, config, tgt, position, ws, self_cache, cross_cache, ends, dtype,
             valid_from=None, group=None):
        mine = real["step_function"](params)(params, config, tgt, position, ws, self_cache,
                                             cross_cache, ends, dtype, valid_from=valid_from,
                                             group=group)
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


FUSED_STEPS = 64  # the fused fixture's teacher-forced frames
FUSED_GREEDY = dict(max_tokens=128)  # and its greedy runs


def fused_teacher_forced(torch, dia, enc, frames, kv_int8):
    """One fused decode step per golden frame on ``dia``'s device, on its
    own caches (float or int8): the logits, on the CPU."""
    from dia_tts_prune_tpu_torch.generate import CFG_BATCH, conditioning
    from dia_tts_prune_tpu_torch.models import dia as model

    cfg, dev, steps = dia.config, dia.device, frames.shape[0]
    with torch.no_grad():
        cross, _, ends = conditioning(dia.params, cfg, torch.from_numpy(enc).to(dev),
                                      torch.float32, None)
        tgt = torch.from_numpy(frames).to(dev)[None].expand(CFG_BATCH, -1, -1)
        pos = torch.arange(steps, device=dev)[None].expand(CFG_BATCH, -1)
        cache = model.new_self_cache(dia.params, cfg, CFG_BATCH, 128, torch.float32, dev,
                                     quant=kv_int8)
        if kv_int8:
            cross = model.quantize_cache(cross)
        out = [model.decode_step_fused(dia.params, cfg, tgt[:, t - 1:t], pos[:, t:t + 1], t - 1,
                                       cache, cross, ends) for t in range(1, steps)]
    return torch.cat(out, dim=1).cpu()


def fused_host(torch, d, int4, tokens, meta) -> dict:
    """The CPU side of ``fused_fixture``: ``quantize_int8(fused=True)``
    (``fused_mlp_int4=int4``) on the CPU, the plain version's teacher-forced
    logits with float and int8 caches, and its greedy trace."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.tokenizer import encode_cfg_batch

    cpu = Dia.from_pretrained(d, compute_dtype="float32", device="cpu")
    cpu.quantize_int8(fused=True, fused_mlp_int4=int4)
    dd = cpu.config.data
    enc = encode_cfg_batch(meta["prompt"], dd.text_length, dd.text_pad_value)
    frames = np.ascontiguousarray(tokens[:FUSED_STEPS]).astype(np.int64)
    return {"params": cpu.params, "config": cpu.config, "enc": enc, "frames": frames,
            "teacher": {kv: fused_teacher_forced(torch, cpu, enc, frames, kv)
                        for kv in (False, True)},
            "greedy": greedy_trace(torch, cpu, meta["prompt"], seed=meta["seed"],
                                   **FUSED_GREEDY)}


def fused_fixture(torch, name, mode, meta, host: dict) -> None:
    """The bytes ``fused_host`` packed on the CPU, on the card:
    teacher-forced decode steps (the fused kernel against the plain version,
    each on its own caches, int8 and float) within FUSED_LOGIT_TOL of the
    largest |logit|, one kernel launch a step and no decode-attention
    launch, then greedy tokens card = CPU up to a near tie, and the card's
    logits at every step of a CPU-driven greedy run."""
    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts

    cpu = Dia(host["config"], host["params"], "float32", device="cpu")
    gpu = Dia(cpu.config, params_to(cpu.params, "cuda"), "float32", device="cuda")
    steps = int(host["frames"].shape[0])
    rec = {"phase": "fixtures", "fixture": name, "packed": mode, "teacher_forced_steps": steps - 1,
           "tol_share_of_max_logit": FUSED_LOGIT_TOL}
    for kv_int8 in (False, True):
        n0 = launch_counts()
        dec_g = fused_teacher_forced(torch, gpu, host["enc"], host["frames"], kv_int8)
        launched = {k: v - n0[k] for k, v in launch_counts().items() if v != n0[k]}
        dec_c = host["teacher"][kv_int8]
        key = "kv_int8" if kv_int8 else "kv_float"
        top = float(dec_c.abs().max())
        rec[key] = {"decode_max_abs_diff": float((dec_g - dec_c).abs().max()),
                    "max_abs_logit": top, "launches_on_card": launched}
        if not rec[key]["decode_max_abs_diff"] <= FUSED_LOGIT_TOL * top or launched.get(
                "fused_decode_step") != steps - 1 or launched.get("decode_attention", 0):
            raise RuntimeError(f"fused fixture {name}: card and CPU disagree: {rec}")
    kw = dict(FUSED_GREEDY, seed=meta["seed"])
    rec["greedy"], cpu_codes = greedy_until_near_tie(torch, gpu, host["greedy"], meta["prompt"],
                                                     **kw)
    rec["cpu_driven"] = cpu_driven_greedy(torch, gpu, cpu, meta["prompt"], cpu_codes, **kw)
    emit(rec)


_SEED_WEIGHTS = {}


def seed_host_weights(cfg):
    """Dia-1.6B bf16 weights on the host, ``Dia.random_init(cfg, seed=0,
    compute_dtype="bfloat16", device="cpu")``'s: drawn once (numpy's normals
    for 1.6 G weights take ~30 s) and kept for every phase."""
    from dia_tts_prune_tpu_torch import Dia

    if "host" not in _SEED_WEIGHTS:
        _SEED_WEIGHTS["host"] = Dia.random_init(cfg, seed=0, compute_dtype="bfloat16",
                                                device="cpu").params
    return _SEED_WEIGHTS["host"]


def seed_weights(torch, cfg):
    """Fresh Dia-1.6B bf16 weights on the card: ``seed_host_weights``
    copied there for every model that needs fresh ones."""
    return params_to(seed_host_weights(cfg), "cuda")


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

    top_k = key[-1][1]  # the key ends in Sampling.graph_key(): (greedy, top-k)

    def rest():  # the default generator: graph_ms registers no other
        gen.loop_step(copy, lambda *a, **k: logits, dia.params, d, cache, cross, ends,
                      top_k, None, dtype)

    return {"decode_step_nodes": kernels_per_call(torch, one),
            "loop_nodes": kernels_per_call(torch, rest),
            "loop_device_ms": graph_ms(torch, rest, iters=16, replays=3)}


# a route's eager reference: the graph loop's codes must equal it (192 to PR 16, 128 to
# PR 20, 96 since PR 21: cut for the script's time as its phases grew)
EAGER_TOKENS = 96
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
        """Every step: two decode-attention calls a layer and the step's 3L + 1
        norms on the norm kernel (more for the encoder and prefill); the 145
        contractions on the dense-rows kernel with float weights, on the GEMV
        kernel with packed ones (and none on the other two)."""
        kernel = gemv or "dense_rows"
        others = {"int8_matmul", "int4_gemv", "dense_rows"} - {kernel}

        def expect(counts, stats):
            ok = (counts["decode_attention"] == 2 * L * stats.host_steps
                  and counts["rms_norm"] >= (3 * L + 1) * stats.host_steps
                  and counts[kernel] == DECODER_GEMVS * stats.host_steps
                  and not any(counts[k] for k in others))
            if not ok:
                raise RuntimeError(f"full width: expected {2 * L} decode-attention, "
                                   f"{DECODER_GEMVS} {kernel} and {3 * L + 1} rms_norm launches "
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
        ran = ("flash_attention", "rms_norm", *attention,
               kernel_of.get(name, "dense_rows"))
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
COLD_TOP_K = 30  # the cold /stream key's top-k: every other serving call keeps 35
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
        # greedy with another top-k (the sampling values alone share a key)
        stream_req = {"text": FULL_WIDTH_TEXT, "max_new_tokens": n, "temperature": 0.0,
                      "cfg_filter_top_k": COLD_TOP_K, "seed": 0}
        reset_launch_counts()
        cold = _post(port, "/stream", stream_req)
        cold_stats = gen.last_stats
        warm = _post(port, "/stream", stream_req)
        warm_stats = gen.last_stats
        left = _post(port, "/stream", stream_req, stop_after=44 + 2 * 81 * dac_cfg.hop_length)
        again = _post(port, "/stream", stream_req)
        launched["stream"] = served_kernels("stream", launch_counts())
        offline = dia.generate(FULL_WIDTH_TEXT, max_tokens=n, temperature=0.0,
                               cfg_filter_top_k=COLD_TOP_K)
        t = time.perf_counter()
        marks, chunks = [], []
        for chunk in dia.generate_stream(FULL_WIDTH_TEXT, max_tokens=n, temperature=0.0,
                                         cfg_filter_top_k=COLD_TOP_K, seed=0):
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
CB_MANY = 40  # lanes of the many-lane group: 80 rows a step, past the int8 matmul's 64-row group
CB_MANY_INT8 = 33  # lanes of the int8 many-lane group: 66 rows
CB_MANY_TOKENS = 96  # max_tokens of the many-lane groups' requests
CB_MANY_CHECKED = (0, CB_MANY // 2, CB_MANY - 1)  # lanes held to their solo runs
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
    int8 KV caches: a greedy and a seeded lane equal their solo runs.  (e)
    ``CB_MANY`` = 40 lanes (80 rows a step) at ``CB_MANY_TOKENS``, bf16, one
    greedy request a lane: the first, middle and last lanes equal their solo
    graph-loop runs bit for bit; (f) after ``quantize_int8()``, 33 lanes:
    the last lane (rows 64 and 65, the second group of the GEMV kernels)
    equals its solo run.  One capture a batcher; flash and decode attention
    launched in each group, ``dense_rows`` and ``rms_norm`` in the float
    groups, ``int8_matmul`` in (b) and (f).  Recorded: capture seconds, device and host ms a
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

    def new_batcher(n_slots=4, **kw):
        reset_launch_counts()
        cb = ContinuousBatcher(dia, **{**shape, "n_slots": n_slots, **kw})
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
    floats = attention + ("dense_rows", "rms_norm")

    def many_lanes(group, n, checked):
        """``n`` lanes at once, one greedy request each; the ``checked``
        lanes against their solo graph-loop runs."""
        reqs = [(f"[S{1 + i % 2}] Lane {i} of {n} speaks at once. [S{2 - i % 2}] Yes.",
                 CB_MANY_TOKENS, 0.0, 0.95, 3.0, i, False) for i in range(n)]
        solo_many = {i: dia.generator.generate_tokens(reqs[i][0], **kwargs(reqs[i]))
                     for i in checked}
        cb = new_batcher(n_slots=n, max_tokens=CB_MANY_TOKENS)
        try:
            t = time.perf_counter()
            futs = [submit(cb, r, []) for r in reqs]
            for f in futs:
                f.result(900)
            out = report(group, cb, futs, [solo_many.get(i) for i in range(n)],
                         time.perf_counter() - t,
                         attention + (("int8_matmul",) if cb.kv_int8 else ("dense_rows",
                                                                          "rms_norm")))
            out["lanes"], out["checked_lanes"] = n, list(checked)
            out["nodes_per_step"] = graph_nodes(torch, cb._buffers.graph) / GRAPH_STEPS
            emit({"phase": "cbatch", "part": f"{group}_steps", "record": {
                k: out[k] for k in ("lanes", "checked_lanes", "lanes_equal_solo",
                                    "full_lanes_device_ms_per_step",
                                    "full_lanes_host_ms_per_step", "aggregate_tokens_per_s",
                                    "nodes_per_step")}})
        finally:
            cb.shutdown()
        return out

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
    rec["mixed"] = report("mixed", cb, futs, solo, time.perf_counter() - t, floats,
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

    # (e) 40 float lanes: 80 rows a step
    rec["many"] = many_lanes("many", CB_MANY, CB_MANY_CHECKED)
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
    # (f) 33 int8 lanes: the last lane's rows are the second group of the GEMV kernels
    rec["int8_many"] = many_lanes("int8_many", CB_MANY_INT8, (CB_MANY_INT8 - 1,))
    rec["seconds"] = time.perf_counter() - t0
    emit({k: v for k, v in rec.items() if k in ("phase", "config", "seconds")})
    del dia, cb
    torch.cuda.empty_cache()
    return rec


# the FLAC voice prompt: a greedy run's whole waveform (~1.3 s).  The CLI's --max-tokens
# counts the prompt's rows too: the 2 s mp3 prompt (173 rows) leaves it 83 to generate
# the files phase's model: the seed weights' first FILES_LAYERS layers of each
# stack, every width kept (cut from 12 + 18 for the script's time; what the
# phase checks is files, not depth)
FILES_LAYERS = 4
FILES_PROMPT_TOKENS = 128
FILES_PROMPT_TEXT = "[S1] Dia is an open weights text to dialogue model."
FILES_CLI_TEXT = "[S2] You get full control over scripts and voices. [S1] Wow. Amazing."
FILES_CLI_TOKENS = 256
FILES_DATAGEN = {"num_samples": 3, "max_tokens": 172}
# the committed mp3 voice prompt (2 s, 44.1 kHz mono; tools/make_torch_mp3_fixture.py)
# and its decode by the JAX package's mp3dec: int16 codes, float32 sha256, length, rate
FILES_MP3 = Path(__file__).resolve().parent / "tests" / "fixtures" / "torch_mp3_prompt"
FILES_MP3_TEXT = "[S1] A voice prompt as users send it, in mp3."
MP3_LSB_TOL = 1  # the port's decode against the record, in 16-bit steps


def _weight_norm_state_dict(torch, sd):
    """A plain DAC state dict re-expressed as the published checkpoints store
    it: every conv as ``weight_g`` / ``weight_v``, as ``torch.nn.utils.
    weight_norm`` leaves a conv whose weight it wraps (v = W, g = ‖W‖ over
    every axis but 0)."""
    import numpy as np

    out = {}
    for k, v in sd.items():
        if k.endswith(".weight") and not k.endswith("codebook.weight"):
            base = k[: -len(".weight")]
            out[f"{base}.weight_v"] = torch.from_numpy(v)
            out[f"{base}.weight_g"] = torch.from_numpy(np.sqrt(np.sum(
                v ** 2, axis=tuple(range(1, v.ndim)), keepdims=True)).astype(np.float32))
        else:
            out[k] = torch.from_numpy(v)
    return out


def phase_files(torch, tmp: Path) -> dict:
    """The files a user brings to the model and takes away, at full width
    (``dia_1_6b_config()``'s widths at FILES_LAYERS layers a stack, bf16,
    ``Dia.random_init``'s seed weights; ``DACConfig()``): (1) a torch DAC
    checkpoint — seeded ``init_dac_params``
    exported by ``to_dac_torch_state_dict`` with weight norm on every conv,
    ``dac.pth`` — loaded by ``Dia.load_dac`` on the card: it holds exactly
    the checkpoint's weights g·v/‖v‖ (within 2 ulp of the original params)
    and decodes within WAV_TOL of a codec built from them, and its codes
    equal the original params' on the original decode's waveform; (2) a model directory (config.json, a bf16 ``pytorch_model.bin``
    in the reference key schema) and a LoRA adapter (``q_proj``,
    ``v_proj``, r = 8, seeded non-zero B); (3) a FLAC prompt, a 128-token
    greedy waveform, written by ``write_flac`` and read back equal as int16
    PCM; (3b) the committed mp3 prompt (``FILES_MP3``) decoded by the port's
    mp3dec, built on this host: the recorded length and rate, within
    MP3_LSB_TOL of the recorded int16 PCM at every sample, whether its
    float32 sha256 is the recorded one, and its decode ms; (4) the
    generation CLI in a subprocess, as ``python -m`` runs it, with
    ``--dac-checkpoint``, ``--adapter-path`` and the mp3 ``--audio-prompt``:
    exit 0, its WAV within PCM_LSB_TOL of the same call made here
    (``from_pretrained(..., dac_checkpoint=...)``, ``load_adapter_weights``,
    ``generate``), flash and decode attention launched in it; (5) the
    prompt cache: a second ``load_audio`` of each prompt, FLAC and mp3,
    encodes nothing and gives equal codes; (5b) whether the libav shim
    built here, and only if it did, the FLAC prompt's waveform written as
    .ogg and .mp3 and read back (rate, length, correlation); (6)
    ``datagen``: three samples that ``data.FineTuneDataset`` reads and
    encodes on the card.  The directory is deleted when the phase ends."""
    import hashlib
    import os

    import numpy as np

    import dia_tts_prune_tpu_torch.api as api
    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config, native
    from dia_tts_prune_tpu_torch.checkpoint import to_torch_state_dict
    from dia_tts_prune_tpu_torch.data import FineTuneDataset
    from dia_tts_prune_tpu_torch.datagen import generate_dataset
    from dia_tts_prune_tpu_torch.lora import LoraConfig, init_lora, save_adapter
    from dia_tts_prune_tpu_torch.models.dac import (
        DACConfig,
        convert_dac_torch_state_dict,
        decode_codes,
        encode_audio,
        init_dac_params,
        to_dac_torch_state_dict,
    )
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dia_tts_prune_tpu_torch.utils.audio_io import (
        f32_to_pcm16,
        read_audio,
        read_wav,
        write_audio,
    )
    from dia_tts_prune_tpu_torch.utils.flac import read_flac, write_flac

    t0 = time.perf_counter()
    dac_cfg = DACConfig()
    rec = {"phase": "files", "config": f"dia_1_6b_config() widths, the first {FILES_LAYERS} "
           "layers a stack of Dia.random_init seed 0 in bf16; DACConfig(), init_dac_params "
           "seed 1", "wav_tol": WAV_TOL, "pcm_lsb_tol": PCM_LSB_TOL}
    failures = []

    # (2) the model directory and the adapter, (1) the DAC checkpoint, all on the host
    t = time.perf_counter()
    cfg, host = cut_layers(dia_1_6b_config(), seed_host_weights(dia_1_6b_config()), FILES_LAYERS)
    drawn_s = time.perf_counter() - t
    model_dir, adapter_dir, pth = tmp / "model", tmp / "adapter", tmp / "dac.pth"
    model_dir.mkdir()
    t = time.perf_counter()
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in to_torch_state_dict(host, cfg).items()},
               model_dir / "pytorch_model.bin")
    cfg.save(model_dir / "config.json")
    adapter = init_lora(host, LoraConfig(r=8, alpha=16.0, target_modules=("q_proj", "v_proj")),
                        generator=torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)

    def seeded_b(tree):
        for v in tree.values():
            if "b" in v:
                v["b"] = torch.from_numpy(
                    (0.02 * rng.standard_normal(tuple(v["b"].shape))).astype(np.float32))
            else:
                seeded_b(v)

    seeded_b(adapter["weights"])
    save_adapter(adapter_dir, adapter)
    del adapter
    write_s = time.perf_counter() - t
    t = time.perf_counter()
    plain = to_dac_torch_state_dict(init_dac_params(dac_cfg, seed=1, device="cpu"), dac_cfg)
    wn = _weight_norm_state_dict(torch, plain)
    torch.save({"state_dict": wn}, pth)
    rec["write"] = {"weights_drawn_s": drawn_s, "model_and_adapter_s": write_s,
                    "dac_pth_s": time.perf_counter() - t,
                    "model_bytes": (model_dir / "pytorch_model.bin").stat().st_size,
                    "dac_pth_bytes": pth.stat().st_size}

    t = time.perf_counter()
    dia = Dia.from_pretrained(model_dir, compute_dtype="bfloat16", dac_checkpoint=pth,
                              device="cuda")
    torch.cuda.synchronize()
    rec["write"]["from_pretrained_s"] = time.perf_counter() - t

    # (1) the converted codec.  The checkpoint defines each conv weight as
    # g·v/‖v‖ (torch's weight norm), which in float32 is the original weight
    # up to a rounding: the loaded codec must hold exactly those weights
    # (against a codec built from them here, on the plain-weight path) and
    # decode as that codec does; against the original params it must encode
    # to equal codes.  Its decode is compared with the original params' too,
    # beside the same comparison for the original with one-ulp nudges: a
    # random-weight codec at full width turns such roundings into ~1e-3.
    t = time.perf_counter()
    dia.load_dac(pth)
    torch.cuda.synchronize()
    convert_s = time.perf_counter() - t
    folded = dict(plain)
    for k in plain:
        if f"{k}_g" in wn:  # k = "<conv>.weight"
            g, v = wn[f"{k}_g"].numpy(), wn[f"{k}_v"].numpy()
            norm = np.sqrt(np.sum(v ** 2, axis=tuple(range(1, v.ndim)), keepdims=True))
            folded[k] = (g * v / np.maximum(norm, 1e-12)).astype(np.float32)
    loaded = to_dac_torch_state_dict(dia.dac_params, dac_cfg)
    leaves_equal = loaded.keys() == folded.keys() and all(
        np.array_equal(loaded[k], folded[k]) for k in folded)
    ulps = max(float(np.max(np.abs(folded[k] - plain[k]) / np.spacing(np.abs(plain[k]))))
               for k in plain if k.endswith(".weight"))
    reference = convert_dac_torch_state_dict(folded, dac_cfg, "cuda")
    original = init_dac_params(dac_cfg, seed=1, device="cuda")  # the same draws
    nudge = torch.Generator(device="cuda").manual_seed(6)

    def nudged(tree):  # one ulp toward zero at a seeded 1% of each conv weight
        if isinstance(tree, list):
            return [nudged(v) for v in tree]
        out = {}
        for k, v in tree.items():
            if isinstance(v, (dict, list)):
                out[k] = nudged(v)
            elif k == "weight":
                pick = torch.rand(v.shape, generator=nudge, device=v.device) < 0.01
                out[k] = torch.where(pick, torch.nextafter(v, torch.zeros_like(v)), v)
            else:
                out[k] = v
        return out

    codes = torch.from_numpy(np.random.default_rng(5).integers(
        0, dac_cfg.codebook_size, size=(1, 192, dac_cfg.n_codebooks)).astype(np.int32)).cuda()
    want = decode_codes(original, dac_cfg, codes)
    got = decode_codes(dia.dac_params, dac_cfg, codes)
    dec_err = float((got - decode_codes(reference, dac_cfg, codes)).abs().max())
    enc_want = encode_audio(original, dac_cfg, want)
    enc_diff = int((encode_audio(dia.dac_params, dac_cfg, want) != enc_want).sum())
    rec["dac"] = {"convert_s": convert_s, "leaves_equal_checkpoint_weights": leaves_equal,
                  "max_ulps_from_original": ulps,
                  "decode_max_abs_err_checkpoint_weights": dec_err,
                  "encode_codes_differing_original": enc_diff,
                  "encode_codes": int(enc_want.numel()),
                  "decode_max_abs_diff_original": float((got - want).abs().max()),
                  "decode_max_abs_diff_original_nudged": float(
                      (decode_codes(nudged(original), dac_cfg, codes) - want).abs().max())}
    emit({"phase": "files", "part": "dac", "record": rec["dac"]})
    if not leaves_equal or not ulps <= 2.0 or not dec_err <= WAV_TOL or enc_diff:
        failures.append("dac")
    del original, reference, want, got, plain, wn, folded, loaded

    # (3) a FLAC prompt: a greedy waveform
    prompt_wav = dia.generate(FILES_PROMPT_TEXT, max_tokens=FILES_PROMPT_TOKENS,
                              temperature=0.0)
    prompt = tmp / "prompt.flac"
    write_flac(prompt, prompt_wav, dac_cfg.sample_rate)
    t = time.perf_counter()
    back, sr = read_flac(prompt)
    read_s = time.perf_counter() - t
    pcm = np.round(np.clip(prompt_wav, -1, 1) * 32767.0).astype(np.int16)
    flac_equal = bool(sr == dac_cfg.sample_rate and np.array_equal(
        np.round(back[0] * 32768.0).astype(np.int16), pcm))
    rec["flac"] = {"audio_s": prompt_wav.shape[0] / dac_cfg.sample_rate,
                   "bytes": prompt.stat().st_size, "read_s": read_s, "pcm16_equal": flac_equal}
    emit({"phase": "files", "part": "flac", "record": rec["flac"]})
    if not flac_equal:
        failures.append("flac")

    # (3b) the committed mp3 prompt through the port's mp3dec, against its record
    mp3 = FILES_MP3 / "prompt.mp3"
    record = json.loads((FILES_MP3 / "decoded.json").read_text())
    data = mp3.read_bytes()
    decode_ms = []
    for _ in range(5):
        t = time.perf_counter()
        pcm, sr, bad = native.decode_mp3(data)
        decode_ms.append(1e3 * (time.perf_counter() - t))
    recorded = np.load(FILES_MP3 / "decoded.npz")["pcm16"].astype(np.int32)
    ours = np.clip(np.round(pcm.astype(np.float64) * 32768.0), -32768, 32767).astype(np.int32)
    lsb = int(np.abs(ours - recorded).max()) if ours.shape == recorded.shape else None
    rec["mp3"] = {"bytes": len(data), "audio_s": pcm.shape[0] / sr, "length": int(pcm.shape[0]),
                  "sample_rate": sr, "bad_frames": bad, "max_lsb_diff_record": lsb,
                  "mp3_lsb_tol": MP3_LSB_TOL,
                  "sha256_equal_record": hashlib.sha256(pcm.tobytes()).hexdigest()
                  == record["sha256_float32"],
                  "decode_ms": decode_ms, "decode_ms_median": float(np.median(decode_ms))}
    emit({"phase": "files", "part": "mp3", "record": rec["mp3"]})
    if (pcm.shape[0], sr, bad) != (record["length"], record["sample_rate"], 0) \
            or lsb is None or lsb > MP3_LSB_TOL:
        failures.append("mp3")

    # (5) the prompt cache: the first load_audio encodes, the second does not
    encodes = []
    real_encode = api.encode_audio

    def counted_encode(*a, **kw):
        encodes.append(1)
        return real_encode(*a, **kw)

    api.encode_audio = counted_encode
    rec["cache"] = {}
    try:
        for name, path in (("flac", prompt), ("mp3", mp3)):
            timed, before = [], len(encodes)
            for _ in range(2):
                torch.cuda.synchronize()
                t = time.perf_counter()
                prompt_codes = dia.load_audio(path)
                timed.append((time.perf_counter() - t, len(encodes), prompt_codes))
            rec["cache"][name] = {
                "first_s": timed[0][0], "hit_s": timed[1][0],
                "encodes": [timed[0][1] - before, timed[1][1] - timed[0][1]],
                "prompt_frames": int(timed[0][2].shape[0]),
                "hit_codes_equal": bool(np.array_equal(timed[0][2], timed[1][2]))}
    finally:
        api.encode_audio = real_encode
    emit({"phase": "files", "part": "cache", "record": rec["cache"]})
    if any(c["encodes"] != [1, 0] or not c["hit_codes_equal"] for c in rec["cache"].values()):
        failures.append("cache")

    # (5b) compressed outputs, where the libav shim built on this host
    rec["compressed"] = {"audiodec_built": native.load_audiodec() is not None}
    if rec["compressed"]["audiodec_built"]:
        for ext in (".ogg", ".mp3"):
            t = time.perf_counter()
            write_audio(tmp / f"out{ext}", prompt_wav, dac_cfg.sample_rate)
            write_s = time.perf_counter() - t
            back, sr = read_audio(tmp / f"out{ext}")
            n = min(back.shape[1], prompt_wav.shape[0])
            corr = float(np.corrcoef(back[0, :n], np.clip(prompt_wav[:n], -1, 1))[0, 1])
            rec["compressed"][ext] = {"bytes": (tmp / f"out{ext}").stat().st_size,
                                      "write_s": write_s, "sample_rate": sr,
                                      "length": int(back.shape[1]),
                                      "input_length": int(prompt_wav.shape[0]),
                                      "correlation": corr}
            if sr != dac_cfg.sample_rate or back.shape[1] != prompt_wav.shape[0] \
                    or not np.isfinite(back).all() or not corr > 0.5:
                failures.append(f"compressed {ext}")
    emit({"phase": "files", "part": "compressed", "record": rec["compressed"]})

    # (4) the CLI as users run it, in a subprocess, and the same call here
    out = tmp / "out.wav"
    cli_args = [FILES_CLI_TEXT, "--output", str(out), "--model-path", str(model_dir),
                "--dac-checkpoint", str(pth), "--adapter-path", str(adapter_dir),
                "--audio-prompt", str(mp3), "--audio-prompt-text", FILES_MP3_TEXT,
                "--max-tokens", str(FILES_CLI_TOKENS), "--seed", "7",
                "--compute-dtype", "bfloat16"]
    # ``python -m dia_tts_prune_tpu_torch.cli ARGS``, run by runpy as -m runs
    # it, its launch counts printed as it exits
    runner = ("import json, runpy, sys\n"
              "from dia_tts_prune_tpu_torch.ops.kernels import launch_counts\n"
              "sys.argv = ['dia_tts_prune_tpu_torch.cli', *sys.argv[1:]]\n"
              "try:\n"
              "    runpy.run_module('dia_tts_prune_tpu_torch.cli', run_name='__main__',"
              " alter_sys=True)\n"
              "finally:\n"
              "    print('LAUNCHES ' + json.dumps(launch_counts()), file=sys.stderr, flush=True)\n")
    t = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", runner, *cli_args], capture_output=True,
                          text=True, timeout=600, cwd=str(Path(__file__).resolve().parent),
                          env={**os.environ, "PYTHONUNBUFFERED": "1"})
    cli_s = time.perf_counter() - t
    launched = next((json.loads(line[len("LAUNCHES "):]) for line in proc.stderr.splitlines()
                     if line.startswith("LAUNCHES ")), {})
    dia.load_adapter_weights(adapter_dir)
    reset_launch_counts()
    ref = dia.generate(FILES_CLI_TEXT, max_tokens=FILES_CLI_TOKENS, audio_prompt=str(mp3),
                       audio_prompt_text=FILES_MP3_TEXT, seed=7)
    in_process_launches = launch_counts()
    lsb = None
    if proc.returncode == 0 and out.exists() and ref is not None:
        got, sr = read_wav(out)
        got16 = np.round(got[0] * 32768.0).astype(np.int32)
        want16 = f32_to_pcm16(ref).astype(np.int32)
        lsb = int(np.abs(got16 - want16).max()) if got16.shape == want16.shape else None
    rec["cli"] = {"rc": proc.returncode, "prompt": "mp3", "wall_s": cli_s,
                  "max_lsb_diff_in_process": lsb,
                  "audio_s": None if ref is None else ref.shape[0] / dac_cfg.sample_rate,
                  "launches": launched, "in_process_launches": in_process_launches,
                  "stderr_tail": proc.stderr[-1500:] if proc.returncode else ""}
    emit({"phase": "files", "part": "cli", "record": rec["cli"]})
    if proc.returncode != 0 or lsb is None or lsb > PCM_LSB_TOL or any(
            counts.get(k, 0) <= 0 for counts in (launched, in_process_launches)
            for k in ("flash_attention", "decode_attention")):
        failures.append("cli")
    dia.unload_adapter()

    # (6) datagen: three samples, read back and encoded by the dataset
    data_dir = tmp / "data"
    reset_launch_counts()
    t = time.perf_counter()
    rows = generate_dataset(dia, data_dir, **FILES_DATAGEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    datagen_launches = launch_counts()
    ds = FineTuneDataset(data_dir / "metadata.csv", data_dir / "wavs", dia.config,
                         dia.dac_params, dia.dac_config)
    t = time.perf_counter()
    frames = [None if c is None else int(c.shape[0])
              for c in (ds.encode_item_audio(it) for it in ds.items)]
    encode_s = time.perf_counter() - t
    rec["datagen"] = {"samples": len(rows), "wavs": len(list((data_dir / "wavs").iterdir())),
                      "dataset_items": len(ds.items), "encoded_frames": frames,
                      "s_per_sample": gen_s / max(1, len(rows)), "encode_s": encode_s,
                      "launches": datagen_launches}
    emit({"phase": "files", "part": "datagen", "record": rec["datagen"]})
    if len(rows) != FILES_DATAGEN["num_samples"] or rec["datagen"]["wavs"] != len(rows) \
            or len(ds.items) != len(rows) or None in frames or min(frames) <= 0 \
            or datagen_launches.get("decode_attention", 0) <= 0:
        failures.append("datagen")

    del dia, ds
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    emit({k: v for k, v in rec.items() if k in ("phase", "config", "write", "seconds")})
    if failures:
        raise RuntimeError(f"files: {failures} failed: "
                           f"{ {k: rec.get(k) for k in ('dac', 'flac', 'mp3', 'cache', 'compressed', 'cli', 'datagen')} }")
    return rec


SPEC_TOKENS = 256  # max_tokens of the speculative phase's calls
SPEC_EAGER_TOKENS = 64  # the eager speculative call (Python steps every window)
SPEC_WINDOW, SPEC_DRAFT = 8, 6  # W and Ld: Dia.speculative_generator's defaults at 18 layers
SPEC_WIDE = 40  # the wide greedy window: 80 verify rows, past the int8 matmul's 64-row group
SPEC_PROMPT_FRAMES = 64  # the voice-prompted route's prompt: the loop's first codes
SPEC_PROMPT_TEXT = "[S2] And it clones voices from a prompt."


def spec_timings(torch, dia, W, Ld) -> dict:
    """Device ms (``graph_ms``) on the kept buffers of the last graphed
    speculative call, at cache slot 128: one Ld-layer draft step, one full
    decode step, the W-row verify pass; and the nodes of its window graph."""
    import dia_tts_prune_tpu_torch.generate as gen
    from dia_tts_prune_tpu_torch.models.dia import decode_step

    _, buffers = next(reversed(dia.generator._graphs.items()))
    st, cache = buffers.held["state"], buffers.held["self"]
    cross, ends = buffers.held["cross"], buffers.held["ends"]
    dtype, cfg, params = gen.DTYPES[dia.compute_dtype], dia.config, dia.params
    s = torch.full((1,), 128, dtype=torch.int64, device="cuda")
    rows = st.tokens[0, 100:100 + W].clamp_min(0)  # [W, C]
    one, pos = rows[None, :1].expand(2, 1, -1), (s + 1).expand(2)[:, None]

    def step(n_layers):
        return lambda: decode_step(params, cfg, one, pos, s, cache, cross, ends, dtype,
                                   valid_from=st.valid_from, n_layers=n_layers)

    def verify():
        decode_step(params, cfg, rows[None].expand(2, W, -1), (s + 1 + torch.arange(
            W, device="cuda")).expand(2, W), s, cache, cross, ends, dtype,
            valid_from=st.valid_from)

    return {"draft_step_ms": graph_ms(torch, step(Ld), iters=8, replays=3),
            "full_step_ms": graph_ms(torch, step(None), iters=8, replays=3),
            "verify_ms": graph_ms(torch, verify, iters=8, replays=3),
            "window_graph_nodes": graph_nodes(torch, buffers.windows[(W, Ld)])}


def phase_speculative(torch, row_bits: dict | None) -> dict:
    """Speculative decoding at full width (``dia_1_6b_config()``, bf16, seed
    weights, a two-speaker text, ``SPEC_TOKENS``), each call with the launch
    counts zeroed just before and read just after: (a) float greedy, W = 8,
    Ld = 6: the codes of a capturing and a replaying call equal the graphed
    loop's bit for bit, and eager speculation equals graphed speculation;
    (b) Ld = 18: codes equal, every draft accepted (alpha 1.0); (f) W = 40
    (80 verify rows), Ld = 18: codes equal, alpha 1.0; (e) seeded
    sampled: codes in [0, 1023], one seed twice equal; (c) voice-prompted
    greedy, W = 6: codes equal the prompted loop's; (d) ``quantize_int8()``
    against the int8 loop with float caches (``kv_int8=False``).  The
    one-query decode-attention launches of every call are exactly the loop's
    host steps' and the host-issued windows' draft steps', the window form's
    exactly their verify and (sampled) q passes'.  Records: device ms of a window, of the verify
    pass, of an Ld-layer draft step and of a full step beside the loop's ms
    a step; captures; graph nodes a window; tokens/s; alpha; the break-even
    alpha = (window ms / step ms - 1) / (W - 1); peak memory."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    if row_bits is None:
        row_bits = row_bits_probe(torch)
    cfg = dia_1_6b_config()
    L = cfg.model.decoder.n_layer
    W, Ld = SPEC_WINDOW, SPEC_DRAFT
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    dia = Dia(cfg, seed_weights(torch, cfg), "bfloat16", device="cuda")
    kw = dict(max_tokens=SPEC_TOKENS, temperature=0.0, seed=0)
    total: dict[str, int] = {}

    def counted(fn):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return out, wall, counts

    def spec(window, draft, text=FULL_WIDTH_TEXT, gemv=None, **k):
        """One speculative call; its codes, wall seconds, counts and call stats."""
        gen = dia.speculative_generator(window, draft)
        codes, wall, counts = counted(lambda: dia.generate_codes(
            text, speculative=window, spec_draft_layers=draft, **k))
        call, stats = dict(gen.last_call), dia.generator.last_stats
        hosted = call["windows"] - call["window_replays"] + call["window_captures"]
        # one-query launches: the loop's steps and the drafts; window-form: verify and q passes
        want = 2 * L * stats.host_steps + 2 * hosted * draft * (window - 1)
        want_window = 2 * hosted * (L + (draft if k.get("temperature", 0.0) else 0))
        rec = {"frames": int(codes.shape[0]), "wall_s": wall, "decode_steps": stats.decode_steps,
               "tokens_per_s": stats.decode_steps / wall, "loop_host_steps": stats.host_steps,
               "loop_captures": stats.captures, **call,
               "acceptance": call["accepted_drafts"] / max(call["drafted"], 1),
               "launches": counts, "expected_decode_attention": want,
               "expected_decode_attention_window": want_window}
        if "window_device_ms" in rec:
            ms = rec.pop("window_device_ms")
            rec["window_device_ms_median"] = float(np.median(ms)) if ms else None
        ok = (counts["decode_attention"] == want and counts["flash_attention"] > 0
              and counts["decode_attention_window"] == want_window)
        if gemv:
            ok &= counts[gemv] > 0
        if not ok:
            raise RuntimeError(f"speculative W={window} Ld={draft}: launch counts are off: {rec}")
        return codes, rec

    def loop_call(text=FULL_WIDTH_TEXT, **k):
        codes, wall, counts = counted(lambda: dia.generate_codes(text, **k))
        stats = dia.generator.last_stats
        return codes, {"frames": int(codes.shape[0]), "wall_s": wall,
                       "decode_steps": stats.decode_steps,
                       "ms_per_step": 1e3 * wall / stats.decode_steps,
                       "device_ms_per_step": stats.device_ms_per_replayed_step,
                       "tokens_per_s": stats.decode_steps / wall, "captures": stats.captures,
                       "launches": counts}

    routes, gates = {}, {}
    loop, routes["loop_capture"] = loop_call(**kw)
    loop_again, routes["loop"] = loop_call(**kw)
    gates["loop_repeats"] = bool(np.array_equal(loop, loop_again))

    # (a) W = 8, Ld = 6: the call that captures, the call that replays, eager against graphed
    a1, routes["spec_capture"] = spec(W, Ld, **kw)
    a2, routes["spec"] = spec(W, Ld, **kw)
    short = dict(kw, max_tokens=SPEC_EAGER_TOKENS)
    eager, routes["spec_eager"] = spec(W, Ld, loop="eager", **short)
    graphed, routes["spec_short"] = spec(W, Ld, **short)
    timings = spec_timings(torch, dia, W, Ld)
    gates["a_capture_equals_loop"] = bool(np.array_equal(a1, loop))
    gates["a_equals_loop"] = bool(np.array_equal(a2, loop))
    gates["a_eager_equals_graph"] = bool(np.array_equal(eager, graphed))
    gates["a_second_call_captures_nothing"] = (routes["spec"]["window_captures"] == 0
                                               and routes["spec"]["loop_captures"] == 0
                                               and routes["spec"]["loop_host_steps"] == 0)
    # (b) the full model as the draft
    b, routes["spec_full_draft"] = spec(W, L, **kw)
    gates["b_equals_loop"] = bool(np.array_equal(b, loop))
    gates["b_alpha_is_1"] = routes["spec_full_draft"]["acceptance"] == 1.0
    # (f) W = 40 with the full model as the draft: every verify pass 80 rows
    f, routes["spec_wide"] = spec(SPEC_WIDE, L, **kw)
    gates["f_wide_equals_loop"] = bool(np.array_equal(f, loop))
    gates["f_wide_alpha_is_1"] = routes["spec_wide"]["acceptance"] == 1.0
    gates["f_wide_windows_ran"] = routes["spec_wide"]["windows"] > 0
    # (e) seeded sampled, one seed twice
    sampled = dict(kw, temperature=1.3, seed=5)
    e1, routes["spec_sampled"] = spec(W, Ld, **sampled)
    e2, routes["spec_sampled_again"] = spec(W, Ld, **sampled)
    gates["e_seed_repeats"] = bool(np.array_equal(e1, e2))
    gates["e_codes_in_range"] = bool(e1.size and e1.min() >= 0 and e1.max() <= 1023)
    # (c) voice-prompted, W = 6
    prompted = dict(max_tokens=SPEC_PROMPT_FRAMES + 1 + 192, temperature=0.0, seed=0,
                    audio_prompt_codes=loop[:SPEC_PROMPT_FRAMES], audio_prompt_text=FULL_WIDTH_TEXT)
    c_loop, routes["prompted_loop"] = loop_call(SPEC_PROMPT_TEXT, **prompted)
    c, routes["spec_prompted"] = spec(6, Ld, SPEC_PROMPT_TEXT, **prompted)
    gates["c_equals_loop"] = bool(np.array_equal(c, c_loop))
    # (d) int8 weights, float caches
    t = time.perf_counter()
    dia.quantize_int8()
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t
    d_loop, routes["int8_loop"] = loop_call(kv_int8=False, **kw)
    d, routes["spec_int8"] = spec(W, Ld, gemv="int8_matmul", **kw)
    gates["d_equals_int8_loop"] = bool(np.array_equal(d, d_loop))

    spec_rec = routes["spec"]
    window_ms = spec_rec["window_device_ms_median"]
    step_ms = routes["loop"]["device_ms_per_step"]
    gates["windows_and_steps_timed"] = window_ms is not None and step_ms is not None
    rec = {"phase": "speculative", "config": "dia_1_6b_config() bf16, seed weights",
           "window": W, "draft_layers": Ld, "max_tokens": SPEC_TOKENS,
           "row_bits_equal": row_bits, "gates": gates, "routes": routes,
           "window_device_ms": window_ms, **timings,
           "loop_device_ms_per_step": step_ms, "loop_ms_per_step": routes["loop"]["ms_per_step"],
           "spec_ms_per_token": 1e3 * spec_rec["wall_s"] / spec_rec["decode_steps"],
           "tokens_per_s": {"loop": routes["loop"]["tokens_per_s"],
                            "spec": spec_rec["tokens_per_s"]},
           "alpha": spec_rec["acceptance"],
           "break_even_alpha": ((window_ms / step_ms - 1.0) / (W - 1)
                                if gates["windows_and_steps_timed"] else None),
           "captures": {k: {"window": r.get("window_captures"), "loop": r.get("loop_captures",
                                                                             r.get("captures"))}
                        for k, r in routes.items()},
           "quantize_s": quantize_s, "peak_memory_bytes": int(torch.cuda.max_memory_allocated()),
           "launches": total, "seconds": time.perf_counter() - t0}
    emit(rec)
    failed = [k for k, v in gates.items() if not v]
    if failed:
        raise RuntimeError(f"speculative phase: gates {failed} failed")
    del dia
    torch.cuda.empty_cache()
    return {"paths": {"spec_bf16": {"launches": routes["spec_capture"]["launches"]}}}


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


def train_batch(cfg) -> dict:
    """The training phases' global batch from numpy seed 7: two rows at
    ``audio_length`` (3072 frames and 2000, the rest padding), texts of 700
    and 300 bytes."""
    import numpy as np

    from dia_tts_prune_tpu_torch.train import build_train_batch

    dd = cfg.data
    rng = np.random.default_rng(7)
    text = rng.integers(1, 256, (2, dd.text_length)).astype(np.int32)
    text[0, 700:] = dd.text_pad_value
    text[1, 300:] = dd.text_pad_value
    codes = [rng.integers(0, 1024, (n, dd.channels)).astype(np.int32) for n in (3072, 2000)]
    return build_train_batch(cfg, text, codes)


def with_layers(cfg, n: int):
    """``cfg`` at ``n`` layers per stack, every width kept."""
    m = cfg.model
    return cfg.model_copy(update={"model": m.model_copy(update={
        "encoder": m.encoder.model_copy(update={"n_layer": n}),
        "decoder": m.decoder.model_copy(update={"n_layer": n})})})


def cut_layers(cfg, host, n: int):
    """``cfg`` and its weights ``host`` at the first ``n`` layers of each
    stack, every width kept (views of ``host``'s layers)."""
    def cut(tree, path=()):
        return {k: cut(v, path + (k,)) if isinstance(v, dict)
                else v[:n] if "layers" in path else v for k, v in tree.items()}

    return with_layers(cfg, n), cut(host)


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
    from dia_tts_prune_tpu_torch.train import TrainConfig, Trainer, global_norm

    cfg = dia_1_6b_config()
    batch = train_batch(cfg)
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
    small = with_layers(cfg, 2)
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


# greedy tokens of each route of the two-rank run (the eager loop; 64 to PR 20, cut for
# the script's time in PR 21)
TP_TOKENS = 40
TP_FAULT_TOKENS = 10  # max_tokens of a planted fault's emulated run (its logits read over 8 steps)
TP_LOGIT_STEPS = 8  # steps whose logits the two ranks hold to the single process's
# Two ranks against one process in bf16, as a share of the largest |logit|
# over the first 8 steps: the sharded arithmetic (each rank's o_proj / wo
# partial sum rounded to bf16 before the two are added, the GEMMs at a
# rank's shapes) moves a logit by ~2% (at most 2.02e-2 on three routes, and
# the in-process emulation of the same sums gives those logits bit for bit:
# H100 80GB HBM3, 700 W).  The planted faults (TP_FAULTS) are read beside it.
TP_LOGIT_TOL = 3e-2
TP_CB_TOKENS = 128  # max_tokens of the one-rank NCCL batcher and of the CLI's request
TP_CLI_TEXT = "[S1] Dia serves from every rank."  # one chunk: the batcher's lane serves it
TP_ROUTES = ("float", "int8", "int4")
# The tp phase's model (its directory, served by (a)'s ranks, (b)'s batcher
# and (c)'s app) is the seed weights' first TP_LAYERS layers of each stack,
# every width kept: cut from 12 + 18 so that the script, with the training
# under a mesh, stays within its time.
TP_LAYERS = 4


def tp_trace(torch, dia) -> dict:
    """One route's greedy eager trace (``greedy_trace``; logits read back every
    step) with its launch counts and ms a decode step (the call's wall time,
    conditioning included, over its decode steps)."""
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    t = time.perf_counter()
    codes, rows, first, logs = greedy_trace(torch, dia, FULL_WIDTH_TEXT, max_tokens=TP_TOKENS)
    seconds = time.perf_counter() - t
    steps = dia.generator.last_stats.decode_steps
    return {"codes": codes, "rows": rows, "first": first, "logs": logs,
            "launches": launch_counts(), "steps": steps, "ms_per_step": seconds * 1e3 / steps}


def logit_shares(logs, ref_logs) -> list:
    """Each of the first TP_LOGIT_STEPS steps' largest guided-logit
    difference as a share of the reference's largest |logit| (the bans' NEG
    entries, equal on both sides, left out)."""
    out = []
    for a, b in list(zip(logs, ref_logs))[:TP_LOGIT_STEPS]:
        keep = b > -1e30
        out.append(float((a - b)[keep].abs().max() / b[keep].abs().max()))
    return out


def tp_exact(run: dict, ref: dict) -> bool:
    """Whether a trace equals another bit for bit: every token row and every
    step's guided logits."""
    import numpy as np

    return bool(np.array_equal(run["rows"], ref["rows"]) and len(run["logs"]) == len(ref["logs"])
                and all(a.equal(b) for a, b in zip(run["logs"], ref["logs"])))


def tp_reading(run: dict, ref: dict) -> dict:
    """A two-rank trace against the single process's (``tp_trace``), a
    reading and not a gate of its codes: whether they are equal, else the
    first step where the picks part and the two runs' margins there; and
    the first TP_LOGIT_STEPS steps' logit shares (``logit_shares``), which
    the phase holds to TP_LOGIT_TOL."""
    import numpy as np

    rows, logs, first = run["rows"], run["logs"], run["first"]
    rec = {"frames": int(run["codes"].shape[0]),
           "tokens_equal": bool(np.array_equal(run["codes"], ref["codes"])),
           "logit_share_of_max": logit_shares(logs, ref["logs"])}
    differ = np.argwhere(rows != ref["rows"])
    if len(differ):
        row = int(differ[0, 0])
        k = row - first
        g = logs[k]
        rec.update({"first_differing_step": k, "margins": [
            float(g[c, int(rows[row, c])] - g[c, int(ref["rows"][row, c])])
            for c in np.flatnonzero(rows[row] != ref["rows"][row])]})
    return rec


def tp_quantized(dia, route: str):
    if route == "int8":
        dia.quantize_int8()
    elif route == "int4":
        dia.quantize_int4()
    return dia


# Training under a mesh (the tp phase's training work).  (a) the exact gate:
# fp32 at Dia-1.6B widths, two layers a stack, two steps of each case against
# one process's Trainer from the same weights and batch.  Step 1: loss rtol
# 1e-5 and grad_norm rtol 1e-4 (the JAX tests' tolerances: summation order);
# step 2's loss at TRAIN_LOSS_RTOL.  Every leaf after the updates is held to
# one process's at TP_UPDATE_TOL (the JAX test's for updated params), with
# TP_UPDATE_SPARE elements allowed over it, each within TP_UPDATE_BOUND:
# where a gradient is as small as the ranks' summation-order noise, AdamW's
# division by sqrt(nu) makes the update follow that noise, by at most the
# step size (TP_TRAIN_LR) a step.
TP_TRAIN_LR = 1e-4
TP_TRAIN_STEPS = 2
TP_TRAIN_EXACT = (("full", (1, 2), False), ("lora", (1, 2), False), ("qat_int8", (1, 2), False),
                  ("full", (2, 1), True))  # (mode, mesh (data, model), FSDP)
TP_UPDATE_TOL = {"rtol": 2e-3, "atol": 1e-5}
TP_UPDATE_SPARE = 1e-5  # share of a leaf's elements allowed over TP_UPDATE_TOL
TP_UPDATE_BOUND = 2 * TP_TRAIN_LR * TP_TRAIN_STEPS
# (b) the reading: bf16, remat, one step each on (a)'s weights at two layers
# a stack; the loss against one process's at TP_TRAIN_BF16_RTOL, predicted in
# PERF.md before the first run (the ranks' bf16 partial sums of o_proj / wo
# round before they add).  Cut from full depth and two LoRA steps to keep the
# script within its time (at full depth an FSDP step took 19.0 s a rank and
# 19.4 GB, a LoRA step 5.3-8.2 s: H100 80GB HBM3, 700.00 W).
TP_TRAIN_BF16_RTOL = 2e-3
TP_TRAIN_READING = (("lora_12", (1, 2), False), ("fsdp_21", (2, 1), True))  # mesh, FSDP
TP_CLI_ITEMS = 4  # the finetune CLI's dataset: seeded noise WAVs, two steps of two


def tp_train_fields(mode: str) -> dict:
    """TrainConfig fields of a training mode; LoRA on column-parallel
    (q_proj, v_proj) and row-parallel (o_proj, wo) targets."""
    from dia_tts_prune_tpu_torch.lora import LoraConfig

    return {"full": {}, "qat_int8": {"qat_mode": "int8"},
            "lora": {"adapter_mode": "lora", "lora": LoraConfig(
                r=8, alpha=16.0, target_modules=("q_proj", "v_proj", "o_proj", "wo"))}}[mode]


def tp_train_config(mode: str, dtype: str):
    from dia_tts_prune_tpu_torch.train import TrainConfig

    return TrainConfig(learning_rate=TP_TRAIN_LR, compute_dtype=dtype, remat=True,
                       **tp_train_fields(mode))


def tp_train_refs(torch, tmp: Path) -> dict:
    """One process's runs of the tp phase's training, before its ranks
    start: (a) each mode's two fp32 steps at two layers a stack (metrics
    kept here, the trained leaves written to ``tmp`` for the ranks), the
    weights the ranks start from written too; (b) one bf16 step of each
    mode of TP_TRAIN_READING on the same weights."""
    from dia_tts_prune_tpu_torch import dia_1_6b_config
    from dia_tts_prune_tpu_torch.models.dia import init_params
    from dia_tts_prune_tpu_torch.train import Trainer

    cfg = dia_1_6b_config()
    small = with_layers(cfg, 2)
    batch = train_batch(cfg)
    weights = init_params(small, seed=3, dtype=torch.float32, device="cpu")
    torch.save(weights, tmp / "tp_train_weights.pt")
    refs = {"exact": {}, "reading": {}}
    for mode in ("full", "lora", "qat_int8"):
        tr = Trainer(params_to(weights, "cuda"), small, tp_train_config(mode, "float32"), 10)
        refs["exact"][mode] = [tr.step(batch) for _ in range(TP_TRAIN_STEPS)]
        torch.save({n: t.detach().cpu() for n, t in tr.optimizer.leaves.items()},
                   tmp / f"tp_train_ref_{mode}.pt")
        del tr
        torch.cuda.empty_cache()
    for name, _, _ in TP_TRAIN_READING:
        mode = "lora" if name.startswith("lora") else "full"
        tr = Trainer(params_to(_map_floats(weights, torch.bfloat16), "cuda"), small,
                     tp_train_config(mode, "bfloat16"), 10)
        refs["reading"][name] = [tr.step(batch)]
        del tr
        torch.cuda.empty_cache()
    return refs


def _map_floats(tree, dtype):
    """A params tree's leaves as ``dtype`` (new tensors where it differs)."""
    return {k: _map_floats(v, dtype) if isinstance(v, dict) else v.to(dtype)
            for k, v in tree.items()}


def count_collectives(dist) -> dict:
    """Wrap the collectives the port issues (``torch.distributed``'s
    functions, looked up at each call) with counters; returns the counts."""
    counts = {}
    for name in ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor"):
        counts[name] = 0

        def counted(*args, _real=getattr(dist, name), _name=name, **kwargs):
            counts[_name] += 1
            return _real(*args, **kwargs)

        setattr(dist, name, counted)
    return counts


class planted_copy_fault:
    """(d): inside ``with``, the last decoder layer's MLP input skips
    ``model_copy``'s backward all-reduce (``ops.modules.mlp_block`` looks
    ``model_copy`` up at each call): that rank's upstream gradients keep
    only its own share.  Nothing in the package changes."""

    def __enter__(self):
        import dia_tts_prune_tpu_torch.models.dia as dia_mod
        import dia_tts_prune_tpu_torch.ops.modules as modules

        self.dia_mod, self.real_layer = dia_mod, dia_mod._decoder_layer_full
        real_copy = modules.model_copy

        def layer(lp, m, *args, **kwargs):
            scale = lp["pre_mlp_norm"]["scale"]  # a view of the stacked scales: its offset is i * D
            if scale.storage_offset() != scale.numel() * (m.decoder.n_layer - 1):
                return self.real_layer(lp, m, *args, **kwargs)
            modules.model_copy = lambda x, group: x
            try:
                return self.real_layer(lp, m, *args, **kwargs)
            finally:
                modules.model_copy = real_copy

        dia_mod._decoder_layer_full = layer
        return self

    def __exit__(self, *exc):
        self.dia_mod._decoder_layer_full = self.real_layer
        return False


def tp_train_exact(torch, local, cfg, mode: str, mesh, batch, ref_path: Path) -> dict:
    """(a) on one rank: ``Trainer(mesh=)`` from local shards, TP_TRAIN_STEPS
    fp32 steps, then every leaf against this rank's block of one process's
    (``ref_path``): its largest difference and the elements over
    TP_UPDATE_TOL."""
    from dia_tts_prune_tpu_torch.train import Trainer

    tr = Trainer(local, cfg, tp_train_config(mode, "float32"), 10, mesh=mesh)
    metrics = [tr.step(batch) for _ in range(TP_TRAIN_STEPS)]
    ref = torch.load(ref_path)
    leaves = {}
    for n, t in tr.optimizer.leaves.items():
        want = tr.plan.leaves[n].local(ref[n]).to(t.device)
        diff = (t.detach() - want).abs()
        over = diff > TP_UPDATE_TOL["atol"] + TP_UPDATE_TOL["rtol"] * want.abs()
        leaves[n] = {"sharded_over": tr.plan.leaves[n].axes, "numel": t.numel(),
                     "max_abs_diff": float(diff.max()), "over_tol": int(over.sum())}
    return {"metrics": metrics, "leaves": leaves}


def tp_train_rank(torch, out: Path) -> dict:
    """The tp phase's training on one of its two ranks, after the serving
    work: (a) each case of TP_TRAIN_EXACT, (d) the planted fault on the
    (1, 2) full case, (b) one bf16 step of each case of TP_TRAIN_READING
    on the same weights, under the profiler
    with its flash launches and collectives counted, and the ranks' loss,
    grad_norm and replicated leaves checked equal (``check_agree``)."""
    import numpy as np
    import torch.distributed as dist

    from dia_tts_prune_tpu_torch import dia_1_6b_config
    from dia_tts_prune_tpu_torch.ops.kernels import reset_launch_counts
    from dia_tts_prune_tpu_torch.parallel.sharding import check_agree, make_mesh, shard_params
    from dia_tts_prune_tpu_torch.train import Trainer

    cfg = dia_1_6b_config()
    small = with_layers(cfg, 2)
    batch = train_batch(cfg)
    weights = torch.load(out / "tp_train_weights.pt")
    res = {"exact": {}, "reading": {}, "seconds": {}}
    meshes = {}
    for mode, shape, fsdp in TP_TRAIN_EXACT:
        t = time.perf_counter()
        mesh = meshes.setdefault(shape, make_mesh(*shape, device="cuda"))
        local = params_to(shard_params(weights, mesh, config=small, fsdp=fsdp), "cuda")
        name = f"{mode}_{shape[0]}{shape[1]}" + ("_fsdp" if fsdp else "")
        res["exact"][name] = tp_train_exact(torch, local, small, mode, mesh, batch,
                                            out / f"tp_train_ref_{mode}.pt")
        res["exact"][name]["mode"] = mode
        res["seconds"][name] = time.perf_counter() - t
        if name == "full_12":
            t = time.perf_counter()
            with planted_copy_fault():
                res["fault"] = tp_train_exact(torch, local, small, mode, mesh, batch,
                                              out / "tp_train_ref_full.pt")
            res["seconds"]["fault"] = time.perf_counter() - t
        del local
        torch.cuda.empty_cache()
    weights = _map_floats(weights, torch.bfloat16)

    counts = count_collectives(dist)
    for name, shape, fsdp in TP_TRAIN_READING:
        t = time.perf_counter()
        mesh = meshes.setdefault(shape, make_mesh(*shape, device="cuda"))
        mode = "lora" if name.startswith("lora") else "full"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        local = params_to(shard_params(weights, mesh, config=small, fsdp=fsdp), "cuda")
        tr = Trainer(local, small, tp_train_config(mode, "bfloat16"), 10, mesh=mesh)
        log = []
        for _ in range(1):
            reset_launch_counts()
            for k in counts:
                counts[k] = 0
            m, wall_ms, device_ms, kinds, kernels = profiled(torch, lambda: tr.step(batch))
            log.append({**m, "wall_ms": wall_ms, "device_ms": device_ms,
                        "device_ms_by_kind": kinds, "kernels": kernels,
                        "launches": train_launch_counts(), "collectives": dict(counts)})
        replicated = [t.detach().float().cpu().numpy() for n, t in tr.optimizer.leaves.items()
                      if not tr.plan.leaves[n].axes]
        check_agree(mesh, [np.array([(x["loss"], x["grad_norm"]) for x in log]), *replicated],
                    "cuda", f"training {name}: loss, grad_norm and the replicated leaves")
        res["reading"][name] = {"steps": log, "peak_memory_bytes":
                                int(torch.cuda.max_memory_allocated()),
                                "replicated_leaves": len(replicated),
                                "trained_elements_this_rank": sum(
                                    t.numel() for t in tr.optimizer.leaves.values())}
        del tr, local
        res["seconds"][f"reading_{name}"] = time.perf_counter() - t
    return res


def tp_train_gate(run: dict, ref: list, mode: str) -> list:
    """Gate (a) of one rank's run against one process's metrics ``ref``:
    what fails it ([] if nothing)."""
    def rel(a, b):
        return abs(a - b) / abs(b)

    bad = []
    got = run["metrics"]
    for key, tol in (("loss", 1e-5), ("grad_norm", 1e-4)):
        if not rel(got[0][key], ref[0][key]) <= tol:
            bad.append(f"step 1 {key} {got[0][key]} against {ref[0][key]} (rtol {tol})")
    if not rel(got[-1]["loss"], ref[-1]["loss"]) <= TRAIN_LOSS_RTOL[mode]:
        bad.append(f"step {len(got)} loss {got[-1]['loss']} against {ref[-1]['loss']}")
    for n, leaf in run["leaves"].items():
        if leaf["over_tol"] > leaf["numel"] * TP_UPDATE_SPARE \
                or not leaf["max_abs_diff"] <= TP_UPDATE_BOUND:
            bad.append(f"{n}: {leaf}")
    return bad


def tp_train_summary(run: dict, ref: list) -> dict:
    """A rank's run of (a) beside one process's: relative differences and
    the leaves' totals."""
    leaves = run["leaves"].values()
    return {"loss_rel_diff": [abs(a["loss"] - b["loss"]) / abs(b["loss"])
                              for a, b in zip(run["metrics"], ref)],
            "grad_norm_rel_diff": [abs(a["grad_norm"] - b["grad_norm"]) / abs(b["grad_norm"])
                                   for a, b in zip(run["metrics"], ref)],
            "leaves": len(run["leaves"]), "elements": sum(x["numel"] for x in leaves),
            "elements_over_tol": sum(x["over_tol"] for x in leaves),
            "max_abs_diff": max(x["max_abs_diff"] for x in leaves),
            "replicated_elements_over_tol": sum(x["over_tol"] for x in leaves
                                                if not x["sharded_over"])}


def tp_training_gates(torch, train: dict, refs: dict, ranks: list) -> list:
    """Gates (a) and (d) and the reading (b) over both ranks' training
    results; fills ``train``, returns the failures."""
    from dia_tts_prune_tpu_torch import dia_1_6b_config

    failures = []
    train["exact"], train["rank_seconds"] = {}, [r.pop("seconds") for r in ranks]
    for name in ranks[0]["exact"]:
        mode = ranks[0]["exact"][name]["mode"]
        ref = refs["exact"][mode]
        train["exact"][name] = [tp_train_summary(r["exact"][name], ref) for r in ranks]
        for r, rank in enumerate(ranks):
            bad = tp_train_gate(rank["exact"][name], ref, mode)
            if bad:
                failures.append(f"training (a) {name} rank {r}: {bad[:4]}")
    fault = [tp_train_gate(r["fault"], refs["exact"]["full"], "full") for r in ranks]
    train["fault"] = {"what": "the last decoder layer's MLP input without model_copy's backward "
                              "all-reduce", "rejected": [bool(b) for b in fault],
                      "reading": [tp_train_summary(r["fault"], refs["exact"]["full"])
                                  for r in ranks], "first_failures": [b[:3] for b in fault]}
    if not all(fault):
        failures.append("training (d): gate (a) passes the planted fault")
    train["reading"] = {}
    want = expected_train_launches(with_layers(dia_1_6b_config(), 2), 1)
    for name, _, _ in TP_TRAIN_READING:
        ref = refs["reading"][name]
        one = {"single_process": ref, "ranks": [r["reading"][name] for r in ranks],
               "loss_rel_diff": [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in
                                 zip(ranks[0]["reading"][name]["steps"], ref)],
               "loss_rtol": TP_TRAIN_BF16_RTOL}
        train["reading"][name] = one
        if not max(one["loss_rel_diff"]) <= TP_TRAIN_BF16_RTOL:
            failures.append(f"training (b) {name}: loss off one process's: {one['loss_rel_diff']}")
        for r, rank in enumerate(one["ranks"]):
            for step in rank["steps"]:
                if step["launches"] != want:
                    failures.append(f"training (b) {name} rank {r}: launches {step['launches']}, "
                                    f"one process's {want}")
    return failures


def tp_training_one_rank(torch, train: dict, mesh) -> list:
    """(c) in this process, on a one-rank NCCL mesh: one LoRA step at full
    width (2 + 2 layers, the weights of (a)'s file in bf16), equal bit for
    bit to the same step without a mesh."""
    from dia_tts_prune_tpu_torch import dia_1_6b_config
    from dia_tts_prune_tpu_torch.ops.kernels import reset_launch_counts
    from dia_tts_prune_tpu_torch.parallel.sharding import shard_params
    from dia_tts_prune_tpu_torch.train import Trainer

    cfg = with_layers(dia_1_6b_config(), 2)
    batch = train_batch(cfg)
    weights = _map_floats(torch.load(train["weights_file"]), torch.bfloat16)
    runs = {}
    for name, m in (("nccl_mesh_1x1", mesh), ("no_mesh", None)):
        params = params_to(weights, "cuda")
        if m is not None:
            params = shard_params(params, m, config=cfg)
        tr = Trainer(params, cfg, tp_train_config("lora", "bfloat16"), 10, mesh=m)
        reset_launch_counts()
        metrics = tr.step(batch)
        runs[name] = {"metrics": metrics, "launches": train_launch_counts(),
                      "adapter": {n: t.detach().clone() for n, t in tr.optimizer.leaves.items()}}
        del tr, params
        torch.cuda.empty_cache()
    a, b = runs["nccl_mesh_1x1"], runs["no_mesh"]
    equal = a["metrics"] == b["metrics"] and all(torch.equal(a["adapter"][n], t)
                                                 for n, t in b["adapter"].items())
    train["one_nccl_rank"] = {"metrics": a["metrics"], "no_mesh_metrics": b["metrics"],
                              "bit_equal": equal, "launches": a["launches"]}
    return [] if equal and a["launches"] == expected_train_launches(cfg, 1) else [
        f"training (c) one NCCL rank: {train['one_nccl_rank']}"]


def tp_cli_inputs(torch, tmp: Path) -> Path:
    """The finetune CLI's inputs: a model directory at Dia-1.6B widths, two
    layers a stack, with the whole DAC (``init_dac_params``), and
    TP_CLI_ITEMS seeded noise WAVs of 2-3 s with their lines."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.api import write_wav
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_params
    from dia_tts_prune_tpu_torch.models.dia import init_params

    root = tmp / "tp_cli"
    small = with_layers(dia_1_6b_config(), 2)
    dac_cfg = DACConfig()
    Dia(small, init_params(small, seed=2, dtype=torch.bfloat16, device="cpu"), "bfloat16",
        dac_params=init_dac_params(dac_cfg, seed=1, device="cpu"), dac_config=dac_cfg,
        device="cpu").save_pretrained(root / "model")
    (root / "dataset" / "wavs").mkdir(parents=True)
    rng = np.random.default_rng(4)
    lines = []
    for i in range(TP_CLI_ITEMS):
        n = int(dac_cfg.sample_rate * (2 + 0.25 * i))
        write_wav(root / "dataset" / "wavs" / f"n{i}.wav",
                  (0.2 * rng.standard_normal(n)).astype(np.float32), dac_cfg.sample_rate)
        lines.append(f"n{i}.wav|[S{1 + i % 2}] Line number {i} of the noise set.")
    (root / "dataset" / "metadata.csv").write_text("\n".join(lines) + "\n")
    return root


def tp_training_cli(torch, train: dict, runs: dict, root: Path) -> list:
    """(c), the CLI: ``finetune --mesh-model 1`` (one NCCL rank) ran to its
    end and wrote a model that the port loads and generates from;
    ``--mesh-model 2`` exited 2 naming the one card."""
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia

    out = {}
    for m, proc in runs.items():
        stdout, stderr = proc.communicate(timeout=600)
        out[m] = {"exit": proc.returncode,
                  "last_lines": (stdout + stderr).strip().splitlines()[-3:]}
    failures = []
    if out["1"]["exit"] != 0:
        failures.append(f"training (c) finetune --mesh-model 1: {out['1']}")
    else:
        tuned = Dia.from_pretrained(root / "out1", compute_dtype="bfloat16", device="cuda")
        codes = tuned.generate_codes(TP_CLI_TEXT, max_tokens=32, temperature=0.0)
        out["1"].update({"output_files": sorted(p.name for p in (root / "out1").iterdir()),
                         "generated_frames": int(codes.shape[0]),
                         "codes_in_range": bool(np.all((codes >= 0) & (codes < 1028)))})
        if not (out["1"]["codes_in_range"] and out["1"]["generated_frames"] > 0
                and {"adapter", "pytorch_model.bin"} <= set(out["1"]["output_files"])):
            failures.append(f"training (c) the model finetune wrote: {out['1']}")
        del tuned
    if out["2"]["exit"] != 2 or not any("needs 2 CUDA devices, found 1" in line
                                        for line in out["2"]["last_lines"]):
        failures.append(f"training (c) finetune --mesh-model 2 on one card: {out['2']}")
    train["cli"] = out
    return failures


def tp_rank(rank: int, init: str, model_dir: str, out: str) -> None:
    """One rank of the two-rank run on the one card (spawned): gloo, the
    model directory's bf16 weights read once to the host, then each route
    sharded on a (1, 2) mesh (``Dia.shard``; packed after sharding) and
    traced.  Writes ``out/tp_rank<rank>.pt``."""
    import datetime

    import torch
    import torch.distributed as dist

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.checkpoint import load_checkpoint
    from dia_tts_prune_tpu_torch.config import DiaConfig
    from dia_tts_prune_tpu_torch.parallel.sharding import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=init, world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        mesh = make_mesh(data=1, model=2, device="cuda")
        cfg = DiaConfig.load(Path(model_dir) / "config.json")
        host = load_checkpoint(Path(model_dir) / "pytorch_model.bin", cfg, torch.bfloat16, "cpu")
        res = {}
        for route in TP_ROUTES:
            dia = Dia(cfg, params_to(host, "cuda"), "bfloat16", device="cuda")
            dia.shard(mesh)
            res[route] = tp_trace(torch, tp_quantized(dia, route))
            res[route]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            del dia
            torch.cuda.empty_cache()
        t = time.perf_counter()
        res["training"] = tp_train_rank(torch, Path(out))
        res["training"]["seconds"]["total"] = time.perf_counter() - t
        torch.save(res, Path(out) / f"tp_rank{rank}.pt")
    finally:
        dist.destroy_process_group()


class _EmulatedGroup:
    """A stand-in model or data group of ``tp_emulated``'s in-process mesh."""

    def __init__(self, size: int):
        self.size = size


class _EmulatedMesh:
    """Rank ``rank`` of a (1, 2) mesh for ``tp_emulated``: the part of the
    ``DeviceMesh`` interface that ``parallel/sharding.py`` reads."""

    mesh_dim_names = ("data", "model")
    shape = (1, 2)

    def __init__(self, rank: int, groups: dict):
        self.rank, self.groups = rank, groups

    def size(self, dim: int) -> int:
        return self.shape[dim]

    def get_coordinate(self) -> list:
        return [0, self.rank]

    def get_group(self, name: str):
        return self.groups[name]


# tp_emulated's planted faults, read against the single process as the
# sound runs are: two query heads of rank 0's self-attention o_proj, of two
# KV groups, swapped in the last decoder layer (a wrong shard: a reading);
# one model all-reduce in every 3 x decoder layers (one a decode step) skipped on both
# ranks; every one skipped (each rank keeps its own partial sums).  The two
# missing collectives must read above TP_LOGIT_TOL.
TP_FAULTS = ("swap_heads", "skip_one_sum", "skip_every_sum")
TP_GATED_FAULTS = ("skip_one_sum", "skip_every_sum")


def tp_emulated(torch, host, cfg, route: str, max_tokens: int, fault: str | None = None,
                device: str = "cuda") -> list:
    """The exact reference of the two-rank run (``tp_rank``): its two ranks
    as two threads of this process, each a ``Dia`` sharded with
    ``Dia.shard`` on a (1, 2) ``_EmulatedMesh`` from the same weights
    (``host``), and every collective of the mesh done here on the card:
    ``torch.distributed.all_reduce`` (patched while this runs) adds rank
    0's tensor and rank 1's in their dtype, as gloo adds them on the host
    (one bf16 rounding of the exact sum of two bf16 values, whatever the
    ring's order), and takes their maximum for MAX.  So the ranks' codes
    and logits must equal these bit for bit.  Each thread traces the greedy
    eager run as ``tp_trace`` does; ``fault`` (``TP_FAULTS``) plants one
    error.  Returns each thread's trace."""
    import threading

    import torch.distributed as dist

    import dia_tts_prune_tpu_torch.generate as gen
    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.models.dia import local_heads
    from dia_tts_prune_tpu_torch.ops.sampling import apply_constraints, cfg_combine

    d = cfg.data
    sums_a_step = 3 * cfg.model.decoder.n_layer  # after o_proj, cross o_proj and wo
    groups = {"data": _EmulatedGroup(1), "model": _EmulatedGroup(2)}
    barrier, slots, local = threading.Barrier(2, timeout=300), [None, None], threading.local()
    real = {"all_reduce": dist.all_reduce, "get_world_size": dist.get_world_size,
            "step_function": gen.step_function, "decode_loop": gen.decode_loop}

    def all_reduce(t, op=dist.ReduceOp.SUM, group=None, async_op=False):
        if group.size == 1:
            return None
        skip = False
        if op == dist.ReduceOp.SUM and t.dim() > 1:
            local.sums += 1
            skip = (fault == "skip_every_sum"
                    or fault == "skip_one_sum" and local.sums % sums_a_step == 0)
        slots[local.rank] = t
        barrier.wait()
        out = (slots[0] + slots[1] if op == dist.ReduceOp.SUM
               else torch.maximum(slots[0], slots[1]))
        barrier.wait()  # both sums are queued before either rank overwrites its tensor
        if not skip:
            t.copy_(out)
        return None

    def step_function(params):
        step = real["step_function"](params)

        def traced(params, config, *args, **kwargs):
            logits = step(params, config, *args, **kwargs)
            local.logs.append(apply_constraints(cfg_combine(logits[:, -1].float().cpu(), 3.0),
                                                d.audio_eos_value, d.audio_pad_value,
                                                d.audio_bos_value))
            return logits

        return traced

    def decode_loop(params, config, tokens_buf, *args, **kwargs):
        out = real["decode_loop"](params, config, tokens_buf, *args, **kwargs)
        local.rows, local.first = tokens_buf.copy(), args[3]
        return out

    results: list = [None, None]

    def rank(r: int) -> None:
        local.rank, local.sums, local.logs = r, 0, []
        try:
            dia = Dia(cfg, params_to(host, device), "bfloat16", device=device)
            dia.shard(_EmulatedMesh(r, groups))
            if fault == "swap_heads" and r == 0:
                o = dia.params["decoder"]["layers"]["self_attention"]["o_proj"]["kernel"]
                g = o.shape[1] // local_heads(dia.params)  # query heads a KV head
                o[-1, [0, g]] = o[-1, [g, 0]]
            dia = tp_quantized(dia, route)
            dia.generator.lock = threading.RLock()  # the two ranks share one device lock
            codes = dia.generate_codes(FULL_WIDTH_TEXT, temperature=0.0, loop="eager",
                                       max_tokens=max_tokens)
            results[r] = {"codes": codes, "rows": local.rows, "first": local.first,
                          "logs": local.logs}
        except BaseException as e:  # noqa: BLE001 — the other rank must not wait for this one
            barrier.abort()
            results[r] = e

    dist.all_reduce, dist.get_world_size = all_reduce, lambda group=None: group.size
    gen.step_function, gen.decode_loop = step_function, decode_loop
    try:
        threads = [threading.Thread(target=rank, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        dist.all_reduce, dist.get_world_size = real["all_reduce"], real["get_world_size"]
        gen.step_function, gen.decode_loop = real["step_function"], real["decode_loop"]
    for out in results:
        if isinstance(out, BaseException):
            raise RuntimeError(f"tp: the emulated ranks failed ({route}, fault {fault})") from out
    return results


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_tp(torch, tmp: Path) -> dict:
    """Tensor-parallel serving (``parallel/sharding.py``) on the one card, at
    full width (``dia_1_6b_config()``'s widths, bf16, the first TP_LAYERS
    layers a stack of ``Dia.random_init``'s seed weights in a model
    directory: a bf16 ``pytorch_model.bin`` and a seeded DAC decoder).  The
    card machine has one H100, so: (a) two ranks on it
    over gloo (CUDA tensors staged through the host), each a spawned
    process, the eager loop: float, ``quantize_int8()`` (int8 KV caches) and
    ``quantize_int4()`` after ``Dia.shard`` on a (1, 2) mesh, 40 greedy
    tokens each.  On each route the two ranks equal each other and the
    in-process emulation of the same two ranks (``tp_emulated``) bit for
    bit, every token and every step's logits; each rank's decode-attention
    and flash launches (and int8-matmul or int4-GEMV) are above 0; against
    the single process the first 8 steps' logits lie within TP_LOGIT_TOL of
    its largest |logit|, two planted missing all-reduces
    (``TP_GATED_FAULTS``) read above it and a planted wrong shard beside
    it; the codes against the single process are a reading
    (``tp_reading``); ms a step beside the single process's eager run,
    both timed before anything else starts on the card.  (b) One rank over
    NCCL, graphed: ``ContinuousBatcher(mesh=make_mesh(1, 1))`` (the model
    group's all-reduce captured in its CUDA graph) gives two lanes (greedy,
    seeded) the unsharded batcher's codes bit for bit.  (c) The CLI:
    ``app --tp 1 --continuous-batch`` (NCCL) answers a greedy ``/generate``
    whose PCM lies within PCM_LSB_TOL of (b)'s waveform, and ``app --tp 2``
    exits with the parser error that names the one card found.  Then the
    training under a mesh of the module docstring's item 10: one process's
    runs before the ranks start (``tp_train_refs``), the ranks' after their
    serving work (``tp_train_rank``), (c) in this process over NCCL and the
    finetune CLI in subprocesses that start once the ranks end.  Nothing of
    this measures NVLink."""
    import datetime
    import multiprocessing
    import signal

    import numpy as np
    import torch.distributed as dist
    from safetensors.numpy import save_file

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.api import flatten_tree
    from dia_tts_prune_tpu_torch.app import _pcm16
    from dia_tts_prune_tpu_torch.cbatch import ContinuousBatcher
    from dia_tts_prune_tpu_torch.checkpoint import load_checkpoint, to_torch_state_dict
    from dia_tts_prune_tpu_torch.models.dac import (
        DACConfig,
        init_dac_decoder_params,
        load_dac_safetensors,
    )
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts
    from dia_tts_prune_tpu_torch.parallel.sharding import make_mesh

    t0 = time.perf_counter()
    torch.cuda.empty_cache()  # the earlier phases' cached blocks: the ranks share this card
    cfg, dac_cfg = dia_1_6b_config(), DACConfig()
    rec = {"phase": "tp", "config": f"dia_1_6b_config() widths, the first {TP_LAYERS} layers a "
           "stack of Dia.random_init seed 0 in bf16; DACConfig() decoder seed 1",
           "tokens": TP_TOKENS, "logit_steps": TP_LOGIT_STEPS, "logit_tol": TP_LOGIT_TOL}
    failures = []

    # the model directory: what the ranks and the CLI load
    cfg, host = cut_layers(cfg, seed_host_weights(cfg), TP_LAYERS)
    model_dir = tmp / "model"
    model_dir.mkdir()
    torch.save({k: torch.from_numpy(v).to(torch.bfloat16)
                for k, v in to_torch_state_dict(host, cfg).items()},
               model_dir / "pytorch_model.bin")
    cfg.save(model_dir / "config.json")
    save_file(flatten_tree(init_dac_decoder_params(dac_cfg, seed=1, device="cpu")),
              str(model_dir / "dac.safetensors"))
    rec["write_s"] = time.perf_counter() - t0

    server = tp2 = None
    cli_runs = {}
    server_log = open(tmp / "tp_server.err", "w")
    try:
        # the single process, each route on the eager loop
        single = {}
        for route in TP_ROUTES:
            dia = tp_quantized(Dia(cfg, params_to(host, "cuda"), "bfloat16", device="cuda"),
                               route)
            single[route] = tp_trace(torch, dia)
            del dia
            torch.cuda.empty_cache()

        # training: one process's runs, which the ranks read and are gated against
        t = time.perf_counter()
        train_refs = tp_train_refs(torch, tmp)
        train = {"phase": "tp", "part": "training", "weights_file": str(
            tmp / "tp_train_weights.pt"), "config": {
            "exact": "dia_1_6b_config() widths, 2 + 2 layers, fp32, init_params seed 3, lr "
                     f"{TP_TRAIN_LR}, {TP_TRAIN_STEPS} steps",
            "reading": "dia_1_6b_config() bf16, the serving weights, remat"},
            "batch": "train_batch: 2 rows, audio_length 3072", "refs_s": time.perf_counter() - t,
            "note": "two gloo ranks time-share one card and stage every collective through "
                    "the host: no multi-card speed"}
        torch.cuda.empty_cache()

        # (a) two ranks on the one card over gloo
        t = time.perf_counter()
        ctx = multiprocessing.get_context("spawn")
        init = f"file://{tmp / 'tp_rendezvous'}"
        ranks = [ctx.Process(target=tp_rank, args=(r, init, str(model_dir), str(tmp)))
                 for r in (0, 1)]
        for p in ranks:
            p.start()
        for p in ranks:
            p.join(timeout=600)
        for p in ranks:
            if p.is_alive():
                p.kill()
                p.join()
        if any(p.exitcode != 0 for p in ranks):
            raise RuntimeError(f"tp: a rank failed: exit codes {[p.exitcode for p in ranks]}")
        got = [torch.load(tmp / f"tp_rank{r}.pt", weights_only=False) for r in (0, 1)]
        rec["two_rank_s"] = time.perf_counter() - t
        failures += tp_training_gates(torch, train, train_refs, [g.pop("training") for g in got])

        # training (c): the finetune CLI on one NCCL rank, and two ranks asked of one card;
        # started now, so that they load while the emulation and (b) run
        cli_dir = tp_cli_inputs(torch, tmp)
        finetune = [sys.executable, "-m", "dia_tts_prune_tpu_torch.finetune", "--model-path",
                    str(cli_dir / "model"), "--dataset-dir", str(cli_dir / "dataset"),
                    "--adapter-mode", "lora", "--compute-dtype", "bfloat16", "--batch-size",
                    "2", "--learning-rate", "1e-4", "--logging-steps", "1", "--save-steps", "1"]
        cli_runs = {m: subprocess.Popen(finetune + ["--output-dir", str(cli_dir / f"out{m}"),
                                                    "--mesh-model", m],
                                        cwd=Path(__file__).resolve().parent,
                                        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                        text=True) for m in ("1", "2")}

        # (c) started once (a) is timed, so that it loads while the emulation and (b) run
        port = _free_port()
        cli = [sys.executable, "-m", "dia_tts_prune_tpu_torch.app", "--model-path",
               str(model_dir), "--continuous-batch"]
        server = subprocess.Popen(cli + ["--tp", "1", "--cb-slots", "2", "--cb-segment-steps",
                                         "64", "--cb-max-tokens", str(TP_CB_TOKENS),
                                         "--cb-text-window", "256", "--host", "127.0.0.1",
                                         "--port", str(port)],
                                  cwd=Path(__file__).resolve().parent, stdout=subprocess.PIPE,
                                  stderr=server_log, text=True)
        tp2 = subprocess.Popen(cli + ["--tp", "2"], cwd=Path(__file__).resolve().parent,
                               stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

        # the exact reference of (a), and the planted faults' readings
        t = time.perf_counter()
        loaded = load_checkpoint(model_dir / "pytorch_model.bin", cfg, torch.bfloat16, "cpu")
        emulated = {route: tp_emulated(torch, loaded, cfg, route, TP_TOKENS)
                    for route in TP_ROUTES}
        rec["faults"] = {}
        for fault in TP_FAULTS:
            e0, e1 = tp_emulated(torch, loaded, cfg, "float", TP_FAULT_TOKENS, fault)
            rec["faults"][fault] = [max(logit_shares(e["logs"], single["float"]["logs"]))
                                    for e in (e0, e1)]
        for fault in TP_GATED_FAULTS:
            if rec["faults"][fault][0] <= TP_LOGIT_TOL:  # rank 0's: what the gate reads
                failures.append(f"(a) the planted fault {fault} reads within TP_LOGIT_TOL: "
                                f"{rec['faults']}")
        del loaded
        rec["emulation_s"] = time.perf_counter() - t

        rec["routes"] = {}
        for route in TP_ROUTES:
            ref, r0, r1 = single[route], got[0][route], got[1][route]
            one = {"single_ms_per_step": ref["ms_per_step"],
                   "two_rank_gloo_ms_per_step": [r["ms_per_step"] for r in (r0, r1)],
                   "timing": "eager loop, logits read back every step, conditioning included; "
                             "two ranks: host-staged gloo on one card",
                   "ranks_equal": tp_exact(r0, r1),
                   "ranks_equal_emulation": [tp_exact(r, e) for r, e in
                                             zip((r0, r1), emulated[route])],
                   "steps": [len(r["logs"]) for r in (r0, r1)],
                   "launches": [r["launches"] for r in (r0, r1)],
                   "single_launches": ref["launches"], "peak_gb": [r["peak_gb"] for r in (r0, r1)],
                   "against_single_process": tp_reading(r0, ref)}
            if not one["ranks_equal"]:
                failures.append(f"{route}: the two ranks differ")
            if not all(one["ranks_equal_emulation"]):
                failures.append(f"{route}: the ranks differ from their in-process emulation")
            if max(one["against_single_process"]["logit_share_of_max"]) > TP_LOGIT_TOL:
                failures.append(f"{route}: logits off the single process's by more than "
                                f"TP_LOGIT_TOL: {one['against_single_process']}")
            kernels = ["decode_attention", "flash_attention"] + {
                "float": [], "int8": ["int8_matmul"], "int4": ["int4_gemv"]}[route]
            for r, counts in enumerate(one["launches"]):
                for k in kernels:
                    if counts.get(k, 0) <= 0:
                        failures.append(f"{route}: rank {r} launched no {k}")
            rec["routes"][route] = one

        # (b) one rank over NCCL, the batcher's graph holding the all-reduces
        t = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{_free_port()}",
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=300))
        dac = load_dac_safetensors(model_dir / "dac.safetensors", "cuda")
        lanes = {}
        try:
            mesh = make_mesh(data=1, model=1, device="cuda")
            for name, m in (("nccl_mesh_1x1", mesh), ("unsharded", None)):
                dia = Dia(cfg, params_to(host, "cuda"), "bfloat16", dac_params=dac,
                          dac_config=dac_cfg, device="cuda")
                if m is not None:
                    dia.shard(m)
                reset_launch_counts()
                cb = ContinuousBatcher(dia, n_slots=2, segment_steps=64, max_tokens=TP_CB_TOKENS,
                                       text_window=256, mesh=m)
                try:
                    futs = [cb.submit(FULL_WIDTH_TEXT, temperature=0.0, seed=0),
                            cb.submit(BATCHED_TEXTS[0], temperature=1.3, seed=5)]
                    codes = [f.result(600) for f in futs]
                    counts = launch_counts()
                    wave = cb.generate(TP_CLI_TEXT, max_tokens=TP_CB_TOKENS, temperature=0.0)
                finally:
                    cb.shutdown()
                lanes[name] = {"codes": codes, "launches": counts, "wave": wave,
                               "captures": cb.stats["captures"]}
                del dia, cb
                torch.cuda.empty_cache()
            failures += tp_training_one_rank(torch, train, mesh)
        finally:
            dist.destroy_process_group()
        equal = all(np.array_equal(a, b) for a, b in zip(lanes["nccl_mesh_1x1"]["codes"],
                                                          lanes["unsharded"]["codes"]))
        rec["nccl_graph"] = {
            "lanes_equal_unsharded": equal,
            "frames": [int(c.shape[0]) for c in lanes["nccl_mesh_1x1"]["codes"]],
            "captures": lanes["nccl_mesh_1x1"]["captures"],
            "launches": lanes["nccl_mesh_1x1"]["launches"],
            "seconds": time.perf_counter() - t}
        if not equal:
            failures.append("(b) the NCCL-mesh batcher's lanes differ from the unsharded ones")
        if lanes["nccl_mesh_1x1"]["captures"] != 1:
            failures.append("(b) the NCCL-mesh batcher did not capture its graph once")
        for k in ("decode_attention", "flash_attention"):
            if lanes["nccl_mesh_1x1"]["launches"].get(k, 0) <= 0:
                failures.append(f"(b) no {k} launch")

        # (c) the CLI
        t = time.perf_counter()
        line = ""
        while "Serving Dia TTS API" not in line:
            line = server.stdout.readline()
            if not line:
                raise RuntimeError("tp: app --tp 1 ended before it served: "
                                   + (tmp / "tp_server.err").read_text()[-3000:])
        served = _post(port, "/generate", {"text": TP_CLI_TEXT,
                                           "max_new_tokens": TP_CB_TOKENS, "temperature": 0.0})
        pcm = np.frombuffer(served["body"][44:], np.int16).astype(np.int32)
        want = _pcm16(lanes["nccl_mesh_1x1"]["wave"]).astype(np.int32)
        diff = int(np.abs(pcm - want).max()) if pcm.shape == want.shape else None
        server.send_signal(signal.SIGTERM)
        server_rc = server.wait(timeout=120)
        out2, err2 = tp2.communicate(timeout=120)
        rec["cli"] = {"tp1_status": served["status"], "tp1_seconds": served["seconds"],
                      "tp1_pcm_max_lsb_diff": diff, "pcm_lsb_tol": PCM_LSB_TOL,
                      "tp1_exit": server_rc, "tp2_exit": tp2.returncode,
                      "tp2_error": err2.strip().splitlines()[-1] if err2.strip() else "",
                      "wall_s": time.perf_counter() - t}
        if served["status"] != 200 or diff is None or diff > PCM_LSB_TOL or server_rc != 0:
            failures.append(f"(c) app --tp 1: {rec['cli']}")
        if tp2.returncode != 2 or "--tp 2 needs 2 CUDA devices, found 1" not in err2:
            failures.append(f"(c) app --tp 2 on one card: {rec['cli']}")
        failures += tp_training_cli(torch, train, cli_runs, cli_dir)
        train["failures"] = [f for f in failures if f.startswith("training")]
        emit(train)
    finally:
        for proc in (server, tp2, *cli_runs.values()):
            if proc is not None and proc.poll() is None:
                proc.kill()
                proc.wait()
        server_log.close()
    rec["seconds"] = time.perf_counter() - t0
    rec["failures"] = failures
    emit(rec)
    if failures:
        raise RuntimeError(f"tp: {failures}")
    return rec


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

    # the fixtures' CPU sides run in worker processes while nvcc builds the kernels
    pool = concurrent.futures.ProcessPoolExecutor(
        HOST_WORKERS, mp_context=multiprocessing.get_context("spawn")) if wanted(
        "fixtures") else None
    try:
        running = fixture_host_runs(pool, repo) if pool else {}
        faults = phase_build()
        lap("build")
        host = {key: f.result() for key, f in running.items()}
        lap("fixtures' CPU sides")
    finally:
        if pool:
            pool.shutdown(cancel_futures=True)
    picked = phase_kernels(torch, faults) if wanted("kernels") else None
    lap("kernels")
    if wanted("fixtures"):
        phase_fixtures(torch, repo, host)
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
    if wanted("files"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_files_") as tmp:
            phase_files(torch, Path(tmp))
        lap("files")
    spec = None
    if wanted("speculative"):
        spec = phase_speculative(torch, picked["row_bits"] if picked else None)
        lap("speculative")
    if wanted("training"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            training = phase_training(torch, Path(tmp))
        lap("training")
    if wanted("tp"):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
            phase_tp(torch, Path(tmp))
        lap("tp")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0] if smi else "nvidia-smi: no card listed"
    if only:
        print(card, flush=True)
        print(f"# chip_smoke partial run {sorted(only)}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
        return 0
    paths = {**full["paths"], **spec["paths"], **training}

    csrc, jax_kernels = "dia_tts_prune_tpu_torch/csrc/", "dia_tts_prune_tpu/ops/kernels/"
    SOURCES = {"flash_attention_lse": "flash_attention",
               "flash_attention_bwd_kv": "flash_attention_bwd",
               "flash_attention_bwd_q": "flash_attention_bwd",
               "fused_decode_step": "fused_step"}
    # (kernel, its record of the kernels phase, the path whose launches it reports, replaces);
    # a form counted apart (the decode kernel's window form) reports its own count
    lines = [("flash_attention", "flash_attention", "bf16", "flash_attention.py:157"),
             ("flash_attention_lse", "flash_attention_lse", "train_lora", "flash_attention.py:359"),
             ("flash_attention_bwd_kv", "flash_attention_bwd_kv", "train_lora",
              "flash_attention.py:456"),
             ("flash_attention_bwd_q", "flash_attention_bwd_q", "train_lora",
              "flash_attention.py:481"),
             ("decode_attention", "decode_attention", "bf16", "decode_attention.py:133"),
             ("decode_attention", "decode_attention_int8", "int8", "decode_attention.py:133"),
             ("decode_attention", "decode_attention_window", "spec_bf16",
              "decode_attention.py:133"),
             ("int8_matmul", "int8_matmul", "int8", "int8_matmul.py:53"),
             ("int4_gemv", "int4_gemv", "int4", "int4_gemv.py:129"),
             ("block_sparse_matmul", "block_sparse_matmul", "pruned", "sparse_matmul.py:121"),
             ("fused_decode_step", "fused_decode_step", "fused_int8", "fused_step.py:1018"),
             # kernels of the port's own: no Pallas counterpart, the JAX package's XLA function
             ("dense_rows", "dense_rows", "bf16",
              "dia_tts_prune_tpu/ops/modules.py:45 (dense_general: XLA, no Pallas kernel)"),
             ("rms_norm", "rms_norm", "bf16",
              "dia_tts_prune_tpu/ops/modules.py:217 (rms_norm: XLA, no Pallas kernel)")]
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": f"{csrc}{SOURCES.get(name, name)}.cu",
         "core_route": rec.get("route"),
         "replaces": (replaces if replaces.startswith("dia_tts_prune_tpu/")
                      else jax_kernels + replaces),
         "launches": paths[path]["launches"].get(pick, paths[path]["launches"][name]),
         "max_abs_err": rec["max_abs_err"],
         "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
         "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
         "case": f"{rec.get('case', '')} {json.dumps(rec['shape'])} {rec['dtype']}"
                 f"{' density %.3f' % rec['density'] if 'density' in rec else ''}".strip(),
         "path": path}
        for name, pick, path, replaces in lines for rec in (picked[pick],)]})
    print(card, flush=True)
    print(f"# chip_smoke total {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
