"""Autoregressive generation (counterpart of ``dia_tts_prune_tpu/generate.py``:
single-stream ``generate_fused`` :460 / ``DiaGenerator.generate_tokens`` :865,
N streams at once, ``generate_fused_batch`` :546 / ``generate_tokens_batch``
:1047, and streaming, ``prepare_stream`` :713 / ``decode_segment`` :769 /
``generate_tokens_stream`` :944).

Conditioning (encoder + cross K/V, trimmed to a 128-bucket of the text
length) and the voice-prompt prefill run as one eager call each.  The decode
loop keeps its whole state on the device (``LoopState``, the JAX
``DecodeLoopState`` / ``BatchLoopState``) and has one body, ``loop_step``,
for one stream or N: the decode step, CFG, the bans, sampling, and the
per-token bookkeeping with the reference's exact semantics (dia/model.py:
748-815) as tensor arithmetic, with no host read:

* step ``t`` consumes buffer row ``t-1``, runs RoPE position ``t``, writes KV
  slot ``t-1`` and attends slots ``[0, t-1]``;
* EOS in channel 0 starts a ``max_delay`` countdown during which channel
  ``c`` is forced to EOS at offset ``delay[c]`` and to PAD after;
* the first ``max_delay`` steps keep the delayed BOS/PAD template rows;
* generation stops when the countdown reaches zero or ``max_tokens`` nears.

On the CPU (and on the card with ``loop="eager"``) the body runs one step at
a time, reading ``stop`` back after each.  On the card the default
``loop="graph"`` captures ``GRAPH_STEPS`` consecutive steps into one CUDA
graph and replays it until ``stop`` is set, one read-back a replay — the
JAX package's one-dispatch loop, a replay at a time.  One method runs an
exact number of steps (``DecodeRun.run``, ``segment_plan``: 16-step
replays, then replays of a one-step graph for the rest): a stream asks for
one segment at a time, its state kept on the device between them; a whole
call asks for the steps left to its cap, rounded up to whole replays.  The
buffers a graph reads (tokens, state, caches) are kept per key by the
``DiaGenerator``, so a second call of the same key replays without a new
capture.

With a packed decoder (``Dia.quantize_int8`` / ``quantize_int4``) the loop
also keeps both caches int8 (``models.dia.QuantKVCache``), as the JAX package
does on its accelerator: the self cache from the start, the cross cache once
the prefill has used its float form.  ``generate_tokens(kv_int8=...)`` takes
the place of the JAX package's ``DIA_KV_INT8`` environment variable.  A
decoder that also carries a ``fused_pack`` (``Dia.quantize_int8(fused=True)``)
runs every decode step, single-stream and batched, as one fused-step kernel
launch (``models.dia.decode_step_fused``; the JAX package's ``DIA_FUSED=1``);
the prompt prefill stays on the packed tree, as in the JAX package.

Sampling draws Gumbel noise from a ``torch.Generator`` seeded per call (one
per stream), so a seeded run repeats itself, graphed or eager; it cannot
repeat the JAX package's ``jax.random`` draws (greedy decoding is identical).

The batched loop runs 2N CFG rows ([uncond × N; cond × N]) with voice
prompts left-padded to one window, row-local RoPE positions, a first valid
cache slot per row (``decode_step(valid_from=...)``), and an EOS countdown
and a generator per stream, so each stream repeats its single-stream run —
bit for bit on the card too: each stream is conditioned at its
single-stream shape (``conditioning_batch``), and every op of a decode
step computes a row in an order that does not depend on the other rows.
"""

from __future__ import annotations

import random
import threading
import time
from collections import OrderedDict
from typing import NamedTuple

import numpy as np
import torch

from .config import DiaConfig
from .models.dia import (
    decode_step,
    decode_step_fused,
    decoder_prefill,
    encoder_forward,
    new_self_cache,
    precompute_cross_cache,
    quantize_cache,
)
from .ops.delay import revert_audio_delay_np
from .ops.kernels.decode_attention import ends_from_padding_mask
from .ops.quant import PACKED_TYPES
from .ops.sampling import apply_constraints, cfg_combine, sample_next_token
from .state import cross_attention_mask, new_encoder_state, prepare_audio_prompt
from .tokenizer import build_effective_text, encode_cfg_batch
from .utils.profiling import GenerationStats

CFG_BATCH = 2  # [uncond; cond] pair (reference: dia/model.py:360-362)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}  # the kernels' dtypes


def _resolve_seed(seed: int | None) -> int:
    """None → a fresh random seed (unseeded runs differ); an int as-is."""
    return random.randint(0, 2**31 - 1) if seed is None else int(seed)


def decoder_is_packed(params) -> bool:
    """True if the decoder's dense kernels are stored packed (int8 or int4
    with scales) — the trees that serve with int8 KV caches by default."""
    try:
        kernel = params["decoder"]["layers"]["mlp"]["wo"]["kernel"]
    except (KeyError, TypeError):
        return False
    return isinstance(kernel, PACKED_TYPES)


def step_function(params):
    """The decode step for these params: the fused whole-decoder-step kernel
    when the decoder carries a ``fused_pack`` (``Dia.quantize_int8(fused=
    True)``), else ``decode_step``."""
    return decode_step_fused if "fused_pack" in params["decoder"] else decode_step


def _bucket(n: int, mult: int, cap: int) -> int:
    """Round ``n`` up to a multiple of ``mult``, clamped to [mult, cap]."""
    return min(cap, max(mult, -(-int(n) // mult) * mult))


def _cross_window_for(enc_input: np.ndarray, config: DiaConfig) -> int | None:
    """Text-key bucket of the cross cache (128-multiples of the longest text)."""
    d = config.data
    text_len = int((np.asarray(enc_input) != d.text_pad_value).sum(axis=-1).max())
    w = _bucket(text_len, 128, d.text_length)
    return None if w >= d.text_length else w


def _cache_len_for(max_tokens: int, floor: int, config: DiaConfig) -> int | None:
    """Self-cache length bucket (256-multiples of ``max_tokens``)."""
    cap = config.data.audio_length
    n = _bucket(max(int(max_tokens), int(floor)), 256, cap)
    return None if n >= cap else n


@torch.no_grad()
def conditioning(params, config: DiaConfig, enc_input: torch.Tensor, compute_dtype,
                 cross_window: int | None):
    """Encoder pass and cross-attention K/V, trimmed to ``cross_window`` text
    keys (the trimmed keys are padding, masked for every row).  Returns
    (cross_cache, padding_mask [B, S], cross_ends int32 [B])."""
    enc_state = new_encoder_state(config, enc_input)
    enc_out = encoder_forward(params, config, enc_input, enc_state.positions, compute_dtype)
    positions, padding_mask = enc_state.positions, enc_state.padding_mask
    if cross_window is not None and cross_window < enc_out.shape[1]:
        enc_out = enc_out[:, :cross_window]
        positions = positions[:, :cross_window]
        padding_mask = padding_mask[:, :cross_window]
    cross_cache = precompute_cross_cache(params, config, enc_out, positions)
    cross_ends = ends_from_padding_mask(cross_attention_mask(padding_mask))
    return cross_cache, padding_mask, cross_ends


@torch.no_grad()
def conditioning_batch(params, config: DiaConfig, conds: list[np.ndarray], compute_dtype,
                       device):
    """N streams' conditioning, each at its single-stream shape: stream i's
    [uncond; cond] text rows ``conds[i]`` through ``conditioning`` with its
    own cross window, so that its cross K/V are those of its single-stream
    run bit for bit (a GEMM's kernel, and with it the order of its sums, may
    change with its row count).  Returned as ``conditioning`` returns them,
    rows [uncond × N; cond × N], the keys padded with zeros to the longest
    window (masked: past every row's end)."""
    parts = [conditioning(params, config, torch.from_numpy(c).to(device), compute_dtype,
                          _cross_window_for(c, config)) for c in conds]
    S = max(mask.shape[1] for _, mask, _ in parts)

    def rows(tensors, dim):  # [uncond × N; cond × N], padded to S along the key axis
        pad = [[0, 0] * (t.dim() - dim - 2) + [0, S - t.shape[dim + 1]] for t in tensors]
        padded = [torch.nn.functional.pad(t, p) for t, p in zip(tensors, pad)]
        return torch.cat([t.narrow(dim, r, 1) for r in (0, 1) for t in padded], dim=dim)

    cross = type(parts[0][0])(*(rows([p[0][i] for p in parts], 1)
                                for i in range(len(parts[0][0]))))
    padding_mask = rows([mask for _, mask, _ in parts], 0)
    cross_ends = torch.cat([torch.stack([ends[r] for _, _, ends in parts]) for r in (0, 1)])
    return cross, padding_mask, cross_ends


@torch.no_grad()
def run_prefill(params, config: DiaConfig, tokens_buf: np.ndarray, prefill_window: int,
                offsets: np.ndarray, prefill_steps: np.ndarray, cross_cache, padding_mask,
                self_cache, compute_dtype) -> None:
    """Write the prompts' K/V into cache slots [0, prefill_window) (the JAX
    ``_run_prefill``, generate.py:408).  ``tokens_buf`` [N, T, C] holds N
    streams, left-padded so that every prompt ends on row ``W - 1``: stream
    i's rows [offsets[i], W - 1) are valid (segment 1), its pads segment 0,
    and its last prompt row is left for the first loop step.  RoPE
    positions are row-local (``row - offsets[i]``), so a stream's numbers are
    those of its own unpadded run.  CFG rows are [uncond × N; cond × N]."""
    dev = padding_mask.device
    window = torch.from_numpy(np.clip(tokens_buf[:, :prefill_window], 0, None)).to(dev)
    tgt = torch.cat([window, window])  # [2N, W, C]
    rows = torch.arange(prefill_window, device=dev)[None]
    off2 = torch.from_numpy(np.concatenate([offsets, offsets]).astype(np.int64)).to(dev)[:, None]
    steps2 = torch.from_numpy(np.concatenate([prefill_steps, prefill_steps]).astype(np.int64))
    positions = (rows - off2).clamp_min(0)
    valid = ((rows >= off2) & (rows - off2 < steps2.to(dev)[:, None] - 1)).to(torch.int32)
    decoder_prefill(params, config, tgt, positions, cross_cache, self_cache, valid,
                    padding_mask.to(torch.int32), compute_dtype)


# ---------------------------------------------------------------------------
# The decode loop: one body on the device, run step by step or replayed from
# CUDA graphs
# ---------------------------------------------------------------------------

# Steps one captured CUDA graph holds.  A replay then runs 16 steps (64-100 ms
# at 4-6 ms a Dia-1.6B step on the H100), so the one read-back of ``stop`` a
# replay costs ~0.1% of it, while the at most 15 steps a replay runs past the
# stop cost <= 3% of a 512-step call, and capture time grows with the steps.
# A stream's segment ends on its exact step: its rest below 16 steps replays
# a one-step graph.
GRAPH_STEPS = 16
# Eager steps of the loop, run as real steps on the capture stream, before the
# first capture of a key: they build the kernels, cuBLAS's workspace of that
# stream and the wrappers' cached launch data, none of which may happen inside
# a capture.
WARMUP_STEPS = 2
GRAPH_CACHE = 4  # keys whose buffers and graph a generator keeps (least recently used out)
LOOPS = ("eager", "graph")


class Sampling(NamedTuple):
    """The sampling scalars of a call (its graph key's last entry): the
    values of its streams' ``LoopState`` sampling fields, and the top-k."""

    cfg_scale: float
    temperature: float
    top_p: float
    cfg_filter_top_k: int


class LoopState(NamedTuple):
    """The decode loop's carry, on the device (the JAX ``state.py::
    DecodeLoopState``, :52, ``generate.py::BatchLoopState``, :522, for
    N streams, and ``cbatch.py::CBState``, :78, for N lanes on their own
    timelines; one stream is N = 1).  The loop body updates it in place, so
    a CUDA graph that captured steps replays them on the same tensors.

    ``t`` and ``start`` are [1] when the streams run in lockstep (one call's
    streams: every prompt ends on row ``start - 1``) and [N] when each
    stream has its own timeline (``cbatch.ContinuousBatcher``'s lanes).  The
    fields from ``caps`` on are constants of a stream: a call's for its
    whole run, a lane's from its admission (``cbatch.swap_in``)."""

    tokens: torch.Tensor         # int32 [N, T, C] delayed rows (template, -1 beyond)
    prev_tok: torch.Tensor       # int32 [N, C]: each stream's last written row (its next input)
    bos_rows: torch.Tensor       # int32 [N, R, C]: rolling window of the template rows from start
    eos_detected: torch.Tensor   # bool [N]
    eos_countdown: torch.Tensor  # int32 [N] (-1 inactive)
    stopped: torch.Tensor        # bool [N]
    final_step: torch.Tensor     # int64 [N]: each stream's last completed step
    t: torch.Tensor              # int64 [1] or [N]: the step run last (the row it wrote)
    stop: torch.Tensor           # bool [1]: every stream stopped; a step then changes nothing
    start: torch.Tensor          # int64 [1] or [N]: the first loop row
    caps: torch.Tensor           # int64 [N]: each stream's total-row cap
    offsets2: torch.Tensor       # int64 [2N]: the CFG rows' RoPE offsets ([uncond × N; cond × N])
    valid_from: torch.Tensor     # int32 [2N]: the rows' first valid self-cache slots
    delay: torch.Tensor          # int32 [C]: the delay pattern
    cfg_scale: torch.Tensor      # fp32 [N]
    temperature: torch.Tensor    # fp32 [N] (a greedy stream's is not read)
    top_p: torch.Tensor          # fp32 [N]
    greedy: torch.Tensor         # bool [N]: argmax, the sampler's draw discarded


def new_loop_state(config: DiaConfig, tokens_buf: np.ndarray, start: int, offsets: np.ndarray,
                   caps: np.ndarray, device, clamp_window: bool,
                   sampling: Sampling) -> LoopState:
    """The state entering the loop at row ``start`` (host numbers, moved to
    the device once per call), every stream with ``sampling``'s values.
    ``clamp_window``: the single-stream ``_loop_entry_carries`` (:279), whose
    ``dynamic_slice`` clamps the template window's start to
    ``T - max_delay``; else the batched loop's plain slice (:702), which
    ends at the buffer's end."""
    d = config.data
    N, T, C = tokens_buf.shape
    w0 = min(start, T - d.max_delay) if clamp_window else start
    off = np.asarray(offsets, np.int64)
    caps = np.asarray(caps, np.int64)

    def dev(a, dtype):  # a copy: no field may share memory with tokens_buf or another
        return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)

    def per_stream(value, dtype=torch.float32):
        return torch.full((N,), value, dtype=dtype, device=device)

    return LoopState(
        tokens=dev(tokens_buf, torch.int32),
        prev_tok=dev(tokens_buf[:, start - 1], torch.int32),
        bos_rows=dev(tokens_buf[:, w0:w0 + d.max_delay], torch.int32),
        eos_detected=torch.zeros(N, dtype=torch.bool, device=device),
        eos_countdown=torch.full((N,), -1, dtype=torch.int32, device=device),
        stopped=torch.zeros(N, dtype=torch.bool, device=device),
        final_step=torch.full((N,), start - 1, dtype=torch.int64, device=device),
        t=torch.full((1,), start - 1, dtype=torch.int64, device=device),
        stop=torch.full((1,), bool(start - 1 >= caps.max() - 1), device=device),
        start=torch.full((1,), start, dtype=torch.int64, device=device),
        caps=dev(caps, torch.int64),
        offsets2=dev(np.concatenate([off, off]), torch.int64),
        valid_from=dev(np.concatenate([off, off]), torch.int32),
        delay=dev(np.asarray(d.delay_pattern), torch.int32),
        cfg_scale=per_stream(sampling.cfg_scale),
        temperature=per_stream(sampling.temperature),
        top_p=per_stream(sampling.top_p),
        greedy=per_stream(sampling.temperature == 0.0, torch.bool))


def sample_streams(guided: torch.Tensor, s: LoopState, top_k: int,
                   generators: list | None) -> torch.Tensor:
    """Each stream's next tokens [N, C] from its guided logits [N, C, V] and
    its ``LoopState`` sampling fields, with no host read (the JAX
    ``cb_segment``'s sampling, cbatch.py:302-311).  Without generators every
    stream is greedy (argmax).  Otherwise every stream runs the sampler on
    its own generator, with its temperature as a device tensor (the one form
    of ``ops.sampling``), and a greedy stream takes the argmax, its draw run
    at temperature 1 and discarded."""
    argmax = torch.argmax(guided, dim=-1)
    if generators is None:
        return argmax
    temperature = torch.where(s.greedy, 1.0, s.temperature)
    sampled = torch.stack([
        sample_next_token(guided[i], temperature[i], s.top_p[i], top_k, generator=generators[i])
        for i in range(guided.shape[0])])
    return torch.where(s.greedy[:, None], argmax, sampled)


def loop_step(s: LoopState, step, params, config: DiaConfig, self_cache, cross_cache,
              cross_ends, top_k: int, generators: list | None, compute_dtype) -> None:
    """One step of the decode loop, in place on ``s`` and the self cache, all
    on the device: no host read, so a CUDA graph can hold it.  The JAX loop
    bodies (``_make_loop_body``, :207-276; ``generate_fused_batch``'s,
    :625-698; ``cb_segment``'s, cbatch.py:284-379) in their order: the step
    at row ``t = s.t + 1`` (RoPE position ``t - offset``, K/V slot
    ``t - 1``), CFG, the constraint bans, one sampling call per stream with
    that stream's generator, the EOS state machine (reference:
    dia/model.py:771-797), the BOS-window masked write (:790-792), the
    per-stream stop and the near-max trigger (:800-804).
    A stopped stream is still stepped and sampled but never written, and
    keeps its last token as input (its rows touch no other row's numbers);
    on its own timeline it also keeps its ``t``, so that its steps re-run
    one row and its K/V commit stays in its own last slot.  With ``t`` [N]
    the step gets one write slot a row, with ``t`` [1] one for every row
    (which the fused step needs); the tokens are written a row a stream
    either way.  Once ``s.stop`` is set a step
    changes nothing that is read later: every field keeps its value, the
    tokens rows are rewritten with themselves, the K/V slots (clamped into
    the cache) are past every stream's last step."""
    d = config.data
    max_delay, eos, pad = d.max_delay, d.audio_eos_value, d.audio_pad_value
    N, T = s.tokens.shape[:2]
    lanes = s.t.shape[0] != 1  # each stream on its own timeline
    halt = s.stop
    t = s.t + 1  # [1] or [N]
    t2 = torch.cat([t, t]) if lanes else t  # the CFG rows' steps
    tgt = torch.cat([s.prev_tok, s.prev_tok])[:, None]  # [2N, 1, C]: the CFG pair per stream
    position = (t2 - s.offsets2)[:, None]  # [2N, 1] row-local RoPE positions
    slot = (t2 - 1).clamp(0, self_cache.k.shape[2] - 1)
    logits = step(params, config, tgt, position, slot, self_cache, cross_cache, cross_ends,
                  compute_dtype, valid_from=s.valid_from)  # [2N, 1, C, V]
    guided = apply_constraints(cfg_combine(logits[:, 0].unflatten(0, (2, N)),
                                           s.cfg_scale[:, None, None]),
                               eos, pad, d.audio_bos_value)  # [N, C, V]
    pred = sample_streams(guided, s, top_k, generators).to(torch.int32)  # [N, C]

    newly_eos = ~s.eos_detected & (pred[:, 0] == eos)
    eos_detected = s.eos_detected | newly_eos
    countdown = torch.where(newly_eos, max_delay, s.eos_countdown)
    active = (countdown > 0)[:, None]
    step_after = (max_delay - countdown)[:, None]
    pred = torch.where(active & (step_after == s.delay), eos,
                       torch.where(active & (step_after > s.delay) & (pred != eos), pad, pred))
    countdown = torch.where(countdown > 0, countdown - 1, countdown)

    # each prompt ends on row start - 1: the write-protected window is a
    # stream's first max_delay - 1 steps, and row is the template at t
    k = (t - s.start)[:, None]
    row = torch.where(k < max_delay, s.bos_rows[:, 0], -1)
    write = torch.where((k < max_delay - 1) & (row != -1), row, pred)
    rows, at = torch.arange(N, device=t.device), t.expand(N).clamp(max=T - 1)
    live = ~(s.stopped | halt)[:, None]
    kept = s.tokens[rows, at]  # one row a stream, at its t
    s.tokens.index_put_((rows, at), torch.where(live, write, kept))

    stop_now = (countdown == 0) & ~s.stopped
    hit_cap = (t >= s.caps - 1) & ~s.stopped & ~stop_now
    final_step = torch.where(s.stopped, s.final_step, torch.where(stop_now, t - 1, t))
    stopped = s.stopped | stop_now | hit_cap
    near_max = (t >= s.caps - max_delay - 1) & ~eos_detected
    new = dict(prev_tok=torch.where(s.stopped[:, None], s.prev_tok, write),
               bos_rows=torch.roll(s.bos_rows, -1, dims=1),
               eos_detected=eos_detected | near_max,
               eos_countdown=torch.where(near_max, max_delay, countdown),
               stopped=stopped, final_step=final_step,
               t=torch.where(s.stopped, s.t, t) if lanes else t,
               stop=stopped.all().reshape(1))
    for name, value in new.items():
        held = getattr(s, name)
        held.copy_(torch.where(halt, held, value))


class LoopBuffers:
    """The tensors a decode loop runs on, and the CUDA graphs captured over
    them.  A generator keeps one per key (``DiaGenerator._buffers``): the
    first call's tensors stay, later calls copy their data in (``put``), so
    that the graphs captured by the first call replay on every later one.
    A fresh one (the eager loop) keeps nothing: ``put`` hands values back."""

    def __init__(self, device: torch.device | None = None):
        self.held: dict = {}
        self.keep = device is not None
        self.stream = torch.cuda.Stream(device) if self.keep else None
        self.graph = None  # GRAPH_STEPS steps
        self.step_graph = None  # one step: the rest of a segment (``segment_plan``)
        self.gens: list | None = None

    @property
    def captured(self) -> bool:
        """A graph of this key was captured: its warm-up steps have run."""
        return self.graph is not None or self.step_graph is not None

    def put(self, name: str, value):
        """``value`` (a tensor or a tuple of tensors) as this key's static
        ``name``: the first call's own tensors, later calls' data copied
        into them."""
        if not self.keep:
            return value
        held = self.held.get(name)
        if held is None:
            self.held[name] = value
            return value
        for h, v in zip(*((held, value) if isinstance(held, tuple) else ((held,), (value,)))):
            h.copy_(v)
        return held

    def generators(self, device, seeds: list[int]) -> list:
        """One ``torch.Generator`` a stream, seeded; the same objects on every
        call of a kept key (a captured graph reads their state)."""
        if not self.keep or self.gens is None:
            self.gens = [torch.Generator(device=device) for _ in seeds]
        for g, seed in zip(self.gens, seeds):
            g.manual_seed(seed)
        return self.gens


def segment_plan(steps: int, captured: bool) -> tuple[int, int, int]:
    """How the graph loop runs exactly ``steps`` steps: (eager warm-up steps,
    replays of the ``GRAPH_STEPS`` graph, replays of the one-step graph).
    A key that has captured neither graph yet warms up first.  Every step draws
    from each stream's generator, so a segment that ran past its end would
    shift a seeded stream's later draws: the rest below ``GRAPH_STEPS`` runs
    one step a replay."""
    warm = 0 if captured else min(WARMUP_STEPS, steps)
    replays, singles = divmod(steps - warm, GRAPH_STEPS)
    return warm, replays, singles


def _run_eager(state: LoopState, body, stats: GenerationStats, steps: int) -> None:
    """``steps`` steps from Python, fewer once ``stop`` is set: the eager
    loop, and the graph loop's warm-up."""
    n = 0
    while n < steps and not bool(state.stop):
        body()
        n += 1
        stats.host_steps += 1


def _capture(body, buffers: LoopBuffers, stats: GenerationStats, steps: int):
    """``steps`` consecutive steps captured into one graph on the buffers'
    stream, the generators registered with it: their Philox offsets advance
    on replay as in eager calls.  A capture that fails raises."""
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    for g in buffers.gens or ():
        graph.register_generator_state(g)
    with torch.cuda.graph(graph, stream=buffers.stream):
        for _ in range(steps):
            body()
    graph.instantiate()
    stats.capture_seconds += time.perf_counter() - t0
    stats.captures += 1
    stats.host_steps += steps
    return graph


def _replay(graph, stats: GenerationStats, events: list, steps: int) -> None:
    ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
    ev[0].record()
    t0 = time.perf_counter()
    graph.replay()
    stats.replay_launch_seconds += time.perf_counter() - t0
    ev[1].record()
    events.append((ev, steps))


def _run_graphs(state: LoopState, body, buffers: LoopBuffers, stats: GenerationStats,
                steps: int) -> None:
    """Exactly ``steps`` steps (``segment_plan``), fewer only once ``stop``
    is set, as CUDA graph replays on the buffers' stream: one read-back of
    ``stop`` a ``GRAPH_STEPS`` replay, none between one-step replays (steps
    past the stop change nothing).  Each graph is captured on the first
    call of its key that needs it."""
    s = buffers.stream
    s.wait_stream(torch.cuda.current_stream())
    events: list = []
    with torch.cuda.stream(s):
        warm, replays, singles = segment_plan(steps, buffers.captured)
        _run_eager(state, body, stats, warm)
        if replays and buffers.graph is None and not bool(state.stop):
            buffers.graph = _capture(body, buffers, stats, GRAPH_STEPS)
        for _ in range(replays):
            if bool(state.stop):
                break
            _replay(buffers.graph, stats, events, GRAPH_STEPS)
        if singles and not bool(state.stop):
            if buffers.step_graph is None:
                buffers.step_graph = _capture(body, buffers, stats, 1)
            for _ in range(singles):
                _replay(buffers.step_graph, stats, events, 1)
    torch.cuda.current_stream().wait_stream(s)
    if events:  # a segment's last replays were not waited for
        events[-1][0][1].synchronize()
    stats.graph_steps = GRAPH_STEPS
    stats.replays += sum(n == GRAPH_STEPS for _, n in events)
    stats.step_replays += sum(n == 1 for _, n in events)
    stats.replay_device_seconds += sum(a.elapsed_time(b) for (a, b), _ in events) / 1e3


class DecodeRun:
    """A decode loop over N streams from row ``start`` (the JAX
    ``_decode_loop_core``, :290, ``generate_fused_batch``'s loop and
    ``decode_segment``, :769), resumable: its state on the device
    (``new_loop_state``) and ``loop_step`` as its body, on the buffers'
    tensors.  ``run(steps)`` runs a segment of exactly ``steps`` steps,
    ``run()`` the rest to the stop (one runner for streams and whole calls;
    ``finish`` reads a whole call back); ``loop="eager"`` one
    step at a time (a read of ``stop`` a step), ``"graph"`` replayed from
    CUDA graphs (the card only)."""

    def __init__(self, params, config: DiaConfig, tokens_buf: np.ndarray, self_cache, cross_cache,
                 cross_ends, start: int, offsets: np.ndarray, caps: np.ndarray,
                 sampling: Sampling, generators: list | None, compute_dtype, loop: str,
                 buffers: LoopBuffers | None, stats: GenerationStats | None,
                 clamp_window: bool):
        if loop not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}, got {loop!r}")
        dev = cross_ends.device
        if loop == "graph" and dev.type != "cuda":
            raise ValueError("loop='graph' needs CUDA tensors")
        self.loop, self.start = loop, start
        self.buffers = buffers or LoopBuffers()
        self.stats = stats if stats is not None else GenerationStats()
        self.stats.loop = loop
        self.state = state = self.buffers.put(
            "state", new_loop_state(config, tokens_buf, start, offsets, caps, dev, clamp_window,
                                    sampling))
        step = step_function(params)

        def body():
            loop_step(state, step, params, config, self_cache, cross_cache, cross_ends,
                      sampling.cfg_filter_top_k, generators, compute_dtype)

        self.body = body

    def run(self, steps: int | None = None) -> None:
        """Exactly ``steps`` steps further, fewer only once ``stop`` is set.
        None: the steps left to the largest cap, which stop every stream; on
        the graph loop rounded up to whole ``GRAPH_STEPS`` replays (the steps
        past the stop change nothing, and no one-step graph is captured)."""
        whole = steps is None
        if whole:
            steps = max(0, int(self.state.caps.max() - 1 - self.state.t))
            if self.loop == "graph":
                steps += -segment_plan(steps, self.buffers.captured)[2] % GRAPH_STEPS
        if self.loop == "eager":
            _run_eager(self.state, self.body, self.stats, steps)
        else:
            _run_graphs(self.state, self.body, self.buffers, self.stats, steps)
        if whole and not bool(self.state.stop):
            raise RuntimeError("decode loop: the last cap was reached with a stream not stopped")
        self.stats.decode_steps = int(self.state.t.item()) - self.start + 1

    def finish(self, tokens_buf: np.ndarray) -> np.ndarray:
        """Run to the stop, copy the rows back into ``tokens_buf`` (host,
        the shape given at the start) and return each stream's last
        completed step."""
        self.run()
        tokens_buf[...] = self.state.tokens.cpu().numpy().reshape(tokens_buf.shape)
        return self.state.final_step.cpu().numpy()


def single_run(params, config: DiaConfig, tokens_buf: np.ndarray, self_cache, cross_cache,
               cross_ends, prefill_step: int, max_tokens: int, cfg_scale: float,
               temperature: float, top_p: float, cfg_filter_top_k: int,
               generator: torch.Generator | None, compute_dtype, loop: str = "eager",
               buffers: LoopBuffers | None = None,
               stats: GenerationStats | None = None) -> DecodeRun:
    """The single-stream ``DecodeRun`` (``generate_fused``'s loop, :460, or
    ``prepare_stream``'s state, :713): stream one from row ``prefill_step``
    up to ``max_tokens`` rows of ``tokens_buf`` [T, C]."""
    return DecodeRun(
        params, config, tokens_buf[None], self_cache, cross_cache, cross_ends, prefill_step,
        np.zeros(1, np.int64), np.asarray([max_tokens]),
        Sampling(cfg_scale, temperature, top_p, cfg_filter_top_k),
        None if generator is None else [generator], compute_dtype, loop, buffers, stats,
        clamp_window=True)


@torch.no_grad()
def decode_loop(params, config: DiaConfig, tokens_buf: np.ndarray, *args, **kwargs) -> int:
    """``single_run``'s loop run to the stop in one call: fills
    ``tokens_buf`` [T, C] in place and returns the last completed step."""
    run = single_run(params, config, tokens_buf, *args, **kwargs)
    return int(run.finish(tokens_buf)[0])


@torch.no_grad()
def decode_loop_batch(params, config: DiaConfig, tokens_buf: np.ndarray, self_cache, cross_cache,
                      cross_ends, start: int, offsets: np.ndarray, caps: np.ndarray,
                      cfg_scale: float, temperature: float, top_p: float, cfg_filter_top_k: int,
                      generators: list | None, compute_dtype, loop: str = "eager",
                      buffers: LoopBuffers | None = None,
                      stats: GenerationStats | None = None) -> np.ndarray:
    """The N-stream decode loop (``generate_fused_batch``'s body,
    generate.py:625-698): all streams advance in lockstep from row
    ``start``, each with its own RoPE positions (``t - offsets[i]``), its
    own first valid cache slot, its own EOS countdown and its own generator,
    so that stream i repeats its single-stream run.  A finished stream stops
    being written; its rows keep running until every stream has stopped or
    the longest cap is reached.  Fills ``tokens_buf`` [N, T, C] in place and
    returns each stream's last completed step."""
    return DecodeRun(params, config, tokens_buf, self_cache, cross_cache, cross_ends, start,
                     offsets, caps, Sampling(cfg_scale, temperature, top_p, cfg_filter_top_k),
                     generators, compute_dtype, loop, buffers, stats,
                     clamp_window=False).finish(tokens_buf)


def _undelay(generated: np.ndarray, config: DiaConfig) -> np.ndarray:
    """Generated delayed rows [T, C] → codec tokens: delay reverted, the
    ``max_delay`` tail trimmed, out-of-codebook values clamped to 0
    (reference: dia/model.py:490-530)."""
    d = config.data
    if generated.shape[0] == 0:
        return np.zeros((0, d.channels), dtype=np.int32)
    reverted = revert_audio_delay_np(generated[None], d.audio_pad_value, tuple(d.delay_pattern),
                                     generated.shape[0])[0]
    reverted = reverted[: max(0, reverted.shape[0] - d.max_delay)]
    return np.where((reverted < 0) | (reverted > 1023), 0, reverted).astype(np.int32)


class DiaGenerator:
    """Generation orchestrator (reference API: dia/model.py:631-846).

    Safe to call from many threads: ``lock`` lets one call at a time do its
    device work (the ``Dia`` around it takes it for codec work too).  A
    kept key's buffers are shared by its calls, and a CUDA graph capture
    fails if another thread works on the card meanwhile.  A stream takes
    the lock for each segment and owns its key's buffers, out of the kept
    ones, from its first segment until it ends or is closed."""

    def __init__(self, params, config: DiaConfig, compute_dtype: str = "float32",
                 device: str | torch.device = "cuda"):
        self.params = params
        self.config = config
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self._graphs: OrderedDict[tuple, LoopBuffers] = OrderedDict()
        self.lock = threading.RLock()
        self.last_stats: GenerationStats | None = None  # the last call's, for callers that report

    def _loop(self, loop: str | None) -> str:
        """``loop`` as given; None: CUDA graphs on the card, eager on the CPU."""
        loop = loop or ("graph" if self.device.type == "cuda" else "eager")
        if loop not in LOOPS:
            raise ValueError(f"loop must be one of {LOOPS}, got {loop!r}")
        if loop == "graph" and self.device.type != "cuda":
            raise ValueError("loop='graph' needs CUDA tensors")
        return loop

    def _buffers(self, loop: str, key: tuple, own: bool = False) -> LoopBuffers:
        """The kept buffers (and graphs) of ``key`` for the graph loop, the
        ``GRAPH_CACHE`` most recently used kept; fresh ones for the eager
        loop.  The key holds every shape and constant a captured step
        depends on: streams, self-cache length, cross window, int8 caches,
        the ``Sampling`` scalars, last (the params are the generator's own).
        ``own``: taken out of the kept ones until ``_release``."""
        if loop != "graph":
            return LoopBuffers()
        buffers = self._graphs.pop(key, None) or LoopBuffers(self.device)
        if not own:
            self._keep(key, buffers)
        return buffers

    def _keep(self, key: tuple, buffers: LoopBuffers) -> None:
        self._graphs[key] = buffers
        while len(self._graphs) > GRAPH_CACHE:
            self._graphs.popitem(last=False)

    def _release(self, key: tuple, buffers: LoopBuffers) -> None:
        """Owned buffers back among the kept ones, unless a call of the key
        made its own meanwhile."""
        if buffers.keep and key not in self._graphs:
            self._keep(key, buffers)

    def _start(self, text: str, max_tokens: int, cfg_scale: float, temperature: float,
               top_p: float, cfg_filter_top_k: int, audio_prompt_codes: np.ndarray | None,
               audio_prompt_text: str | None, seed: int | None, cache_len: int | None,
               kv_int8: bool | None, loop: str | None, own: bool):
        """One stream up to its decode loop: conditioning and the voice-prompt
        prefill.  Returns (the arguments of ``decode_loop`` / ``single_run``
        for the loop from row ``prefill_step``, key, buffers)."""
        cfg = self.config
        d = cfg.data
        dtype = DTYPES[self.compute_dtype]
        if audio_prompt_codes is not None and not audio_prompt_text:
            raise ValueError(
                "`audio_prompt_text` is required when `audio_prompt_codes` is provided.")
        effective_text = build_effective_text(text, audio_prompt_text)
        enc_input = encode_cfg_batch(effective_text, d.text_length, d.text_pad_value)

        delayed, prefill_step = prepare_audio_prompt(cfg, audio_prompt_codes)
        tokens_buf = np.full((d.audio_length, d.channels), -1, dtype=np.int32)
        tokens_buf[: delayed.shape[0]] = delayed
        window = _bucket(prefill_step - 1, 128, d.audio_length) if prefill_step > 1 else None
        cache_len = _cache_len_for(max_tokens if cache_len is None else cache_len,
                                   window or 0, cfg)
        loop = self._loop(loop)
        cross_window = _cross_window_for(enc_input, cfg)
        if kv_int8 is None:
            kv_int8 = decoder_is_packed(self.params)
        key = (1, cache_len, cross_window, kv_int8, Sampling(
            cfg_scale, temperature, top_p, cfg_filter_top_k))
        buffers = self._buffers(loop, key, own)
        generator = None
        if temperature != 0.0:
            generator = buffers.generators(self.device, [_resolve_seed(seed)])[0]

        stats = GenerationStats()
        cross_cache, padding_mask, cross_ends = conditioning(
            self.params, cfg, torch.from_numpy(enc_input).to(self.device), dtype, cross_window)
        self_cache = buffers.put("self", new_self_cache(cfg, CFG_BATCH, cache_len, dtype,
                                                        self.device, quant=kv_int8))
        if window is not None:
            run_prefill(self.params, cfg, tokens_buf[None], window, np.zeros(1, np.int64),
                        np.asarray([prefill_step]), cross_cache, padding_mask, self_cache, dtype)
        if kv_int8:  # prefill's flash attention reads the float cross cache
            cross_cache = quantize_cache(cross_cache)
        args = (self.params, cfg, tokens_buf, self_cache, buffers.put("cross", cross_cache),
                buffers.put("ends", cross_ends), prefill_step, max_tokens, cfg_scale,
                temperature, top_p, cfg_filter_top_k, generator, dtype, loop, buffers, stats)
        return args, key, buffers

    @torch.no_grad()
    def generate_tokens(
        self,
        text: str,
        max_tokens: int | None = None,
        cfg_scale: float = 3.0,
        temperature: float = 1.3,
        top_p: float = 0.95,
        cfg_filter_top_k: int = 35,
        audio_prompt_codes: np.ndarray | None = None,
        audio_prompt_text: str | None = None,
        seed: int | None = None,
        verbose: bool = False,
        cache_len: int | None = None,
        kv_int8: bool | None = None,
        loop: str | None = None,
    ) -> np.ndarray:
        """Text → undelayed codec tokens [T, C] (delay reverted, tail trimmed,
        out-of-codebook values clamped to 0).  ``kv_int8``: int8 self and
        cross caches; None = on iff the decoder's kernels are packed.
        ``loop``: ``"graph"`` (the default on the card) replays the decode
        loop from CUDA graphs, captured once per key (streams, cache length,
        cross window, int8 caches, sampling scalars) and kept for later calls
        of that key; ``"eager"`` (the default on the CPU) steps from Python.
        Both run the same kernels in the same order (``loop_step``).  The
        call's ``GenerationStats`` land in ``last_stats``."""
        d = self.config.data
        max_tokens = d.audio_length if max_tokens is None else min(max_tokens, d.audio_length)
        with self.lock:
            args, _, _ = self._start(
                text, max_tokens, cfg_scale, temperature, top_p, cfg_filter_top_k,
                audio_prompt_codes, audio_prompt_text, seed, cache_len, kv_int8, loop, own=False)
            final_step = decode_loop(*args)
            tokens_buf, prefill_step, stats = args[2], args[6], args[-1]
            self.last_stats = stats.finish(stats.decode_steps, prefill_step - 1)
        if verbose:
            print(f"generate: {stats.decode_steps} steps in {stats.wall_seconds:.3f}s "
                  f"({stats.tokens_per_second:.2f} tokens/s, {stats.loop} loop)")

        return _undelay(tokens_buf[prefill_step: final_step + 1], self.config)  # (model.py:831)

    @torch.no_grad()
    def generate_tokens_stream(
        self,
        text: str,
        segment_steps: int = 128,
        max_tokens: int | None = None,
        cfg_scale: float = 3.0,
        temperature: float = 1.3,
        top_p: float = 0.95,
        cfg_filter_top_k: int = 35,
        audio_prompt_codes: np.ndarray | None = None,
        audio_prompt_text: str | None = None,
        seed: int | None = None,
        cache_len: int | None = None,
        kv_int8: bool | None = None,
        loop: str | None = None,
    ):
        """Stream undelayed codec frames as generation goes on (the JAX
        ``generate_tokens_stream``, generate.py:944): the decode loop runs in
        segments of exactly ``segment_steps`` steps on one kept state
        (``DecodeRun.run(steps)``), and after each the newly final frames
        are yielded (a frame is final once every delayed row it gathers from
        exists: the last ``max_delay`` rows stay pending).  The yields
        concatenate to ``generate_tokens``'s codes for the same arguments bit
        for bit, voice prompts and seeded sampling included.

        Each segment is run, and its new rows read back, before the next is
        started (the JAX package's ``DIA_STREAM_PIPELINE=0``): the device
        waits while the caller handles a chunk, and no step runs that the
        caller may not want.  The stream owns its key's buffers until it ends
        or is closed, and takes ``lock`` for each segment only."""
        if segment_steps < 1:
            raise ValueError(f"segment_steps must be positive, got {segment_steps}")
        d = self.config.data
        max_tokens = d.audio_length if max_tokens is None else min(max_tokens, d.audio_length)
        owned = None  # (key, buffers) while the stream holds them
        try:
            with self.lock:
                args, *owned = self._start(
                    text, max_tokens, cfg_scale, temperature, top_p, cfg_filter_top_k,
                    audio_prompt_codes, audio_prompt_text, seed, cache_len, kv_int8, loop,
                    own=True)
                run = single_run(*args)
            tokens_buf, prefill_step = args[2], args[6]
            emitted, read_to, t = 0, prefill_step, prefill_step - 1
            seg_end = prefill_step - 1
            while True:
                seg_end = min(seg_end + segment_steps, max_tokens - 1)
                with self.lock:
                    run.run(max(0, seg_end - t))
                    final, t, stop = (int(v) for v in torch.cat(
                        [run.state.final_step, run.state.t, run.state.stop.long()]).cpu())
                    if final + 1 > read_to:  # the rows this segment completed
                        tokens_buf[read_to: final + 1] = \
                            run.state.tokens[0, read_to: final + 1].cpu().numpy()
                        read_to = final + 1
                    self.last_stats = run.stats.finish(run.stats.decode_steps, prefill_step - 1)
                n_final = max(0, final + 1 - prefill_step - d.max_delay)
                if n_final > emitted:
                    yield _undelay(tokens_buf[prefill_step + emitted: final + 1], self.config)
                    emitted = n_final
                if stop or t >= max_tokens - 1:
                    return
        finally:
            if owned:
                with self.lock:
                    self._release(*owned)

    @torch.no_grad()
    def generate_tokens_batch(
        self,
        texts: list[str],
        max_tokens: int | None = None,
        cfg_scale: float = 3.0,
        temperature: float = 1.3,
        top_p: float = 0.95,
        cfg_filter_top_k: int = 35,
        audio_prompt_codes: list[np.ndarray | None] | None = None,
        audio_prompt_texts: list[str | None] | None = None,
        seed: int | None = None,
        seeds: list[int | None] | None = None,
        cache_len: int | None = None,
        kv_int8: bool | None = None,
        loop: str | None = None,
    ) -> list[np.ndarray]:
        """N texts → N undelayed token arrays, decoded together in one loop
        over 2N CFG rows (the JAX ``generate_tokens_batch``, generate.py:1047,
        with ``generate_fused_batch``'s semantics): every stream shares each
        step's weight reads.

        Voice prompts may differ per stream: the delayed templates are
        left-padded to a shared 128-bucket window so that every prompt ends
        on one row, with row-local RoPE positions and per-row first valid
        cache slots.  ``seeds`` gives each stream its own seed (None entries a
        fresh one), ``seed`` one seed to all; each stream samples from its own
        ``torch.Generator``.  So stream i repeats its single-stream run with
        that seed whatever streams ride with it.  ``loop`` as in
        ``generate_tokens``: one loop over all streams, graphed on the card."""
        cfg = self.config
        d = cfg.data
        dtype = DTYPES[self.compute_dtype]
        max_tokens = d.audio_length if max_tokens is None else min(max_tokens, d.audio_length)
        N = len(texts)
        if N == 0:
            return []
        prompts = audio_prompt_codes or [None] * N
        prompt_texts = audio_prompt_texts or [None] * N
        if len(prompts) != N or len(prompt_texts) != N:
            raise ValueError("audio prompt lists must match len(texts)")
        for p, pt in zip(prompts, prompt_texts):
            if p is not None and not pt:
                raise ValueError("`audio_prompt_texts[i]` is required when "
                                 "`audio_prompt_codes[i]` is provided.")
        conds = [encode_cfg_batch(build_effective_text(t, pt), d.text_length, d.text_pad_value)
                 for t, pt in zip(texts, prompt_texts)]

        templates = [prepare_audio_prompt(cfg, p) for p in prompts]
        prefill_steps = np.asarray([t[1] for t in templates], np.int64)
        max_p = int(prefill_steps.max())
        window = None
        if max_p > 1:
            # all streams start generating at row `window`: the exact window
            # when the bucket would eat the generation budget
            window = _bucket(max_p, 128, d.audio_length)
            if window > d.audio_length - 32:
                window = max_p
        start = window if window is not None else 1
        offsets = start - prefill_steps
        tokens_buf = np.full((N, d.audio_length, d.channels), -1, dtype=np.int32)
        for i, (delayed, _) in enumerate(templates):
            tokens_buf[i, offsets[i]: offsets[i] + delayed.shape[0]] = delayed
        caps = np.minimum(max_tokens + offsets, d.audio_length)

        if seeds is not None:
            if len(seeds) != N:
                raise ValueError("seeds must match len(texts)")
            seed_list = [_resolve_seed(s) for s in seeds]
        else:
            seed_list = [_resolve_seed(seed) for _ in range(N)]
        with self.lock:
            loop = self._loop(loop)
            if kv_int8 is None:
                kv_int8 = decoder_is_packed(self.params)
            self_len = _cache_len_for(cache_len or int(caps.max()), start, cfg)
            cross_window = max(_cross_window_for(c, cfg) or d.text_length for c in conds)
            buffers = self._buffers(loop, (N, self_len, cross_window, kv_int8, Sampling(
                cfg_scale, temperature, top_p, cfg_filter_top_k)))
            generators = None
            if temperature != 0.0:
                generators = buffers.generators(self.device, seed_list)

            stats = GenerationStats()
            cross_cache, padding_mask, cross_ends = conditioning_batch(
                self.params, cfg, conds, dtype, self.device)
            self_cache = buffers.put("self", new_self_cache(cfg, 2 * N, self_len, dtype,
                                                            self.device, quant=kv_int8))
            if window is not None:
                run_prefill(self.params, cfg, tokens_buf, window, offsets, prefill_steps,
                            cross_cache, padding_mask, self_cache, dtype)
            if kv_int8:
                cross_cache = quantize_cache(cross_cache)
            final_steps = decode_loop_batch(
                self.params, cfg, tokens_buf, self_cache, buffers.put("cross", cross_cache),
                buffers.put("ends", cross_ends), start, offsets, caps, cfg_scale, temperature,
                top_p, cfg_filter_top_k, generators, dtype, loop=loop, buffers=buffers,
                stats=stats)
            self.last_stats = stats.finish(stats.decode_steps, start - 1)
        return [_undelay(tokens_buf[i, start: int(final_steps[i]) + 1], cfg) for i in range(N)]
