"""Speculative decoding: layer-skip self-draft and a one-pass verify window
(counterpart of ``dia_tts_prune_tpu/speculative.py``).

The first ``n_draft_layers`` decoder layers draft W-1 tokens one at a time,
leaving early through the shared final norm and logits head
(``models.dia.decode_step(n_layers=...)``); one full-model pass over the
W rows (``models.dia.decode_step`` on a window) then scores them, and the longest
prefix that keeps the output distribution is accepted:

* **greedy** — token-exact with the decode loop: a draft is kept only while
  the full model's constrained CFG argmax equals it, the first mismatch is
  replaced by the full model's own argmax, and a step whose full-model token
  is EOS ends the window unwritten, so that the loop regenerates it and runs
  the EOS countdown as it always does.  On the card the verify pass's row
  ``i`` computes, bit for bit, what the loop's step at that row computes
  (the decode-attention kernel's window form; every float product at a
  fixed row count), so the codes equal the graphed loop's;
* **sampled** — channelwise rejection sampling (accept the draft with
  probability min(1, p/q), else draw from the residual max(p - q, 0)): every
  emitted step is a draw from the full model's filtered distribution.  The
  draft's q comes from a second window pass over the first
  ``n_draft_layers`` layers, as in the JAX package; it writes those layers'
  slots again with the values the verify pass just wrote there.  Draws come
  from the stream's ``torch.Generator``, so they cannot repeat the JAX
  package's ``jax.random`` draws; a seed repeats itself.

``SpeculativeGenerator`` runs a call in three stages on one
``generate.DecodeRun``: the BOS write-protect window through the loop
(``run(steps)``), windows while no stream stopped or saw EOS and the next
window fits well before the cap, and the tail through the loop (``run()``).
A window has no host read inside; one read-back of its advance after it is
the host's pacing.  On the card each window is one CUDA graph replay, the
graph captured once per (window, draft layers) in the ``LoopBuffers`` of
the call's loop key, which the ``DiaGenerator`` keeps, so a second call
replays without a capture; ``loop="eager"`` steps the window from Python.

Both caches stay float on every route, packed decoders included (the JAX
path's ``kv_quant=False``).  The draft and the verify pass run the
per-layer tree, never the fused step, as the JAX ``spec_window`` runs
``decode_step_scan``.  Single-stream only, as in the JAX package.  A
generator under a mesh raises: speculation has no tensor-parallel form (the
JAX package has none under a mesh either).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .config import DiaConfig
from .generate import (
    DiaGenerator,
    LoopBuffers,
    LoopState,
    _capture,
    _undelay,
    sample_streams,
    single_run,
)
from .models.dia import decode_step
from .ops.sampling import apply_constraints, cfg_combine, filtered_topk, gumbel_argmax, top_p_filter
from .utils.profiling import GenerationStats

STAT_KEYS = ("windows", "drafted", "accepted_drafts", "tokens", "fallback_steps")


def filtered_probs(logits: torch.Tensor, temperature, top_p,
                   cfg_filter_top_k: int | None) -> torch.Tensor:
    """Full-vocabulary probabilities [..., V] of the exact distribution
    ``ops.sampling.sample_next_token`` draws from (temperature, top-k, top-p;
    the same ``filtered_topk``).  Tokens outside the filter get 0."""
    if cfg_filter_top_k is None or cfg_filter_top_k <= 0:
        return torch.softmax(top_p_filter(logits / temperature, top_p).float(), dim=-1)
    vals, idx = filtered_topk(logits, temperature, top_p, cfg_filter_top_k)
    probs = torch.softmax(vals.float(), dim=-1)
    return torch.zeros(logits.shape, dtype=probs.dtype, device=logits.device).scatter_(
        -1, idx, probs)


def rejection_sample_channel(draft_token: torch.Tensor, q_probs: torch.Tensor,
                             p_probs: torch.Tensor, generator: torch.Generator | None = None):
    """Accept-or-residual over any leading shape (the JAX
    ``rejection_sample_channel``, vectorised): draft tokens [...], draft and
    target distributions [..., V].  The draft is kept with probability
    min(1, p(x)/q(x)), else a token is drawn from max(p - q, 0)
    renormalised; either way the token is a draw from p.  The acceptance
    and Gumbel uniforms come from ``generator``.  Returns (tokens [...] in
    the drafts' dtype, accepted bool [...])."""
    dev = p_probs.device
    draft = draft_token.long()
    q_x = q_probs.gather(-1, draft[..., None])[..., 0]
    p_x = p_probs.gather(-1, draft[..., None])[..., 0]
    accept = torch.rand(draft.shape, generator=generator, device=dev) * q_x < p_x  # u < p/q
    residual = (p_probs - q_probs).clamp_min(0.0)
    safe = torch.where(residual.sum(-1, keepdim=True) > 0, residual, p_probs)
    noise = torch.rand(p_probs.shape, generator=generator, device=dev)
    resampled = gumbel_argmax(torch.log(safe.clamp_min(1e-30)), noise)
    return torch.where(accept, draft, resampled).to(draft_token.dtype), accept


class WindowCounts(NamedTuple):
    """What a window reports: its advance (accepted tokens; 0 hands the
    step to the loop) and the drafts it kept, int64 [1] each."""

    advance: torch.Tensor
    accepted: torch.Tensor


def spec_window(s: LoopState, params, config: DiaConfig, self_cache, cross_cache,
                cross_ends: torch.Tensor, window: int, n_draft_layers: int, top_k: int,
                generators: list | None, compute_dtype, counts: WindowCounts) -> None:
    """One speculative window on one stream's loop state, in place and on
    the device only (the JAX ``spec_window``, :107): draft ``window - 1``
    tokens with the first ``n_draft_layers`` layers (rows ``t+1 ..
    t+window-1``, Ld layers' K/V committed), verify rows ``t .. t+window-1``
    in one window ``decode_step`` (every layer's K/V committed), accept the
    longest prefix, write the correction, bonus or resampled row, and move
    ``t``, ``final_step``, ``prev_tok`` and ``bos_rows`` to the new position
    (the JAX ``_loop_entry_carries``, generate.py:279).  The EOS state, the
    stop flags and the sampling fields stay: a window never sees EOS.
    ``generators`` None: greedy."""
    d = config.data
    eos, pad, bos = d.audio_eos_value, d.audio_pad_value, d.audio_bos_value
    W = window
    tokens = s.tokens[0]  # [T, C]: one stream
    T, dev = tokens.shape[0], tokens.device
    t0 = s.t + 1  # [1]: the first row this window generates

    def guide(logits):  # [2, ..., C, V] -> the constrained CFG logits [..., C, V]
        return apply_constraints(cfg_combine(logits, s.cfg_scale[:, None, None]), eos, pad, bos)

    for i in range(W - 1):  # the draft: the loop body's step, CFG, bans and sampler
        t = t0 + i
        prev = tokens.index_select(0, t - 1)  # [1, C]
        logits = decode_step(params, config, torch.cat([prev, prev])[:, None],
                             (t - s.offsets2)[:, None], t - 1, self_cache, cross_cache,
                             cross_ends, compute_dtype, valid_from=s.valid_from,
                             n_layers=n_draft_layers)
        pred = sample_streams(guide(logits[:, 0].unflatten(0, (2, 1))), s, top_k, generators)
        tokens.index_copy_(0, t, pred.to(torch.int32))

    offs = torch.arange(W, device=dev)
    rows = tokens.index_select(0, s.t + offs)  # [W, C]: row t0 - 1 + i feeds step t0 + i
    tgt = rows[None].expand(2, *rows.shape)
    position = (t0 + offs)[None] - s.offsets2[:, None]  # [2, W]

    def window(n_layers=None):  # [2, W, C, V]: rows t0 .. t0 + W - 1 teacher-forced
        return decode_step(params, config, tgt, position, s.t, self_cache, cross_cache,
                           cross_ends, compute_dtype, valid_from=s.valid_from, n_layers=n_layers)

    guided = guide(window())  # [W, C, V]
    drafts = rows[1:]
    if generators is None:
        final = torch.argmax(guided, dim=-1).to(torch.int32)  # [W, C]
        match = (final[: W - 1] == drafts).all(dim=1)
    else:
        gen, temperature, top_p = generators[0], s.temperature[0], s.top_p[0]
        p = filtered_probs(guided, temperature, top_p, top_k)
        q = filtered_probs(guide(window(n_draft_layers)), temperature, top_p, top_k)
        tok, accepted = rejection_sample_channel(drafts, q[: W - 1], p[: W - 1], gen)
        bonus = gumbel_argmax(torch.log(p[W - 1].clamp_min(1e-30)),
                              torch.rand(p[W - 1].shape, generator=gen, device=dev))
        final = torch.cat([tok, bonus[None].to(torch.int32)])
        match = accepted.all(dim=1)

    is_eos = final[:, 0] == eos  # [W]
    ok = match & ~is_eos[: W - 1]
    at = torch.arange(W - 1, device=dev)
    j = torch.where(ok, W - 1, at).amin().reshape(1)  # the first step not kept, else W - 1
    take = ~is_eos.index_select(0, j)  # [1]: write row t0 + j (an EOS goes to the loop)
    advance = j + take.long()
    row = t0 + j
    tokens.index_copy_(0, row, torch.where(take[:, None], final.index_select(0, j),
                                           tokens.index_select(0, row)))
    t_new = s.t + advance
    R = s.bos_rows.shape[1]
    s.t.copy_(t_new)
    s.final_step.copy_(t_new)
    s.prev_tok.copy_(tokens.index_select(0, t_new))
    w0 = (t_new + 1).clamp(max=T - R)  # the JAX dynamic_slice's clamp
    s.bos_rows.copy_(tokens.index_select(0, w0 + torch.arange(R, device=dev))[None])
    counts.advance.copy_(advance)
    counts.accepted.copy_(j)


class SpeculativeGenerator:
    """Speculative generation for one stream (the JAX
    ``SpeculativeGenerator``, speculative.py:276): greedy and sampled.

    Runs on a ``DiaGenerator`` (``generator``, else one of its own): its
    conditioning and prefill (``_start``), its decode loop for the BOS
    window and the tail, its lock and its kept buffers, where each window
    graph is kept beside the loop's own.  ``stats`` accumulates the JAX
    keys over calls; ``last_call`` holds one call's counts, window graph
    replays, captures and the device time of the replayed windows."""

    def __init__(self, params, config: DiaConfig, compute_dtype: str = "float32",
                 n_draft_layers: int | None = None, window: int = 8,
                 device: str | torch.device = "cuda", generator: DiaGenerator | None = None):
        L = config.model.decoder.n_layer
        if generator is not None and generator.mesh is not None:
            raise NotImplementedError("speculative decoding has no tensor-parallel form")
        self.generator = generator or DiaGenerator(params, config, compute_dtype, device)
        self.params, self.config = self.generator.params, config
        self.compute_dtype = self.generator.compute_dtype
        self.n_draft_layers = n_draft_layers or max(1, L // 3)
        self.window = int(window)
        if not 1 <= self.n_draft_layers <= L:
            raise ValueError(f"n_draft_layers must be in [1, {L}], got {self.n_draft_layers}")
        if self.window < 2:
            raise ValueError(f"window must be at least 2, got {self.window}")
        self.stats = dict.fromkeys(STAT_KEYS, 0)
        self.last_call: dict = {}

    @torch.no_grad()
    def generate_tokens(
        self,
        text: str,
        max_tokens: int | None = None,
        cfg_scale: float = 3.0,
        temperature: float = 0.0,
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
        """Text → undelayed codec tokens [T, C], as ``DiaGenerator.
        generate_tokens`` returns them (greedy: the same codes).  ``loop``:
        ``"graph"`` (the card's default) replays each window from a CUDA
        graph, ``"eager"`` steps it from Python.  ``kv_int8=True`` raises:
        the speculative path keeps float caches."""
        if kv_int8:
            raise ValueError("speculative decoding keeps float KV caches: kv_int8=True is not "
                             "supported")
        gen, cfg = self.generator, self.config
        d = cfg.data
        max_tokens = d.audio_length if max_tokens is None else min(max_tokens, d.audio_length)
        W, Ld = self.window, self.n_draft_layers
        call = dict.fromkeys(STAT_KEYS, 0)
        call.update(window_replays=0, window_captures=0, window_capture_seconds=0.0)
        events: list = []
        with gen.lock:
            args, _, buffers = gen._start(
                text, max_tokens, cfg_scale, temperature, top_p, cfg_filter_top_k,
                audio_prompt_codes, audio_prompt_text, seed, cache_len, False, loop, own=False)
            (params, _, tokens_buf, self_cache, cross_cache, cross_ends, prefill_step, _, _, _,
             _, _, generator, dtype, loop, _, stats) = args
            run = single_run(*args)
            state = run.state
            counts = buffers.put("window_counts", WindowCounts(
                *(torch.zeros(1, dtype=torch.int64, device=gen.device) for _ in range(2))))
            generators = None if generator is None else [generator]

            def body():
                spec_window(state, params, cfg, self_cache, cross_cache, cross_ends, W, Ld,
                            cfg_filter_top_k, generators, dtype, counts)

            def host():  # (t, final_step, stop, eos_detected): one read-back
                return tuple(int(v) for v in torch.cat(
                    [state.t, state.final_step, state.stop.long(), state.eos_detected.long()]
                ).cpu())

            # 1) the BOS write-protect window through the loop (steps counted
            # as the JAX loop's dec_step counts them: the stop step is not one)
            t_first = prefill_step - 1
            run.run(max(0, min(prefill_step + d.max_delay, max_tokens - 1) - t_first))
            t, final, stop, eos = host()
            call["fallback_steps"] += final - t_first

            # 2) windows over the bulk
            spec_limit = max_tokens - d.max_delay - W - 2
            while not stop and not eos and t < spec_limit:
                advance, accepted = self._window(body, loop, buffers, (W, Ld), counts, call,
                                                 events)
                call["windows"] += 1
                call["drafted"] += W - 1
                call["accepted_drafts"] += accepted
                call["tokens"] += advance
                t += advance
                if advance == 0:  # the full model wants EOS here: the loop writes it
                    break

            # 3) the EOS tail and the rest of the budget through the loop
            final_step = int(run.finish(tokens_buf)[0])
            call["fallback_steps"] += final_step - (t if call["windows"] else final)
            stats.finish(stats.decode_steps, prefill_step - 1)
            gen.last_stats = stats
        call["window_device_ms"] = [a.elapsed_time(b) for a, b in events]
        for k in STAT_KEYS:
            self.stats[k] += call[k]
        self.last_call = call
        if verbose:
            print(f"speculative: {call['windows']} windows, {call['tokens']} tokens from "
                  f"windows, {call['fallback_steps']} loop steps, acceptance "
                  f"{call['accepted_drafts'] / max(call['drafted'], 1):.3f}")
        return _undelay(tokens_buf[prefill_step: final_step + 1], cfg)

    @staticmethod
    def _window(body, loop: str, buffers: LoopBuffers, key: tuple, counts: WindowCounts,
                call: dict, events: list) -> tuple[int, int]:
        """One window, eager or as a graph replay on the buffers' stream (the
        first window of a key runs eagerly there as the warm-up, the second
        captures), then the one read-back: (advance, accepted drafts)."""
        if loop == "eager":
            body()
            return tuple(int(v) for v in torch.cat(counts).cpu())
        side = buffers.stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            graph = buffers.windows.get(key)
            if graph is None and key not in buffers.warm_windows:
                body()
                buffers.warm_windows.add(key)
            else:
                if graph is None:  # the loop's capture: the generators registered
                    cap = GenerationStats()
                    graph = buffers.windows[key] = _capture(body, buffers, cap, 1)
                    call["window_captures"] += cap.captures
                    call["window_capture_seconds"] += cap.capture_seconds
                ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                ev[0].record()
                graph.replay()
                ev[1].record()
                events.append(ev)
                call["window_replays"] += 1
            out = tuple(int(v) for v in torch.cat(counts).cpu())
        torch.cuda.current_stream().wait_stream(side)
        return out

    @property
    def acceptance_rate(self) -> float:
        drafted = self.stats["drafted"]
        return self.stats["accepted_drafts"] / drafted if drafted else float("nan")
