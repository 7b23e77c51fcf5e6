"""Autoregressive generation (counterpart of ``dia_tts_prune_tpu/generate.py``:
single-stream ``generate_fused`` :460 / ``DiaGenerator.generate_tokens`` :865,
and N streams at once, ``generate_fused_batch`` :546 /
``generate_tokens_batch`` :1047).

Conditioning (encoder + cross K/V, trimmed to a 128-bucket of the text
length), the voice-prompt prefill, and the decode loop run on the device; the
loop itself is a plain Python loop that issues one ``decode_step`` per token
and reads back the 9 sampled codes, so the per-token bookkeeping — the EOS
countdown, the BOS-window masked write, the near-max trigger — runs on the
host with the reference's exact semantics (dia/model.py:748-815):

* step ``t`` consumes buffer row ``t-1``, runs RoPE position ``t``, writes KV
  slot ``t-1`` and attends slots ``[0, t-1]``;
* EOS in channel 0 starts a ``max_delay`` countdown during which channel
  ``c`` is forced to EOS at offset ``delay[c]`` and to PAD after;
* the first ``max_delay`` steps keep the delayed BOS/PAD template rows;
* generation stops when the countdown reaches zero or ``max_tokens`` nears.

With a packed decoder (``Dia.quantize_int8`` / ``quantize_int4``) the loop
also keeps both caches int8 (``models.dia.QuantKVCache``), as the JAX package
does on its accelerator: the self cache from the start, the cross cache once
the prefill has used its float form.  ``generate_tokens(kv_int8=...)`` takes
the place of the JAX package's ``DIA_KV_INT8`` environment variable.

Sampling draws Gumbel noise from a ``torch.Generator`` seeded per call, so a
seeded run repeats itself; it cannot repeat the JAX package's ``jax.random``
draws (greedy decoding is identical).

The batched loop runs 2N CFG rows ([uncond × N; cond × N]) with voice
prompts left-padded to one window, row-local RoPE positions, a first valid
cache slot per row (``decode_step(valid_from=...)``), and an EOS countdown
and a generator per stream, so each stream repeats its single-stream run.
"""

from __future__ import annotations

import random
import time

import numpy as np
import torch

from .config import DiaConfig
from .models.dia import (
    decode_step,
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


@torch.no_grad()
def decode_loop(params, config: DiaConfig, tokens_buf: np.ndarray, self_cache, cross_cache,
                cross_ends, prefill_step: int, max_tokens: int, cfg_scale: float,
                temperature: float, top_p: float, cfg_filter_top_k: int,
                generator: torch.Generator | None, compute_dtype) -> int:
    """The decode loop (loop body semantics of generate.py:217-276).  Fills
    ``tokens_buf`` rows in place and returns the last completed step."""
    d = config.data
    dev = cross_ends.device
    delay = np.asarray(d.delay_pattern, np.int32)
    max_delay, eos, pad = d.max_delay, d.audio_eos_value, d.audio_pad_value
    T = tokens_buf.shape[0]

    dec_step = prefill_step - 1
    prev_tok = tokens_buf[dec_step].copy()
    w0 = min(dec_step + 1, T - max_delay)  # the JAX dynamic_slice clamps its start
    bos_rows = tokens_buf[w0:w0 + max_delay].copy()
    eos_detected, countdown, bos_countdown = False, -1, max_delay
    while dec_step < max_tokens - 1:
        t = dec_step + 1
        tgt = torch.from_numpy(prev_tok).to(dev)[None, None].expand(CFG_BATCH, 1, -1)
        position = torch.full((CFG_BATCH, 1), t, dtype=torch.int64, device=dev)
        logits = decode_step(params, config, tgt, position, t - 1, self_cache, cross_cache,
                             cross_ends, compute_dtype)  # [2, 1, C, V]
        guided = apply_constraints(cfg_combine(logits[:, -1], cfg_scale), eos, pad,
                                   d.audio_bos_value)
        pred = sample_next_token(guided, temperature, top_p, cfg_filter_top_k,
                                 generator=generator).to(torch.int32).cpu().numpy()

        # EOS state machine (reference: dia/model.py:771-797)
        newly_eos = (not eos_detected) and pred[0] == eos
        eos_detected = eos_detected or newly_eos
        if newly_eos:
            countdown = max_delay
        if countdown > 0:
            step_after = max_delay - countdown
            pred = np.where(step_after == delay, eos,
                            np.where((step_after > delay) & (pred != eos), pad, pred))
            countdown -= 1
        pred = pred.astype(np.int32)

        # BOS-window masked write (reference: dia/model.py:790-792)
        bos_countdown = max(0, bos_countdown - 1)
        row = bos_rows[0]
        write = np.where((bos_countdown > 0) & (row != -1), row, pred).astype(np.int32)
        tokens_buf[t] = write
        bos_rows = np.roll(bos_rows, -1, axis=0)

        stop = countdown == 0
        # near-max EOS trigger (reference: dia/model.py:800-804)
        if t >= max_tokens - max_delay - 1 and not eos_detected:
            eos_detected = True
            countdown = max_delay
        prev_tok = write
        if stop:
            break
        dec_step += 1
    return dec_step


@torch.no_grad()
def decode_loop_batch(params, config: DiaConfig, tokens_buf: np.ndarray, self_cache, cross_cache,
                      cross_ends, start: int, offsets: np.ndarray, caps: np.ndarray,
                      cfg_scale: float, temperature: float, top_p: float, cfg_filter_top_k: int,
                      generators: list | None, compute_dtype) -> np.ndarray:
    """The N-stream decode loop (``generate_fused_batch``'s body,
    generate.py:625-698): all streams advance in lockstep from row
    ``start``, each with its own RoPE positions (``t - offsets[i]``), its
    own first valid cache slot, its own EOS countdown and its own generator,
    so that stream i repeats its single-stream run.  A finished stream stops
    being written and sampled; its rows keep running until every stream has
    stopped or the longest cap is reached.  Fills ``tokens_buf`` [N, T, C]
    in place and returns each stream's last completed step."""
    d = config.data
    dev = cross_ends.device
    N = tokens_buf.shape[0]
    delay = np.asarray(d.delay_pattern, np.int32)[None]
    max_delay, eos, pad = d.max_delay, d.audio_eos_value, d.audio_pad_value
    off2 = np.concatenate([offsets, offsets]).astype(np.int64)
    valid_from = torch.from_numpy(off2.astype(np.int32)).to(dev)

    prev_tok = tokens_buf[:, start - 1].copy()  # [N, C]
    bos_rows = tokens_buf[:, start:start + max_delay].copy()  # [N, max_delay, C]
    eos_detected = np.zeros(N, bool)
    countdown = np.full(N, -1, np.int64)
    stopped = np.zeros(N, bool)
    final_step = np.full(N, start - 1, np.int64)
    t = start - 1
    while t < caps.max() - 1 and not stopped.all():
        t += 1
        tgt = torch.from_numpy(np.concatenate([prev_tok, prev_tok])).to(dev)[:, None]
        position = torch.from_numpy(t - off2[:, None]).to(dev)
        logits = decode_step(params, config, tgt, position, t - 1, self_cache, cross_cache,
                             cross_ends, compute_dtype, valid_from=valid_from)  # [2N, 1, C, V]
        pred = prev_tok.copy()  # a stopped stream is neither sampled nor written
        live = np.flatnonzero(~stopped)
        picks = [sample_next_token(
            apply_constraints(cfg_combine(logits[[i, N + i], 0], cfg_scale), eos, pad,
                              d.audio_bos_value),
            temperature, top_p, cfg_filter_top_k,
            generator=None if generators is None else generators[i]) for i in live]
        pred[live] = torch.stack(picks).to(torch.int32).cpu().numpy()

        # per-stream EOS state machines (reference: dia/model.py:771-797)
        newly_eos = ~eos_detected & (pred[:, 0] == eos)
        eos_detected |= newly_eos
        countdown = np.where(newly_eos, max_delay, countdown)
        active = (countdown > 0)[:, None]
        step_after = (max_delay - countdown)[:, None]
        pred = np.where(active & (step_after == delay), eos,
                        np.where(active & (step_after > delay) & (pred != eos), pad, pred))
        countdown = np.where(countdown > 0, countdown - 1, countdown)

        # BOS-window masked write: every prompt ends on row start - 1, so the
        # write-protected window is the first max_delay - 1 steps for all
        row = bos_rows[:, 0] if t - start < max_delay else np.full_like(prev_tok, -1)
        write = np.where((t - start < max_delay - 1) & (row != -1), row, pred).astype(np.int32)
        tokens_buf[live, t] = write[live]
        bos_rows = np.roll(bos_rows, -1, axis=1)

        stop_now = (countdown == 0) & ~stopped
        hit_cap = (t >= caps - 1) & ~stopped & ~stop_now
        final_step = np.where(stopped, final_step, np.where(stop_now, t - 1, t))
        prev_tok = np.where(stopped[:, None], prev_tok, write)
        stopped = stopped | stop_now | hit_cap
        # near-max EOS trigger (reference: dia/model.py:800-804)
        near_max = (t >= caps - max_delay - 1) & ~eos_detected
        eos_detected |= near_max
        countdown = np.where(near_max, max_delay, countdown)
    return final_step


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
    """Generation orchestrator (reference API: dia/model.py:631-846)."""

    def __init__(self, params, config: DiaConfig, compute_dtype: str = "float32",
                 device: str | torch.device = "cuda"):
        self.params = params
        self.config = config
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)

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
    ) -> np.ndarray:
        """Text → undelayed codec tokens [T, C] (delay reverted, tail trimmed,
        out-of-codebook values clamped to 0).  ``kv_int8``: int8 self and
        cross caches; None = on iff the decoder's kernels are packed."""
        cfg = self.config
        d = cfg.data
        dtype = DTYPES[self.compute_dtype]
        if audio_prompt_codes is not None and not audio_prompt_text:
            raise ValueError(
                "`audio_prompt_text` is required when `audio_prompt_codes` is provided.")
        effective_text = build_effective_text(text, audio_prompt_text)
        enc_input = encode_cfg_batch(effective_text, d.text_length, d.text_pad_value)
        max_tokens = d.audio_length if max_tokens is None else min(max_tokens, d.audio_length)

        delayed, prefill_step = prepare_audio_prompt(cfg, audio_prompt_codes)
        tokens_buf = np.full((d.audio_length, d.channels), -1, dtype=np.int32)
        tokens_buf[: delayed.shape[0]] = delayed
        window = _bucket(prefill_step - 1, 128, d.audio_length) if prefill_step > 1 else None
        cache_len = _cache_len_for(max_tokens if cache_len is None else cache_len,
                                   window or 0, cfg)
        generator = None
        if temperature != 0.0:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(_resolve_seed(seed))

        t0 = time.perf_counter()
        cross_cache, padding_mask, cross_ends = conditioning(
            self.params, cfg, torch.from_numpy(enc_input).to(self.device), dtype,
            _cross_window_for(enc_input, cfg))
        if kv_int8 is None:
            kv_int8 = decoder_is_packed(self.params)
        self_cache = new_self_cache(cfg, CFG_BATCH, cache_len, dtype, self.device, quant=kv_int8)
        if window is not None:
            run_prefill(self.params, cfg, tokens_buf[None], window, np.zeros(1, np.int64),
                        np.asarray([prefill_step]), cross_cache, padding_mask, self_cache, dtype)
        if kv_int8:  # prefill's flash attention reads the float cross cache
            cross_cache = quantize_cache(cross_cache)
        final_step = decode_loop(
            self.params, cfg, tokens_buf, self_cache, cross_cache, cross_ends, prefill_step,
            max_tokens, cfg_scale, temperature, top_p, cfg_filter_top_k, generator, dtype)
        if verbose:
            dt = time.perf_counter() - t0
            steps = final_step + 1 - prefill_step
            print(f"generate: {steps} steps in {dt:.3f}s ({steps / max(dt, 1e-9):.2f} tokens/s)")

        return _undelay(tokens_buf[prefill_step: final_step + 1], cfg)  # (dia/model.py:831)

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
        that seed whatever streams ride with it."""
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
        enc_input = np.concatenate([np.stack([c[0] for c in conds]),
                                    np.stack([c[1] for c in conds])])  # [uncond × N; cond × N]

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
        generators = None
        if temperature != 0.0:
            generators = [torch.Generator(device=self.device).manual_seed(s) for s in seed_list]

        cross_cache, padding_mask, cross_ends = conditioning(
            self.params, cfg, torch.from_numpy(enc_input).to(self.device), dtype,
            _cross_window_for(enc_input, cfg))
        if kv_int8 is None:
            kv_int8 = decoder_is_packed(self.params)
        self_cache = new_self_cache(cfg, 2 * N, _cache_len_for(cache_len or int(caps.max()),
                                                               start, cfg),
                                    dtype, self.device, quant=kv_int8)
        if window is not None:
            run_prefill(self.params, cfg, tokens_buf, window, offsets, prefill_steps,
                        cross_cache, padding_mask, self_cache, dtype)
        if kv_int8:
            cross_cache = quantize_cache(cross_cache)
        final_steps = decode_loop_batch(
            self.params, cfg, tokens_buf, self_cache, cross_cache, cross_ends, start, offsets,
            caps, cfg_scale, temperature, top_p, cfg_filter_top_k, generators, dtype)
        return [_undelay(tokens_buf[i, start: int(final_steps[i]) + 1], cfg) for i in range(N)]
