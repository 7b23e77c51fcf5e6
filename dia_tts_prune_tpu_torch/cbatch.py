"""Continuous batching: requests join and leave a running batched decode
(counterpart of ``dia_tts_prune_tpu/cbatch.py``).

``serving.DynamicBatcher`` coalesces requests that arrive together into one
batched call; a request that arrives mid-flight waits for the whole batch.
Here ``n_slots`` decode lanes stay resident on the device, and a request
takes a free lane at the next segment boundary (``segment_steps`` decode
steps) while the other lanes go on decoding.  The lane count, the self-cache
length and the text window are fixed at construction; admission only
changes what the lanes hold, in place.

* ``_prepare_request`` conditions one request at its single-stream shape:
  the encoder and cross K/V at the request's own 128-bucket text window
  (``generate.conditioning``) and the voice-prompt prefill on a 2-row cache
  of the batcher's length, so that its numbers are those of its solo run.
* ``swap_in`` copies them into lane ``s``: its template row, its cache rows
  ``(s, N + s)``, its cross rows zero-padded to the window and its text
  ends, and resets every per-lane loop field as the single-stream loop
  starts it (``generate.new_loop_state``); the lane's generator is seeded.
* ``cb_segment`` advances every live lane: the decode loop's one body,
  ``generate.loop_step``, over a ``LoopState`` whose ``t`` and ``start`` are
  [N] — each lane on its own timeline, with its own write slot and RoPE
  position (``decode_step``'s per-row ``write_slot``), EOS and BOS state,
  cap, sampling values and generator.  A lane therefore repeats its
  single-stream run bit for bit whatever the other lanes do, and a seeded
  request under any admission order.  A stopped or vacant lane keeps its
  step and rows; its steps change nothing that is read.

On the card the body is captured once, at construction in the constructing
thread with every lane idle, as a ``GRAPH_STEPS``-step CUDA graph, and a
segment is ``segment_steps / GRAPH_STEPS`` replays of it, ``stop`` read back
after each.  The sampling values are tensors of the state, so one graph
serves every mix of greedy and seeded requests.  Admissions, cancels and
replays run in order on the batcher's own stream, under the generator's
lock.  On the CPU the body steps eagerly.  Nothing falls back: a failing
capture raises from the constructor, a failing segment to every waiting
request (``_fail_all``).

The JAX constructor's ``mesh`` (tensor-parallel serving) has no counterpart
yet.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from .config import DiaConfig
from .generate import (
    CFG_BATCH,
    DTYPES,
    GRAPH_STEPS,
    WARMUP_STEPS,
    LoopBuffers,
    LoopState,
    _bucket,
    _cache_len_for,
    _capture,
    _cross_window_for,
    _replay,
    _resolve_seed,
    conditioning,
    decoder_is_packed,
    loop_step,
    run_prefill,
)
from .models.dia import KVCache, QuantKVCache, decode_step, new_self_cache, quantize_cache
from .ops.delay import revert_audio_delay_np
from .ops.modules import MAX_ROWS
from .state import prepare_audio_prompt
from .tokenizer import build_effective_text, encode_cfg_batch
from .utils.profiling import GenerationStats


@dataclass
class Prepared:
    """One request conditioned at its single-stream shape, ready for a lane."""

    tokens: np.ndarray  # int32 [T, C]: the delayed template (prompt rows, -1 beyond)
    prefill_step: int  # the lane's first loop row
    self_cache: KVCache | QuantKVCache  # [L, 2, cache_len, ...]: the prompt's K/V
    cross: KVCache | QuantKVCache  # [L, 2, S_request, ...]
    ends: torch.Tensor  # int32 [2]: the CFG rows' text keys


def cb_init(config: DiaConfig, n_slots: int, cache_len: int, text_window: int, dtype,
            kv_int8: bool, device):
    """The idle N-lane state, every lane stopped (the JAX ``cb_init``, :105),
    its 2N-row self cache, and the batch's cross buffers at ``text_window``
    keys.  Returns (state, self_cache, cross_cache, cross_ends)."""
    d, dec = config.data, config.model.decoder
    N = int(n_slots)

    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    state = LoopState(
        tokens=full((N, d.audio_length, d.channels), -1, torch.int32),
        prev_tok=full((N, d.channels), 0, torch.int32),
        bos_rows=full((N, d.max_delay, d.channels), -1, torch.int32),
        eos_detected=full((N,), False, torch.bool),
        eos_countdown=full((N,), -1, torch.int32),
        stopped=full((N,), True, torch.bool),
        final_step=full((N,), 0, torch.int64),
        t=full((N,), 0, torch.int64),
        stop=full((1,), True, torch.bool),
        start=full((N,), 1, torch.int64),
        caps=full((N,), 2, torch.int64),
        offsets2=full((CFG_BATCH * N,), 0, torch.int64),
        valid_from=full((CFG_BATCH * N,), 0, torch.int32),
        delay=torch.tensor(d.delay_pattern, dtype=torch.int32, device=device),
        cfg_scale=full((N,), 0.0, torch.float32),
        temperature=full((N,), 1.0, torch.float32),
        top_p=full((N,), 1.0, torch.float32),
        greedy=full((N,), True, torch.bool))
    self_cache = new_self_cache(config, CFG_BATCH * N, cache_len, dtype, device, quant=kv_int8)
    shape = (dec.n_layer, CFG_BATCH * N, int(text_window), dec.cross_query_heads,
             dec.cross_head_dim)
    if kv_int8:
        cross = QuantKVCache(k=full(shape, 0, torch.int8), v=full(shape, 0, torch.int8),
                             ks=full(shape[:-1], 0.0, torch.float32),
                             vs=full(shape[:-1], 0.0, torch.float32))
    else:
        cross = KVCache(k=full(shape, 0.0, dtype), v=full(shape, 0.0, dtype))
    return state, self_cache, cross, full((CFG_BATCH * N,), 0, torch.int32)


@torch.no_grad()
def swap_in(state: LoopState, self_cache, cross_cache, cross_ends: torch.Tensor, slot: int,
            lane: Prepared, max_tokens: int, cfg_scale: float, temperature: float,
            top_p: float, max_delay: int) -> None:
    """Lane ``slot`` takes one prepared request, in place (the JAX
    ``swap_in``, :170): its template row, its cache rows ``(slot, N + slot)``,
    its cross rows zero-padded to the window (keys past the request's text
    are masked: a window wider than the batch's is cut there) and its text
    ends, and every per-lane loop field as ``new_loop_state`` starts a
    single stream at row ``prefill_step``.  The lane's generator is the
    caller's to seed."""
    N, T = state.tokens.shape[:2]
    s, p = int(slot), int(lane.prefill_step)
    tokens = torch.from_numpy(np.ascontiguousarray(lane.tokens)).to(state.tokens.device)
    w0 = min(p, T - max_delay)  # the single-stream window clamp
    state.tokens[s].copy_(tokens)
    state.prev_tok[s].copy_(tokens[p - 1])
    state.bos_rows[s].copy_(tokens[w0:w0 + max_delay])
    for field, value in (("eos_detected", False), ("eos_countdown", -1),
                         ("stopped", p - 1 >= max_tokens - 1), ("final_step", p - 1),
                         ("t", p - 1), ("start", p), ("caps", max_tokens),
                         ("cfg_scale", cfg_scale), ("temperature", temperature),
                         ("top_p", top_p), ("greedy", temperature == 0.0)):
        getattr(state, field)[s] = value
    state.stop.copy_(state.stopped.all().reshape(1))
    for dst, src in zip(self_cache, lane.self_cache):
        dst[:, s].copy_(src[:, 0])
        dst[:, N + s].copy_(src[:, 1])
    S = min(cross_cache.k.shape[2], lane.cross.k.shape[2])
    for dst, src in zip(cross_cache, lane.cross):
        for row, r in ((s, 0), (N + s, 1)):
            dst[:, row].zero_()
            dst[:, row, :S].copy_(src[:, r, :S])
    cross_ends[s].copy_(lane.ends[0])
    cross_ends[N + s].copy_(lane.ends[1])


def cb_segment(state: LoopState, body, buffers: LoopBuffers, stats: GenerationStats,
               steps: int, after_first=None) -> int:
    """Advance every live lane up to ``steps`` steps (the JAX ``cb_segment``,
    :252), ending early once every lane has stopped; returns the steps run.
    With a captured graph (``buffers.graph``) a step is one of its
    ``GRAPH_STEPS`` and ``stop`` is read back after each replay; else the
    body runs eagerly, ``stop`` read back after each step.  ``after_first``
    runs once the first replay or step is queued, before the first read-back:
    host work there overlaps the device's."""
    n, events = 0, []
    while n < steps and not bool(state.stop):
        if buffers.graph is None:
            body()
            stats.host_steps += 1
            n += 1
        else:
            _replay(buffers.graph, stats, events, GRAPH_STEPS)
            n += GRAPH_STEPS
        if after_first is not None:
            after_first()
            after_first = None
    if events:
        events[-1][0][1].synchronize()
        stats.replays += len(events)
        stats.replay_device_seconds += sum(a.elapsed_time(b) for (a, b), _ in events) / 1e3
    return n


@dataclass
class _Lane:
    future: Future
    prefill_step: int
    stream_q: queue.Queue | None = None  # set for submit_stream lanes
    emitted: int = 0  # final frames already streamed out


class ContinuousBatcher:
    """Slot-based scheduler: ``submit`` returns a Future; a worker thread
    swaps requests into free lanes at segment boundaries while the other
    lanes go on decoding.  Every device shape is fixed at construction, for
    the model's weights at that time (``dia.params``): one CUDA graph for
    the batcher's life."""

    def __init__(self, dia, n_slots: int = 4, segment_steps: int = 64, max_tokens: int = 1024,
                 text_window: int | None = 256, cfg_filter_top_k: int = 35):
        cfg = dia.config
        self._dia = dia
        self.n_slots = int(n_slots)
        self.segment_steps = int(segment_steps)
        self.max_tokens = min(int(max_tokens), cfg.data.audio_length)
        self.cfg_filter_top_k = int(cfg_filter_top_k)
        self.device = dia.generator.device
        self.loop = "graph" if self.device.type == "cuda" else "eager"
        if self.n_slots < 1 or self.segment_steps < 1:
            raise ValueError("n_slots and segment_steps must be positive")
        if CFG_BATCH * self.n_slots > MAX_ROWS:  # a step's rows: a CFG pair a lane
            raise ValueError(f"n_slots must be at most {MAX_ROWS // CFG_BATCH}, got "
                             f"{self.n_slots}: a lane's rows keep their solo bits only up "
                             f"to {MAX_ROWS} rows a step (ops.modules.fixed_rows_matmul)")
        if self.loop == "graph" and self.segment_steps % GRAPH_STEPS:
            raise ValueError(f"segment_steps must be a multiple of {GRAPH_STEPS} on the card "
                             f"(a segment is whole graph replays), got {self.segment_steps}")
        self.kv_int8 = decoder_is_packed(dia.params)
        self.cache_len = _cache_len_for(self.max_tokens, 0, cfg) or cfg.data.audio_length
        self.text_window = min(int(text_window or cfg.data.text_length), cfg.data.text_length)
        self._dtype = DTYPES[dia.compute_dtype]
        self._buffers = LoopBuffers(self.device if self.loop == "graph" else None)
        self.run_stats = GenerationStats(loop=self.loop, graph_steps=GRAPH_STEPS)
        with self._device_work():
            self._state, self._self_cache, self._cross, self._ends = cb_init(
                cfg, self.n_slots, self.cache_len, self.text_window, self._dtype, self.kv_int8,
                self.device)
            self._gens = self._buffers.generators(self.device, [0] * self.n_slots)
            params, state, top_k = dia.params, self._state, self.cfg_filter_top_k

            def body():
                loop_step(state, decode_step, params, cfg, self._self_cache, self._cross,
                          self._ends, top_k, self._gens, self._dtype)

            self._body = body
            if self.loop == "graph":
                self._capture_graph()
        self._lanes: list[_Lane | None] = [None] * self.n_slots
        self._q: deque = deque()
        self._cancel: dict[int, Future] = {}  # slot → future to cancel
        self._cond = threading.Condition()
        self._running = True
        self.segment_log: deque = deque(maxlen=1024)  # (live lanes, steps, host s, device s)
        self.stats = {"requests": 0, "segments": 0, "completed": 0, "cancelled": 0,
                      "max_live": 0,
                      # the segment computes every lane: vacant ones are waste
                      "lane_segments_occupied": 0, "lane_segments_capacity": 0,
                      "steps": 0, "captures": self.run_stats.captures,
                      "capture_seconds": self.run_stats.capture_seconds, "replays": 0,
                      "admitted": 0, "admission_wait_s": 0.0, "admission_wait_max_s": 0.0}
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="dia-continuous-batcher")
        self._worker.start()

    @contextlib.contextmanager
    def _device_work(self):
        """The generator's lock and the batcher's stream: admissions, cancels
        and replays run in order on one stream, one thread at a time."""
        with self._dia.generator.lock, torch.no_grad():
            if self._buffers.stream is None:
                yield
            else:
                with torch.cuda.stream(self._buffers.stream):
                    yield

    def _capture_graph(self) -> None:
        """``WARMUP_STEPS`` steps on the batcher's stream (they build the
        kernels and cuBLAS's workspace; with every lane idle they change
        nothing that is read), then the ``GRAPH_STEPS``-step graph."""
        buffers = self._buffers
        buffers.stream.wait_stream(torch.cuda.default_stream(self.device))
        for _ in range(WARMUP_STEPS):
            self._body()
            self.run_stats.host_steps += 1
        buffers.graph = _capture(self._body, buffers, self.run_stats, GRAPH_STEPS)

    # ------------------------------------------------------------------
    def submit(self, text: str, cfg_scale: float = 3.0, temperature: float = 1.3,
               top_p: float = 0.95, seed: int | None = None, max_tokens: int | None = None,
               audio_prompt_codes: np.ndarray | None = None,
               audio_prompt_text: str | None = None,
               _stream_q: queue.Queue | None = None) -> Future:
        """Queue one request; resolves to undelayed codes [T, C] (int32).  A
        seeded request repeats its solo run whatever lane it gets and
        whenever it is admitted."""
        if not self._running:
            raise RuntimeError("batcher is shut down")
        if audio_prompt_codes is not None and not audio_prompt_text:
            raise ValueError(
                "`audio_prompt_text` is required when `audio_prompt_codes` is provided.")
        fut: Future = Future()
        req = dict(text=text, cfg_scale=float(cfg_scale), temperature=float(temperature),
                   top_p=float(top_p), seed=_resolve_seed(seed),
                   max_tokens=min(int(max_tokens or self.max_tokens), self.max_tokens),
                   audio_prompt_codes=audio_prompt_codes, audio_prompt_text=audio_prompt_text,
                   future=fut, stream_q=_stream_q, submitted=time.perf_counter())
        with self._cond:
            self._q.append(req)
            self.stats["requests"] += 1
            self._cond.notify_all()
        return fut

    def cancel(self, future: Future) -> bool:
        """Cancel a ``submit`` / ``submit_stream`` request: a queued one is
        dropped now, a running lane is stopped and freed at the next segment
        boundary.  True if the request will do no further device work."""
        with self._cond:
            for req in list(self._q):
                if req["future"] is future:
                    self._q.remove(req)
                    future.cancel()
                    self.stats["cancelled"] += 1
                    if req.get("stream_q") is not None:
                        req["stream_q"].put(None)
                    return True
            for i, lane in enumerate(self._lanes):
                if lane is not None and lane.future is future:
                    self._cancel[i] = future
                    self._cond.notify_all()
                    return True
        return False

    def _apply_cancels(self) -> None:
        """Free the lanes whose futures were cancelled (worker thread; the
        identity check skips a lane harvested, and perhaps reused, since)."""
        with self._cond:
            pending = list(self._cancel.items())
            self._cancel.clear()
        for i, fut in pending:
            lane = self._lanes[i]
            if lane is None or lane.future is not fut:
                continue
            self._lanes[i] = None
            lane.future.cancel()
            self.stats["cancelled"] += 1
            if lane.stream_q is not None:
                lane.stream_q.put(None)
            with self._device_work():  # freeze the lane until its slot is reused
                self._state.stopped[i] = True
                self._state.stop.copy_(self._state.stopped.all().reshape(1))

    def submit_stream(self, text: str, **kwargs):
        """Stream one request's undelayed code chunks as its lane decodes: a
        chunk of newly final frames after each segment.  The chunks
        concatenate to ``submit(...).result()`` for the same arguments.
        Closing the iterator early cancels the request."""
        q: queue.Queue = queue.Queue()
        fut = self.submit(text, _stream_q=q, **kwargs)

        def _chunks():
            try:
                while True:
                    item = q.get()
                    if item is None:
                        if not fut.cancelled() and fut.done() and fut.exception() is not None:
                            raise fut.exception()
                        return
                    yield item
            except GeneratorExit:
                self.cancel(fut)  # the consumer left: free the lane
                raise

        return _chunks()

    def _prompt_codes(self, audio_prompt):
        if audio_prompt is None:
            return None
        if isinstance(audio_prompt, (str, bytes, Path)):
            return self._dia.load_audio(audio_prompt)
        return np.asarray(audio_prompt)

    def _check_top_k(self, cfg_filter_top_k: int) -> None:
        if int(cfg_filter_top_k) != self.cfg_filter_top_k:
            raise ValueError(f"this batcher samples with cfg_filter_top_k="
                             f"{self.cfg_filter_top_k}; a request for {cfg_filter_top_k} "
                             f"is not supported")

    def generate_stream(self, text: str, overlap_frames: int = 32, lookahead_frames: int = 32,
                        audio_prompt=None, audio_prompt_text: str | None = None,
                        cfg_filter_top_k: int | None = None, **kwargs):
        """Audio chunks of one request of the resident batch (``Dia.
        generate_stream``'s incremental codec decode, ``api.stream_decode_wav``,
        over ``submit_stream``); ``kwargs`` as ``submit`` takes them.  The
        codec work takes the generator's lock."""
        from .api import stream_decode_wav

        if cfg_filter_top_k is not None:
            self._check_top_k(cfg_filter_top_k)
        self._dia._require_dac()
        chunks = self.submit_stream(text, audio_prompt_codes=self._prompt_codes(audio_prompt),
                                    audio_prompt_text=audio_prompt_text, **kwargs)
        audio = stream_decode_wav(self._dia.dac_params, self._dia.dac_config, chunks,
                                  overlap_frames=overlap_frames,
                                  lookahead_frames=lookahead_frames,
                                  lock=self._dia.generator.lock)
        try:
            yield from audio
        finally:
            audio.close()
            chunks.close()

    def generate(self, text: str, max_tokens: int | None = None, cfg_scale: float = 3.0,
                 temperature: float = 1.3, top_p: float = 0.95, cfg_filter_top_k: int = 35,
                 audio_prompt=None, audio_prompt_text: str | None = None,
                 seed: int | None = None, timeout: float = 600.0) -> np.ndarray | None:
        """Blocking waveform generation, ``DynamicBatcher.generate``'s drop-in
        for the HTTP server.  ``audio_prompt``: a WAV path or [T, C] codes.
        ``cfg_filter_top_k`` is fixed for the batcher: another value raises."""
        self._check_top_k(cfg_filter_top_k)
        fut = self.submit(text, cfg_scale=cfg_scale, temperature=temperature, top_p=top_p,
                          seed=seed, max_tokens=max_tokens,
                          audio_prompt_codes=self._prompt_codes(audio_prompt),
                          audio_prompt_text=audio_prompt_text)
        try:
            codes = fut.result(timeout)
        except TimeoutError:
            self.cancel(fut)  # nobody waits for it any more
            raise
        if codes.shape[0] == 0:
            return None
        return self._dia._decode_waveform(codes)

    def shutdown(self, wait: bool = True) -> None:
        """Stop taking requests; the worker finishes what is queued and
        running, then exits."""
        with self._cond:
            self._running = False
            self._cond.notify_all()
        if wait:
            self._worker.join(timeout=60)

    # ------------------------------------------------------------------
    def _prepare_request(self, req: dict) -> Prepared:
        """One request's conditioning and prompt prefill at its single-stream
        shape (the solo ``DiaGenerator._start``'s), touching no lane: it can
        be queued on the stream behind a running segment (``_prep_pending``).
        A text over the batcher's window raises: cutting it to the window
        would drop real conditioning."""
        dia = self._dia
        cfg = dia.config
        d = cfg.data
        enc_input = encode_cfg_batch(build_effective_text(req["text"], req["audio_prompt_text"]),
                                     d.text_length, d.text_pad_value)
        text_len = int((enc_input != d.text_pad_value).sum(axis=-1).max())
        if text_len > self.text_window:
            raise ValueError(f"effective text is {text_len} encoded bytes, over this server's "
                             f"text window of {self.text_window}; chunk the text or restart "
                             f"with a larger --cb-text-window")
        delayed, prefill_step = prepare_audio_prompt(cfg, req["audio_prompt_codes"])
        tokens = np.full((d.audio_length, d.channels), -1, dtype=np.int32)
        tokens[: delayed.shape[0]] = delayed
        cross, padding_mask, ends = conditioning(
            dia.params, cfg, torch.from_numpy(enc_input).to(self.device), self._dtype,
            _cross_window_for(enc_input, cfg))
        self_cache = new_self_cache(cfg, CFG_BATCH, self.cache_len, self._dtype, self.device,
                                    quant=self.kv_int8)
        if prefill_step > 1:
            run_prefill(dia.params, cfg, tokens[None], _bucket(prefill_step - 1, 128,
                                                               d.audio_length),
                        np.zeros(1, np.int64), np.asarray([prefill_step]), cross, padding_mask,
                        self_cache, self._dtype)
        if self.kv_int8:  # the prefill read the float cross cache
            cross = quantize_cache(cross)
        return Prepared(tokens, int(prefill_step), self_cache, cross, ends)

    def _prep_pending(self) -> None:
        """Prepare queued requests ahead of their admission (worker thread,
        inside the device work, while a segment runs): at most ``n_slots``
        prepared at once, each holding a lane's rows.  A request whose
        preparation fails gets the error and leaves the queue."""
        with self._cond:
            n_prepped = sum(1 for r in self._q if "prepped" in r)
            todo = [r for r in self._q if "prepped" not in r][: max(0, self.n_slots - n_prepped)]
        for req in todo:
            try:
                req["prepped"] = self._prepare_request(req)
            except Exception as e:  # noqa: BLE001 — delivered to its caller
                with self._cond:
                    try:
                        self._q.remove(req)
                    except ValueError:
                        pass  # cancelled meanwhile
                if not req["future"].cancelled():
                    req["future"].set_exception(e)
                if req.get("stream_q") is not None:
                    req["stream_q"].put(None)

    def _admit(self, slot: int, req: dict) -> None:
        """Lane ``slot`` takes one request (prepared now unless
        ``_prep_pending`` got to it during an earlier segment)."""
        prepped = req.pop("prepped", None) or self._prepare_request(req)
        swap_in(self._state, self._self_cache, self._cross, self._ends, slot, prepped,
                req["max_tokens"], req["cfg_scale"], req["temperature"], req["top_p"],
                self._dia.config.data.max_delay)
        self._gens[slot].manual_seed(req["seed"])
        self._lanes[slot] = _Lane(req["future"], prepped.prefill_step, req.get("stream_q"))
        wait = time.perf_counter() - req["submitted"]
        self.stats["admitted"] += 1
        self.stats["admission_wait_s"] += wait
        self.stats["admission_wait_max_s"] = max(self.stats["admission_wait_max_s"], wait)

    def _revert_prefix(self, raw: np.ndarray, n_final: int) -> np.ndarray:
        """Undelay ``raw`` rows and return the first ``n_final`` frames (a
        frame is final once every delayed row it gathers from exists, the
        last ``max_delay`` rows pending: ``generate_tokens_stream``'s rule,
        so that stream chunks concatenate to the ``submit`` result)."""
        d = self._dia.config.data
        if raw.shape[0] == 0 or n_final <= 0:
            return np.zeros((0, d.channels), np.int32)
        reverted = revert_audio_delay_np(raw[None], d.audio_pad_value, tuple(d.delay_pattern),
                                         raw.shape[0])[0][: max(0, n_final)]
        return np.where((reverted < 0) | (reverted > 1023), 0, reverted).astype(np.int32)

    def _emit_streams(self, stopped, final_step, tokens, owners) -> None:
        """Push newly final frames to live streaming lanes (a stopped lane
        flushes its tail in ``_harvest``).  ``owners``: the (slot, lane)
        pairs of the segment these rows come from — a lane cancelled since
        takes no other request's rows."""
        d = self._dia.config.data
        for i, lane in owners:
            if lane is not self._lanes[i] or lane.stream_q is None or bool(stopped[i]):
                continue
            raw = tokens[i, lane.prefill_step: int(final_step[i]) + 1]
            n_final = raw.shape[0] - d.max_delay
            if n_final > lane.emitted:
                lane.stream_q.put(self._revert_prefix(raw, n_final)[lane.emitted:])
                lane.emitted = n_final

    def _harvest(self, stopped, final_step, tokens, owners) -> None:
        """Resolve the futures of the lanes that stopped in the segment whose
        rows these are (``owners``, as in ``_emit_streams``)."""
        d = self._dia.config.data
        for i, lane in owners:
            if lane is not self._lanes[i] or not bool(stopped[i]):
                continue
            self._lanes[i] = None
            self.stats["completed"] += 1
            generated = tokens[i, lane.prefill_step: int(final_step[i]) + 1]
            codes = self._revert_prefix(generated, generated.shape[0] - d.max_delay)
            if lane.stream_q is not None:
                if codes.shape[0] > lane.emitted:
                    lane.stream_q.put(codes[lane.emitted:])
                lane.stream_q.put(None)  # ends the chunk iterator
            lane.future.set_result(codes)

    def _fail_all(self, exc: BaseException) -> None:
        """The worker failed: every queued and running request gets the
        error instead of waiting forever, and the batcher takes no more."""
        with self._cond:
            self._running = False
            queued = list(self._q)
            self._q.clear()
        waiting = [(r["future"], r.get("stream_q")) for r in queued]
        for i, lane in enumerate(self._lanes):
            if lane is not None:
                self._lanes[i] = None
                waiting.append((lane.future, lane.stream_q))
        for fut, stream_q in waiting:
            if not fut.done():
                fut.set_exception(exc)
            if stream_q is not None:
                stream_q.put(None)

    def _run(self) -> None:
        try:
            self._run_loop()
        except Exception as e:  # noqa: BLE001 — delivered, no client hangs
            self._fail_all(e)

    def _run_segment(self, live: int) -> tuple:
        """One segment over the resident lanes (device work held); returns
        the host copies of (stopped, final_step, tokens) after it."""
        t0 = time.perf_counter()
        replays, device_s = self.run_stats.replays, self.run_stats.replay_device_seconds
        steps = cb_segment(self._state, self._body, self._buffers, self.run_stats,
                           self.segment_steps, after_first=self._prep_pending)
        out = (self._state.stopped.cpu().numpy(), self._state.final_step.cpu().numpy(),
               self._state.tokens.cpu().numpy())
        self.segment_log.append((live, steps, time.perf_counter() - t0,
                                 self.run_stats.replay_device_seconds - device_s))
        self.stats["segments"] += 1
        self.stats["steps"] += steps
        self.stats["replays"] += self.run_stats.replays - replays
        self.stats["lane_segments_occupied"] += live
        self.stats["lane_segments_capacity"] += self.n_slots
        return out

    def _run_loop(self) -> None:
        while True:
            self._apply_cancels()
            with self._cond:
                have_work = bool(self._q) or any(lane is not None for lane in self._lanes)
                if not self._running and not have_work:
                    return
                if not have_work:
                    self._cond.wait(timeout=0.1)
                    continue
                batch = []
                for slot in range(self.n_slots):
                    if self._lanes[slot] is None and self._q:
                        batch.append((slot, self._q.popleft()))
            with self._device_work():
                for slot, req in batch:
                    try:
                        self._admit(slot, req)
                    except Exception as e:  # noqa: BLE001 — delivered, the others go on
                        req["future"].set_exception(e)
                        if req.get("stream_q") is not None:
                            req["stream_q"].put(None)
                owners = [(i, lane) for i, lane in enumerate(self._lanes) if lane is not None]
                self.stats["max_live"] = max(self.stats["max_live"], len(owners))
                if not owners:
                    continue
                result = self._run_segment(len(owners))
            self._emit_streams(*result, owners)
            self._harvest(*result, owners)
