"""Serving front end (counterpart of ``dia_tts_prune_tpu/app.py``): chunked
long-form generation with rolling voice conditioning, and a stdlib HTTP API.

Reference: app.py — text chunking by effective characters (speaker tags
count as one character, :80-121), batches of 4 chunks joined with 0.2 s
silences (:206-248), rolling self-conditioning (each batch's audio and text
become the next batch's voice prompt, :221-226), per-batch max-token scaling
(:216-218), speed-factor resampling (:259-268), optional int8 weights.

Run on the card: ``python -m dia_tts_prune_tpu_torch.app --model-path DIR
[--dynamic-batch | --continuous-batch] [--quantize-int8] [--port 7860]``
(``--device cpu`` runs on the CPU).  The API:

* ``POST /generate`` {"text", "max_new_tokens", "cfg_scale", "temperature",
  "top_p", "cfg_filter_top_k", "speed_factor", "chunk_size", "seed",
  "audio_prompt", "audio_prompt_text"} → a WAV file;
* ``POST /stream`` (the same keys but the chunking ones) → a live WAV:
  header, then 16-bit PCM as each decode segment's audio is ready;
* ``GET /health``, ``GET /stats`` (the batcher's counters).

Only the stdlib HTTP API is served: the JAX package's Gradio UI needs
``gradio``, which this package does not depend on.  A ``Dia`` serves
concurrent requests safely: its generator's lock lets one call at a time
work on the card (``generate.DiaGenerator``).
"""

from __future__ import annotations

import argparse
import io
import itertools
import json
import os
import re
import struct
import tempfile
import time
import wave

import numpy as np

from .utils.audio_io import speed_change, write_wav

SAMPLE_RATE = 44100
BATCH_CHUNKS = 4
SILENCE_SEC = 0.2


# ---------------------------------------------------------------------------
# Chunking — behavioural spec from the reference (app.py:80-131): speaker tags
# are billed as one character; the chunk budget auto-scales 48/64/96 with the
# input's size; splits never break words; chunks are consumed in groups.
# ---------------------------------------------------------------------------

_TAG_RE = re.compile(r"\[S[12]\]")

# (input ceiling in effective chars, chunk budget): longer inputs get larger
# chunks, so the batch count stays bounded
_CHUNK_BUDGETS = ((1024, 48), (4096, 64), (float("inf"), 96))


def count_effective_length(text: str) -> int:
    """Character count where each speaker tag bills as a single character."""
    return len(text) - sum(len(m.group()) - 1 for m in _TAG_RE.finditer(text))


def auto_adjust_chunk_size(text: str, user_chunk_size: int = 0) -> int:
    """Pick the per-chunk character budget (a user override wins)."""
    if user_chunk_size > 0:
        return int(user_chunk_size)
    n = count_effective_length(text)
    return next(budget for ceiling, budget in _CHUNK_BUDGETS if n <= ceiling)


def split_by_words_respecting_special_tokens(text: str,
                                             max_effective_chars: int = 64) -> list[str]:
    """Greedy word-boundary split: keep appending words while the chunk fits;
    a single word longer than the budget becomes its own chunk."""
    chunks: list[list[str]] = [[]]
    used = 0
    for word in text.split():
        cost = count_effective_length(word) + (1 if chunks[-1] else 0)
        if chunks[-1] and used + cost > max_effective_chars:
            chunks.append([])
            used = 0
            cost = count_effective_length(word)
        chunks[-1].append(word)
        used += cost
        if used > max_effective_chars:  # an oversized lone word: close it out
            chunks.append([])
            used = 0
    return [" ".join(c) for c in chunks if c]


def batch_chunks(chunks: list[str], batch_size: int):
    """Consume chunks in fixed-size groups (the last group may be short)."""
    it = iter(chunks)
    while group := list(itertools.islice(it, batch_size)):
        yield group


# ---------------------------------------------------------------------------
# Pipeline (reference: app.py:142-268)
# ---------------------------------------------------------------------------


def run_inference(
    dia,
    text_input: str,
    audio_prompt_path: str | None = None,
    audio_prompt_text: str | None = None,
    max_new_tokens: int = 1024,
    cfg_scale: float = 3.0,
    temperature: float = 1.3,
    top_p: float = 0.95,
    cfg_filter_top_k: int = 35,
    speed_factor: float = 1.0,
    chunk_size: int = 0,
    seed: int | None = None,
    verbose: bool = False,
) -> tuple[int, np.ndarray]:
    """Chunked generation with rolling self-conditioning: the text is split
    into chunks, 4 chunks a batch, and each batch after the first is
    prompted with the previous batch's audio (through a temporary WAV and
    ``Dia.load_audio``) and text.  Returns (sample_rate, int16 waveform) as
    the reference's handler does."""
    if not text_input or not text_input.strip():
        raise ValueError("Text input is empty.")

    chunk_size = auto_adjust_chunk_size(text_input, chunk_size)
    chunks = split_by_words_respecting_special_tokens(text_input, chunk_size)
    if verbose:
        print(f"Chunked into {len(chunks)} chunks of ≤{chunk_size} effective chars.")

    n_batches = -(-len(chunks) // BATCH_CHUNKS)
    segments: list[np.ndarray] = []
    prev_audio: np.ndarray | None = None
    prev_text: str | None = None
    prompt_path = audio_prompt_path
    prompt_text = audio_prompt_text
    tmp_files: list[str] = []
    t0 = time.time()

    try:
        for batch_idx, chunk_batch in enumerate(batch_chunks(chunks, BATCH_CHUNKS)):
            batch_text = "\n".join(c.strip() for c in chunk_batch).strip()
            if not batch_text:
                continue
            # per-batch token budget scaling (reference: app.py:216-218)
            scaling = count_effective_length(batch_text) / chunk_size
            adjusted_tokens = max(256, int(max_new_tokens * scaling))

            # rolling self-conditioning (reference: app.py:221-226)
            if batch_idx > 0 and prev_audio is not None:
                f = tempfile.NamedTemporaryFile(suffix=".wav", delete=False)
                f.close()
                write_wav(f.name, prev_audio.astype(np.float32), SAMPLE_RATE)
                prompt_path = f.name
                prompt_text = prev_text
                tmp_files.append(f.name)

            audio = dia.generate(
                batch_text,
                max_tokens=adjusted_tokens,
                cfg_scale=cfg_scale,
                temperature=temperature,
                top_p=top_p,
                cfg_filter_top_k=cfg_filter_top_k,
                audio_prompt=prompt_path,
                audio_prompt_text=prompt_text,
                seed=seed,
                verbose=verbose,
            )
            if audio is not None:
                segments.append(audio)
                prev_audio = audio
                prev_text = batch_text
                if batch_idx < n_batches - 1:
                    segments.append(np.zeros(int(SAMPLE_RATE * SILENCE_SEC), np.float32))
    finally:
        for f in tmp_files:
            try:
                os.unlink(f)
            except OSError:
                pass

    if not segments:
        return SAMPLE_RATE, np.zeros(0, np.int16)
    out = np.concatenate(segments)
    if verbose:
        print(f"Generated {out.shape[0] / SAMPLE_RATE:.2f}s in {time.time() - t0:.2f}s.")

    out = speed_change(out, speed_factor)  # linear resample (reference: app.py:259-268)
    return SAMPLE_RATE, (np.clip(out, -1, 1) * 32767).astype(np.int16)


# ---------------------------------------------------------------------------
# HTTP API (stdlib)
# ---------------------------------------------------------------------------


def _wav_bytes(sr: int, pcm16: np.ndarray) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm16.tobytes())
    return buf.getvalue()


def _wav_stream_header(sr: int) -> bytes:
    """A 44-byte PCM WAV header with unknown (0xFFFFFFFF) lengths: players
    and ffmpeg treat it as a live stream and read until the socket closes."""
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def _pcm16(audio: np.ndarray) -> np.ndarray:
    return (np.clip(audio, -1, 1) * 32767).astype(np.int16)


def make_server(dia, host: str = "0.0.0.0", port: int = 7860, batcher=None):
    """The JSON → WAV server: POST /generate and /stream, GET /health and
    /stats.  Each request runs in its own thread.

    With ``batcher``, single-chunk ``/generate`` requests from concurrent
    clients go to ``batcher.generate``: a ``serving.DynamicBatcher``
    coalesces them into one batched decode loop, a
    ``cbatch.ContinuousBatcher`` gives each a resident lane.  Multi-chunk
    long-form requests keep the rolling-prompt pipeline (``run_inference``).
    ``/stream`` goes to ``batcher.generate_stream`` where the batcher has one
    (a continuous batcher's lane streams as it decodes); with a dynamic
    batcher, whose streams end together, it generates on its own."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, body: bytes, content_type: str) -> None:
            self.send_response(code)
            self.send_header("Content-Type", content_type)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json_error(self, code: int, msg: str) -> None:
            self._send(code, json.dumps({"error": msg}).encode(), "application/json")

        def _request(self) -> dict:
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def do_GET(self):
            if self.path == "/health":
                body = {"status": "ok"}
            elif self.path == "/stats" and batcher is not None:
                body = dict(batcher.stats)
            else:
                self.send_error(404)
                return
            self._send(200, json.dumps(body).encode(), "application/json")

        def _do_stream(self):
            """POST /stream: a live WAV, the header and then PCM chunks as
            they are generated.  No Content-Length (read until close), so
            ``curl ... | ffplay -`` plays from the first chunk.  The first
            chunk is pulled before the 200 is sent, so a bad request still
            gets a JSON error status."""
            try:
                req = self._request()
                streamer = getattr(batcher, "generate_stream", dia.generate_stream)
                chunks = streamer(
                    req.get("text", ""),
                    max_tokens=int(req.get("max_new_tokens", 1024)),
                    cfg_scale=float(req.get("cfg_scale", 3.0)),
                    temperature=float(req.get("temperature", 1.3)),
                    top_p=float(req.get("top_p", 0.95)),
                    cfg_filter_top_k=int(req.get("cfg_filter_top_k", 35)),
                    seed=req.get("seed"),
                    audio_prompt=req.get("audio_prompt"),
                    audio_prompt_text=req.get("audio_prompt_text"))
                first = next(chunks, None)
            except ValueError as e:
                self._send_json_error(400, str(e))
                return
            except Exception as e:  # noqa: BLE001 — a server thread reports and goes on
                self._send_json_error(500, f"{type(e).__name__}: {e}")
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.end_headers()
            try:
                self.wfile.write(_wav_stream_header(SAMPLE_RATE))
                if first is not None:
                    for chunk in itertools.chain([first], chunks):
                        self.wfile.write(_pcm16(chunk).tobytes())
                        self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError):
                pass  # the client left; closing the stream releases what it held
            finally:
                chunks.close()

        def do_POST(self):
            if self.path == "/stream":
                self._do_stream()
                return
            if self.path != "/generate":
                self.send_error(404)
                return
            try:
                req = self._request()
                text = req.get("text", "")
                speed = float(req.get("speed_factor", 1.0))
                chunk_size = auto_adjust_chunk_size(text, int(req.get("chunk_size", 0)))
                single_chunk = (
                    text.strip()
                    and len(split_by_words_respecting_special_tokens(text, chunk_size)) == 1)
                if batcher is not None and single_chunk and speed == 1.0:
                    audio = batcher.generate(
                        text,
                        max_tokens=int(req.get("max_new_tokens", 1024)),
                        cfg_scale=float(req.get("cfg_scale", 3.0)),
                        temperature=float(req.get("temperature", 1.3)),
                        top_p=float(req.get("top_p", 0.95)),
                        cfg_filter_top_k=int(req.get("cfg_filter_top_k", 35)),
                        audio_prompt=req.get("audio_prompt"),
                        audio_prompt_text=req.get("audio_prompt_text"),
                        seed=req.get("seed"))
                    sr = SAMPLE_RATE
                    pcm = _pcm16(np.zeros(0, np.float32) if audio is None else audio)
                else:
                    sr, pcm = run_inference(
                        dia,
                        text,
                        audio_prompt_path=req.get("audio_prompt"),
                        audio_prompt_text=req.get("audio_prompt_text"),
                        max_new_tokens=int(req.get("max_new_tokens", 1024)),
                        cfg_scale=float(req.get("cfg_scale", 3.0)),
                        temperature=float(req.get("temperature", 1.3)),
                        top_p=float(req.get("top_p", 0.95)),
                        cfg_filter_top_k=int(req.get("cfg_filter_top_k", 35)),
                        speed_factor=speed,
                        chunk_size=int(req.get("chunk_size", 0)),
                        seed=req.get("seed"))
                self._send(200, _wav_bytes(sr, pcm), "audio/wav")
            except ValueError as e:
                self._send_json_error(400, str(e))
            except Exception as e:  # noqa: BLE001 — a server thread reports and goes on
                self._send_json_error(500, f"{type(e).__name__}: {e}")

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(dia, host: str = "0.0.0.0", port: int = 7860, batcher=None) -> None:
    """Serve until SIGTERM or SIGINT, then drain: stop accepting, let the
    batcher finish what is queued and in flight, and return."""
    import signal
    import threading

    server = make_server(dia, host, port, batcher=batcher)
    mode = "serial" if batcher is None else type(batcher).__name__
    print(f"Serving Dia TTS API on http://{host}:{server.server_address[1]} "
          f"(POST /generate, POST /stream, {mode})", flush=True)

    def _drain(signum, frame):
        threading.Thread(target=server.shutdown, daemon=True).start()

    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            signal.signal(sig, _drain)
        except ValueError:  # not the main thread (tests): no handlers
            break
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.shutdown()
        print("Dia TTS server drained and stopped.", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Dia TTS serving app (stdlib HTTP API)")
    parser.add_argument("--model-path", type=str, required=True,
                        help="local model directory (config.json, model.safetensors, "
                             "dac_config.json, dac.safetensors)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--compute-dtype", type=str, default="bfloat16",
                        choices=["bfloat16", "float32"])
    parser.add_argument("--quantize-int8", action="store_true",
                        help="int8 weights for the decoder's dense kernels (and int8 KV caches)")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--dynamic-batch", action="store_true",
                        help="coalesce concurrent single-chunk /generate requests into "
                             "batched decode loops")
    parser.add_argument("--max-batch", type=int, default=8,
                        help="most requests in one batched decode loop")
    parser.add_argument("--batch-wait-ms", type=float, default=50.0,
                        help="longest wait for companions of a request")
    parser.add_argument("--continuous-batch", action="store_true",
                        help="resident decode lanes: a request joins the running batch at the "
                             "next segment boundary, and /stream streams from its lane")
    parser.add_argument("--cb-slots", type=int, default=4,
                        help="resident decode lanes for --continuous-batch")
    parser.add_argument("--cb-segment-steps", type=int, default=64,
                        help="decode steps between admissions (a multiple of 16 on the card)")
    parser.add_argument("--cb-max-tokens", type=int, default=1024,
                        help="per-request token cap (sets the self-cache length)")
    parser.add_argument("--cb-text-window", type=int, default=256,
                        help="cross-attention text window (encoded bytes) of every lane; a "
                             "longer request gets a 400")
    args = parser.parse_args(argv)
    if args.dynamic_batch and args.continuous_batch:
        parser.error("--dynamic-batch and --continuous-batch exclude each other")

    from .api import Dia

    dia = Dia.from_pretrained(args.model_path, compute_dtype=args.compute_dtype,
                              device=args.device)
    if args.quantize_int8:
        dia.quantize_int8()
    batcher = None
    if args.continuous_batch:
        from .cbatch import ContinuousBatcher

        batcher = ContinuousBatcher(dia, n_slots=args.cb_slots,
                                    segment_steps=args.cb_segment_steps,
                                    max_tokens=args.cb_max_tokens,
                                    text_window=args.cb_text_window)
    elif args.dynamic_batch:
        from .serving import DynamicBatcher

        batcher = DynamicBatcher(dia, max_batch=args.max_batch, max_wait_ms=args.batch_wait_ms)
    serve_http(dia, args.host, args.port, batcher=batcher)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
