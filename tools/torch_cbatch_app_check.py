#!/usr/bin/env python3
"""The serving app with continuous batching, as a user starts it.

Starts ``python -m dia_tts_prune_tpu_torch.app --continuous-batch`` on a
model directory in a child process, waits for ``/health``, then sends: two
concurrent ``/generate`` requests, one ``/stream``, ``GET /stats``, and a
text over the batcher's text window to both ``/generate`` (one chunk) and
``/stream``.  Checks: every served request answers 200 with a WAV, the
over-window ones answer 400 with a JSON error, ``/stats`` counts the
requests and one capture on the card (none on the CPU), and SIGTERM drains
the server to exit 0.  Prints one JSON line and exits non-zero if a check
fails.

Run from the repository root, on the card:
``python3 tools/torch_cbatch_app_check.py [--model-path tests/fixtures/trained_small]``;
on the CPU add ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def request(url: str, payload: dict | None = None, timeout: float = 600.0) -> tuple[int, bytes]:
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no one holds now (the kernel's pick), so
    that two checks on one machine do not meet on one port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model-path", default=str(REPO / "tests/fixtures/trained_small"))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--port", type=int, default=None, help="default: a free port")
    parser.add_argument("--max-tokens", type=int, default=128)
    parser.add_argument("--text-window", type=int, default=64)
    args = parser.parse_args()
    args.port = args.port or free_port()

    cmd = [sys.executable, "-m", "dia_tts_prune_tpu_torch.app", "--model-path", args.model_path,
           "--device", args.device, "--host", "127.0.0.1", "--port", str(args.port),
           "--continuous-batch", "--cb-slots", "4", "--cb-segment-steps", "32",
           "--cb-max-tokens", str(args.max_tokens), "--cb-text-window", str(args.text_window)]
    if args.device == "cpu":
        cmd += ["--compute-dtype", "float32"]
    server = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
    base = f"http://127.0.0.1:{args.port}"
    rec: dict = {"command": " ".join(cmd[1:])}
    try:
        t0 = time.perf_counter()
        while True:
            if server.poll() is not None:
                raise RuntimeError(f"the app exited {server.returncode}: {server.stdout.read()}")
            try:
                if request(f"{base}/health", timeout=5)[0] == 200:
                    break
            except OSError:
                pass
            if time.perf_counter() - t0 > 300:
                raise RuntimeError("the app did not answer /health within 300 s")
            time.sleep(0.5)
        rec["ready_s"] = time.perf_counter() - t0

        served: dict = {}

        def post(name, path, text, seed):
            t = time.perf_counter()
            status, body = request(f"{base}{path}", {
                "text": text, "max_new_tokens": args.max_tokens, "temperature": 1.3 * (seed % 2),
                "seed": seed, "chunk_size": 1000})
            served[name] = {"status": status, "bytes": len(body), "riff": body[:4] == b"RIFF",
                            "seconds": time.perf_counter() - t}

        clients = [threading.Thread(target=post, args=a) for a in (
            ("generate_0", "/generate", "[S1] Hello there. [S2] Hi!", 0),
            ("generate_1", "/generate", "[S2] A second request.", 1),
            ("stream", "/stream", "[S1] A streamed request.", 2))]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=900)
        over = "[S1] " + "word " * 40
        rejected = {path: request(f"{base}{path}", {"text": over, "chunk_size": 1000})
                    for path in ("/generate", "/stream")}
        status, body = request(f"{base}/stats")
        stats = json.loads(body) if status == 200 else None
        rec.update(served=served, stats=stats,
                   over_window={p: {"status": s, "error": json.loads(b).get("error", "")[:80]}
                                for p, (s, b) in rejected.items()})
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            rec["exit_code"] = server.wait(timeout=120)
        except subprocess.TimeoutExpired:
            server.kill()
            rec["exit_code"] = None
    ok = (all(v["status"] == 200 and v["riff"] for v in served.values()) and len(served) == 3
          and all(v["status"] == 400 and "text window" in v["error"]
                  for v in rec["over_window"].values())
          and stats is not None and stats["requests"] >= 5 and stats["completed"] >= 3
          and stats["captures"] == (1 if args.device.startswith("cuda") else 0)
          and rec["exit_code"] == 0)
    rec["ok"] = ok
    print(json.dumps(rec), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
