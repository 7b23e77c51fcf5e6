#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``dia_tts_prune_tpu_torch``) on one NVIDIA card.

Run from the repository root: ``python3 chip_smoke.py`` (no arguments, one
card).  Phases, each printing one JSON line; any failure raises and the
script exits non-zero:

1. build     — compile every CUDA kernel from ``dia_tts_prune_tpu_torch/csrc``
               (one nvcc per source, all at once);
2. kernels   — each kernel against its plain PyTorch version at the main
               path's shapes, fp32 and bf16: max abs error beside the stated
               tolerance, kernel / plain / library times (CUDA events), the
               least time the card could take, launches;
3. fixtures  — the trained fixtures through ``Dia.from_pretrained(...,
               device="cuda")`` in fp32: greedy tokens equal ``golden.npz``,
               waveform length and head as recorded;
4. full_width — Dia-1.6B shapes in bf16 and the 44.1 kHz DAC with weights
               from a numpy seed: a greedy and a seeded-sampled ``generate``
               and a voice-prompted ``generate_codes`` (the causal-flash
               prefill).  Launch counts are zeroed just before and read just
               after; every kernel must have launched.

Then a ``kernels`` line, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result, when
CUDA is unavailable or the package is not beside this file.
"""

from __future__ import annotations

import json
import subprocess
import sys
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
WAV_TOL = 1e-4  # cuDNN fp32 convs sum in another order than XLA's (the CPU test's cause)


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


def phase_build():
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    t0 = time.perf_counter()
    libs = _build.build_all()
    emit({"phase": "build", "ok": True, "seconds": round(time.perf_counter() - t0, 3),
          "nvcc": _build.nvcc_path(), "libs": libs})


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
    kernel_ms = cuda_ms(torch, lambda: flash_attention(q, k, v, seg, seg, causal))
    plain_ms = cuda_ms(torch, lambda: flash_attention_plain(q, k, v, seg, seg, causal), iters=5)
    mask = seg[:, :, None] == seg[:, None, :]
    if causal:
        mask &= torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    pairs = mask.sum().item()
    qh, kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // x.shape[2], dim=1) for x in (q, k, v))
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask[:, None]))
    e = q.element_size()
    nbytes = e * (2 * B * T * Nq * H + 2 * B * T * Nkv * H) + 4 * 2 * B * T
    bound_ms, bound_by = bound(nbytes, 4.0 * H * Nq * pairs, dtype)
    rec = {"phase": "kernels", "kernel": "flash_attention", "case": name, "dtype": dtype,
           "shape": {"B": B, "T": T, "Nq": Nq, "Nkv": Nkv, "H": H, "causal": causal,
                     "real_len": real_len},
           **errs, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launches}
    emit(rec)
    return rec


def decode_case(torch, name, dtype, B, T, Nq, Nkv, H, ends):
    import torch.nn.functional as F

    from dia_tts_prune_tpu_torch.ops.kernels import decode_attention, decode_attention_plain

    g = torch.Generator(device="cuda").manual_seed(2)
    dt = getattr(torch, dtype)
    q = torch.randn(B, Nq, H, generator=g, device="cuda").to(dt)
    k = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    v = torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt)
    start = torch.zeros(B, dtype=torch.int32, device="cuda")
    end = torch.tensor(ends, dtype=torch.int32, device="cuda")
    before = decode_attention.launches
    out = decode_attention(q, k, v, start, end)
    launches = decode_attention.launches - before
    errs = check(torch, f"decode_attention {name}", dtype, out, decode_attention_plain,
                 (q, k, v, start, end))
    for b, e_b in enumerate(ends):
        if e_b == 0 and not bool((out[b] == 0).all()):
            raise RuntimeError(f"decode_attention {name} {dtype}: end=0 row {b} is not exactly 0")
    kernel_ms = cuda_ms(torch, lambda: decode_attention(q, k, v, start, end), iters=100)
    plain_ms = cuda_ms(torch, lambda: decode_attention_plain(q, k, v, start, end))
    slots = torch.arange(T, device="cuda")
    mask = (slots[None] >= start[:, None]) & (slots[None] < end[:, None])
    qh = q[:, :, None]
    kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // Nkv, dim=1) for x in (k, v))
    library_ms = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        qh, kh, vh, attn_mask=mask[:, None, None]), iters=100)
    valid = sum(ends)
    e = q.element_size()
    nbytes = e * (2 * B * Nq * H + 2 * valid * Nkv * H) + 4 * 2 * B
    bound_ms, bound_by = bound(nbytes, 4.0 * H * Nq * valid, dtype)
    rec = {"phase": "kernels", "kernel": "decode_attention", "case": name, "dtype": dtype,
           "shape": {"B": B, "T": T, "Nq": Nq, "Nkv": Nkv, "H": H, "ends": list(ends)},
           **errs, "ms": kernel_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "launches": launches}
    emit(rec)
    return rec


def phase_kernels(torch) -> dict:
    """Every kernel at the main path's shapes; returns the bf16 record of
    each kernel's heaviest use for the final ``kernels`` line."""
    picked = {}
    for dtype in ("float32", "bfloat16"):
        enc = flash_case(torch, "encoder", dtype, 2, 1024, 16, 16, 128, False, [0, 300])
        flash_case(torch, "prefill", dtype, 2, 512, 16, 4, 128, True, [499, 499])
        for ends in ([1, 3072], [1537, 1537]):
            rec = decode_case(torch, "self", dtype, 2, 3072, 16, 4, 128, ends)
        decode_case(torch, "cross_S1024", dtype, 2, 1024, 16, 16, 128, [0, 700])
        decode_case(torch, "cross_S128", dtype, 2, 128, 16, 16, 128, [0, 61])
        picked = {"flash_attention": enc, "decode_attention": rec}
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


def phase_full_width(torch) -> dict:
    import numpy as np

    from dia_tts_prune_tpu_torch import Dia, dia_1_6b_config
    from dia_tts_prune_tpu_torch.models.dac import DACConfig, init_dac_decoder_params
    from dia_tts_prune_tpu_torch.models.dia import init_params
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    t0 = time.perf_counter()
    cfg = dia_1_6b_config()
    dac_cfg = DACConfig()
    dia = Dia(cfg, init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda"), "bfloat16",
              dac_params=init_dac_decoder_params(dac_cfg, seed=1, device="cuda"),
              dac_config=dac_cfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    text = ("[S1] Dia is an open weights text to dialogue model. [S2] You get full control "
            "over scripts and voices. [S1] Wow. Amazing.")
    runs = []

    def timed(fn):
        """(result, seconds, decode steps run): every step launches the decode
        kernel twice per decoder layer."""
        torch.cuda.synchronize()
        n0, t = launch_counts()["decode_attention"], time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps = (launch_counts()["decode_attention"] - n0) // (2 * cfg.model.decoder.n_layer)
        return out, time.perf_counter() - t, steps

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
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    results = []
    for name, frames, steps, gen_s, dec_s, w in runs:
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
        results.append(rec)
    if codes.shape[0] == 0 or pcodes.shape[0] == 0:
        raise RuntimeError("full-width run generated no frames")
    rec = {"phase": "full_width", "config": "dia_1_6b_config() bf16, DACConfig(), seed weights",
           "init_s": init_s, "runs": results, "launches": counts,
           "peak_memory_bytes": int(peak)}
    emit(rec)
    missing = [k for k, n in counts.items() if n <= 0]
    if missing:
        raise RuntimeError(f"main path never launched {missing}: {counts}")
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

    t0 = time.perf_counter()
    phase_build()
    picked = phase_kernels(torch)
    phase_fixtures(torch, repo)
    full = phase_full_width(torch)

    sources = {"flash_attention": ("dia_tts_prune_tpu_torch/csrc/flash_attention.cu",
                                   "dia_tts_prune_tpu/ops/kernels/flash_attention.py:359"),
               "decode_attention": ("dia_tts_prune_tpu_torch/csrc/decode_attention.cu",
                                    "dia_tts_prune_tpu/ops/kernels/decode_attention.py:133")}
    emit({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": full["launches"][name], "max_abs_err": picked[name]["max_abs_err"],
         "ms": picked[name]["ms"], "plain_ms": picked[name]["plain_ms"],
         "bound_ms": picked[name]["bound_ms"], "bound_by": picked[name]["bound_by"],
         "library_ms": picked[name]["library_ms"],
         "case": f"{picked[name]['case']} {picked[name]['dtype']}"}
        for name, (src, replaces) in sources.items()]})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no card listed", flush=True)
    print(f"# chip_smoke total {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
