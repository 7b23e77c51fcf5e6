#!/usr/bin/env python3
"""Time the decode-attention kernel against an earlier source of itself, edited
copies of its current source, and SDPA.

Builds ``csrc/decode_attention.cu`` as it is and as each named variant edits it
(a list of (old, new) text edits), each by nvcc into a library of its own
called through the C entry the wrapper calls.  It builds an earlier copy of
the source too, given by ``--old`` (default: the copy in ``_parent/``, a
git-ignored directory into which the caller unpacks the parent commit with
``git archive``), whose C entry takes the split-K design's signature
(``decode_attention_fwd(q, kc, vc, ks, vs, k_new, v_new, start, end, out,
part, B, Tc, Nq, Nkv, H, dtype, kv_int8, stream)`` with an fp32 scratch of
``B * Nq * ceil(Tc / 128) * (H + 2)`` floats).  At the decode cases of
``chip_smoke.py``'s kernels phase (Dia-1.6B: 16 query heads, 4 kv heads in
self-attention, 16 in cross-attention, H = 128; bf16, inputs from a seed) it
prints one JSON line per case: the device time of each (CUDA-graph replay, in
turns old, a, b, ..., b, a, old), each one's ratio to the old kernel's, SDPA's
time on the same inputs (``F.scaled_dot_product_attention`` over the cache
with the range as its mask; int8 caches dequantized first, the current token
in slot ``end``), the largest difference of each output from the old one's,
and whether each output is bit-identical over two runs; then the card's name
and power limit.

Variants (``--variants``, default ``base``; each edit replaces every
occurrence): ``base`` — the source as it is; ``expf`` — ``expf`` on scores in
natural units instead of ``exp2f`` on log2-scaled ones; ``u4`` — 4 units a
lane per stage instead of 2; ``c16`` — clusters of 16 blocks (non-portable)
instead of 8; ``w8`` — 8 warps a block instead of 4; ``spread`` — the launch
asks the scheduler to spread a cluster's blocks over its GPC's SMs
(``cudaClusterSchedulingPolicySpread``); ``pad1`` — one block per SM (shared
memory asked for as 120 KB).

Run on the card from the repository root:
``python3 tools/torch_decode_ab.py [--old PATH] [--variants base c16 ...]``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

OLD_DEFAULT = REPO / "_parent" / "dia_tts_prune_tpu_torch" / "csrc" / "decode_attention.cu"
OLD_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
OLD_CHUNK = 128


def _const(name: str, old: int, new: int) -> tuple[str, str]:
    return f"constexpr int {name} = {old};", f"constexpr int {name} = {new};"


SMEM_ATTR = """    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
"""
# clusters of 16 blocks, above the portable size of 8
C16 = [_const("CLUSTER", 8, 16), (SMEM_ATTR, SMEM_ATTR + """    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
""")]
# the cluster's blocks spread over the GPC's SMs rather than packed
SPREAD = [("""  cfg.attrs = attr;
  cfg.numAttrs = 1;""", """  cudaLaunchAttribute attr2[2] = {attr[0], attr[0]};
  attr2[1].id = cudaLaunchAttributeClusterSchedulingPolicyPreference;
  attr2[1].val.clusterSchedulingPolicyPreference = cudaClusterSchedulingPolicySpread;
  cfg.attrs = attr2;
  cfg.numAttrs = 2;""")]
# one block per SM: shared memory asked for as if each block needed 120 KB
PAD1 = [("(int)smem);", "120 * 1024);"), ("cfg.dynamicSmemBytes = smem;",
                                             "cfg.dynamicSmemBytes = 120 * 1024;")]
# expf on scores in natural units instead of exp2f on log2-scaled ones
EXPF = [("exp2f(", "expf("), ("LOG2E / sqrtf((float)H)", "1.0f / sqrtf((float)H)")]
VARIANTS = {
    "base": [],
    "expf": EXPF,
    "u4": [_const("UNITS", 2, 4)],
    "c16": C16,
    "w8": [_const("NWARPS", 4, 8)],
    "spread": SPREAD,
    "pad1": PAD1,
}
# (case, B, T, Nkv, ends, starts, int8, with_new); Nq = 16, H = 128
CASES = [
    ("self", 2, 3072, 4, [1537, 1537], None, False, False),
    ("cross_S1024", 2, 1024, 16, [0, 700], None, False, False),
    ("cross_S128", 2, 128, 16, [0, 61], None, False, False),
    ("self_B8", 8, 3072, 4, [1537] * 8, None, False, False),
    ("start_gt_0", 4, 1024, 16, [700, 1024, 61, 5], [100, 1000, 0, 5], False, False),
    ("self_int8", 2, 3072, 4, [1537, 1537], None, True, True),
    ("cross_S1024_int8", 2, 1024, 16, [0, 700], None, True, False),
    ("cross_S128_int8", 2, 128, 16, [0, 61], None, True, False),
]


def build(sources: dict, out_dir: Path) -> dict:
    """{name: ctypes library}: one nvcc per source text, all at once."""
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    running = {}
    for name, text in sources.items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
        src.write_text(text)
        running[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (lib, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{log.decode(errors='replace')}")
        libs[name] = ctypes.CDLL(str(lib))
    return libs


def inputs(torch, B, T, Nkv, ends, starts, int8, with_new, Nq=16, H=128):
    from dia_tts_prune_tpu_torch.models.dia import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(2)
    dt = torch.bfloat16
    q = torch.randn(B, Nq, H, generator=g, device="cuda").to(dt)
    start = torch.tensor(starts or [0] * B, dtype=torch.int32, device="cuda")
    end = torch.tensor(ends, dtype=torch.int32, device="cuda")
    if not int8:
        k, v = (torch.randn(B, T, Nkv, H, generator=g, device="cuda").to(dt) for _ in range(2))
        return [q, k, v, start, end, None, None, None, None]
    (k8, ks), (v8, vs) = (quantize_kv(torch.randn(B, T, Nkv, H, generator=g, device="cuda"))
                          for _ in range(2))
    new = ([torch.randn(B, Nkv, H, generator=g, device="cuda").to(dt) for _ in range(2)]
           if with_new else [None, None])
    return [q, k8, v8, start, end, ks, vs, *new]


def caller(torch, lib, args, old: bool):
    """fn() launching ``lib``'s entry on ``args`` into a fixed output."""
    from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import _ARGTYPES

    fn = lib.decode_attention_fwd
    fn.argtypes, fn.restype = (OLD_ARGTYPES if old else _ARGTYPES), ctypes.c_int
    q, kc, vc, start, end = args[:5]
    B, Nq, H = q.shape
    T, Nkv = kc.shape[1], kc.shape[2]
    out = torch.empty_like(q)
    ptrs = [None if t is None else t.data_ptr() for t in args[5:]]
    part = []
    if old:
        part = [torch.empty(B * Nq * -(-T // OLD_CHUNK) * (H + 2), dtype=torch.float32,
                            device="cuda")]

    def run():
        err = fn(q.data_ptr(), kc.data_ptr(), vc.data_ptr(), *ptrs, start.data_ptr(),
                 end.data_ptr(), out.data_ptr(), *(p.data_ptr() for p in part), B, T, Nq, Nkv,
                 H, 1, int(args[5] is not None), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"decode_attention_fwd failed (cudaError {err})")
        return out

    return run


def sdpa_call(torch, args):
    import torch.nn.functional as F

    q, kc, vc, start, end, ks, vs, k_new, v_new = args
    B, Nq, H = q.shape
    T, Nkv = kc.shape[1], kc.shape[2]
    if ks is not None:
        kc, vc = (kc.float() * ks[..., None]).to(q.dtype), (vc.float() * vs[..., None]).to(q.dtype)
    end = end.clone()
    if k_new is not None:
        rows = torch.arange(B, device="cuda")
        kc[rows, end.long()], vc[rows, end.long()] = k_new, v_new
        end += 1
    slots = torch.arange(T, device="cuda")
    mask = ((slots[None] >= start[:, None]) & (slots[None] < end[:, None]))[:, None, None]
    kh, vh = (x.transpose(1, 2).repeat_interleave(Nq // Nkv, dim=1) for x in (kc, vc))
    return lambda: F.scaled_dot_product_attention(q[:, :, None], kh, vh, attn_mask=mask)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--old", type=Path, default=OLD_DEFAULT)
    p.add_argument("--variants", nargs="+", default=["base"], choices=sorted(VARIANTS))
    args = p.parse_args(argv)

    import torch

    from chip_smoke import graph_ms
    from dia_tts_prune_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        print("torch_decode_ab: no CUDA device", file=sys.stderr)
        return 1
    source = (_build.CSRC_DIR / "decode_attention.cu").read_text()
    sources = {"old": args.old.read_text()}
    for name in args.variants:
        text = source
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} is not in the source")
            text = text.replace(old, new)
        sources[name] = text
    with tempfile.TemporaryDirectory(prefix="decode_ab_") as tmp:
        libs = build(sources, Path(tmp))
        order = ["old", *args.variants]
        for case, B, T, Nkv, ends, starts, int8, with_new in CASES:
            x = inputs(torch, B, T, Nkv, ends, starts, int8, with_new)
            calls = {name: caller(torch, libs[name], x, name == "old") for name in order}
            outs = {name: fn().clone() for name, fn in calls.items()}
            repeat = {name: torch.equal(calls[name](), outs[name]) for name in order}
            times = {name: [] for name in order}
            for name in order + order[::-1]:
                times[name].append(graph_ms(torch, calls[name]))
            ms = {name: sum(t) / len(t) for name, t in times.items()}
            print(json.dumps({
                "tool": "torch_decode_ab", "case": case, "B": B, "T": T, "Nkv": Nkv,
                "ends": ends, "starts": starts, "cache": "int8" if int8 else "bf16",
                "current_token": with_new,
                "ms": ms, "ms_each_turn": times,
                "ratio_to_old": {n: ms[n] / ms["old"] for n in order},
                "sdpa_ms": graph_ms(torch, sdpa_call(torch, x)),
                "max_abs_diff_to_old": {n: (outs[n].float() - outs["old"].float()).abs().max()
                                        .item() for n in order},
                "bit_identical_over_two_runs": repeat}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
