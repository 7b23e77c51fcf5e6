"""Build and load the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library with a plain C interface and loaded with ``ctypes``; nothing
includes PyTorch's headers, so a build takes seconds.  Libraries land in
``dia_tts_prune_tpu_torch/_build/`` (git-ignored), named by a hash of their
source and flags, so an edited source rebuilds and an unchanged one is reused.

Nothing here runs at import time: a kernel is built at its first CUDA use
(``kernel_function``), or all at once, in parallel, by ``build_all``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
KERNEL_SOURCES = ("flash_attention", "flash_attention_bwd", "decode_attention", "int8_matmul",
                  "int4_gemv", "block_sparse_matmul", "fused_step")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[tuple[str, str], ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda``,
    then ``PATH``.  Raises if there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNEL_SOURCES) -> dict[str, dict]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns {name: {"path", "seconds", "cached"}}; raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    result: dict[str, dict] = {}
    running = []
    for name in names:
        out = library_path(name)
        if out.exists():
            result[name] = {"path": str(out), "seconds": 0.0, "cached": True}
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        running.append((name, out, tmp, proc, time.perf_counter()))
    failures = []
    for name, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failures.append(
                f"{name}: nvcc exited {proc.returncode}\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        result[name] = {"path": str(out), "seconds": seconds, "cached": False}
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return result


def kernel_function(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry ``fn_name`` of ``csrc/<lib_name>.cu``, building and loading
    the library on first use.  Every entry returns a ``cudaError_t``."""
    fn = _functions.get((lib_name, fn_name))
    if fn is not None:
        return fn
    lib = _loaded.get(lib_name)
    if lib is None:
        build_all((lib_name,))
        lib = ctypes.CDLL(str(library_path(lib_name)))
        _loaded[lib_name] = lib
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _functions[(lib_name, fn_name)] = fn
    return fn
