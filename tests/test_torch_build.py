"""The kernel build (``ops/kernels/_build.py``) on the CPU, with a stand-in
compiler: every library is compiled with ``-Xptxas -v``, its report is kept
beside it, and a cached library returns the same report as a fresh build."""

import os
import stat

import pytest

from dia_tts_prune_tpu_torch.ops.kernels import _build

REPORT = "ptxas info    : Used 40 registers, 0 bytes spill stores, 0 bytes spill loads"


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """A ``$CUDA_HOME/bin/nvcc`` that records its arguments, writes the
    ``-o`` file and prints a ptxas line; libraries land in ``tmp_path``."""
    calls = tmp_path / "calls.txt"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(f"""#!/bin/sh
echo "$@" >> {calls}
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then shift; echo lib > "$1"; fi
  shift
done
echo "{REPORT}"
""")
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    return calls


def test_build_keeps_the_ptxas_report_beside_the_library(fake_nvcc):
    names = ("decode_attention", "int8_matmul")
    first = _build.build_all(names)
    for name in names:
        lib = _build.library_path(name)
        assert first[name]["path"] == str(lib) and not first[name]["cached"]
        assert REPORT in first[name]["log"]
        assert _build.log_path(lib).read_text() == first[name]["log"]
        assert lib.name.endswith(".so") and _build.log_path(lib).name.endswith(".ptxas.txt")
    lines = fake_nvcc.read_text().splitlines()
    assert len(lines) == 2 and all("-Xptxas -v" in line for line in lines)

    again = _build.build_all(names)  # cached: no compile, the same report
    assert len(fake_nvcc.read_text().splitlines()) == 2
    for name in names:
        assert again[name]["cached"] and again[name]["log"] == first[name]["log"]
    assert not [p for p in os.listdir(_build.BUILD_DIR) if p.startswith("tmp")]


def test_kernel_sources_are_every_cuda_source(fake_nvcc):
    """``KERNEL_SOURCES`` names every ``csrc/*.cu`` (the dense-rows and
    RMSNorm kernels among them), and ``build_all`` builds each, one nvcc
    a source."""
    on_disk = sorted(p.stem for p in _build.CSRC_DIR.glob("*.cu"))
    assert sorted(_build.KERNEL_SOURCES) == on_disk
    assert {"dense_rows", "rms_norm"} <= set(_build.KERNEL_SOURCES)
    built = _build.build_all()
    assert sorted(built) == on_disk and not any(v["cached"] for v in built.values())
    assert len(fake_nvcc.read_text().splitlines()) == len(on_disk)
