"""The benchmark's tests: its modules and the program on the path, one
torch thread a worker.  Run from the repository's root:

    python -m pytest benchmark/tests -q -p no:cacheprovider

Tests marked ``gpu`` need a CUDA device and skip without one (decided inside
the test)."""

import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]
torch.set_num_threads(1)

FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture
def tiny():
    """(spec path, traffic dir) of the tiny cells: the four cells of
    ``BENCHMARK.json`` at the tiny widths, float32, on short requests."""
    return FIXTURES / "BENCHMARK.json", FIXTURES / "traffic"
