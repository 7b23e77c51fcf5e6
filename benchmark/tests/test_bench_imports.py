"""What the benchmark may import, and the shape of BENCHMARK.json.

No module under ``benchmark/`` imports JAX or the JAX package
(``dia_tts_prune_tpu``; top-level names compared whole, since the port's
name begins with it), and the plain reference imports nothing of the
program (``dia_tts_prune_tpu_torch``).  Only the tests may import the
program beside the reference."""

import ast
import json
import re

import pytest

from conftest import BENCH

ROOT = BENCH.parent
JAX = {"jax", "jaxlib", "flax", "dia_tts_prune_tpu"}
PORT = "dia_tts_prune_tpu_torch"


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH)) for p in SOURCES])
def test_no_jax(path):
    assert not imported(path) & JAX


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((BENCH / "reference").rglob("*.py")):
        assert PORT not in imported(path), path
        assert not re.search(r"\bdia_tts_prune_tpu", path.read_text()), path


def test_the_yardstick_takes_nothing_from_the_program():
    """The comparison, the weights, the counts and the traffic import nothing
    of the program: what they judge or hand over is made here."""
    for name in ("correctness.py", "weights.py", "counts.py", "traffic.py", "tracing.py"):
        assert PORT not in imported(BENCH / name), name


def test_benchmark_json_keeps_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"][1].startswith("benchmark/")
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    names = [c["name"] for c in spec["configs"]] + [w["name"] for w in spec["workloads"]] + [
        m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(names)) == len(names) and all(name.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200 and (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        assert unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and unit.match(m["unit"]) and "\t" not in m["layer"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(spec)) <= 64 * 1024
