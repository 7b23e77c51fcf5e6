"""The metric arithmetic, the drivers' statistics and finding files by name."""

import json
import shutil
import statistics
import types

import pytest

import counts
import harness
import readers
import traffic
from conftest import BENCH, FIXTURES

ROOT = BENCH.parent
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
MODEL = json.loads((BENCH / "configs" / "dia-1.6b-bf16.json").read_text())["dia"]
D = counts.Dims.of(MODEL)


def test_bf16_products_read_2_53_gb():
    """The 145 products of a bf16 step read 2.53 GB of weights: 0.756 ms at
    3.35 TB/s (PERF.md's bound of the float step's products)."""
    prods = counts.decoder_products(D)
    assert len(prods) == 145
    w = sum(2 * K * N for K, N in prods)
    assert round(w / 1e9, 2) == 2.53
    calls = sum(counts.dense_rows_bytes(2, K, N) for K, N in prods)
    assert calls - w == sum(2 * 2 * (K + N) for K, N in prods)  # x in, bf16 out, 2 rows
    assert round(1e3 * calls / counts.PEAKS["hbm_bytes_per_s"], 3) == 0.756


def test_int8_pack_is_1_248_gb():
    """The fused step's int8 pack (values and a scale a column): 1.248 GB."""
    pack = sum(K * N + 4 * N for K, N in counts.decoder_products(D)[:-1])
    assert round(pack / 1e9, 3) == 1.248


def test_step_work_by_hand():
    route = counts.Route("bf16", False)
    flops, nbytes = counts.step_work(D, route, 2, 2 * 100, 150)
    prods = counts.decoder_products(D)
    want_b = (sum(2 * K * N for K, N in prods) + 55 * 2048 * 2 + 2 * 9 * 2048 * 2
              + 2 * sum(2 * (K + N) for K, N in prods[:-1]) + 2 * 2048 * 2 + 2 * 9 * 1028 * 4
              + 200 * 18 * 2 * 4 * 128 * 2 + 150 * 18 * 2 * 16 * 128 * 2 + 2 * 18 * 2 * 4 * 256)
    assert nbytes == want_b
    assert flops == sum(2 * 2 * K * N for K, N in prods) + 18 * 4 * 128 * (16 * 200 + 16 * 150)
    assert counts.least_seconds(flops, nbytes) == nbytes / 3.35e12


def test_solo_call_work_sums_its_steps():
    route = counts.Route("fused", True)
    f, b = counts.solo_call_work(D, route, 3, 40)
    parts = [counts.step_work(D, route, 2, 2 * t, 40) for t in (1, 2, 3)]
    assert f == sum(p[0] for p in parts) and b == sum(p[1] for p in parts)


def test_window_numbers_are_over_every_call():
    """The per-request numbers sum every call of the window, not medians of
    pieces: captures a request, and the step's device time over all steps."""
    caps = harness.load_module(BENCH / "metrics" / "graph_captures_per_request.py", "t_caps")
    calls = [dict(captures=c, replays=r, graph_steps=16, step_replays=0, replay_device_seconds=t)
             for c, r, t in ((0, 1, 0.1), (0, 1, 0.1), (3, 10, 2.0))]
    ctx = types.SimpleNamespace(window=types.SimpleNamespace(layer={"calls": calls}))
    assert caps.read(ctx) == 1.0 != statistics.median(c["captures"] for c in calls)
    assert readers.step_device_ms(ctx) == pytest.approx(1e3 * 2.2 / (12 * 16))


def ctx_with(layer, summary=None, config="dia-1.6b-bf16", mix="solo"):
    cell = types.SimpleNamespace(
        config=json.loads((BENCH / "configs" / f"{config}.json").read_text()),
        mix=json.loads((BENCH / "traffic" / f"{mix}.json").read_text()))
    return types.SimpleNamespace(window=types.SimpleNamespace(layer=layer), summary=summary,
                                 config=cell.config, mix=cell.mix)


def test_step_readers_take_every_call():
    calls = [{"replays": 10, "graph_steps": 16, "step_replays": 0, "replay_device_seconds": 0.5,
              "wall_seconds": 0.6, "decode_steps": 150, "cross_len": 100},
             {"replays": 2, "graph_steps": 16, "step_replays": 0, "replay_device_seconds": 0.1,
              "wall_seconds": 0.2, "decode_steps": 30, "cross_len": 50}]
    ctx = ctx_with({"calls": calls})
    assert readers.step_device_ms(ctx) == pytest.approx(1e3 * 0.6 / 192)
    loop = harness.load_module(BENCH / "metrics" / "loop_host_gap_ms.py", "t_loop")
    assert loop.read(ctx) == pytest.approx(1e3 * 0.2 / 192)
    d, r = counts.Dims.of(ctx.config["dia"]), counts.Route("bf16", False)
    least = sum(counts.least_seconds(*counts.solo_call_work(d, r, c["decode_steps"],
                                                            c["cross_len"])) for c in calls)
    assert readers.step_mfu(ctx) == pytest.approx(100 * least / 0.6)


def test_product_roofline_by_hand():
    import tracing

    s = tracing.Summary(start=0, end=10_000_000, device=[
        ("void dense_rows_wgmma_kernel<1, 0>", i * 20_000, i * 20_000 + 10_000)
        for i in range(290)], host=[])
    ctx = ctx_with({}, s)
    per = sum(counts.dense_rows_bytes(2, K, N) for K, N in counts.decoder_products(D)) / 145
    want = 100 * 290 * per / 3.35e12 / (290 * 10_000 / 1e9)
    assert readers.dense_rows_roofline(ctx) == pytest.approx(want)
    assert readers.dense_rows_roofline(ctx_with({}, tracing.Summary(0, 1, [], []))) is None
    assert s.busy_s() == pytest.approx(290 * 10_000 / 1e9)
    assert s.idle_gaps(2)[0][0] == "no host event"


def test_every_metric_has_its_file_and_reads_none_without_a_source():
    ctx = ctx_with({}, None)
    for m in SPEC["per_layer"]:
        mod = harness.load_module(BENCH / "metrics" / f"{m['name']}.py", "t_" + m["name"])
        assert mod.read(ctx) is None, m["name"]


def test_a_dropped_in_mix_is_found_by_name(tmp_path):
    spec = json.loads((FIXTURES / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "bf16-burst", "config": "dia-1.6b-bf16",
                              "traffic": "burst", "chips": 1, "why": "a test"})
    (tmp_path / "configs").mkdir()
    for c in spec["configs"]:
        shutil.copy(FIXTURES / c["file"], tmp_path / c["file"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    tdir = tmp_path / "traffic"
    shutil.copytree(FIXTURES / "traffic", tdir)
    mix = json.loads((tdir / "solo.json").read_text())
    mix["lengths"]["count"] = 9
    (tdir / "burst.json").write_text(json.dumps(mix))
    cell = harness.load_cell("bf16-burst", tmp_path / "BENCHMARK.json", tdir)
    assert cell.mix["lengths"]["count"] == 9 and cell.config["name"] == "dia-1.6b-bf16"
    assert harness.per_layer_names(cell) == []


def test_cells_report_their_metrics():
    for w in SPEC["workloads"]:
        cell = harness.load_cell(w["name"])
        e2e = harness.end_to_end_names(cell)
        assert "setup_s" in e2e and len(e2e) >= 2
        assert harness.per_layer_names(cell)
        assert (BENCH / "drivers" / f"{cell.mix['driver']}.py").is_file()


def test_traffic_gives_every_seed_the_same_work():
    mix = json.loads((BENCH / "traffic" / "solo.json").read_text())
    n = mix["lengths"]["count"]

    def cycle(seed):
        it = traffic.requests(mix, seed)
        return [next(it) for _ in range(n)]

    a, b = cycle(1), cycle(2**31 + 99)
    assert sorted(r.max_tokens for r in a) == sorted(r.max_tokens for r in b)
    assert sorted(len(r.text) for r in a) == sorted(len(r.text) for r in b)
    assert [r.slot for r in a] != [r.slot for r in b]
    assert [r.text for r in cycle(5)] == [r.text for r in cycle(5)]
    assert sum(r.greedy for r in a) == len(traffic.greedy_slots(mix)) >= 1
    longest = max(a, key=lambda r: r.max_tokens)
    assert longest.greedy
    for r in a:
        assert mix["text"]["min"] <= len(r.text) <= mix["text"]["max"]
        assert r.text.startswith("[S1] ")


def test_fused_roofline_by_hand():
    """Launch i of the traced request is its step i + 1; launches past the
    stop repeat the last step; each against its own least time."""
    import tracing

    s = tracing.Summary(start=0, end=10**9, device=[
        ("void (anonymous namespace)::fused_step_kernel<1>", i * 10**6, i * 10**6 + 500_000)
        for i in range(5)], host=[])
    ctx = ctx_with({"traced_call": {"decode_steps": 3, "cross_len": 100}}, s,
                   config="dia-1.6b-int8-fused")
    d = counts.Dims.of(ctx.config["dia"])
    pack = sum(K * N + 4 * N for K, N in counts.decoder_products(d)[:-1])
    slot = 18 * 2 * 4 * (128 + 4)
    key = 18 * 2 * 16 * (128 + 4)
    want = sum((pack + 2 * t * slot + 100 * key + 4 * 2048 * 4) / 3.35e12 for t in (1, 2, 3, 3, 3))
    assert readers.fused_roofline(ctx) == pytest.approx(100 * want / (5 * 500_000 / 1e9))
