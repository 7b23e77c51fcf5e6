"""Tensor-parallel serving of the port (``parallel/sharding.py`` and its
users) against the JAX package's sharding module and single-device runs, on
the CPU.

JAX drives its 8 virtual devices from one process (tests/test_sharding.py);
the port runs one rank a process, so the sharded runs here are processes
over gloo (tests/torch_tp_worker.py), each with its own rendezvous file
under ``tmp_path``, a process-group timeout and a subprocess timeout: a rank
that dies fails the test and never hangs the run.

* The spec functions equal JAX's leaf by leaf (``param_specs``,
  ``fsdp_param_specs``, the cache and batch specs, ``validate_divisibility``)
  at ``_tp_config`` and ``dia_1_6b_config()``; mesh shapes and errors on 4
  ranks equal JAX's on 4 devices.
* Greedy codes at (data, model) = (1, 2), (1, 4) and (2, 2), 40 tokens,
  fp32, equal the unsharded port run and the JAX single-device run, for
  float weights, int8 weights with int8 KV caches, and int4 group 16
  halfsplit (weights through ``checkpoint.params_from_jax``).  Exact: in
  fp32 the ranks' partial sums differ from one product's only by summation
  order (~1e-7 of a logit), and greedy picks are far from ties here — the
  JAX test asserts the same equality.
* Every rank's packed shard, unpacked, equals the unsharded pack's rows or
  columns byte for byte, scales included; the float shards concatenate to
  the full leaves.
* The loss forward under a mesh equals the unsharded loss (rtol 1e-5, the
  JAX test's: summation order), and so do its gradients: a rank's rows of
  a row-parallel kernel, and two replicated leaves whose gradients pass
  every model-axis sum (rtol 1e-5, atol 1e-7).
* A two-rank ``ContinuousBatcher`` gives each lane (greedy, seeded, streamed)
  its solo codes; a follower that fails fails the waiting request and ends.
* ``app --device cpu --tp 2 --continuous-batch`` serves the bytes that the
  unsharded batcher's waveform gives.
* The routes without a tensor-parallel form raise.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.config import dia_1_6b_config as jax_1_6b
from dia_tts_prune_tpu.generate import DiaGenerator as JaxGenerator
from dia_tts_prune_tpu.models.dia import init_params as jax_init
from dia_tts_prune_tpu.ops.quant import quantize_params_int4_packed as jax_int4
from dia_tts_prune_tpu.ops.quant import quantize_params_int8_packed as jax_int8
from dia_tts_prune_tpu.parallel import sharding as jsh
from dia_tts_prune_tpu_torch import Dia, app, dia_1_6b_config
from dia_tts_prune_tpu_torch.cbatch import ContinuousBatcher
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.parallel import sharding as tsh
from dia_tts_prune_tpu_torch.train import compute_loss
from tests.test_sharding import _tp_config
from tests.torch_tp_worker import (
    PACKED,
    TEXT,
    TOKENS,
    loss_batch,
    loss_grads,
    tp_config,
    unpacked,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
WORKER = Path(__file__).with_name("torch_tp_worker.py")
SMALL = Path(__file__).parent / "fixtures" / "trained_small"
RANK_TIMEOUT = 300  # seconds a rank process may take before the test fails
MESHES = {"tp12": (2, [1, 2]), "tp14": (4, [1, 4]), "tp22": (4, [2, 2])}
CB_TOKENS = 48
CB_REQUESTS = [("[S1] tp lane zero", 0.0, 11), ("[S1] tp lane one differs", 1.2, 12),
               ("[S2] a streamed lane", 0.9, 13)]
ROUTES = ("float", "int8", "int4")


def _env():
    return dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""),
                OMP_NUM_THREADS="1")


def _start(job: str, world: int, out: Path, args: dict) -> list:
    """``world`` rank processes of ``job``, writing into ``out`` (a new
    directory: its rendezvous file and results are the run's own)."""
    out.mkdir()
    init = f"file://{out / 'rendezvous'}"
    return [subprocess.Popen([sys.executable, str(WORKER), job, str(r), str(world), init, str(out),
                              json.dumps(args)], env=_env(), cwd=out, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _finish(procs: list, out: Path, job: str) -> list:
    """Every rank's result; a rank that fails or outlasts RANK_TIMEOUT fails
    the run (the others are killed)."""
    deadline = time.monotonic() + RANK_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    bad = [(r, p.returncode, log[-3000:]) for r, (p, log) in enumerate(zip(procs, logs))
           if p.returncode != 0]
    assert not bad, f"{job}: ranks failed: {bad}"
    return [torch.load(out / f"{job}.rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _jax_codes(jparams, jcfg, route: str) -> np.ndarray:
    if route == "int8":
        jparams = jax_int8(jparams, fused=False)
    elif route == "int4":
        jparams = jax_int4(jparams, group=16, nibble=True, halfsplit=True)
    old = os.environ.get("DIA_KV_INT8")
    if route != "float":  # the port's packed routes keep int8 KV caches
        os.environ["DIA_KV_INT8"] = "1"
    try:
        return JaxGenerator(jparams, jcfg).generate_tokens(TEXT, max_tokens=TOKENS,
                                                            temperature=0.0)
    finally:
        if old is None:
            os.environ.pop("DIA_KV_INT8", None)
        else:
            os.environ["DIA_KV_INT8"] = old


def _port(weights) -> Dia:
    return Dia(tp_config(), torch.load(weights), device="cpu")


def _quantized(dia: Dia, route: str) -> Dia:
    if route == "int8":
        dia.quantize_int8()
    elif route == "int4":
        dia.quantize_int4(group=16, halfsplit=True)
    return dia


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """Every sharded run, started at once, and the references computed here
    while they run: the unsharded port, the JAX single-device runs, the
    solo runs of the batcher's lanes."""
    out = tmp_path_factory.mktemp("tp")
    jcfg = _tp_config()
    jparams = jax_init(jcfg, jax.random.PRNGKey(1))
    weights = out / "weights.pt"
    torch.save(params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu"), weights)
    started = {name: _start("generate", world, out / name,
                            {"mesh": mesh, "weights": str(weights), "route_checks": name == "tp12",
                             "mesh_checks": name == "tp22"})
               for name, (world, mesh) in MESHES.items()}
    started["cbatch"] = _start("cbatch", 2, out / "cbatch", {
        "weights": str(weights), "max_tokens": CB_TOKENS, "requests": CB_REQUESTS})
    ref = {"port": {}, "jax": {}, "packed": {}}
    for route in ROUTES:
        dia = _quantized(_port(weights), route)
        ref["port"][route] = dia.generate_codes(TEXT, max_tokens=TOKENS, temperature=0.0)
        ref["jax"][route] = _jax_codes(jparams, jcfg, route)
        if route != "float":
            layers = dia.params["decoder"]["layers"]
            ref["packed"][route] = {f"{a}.{k}": unpacked(layers[a][k]["kernel"])
                                    for a, k in PACKED}
    whole = _port(weights)
    ref["float"] = {f"{a}.{k}": whole.params["decoder"]["layers"][a][k]["kernel"]
                    for a, k in PACKED}
    with torch.no_grad():
        ref["loss"] = float(compute_loss(whole.params, whole.config, loss_batch(whole.config)))
    ref["grads"] = loss_grads(whole.params, whole.config, loss_batch(whole.config))
    ref["solo"] = [whole.generate_codes(text, max_tokens=CB_TOKENS, temperature=t, seed=s)
                   for text, t, s in CB_REQUESTS]
    runs = {name: _finish(procs, out / name, "cbatch" if name == "cbatch" else "generate")
            for name, procs in started.items()}
    return runs, ref


# ---------------------------------------------------------------------------
# The spec functions against JAX's
# ---------------------------------------------------------------------------


def _leaves(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _same_specs(port, jax_tree):
    got = [(p, tuple(s)) for p, s in _leaves(port)]
    want = [(p, tuple(s)) for p, s in _leaves(jax_tree)]
    assert got == want


def _configs():
    return [(tp_config(), _tp_config()), (dia_1_6b_config(), jax_1_6b())]


@pytest.mark.parametrize("which", [0, 1], ids=["tp_config", "dia_1_6b"])
def test_param_specs_equal_jax(which):
    cfg, jcfg = _configs()[which]
    _same_specs(tsh.param_specs(cfg), jsh.param_specs(jcfg))


@pytest.mark.parametrize("which", [0, 1], ids=["tp_config", "dia_1_6b"])
@pytest.mark.parametrize("data,min_elements", [(4, 1 << 12), (2, 1 << 16), (1, 1 << 12)])
def test_fsdp_param_specs_equal_jax(which, data, min_elements):
    """The leaves' shapes only: JAX's ``eval_shape`` of its init, and meta
    tensors of the same shapes for the port."""
    cfg, jcfg = _configs()[which]
    shapes = jax.eval_shape(lambda: jax_init(jcfg, jax.random.PRNGKey(0)))

    def meta(tree):
        return {k: meta(v) if isinstance(v, dict) else torch.empty(v.shape, device="meta")
                for k, v in tree.items()}

    mesh = {"data": data, "model": 8 // data}
    _same_specs(tsh.fsdp_param_specs(cfg, meta(shapes), mesh, min_elements),
                jsh.fsdp_param_specs(jcfg, shapes, types.SimpleNamespace(shape=mesh),
                                     min_elements))


def test_cache_and_batch_specs_equal_jax():
    assert tuple(tsh.self_cache_spec()) == tuple(jsh.self_cache_spec())
    assert tuple(tsh.cross_cache_spec()) == tuple(jsh.cross_cache_spec())
    for ndim in (1, 3):
        assert tuple(tsh.batch_spec(ndim)) == tuple(jsh.batch_spec(ndim))
        hybrid = jsh.make_hybrid_mesh(replica=2, data=2, model=2)
        assert tuple(tsh.batch_spec(ndim, {"replica": 2, "data": 2, "model": 2})) == \
            tuple(jsh.batch_spec(ndim, hybrid))


@pytest.mark.parametrize("which", [0, 1], ids=["tp_config", "dia_1_6b"])
def test_validate_divisibility_equals_jax(which):
    cfg, jcfg = _configs()[which]
    for size in (1, 2, 3, 4, 8, 16, 32):
        assert tsh.validate_divisibility(cfg, size) == jsh.validate_divisibility(jcfg, size)


def test_mesh_shapes_and_errors_equal_jax(tp):
    """4 ranks (the (2, 2) run) against JAX on 4 of its virtual devices."""
    runs, _ = tp
    devs = np.asarray(jax.devices()[:4])
    for rank in runs["tp22"]:
        m = rank["mesh"]
        for key, kw in (("2x2", dict(data=2, model=2)), ("default", {}),
                        ("model_only", dict(model=2))):
            assert dict(zip(("data", "model"), m[key])) == dict(
                jsh.make_mesh(devices=devs, **kw).shape)
        hybrid = jsh.make_hybrid_mesh(replica=2, data=2, model=1, devices=devs)
        assert dict(zip(m["hybrid"][1], m["hybrid"][0])) == dict(hybrid.shape)
        assert m["hybrid_via_make_mesh"] == m["hybrid"][0]
        for key, kw in (("3x4", dict(data=3, model=4)),):
            assert m[key].startswith("ValueError: mesh 3x4 != 4 ranks")
            with pytest.raises(ValueError):
                jsh.make_mesh(devices=devs, **kw)
        assert m["hybrid_3x2x2"].startswith("ValueError")
        with pytest.raises(ValueError):
            jsh.make_hybrid_mesh(replica=3, data=2, model=2, devices=devs)
        assert m["batch_spec_hybrid"] == tuple(jsh.batch_spec(3, hybrid))
    # one example per (replica, data) pair, in rank order
    rows = [r["mesh"]["batch_rows_hybrid"] for r in runs["tp22"]]
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    for rank, got in enumerate(rows):
        torch.testing.assert_close(got, x[rank: rank + 1], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# Sharded runs against the unsharded port and JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_coordinates(tp, name):
    runs, _ = tp
    data, model = MESHES[name][1]
    assert [tuple(r["coord"]) for r in runs[name]] == [
        (d, m) for d in range(data) for m in range(model)]
    assert all(tuple(r["shape"]) == (data, model) for r in runs[name])


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_greedy_codes_equal_unsharded_and_jax(tp, name, route):
    runs, ref = tp
    for rank in runs[name]:
        codes = rank[f"codes_{route}"]
        np.testing.assert_array_equal(codes, ref["port"][route])
        np.testing.assert_array_equal(codes, ref["jax"][route])
    assert ref["port"][route].shape[0] > 0


def _model_slice(t: torch.Tensor, key: str, m: int, M: int, scale: bool, grouped: bool):
    """The unsharded pack's part that model rank ``m`` of ``M`` holds: a
    column block of q_proj (heads x H flattened), the F block of each half
    of wi_fused; a row block of o_proj / wo and of their grouped scales
    (per-column scales span K: whole)."""
    if key.endswith("q_proj"):
        n = t.shape[-1] // M
        return t[..., m * n:(m + 1) * n]
    if key.endswith("wi_fused"):
        halves = t.unflatten(-1, (2, t.shape[-1] // 2))
        f = halves.shape[-1] // M
        return halves[..., m * f:(m + 1) * f].flatten(-2)
    if scale and not grouped:
        return t
    k = t.shape[-2] // M
    return t[..., m * k:(m + 1) * k, :]


@pytest.mark.parametrize("route", ["int8", "int4"])
@pytest.mark.parametrize("name", list(MESHES))
def test_packed_shards_are_slices_of_the_whole_pack(tp, name, route):
    """Each rank's packed kernel, unpacked, is the unsharded pack's slice,
    byte for byte, scales included, in the whole kernel's format."""
    runs, ref = tp
    M = MESHES[name][1][1]
    for rank in runs[name]:
        m = rank["coord"][1]
        for key, got in rank[f"packed_{route}"].items():
            whole = ref["packed"][route][key]
            assert got["format"] == whole["format"], key
            grouped = route == "int4" and whole["format"][0] is not None
            assert torch.equal(got["rows"], _model_slice(whole["rows"], key, m, M, False, grouped))
            assert torch.equal(got["scale"],
                               _model_slice(whole["scale"], key, m, M, True, grouped)), key


@pytest.mark.parametrize("name", list(MESHES))
def test_float_shards_concatenate_to_the_whole(tp, name):
    runs, ref = tp
    data, M = MESHES[name][1]
    dims = {"q_proj": 2, "o_proj": 1, "wi_fused": 3, "wo": 1}
    for key, whole in ref["float"].items():
        dim = dims[key.split(".")[-1]]
        for d in range(data):
            parts = [r["float_shards"][key] for r in runs[name] if r["coord"][0] == d]
            assert len(parts) == M
            assert torch.equal(torch.cat(parts, dim=dim), whole), key


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_loss_forward_equals_unsharded(tp, name):
    """The loss under the mesh, and its gradients: ``wo``'s (the rank's rows
    of F) and two replicated leaves' (every rank's whole)."""
    runs, ref = tp
    M = MESHES[name][1][1]
    for rank in runs[name]:
        np.testing.assert_allclose(rank["loss"], ref["loss"], rtol=1e-5)
        m = rank["coord"][1]
        for key, want in ref["grads"].items():
            if key.endswith("wo.kernel"):
                f = want.shape[1] // M
                want = want[:, m * f:(m + 1) * f]
            torch.testing.assert_close(rank["grads"][key], want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# Routes without a tensor-parallel form raise; nothing picks another route
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("route,message", [
    ("fused", "NotImplementedError: the fused-step pack has no tensor-parallel form"),
    ("speculative", "NotImplementedError: speculative decoding has no tensor-parallel form"),
    ("dynamic_batcher", "NotImplementedError: DynamicBatcher has no tensor-parallel form"),
    ("block_sparse", "NotImplementedError: block-sparse (pruned) kernels have no"),
    ("shard_block_sparse", "TypeError: decoder.layers.self_attention.q_proj.kernel: a "
                           "BlockSparseKernel cannot be sharded"),
    ("shard_packed", "TypeError: decoder.layers.self_attention.q_proj.kernel: a "
                     "QuantizedKernel cannot be sharded"),
    ("graph_loop_gloo", "ValueError: loop='graph' under a mesh needs collectives that a CUDA "
                        "graph can capture (NCCL); this mesh's model group runs gloo"),
    ("indivisible", "ValueError: x: dimension 1 of shape (2, 3, 4) (3) does not divide over "
                    "mesh axis 'model' (2 ranks)"),
])
def test_routes_without_a_tensor_parallel_form_raise(tp, route, message):
    runs, _ = tp
    for rank in runs["tp12"]:
        assert rank["raises"][route].startswith(message), rank["raises"][route]


def test_gloo_runs_the_eager_loop_only_when_asked(tp):
    runs, _ = tp
    for rank in runs["tp12"]:
        assert rank["raises"]["eager_loop_gloo"] == ""
        assert rank["raises"]["gloo_capturable"] is False


def test_int4_format_a_shard_cannot_hold_raises():
    """A row-parallel shard whose slice of K the whole kernel's groups do not
    tile: the packer refuses rather than pick another format for it."""
    from dia_tts_prune_tpu_torch.ops import quant

    w = torch.randn(2, 64, 8)  # stacked [L, K, N]: K = 64 on each of 4 ranks, 256 in all
    real = quant._k_shards
    quant._k_shards = lambda group: 4
    try:
        with pytest.raises(ValueError, match="cannot hold"):
            quant.quantize_int4(w, stacked=True, group=128, halfsplit=True, model_group="m")
        ok = quant.quantize_int4(w, stacked=True, group=32, halfsplit=False, model_group="m")
        assert (ok.group, ok.halfsplit) == (32, False)
    finally:
        quant._k_shards = real


# ---------------------------------------------------------------------------
# Serving: the continuous batcher and the app
# ---------------------------------------------------------------------------


def test_two_rank_batcher_lanes_equal_their_solo_runs(tp):
    runs, ref = tp
    leader, follower = runs["cbatch"]
    for got, solo in zip(leader["lanes"], ref["solo"][:2]):
        np.testing.assert_array_equal(got, solo)
    np.testing.assert_array_equal(leader["stream"], ref["solo"][2])
    assert leader["stats"]["completed"] == 3 and leader["stats"]["segments"] > 0


def test_a_failing_follower_fails_every_waiting_request(tp):
    runs, _ = tp
    leader, follower = runs["cbatch"]
    assert leader["failed_request"] == "RuntimeError: another rank failed in the batcher's 'admit'"
    assert leader["after_failure"] == "RuntimeError: batcher is shut down"
    assert follower["follower"] == "RuntimeError: rank 1 lost its lane"


def test_app_tp2_on_the_cpu_serves_the_unsharded_bytes(tmp_path):
    """``python -m dia_tts_prune_tpu_torch.app --device cpu --tp 2
    --continuous-batch`` on trained_small (2 KV heads: one a rank): one
    greedy ``/generate`` answers the WAV that the unsharded batcher's
    waveform gives; SIGTERM drains both ranks and exits 0."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "dia_tts_prune_tpu_torch.app", "--model-path", str(SMALL),
         "--device", "cpu", "--compute-dtype", "float32", "--continuous-batch", "--tp", "2",
         "--cb-slots", "2", "--cb-segment-steps", "16", "--cb-max-tokens", "64",
         "--cb-text-window", "128", "--host", "127.0.0.1", "--port", "0"],
        env=_env(), cwd=tmp_path, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    request = {"text": "[S1] Two ranks, one voice.", "max_new_tokens": 64, "temperature": 0.0}
    try:
        dia = Dia.from_pretrained(SMALL, device="cpu")
        cb = ContinuousBatcher(dia, n_slots=2, segment_steps=16, max_tokens=64, text_window=128)
        try:
            want = app._wav_bytes(app.SAMPLE_RATE, app._pcm16(cb.generate(
                request["text"], max_tokens=64, temperature=0.0)))
        finally:
            cb.shutdown()
        seen = []
        while not seen or "Serving Dia TTS API on http://127.0.0.1:" not in seen[-1]:
            seen.append(proc.stdout.readline())  # the banner, once rank 0 listens
            assert seen[-1], "".join(seen)  # the app ended before it served
        port = int(seen[-1].split("127.0.0.1:")[1].split()[0])
        req = urllib.request.Request(f"http://127.0.0.1:{port}/generate",
                                     data=json.dumps(request).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=RANK_TIMEOUT) as r:
            assert r.status == 200
            got = r.read()
        assert got == want
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
        assert proc.returncode == 0, out[-2000:]
        assert "drained and stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def test_app_tp_needs_the_continuous_batcher_and_enough_cards(capsys):
    with pytest.raises(SystemExit):
        app.main(["--model-path", str(SMALL), "--device", "cpu", "--tp", "2"])
    assert "--tp requires --continuous-batch" in capsys.readouterr().err
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            app.main(["--model-path", str(SMALL), "--continuous-batch", "--tp", "2"])
        assert "--tp 2 needs 2 CUDA devices, found 0" in capsys.readouterr().err
