"""Training under a mesh (``train.py::Trainer(mesh=)``, ``finetune
--mesh-data/--mesh-model/--fsdp``) of the port against the JAX package's
sharded Trainer and the unsharded port, on the CPU.

The JAX side runs its ``Trainer(mesh=)`` on host devices of this process
(tests/conftest.py gives JAX 8), on the same mesh shapes; the port's ranks
are gloo processes (tests/torch_tp_worker.py ``train``), each run with its
own rendezvous file, a process-group timeout and a subprocess timeout, as in
tests/test_torch_sharding.py.  Weights: JAX's ``init_params`` at
``_tp_config`` through ``checkpoint.params_from_jax``; the global batch of 4
is tests/test_sharding.py's.

* One fp32 step on (1, 2), (2, 1), (2, 2), (2, 1) + FSDP, (2, 2) + FSDP and
  the hybrid (replica 2, data 1, model 2) mesh equals JAX's step on the same
  mesh at tests/test_sharding.py's tolerances (loss rtol 1e-5, grad_norm
  rtol 1e-4, the updated ``wi_fused`` rtol 2e-3 / atol 1e-5: the ranks'
  partial sums add in another order, and AdamW's division by sqrt(nu) turns
  that into a few 1e-5 where a gradient is small); every rank's gradients of
  the replicated leaves are equal, and equal the unsharded port's (rtol
  1e-5, atol 1e-6); FSDP moments are shard-sized.
* Two FSDP steps; LoRA on (1, 2) and (2, 2) (column- and row-parallel
  targets) after two steps; QAT-int8 on (1, 2) with row-parallel kernels
  whose column maxima lie on the other rank; gradient accumulation on
  (2, 1): each against the unsharded port at the same tolerances.
* Every layer rematerialized on (1, 2); a (1, 1) mesh equal to one process
  bit for bit.
* A checkpoint written under a mesh resumes in one process, and one written
  by one process resumes under a mesh: the next step equals.
* ``finetune --mesh-model 2 --device cpu`` writes the ``pytorch_model.bin``
  of the unsharded CLI (``test_finetune_cli_mesh_model_2_equals_unsharded``
  states its tolerance).
"""

import contextlib
import math
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.parallel import sharding as jsh
from dia_tts_prune_tpu.train import TrainConfig as JaxTrainConfig
from dia_tts_prune_tpu.train import Trainer as JaxTrainer
from dia_tts_prune_tpu.train import build_train_batch as jax_build_train_batch
from dia_tts_prune_tpu_torch.api import write_wav
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.models.dia import init_params, param_shapes
from dia_tts_prune_tpu_torch.ops.modules import model_copy, model_psum
from dia_tts_prune_tpu_torch.train import Trainer, storage_specs
from tests.test_sharding import _fsdp_setup
from tests.test_torch_sharding import RANK_TIMEOUT, SMALL, _env, _finish, _start
from tests.torch_tp_worker import TRAIN_CASES, tp_config, train_config

torch.set_num_threads(1)

WI = ("decoder", "layers", "mlp", "wi_fused", "kernel")
STEP_CASES = ("full_12", "full_21", "full_22", "fsdp_21", "fsdp_22", "hybrid_212")
TWO_RANKS = ("full_12", "full_21", "fsdp_21", "lora_12", "qat_12", "accum_21", "resume_12",
             "remat_12")
FOUR_RANKS = ("full_22", "fsdp_22", "hybrid_212", "lora_22")
UPDATE_TOL = {"rtol": 2e-3, "atol": 1e-5}  # tests/test_sharding.py's for updated params
CLI_ARGS = ["--device", "cpu", "--compute-dtype", "float32", "--epochs", "1", "--batch-size",
            "2", "--logging-steps", "1", "--save-steps", "0", "--learning-rate", "1e-3"]


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _second_batch(jcfg):
    rng = np.random.default_rng(1)
    text = rng.integers(1, 200, (4, jcfg.data.text_length)).astype(np.int32)
    text[:, 30:] = 0
    codes = [rng.integers(0, 1024, (50 + 10 * i, 9)).astype(np.int32) for i in range(4)]
    return jax_build_train_batch(jcfg, text, codes)


def _jax_mesh(shape):
    devs = np.asarray(jax.devices()[:math.prod(shape)])
    if len(shape) == 3:
        return jsh.make_mesh(replica=shape[0], data=shape[1], model=shape[2], devices=devs)
    return jsh.make_mesh(data=shape[0], model=shape[1], devices=devs)


def _jax_run(jcfg, jparams, batches, shape=None, fsdp=False, steps=1, **fields):
    """JAX's Trainer (on a mesh of ``shape``, or one device): each step's
    metrics, and ``wi_fused`` after the first step."""
    tc = JaxTrainConfig(learning_rate=3e-3, remat=False, max_grad_norm=1.0, **fields)
    mesh = None if shape is None else _jax_mesh(shape)
    if mesh is not None:
        jparams = jsh.shard_params(jparams, mesh, config=jcfg, fsdp=fsdp)
    with mesh if mesh is not None else contextlib.nullcontext():
        tr = JaxTrainer(jparams, jcfg, tc, 10, mesh=mesh)
        metrics, wi = [], None
        for i in range(steps):
            metrics.append(tr.step(batches[i % len(batches)]))
            if i == 0:
                wi = np.asarray(_at(tr.params, WI))
    return {"metrics": metrics, "wi": wi}


def _dataset(root: Path) -> Path:
    (root / "wavs").mkdir(parents=True)
    lines = []
    for i, (text, n) in enumerate([("[S1] Hello there.", 9000), ("[S2] Hi.", 5000),
                                   ("[S1] One more line.", 12345), ("[S2] And a fourth.", 7000)]):
        rng = np.random.default_rng(30 + i)
        t = np.arange(n) / 44100.0
        wav = 0.4 * np.sin(2 * np.pi * 220 * t) + 0.1 * rng.normal(size=n)
        write_wav(root / "wavs" / f"a{i}.wav", wav.astype(np.float32))
        lines.append(f"a{i}.wav|{text}")
    (root / "metadata.csv").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The sharded runs, started at once, and every reference computed here
    while they run."""
    out = tmp_path_factory.mktemp("sharded_train")
    jcfg, jparams, batch0 = _fsdp_setup()
    batches = [batch0, _second_batch(jcfg)]
    weights = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    torch.save(weights, out / "weights.pt")
    paths = []
    for i, b in enumerate(batches):
        paths.append(str(out / f"batch{i}.npz"))
        np.savez(paths[-1], **b)
    # one process's checkpoint after a step, which the (1, 2) ranks resume
    resumed = Trainer(weights, tp_config(), train_config({}), 10)
    resumed.step(batches[0])
    resumed.save(out / "one_process")
    args = {"weights": str(out / "weights.pt"), "batches": paths, "save": "fsdp_21",
            "save_to": str(out / "from_mesh"), "resume_from": str(out / "one_process")}
    procs = {"two": _start("train", 2, out / "two", {**args, "cases": list(TWO_RANKS)}),
             "four": _start("train", 4, out / "four", {**args, "cases": list(FOUR_RANKS)}),
             "one": _start("train", 1, out / "one", {**args, "cases": ["one_11"]})}
    data = _dataset(out / "dataset")
    common = ["--model-path", str(SMALL), "--dataset-dir", str(data), *CLI_ARGS]
    cli = subprocess.Popen([sys.executable, "-m", "dia_tts_prune_tpu_torch.finetune", *common,
                            "--output-dir", str(out / "cli_mesh"), "--mesh-model", "2"],
                           env=_env(), cwd=out, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)

    ref = {"jax": {"single": _jax_run(jcfg, jparams, batches, steps=2),
                   "qat": _jax_run(jcfg, jparams, batches, qat_mode="int8")}}
    for name in STEP_CASES:
        shape, fsdp, _, steps = TRAIN_CASES[name]
        ref["jax"][name] = _jax_run(jcfg, jparams, batches, shape, fsdp, steps)
    ref["port"] = {}
    for name, (_, _, fields, steps) in TRAIN_CASES.items():
        tr = resumed if name == "resume_12" else Trainer(weights, tp_config(),
                                                         train_config(fields), 10)
        loss, grads = tr.gradients(batches[0])
        rec = {"grad_loss": loss, "grads": grads,
               "metrics": [tr.step(batches[i % 2]) for i in range(steps)]}
        rec["adapter"], rec["trained"] = tr.adapter(), tr.trained_params()
        ref["port"][name] = rec
    from dia_tts_prune_tpu_torch.finetune import main as finetune

    assert finetune([*common, "--output-dir", str(out / "cli_one")]) == 0
    ref["cli_one"] = torch.load(out / "cli_one" / "pytorch_model.bin")
    try:
        log = cli.communicate(timeout=RANK_TIMEOUT)[0]
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.communicate()
    assert cli.returncode == 0, log[-3000:]
    ref["cli_mesh"] = torch.load(out / "cli_mesh" / "pytorch_model.bin")
    got = {}
    for world in ("two", "four", "one"):
        for r, rank in enumerate(_finish(procs[world], out / world, "train")):
            for name, rec in rank.items():
                got.setdefault(name, []).append(rec)
    return got, ref, out


# ---------------------------------------------------------------------------
# One step on each mesh against JAX's sharded step and the unsharded port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", STEP_CASES)
def test_sharded_step_equals_jax(runs, name):
    got, ref, _ = runs
    want = ref["jax"][name]
    for rank in got[name]:
        m = rank["metrics"][0]
        for jax_ref in (want, ref["jax"]["single"]):
            np.testing.assert_allclose(m["loss"], jax_ref["metrics"][0]["loss"], rtol=1e-5)
            np.testing.assert_allclose(m["grad_norm"], jax_ref["metrics"][0]["grad_norm"],
                                       rtol=1e-4)
        np.testing.assert_allclose(_at(rank["first_step"], WI).detach().numpy(), want["wi"],
                                   **UPDATE_TOL)


@pytest.mark.parametrize("name", STEP_CASES + ("lora_12", "lora_22", "qat_12", "accum_21",
                                               "remat_12"))
def test_replicated_gradients_equal_unsharded(runs, name):
    """Every rank's gradient of every replicated leaf (reduced as the step
    reduces it) is the same on every rank and equals one process's."""
    got, ref, _ = runs
    first = got[name][0]["replicated_grads"]
    assert first
    for rank in got[name]:
        assert rank["replicated_grads"].keys() == first.keys()
        for n, g in rank["replicated_grads"].items():
            assert torch.equal(g, first[n]), n
            torch.testing.assert_close(g, ref["port"][name]["grads"][n], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rank["grad_loss"], ref["port"][name]["grad_loss"], rtol=1e-5)


@pytest.mark.parametrize("name", ("fsdp_21", "fsdp_22"))
def test_fsdp_moments_are_shard_sized(runs, name):
    """AdamW's moments have their leaf's local shape, and ``wi_fused``'s
    local block is split over both axes (ZeRO: the JAX test's memory claim)."""
    got, _, _ = runs
    data, model = TRAIN_CASES[name][0]
    whole = param_shapes(tp_config())
    for rank in got[name]:
        assert rank["moment_shapes"] == rank["leaf_shapes"]
        for stack in ("encoder", "decoder"):
            key = f"{stack}.layers.mlp.wi_fused.kernel"
            full = math.prod(_at(whole, (stack, "layers", "mlp", "wi_fused", "kernel")))
            assert math.prod(rank["moment_shapes"][key]) * data * model == full


def test_two_fsdp_steps_equal_jax(runs):
    got, ref, _ = runs
    for rank in got["fsdp_21"]:
        for i in range(2):
            np.testing.assert_allclose(rank["metrics"][i]["loss"],
                                       ref["jax"]["fsdp_21"]["metrics"][i]["loss"], rtol=1e-5)
            np.testing.assert_allclose(rank["metrics"][i]["loss"],
                                       ref["port"]["fsdp_21"]["metrics"][i]["loss"], rtol=1e-5)


# ---------------------------------------------------------------------------
# LoRA, QAT, accumulation, checkpoints against the unsharded port
# ---------------------------------------------------------------------------


def _same_run(rank, want):
    for a, b in zip(rank["metrics"], want["metrics"], strict=True):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-5)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"], rtol=1e-4)
        assert a["step"] == b["step"]


@pytest.mark.parametrize("name", ("lora_12", "lora_22"))
def test_lora_adapter_equals_unsharded(runs, name):
    got, ref, _ = runs
    want = _flat(ref["port"][name]["adapter"]["weights"])
    assert {k.rsplit(".", 2)[-2] for k in want} == {"q_proj", "v_proj", "o_proj", "wi_fused",
                                                    "wo"}
    for rank in got[name]:
        _same_run(rank, ref["port"][name])
        assert rank["adapter"]["config"] == ref["port"][name]["adapter"]["config"]
        adapter = _flat(rank["adapter"]["weights"])
        assert adapter.keys() == want.keys()
        for k, b in want.items():
            assert float(b.abs().max()) > 0 or k.endswith(".a"), k  # B left zero
            torch.testing.assert_close(adapter[k], b, **UPDATE_TOL)


def test_qat_int8_on_a_mesh_equals_unsharded(runs):
    """Row-parallel kernels whose column maxima lie on the other rank (so a
    rank's own maxima would give other scales): the mesh-wide maximum gives
    the unsharded QAT step, and JAX's."""
    got, ref, _ = runs
    assert any(rank["column_max_differs"] for rank in got["qat_12"])
    for rank in got["qat_12"]:
        _same_run(rank, ref["port"]["qat_12"])
        np.testing.assert_allclose(rank["metrics"][0]["loss"],
                                   ref["jax"]["qat"]["metrics"][0]["loss"], rtol=1e-5)
        torch.testing.assert_close(_at(rank["trained"], WI), _at(ref["port"]["qat_12"]["trained"],
                                                                  WI), **UPDATE_TOL)


@pytest.mark.parametrize("name", ("accum_21", "full_12", "full_22", "hybrid_212", "remat_12"))
def test_trained_tree_equals_unsharded(runs, name):
    """The whole trained tree (``trained_params``, gathered) after the
    steps: gradient accumulation over two micro-batches on (2, 1), the
    one-step meshes, and (1, 2) with every layer rematerialized (the
    recomputed forward's all-reduces issued again inside the backward)."""
    got, ref, _ = runs
    want = _flat(ref["port"][name]["trained"])
    for rank in got[name]:
        _same_run(rank, ref["port"][name])
        trained = _flat(rank["trained"])
        assert trained.keys() == want.keys()
        for k, w in want.items():
            torch.testing.assert_close(trained[k], w, **UPDATE_TOL)


def test_checkpoint_from_a_mesh_resumes_in_one_process(runs):
    """(2, 1) + FSDP writes its checkpoint after step 1; one process restores
    it and takes step 2 as the ranks did."""
    got, ref, out = runs
    tr = Trainer(torch.load(out / "weights.pt"), tp_config(), train_config({}), 10)
    assert tr.restore(out / "from_mesh") == 1
    batch1 = dict(np.load(out / "batch1.npz"))
    m = tr.step(batch1)
    for rank in got["fsdp_21"]:
        np.testing.assert_allclose(m["loss"], rank["metrics"][1]["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], rank["metrics"][1]["grad_norm"], rtol=1e-4)
        torch.testing.assert_close(_at(tr.params, WI), _at(rank["trained"], WI), **UPDATE_TOL)


def test_checkpoint_from_one_process_resumes_on_a_mesh(runs):
    got, ref, _ = runs
    for rank in got["resume_12"]:
        _same_run(rank, ref["port"]["resume_12"])
        torch.testing.assert_close(_at(rank["trained"], WI),
                                   _at(ref["port"]["resume_12"]["trained"], WI), **UPDATE_TOL)


def test_one_rank_mesh_is_one_process_bit_for_bit(runs):
    """On a (1, 1) mesh every collective is a one-rank identity and the
    step's arithmetic is one process's: a LoRA step equal bit for bit."""
    got, ref, _ = runs
    (rank,) = got["one_11"]
    want = ref["port"]["one_11"]
    assert rank["metrics"] == want["metrics"] and rank["grad_loss"] == want["grad_loss"]
    adapter, theirs = _flat(rank["adapter"]["weights"]), _flat(want["adapter"]["weights"])
    assert adapter.keys() == theirs.keys()
    assert all(torch.equal(adapter[k], t) for k, t in theirs.items())


def test_finetune_cli_mesh_model_2_equals_unsharded(runs):
    """Two AdamW steps at lr 1e-3 through the CLI: every element within
    UPDATE_TOL but at most one in 10^4 of a tensor, and those within the
    most two updates can part (2 x lr a step): where a gradient is as small
    as the ranks' summation-order noise, AdamW's division by sqrt(nu) makes
    the step follow the noise."""
    _, ref, _ = runs
    lr, steps = 1e-3, 2
    assert ref["cli_mesh"].keys() == ref["cli_one"].keys()
    for k, w in ref["cli_one"].items():
        got = ref["cli_mesh"][k]
        off = (got - w).abs() > UPDATE_TOL["atol"] + UPDATE_TOL["rtol"] * w.abs()
        assert int(off.sum()) <= w.numel() // 10_000, (k, int(off.sum()))
        torch.testing.assert_close(got, w, rtol=0, atol=2 * lr * steps)


# ---------------------------------------------------------------------------
# Pieces, in one process
# ---------------------------------------------------------------------------


def test_model_operators_without_a_group_add_no_autograd_node():
    x = torch.randn(3, 4, requires_grad=True)
    assert model_copy(x, None) is x and model_psum(x, None) is x
    y = x * 2
    assert model_copy(y, None) is y and model_psum(y, None) is y


def test_param_shapes_are_init_params_shapes():
    cfg = tp_config()
    shapes = _flat(param_shapes(cfg))
    params = _flat(init_params(cfg, seed=0, device="cpu"))
    assert list(shapes) == list(params)
    assert all(tuple(params[k].shape) == s for k, s in shapes.items())


def test_storage_specs_tell_the_layouts_apart():
    """Local shapes under the tensor-parallel and the FSDP plans (the
    ``shard_params`` trees of a (2, 2) mesh) give their spec trees; the
    whole tree is neither and raises."""
    from dia_tts_prune_tpu_torch.parallel import sharding as tsh

    cfg = tp_config()
    mesh = {"data": 2, "model": 2}
    whole = _meta(param_shapes(cfg))
    for specs in (tsh.param_specs(cfg), tsh.fsdp_param_specs(cfg, whole, mesh)):
        local = tsh.map_specs(lambda spec, x, path: torch.empty(
            tsh.local_shape(x.shape, spec, mesh), device="meta"), specs, whole)
        assert storage_specs(cfg, local, mesh) == specs
    with pytest.raises(ValueError, match="not this rank's local shards"):
        storage_specs(cfg, whole, mesh)


def _meta(shapes):
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v, device="meta")
            for k, v in shapes.items()}
