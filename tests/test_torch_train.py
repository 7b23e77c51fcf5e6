"""The port's training slice against the JAX package (CPU, fp32,
``tiny_test_config``; inputs from numpy seeds, params carried across by
``params_from_jax``).

* The plain versions of the training flash kernels
  (``flash_attention_lse_plain``, ``flash_attention_bwd_plain``) against the
  Pallas kernels in interpret mode (``flash_attention_trainable(...,
  interpret=True)`` and ``jax.grad`` of it) at the shapes of
  tests/test_kernels.py: out/lse atol 2e-5, gradients rtol 1e-3 atol 1e-4 —
  the JAX tests' own limits.
* ``decoder_forward`` logits atol 1e-4; ``build_train_batch`` exact;
  ``compute_loss`` value rtol 1e-5 and every gradient leaf rtol 2e-3 atol 1e-5
  against ``jax.value_and_grad`` on the XLA path and on the Pallas path
  (``DIA_FLASH_INTERPRET=1``).
* Schedules equal optax's at every step: rtol 1e-6 plus 1e-7 of the base rate
  (optax computes them in float32, the port in Python floats; near the end of
  a cosine decay 1 + cos cancels, so the float32 value is off by ~1e-8 of the
  base rate).
* ``Trainer.step`` against the optax-driven JAX trainer: see ``STEP_TOL``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import train as jtrain
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.lora import LoraConfig as JaxLoraConfig
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu.ops.kernels import flash_attention as jflash
from dia_tts_prune_tpu.state import cross_attention_mask as jax_cross_mask
from dia_tts_prune_tpu.state import new_encoder_state as jax_encoder_state
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import train as ttrain
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax, params_to_numpy
from dia_tts_prune_tpu_torch.lora import LoraConfig
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops.kernels import (
    flash_attention_bwd_kv,
    flash_attention_bwd_plain,
    flash_attention_bwd_q,
    flash_attention_lse,
    flash_attention_lse_plain,
    flash_attention_trainable,
)
from dia_tts_prune_tpu_torch.ops.modules import full_attention

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

NAN_TOKEN = 250  # a text byte no ordinary batch uses; its embedding row is NaN


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# flash attention: plain versions vs the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

# (seed, T, block, pad spec): the shapes of tests/test_kernels.py:472-571,
# plus a fully masked query row
FLASH_CASES = {
    "blocks": (10, 256, 128, lambda seg: seg.__setitem__((0, slice(200, None)), 0)),
    "ragged": (11, 320, 256, lambda seg: seg.__setitem__((1, slice(250, None)), 0)),
}


def _flash_inputs(case, masked_row=False):
    seed, T, block, pad = FLASH_CASES[case]
    rng = np.random.default_rng(seed)
    B, Nkv, G, H = 2, 2, 2, 128
    q, k, v = (rng.normal(size=(B, T, n, H)).astype(np.float32) * 0.3
               for n in (Nkv * G, Nkv, Nkv))
    kv_seg = np.ones((B, T), np.int32)
    pad(kv_seg)
    q_seg = kv_seg.copy()
    if masked_row:
        q_seg[0, 17] = 7  # matches no key
    cot = rng.normal(size=(B, T, Nkv * G, H)).astype(np.float32)
    return q, k, v, q_seg, kv_seg, cot, block


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case,masked_row", [("blocks", False), ("ragged", False),
                                             ("ragged", True)])
def test_flash_plain_versions_match_pallas(case, masked_row, causal):
    q, k, v, q_seg, kv_seg, cot, block = _flash_inputs(case, masked_row)
    jq, jk, jv, jqs, jks, jcot = (jnp.asarray(a) for a in (q, k, v, q_seg, kv_seg, cot))
    T = q.shape[1]

    j_out, res = jflash._flash_fwd(jq, jk, jv, jqs, jks, causal, block, block, True)
    j_lse = np.asarray(res[6])[:, :, :T]
    tq, tk, tv, tcot = (_t(a) for a in (q, k, v, cot))
    tqs, tks = _t(q_seg), _t(kv_seg)
    out, lse = flash_attention_lse_plain(tq, tk, tv, tqs, tks, causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(j_out), rtol=0, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), j_lse, rtol=0, atol=2e-5)
    # the CPU route of the wrapper is the plain version
    w_out, w_lse = flash_attention_lse(tq, tk, tv, tqs, tks, causal)
    assert torch.equal(w_out, out) and torch.equal(w_lse, lse)

    j_grads = jax.grad(lambda q, k, v: jnp.sum(jflash.flash_attention_trainable(
        q, k, v, jqs, jks, causal, block, block, True) * jcot), argnums=(0, 1, 2))(jq, jk, jv)
    grads = flash_attention_bwd_plain(tq, tk, tv, tqs, tks, out, lse, tcot, causal)
    for name, got, ref in zip(("dq", "dk", "dv"), grads, j_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-3, atol=1e-4,
                                   err_msg=f"{name} {case} causal={causal}")
    if masked_row:
        assert torch.all(out[0, 17] == 0) and torch.all(grads[0][0, 17] == 0)
        np.testing.assert_allclose(lse[0, :, 17].numpy(), np.log(np.float32(1e-30)), rtol=1e-6)

    # autograd through the trainable entry (plain version on the CPU) gives the same
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    auto = torch.autograd.grad(
        (flash_attention_trainable(*leaves, tqs, tks, causal) * tcot).sum(), leaves)
    for got, ref in zip(auto, grads):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=1e-5)


def test_full_attention_routes_by_autograd_state(monkeypatch):
    """The trainable entry iff q, k or v needs a gradient — by autograd
    state, not by a flag."""
    from dia_tts_prune_tpu_torch.ops import modules

    called = []
    monkeypatch.setattr(modules, "flash_attention_trainable",
                        lambda *a: called.append("trainable") or a[0])
    monkeypatch.setattr(modules, "flash_attention", lambda *a: called.append("forward") or a[0])
    q, k, v = (torch.zeros(1, 4, 2, 32) for _ in range(3))
    seg = torch.ones(1, 4, dtype=torch.int32)
    full_attention(q, k, v, False, seg, seg)
    full_attention(q, k.clone().requires_grad_(True), v, False, seg, seg)
    with torch.no_grad():
        full_attention(q.clone().requires_grad_(True), k, v, True, seg, seg)
    assert called == ["forward", "trainable", "forward"]


def test_backward_wrappers_take_the_plain_version_on_the_cpu():
    q, k, v, q_seg, kv_seg, cot, _ = _flash_inputs("ragged")
    tq, tk, tv, tcot, tqs, tks = (_t(a)[:, :40] for a in (q, k, v, cot, q_seg, kv_seg))
    out, lse = flash_attention_lse(tq, tk, tv, tqs, tks, True)
    dq, dk, dv = flash_attention_bwd_plain(tq, tk, tv, tqs, tks, out, lse, tcot, True)
    got_kv = flash_attention_bwd_kv(tq, tk, tv, tqs, tks, out, lse, tcot, True)
    assert torch.equal(got_kv[0], dk) and torch.equal(got_kv[1], dv)
    assert torch.equal(flash_attention_bwd_q(tq, tk, tv, tqs, tks, out, lse, tcot, True), dq)


# ---------------------------------------------------------------------------
# model, batch, loss
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    jcfg = tiny_test_config()
    jparams = jdia.init_params(jcfg, jax.random.PRNGKey(0))
    # the row of NAN_TOKEN is NaN in both packages: a batch that holds the
    # token has a NaN loss, every other batch never reads the row
    emb = np.array(jparams["encoder"]["embedding"]["embedding"])
    emb[NAN_TOKEN] = np.nan
    jparams["encoder"]["embedding"]["embedding"] = jnp.asarray(emb)
    cfg = tcfg.tiny_test_config()
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(2):
        text = rng.integers(1, 200, (2, cfg.data.text_length)).astype(np.int32)
        text[:, 60:] = 0
        text[1, 41:] = 0
        codes = [rng.integers(0, 1024, (n, 9)).astype(np.int32) for n in (80, 57)]
        batches.append((text, codes))
    return jcfg, jparams, cfg, batches


def _tparams(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("loss_mode", ["delayed", "reference"])
def test_build_train_batch_equals_jax(setup, loss_mode):
    jcfg, _, cfg, batches = setup
    for text, codes in batches:
        jb = jtrain.build_train_batch(jcfg, text, codes, loss_mode)
        tb = ttrain.build_train_batch(cfg, text, codes, loss_mode)
        assert sorted(jb) == sorted(tb)
        for key in jb:
            assert tb[key].dtype == jb[key].dtype
            np.testing.assert_array_equal(tb[key], jb[key])
    # longer than audio_length: truncated alike
    long = [np.random.default_rng(3).integers(0, 1024, (300, 9)).astype(np.int32)]
    np.testing.assert_array_equal(
        ttrain.build_train_batch(cfg, batches[0][0][:1], long, loss_mode)["target_ids"],
        jtrain.build_train_batch(jcfg, batches[0][0][:1], long, loss_mode)["target_ids"])


@pytest.mark.parametrize("flash", [False, True])
def test_decoder_forward_matches_jax(setup, monkeypatch, flash):
    if flash:
        monkeypatch.setenv("DIA_FLASH_INTERPRET", "1")
    jcfg, jp, cfg, batches = setup
    text, codes = batches[0]
    batch = ttrain.build_train_batch(cfg, text, codes)
    B, T = batch["decoder_input_ids"].shape[:2]
    js = jax_encoder_state(jcfg, jnp.asarray(text))
    j_enc = jdia.encoder_forward(jp, jcfg, jnp.asarray(text), js.positions, js.attn_mask)
    dec_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None], (B, T))
    j_logits, j_kv = jdia.decoder_forward(
        jp, jcfg, jnp.asarray(batch["decoder_input_ids"]), j_enc, js.positions,
        jnp.asarray(dec_pos), None, jax_cross_mask(js.padding_mask), return_kv=True,
        enc_padding_mask=js.padding_mask)

    tp = _tparams(jp)
    t_text = torch.from_numpy(text)
    t_pos = torch.arange(text.shape[1])[None].expand(B, -1)
    with torch.no_grad():
        t_enc = tdia.encoder_forward(tp, cfg, t_text, t_pos)
        t_logits, t_kv = tdia.decoder_forward(
            tp, cfg, torch.from_numpy(batch["decoder_input_ids"]), t_enc, t_pos,
            torch.from_numpy(np.array(dec_pos)), t_text != cfg.data.text_pad_value,
            return_kv=True)
    assert t_logits.dtype == torch.float32
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_kv.k.numpy(), np.asarray(j_kv.k), rtol=0, atol=1e-4)
    np.testing.assert_allclose(t_kv.v.numpy(), np.asarray(j_kv.v), rtol=0, atol=1e-4)


@pytest.mark.parametrize("flash", [False, True])
def test_compute_loss_and_gradients_match_jax(setup, monkeypatch, flash):
    if flash:
        monkeypatch.setenv("DIA_FLASH_INTERPRET", "1")
    jcfg, jp, cfg, batches = setup
    batch = ttrain.build_train_batch(cfg, *batches[0])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    j_loss, j_grads = jax.value_and_grad(lambda p: jtrain.compute_loss(p, jcfg, jb))(jp)

    tp = _tparams(jp)
    leaves = ttrain._flatten(tp)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    loss = ttrain.compute_loss(tp, cfg, _tbatch(batch))
    grads = torch.autograd.grad(loss, list(leaves.values()))
    np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-5)
    j_flat = ttrain._flatten(jax.tree.map(np.asarray, j_grads))
    assert list(j_flat) == list(leaves)
    for (name, _), got in zip(leaves.items(), grads):
        np.testing.assert_allclose(got.numpy(), j_flat[name], rtol=2e-3, atol=1e-5,
                                   err_msg=name)


def test_loss_masks_pad_and_remat_changes_nothing(setup):
    _, jp, cfg, batches = setup
    tp = _tparams(jp)
    batch = ttrain.build_train_batch(cfg, *batches[0])
    empty = dict(batch, target_ids=np.full_like(batch["target_ids"], cfg.data.audio_pad_value))
    with torch.no_grad():
        assert float(ttrain.compute_loss(tp, cfg, _tbatch(empty))) == 0.0

    leaves = ttrain._flatten(tp)
    for leaf in leaves.values():
        leaf.requires_grad_(True)
    outs = []
    for remat in (False, True):
        loss = ttrain.compute_loss(tp, cfg, _tbatch(batch), remat=remat)
        outs.append((loss.detach(), torch.autograd.grad(loss, list(leaves.values()))))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)  # the same ops in the same order: bit-identical


# ---------------------------------------------------------------------------
# schedules, optimizer, trainer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["linear", "cosine", "step", "constant"])
@pytest.mark.parametrize("warmup", [0, 3])
def test_schedules_equal_optax_at_every_step(kind, warmup):
    for n in (1, 2, 7, 30):
        kw = dict(learning_rate=3e-4, lr_scheduler_type=kind, warmup_steps=warmup)
        j_sched = jtrain.make_schedule(jtrain.TrainConfig(**kw), n)
        t_sched = ttrain.make_schedule(ttrain.TrainConfig(**kw), n)
        for count in range(n + warmup + 4):
            np.testing.assert_allclose(t_sched(count), float(j_sched(count)), rtol=1e-6,
                                       atol=1e-7 * 3e-4, err_msg=f"{kind} n={n} count={count}")


def test_unknown_scheduler_and_dtype_rejected(setup):
    _, jp, cfg, _ = setup
    with pytest.raises(ValueError, match="nope"):
        ttrain.make_schedule(ttrain.TrainConfig(lr_scheduler_type="nope"), 10)
    with pytest.raises(ValueError, match="float16"):
        ttrain.Trainer(_tparams(jp), cfg, ttrain.TrainConfig(compute_dtype="float16"), 10)
    with pytest.raises(ValueError, match="QAT composes"):
        ttrain.Trainer(_tparams(jp), cfg,
                       ttrain.TrainConfig(qat_mode="int8", adapter_mode="lora"), 10)


@pytest.mark.parametrize("k,wd,max_norm", [(1, 0.0, 1.0), (2, 0.01, 0.5), (3, 0.1, 0.0)])
def test_optimizer_equals_optax_on_given_gradients(k, wd, max_norm):
    """The same gradients through optax's chain and the port's ``Optimizer``:
    clip after averaging, schedule count per applied update, AdamW."""
    import optax

    rng = np.random.default_rng(5)
    shapes = {"a": (4, 5), "b": (7,)}
    kw = dict(gradient_accumulation_steps=k, weight_decay=wd, max_grad_norm=max_norm,
              lr_scheduler_type="linear", warmup_steps=2, learning_rate=1e-2)
    p0 = {n: rng.normal(size=s).astype(np.float32) for n, s in shapes.items()}
    opt = jtrain.make_optimizer(jtrain.TrainConfig(**kw), 10)
    jp = {n: jnp.asarray(v) for n, v in p0.items()}
    state = opt.init(jp)
    leaves = {n: torch.from_numpy(v.copy()) for n, v in p0.items()}
    t_opt = ttrain.Optimizer(ttrain.TrainConfig(**kw), 10, leaves)
    for _ in range(9):
        g = {n: (rng.normal(size=s) * 3).astype(np.float32) for n, s in shapes.items()}
        updates, state = opt.update({n: jnp.asarray(v) for n, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        t_opt.update({n: torch.from_numpy(v) for n, v in g.items()})
        for n in shapes:
            np.testing.assert_allclose(leaves[n].numpy(), np.asarray(jp[n]), rtol=0, atol=2e-6)
    assert t_opt.count == 9 // k


# Three (or five) optimizer steps in both packages from the same weights.  The
# loss and the gradient norm of step i depend on every earlier update, and an
# AdamW update is lr * g / (|g| + 1e-8) at the first step: where a gradient
# element is within fp32 noise of zero, the two packages' elements can differ
# by a good part of lr, in every step.  So: losses rtol 2e-4, gradient norms
# rtol 2e-3, and trained tensors within 2 lr of each other everywhere (seen:
# 1.2 lr on one element in a thousand) and within 0.05 lr on average
# (fake-quant adds weights that round to the neighbouring code on one side
# only: QAT losses rtol 2e-3).
LR = 1e-3
STEP_TOL = {"loss": 2e-4, "qat_loss": 2e-3, "grad_norm": 2e-3, "param_max": 2.0 * LR,
            "param_mean": 0.05 * LR}


def _run_both(setup, order, **kw):
    jcfg, jp, cfg, batches = setup
    lora = kw.pop("lora", False)
    j_kw, t_kw = dict(kw), dict(kw)
    if lora:
        j_kw.update(adapter_mode="lora", lora=JaxLoraConfig(r=4, alpha=8.0))
        t_kw.update(adapter_mode="lora", lora=LoraConfig(r=4, alpha=8.0))
    common = dict(learning_rate=LR, remat=False, lr_scheduler_type="cosine")
    jt = jtrain.Trainer(jp, jcfg, jtrain.TrainConfig(**common, **j_kw), 10)
    tt = ttrain.Trainer(_tparams(jp), cfg, ttrain.TrainConfig(**common, **t_kw), 10)
    if lora:  # the same A/B in both: the draws of jax.random, carried as numpy
        given = ttrain._flatten(params_from_jax(jax.tree.map(np.asarray, jt.adapter_weights),
                                                device="cpu"))
        with torch.no_grad():
            for name, leaf in ttrain._flatten(tt.adapter_weights).items():
                leaf.copy_(given[name])
    made = []
    for text, codes in batches:
        made.append(ttrain.build_train_batch(cfg, text, codes))
    nan_batch = {k: v.copy() for k, v in made[0].items()}
    nan_batch["text_ids"][0, 3] = NAN_TOKEN
    pick = {"a": made[0], "b": made[1], "nan": nan_batch}
    j_log = [jt.step(pick[name]) for name in order]
    t_log = [tt.step(pick[name]) for name in order]
    return jt, tt, j_log, t_log


def _check_logs(order, j_log, t_log, qat=False):
    for name, j, t in zip(order, j_log, t_log):
        assert t["step"] == j["step"]
        if name == "nan":
            assert np.isnan(t["loss"]) and np.isnan(j["loss"])
            continue
        np.testing.assert_allclose(t["loss"], j["loss"],
                                   rtol=STEP_TOL["qat_loss" if qat else "loss"])
        np.testing.assert_allclose(t["grad_norm"], j["grad_norm"], rtol=STEP_TOL["grad_norm"])


def _check_trees(t_tree, j_tree):
    t_flat = ttrain._flatten(params_to_numpy(t_tree))
    j_flat = ttrain._flatten(jax.tree.map(np.asarray, j_tree))
    assert list(t_flat) == list(j_flat)
    for name, got in t_flat.items():
        diff = np.abs(got - j_flat[name])
        assert np.array_equal(np.isnan(got), np.isnan(j_flat[name])), name
        assert np.nanmax(diff) <= STEP_TOL["param_max"], (name, np.nanmax(diff))
        assert np.nanmean(diff) <= STEP_TOL["param_mean"], (name, np.nanmean(diff))


@pytest.mark.parametrize("k,order", [(1, ("a", "nan", "b", "a")),
                                     (2, ("a", "b", "nan", "a", "b"))])
def test_full_trainer_steps_match_jax(setup, k, order):
    jt, tt, j_log, t_log = _run_both(setup, order, gradient_accumulation_steps=k,
                                     weight_decay=0.01)
    _check_logs(order, j_log, t_log)
    _check_trees(tt.trained_params(), jt.trained_params())
    assert tt.optimizer.count == (len(order) - 1) // k
    moved = ttrain._flatten(params_to_numpy(tt.trained_params()))["decoder.norm.scale"]
    assert not np.array_equal(moved, np.ones_like(moved))


@pytest.mark.parametrize("k,order", [(1, ("a", "nan", "b", "a")),
                                     (2, ("a", "b", "nan", "a", "b"))])
def test_lora_trainer_steps_match_jax(setup, k, order):
    jt, tt, j_log, t_log = _run_both(setup, order, lora=True, gradient_accumulation_steps=k)
    _check_logs(order, j_log, t_log)
    _check_trees(tt.adapter()["weights"], jt.adapter()["weights"])
    _check_trees(tt.trained_params(), jt.trained_params())
    b = tt.adapter()["weights"]["decoder"]["layers"]["self_attention"]["q_proj"]["b"]
    assert float(b.abs().max()) > 0  # B has left zero
    # the base weights are untouched
    base = ttrain._flatten(params_to_numpy(tt.base_params))
    ref = ttrain._flatten(jax.tree.map(np.asarray, setup[1]))
    for name in base:
        np.testing.assert_array_equal(base[name], ref[name])


@pytest.mark.parametrize("mode", ["int8", "int4", "int4_hybrid"])
def test_qat_trainer_steps_match_jax(setup, mode):
    order = ("a", "b", "a")
    jt, tt, j_log, t_log = _run_both(setup, order, qat_mode=mode)
    _check_logs(order, j_log, t_log, qat=True)
    _check_trees(tt.trained_params(), jt.trained_params())


@pytest.mark.parametrize("lora", [False, True])
def test_save_restore_then_step_equals_uninterrupted(setup, tmp_path, lora):
    _, jp, cfg, batches = setup
    made = [ttrain.build_train_batch(cfg, *b) for b in batches]
    kw = dict(learning_rate=LR, remat=True, gradient_accumulation_steps=2, weight_decay=0.01)
    if lora:
        kw.update(adapter_mode="lora", lora=LoraConfig(r=4, alpha=8.0))
    tc = ttrain.TrainConfig(**kw)
    t1 = ttrain.Trainer(_tparams(jp), cfg, tc, 10)
    for i in range(3):  # one applied update and one gradient in the accumulator
        t1.step(made[i % 2])
    t1.save(tmp_path, step=t1.global_step)
    assert ttrain.latest_step_dir(tmp_path).name == "step_3"
    want = [t1.step(made[i % 2]) for i in range(2)]

    t2 = ttrain.Trainer(_tparams(jp), cfg, tc, 10)
    assert t2.restore(tmp_path) == 3
    got = [t2.step(made[i % 2]) for i in range(2)]
    assert got == want  # the same state, the same ops: bit-identical
    for a, b in zip(ttrain._flatten(t1.trained_params()).values(),
                    ttrain._flatten(t2.trained_params()).values()):
        assert torch.equal(a, b) or bool(torch.isnan(a).any())
    other = ttrain.Trainer(_tparams(jp), cfg, ttrain.TrainConfig(
        adapter_mode="none" if lora else "lora"), 10)
    with pytest.raises(ValueError, match="adapter mode"):
        other.restore(tmp_path)
