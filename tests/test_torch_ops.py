"""The port's ops against the JAX package's, on the same numpy inputs (CPU, fp32).

Tolerances: exact for integer transforms, masks and draws; 1e-6 for
elementwise ops and attention on unit-scale inputs; 1e-5 for contractions
whose outputs reach ~10 (fp32 sums taken in another order); 2e-5 for RoPE,
whose trig arguments reach 3000 rad (an ulp of the frequency moves them).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import config as jcfg
from dia_tts_prune_tpu import tokenizer as jtok
from dia_tts_prune_tpu.ops import delay as jdelay
from dia_tts_prune_tpu.ops import masks as jmasks
from dia_tts_prune_tpu.ops import modules as jmod
from dia_tts_prune_tpu.ops import sampling as jsamp
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import tokenizer as ttok
from dia_tts_prune_tpu_torch.ops import delay as tdelay
from dia_tts_prune_tpu_torch.ops import masks as tmasks
from dia_tts_prune_tpu_torch.ops import modules as tmod
from dia_tts_prune_tpu_torch.ops import sampling as tsamp
from dia_tts_prune_tpu_torch.ops.kernels import dense_rows_plain

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

ATOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=atol)


@pytest.fixture
def rng():
    return np.random.default_rng(20)


def test_config_and_tokenizer_copies_agree():
    for name in ("dia_1_6b_config", "tiny_test_config"):
        assert (getattr(tcfg, name)().model_dump_json()
                == getattr(jcfg, name)().model_dump_json())
    text = "[S1] Hello there. [S2] Hi! ünïcode"
    assert ttok.build_effective_text(text, "[S2] prompt") == jtok.build_effective_text(
        text, "[S2] prompt")
    np.testing.assert_array_equal(ttok.encode_cfg_batch(text, 64), jtok.encode_cfg_batch(text, 64))


def test_rms_norm(rng):
    x, s = rng.normal(size=(2, 5, 64)).astype(np.float32), rng.normal(size=64).astype(np.float32)
    _close(tmod.rms_norm(_t(x), _t(s), 1e-5), jmod.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("D", [20, 33, 1000])
def test_rms_norm_any_width_equals_jax(rng, D):
    """Any width is normed, one not a multiple of 16 among them (the plain
    fp32 mean of squares, as the JAX ``rms_norm`` takes it)."""
    x, s = rng.normal(size=(3, 2, D)).astype(np.float32), rng.normal(size=D).astype(np.float32)
    _close(tmod.rms_norm(_t(x), _t(s), 1e-5), jmod.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-5))


@pytest.mark.parametrize("H", [32, 64, 128])
def test_rope(rng, H):
    x = rng.normal(size=(2, 7, 3, H)).astype(np.float32)
    pos = rng.integers(0, 3000, size=(2, 7))
    out = tmod.rope(_t(x), _t(pos), 1, 10_000)
    ref = jmod.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1, 10_000)
    _close(out, ref, atol=2e-5)  # |x| ~ 4 times trig of arguments up to 3000 rad


def test_dense_general_and_mlp(rng):
    x = rng.normal(size=(2, 3, 4, 16)).astype(np.float32)
    w = rng.normal(size=(4, 16, 32)).astype(np.float32)
    _close(tmod.dense_general(_t(x), _t(w), axis=(-2, -1)),
           jmod.dense_general(jnp.asarray(x), jnp.asarray(w), axis=(-2, -1)), atol=1e-5)
    p = {"wi_fused": {"kernel": rng.normal(size=(32, 2, 48)).astype(np.float32) / 6},
         "wo": {"kernel": rng.normal(size=(48, 32)).astype(np.float32) / 7}}
    h = rng.normal(size=(2, 5, 32)).astype(np.float32)
    tp = jax.tree.map(_t, p)
    _close(tmod.mlp_block(tp, _t(h)), jmod.mlp_block(jax.tree.map(jnp.asarray, p), jnp.asarray(h)),
           atol=1e-5)


@pytest.mark.parametrize("rows", [1, 2, 7, 64, 80])
def test_dense_rows_plain_equals_jax_dense(rng, rows):
    """The decode step's route for float contractions (``dense_general(...,
    decode=True)``: ``dense_rows``, on the CPU its plain version) against the
    JAX contraction, at any row count."""
    x = rng.normal(size=(rows, 48)).astype(np.float32)
    w = rng.normal(size=(48, 3, 20)).astype(np.float32)
    out = dense_rows_plain(_t(x), _t(w).reshape(48, -1))
    assert out.shape == (rows, 60)
    ref = jmod.dense_general(jnp.asarray(x), jnp.asarray(w))
    _close(out.reshape(rows, 3, 20), ref, atol=1e-5)
    _close(tmod.dense_general(_t(x), _t(w), decode=True), ref, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa(rng, causal):
    B, T, Nq, Nkv, H = 2, 12, 4, 2, 16
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, T, Nq, H), (B, T, Nkv, H), (B, T, Nkv, H)))
    pad = np.ones((B, T), bool)
    pad[1, 8:] = False
    mask = np.asarray(jmasks.create_attn_mask(jnp.asarray(pad), jnp.asarray(pad), causal))
    np.testing.assert_array_equal(tmasks.create_attn_mask(_t(pad), _t(pad), causal).numpy(), mask)
    out = tmod.sdpa(_t(q), _t(k), _t(v), _t(mask), is_causal=causal)
    ref = jmod.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
                    is_causal=causal)
    _close(out, ref)
    none = np.zeros((B, 1, T, T), bool)  # fully masked: exact zeros in both
    assert torch.all(tmod.sdpa(_t(q), _t(k), _t(v), _t(none)) == 0)


def test_delay_apply_revert_exact(rng):
    codes = rng.integers(0, 1024, size=(2, 40, 9)).astype(np.int32)
    pattern = (0, 8, 9, 10, 11, 12, 13, 14, 15)
    ref = np.asarray(jdelay.apply_audio_delay(jnp.asarray(codes), 1025, 1026, pattern))
    np.testing.assert_array_equal(
        tdelay.apply_audio_delay(_t(codes), 1025, 1026, pattern).numpy(), ref)
    np.testing.assert_array_equal(tdelay.apply_audio_delay_np(codes, 1025, 1026, pattern), ref)
    for T in (None, 30):
        rref = np.asarray(jdelay.revert_audio_delay(jnp.asarray(codes), 1025, pattern, T))
        np.testing.assert_array_equal(
            tdelay.revert_audio_delay(_t(codes), 1025, pattern, T).numpy(), rref)
        np.testing.assert_array_equal(tdelay.revert_audio_delay_np(codes, 1025, pattern, T), rref)


def test_cfg_and_constraints(rng):
    logits = rng.normal(size=(2, 9, 1028)).astype(np.float32)
    out = tsamp.apply_constraints(tsamp.cfg_combine(_t(logits), 3.0), 1024, 1025, 1026)
    ref = jsamp.apply_constraints(jsamp.cfg_combine(jnp.asarray(logits), 3.0), 1024, 1025, 1026)
    ref = np.asarray(ref)
    np.testing.assert_array_equal(out.numpy() == tsamp.NEG, ref == np.float32(jsamp.NEG))
    _close(out, ref)


def test_top_k_top_p_filters(rng):
    logits = (rng.normal(size=(9, 1028)) * 3).astype(np.float32)
    vals, idx = tsamp.filtered_topk(_t(logits), 1.0, 1.0, 35)  # top-k only
    ref_k = np.asarray(jsamp.top_k_filter(jnp.asarray(logits), 35))
    kept = np.zeros_like(ref_k, bool)
    np.put_along_axis(kept, idx.numpy(), True, axis=-1)
    np.testing.assert_array_equal(kept, ref_k != np.float32(jsamp.NEG))
    _close(vals, np.sort(ref_k, axis=-1)[:, ::-1][:, :35])
    out_p = tsamp.top_p_filter(_t(logits), 0.8).numpy()
    ref_p = np.asarray(jsamp.top_p_filter(jnp.asarray(logits), 0.8))
    np.testing.assert_array_equal(out_p == tsamp.NEG, ref_p == np.float32(jsamp.NEG))


def test_sampling_from_shared_noise(rng):
    """Same uniform noise → same draw as the JAX sampler's rule (top-k, then
    nucleus over the sorted survivors, then Gumbel-max)."""
    logits = (rng.normal(size=(9, 1028)) * 3).astype(np.float32)
    u = rng.uniform(size=(9, 35)).astype(np.float32)
    out = tsamp.sample_next_token(_t(logits), 1.3, 0.95, 35, uniform=_t(u)).numpy()
    vals, idx = jax.lax.top_k(jnp.asarray(logits) / 1.3, 35)
    cum = jnp.cumsum(jax.nn.softmax(vals, axis=-1), axis=-1)
    remove = jnp.roll(cum > 0.95, 1, axis=-1).at[..., 0].set(False)
    vals = jnp.where(remove, jsamp.NEG, vals)
    gumbel = -jnp.log(-jnp.log(jnp.clip(jnp.asarray(u), jnp.finfo(jnp.float32).tiny, 1.0)))
    choice = np.asarray(jnp.argmax(vals + gumbel, -1))
    ref = np.take_along_axis(np.asarray(idx), choice[:, None], -1)[:, 0]
    np.testing.assert_array_equal(out, ref)
    assert np.array_equal(tsamp.sample_next_token(_t(logits), 0.0, 0.95, 35).numpy(),
                          np.argmax(logits, -1))
