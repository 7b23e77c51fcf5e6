"""The port's model functions and generator against the JAX package's, with
the same weights (``params_from_jax``) on ``tiny_test_config`` (CPU, fp32).

The JAX encoder runs its Pallas flash path in interpret mode
(``DIA_FLASH_INTERPRET=1``, as tests/test_kernels.py does), so the reference
for the port's flash-routed encoder is the Pallas kernel.  The JAX prefill
runs its masked-XLA path: its flash route passes ``is_causal=False``
(models/dia.py:438) and drops the causal prefill mask, so under the Pallas
kernel every valid prompt row attends later prompt rows too.  The port's
prefill is causal, as the reference (dia/model.py:403-419) and the JAX XLA
path are; ``test_jax_flash_prefill_is_not_causal`` pins that difference.
Tolerances: 1e-4 on logits and hidden states (a few layers of fp32 sums in
another order), token-for-token equality for greedy generation.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.generate import DiaGenerator as JaxGenerator
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu.state import cross_attention_mask as jax_cross_mask
from dia_tts_prune_tpu.state import new_encoder_state as jax_encoder_state
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.generate import DiaGenerator, conditioning
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import ends_from_padding_mask
from dia_tts_prune_tpu_torch.ops.modules import full_attention
from dia_tts_prune_tpu_torch.state import cross_attention_mask, new_encoder_state

ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_test_config()
    jparams = jdia.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg.tiny_test_config(), tparams


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=atol)


def test_encoder_prefill_and_decode_steps(models, monkeypatch):
    monkeypatch.setenv("DIA_FLASH_INTERPRET", "1")
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(30)
    T = cfg.data.text_length
    ids = rng.integers(1, 200, (2, T)).astype(np.int32)
    ids[0, :] = 0  # unconditional row
    ids[1, 70:] = 0

    # encoder + cross cache
    js = jax_encoder_state(jcfg, jnp.asarray(ids))
    j_enc = jdia.encoder_forward(jp, jcfg, jnp.asarray(ids), js.positions, js.attn_mask)
    ts = new_encoder_state(cfg, torch.from_numpy(ids))
    t_enc = tdia.encoder_forward(tp, cfg, torch.from_numpy(ids), ts.positions)
    _close(t_enc, j_enc)
    j_cross = jdia.precompute_cross_cache(jp, jcfg, j_enc, js.positions)
    t_cross = tdia.precompute_cross_cache(tp, cfg, t_enc, ts.positions)
    _close(t_cross.k, j_cross.k)
    _close(t_cross.v, j_cross.v)

    # prompt prefill: 128-row window, rows [0, 37) valid (JAX: masked-XLA path)
    monkeypatch.delenv("DIA_FLASH_INTERPRET")
    W, P = 128, 37
    prompt = rng.integers(0, 1024, (1, W, 9)).astype(np.int32)
    tgt = np.concatenate([prompt, prompt])
    rows = np.broadcast_to(np.arange(W)[None], (2, W))
    valid = rows < P
    pm = jnp.asarray(valid)
    prefill_mask = (pm[:, :, None] == pm[:, None, :])[:, None] & jnp.tril(jnp.ones((W, W), bool))
    j_logits, j_cache = jdia.decoder_prefill(
        jp, jcfg, jnp.asarray(tgt), jnp.asarray(rows, jnp.int32), prefill_mask, j_cross,
        jax_cross_mask(js.padding_mask), jdia.new_self_cache(jcfg, 2),
        dec_segment_ids=jnp.asarray(valid, jnp.int32),
        enc_segment_ids=js.padding_mask.astype(jnp.int32))
    t_cache = tdia.new_self_cache(cfg, 2, device="cpu")
    t_logits = tdia.decoder_prefill(
        tp, cfg, torch.from_numpy(tgt), torch.from_numpy(np.array(rows)), t_cross, t_cache,
        torch.from_numpy(valid.astype(np.int32)), ts.padding_mask.to(torch.int32))
    _close(t_logits, j_logits)
    _close(t_cache.k, j_cache.k)

    # three decode steps after the prompt: self-attention over [0, slot],
    # cross-attention over each row's text (the unconditional row: none)
    j_mask = jax_cross_mask(js.padding_mask)
    ends = ends_from_padding_mask(cross_attention_mask(ts.padding_mask))
    assert ends.tolist() == [0, 70]
    for t in range(P, P + 3):
        tok = rng.integers(0, 1024, (1, 1, 9)).astype(np.int32)
        tgt1 = np.concatenate([tok, tok])
        pos = np.full((2, 1), t, np.int32)
        j_step, j_cache = jdia.decode_step(jp, jcfg, jnp.asarray(tgt1), jnp.asarray(pos),
                                           jnp.asarray(t - 1, jnp.int32), j_cache, j_cross, j_mask)
        t_step = tdia.decode_step(tp, cfg, torch.from_numpy(tgt1), torch.from_numpy(pos), t - 1,
                                  t_cache, t_cross, ends)
        _close(t_step, j_step)
        _close(t_cache.k, j_cache.k)
        _close(t_cache.v, j_cache.v)


def test_jax_flash_prefill_is_not_causal(models, monkeypatch):
    """The JAX package's flash-routed prefill equals the port's prefill with
    causality switched off — the fault the port does not copy."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(32)
    W, P = 128, 50
    tgt = np.repeat(rng.integers(0, 1024, (1, W, 9)).astype(np.int32), 2, axis=0)
    rows = np.broadcast_to(np.arange(W)[None], (2, W))
    valid = rows < P
    ids = np.zeros((2, cfg.data.text_length), np.int32)
    ids[1, :30] = 7
    js = jax_encoder_state(jcfg, jnp.asarray(ids))
    j_cross = jdia.precompute_cross_cache(
        jp, jcfg, jdia.encoder_forward(jp, jcfg, jnp.asarray(ids), js.positions, js.attn_mask),
        js.positions)
    monkeypatch.setenv("DIA_FLASH_INTERPRET", "1")
    j_logits, _ = jdia.decoder_prefill(
        jp, jcfg, jnp.asarray(tgt), jnp.asarray(rows, jnp.int32), None, j_cross,
        jax_cross_mask(js.padding_mask), jdia.new_self_cache(jcfg, 2),
        dec_segment_ids=jnp.asarray(valid, jnp.int32),
        enc_segment_ids=js.padding_mask.astype(jnp.int32))
    t_cross = tdia.KVCache(*(torch.from_numpy(np.array(a)) for a in (j_cross.k, j_cross.v)))
    run = dict(tgt_BxTxC=torch.from_numpy(tgt), dec_positions=torch.from_numpy(np.array(rows)),
               cross_cache=t_cross, dec_segment_ids=torch.from_numpy(valid.astype(np.int32)),
               enc_segment_ids=torch.from_numpy(np.array(js.padding_mask)).to(torch.int32))
    causal = tdia.decoder_prefill(tp, cfg, self_cache=tdia.new_self_cache(cfg, 2, device="cpu"),
                                  **run)
    monkeypatch.setattr(tdia, "full_attention",
                        lambda q, k, v, c, a, b: full_attention(q, k, v, False, a, b))
    acausal = tdia.decoder_prefill(tp, cfg, self_cache=tdia.new_self_cache(cfg, 2, device="cpu"),
                                   **run)
    _close(acausal, j_logits)
    assert np.abs(causal.numpy() - np.asarray(j_logits))[:, : P - 1].max() > 1e-2


def test_generate_with_prompt_matches_jax(models):
    """Greedy generation with a voice prompt (prefill path) equals the JAX
    package's generate_codes token for token."""
    jcfg, jp, cfg, tp = models
    prompt = np.random.default_rng(31).integers(0, 1024, (40, 9)).astype(np.int32)
    kw = dict(max_tokens=80, temperature=0.0, audio_prompt_codes=prompt,
              audio_prompt_text="[S1] p")
    ref = JaxGenerator(jp, jcfg).generate_tokens("[S2] x", **kw)
    out = DiaGenerator(tp, cfg, device="cpu").generate_tokens("[S2] x", **kw)
    assert out.shape[0] > 0
    np.testing.assert_array_equal(out, ref)


def test_conditioning_trims_cross_window(models):
    _, _, cfg, tp = models
    ids = torch.zeros(2, cfg.data.text_length, dtype=torch.int32)
    ids[1, :20] = 5
    cross, padding, ends = conditioning(tp, cfg, ids, torch.float32, cross_window=None)
    assert cross.k.shape[2] == cfg.data.text_length and ends.tolist() == [0, 20]
    assert padding.shape == (2, cfg.data.text_length)


def test_seeded_sampling_repeats(models):
    _, _, cfg, tp = models
    gen = DiaGenerator(tp, cfg, device="cpu")
    a = gen.generate_tokens("[S1] hi", max_tokens=40, temperature=1.3, seed=7)
    b = gen.generate_tokens("[S1] hi", max_tokens=40, temperature=1.3, seed=7)
    np.testing.assert_array_equal(a, b)
