"""Batched generation in the port (``generate_tokens_batch``,
``Dia.generate_batch``) against single-stream runs and the JAX package, on
the CPU.

* Each lane of a batch equals its own single-stream run — greedy, and
  sampled with per-stream seeds — for float and block-sparse trees, with
  voice prompts of different lengths (left-padded streams, first valid
  cache slot > 0, row-local RoPE positions).
* Greedy batched codes equal the JAX package's ``generate_tokens_batch``.
* ``decode_step(valid_from=...)`` equals the JAX step's logits at 1e-4 (a
  few layers of fp32 sums in another order, the model tests' tolerance).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.api import Dia as JaxDia
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu.state import cross_attention_mask as jax_cross_mask
from dia_tts_prune_tpu.state import new_encoder_state as jax_encoder_state
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import prune as tprune
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import ends_from_padding_mask
from dia_tts_prune_tpu_torch.state import cross_attention_mask, new_encoder_state

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"
TEXTS = ["[S1] The birch canoe slid. [S2]", "[S2] Hello there, friend.", "[S1] Three."]
PROMPT_TEXTS = ["[S1] A voice.", None, "[S2] Another, longer voice prompt."]
MAX_TOKENS = 96  # inside the 256-row buffer for every stream, prompted or not


@pytest.fixture(scope="module")
def golden():
    return np.load(SMALL / "golden.npz")["tokens"]


@pytest.fixture(scope="module", params=["float", "sparse"])
def model(request):
    dia = Dia.from_pretrained(SMALL, device="cpu")
    if request.param == "sparse":
        masks = tprune.block_masks(dia.params, 0.5, block=(32, 64), scope="module")
        dia._set_params(tprune.apply_masks(dia.params, masks))
        assert min(dia.sparsify_block((32, 64)).values()) < 1.0
    return dia


def _prompts(golden):
    return [golden[:20], None, golden[50:90]]  # 20 and 40 frames: offsets differ


def _singles(dia, golden, **kw):
    return [dia.generate_codes(t, audio_prompt_codes=p, audio_prompt_text=pt, **kw)
            for t, p, pt in zip(TEXTS, _prompts(golden), PROMPT_TEXTS)]


def test_greedy_lanes_equal_single_stream_runs(model, golden):
    kw = dict(max_tokens=MAX_TOKENS, temperature=0.0)
    batch = model.generator.generate_tokens_batch(
        TEXTS, audio_prompt_codes=_prompts(golden), audio_prompt_texts=PROMPT_TEXTS, **kw)
    for out, ref in zip(batch, _singles(model, golden, **kw)):
        assert out.shape[0] > 0
        np.testing.assert_array_equal(out, ref)


def test_seeded_lanes_equal_single_stream_runs(model, golden):
    kw = dict(max_tokens=MAX_TOKENS, temperature=1.3)
    seeds = [11, 12, 13]
    batch = model.generator.generate_tokens_batch(
        TEXTS, audio_prompt_codes=_prompts(golden), audio_prompt_texts=PROMPT_TEXTS,
        seeds=seeds, **kw)
    refs = [model.generate_codes(t, audio_prompt_codes=p, audio_prompt_text=pt, seed=s, **kw)
            for t, p, pt, s in zip(TEXTS, _prompts(golden), PROMPT_TEXTS, seeds)]
    for out, ref in zip(batch, refs):
        np.testing.assert_array_equal(out, ref)
    # one seed for all: each lane is its single-stream run with that seed
    shared = model.generator.generate_tokens_batch(TEXTS[:2], seed=5, **kw)
    for t, out in zip(TEXTS[:2], shared):
        np.testing.assert_array_equal(out, model.generate_codes(t, seed=5, **kw))


def test_greedy_batch_equals_jax(golden):
    jd, dia = JaxDia.from_pretrained(str(SMALL)), Dia.from_pretrained(SMALL, device="cpu")
    kw = dict(max_tokens=MAX_TOKENS, temperature=0.0, audio_prompt_codes=_prompts(golden),
              audio_prompt_texts=PROMPT_TEXTS)
    ref = jd.generator.generate_tokens_batch(TEXTS, **kw)
    out = dia.generator.generate_tokens_batch(TEXTS, **kw)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_generate_batch_waveforms_and_argument_checks(golden):
    dia = Dia.from_pretrained(SMALL, device="cpu")
    kw = dict(max_tokens=64, temperature=0.0)
    wavs = dia.generate_batch(TEXTS[:2], **kw)
    for t, w in zip(TEXTS[:2], wavs):
        np.testing.assert_array_equal(w, dia.generate(t, **kw))
    assert dia.generate_batch([]) == []
    with pytest.raises(ValueError, match="audio_prompt_texts"):
        dia.generate_batch(TEXTS[:1], audio_prompts=[golden[:10]], **kw)
    with pytest.raises(ValueError, match="seeds"):
        dia.generate_batch(TEXTS[:2], seeds=[1], **kw)


def test_decode_step_valid_from_matches_jax():
    """Two rows whose valid cache windows start at different slots."""
    jcfg, cfg = tiny_test_config(), tcfg.tiny_test_config()
    jp = jdia.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(21)
    ids = rng.integers(1, 200, (2, cfg.data.text_length)).astype(np.int32)
    ids[0, 50:] = 0
    js = jax_encoder_state(jcfg, jnp.asarray(ids))
    j_enc = jdia.encoder_forward(jp, jcfg, jnp.asarray(ids), js.positions, js.attn_mask)
    j_cross = jdia.precompute_cross_cache(jp, jcfg, j_enc, js.positions)
    ts = new_encoder_state(cfg, torch.from_numpy(ids))
    t_cross = tdia.KVCache(k=torch.from_numpy(np.array(j_cross.k)),
                           v=torch.from_numpy(np.array(j_cross.v)))
    T, slot = 32, 12
    shape = (cfg.model.decoder.n_layer, 2, T, cfg.model.decoder.kv_heads,
             cfg.model.decoder.gqa_head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    j_cache = jdia.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    t_cache = tdia.KVCache(k=torch.from_numpy(k0.copy()), v=torch.from_numpy(v0.copy()))
    valid_from = np.asarray([3, 9], np.int32)
    tok = rng.integers(0, 1024, (2, 1, 9)).astype(np.int32)
    pos = (slot + 1 - valid_from)[:, None].astype(np.int32)
    ref, _ = jdia.decode_step(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jnp.int32(slot),
                              j_cache, j_cross, jax_cross_mask(js.padding_mask),
                              valid_from=jnp.asarray(valid_from))
    ends = ends_from_padding_mask(cross_attention_mask(ts.padding_mask))
    out = tdia.decode_step(params, cfg, torch.from_numpy(tok), torch.from_numpy(pos).long(), slot,
                           t_cache, t_cross, ends, valid_from=torch.from_numpy(valid_from))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    no_window = tdia.decode_step(params, cfg, torch.from_numpy(tok), torch.from_numpy(pos).long(),
                                 slot, t_cache, t_cross, ends)
    assert (no_window - out).abs().max() > 1e-3  # the window does change the result
