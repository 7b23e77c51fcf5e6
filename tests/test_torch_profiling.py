"""The port's profiling helpers (``utils/profiling.py``: the three cases of
tests/test_profiling.py) and the two decode steps with their write slot on
the device, which the CUDA-graph decode loop needs, on the CPU:

* ``decode_step`` with an int32 [1] tensor slot against the JAX
  ``decode_step_scan`` (its traced slot) at ``tiny_test_config`` width, float
  and int8 caches: logits at 1e-4 (the model tests' tolerance), the caches
  after the commit equal to those of the int slot bit for bit;
* ``fused_decode_step_plain`` with the tensor slot against the JAX
  ``fused_step_reference``, at 2e-2 (tests/test_torch_fused.py's gate), and
  equal to its run with the int slot.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu.ops.kernels import fused_step as jfs
from dia_tts_prune_tpu.state import cross_attention_mask as jax_cross_mask
from dia_tts_prune_tpu.state import new_encoder_state as jax_encoder_state
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops.kernels import fused_step as tfs
from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import ends_from_padding_mask
from dia_tts_prune_tpu_torch.state import cross_attention_mask, new_encoder_state
from dia_tts_prune_tpu_torch.utils.profiling import (
    DAC_FRAME_RATE,
    GenerationStats,
    annotate,
    memory_stats,
    trace,
)

from .test_torch_fused import _carry_pack, _close, _jax_args, _jpack, _step_inputs, _t

torch.set_num_threads(1)


def test_generation_stats_counters():
    stats = GenerationStats()
    time.sleep(0.01)
    stats.finish(decode_steps=173, prefill_steps=1)
    d = stats.as_dict()
    assert d["decode_steps"] == 173 and d["prefill_steps"] == 1
    assert d["wall_seconds"] > 0
    assert abs(stats.realtime_factor - stats.tokens_per_second / DAC_FRAME_RATE) < 1e-6
    assert d["device_ms_per_replayed_step"] is None  # no replays
    stats.replays, stats.graph_steps, stats.replay_device_seconds = 3, 16, 0.192
    assert abs(stats.device_ms_per_replayed_step - 4.0) < 1e-9


def test_annotate_context(tmp_path):
    with annotate("test-region"):
        pass  # must not raise outside a trace
    with trace(str(tmp_path)) as prof:
        with annotate("test-region"):
            torch.ones(4).sum()
    assert any(e.key == "test-region" for e in prof.key_averages())
    assert (tmp_path / "trace.json").exists()


def test_memory_stats_shape():
    out = memory_stats()
    assert isinstance(out, list)
    if torch.cuda.is_available():
        assert out and "device" in out[0] and out[0]["peak_bytes_in_use"] >= 0
    else:
        assert out == []  # no device reports stats


@pytest.fixture(scope="module")
def tiny_models():
    jcfg = tiny_test_config()
    jp = jdia.init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg.tiny_test_config(), params_from_jax(jax.tree.map(np.asarray, jp),
                                                              device="cpu")


def _quantized(cache):
    (kq, ks), (vq, vs) = jdia.quantize_kv(cache.k), jdia.quantize_kv(cache.v)
    return jdia.QuantKVCache(k=kq, v=vq, ks=ks, vs=vs)


@pytest.mark.parametrize("kv", ["float", "int8"])
def test_decode_step_device_slot_matches_jax_scan(tiny_models, kv):
    jcfg, jp, cfg, params = tiny_models
    rng = np.random.default_rng(41)
    ids = rng.integers(1, 200, (2, cfg.data.text_length)).astype(np.int32)
    ids[0, :] = 0  # the CFG unconditional row
    ids[1, 60:] = 0
    js = jax_encoder_state(jcfg, jnp.asarray(ids))
    j_enc = jdia.encoder_forward(jp, jcfg, jnp.asarray(ids), js.positions, js.attn_mask)
    j_cross = jdia.precompute_cross_cache(jp, jcfg, j_enc, js.positions)
    t_cross = tdia.KVCache(k=_t(j_cross.k), v=_t(j_cross.v))
    dec = cfg.model.decoder
    T, slot = 40, 23
    shape = (dec.n_layer, 2, T, dec.kv_heads, dec.gqa_head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    j_cache = jdia.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    if kv == "int8":
        j_cache, j_cross = _quantized(j_cache), _quantized(j_cross)
        t_cross = tdia.QuantKVCache(*(_t(a) for a in j_cross))
    tok = rng.integers(0, 1024, (2, 1, 9)).astype(np.int32)
    pos = np.full((2, 1), slot + 1, np.int32)
    ref, ref_cache = jdia.decode_step_scan(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                           jnp.int32(slot), j_cache, j_cross,
                                           jax_cross_mask(js.padding_mask))
    ends = ends_from_padding_mask(cross_attention_mask(new_encoder_state(
        cfg, torch.from_numpy(ids)).padding_mask))
    runs = []
    for ws in (torch.tensor([slot], dtype=torch.int32), slot):
        cache = type(t_cross)(*(_t(a) for a in j_cache))
        out = tdia.decode_step(params, cfg, _t(tok), _t(pos).long(), ws, cache, t_cross, ends)
        runs.append((out, cache))
    (out, cache), (out_int, cache_int) = runs
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    assert torch.equal(out, out_int)
    # the committed slot: float K/V at 1e-4; int8 codes within one step (a
    # value on a rounding boundary), their scales at 1e-5 of their size
    tols = [(0, 1e-4)] * 2 if kv == "float" else [(0, 1)] * 2 + [(1e-5, 0)] * 2
    untouched = np.arange(T) != slot
    for a, b, r, (rtol, atol) in zip(cache, cache_int, ref_cache, tols):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a[:, :, slot].float().numpy(),
                                   np.asarray(r, np.float32)[:, :, slot], rtol=rtol, atol=atol)
        assert torch.equal(a[:, :, untouched], _t(np.asarray(r))[:, :, untouched])


@pytest.mark.parametrize("kind,int4", [("f32", False), ("int8", False), ("bf16", True)])
def test_fused_plain_device_slot_matches_jax_reference(tiny_models, kind, int4):
    jcfg, jp, _, _ = tiny_models
    jpack = _jpack(jp, int4, 4)
    pack = _carry_pack(jpack)
    inp = _step_inputs(jcfg, kind, True, seed=5)
    ref = jfs.fused_step_reference(jpack, jnp.asarray(inp["x"]), **_jax_args(jcfg, inp))
    m = jcfg.model
    tc = [_t(np.asarray(c, np.float32)).to(torch.bfloat16) if str(c.dtype) == "bfloat16"
          else _t(c) for c in inp["caches"]]
    scales = [None] * 4 if inp["scales"] is None else [_t(s) for s in inp["scales"]]
    outs = [tfs.fused_decode_step_plain(
        pack, _t(inp["x"]), _t(inp["pos"]), ws, *tc, _t(inp["ends"]),
        m.normalization_layer_epsilon, m.rope_min_timescale, m.rope_max_timescale,
        _t(inp["vf"]), *scales) for ws in (torch.tensor([inp["ws"]], dtype=torch.int32),
                                           inp["ws"])]
    for o, i, r in zip(*outs, ref):
        _close(o.float().numpy(), r)
        assert torch.equal(o, i)
