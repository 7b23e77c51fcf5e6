"""The port's decode loop body (``generate.loop_step``, one body for one
stream or N) against the JAX package's loop, on scripted logits, on the CPU.

A fake decode step returns logits read from a table by the step's row ``t``
(both packages' steps get ``t - 1`` as their write slot), made from a numpy
seed, so the JAX loop (``_make_loop_body`` through ``_decode_loop_core``;
``generate_fused_batch``'s body for N streams, its conditioning, caches and
prefill stubbed) and the port's loop see the same logits at every step, and
their greedy token rows and last steps must be equal as integers.  The
scripts: EOS in channel 0 at a chosen step; an EOS logit on delayed channels
(banned there); no EOS, so the near-max trigger ends the run; a voice prompt
whose BOS window is longer than the loop; a prompt that ends near the
buffer's end (the single-stream window clamp); EOS so late that
``max_tokens`` cuts the countdown.  Then: steps run after the stop (as a
CUDA graph replay runs them) change nothing, and greedy generation through
the loop still equals ``golden.npz`` on both trained fixtures.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import generate as jgen
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import generate as tgen
from dia_tts_prune_tpu_torch.models.dia import KVCache
from dia_tts_prune_tpu_torch.state import prepare_audio_prompt

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
CFG_SCALE, TOP_P, TOP_K = 3.0, 0.95, 35


def _table(cfg, rows: int, seed: int, eos_at=(), eos_delayed=(), eos_channel0_big=8.0):
    """Logits [T + 1, rows, C, V] by step row: normals (no ties), EOS made
    the channel-0 pick of the cond rows at the rows in ``eos_at`` (a
    [row, stream] pair list), a large EOS logit on channels 1-4 at the rows
    in ``eos_delayed`` (banned there: never picked)."""
    d = cfg.data
    C, V = d.channels, cfg.model.tgt_vocab_size
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(d.audio_length + 1, rows, C, V)).astype(np.float32)
    n = rows // 2
    for t, i in eos_at:
        tab[t, n + i, 0, d.audio_eos_value] = eos_channel0_big
        tab[t, i, 0, d.audio_eos_value] = -eos_channel0_big
    for t, i in eos_delayed:
        tab[t, n + i, 1:5, d.audio_eos_value] = 50.0
    return tab


def _port_step(table):
    tab = torch.from_numpy(table)

    def step(params, config, tgt, position, write_slot, self_cache, cross_cache, ends,
             dtype, valid_from=None, group=None):
        t = int(torch.as_tensor(write_slot).reshape(-1)[0]) + 1
        return tab[t][:, None]

    return step


def _jax_step(table):
    tab = jnp.asarray(table)

    def step(params, config, tgt, position, write_slot, cache, cross_cache, cross_mask, dtype,
             **kwargs):
        return jax.lax.dynamic_index_in_dim(tab, write_slot + 1, keepdims=False)[:, None], cache

    return step


def _dummy_cache(rows, T):
    z = torch.zeros(1, rows, T, 1, 1)
    return KVCache(k=z, v=z.clone())


def _template(cfg, prompt_len, seed):
    d = cfg.data
    codes = None
    if prompt_len:
        codes = np.random.default_rng(seed).integers(0, 1024, (prompt_len, d.channels))
    delayed, prefill_step = prepare_audio_prompt(cfg, codes)
    buf = np.full((d.audio_length, d.channels), -1, np.int32)
    buf[: delayed.shape[0]] = delayed[: d.audio_length]
    return buf, prefill_step


# (name, prompt frames, max_tokens, EOS rows, banned-EOS rows); steps run from
# row prefill_step on, and audio_length is 128, max_delay 15
SINGLE = [
    ("eos_at_step", 0, 128, [(30, 0)], []),
    ("eos_on_delayed_channels", 0, 128, [(60, 0)], [(20, 0), (40, 0)]),
    ("near_max_trigger", 0, 90, [], []),
    ("bos_window_longer_than_loop", 40, 50, [], []),
    ("window_clamped_at_buffer_end", 113, 128, [], []),
    ("max_tokens_cuts_countdown", 0, 70, [(62, 0)], []),
]


@pytest.mark.parametrize("name,prompt,max_tokens,eos_at,eos_delayed", SINGLE,
                         ids=[c[0] for c in SINGLE])
def test_single_stream_body_equals_jax(monkeypatch, name, prompt, max_tokens, eos_at,
                                       eos_delayed):
    jcfg, cfg = tiny_test_config(), tcfg.tiny_test_config()
    T = cfg.data.audio_length
    buf, prefill_step = _template(cfg, prompt, seed=len(name))
    table = _table(cfg, 2, seed=7 + len(name), eos_at=eos_at, eos_delayed=eos_delayed)

    monkeypatch.setattr(jgen, "_decode_step_fn", lambda params=None, batch=False: _jax_step(table))
    j_tokens, j_step = jgen._decode_loop_core(
        {}, jcfg, jnp.asarray(buf), jnp.zeros(1), None, None, jax.random.PRNGKey(0),
        jnp.int32(prefill_step), jnp.int32(max_tokens), jnp.float32(CFG_SCALE), jnp.float32(0.0),
        jnp.float32(TOP_P), True, TOP_K, jnp.float32)

    monkeypatch.setattr(tgen, "step_function", lambda params: _port_step(table))
    mine = buf.copy()
    stats = tgen.GenerationStats()
    final = tgen.decode_loop({}, cfg, mine, _dummy_cache(2, T), None,
                             torch.zeros(2, dtype=torch.int32), prefill_step, max_tokens,
                             CFG_SCALE, 0.0, TOP_P, TOP_K, None, torch.float32, stats=stats)
    assert final == int(j_step)
    np.testing.assert_array_equal(mine, np.asarray(j_tokens))
    assert stats.loop == "eager" and stats.host_steps == stats.decode_steps
    max_delay, eos = cfg.data.max_delay, cfg.data.audio_eos_value
    assert prefill_step - 1 < final <= max_tokens - 1
    if name == "eos_at_step":  # the countdown's max_delay steps, the last one not kept
        assert final == eos_at[0][0] + max_delay - 2
    # no EOS outside channel 0 before a countdown forces it (the ban)
    forced_from = eos_at[0][0] if eos_at else max_tokens - max_delay - 1
    assert not (mine[prefill_step:forced_from, 1:] == eos).any()


# (name, per-stream prompt frames, max_tokens, EOS rows (row, stream))
BATCH = [
    ("eos_staggered", (0, 0, 0), 128, [(25, 0), (40, 2)]),
    ("prompts_and_caps", (10, 0, 30), 70, [(50, 1)]),
    ("all_hit_caps", (5, 20, 0), 60, []),
]


@pytest.mark.parametrize("name,prompts,max_tokens,eos_at", BATCH, ids=[c[0] for c in BATCH])
def test_three_streams_body_equals_jax_batch(monkeypatch, name, prompts, max_tokens, eos_at):
    """N = 3 streams with per-stream offsets and caps, against the body of
    JAX ``generate_fused_batch`` (its conditioning, caches and prefill
    stubbed out; the fake step as above)."""
    jcfg, cfg = tiny_test_config(), tcfg.tiny_test_config()
    d = cfg.data
    N, T = len(prompts), d.audio_length
    templates = [prepare_audio_prompt(cfg, None if p == 0 else np.random.default_rng(p).integers(
        0, 1024, (p, d.channels))) for p in prompts]
    prefill_steps = np.asarray([s for _, s in templates], np.int32)
    window = int(prefill_steps.max()) if prefill_steps.max() > 1 else None
    start = window or 1
    offsets = start - prefill_steps
    buf = np.full((N, T, d.channels), -1, np.int32)
    for i, (delayed, _) in enumerate(templates):
        buf[i, offsets[i]: offsets[i] + delayed.shape[0]] = delayed
    caps = np.minimum(max_tokens + offsets, T)
    table = _table(cfg, 2 * N, seed=len(name), eos_at=eos_at)

    for fn, value in (("_maybe_unpack_s4", lambda p: p),
                      ("_conditioning", lambda *a: (None, None, None)),
                      ("_new_self_cache_sharded", lambda *a, **k: jnp.zeros(1)),
                      ("_run_prefill", lambda *a: a[-2]),
                      ("_quantize_cross", lambda c, q: c),
                      ("_decode_step_fn", lambda params=None, batch=False: _jax_step(table))):
        monkeypatch.setattr(jgen, fn, value)
    j_tokens, j_final = jgen.generate_fused_batch.__wrapped__(
        {}, jcfg, jnp.zeros((2 * N, d.text_length), jnp.int32), jnp.asarray(buf),
        jnp.asarray(prefill_steps), jnp.zeros(N, jnp.int32), jnp.asarray([max_tokens], jnp.int32),
        jnp.asarray([CFG_SCALE, 0.0, TOP_P], jnp.float32), window, True, TOP_K, "float32",
        kv_quant=False)

    monkeypatch.setattr(tgen, "step_function", lambda params: _port_step(table))
    mine = buf.copy()
    final = tgen.decode_loop_batch({}, cfg, mine, _dummy_cache(2 * N, T), None,
                                   torch.zeros(2 * N, dtype=torch.int32), start, offsets, caps,
                                   CFG_SCALE, 0.0, TOP_P, TOP_K, None, torch.float32)
    np.testing.assert_array_equal(final, np.asarray(j_final))
    np.testing.assert_array_equal(mine, np.asarray(j_tokens))
    assert len(set(final.tolist())) > 1 or name == "all_hit_caps"


def test_steps_after_the_stop_change_nothing(monkeypatch):
    """A replayed CUDA graph runs up to GRAPH_STEPS - 1 steps past the stop:
    such steps leave the state, the token rows and the returned steps as
    they are (every field frozen, the row rewritten with itself)."""
    cfg = tcfg.tiny_test_config()
    T = cfg.data.audio_length
    buf, prefill_step = _template(cfg, 0, seed=0)
    table = _table(cfg, 2, seed=3, eos_at=[(30, 0)])
    step = _port_step(table)
    sampling = tgen.Sampling(CFG_SCALE, 0.0, TOP_P, TOP_K)
    state = tgen.new_loop_state(cfg, buf[None], prefill_step, np.zeros(1, np.int64),
                                np.asarray([128]), "cpu", clamp_window=True, sampling=sampling)
    cache = _dummy_cache(2, T)
    ends = torch.zeros(2, dtype=torch.int32)

    def body():
        tgen.loop_step(state, step, {}, cfg, cache, None, ends, TOP_K, None, torch.float32)

    while not bool(state.stop):
        body()
    before = [t.clone() for t in state]
    for _ in range(tgen.GRAPH_STEPS - 1):
        body()
    for name, a, b in zip(state._fields, before, state):
        assert torch.equal(a, b), name
    assert int(state.final_step[0]) == 30 + cfg.data.max_delay - 2


@pytest.mark.parametrize("fixture", ["trained_small", "trained_deep"])
def test_greedy_generation_equals_golden(fixture):
    d = FIXTURES / fixture
    meta = json.loads((d / "FIXTURE.json").read_text())
    dia = Dia.from_pretrained(d, device="cpu")
    codes = dia.generate_codes(meta["prompt"], temperature=0.0, seed=meta["seed"])
    np.testing.assert_array_equal(codes, np.load(d / "golden.npz")["tokens"])
    stats = dia.generator.last_stats
    # the rows the loop wrote: the codes and the max_delay tail (and the stop step's)
    n = codes.shape[0] + dia.config.data.max_delay
    assert stats.loop == "eager" and stats.decode_steps in (n, n + 1)


def test_graph_loop_needs_the_card():
    dia = Dia.from_pretrained(FIXTURES / "trained_small", device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        dia.generate_codes("[S1] Hi.", max_tokens=20, temperature=0.0, loop="graph")
    with pytest.raises(ValueError, match="loop"):
        dia.generate_codes("[S1] Hi.", max_tokens=20, temperature=0.0, loop="scan")


@pytest.mark.parametrize("a,b,same", [
    ((3.0, 1.3, 0.95, 35), (2.0, 0.9, 0.8, 35), True),  # sampled: only top-k shapes a step
    ((3.0, 0.0, 0.95, 35), (1.0, 0.0, 0.5, 35), True),  # greedy
    ((3.0, 1.3, 0.95, 35), (3.0, 1.3, 0.95, 30), False),
    ((3.0, 1.3, 0.95, 35), (3.0, 0.0, 0.95, 35), False),
])
def test_graph_key_is_greedy_and_top_k(monkeypatch, a, b, same):
    """A kept graph's key holds greedy-or-not and the top-k, not the
    ``cfg_scale`` / ``temperature`` / ``top_p`` values, which ride in
    ``LoopState`` tensors: the keys the solo and lockstep calls ask
    ``_buffers`` for."""
    assert tgen.Sampling(*a).graph_key() == (a[1] == 0.0, a[3])
    assert (tgen.Sampling(*a).graph_key() == tgen.Sampling(*b).graph_key()) == same
    dia = Dia.from_pretrained(FIXTURES / "trained_small", device="cpu")
    gen = dia.generator
    asked = []
    buffers = gen._buffers
    monkeypatch.setattr(gen, "_buffers", lambda loop, key, own=False: (
        asked.append(key), buffers(loop, key, own))[1])
    for cfg_scale, temperature, top_p, top_k in (a, b):
        kw = dict(max_tokens=12, cfg_scale=cfg_scale, temperature=temperature, top_p=top_p,
                  cfg_filter_top_k=top_k, seed=0)
        gen.generate_tokens("[S1] Hi.", **kw)
        gen.generate_tokens_batch(["[S1] Hi.", "[S2] Yo."], **kw)
    solo_a, batch_a, solo_b, batch_b = asked
    assert solo_a[-1] == batch_a[-1] == tgen.Sampling(*a).graph_key()
    assert (solo_a == solo_b) == same and (batch_a == batch_b) == same


def test_generators_on_one_device_share_one_lock():
    """Two models in one process take turns on a device: a capture fails if
    another thread works on the card meanwhile, whatever model it serves."""
    a = Dia.from_pretrained(FIXTURES / "trained_small", device="cpu")
    b = Dia.from_pretrained(FIXTURES / "trained_small", device="cpu")
    assert a.generator.lock is b.generator.lock is tgen.device_lock("cpu")
    assert tgen.device_lock(torch.device("cpu")) is tgen.device_lock("cpu")
    assert tgen.device_lock("meta") is not tgen.device_lock("cpu")
    a.quantize_int8()  # a rebuilt generator keeps the device's lock
    assert a.generator.lock is b.generator.lock
    with a.generator.lock:
        assert b.generator.lock.acquire(blocking=False)  # re-entrant in the holding thread
        b.generator.lock.release()
