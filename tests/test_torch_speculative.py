"""The port's speculative decoding (``speculative.py``, ``models.dia.
decode_step`` on a window of W rows and with ``n_layers``, and the
decode-attention window form) against the JAX package's, on the CPU.

Weights are the JAX ``init_params`` of ``tiny_test_config`` carried over by
``checkpoint.params_from_jax`` (fp32); inputs and caches come from numpy
seeds.  Tolerances: 1e-5 on logits and cache slots (fp32, two frameworks'
summation orders), 1e-6 on probabilities; the window form's plain version
is bit-equal to W one-query calls; greedy codes are compared as integers.
The sampled path is checked by its statistics (chi-square, acceptance rate)
and by a seed repeating itself: torch generators cannot repeat
``jax.random``'s draws.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import speculative as jspec
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu.state import cross_attention_mask as jax_cross_mask
from dia_tts_prune_tpu.state import new_encoder_state as jax_encoder_state
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.generate import DiaGenerator
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops.kernels import (
    decode_attention,
    decode_attention_plain,
    launch_counts,
    reset_launch_counts,
)
from dia_tts_prune_tpu_torch.ops.sampling import sample_next_token
from dia_tts_prune_tpu_torch.speculative import (
    SpeculativeGenerator,
    filtered_probs,
    rejection_sample_channel,
)

torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
ATOL = 1e-5  # logits and K/V: fp32 in both packages, summation order only
TEXT = "[S1] speculative parity check"


@pytest.fixture(scope="module")
def models():
    jcfg = tiny_test_config()
    jparams = jdia.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")
    return jcfg, jparams, tcfg.tiny_test_config(), tparams


@pytest.fixture(scope="module")
def step_inputs(models):
    """Both packages' cross caches from one text, a self cache of random
    K/V (so that every prefix slot matters) and a window of token rows."""
    jcfg, jp, cfg, tp = models
    rng = np.random.default_rng(40)
    ids = np.zeros((2, cfg.data.text_length), np.int32)
    ids[1, :37] = rng.integers(1, 200, 37)
    js = jax_encoder_state(jcfg, jnp.asarray(ids))
    j_cross = jdia.precompute_cross_cache(
        jp, jcfg, jdia.encoder_forward(jp, jcfg, jnp.asarray(ids), js.positions, js.attn_mask),
        js.positions)
    dec = cfg.model.decoder
    shape = (dec.n_layer, 2, 96, dec.kv_heads, dec.gqa_head_dim)
    k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    rows = rng.integers(0, 1024, (12, cfg.data.channels)).astype(np.int32)
    return {"j_cross": j_cross, "j_mask": jax_cross_mask(js.padding_mask),
            "t_cross": tdia.KVCache(*(torch.from_numpy(np.array(a)) for a in (j_cross.k,
                                                                               j_cross.v))),
            "ends": torch.tensor([0, 37], dtype=torch.int32), "k": k, "v": v, "rows": rows}


def _caches(inp):
    return (jdia.KVCache(k=jnp.asarray(inp["k"]), v=jnp.asarray(inp["v"])),
            tdia.KVCache(torch.from_numpy(inp["k"].copy()), torch.from_numpy(inp["v"].copy())))


def _window(tp, cfg, tgt, s, cache, inp, **kw):
    """``decode_step`` on the W rows of ``tgt`` [2, W, C] from cache slot
    ``s``: row i at RoPE position s + i + 1, as the verify pass runs it."""
    W = tgt.shape[1]
    pos = (int(s) + 1 + torch.arange(W))[None].expand(2, W)
    return tdia.decode_step(tp, cfg, torch.as_tensor(tgt), pos, s, cache, inp["t_cross"],
                            inp["ends"], **kw)


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=0, atol=atol)


def test_decode_step_early_exit_matches_jax(models, step_inputs):
    """``decode_step(n_layers=1)`` against the JAX ``decode_step_scan(n_layers=1)``:
    logits to 1e-5, the first layer's slot written, the second layer's not."""
    jcfg, jp, cfg, tp = models
    inp = step_inputs
    j_cache, t_cache = _caches(inp)
    slot = 40
    tok = np.repeat(inp["rows"][None, :1], 2, axis=0)  # [2, 1, C]
    pos = np.full((2, 1), slot + 1, np.int32)
    j_logits, j_new = jdia.decode_step_scan(
        jp, jcfg, jnp.asarray(tok), jnp.asarray(pos), jnp.asarray(slot, jnp.int32), j_cache,
        inp["j_cross"], inp["j_mask"], n_layers=1, skip_uncond_cross=True)
    t_logits = tdia.decode_step(tp, cfg, torch.from_numpy(tok), torch.from_numpy(pos), slot,
                                t_cache, inp["t_cross"], inp["ends"], n_layers=1)
    _close(t_logits, j_logits)
    _close(t_cache.k, j_new.k)
    _close(t_cache.v, j_new.v)
    assert not np.array_equal(t_cache.k[0].numpy(), inp["k"][0])
    np.testing.assert_array_equal(t_cache.k[1].numpy(), inp["k"][1])
    np.testing.assert_array_equal(t_cache.v[1].numpy(), inp["v"][1])
    with pytest.raises(ValueError, match="n_layers"):
        tdia.decode_step(tp, cfg, torch.from_numpy(tok), torch.from_numpy(pos), slot, t_cache,
                         inp["t_cross"], inp["ends"], n_layers=3)


@pytest.mark.parametrize("s", [0, 40])
def test_decode_window_matches_jax(models, step_inputs, s):
    """``decode_step`` on W rows against the JAX ``decode_window`` at a
    cache offset inside the cache and at 0: logits [B, W, C, V] and the committed slots
    [s, s + W) to 1e-5, the other slots untouched."""
    jcfg, jp, cfg, tp = models
    inp = step_inputs
    j_cache, t_cache = _caches(inp)
    W = 8
    tgt = np.repeat(inp["rows"][None, :W], 2, axis=0)
    j_logits, j_new = jdia.decode_window(jp, jcfg, jnp.asarray(tgt), jnp.asarray(s, jnp.int32),
                                         j_cache, inp["j_cross"], inp["j_mask"],
                                         skip_uncond_cross=True)
    t_logits = _window(tp, cfg, tgt, s, t_cache, inp)
    assert t_logits.shape == (2, W, cfg.data.channels, cfg.model.tgt_vocab_size)
    _close(t_logits, j_logits)
    _close(t_cache.k, j_new.k)
    _close(t_cache.v, j_new.v)
    outside = np.r_[0:s, s + W:inp["k"].shape[2]]
    np.testing.assert_array_equal(t_cache.k.numpy()[:, :, outside], inp["k"][:, :, outside])


def test_window_rows_equal_decode_steps(models, step_inputs):
    """Window row i equals ``decode_step`` at row s + i from the same cache
    (the loop's step, each committing its own slot first): logits and
    committed K/V to 1e-5 (the CPU's products sum in an order that may
    follow the row count; on the card they are bit-equal)."""
    _, _, cfg, tp = models
    inp = step_inputs
    W, s = 6, 30
    _, win_cache = _caches(inp)
    _, step_cache = _caches(inp)
    tgt = np.repeat(inp["rows"][None, :W], 2, axis=0)
    win = _window(tp, cfg, tgt, torch.tensor([s]), win_cache, inp)
    for i in range(W):
        pos = torch.full((2, 1), s + i + 1)
        step = tdia.decode_step(tp, cfg, torch.from_numpy(tgt[:, i: i + 1]), pos, s + i,
                                step_cache, inp["t_cross"], inp["ends"])
        _close(win[:, i], step[:, 0])
    _close(win_cache.k, step_cache.k)
    _close(win_cache.v, step_cache.v)


def test_q_pass_leaves_the_cache_unchanged(models, step_inputs):
    """The draft's q pass (``decode_step`` on the window's W rows with
    ``n_layers=1``, run after the verify pass over the same rows) equals the
    JAX ``decode_step_scan_window_q`` to 1e-5 (on the cache the JAX verify
    pass left) and leaves the cache bit for bit as the verify pass left it:
    it writes its layer's slots again with the same values."""
    jcfg, jp, cfg, tp = models
    inp = step_inputs
    j_cache, t_cache = _caches(inp)
    W, s = 8, 17
    tgt = np.repeat(inp["rows"][None, 2: 2 + W], 2, axis=0)
    _, j_verified = jdia.decode_window(jp, jcfg, jnp.asarray(tgt), jnp.asarray(s, jnp.int32),
                                       j_cache, inp["j_cross"], inp["j_mask"],
                                       skip_uncond_cross=True)
    ref, _ = jspec.decode_step_scan_window_q(jp, jcfg, jnp.asarray(tgt), jnp.asarray(s, jnp.int32),
                                             j_verified, inp["j_cross"], inp["j_mask"],
                                             jnp.float32, 1)
    _window(tp, cfg, tgt, s, t_cache, inp)
    verified = [c.clone() for c in t_cache]
    out = _window(tp, cfg, tgt, s, t_cache, inp, n_layers=1)
    _close(out, ref)
    for a, b in zip(t_cache, verified):
        assert torch.equal(a, b)


def test_window_form_counts_apart():
    """The window form's launches have their own count
    (``launch_counts()["decode_attention_window"]``), which
    ``reset_launch_counts`` zeroes with the others."""
    saved = decode_attention.launches, decode_attention.window_launches
    try:
        decode_attention.launches, decode_attention.window_launches = 5, 3
        counts = launch_counts()
        assert (counts["decode_attention"], counts["decode_attention_window"]) == (5, 3)
        reset_launch_counts()
        assert not any(launch_counts().values())
    finally:
        decode_attention.launches, decode_attention.window_launches = saved


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("W", [2, 8])
def test_window_form_plain_is_bit_equal_to_single_calls(dtype, W):
    """``decode_attention_plain(queries_per_row=W)``: query row r reads cache
    row r // W; each of the W query positions equals a one-query call over
    the same cache rows and ranges bit for bit.  The int8 form raises."""
    rng = np.random.default_rng(41)
    B, T, Nq, Nkv, H = 2, 200, 4, 2, 16
    q = torch.from_numpy(rng.normal(size=(B * W, Nq, H)).astype(np.float32)).to(dtype)
    k, v = (torch.from_numpy(rng.normal(size=(B, T, Nkv, H)).astype(np.float32)).to(dtype)
            for _ in range(2))
    start = torch.tensor([3] * W + [0] * W, dtype=torch.int32)
    end = torch.tensor([100 + i for i in range(W)] + [150 + 2 * i for i in range(W)],
                       dtype=torch.int32)
    out = decode_attention_plain(q, k, v, start, end, queries_per_row=W).view(B, W, Nq, H)
    for i in range(W):
        one = decode_attention_plain(q.view(B, W, Nq, H)[:, i].contiguous(), k, v,
                                     start.view(B, W)[:, i].contiguous(),
                                     end.view(B, W)[:, i].contiguous())
        assert torch.equal(out[:, i], one)
    with pytest.raises(ValueError, match="window form"):
        decode_attention_plain(q, k.to(torch.int8), v.to(torch.int8), start, end,
                               torch.ones(B, T, Nkv), torch.ones(B, T, Nkv), queries_per_row=W)


def test_filtered_probs_matches_jax_and_the_sampler():
    """``filtered_probs`` equals the JAX one to 1e-6 (temperature, top-k,
    top-p), and ``sample_next_token``'s draws follow it: chi-square over
    20 000 draws below 30 (at most 7 degrees of freedom; the 99.9th
    percentile of chi2(7) is 24.3)."""
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(3, 64)).astype(np.float32) * 3
    p = filtered_probs(torch.from_numpy(logits), 1.3, 0.9, 8)
    ref = jspec.filtered_probs(jnp.asarray(logits), 1.3, 0.9, 8)
    _close(p, ref, atol=1e-6)
    np.testing.assert_allclose(p.sum(-1).numpy(), 1.0, rtol=1e-6)
    n = 20000
    g = torch.Generator().manual_seed(5)
    for row, row_p in zip(torch.from_numpy(logits), p):
        draws = sample_next_token(row.expand(n, -1), torch.tensor(1.3), torch.tensor(0.9), 8,
                                  generator=g)
        counts = np.bincount(draws.numpy(), minlength=64)
        support = row_p.numpy() > 0
        assert counts[~support].sum() == 0
        expected = row_p.numpy()[support] * n
        chi2 = float(((counts[support] - expected) ** 2 / expected).sum())
        assert chi2 < 30.0, (chi2, counts[support], expected)


def test_rejection_sampling_matches_target():
    """Channelwise accept-or-residual emits draws from p on fixed (p, q):
    chi-square over 20 000 trials below 40 (15 degrees of freedom; the 99.9th
    percentile is 37.7), acceptance within 0.02 of 1 - TV(p, q)."""
    V, n = 16, 20000
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.dirichlet(np.ones(V)).astype(np.float32))
    p = torch.from_numpy(rng.dirichlet(np.ones(V)).astype(np.float32))
    g = torch.Generator().manual_seed(2)
    drafts = torch.multinomial(q, n, replacement=True, generator=g).to(torch.int32)
    toks, acc = rejection_sample_channel(drafts, q.expand(n, V), p.expand(n, V), g)
    assert toks.dtype == torch.int32
    counts = np.bincount(toks.numpy(), minlength=V)
    expected = p.numpy() * n
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 40.0, (chi2, counts, expected)
    tv = 0.5 * float((p - q).abs().sum())
    assert abs(float(acc.float().mean()) - (1 - tv)) < 0.02


def test_rejection_identical_distributions_always_accept():
    V = 8
    p = torch.full((500, V), 1 / V)
    toks, acc = rejection_sample_channel(torch.full((500,), 3), p, p, torch.Generator())
    assert bool(acc.all()) and bool((toks == 3).all())


@pytest.mark.parametrize("n_draft,window", [(1, 4), (1, 8), (2, 4)])
def test_greedy_token_exact(models, n_draft, window):
    """Speculative greedy equals the port's loop, which equals the JAX
    ``SpeculativeGenerator``, token for token, at two window sizes and with
    the full model as the draft (every draft accepted: alpha = 1.0)."""
    jcfg, jp, cfg, tp = models
    kw = dict(max_tokens=96, temperature=0.0)
    loop = DiaGenerator(tp, cfg, device="cpu").generate_tokens(TEXT, **kw)
    spec = SpeculativeGenerator(tp, cfg, n_draft_layers=n_draft, window=window, device="cpu")
    got = spec.generate_tokens(TEXT, **kw)
    ref = jspec.SpeculativeGenerator(jp, jcfg, n_draft_layers=n_draft, window=window)
    np.testing.assert_array_equal(got, loop)
    np.testing.assert_array_equal(ref.generate_tokens(TEXT, **kw), loop)
    assert spec.stats["windows"] > 0 and spec.stats["drafted"] > 0
    assert spec.last_call["windows"] == spec.stats["windows"]
    if n_draft == cfg.model.decoder.n_layer:
        assert spec.acceptance_rate == 1.0
        assert spec.stats == ref.stats
    else:
        assert spec.stats["windows"] == ref.stats["windows"]


def test_greedy_token_exact_with_voice_prompt(models):
    """A voice prompt (the prefill, then the windows from its end) with W = 6."""
    jcfg, jp, cfg, tp = models
    prompt = np.random.default_rng(9).integers(0, 1024, (14, 9)).astype(np.int32)
    kw = dict(max_tokens=96, temperature=0.0, audio_prompt_codes=prompt,
              audio_prompt_text="[S1] prompt words")
    loop = DiaGenerator(tp, cfg, device="cpu").generate_tokens("[S2] continue", **kw)
    spec = SpeculativeGenerator(tp, cfg, n_draft_layers=1, window=6, device="cpu")
    ref = jspec.SpeculativeGenerator(jp, jcfg, n_draft_layers=1, window=6)
    np.testing.assert_array_equal(spec.generate_tokens("[S2] continue", **kw), loop)
    np.testing.assert_array_equal(ref.generate_tokens("[S2] continue", **kw), loop)
    assert spec.stats["windows"] > 0


def test_sampled_runs_are_valid_and_repeat(models):
    """Seeded sampled speculation gives codes in [0, 1023], windows ran, and
    one seed repeats itself (another seed gives other codes)."""
    _, _, cfg, tp = models
    spec = SpeculativeGenerator(tp, cfg, n_draft_layers=1, window=4, device="cpu")
    kw = dict(max_tokens=64, temperature=1.2)
    a = spec.generate_tokens(TEXT, seed=7, **kw)
    windows = spec.last_call["windows"]
    b = spec.generate_tokens(TEXT, seed=7, **kw)
    c = spec.generate_tokens(TEXT, seed=8, **kw)
    assert a.shape[1] == 9 and a.min() >= 0 and a.max() <= 1023
    assert windows > 0 and spec.stats["windows"] >= 3 * windows - 2
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_dia_generate_codes_speculative(models):
    """``Dia.generate_codes(speculative=True)`` (window 8) and an int window
    equal the greedy loop; the generator is kept per (window, draft layers) and
    rebuilt once ``quantize_int8()`` swaps the params, after which it still
    equals that decoder's loop."""
    _, _, cfg, tp = models
    dia = Dia(cfg, tp, device="cpu")
    kw = dict(max_tokens=96, temperature=0.0, seed=3)
    ref = dia.generate_codes(TEXT, **kw)
    np.testing.assert_array_equal(dia.generate_codes(TEXT, speculative=True, **kw), ref)
    g8 = dia.speculative_generator()
    assert (g8.window, g8.n_draft_layers) == (8, 1) and g8.stats["windows"] > 0
    np.testing.assert_array_equal(
        dia.generate_codes(TEXT, speculative=4, spec_draft_layers=1, **kw), ref)
    g4 = dia.speculative_generator(4, 1)
    assert g4 is dia.speculative_generator(4, 1) and g4 is not g8
    assert g4.generator is dia.generator
    dia.quantize_int8()
    assert dia.speculative_generator(4, 1) is not g4
    assert dia.speculative_generator(4, 1).generator is dia.generator
    ref8 = dia.generate_codes(TEXT, kv_int8=False, **kw)
    np.testing.assert_array_equal(
        dia.generate_codes(TEXT, speculative=4, spec_draft_layers=1, **kw), ref8)


@pytest.mark.parametrize("route", ["int8", "int4", "pruned"])
def test_packed_and_pruned_decoders(models, route):
    """int8, int4 and block-sparse pruned decoders: speculative greedy equals
    that decoder's loop with float caches (``kv_int8=False``)."""
    _, _, cfg, tp = models
    dia = Dia(cfg, tp, device="cpu")
    if route == "int8":
        dia.quantize_int8()
    elif route == "int4":
        dia.quantize_int4()
    else:
        dia.prune_block_sparse(0.5, (32, 64), scope="module")
    kw = dict(max_tokens=80, temperature=0.0)
    ref = dia.generate_codes(TEXT, kv_int8=False, **kw)
    out = dia.generate_codes(TEXT, speculative=6, spec_draft_layers=1, **kw)
    np.testing.assert_array_equal(out, ref)
    assert dia.speculative_generator(6, 1).stats["windows"] > 0


def test_trained_deep_speculative_equals_golden():
    """The 18-layer fixture (the real depth): speculative greedy with
    Ld = 6, W = 8 equals ``golden.npz``."""
    d = FIXTURES / "trained_deep"
    meta = json.loads((d / "FIXTURE.json").read_text())
    dia = Dia.from_pretrained(d, device="cpu")
    assert dia.config.model.decoder.n_layer == 18
    codes = dia.generate_codes(meta["prompt"], temperature=0.0, seed=meta["seed"],
                               speculative=8, spec_draft_layers=6)
    np.testing.assert_array_equal(codes, np.load(d / "golden.npz")["tokens"])
    assert dia.speculative_generator(8, 6).stats["windows"] > 0


def test_limits_raise(models, step_inputs):
    """``kv_int8=True`` raises, and so does an int8 cache in a window
    ``decode_step``; a window of 33 rows runs (the JAX ``decode_window`` has
    no cap), and so does a generator of W = 33 (``test_window_33_equals_the_loop``)."""
    _, _, cfg, tp = models
    _, t_cache = _caches(step_inputs)
    tgt = torch.zeros(2, 33, cfg.data.channels, dtype=torch.int32)
    assert _window(tp, cfg, tgt, 0, t_cache, step_inputs).shape[:2] == (2, 33)
    with pytest.raises(ValueError, match="float"):
        _window(tp, cfg, tgt[:, :4], 0, tdia.quantize_cache(t_cache), step_inputs)
    spec = SpeculativeGenerator(tp, cfg, window=4, device="cpu")
    with pytest.raises(ValueError, match="kv_int8"):
        spec.generate_tokens(TEXT, max_tokens=40, kv_int8=True)


def test_window_33_equals_the_loop(models):
    """W = 33 (66 verify rows, past the 64 of one kernel launch on the
    card), the full model as the draft so that every window is accepted:
    greedy tokens equal the loop's."""
    _, _, cfg, tp = models
    kw = dict(max_tokens=120, temperature=0.0)
    loop = DiaGenerator(tp, cfg, device="cpu").generate_tokens(TEXT, **kw)
    spec = SpeculativeGenerator(tp, cfg, n_draft_layers=cfg.model.decoder.n_layer, window=33,
                                device="cpu")
    np.testing.assert_array_equal(spec.generate_tokens(TEXT, **kw), loop)
    assert spec.stats["windows"] > 0 and spec.acceptance_rate == 1.0
