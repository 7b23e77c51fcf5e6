"""The continuous batcher's loop body and its decode step against the JAX
package, on the CPU at ``tiny_test_config`` width.

* The port's lanes (``cbatch.cb_init`` / ``swap_in`` / ``cb_segment`` around
  ``generate.loop_step`` with ``t`` [N]) against JAX ``cb_init`` /
  ``swap_in`` / ``cb_segment`` (cbatch.py:105-386), both decode steps
  stubbed by a logits table read at each row's own step (``write_slot + 1``
  of that row), greedy lanes: lanes at different steps, EOS at different
  steps in each lane, caps, voice-prompt BOS windows, frozen and vacant
  lanes, and lanes admitted mid-run into a vacant and a freed slot.  After
  every segment the token rows, each lane's last step (JAX ``dec_step``,
  the port's ``final_step``) and its stop flag are equal as integers.  The
  port steps with a generator a lane, every lane greedy: the argmax wins
  over the draw.
* ``decode_step`` with a ``[B]`` write slot (rows at different slots)
  against JAX ``decode_step_scan``'s per-row ``write_slot``, float and int8
  caches: logits at 1e-4, the committed slots at tests/
  test_torch_profiling.py's tolerances, every other slot untouched.
* ``write_slots`` and ``_commit`` on their own: every slot form, the flat
  indices, the writes, and the errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu import cbatch as jcb
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu.state import cross_attention_mask as jax_cross_mask
from dia_tts_prune_tpu.state import new_encoder_state as jax_encoder_state
from dia_tts_prune_tpu_torch import cbatch as tcb
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import generate as tgen
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import ends_from_padding_mask
from dia_tts_prune_tpu_torch.state import cross_attention_mask, new_encoder_state, prepare_audio_prompt
from dia_tts_prune_tpu_torch.utils.profiling import GenerationStats

torch.set_num_threads(1)

CFG_SCALE, TOP_P, TOP_K = 3.0, 0.95, 35
N, S = 3, 32  # lanes, text window


def _t(a):
    return torch.from_numpy(np.array(a))


def _table(cfg, seed, eos_at):
    """Logits [T + 1, 2N, C, V] by (step row, CFG row): normals, and EOS the
    channel-0 pick of lane i's cond row at the rows in ``eos_at`` ((row,
    lane) pairs)."""
    d = cfg.data
    rng = np.random.default_rng(seed)
    tab = rng.normal(size=(d.audio_length + 1, 2 * N, d.channels,
                           cfg.model.tgt_vocab_size)).astype(np.float32)
    for t, i in eos_at:
        tab[t, N + i, 0, d.audio_eos_value] = 8.0
        tab[t, i, 0, d.audio_eos_value] = -8.0
    return tab


def _template(cfg, prompt_len, seed):
    d = cfg.data
    codes = None
    if prompt_len:
        codes = np.random.default_rng(seed).integers(0, 1024, (prompt_len, d.channels))
    delayed, prefill_step = prepare_audio_prompt(cfg, codes)
    buf = np.full((d.audio_length, d.channels), -1, np.int32)
    buf[: delayed.shape[0]] = delayed[: d.audio_length]
    return buf, prefill_step


class _Lanes:
    """The same lanes in both packages, stepped one segment at a time."""

    def __init__(self, monkeypatch, table):
        self.jcfg, self.cfg = tiny_test_config(), tcfg.tiny_test_config()
        d = self.cfg.data
        self.T, self.max_delay = d.audio_length, d.max_delay
        tab_j, tab_t = jnp.asarray(table), torch.from_numpy(table)
        rows = np.arange(2 * N)

        def jax_step(params, config, tgt, position, write_slot, cache, cross, mask, dtype,
                     **kw):
            return tab_j[write_slot + 1, rows][:, None], cache

        def port_step(params, config, tgt, position, write_slot, self_cache, cross, ends,
                      dtype, valid_from=None):
            return tab_t[write_slot + 1, torch.from_numpy(rows)][:, None]

        monkeypatch.setattr(jcb, "decode_step_scan", jax_step)
        self.j = list(jcb.cb_init(self.jcfg, N, self.T, S, "float32", False))
        params = tdia.init_params(self.cfg, device="cpu")
        state, cache, cross, ends = tcb.cb_init(params, self.cfg, N, self.T, S, torch.float32,
                                                False, "cpu")
        self.t = state
        self.cache, self.cross, self.ends = cache, cross, ends
        gens = [torch.Generator().manual_seed(i) for i in range(N)]

        def body():
            tgen.loop_step(state, port_step, {}, self.cfg, cache, cross, ends, TOP_K, gens,
                           torch.float32)

        self.body = body
        self.admitted: dict[int, int] = {}  # slot → prefill step

    def admit(self, slot, prompt_len, cap, seed):
        tokens, p = _template(self.cfg, prompt_len, seed)
        dec = self.cfg.model.decoder
        zeros = np.zeros((dec.n_layer, 2, self.T, dec.kv_heads, dec.gqa_head_dim), np.float32)
        czeros = np.zeros((dec.n_layer, 2, S, dec.cross_query_heads, dec.cross_head_dim),
                          np.float32)
        state, cross, mask = self.j
        self.j = list(jcb.swap_in.__wrapped__(
            state, cross, mask, jnp.int32(slot), jnp.asarray(tokens),
            jdia.KVCache(k=jnp.asarray(zeros), v=jnp.asarray(zeros)),
            jdia.KVCache(k=jnp.asarray(czeros), v=jnp.asarray(czeros)),
            jnp.ones((2, 1, 1, S), bool), jax.random.PRNGKey(seed),
            jnp.asarray([p, cap], jnp.int32), jnp.asarray([CFG_SCALE, 0.0, TOP_P], jnp.float32),
            jnp.asarray(True), max_delay=self.max_delay))
        lane = tcb.Prepared(tokens, p, tdia.KVCache(k=_t(zeros), v=_t(zeros)),
                            tdia.KVCache(k=_t(czeros), v=_t(czeros)),
                            torch.tensor([0, S], dtype=torch.int32))
        tcb.swap_in(self.t, self.cache, self.cross, self.ends, slot, lane, cap, CFG_SCALE, 0.0,
                    TOP_P, self.max_delay)
        self.admitted[slot] = p

    def segment(self, steps):
        state, cross, mask = self.j
        self.j[0] = jcb.cb_segment.__wrapped__({}, self.jcfg, state, cross, mask,
                                                jnp.int32(steps), TOP_K, "float32")
        tcb.cb_segment(self.t, self.body, tgen.LoopBuffers(), GenerationStats(), steps)

    def check(self):
        js = self.j[0]
        j_tokens, j_step, j_stop = (np.asarray(a) for a in (js.tokens, js.dec_step, js.stop))
        t_tokens = self.t.tokens.numpy()
        for slot in range(N):
            np.testing.assert_array_equal(t_tokens[slot], j_tokens[slot], err_msg=f"lane {slot}")
            assert bool(self.t.stopped[slot]) == bool(j_stop[slot]), slot
            if slot in self.admitted:
                assert int(self.t.final_step[slot]) == int(j_step[slot]), slot
        return j_stop.astype(bool)


# (name, EOS (row, lane) pairs, [(slot, prompt frames, cap, admitted before segment k)])
SCRIPTS = [
    ("eos_staggered", [(30, 0), (45, 1), (60, 2)],
     [(0, 0, 128, 0), (1, 20, 128, 0), (2, 5, 90, 2)]),
    ("caps_bos_and_reuse", [(25, 1)],
     [(0, 40, 50, 0), (1, 0, 128, 0), (2, 0, 70, 3), (1, 10, 128, 8)]),
]


@pytest.mark.parametrize("name,eos_at,admissions", SCRIPTS, ids=[s[0] for s in SCRIPTS])
def test_lanes_body_equals_jax_cb_segment(monkeypatch, name, eos_at, admissions):
    lanes = _Lanes(monkeypatch, _table(tcfg.tiny_test_config(), len(name), eos_at))
    pending = sorted(admissions, key=lambda a: a[3])
    k, reused = 0, False
    while pending or not lanes.check().all():
        stop = lanes.check()
        while pending and pending[0][3] <= k:
            slot, prompt, cap, _ = pending.pop(0)
            reused |= slot in lanes.admitted
            if slot in lanes.admitted and not stop[slot]:
                pending.insert(0, (slot, prompt, cap, k + 1))  # the slot is still busy
                break
            lanes.admit(slot, prompt, cap, seed=slot + k)
        lanes.segment(8)
        k += 1
        assert k < 64
    assert lanes.check().all()
    for slot, p in lanes.admitted.items():  # every lane generated rows
        assert int(lanes.t.final_step[slot]) >= p
    if name == "caps_bos_and_reuse":
        assert reused
    # steps after every lane stopped change nothing
    before = [x.clone() for x in lanes.t]
    for _ in range(tgen.GRAPH_STEPS):
        lanes.body()
    for field, a, b in zip(lanes.t._fields, before, lanes.t):
        assert torch.equal(a, b), field


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
def test_decode_step_per_row_slots_match_jax_scan(tiny_models, kv):
    """Two streams (rows [uncond × 2; cond × 2]) at slots 7 and 23: each row
    attends its own prefix and commits at its own slot."""
    jcfg, jp, cfg, params = tiny_models
    rng = np.random.default_rng(43)
    B = 4
    ids = rng.integers(1, 200, (B, cfg.data.text_length)).astype(np.int32)
    ids[:2, :] = 0  # the CFG unconditional rows
    ids[2, 60:] = 0
    ids[3, 90:] = 0
    js = jax_encoder_state(jcfg, jnp.asarray(ids))
    j_enc = jdia.encoder_forward(jp, jcfg, jnp.asarray(ids), js.positions, js.attn_mask)
    j_cross = jdia.precompute_cross_cache(jp, jcfg, j_enc, js.positions)
    t_cross = tdia.KVCache(k=_t(j_cross.k), v=_t(j_cross.v))
    dec = cfg.model.decoder
    T = 40
    slots = np.asarray([7, 23, 7, 23], np.int32)
    shape = (dec.n_layer, B, T, dec.kv_heads, dec.gqa_head_dim)
    k0, v0 = (rng.normal(size=shape).astype(np.float32) for _ in range(2))
    j_cache = jdia.KVCache(k=jnp.asarray(k0), v=jnp.asarray(v0))
    if kv == "int8":
        j_cache, j_cross = _quantized(j_cache), _quantized(j_cross)
        t_cross = tdia.QuantKVCache(*(_t(a) for a in j_cross))
    tok = rng.integers(0, 1024, (B, 1, 9)).astype(np.int32)
    pos = (slots + 1)[:, None]
    ref, ref_cache = jdia.decode_step_scan(jp, jcfg, jnp.asarray(tok), jnp.asarray(pos),
                                           jnp.asarray(slots), j_cache, j_cross,
                                           jax_cross_mask(js.padding_mask))
    ends = ends_from_padding_mask(cross_attention_mask(new_encoder_state(
        cfg, torch.from_numpy(ids)).padding_mask))
    cache = type(t_cross)(*(_t(a) for a in j_cache))
    out = tdia.decode_step(params, cfg, _t(tok), _t(pos).long(), _t(slots), cache, t_cross, ends)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0, atol=1e-4)
    # each row alone at its slot: the same logits (rows do not see each other's slots)
    for b in range(B):
        alone = type(t_cross)(*(_t(a)[:, b:b + 1] for a in j_cache))
        one = tdia.decode_step(params, cfg, _t(tok[b:b + 1]), _t(pos[b:b + 1]).long(),
                               int(slots[b]), alone, type(t_cross)(*(x[:, b:b + 1]
                                                                     for x in t_cross)),
                               ends[b:b + 1])
        np.testing.assert_allclose(one.numpy(), out[b:b + 1].numpy(), rtol=0, atol=1e-5)
    tols = [(0, 1e-4)] * 2 if kv == "float" else [(0, 1)] * 2 + [(1e-5, 0)] * 2
    for a, r, (rtol, atol) in zip(cache, ref_cache, tols):
        r = np.asarray(r)
        for b in range(B):
            s = slots[b]
            np.testing.assert_allclose(a[:, b, s].float().numpy(), r[:, b, s].astype(np.float32),
                                       rtol=rtol, atol=atol)
            untouched = np.arange(T) != s
            assert torch.equal(a[:, b, untouched], _t(r)[:, b, untouched])


def test_write_slots_and_commit_forms():
    """An int, a [1] and a [B] write slot give one slot a row and ``_commit``'s
    flat indices ``b * cache_len + slot[b]``; a slot count other than the
    rows raises.  The commit writes each row at its own slot and nothing
    else, every layer at once or one layer, and raises on a cache whose row
    and slot axes do not merge, where a flattened copy would take the write."""
    for ws in (5, torch.tensor([5]), torch.tensor([5, 5, 5])):
        slots, flat = tdia.write_slots(ws, 3, 8, "cpu")
        assert slots.tolist() == [5, 5, 5] and flat.tolist() == [5, 13, 21]
    slots, flat = tdia.write_slots(torch.tensor([1, 7, 0]), 3, 8, "cpu")
    assert slots.tolist() == [1, 7, 0] and flat.tolist() == [1, 15, 16]
    with pytest.raises(ValueError, match="2 slots for 3 rows"):
        tdia.write_slots(torch.tensor([1, 2]), 3, 8, "cpu")

    cache = tdia.KVCache(k=torch.zeros(2, 3, 8, 1, 4), v=torch.zeros(2, 3, 8, 1, 4))
    new = 1.0 + torch.arange(2 * 3 * 4, dtype=torch.float32).reshape(2, 3, 1, 4)
    tdia._commit(cache, None, flat, new, -new)  # every layer
    tdia._commit(cache, 1, flat, 2 * new[1], -2 * new[1])  # layer 1 again
    want = torch.zeros_like(cache.k)
    for b, s in enumerate([1, 7, 0]):
        want[:, b, s] = new[:, b]
        want[1, b, s] = 2 * new[1, b]
    assert torch.equal(cache.k, want) and torch.equal(cache.v, -want)

    apart = torch.zeros(2, 8, 3, 1, 4).transpose(1, 2)  # [L, B, T, ...], rows and slots apart
    with pytest.raises(RuntimeError, match="view"):
        tdia._commit(tdia.KVCache(k=apart, v=apart.clone()), 0, flat, new[0], new[0])
