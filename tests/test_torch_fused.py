"""The port's fused whole-decoder-step slice against the JAX package's, on the CPU.

* ``repack_decoder_fused``: values and scales equal the JAX repack's byte
  for byte (int8, and int4 MLP paired in 4 and 2 tiles), and
  ``params_from_jax`` carries a JAX pack across unchanged.
* ``fused_decode_step_plain`` against JAX ``fused_step_reference`` and the
  Pallas kernel in interpret mode, on the same pack bytes, at 2e-2 (the JAX
  package's own kernel-vs-reference gate, tests/test_fused_step.py:46).
  Cause: both sides round ``xn``, ``sa``, ``ca`` and ``h`` to bf16 before
  their dots, and fp32 sums taken in another order can put a value on the
  other side of a bf16 rounding step; the port's int8 ``wm`` also takes its
  scales after the whole sum, as the kernel does, where the reference scales
  each tile.  A row with ``cross_ends == 0`` gets exact zeros from
  cross-attention, and NaN in what it must not read changes nothing.
* ``models.dia.decode_step_fused`` against JAX ``decode_step_fused``
  (``DIA_FUSED_INTERPRET=1``): logits and the committed caches.
* The slice: greedy generation of ``Dia.quantize_int8(fused=True)`` against
  the JAX package's fused generation (``DIA_FUSED=1``) on ``trained_small``,
  with int8 and float caches, the int4 MLP, and two batched streams with
  voice prompts of different lengths.  Run side by side, the port's loop on
  the JAX step's logits gives the JAX codes exactly, and at every step of
  that run the port's logits lie within 2e-2 of the largest |JAX logit|
  (measured: at most 0.5%); the port's own run
  gives them up to the first step where the two steps' picks part, and there
  the margin is a near tie (measured 0.029, 0.022, 0.061 and 0.00014 of a
  guided logit): fp32 sums in another order, put on the other side of one of
  each layer's four bf16 rounding points or of an int8 K/V code, move later
  logits by up to ~0.03, so exact codes over a whole run are out of reach of
  any second implementation, the Pallas kernel's own eager and compiled
  forms included.
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
from dia_tts_prune_tpu.ops import quant as jq
from dia_tts_prune_tpu.ops.kernels import fused_step as jfs
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.generate import step_function
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops import quant as tq
from dia_tts_prune_tpu_torch.ops.kernels import fused_step as tfs
from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

SMALL = Path(__file__).parent / "fixtures" / "trained_small"
TOL = 2e-2  # the JAX kernel-vs-reference gate; cause in the module docstring
PACKS = [(False, 4), (True, 4), (True, 2)]  # (mlp_int4, mlp_tiles)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def _carry(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _carry_pack(jpack):
    return _carry({"decoder": {"fused_pack": jpack}})["decoder"]["fused_pack"]


@pytest.fixture(scope="module", autouse=True)
def _no_traces_across_files():
    """JAX's generate functions bake ``DIA_*`` variables into the traces they
    keep (ROADMAP C): start and leave this file with none kept."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_test_config()
    return jcfg, jdia.init_params(jcfg, jax.random.PRNGKey(0)), tcfg.tiny_test_config()


@pytest.fixture(scope="module")
def small():
    jd = JaxDia.from_pretrained(str(SMALL))
    return jd.config, jd.params, tcfg.DiaConfig.load(SMALL / "config.json")


def _fix_jax_int4_tiling(monkeypatch):
    """JAX ``decode_step_fused`` (models/dia.py:920) derives the int4 MLP
    tiling as ``sm.shape[1] // 2``, from an older ``[L, 2*MT, D]`` scale
    layout; its packs now hold ``[L, MT, 2, D]``, so it asserts on every int4
    pack (ROADMAP C).  Route its kernel call with the pack's own tiling."""
    real = jfs.fused_decode_step

    def fixed(pack, *args, **kw):
        if pack.mlp_int4:
            kw["mlp_tiles"] = pack.sm.shape[1]
        return real(pack, *args, **kw)

    monkeypatch.setattr(jfs, "fused_decode_step", fixed)


def _jpack(jp, mlp_int4, mlp_tiles):
    return jfs.repack_decoder_fused(jp, mlp_int4=mlp_int4, mlp_tiles=mlp_tiles)


# ---------------------------------------------------------------------------
# the pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mlp_int4,mlp_tiles", PACKS)
@pytest.mark.parametrize("which", ["tiny", "small"])
def test_repack_is_byte_identical(tiny, small, which, mlp_int4, mlp_tiles):
    _, jp, _ = tiny if which == "tiny" else small
    ref = _jpack(jp, mlp_int4, mlp_tiles)
    out = tfs.repack_decoder_fused(_carry(jp), mlp_int4=mlp_int4, mlp_tiles=mlp_tiles)
    assert out.mlp_int4 == ref.mlp_int4 == mlp_int4
    for a, b in zip(out[:14], ref[:14]):
        _same(a.numpy(), b)
    assert out.jq is None and out.jk is None  # the TPU kernel's RoPE matrices: not kept
    if mlp_int4:
        assert out.mlp_tiles == mlp_tiles and tuple(out.sm.shape[1:3]) == (mlp_tiles, 2)


def test_packer_builds_the_pack_on_request(small, monkeypatch):
    """``quantize_params_int8_packed(fused=True)`` adds the JAX packer's pack
    (byte-equal, int8 and int4 MLP); the default adds none; a JAX-packed tree
    carries its pack over through ``params_from_jax``."""
    _, jp, _ = small
    port = _carry(jp)
    assert "fused_pack" not in tq.quantize_params_int8_packed(port)["decoder"]
    for int4 in (False, True):
        monkeypatch.setenv("DIA_FUSED_INT4", "1" if int4 else "0")
        ref = jq.quantize_params_int8_packed(jp)["decoder"]["fused_pack"]
        out = tq.quantize_params_int8_packed(port, fused=True, fused_mlp_int4=int4)
        carried = _carry(jq.quantize_params_int8_packed(jp))["decoder"]["fused_pack"]
        for a, c, b in zip(out["decoder"]["fused_pack"][:14], carried[:14], ref[:14]):
            _same(a.numpy(), b)
            _same(c.numpy(), b)
        assert isinstance(carried, tfs.FusedPack) and carried.jq is None
        assert isinstance(out["decoder"]["layers"]["mlp"]["wo"]["kernel"], tq.QuantizedKernel)
    # its 16 arrays as a plain tuple carry over too
    tree = jax.tree.map(np.asarray, jq.quantize_params_int8_packed(jp))
    tree["decoder"]["fused_pack"] = tuple(tree["decoder"]["fused_pack"])
    plain = params_from_jax(tree, device="cpu")["decoder"]["fused_pack"]
    _same(plain.wm.numpy(), np.asarray(tree["decoder"]["fused_pack"][12]))


def test_block_sparse_decoder_gets_no_pack():
    """A pruned, block-sparse decoder no longer holds the float weights the
    pack folds norm gains into: no pack, and the loop keeps ``decode_step``."""
    from dia_tts_prune_tpu_torch import prune as tprune

    dia = Dia.from_pretrained(SMALL, device="cpu")
    dia._set_params(tprune.apply_masks(
        dia.params, tprune.block_masks(dia.params, 0.5, block=(32, 64), scope="module")))
    dia.sparsify_block((32, 64))
    dia.quantize_int8(fused=True)
    assert "fused_pack" not in dia.params["decoder"]
    assert step_function(dia.params) is tdia.decode_step


# ---------------------------------------------------------------------------
# the plain version against the JAX reference and the interpret-mode kernel
# ---------------------------------------------------------------------------

CASES = {  # name: (cache kind, mlp_int4, per-row positions and valid_from, mlp_tiles)
    "f32": ("f32", False, False, 4),
    "bf16": ("bf16", False, False, 4),
    "int8": ("int8", False, False, 4),
    "int4_mlp": ("f32", True, False, 4),
    "int4_mlp_int8_rows": ("int8", True, True, 4),
    "rows": ("f32", False, True, 4),
    "bf16_rows": ("bf16", False, True, 4),
    "int4_mlp_2_tiles": ("f32", True, False, 2),
    "int4_mlp_2_tiles_bf16_rows": ("bf16", True, True, 2),
}


def _step_inputs(jcfg, kind, rows, seed):
    """Caches, x, positions, windows for 3 rows: row 0 reads no text keys."""
    d = jcfg.model.decoder
    L, B, T, S = d.n_layer, 3, 64, 32
    Nkv, H, Ncq = d.kv_heads, d.gqa_head_dim, d.cross_query_heads
    rng = np.random.default_rng(seed)
    caches = [rng.standard_normal(s).astype(np.float32)
              for s in [(L, B, T, Nkv, H)] * 2 + [(L, B, S, Ncq, H)] * 2]
    inp = dict(x=rng.standard_normal((B, d.n_embd)).astype(np.float32),
               pos=np.asarray([17, 9, 12] if rows else [17] * 3, np.int32),
               vf=np.asarray([0, 7, 3] if rows else [0] * 3, np.int32),
               ends=np.asarray([0, 32, 25], np.int32), ws=16, scales=None)
    if kind == "int8":
        q = [jdia.quantize_kv(jnp.asarray(c)) for c in caches]
        caches = [np.asarray(c) for c, _ in q]
        inp["scales"] = [np.asarray(s) for _, s in q]
    elif kind == "bf16":
        caches = [np.asarray(jnp.asarray(c, jnp.bfloat16)) for c in caches]
    inp["caches"] = caches
    return inp


def _jax_args(jcfg, inp):
    m = jcfg.model
    S = inp["caches"][2].shape[2]
    kw = dict(position=jnp.asarray(inp["pos"]), write_slot=jnp.int32(inp["ws"]),
              self_k=jnp.asarray(inp["caches"][0]), self_v=jnp.asarray(inp["caches"][1]),
              cross_k=jnp.asarray(inp["caches"][2]), cross_v=jnp.asarray(inp["caches"][3]),
              cross_mask=jnp.arange(S)[None, :] < jnp.asarray(inp["ends"])[:, None],
              eps=m.normalization_layer_epsilon, rope_min=m.rope_min_timescale,
              rope_max=m.rope_max_timescale, valid_from=jnp.asarray(inp["vf"]))
    if inp["scales"] is not None:
        kw.update({k: jnp.asarray(s) for k, s in
                   zip(("self_ks", "self_vs", "cross_ks", "cross_vs"), inp["scales"])})
    return kw


def _port_step(pack, jcfg, inp, caches=None):
    m = jcfg.model
    caches = inp["caches"] if caches is None else caches
    tc = [_t(np.asarray(c, np.float32)).to(torch.bfloat16) if str(c.dtype) == "bfloat16"
          else _t(c) for c in caches]
    scales = [None] * 4 if inp["scales"] is None else [_t(s) for s in inp["scales"]]
    return tfs.fused_decode_step(pack, _t(inp["x"]), _t(inp["pos"]), inp["ws"], *tc,
                                 _t(inp["ends"]), m.normalization_layer_epsilon,
                                 m.rope_min_timescale, m.rope_max_timescale, _t(inp["vf"]),
                                 *scales)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_reference_and_kernel(tiny, case):
    jcfg, jp, _ = tiny
    kind, int4, rows, tiles = CASES[case]
    jpack = _jpack(jp, int4, tiles)
    pack = _carry_pack(jpack)
    inp = _step_inputs(jcfg, kind, rows, seed=len(case))
    kw = _jax_args(jcfg, inp)
    x = jnp.asarray(inp["x"])
    ref = jfs.fused_step_reference(jpack, x, **kw)
    kern = jfs.fused_decode_step(jpack, x, **kw, mlp_tiles=tiles, interpret=True)
    out = _port_step(pack, jcfg, inp)
    want_dt = torch.float32 if kind in ("f32", "int8") else torch.bfloat16
    assert out[1].dtype == out[2].dtype == want_dt and out[0].dtype == torch.float32
    for o, r, k in zip(out, ref, kern):
        _close(o.float().numpy(), r)
        _close(o.float().numpy(), k)
    assert np.abs(np.asarray(ref[0])).max() > 0.5  # the outputs are not trivially small


def test_rowless_cross_is_exact_zero_and_unread(tiny):
    """Row 0 (``cross_ends == 0``) reads no text keys: NaN in its cross
    cache and scales, and NaN in every self slot outside [valid_from,
    write_slot), leave every output bit-identical; and its cross-attention
    adds exact zeros (the same outputs as with any other cross cache)."""
    jcfg, jp, _ = tiny
    pack = tfs.repack_decoder_fused(_carry(jp))
    for kind in ("f32", "int8"):
        inp = _step_inputs(jcfg, kind, True, seed=7)
        base = _port_step(pack, jcfg, inp)
        poisoned = [np.array(c) for c in inp["caches"]]
        scales = None if inp["scales"] is None else [np.array(s) for s in inp["scales"]]
        T = poisoned[0].shape[2]
        for b in range(3):
            out_slots = (np.arange(T) < inp["vf"][b]) | (np.arange(T) >= inp["ws"])
            for i in (0, 1):
                if kind == "int8":
                    scales[i][:, b, out_slots] = np.nan
                else:
                    poisoned[i][:, b, out_slots] = np.nan
        if kind == "int8":
            scales[2][:, 0] = np.nan
            scales[3][:, 0] = np.nan
            poisoned[2][:, 0] = 127
        else:
            poisoned[2][:, 0] = np.nan
            poisoned[3][:, 0] = np.nan
        got = _port_step(pack, jcfg, dict(inp, scales=scales), poisoned)
        for a, b in zip(got, base):
            _same(a.numpy(), b.numpy())
    # exact zeros: the row's x equals a run whose cross projection of that row
    # meets an all-zero attention output (wco applied to zeros adds nothing)
    inp = _step_inputs(jcfg, "f32", False, seed=8)
    other = [np.array(c) for c in inp["caches"]]
    other[2][:, 0] = 5.0
    other[3][:, 0] = -3.0
    a, b = _port_step(pack, jcfg, inp), _port_step(pack, jcfg, inp, other)
    _same(a[0].numpy(), b[0].numpy())


# ---------------------------------------------------------------------------
# the model step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("mlp_int4", [False, True])
def test_decode_step_fused_matches_jax(tiny, monkeypatch, mlp_int4, kv_int8):
    """Two steps with per-row windows: logits and the slot each step commits."""
    jcfg, jp, cfg = tiny
    monkeypatch.setenv("DIA_FUSED_INTERPRET", "1")
    monkeypatch.setenv("DIA_FUSED_INT4", "1" if mlp_int4 else "0")
    _fix_jax_int4_tiling(monkeypatch)
    jparams = jq.quantize_params_int8_packed(jp)
    params = _carry(jparams)
    assert params["decoder"]["fused_pack"].mlp_int4 == mlp_int4
    assert step_function(params) is tdia.decode_step_fused
    inp = _step_inputs(jcfg, "int8" if kv_int8 else "f32", True, seed=11)
    if kv_int8:
        j_self = jdia.QuantKVCache(*(jnp.asarray(a) for a in
                                     (inp["caches"][0], inp["caches"][1], *inp["scales"][:2])))
        j_cross = jdia.QuantKVCache(*(jnp.asarray(a) for a in
                                      (inp["caches"][2], inp["caches"][3], *inp["scales"][2:])))
        t_self = tdia.QuantKVCache(*(_t(a) for a in
                                     (inp["caches"][0], inp["caches"][1], *inp["scales"][:2])))
        t_cross = tdia.QuantKVCache(*(_t(a) for a in
                                      (inp["caches"][2], inp["caches"][3], *inp["scales"][2:])))
    else:
        j_self = jdia.KVCache(jnp.asarray(inp["caches"][0]), jnp.asarray(inp["caches"][1]))
        j_cross = jdia.KVCache(jnp.asarray(inp["caches"][2]), jnp.asarray(inp["caches"][3]))
        t_self = tdia.KVCache(_t(inp["caches"][0]), _t(inp["caches"][1]))
        t_cross = tdia.KVCache(_t(inp["caches"][2]), _t(inp["caches"][3]))
    S = inp["caches"][2].shape[2]
    mask = (jnp.arange(S)[None, :] < jnp.asarray(inp["ends"])[:, None])[:, None, None, :]
    rng = np.random.default_rng(12)
    for step in range(2):
        ws = inp["ws"] + step
        tok = rng.integers(0, 1024, (3, 1, 9)).astype(np.int32)
        pos = (inp["pos"] + step)[:, None]
        j_logits, j_self = jdia.decode_step_fused(
            jparams, jcfg, jnp.asarray(tok), jnp.asarray(pos), jnp.int32(ws), j_self, j_cross,
            mask, valid_from=jnp.asarray(inp["vf"]))
        logits = tdia.decode_step_fused(params, cfg, _t(tok), _t(pos), ws, t_self, t_cross,
                                        _t(inp["ends"]), valid_from=_t(inp["vf"]))
        _close(logits.numpy(), j_logits)
        for name in ("k", "v"):
            a, b = getattr(t_self, name)[:, :, ws], np.asarray(getattr(j_self, name))[:, :, ws]
            if kv_int8:  # compared dequantized, to one quantization step
                sa = getattr(t_self, name + "s")[:, :, ws]
                sb = np.asarray(getattr(j_self, name + "s"))[:, :, ws]
                np.testing.assert_allclose((a.float() * sa[..., None]).numpy(),
                                           b.astype(np.float32) * sb[..., None],
                                           rtol=TOL, atol=TOL + float(sb.max()))
            else:
                _close(a.numpy(), b)
    # nothing but slot `ws` of each step changed
    _same(t_self.k[:, :, : inp["ws"]].numpy(), np.asarray(j_self.k)[:, :, : inp["ws"]])


# ---------------------------------------------------------------------------
# the slice: greedy codes equal the JAX package's fused generation
# ---------------------------------------------------------------------------

TEXT = "[S1] The birch canoe slid. [S2]"
NEAR_TIE = 0.1  # guided-logit margin at which two correct runs may part


def _jax_driven(monkeypatch, jd):
    """Run the port's generation loop with the JAX package's fused step
    beside the port's: conditioning, caches, prefill and every decode step
    run in both packages, each on its own caches, and the loop continues on
    the JAX logits.  Returns per step (the port's guided logits [N, C, V],
    its argmax, the JAX argmax, the port's raw logits, the JAX raw logits)."""
    from dia_tts_prune_tpu import generate as jgen
    from dia_tts_prune_tpu_torch import generate as tgen
    from dia_tts_prune_tpu_torch.ops.sampling import apply_constraints, cfg_combine

    jcfg = jd.config
    st: dict = {}
    records = []
    # compiled as the JAX generate compiles it: eager op-by-op XLA rounds
    # some fp32 sums otherwise, enough to part at a near tie
    jax_step = jax.jit(lambda params, *a, **k: jdia.decode_step_fused(params, jcfg, *a, **k),
                       static_argnames=("skip_uncond_cross",))

    def conditioning(params, config, enc_input, dtype, window):
        st["cross"], st["mask"], st["pad"] = jax.jit(jgen._conditioning, static_argnums=(
            1, 3, 4))(jd.params, jcfg, jnp.asarray(enc_input.numpy()), jnp.float32, window)
        return real["conditioning"](params, config, enc_input, dtype, window)

    def conditioning_batch(params, config, conds, dtype, device):
        # the port conditions each stream alone (through ``conditioning``
        # above); the JAX package all streams at once, rows [uncond × N; cond × N]
        out = real["conditioning_batch"](params, config, conds, dtype, device)
        enc = np.concatenate([np.stack([c[0] for c in conds]), np.stack([c[1] for c in conds])])
        st["cross"], st["mask"], st["pad"] = jax.jit(jgen._conditioning, static_argnums=(
            1, 3, 4))(jd.params, jcfg, jnp.asarray(enc), jnp.float32,
                      tgen._cross_window_for(enc, config))
        return out

    def new_self_cache(config, batch, max_len, dtype, device, quant):
        st["self"] = jdia.new_self_cache(jcfg, batch, max_len, quant=quant)
        return real["new_self_cache"](config, batch, max_len, dtype, device, quant=quant)

    def run_prefill(params, config, buf, window, offsets, steps, cross, pad, cache, dtype):
        st["self"] = jax.jit(jgen._run_prefill, static_argnums=(1, 3, 10))(
                                       jd.params, jcfg, jnp.asarray(buf), window,
                                       jnp.asarray(offsets, jnp.int32),
                                       jnp.asarray(steps, jnp.int32), st["cross"], st["mask"],
                                       st["pad"], st["self"], jnp.float32)
        return real["run_prefill"](params, config, buf, window, offsets, steps, cross, pad,
                                   cache, dtype)

    def quantize_cache(cache):
        st["cross"] = jax.jit(jgen._quantize_cross, static_argnums=1)(st["cross"], True)
        return real["quantize_cache"](cache)

    def step(params, config, tgt, position, ws, self_cache, cross_cache, ends, dtype,
             valid_from=None):
        logits = tdia.decode_step_fused(params, config, tgt, position, ws, self_cache,
                                        cross_cache, ends, dtype, valid_from=valid_from)
        vf = None if valid_from is None else jnp.asarray(valid_from.numpy())
        j_logits, st["self"] = jax_step(
            jd.params, jnp.asarray(tgt.numpy()), jnp.asarray(position.numpy(), jnp.int32),
            jnp.int32(int(ws)), st["self"], st["cross"], st["mask"], valid_from=vf,
            skip_uncond_cross=True)
        j_logits = _t(j_logits)
        d = config.data
        n = logits.shape[0] // 2

        def guided(lg):
            return torch.stack([apply_constraints(cfg_combine(lg[[i, n + i], 0], 3.0),
                                                  d.audio_eos_value, d.audio_pad_value,
                                                  d.audio_bos_value) for i in range(n)])

        mine = guided(logits)
        records.append((mine, mine.argmax(-1), guided(j_logits).argmax(-1), logits, j_logits))
        return j_logits

    def decode_loop(params, config, buf, *args, **kw):
        st["template"], st["first_row"], st["batched"] = buf[None].copy(), args[3], False
        return real["decode_loop"](params, config, buf, *args, **kw)

    def decode_loop_batch(params, config, buf, *args, **kw):
        st["template"], st["first_row"], st["batched"] = buf.copy(), args[3], True
        return real["decode_loop_batch"](params, config, buf, *args, **kw)

    def forced(i, lane, c):
        """Whether iteration i wrote channel c of a lane from the delay
        template instead of the pick (the loops' BOS-window rule)."""
        max_delay = jd.config.data.max_delay
        first, tpl = st["first_row"], st["template"][lane]
        if st["batched"]:
            return i < max_delay - 1 and tpl[first + i, c] != -1
        w0 = min(first, tpl.shape[0] - max_delay)
        return max_delay - (i + 1) > 0 and tpl[w0 + i, c] != -1

    st["forced"] = forced
    real = {name: getattr(tgen, name) for name in
            ("conditioning", "conditioning_batch", "new_self_cache", "run_prefill",
             "quantize_cache", "decode_loop", "decode_loop_batch")}
    for name, fn in (("conditioning", conditioning), ("conditioning_batch", conditioning_batch),
                     ("new_self_cache", new_self_cache),
                     ("run_prefill", run_prefill), ("quantize_cache", quantize_cache),
                     ("decode_loop", decode_loop), ("decode_loop_batch", decode_loop_batch)):
        monkeypatch.setattr(tgen, name, fn)
    monkeypatch.setattr(tgen, "step_function", lambda params: step)
    return records, lambda i, lane, c: st["forced"](i, lane, c)


@pytest.fixture
def fresh_jax_traces():
    """The JAX generate functions read ``DIA_FUSED`` and ``DIA_KV_INT8`` while
    they trace and keep the executable for trees of the same shapes: clear
    the traces before and after, so that no other test in the process hands
    its variables to this one or takes this one's."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.usefixtures("fresh_jax_traces")
@pytest.mark.parametrize("mode", ["int8_kv", "float_kv", "int4_mlp", "batched"])
def test_fused_greedy_codes_match_jax(mode, monkeypatch):
    """Greedy generation of ``Dia.quantize_int8(fused=True)`` against the
    JAX fused generation (``DIA_FUSED=1``, the Pallas kernel in interpret
    mode) on the same pack bytes.  Both packages run side by side, the loop
    following the JAX logits, which gives the JAX ``generate``'s codes
    exactly (the port's loop is the JAX loop).  Then the port's own greedy
    run equals the JAX codes at every step before the first one where the
    two packages' picks parted in the side-by-side run (until then that run
    is the port's own run), and there the port's margin between the two
    picks is a near tie (module docstring)."""
    monkeypatch.setenv("DIA_FUSED", "1")
    monkeypatch.setenv("DIA_FUSED_INTERPRET", "1")
    monkeypatch.setenv("DIA_KV_INT8", "0" if mode == "float_kv" else "1")
    monkeypatch.setenv("DIA_FUSED_INT4", "1" if mode == "int4_mlp" else "0")
    _fix_jax_int4_tiling(monkeypatch)
    jd, dia = JaxDia.from_pretrained(str(SMALL)), Dia.from_pretrained(SMALL, device="cpu")
    jd.quantize_int8()
    dia.quantize_int8(fused=True, fused_mlp_int4=mode == "int4_mlp")
    for a, b in zip(dia.params["decoder"]["fused_pack"][:14],
                    jd.params["decoder"]["fused_pack"][:14]):
        _same(a.numpy(), b)
    delay = np.asarray(dia.config.data.delay_pattern)
    kw = dict(max_tokens=64, temperature=0.0)
    if mode == "batched":
        golden = np.load(SMALL / "golden.npz")["tokens"]
        texts = [TEXT, "[S2] Hello there, friend."]
        kw.update(audio_prompt_codes=[golden[:20], golden[50:90]],
                  audio_prompt_texts=["[S1] A voice.", "[S2] Another, longer voice prompt."])

        def run(d):
            return [np.asarray(c) for c in d.generator.generate_tokens_batch(texts, **kw)]
    else:
        def run(d):
            if d is jd:
                return [np.asarray(jd.generate_codes(TEXT, **kw))]
            return [dia.generator.generate_tokens(TEXT, kv_int8=mode != "float_kv", **kw)]
    ref = run(jd)
    reset_launch_counts()
    own = run(dia)
    with pytest.MonkeyPatch.context() as mp:
        records, forced = _jax_driven(mp, jd)
        driven = run(dia)
    for a, b in zip(driven, ref):  # the port's loop on the JAX logits: the JAX codes
        assert a.shape[0] > 0
        _same(a, b)
    # every step of the whole run, both packages on the same tokens: the
    # port's logits within TOL of the largest |JAX logit| (measured: at most
    # 0.5% of it, over runs of 43 to 63 steps)
    assert len(records) >= 40
    for t, (*_, mine, theirs) in enumerate(records):
        err = float((mine - theirs).abs().max())
        assert err <= TOL * float(theirs.abs().max()), (t, err)
    for lane, (a, b) in enumerate(zip(own, ref)):
        # until the port's own argmax parts from the JAX one, the side-by-side
        # run is the port's own run: the codes agree up to that step ...
        # (a pick counts where the loop writes it: not in the BOS window, and
        # only while the lane is still being written)
        def counts(t, c, lane=lane):
            return not forced(t, lane, c) and t - delay[c] < b.shape[0]

        parted = [t for t, (_, p, j, *_) in enumerate(records)
                  if any(counts(t, c) for c in np.flatnonzero((p[lane] != j[lane]).numpy()))]
        first = parted[0] if parted else len(records)
        steps = np.arange(b.shape[0])[:, None] + delay[None, :]  # loop step of each code
        n = min(a.shape[0], b.shape[0])
        assert a.shape == b.shape or parted
        keep = steps[:n] < first
        np.testing.assert_array_equal(a[:n][keep], b[:n][keep])
        if parted:  # ... and there the two picks are a near tie
            g, p, j, *_ = records[first]
            for c in np.flatnonzero((p[lane] != j[lane]).numpy()):
                if not counts(first, c):
                    continue
                margin = float(g[lane, c, p[lane, c]] - g[lane, c, j[lane, c]])
                assert 0 <= margin < NEAR_TIE, (lane, first, c, margin)
    counts = launch_counts()
    assert counts["fused_decode_step"] == 0  # CPU tensors: the plain version, not the kernel
    assert counts["decode_attention"] == 0 and counts["int8_matmul"] == 0


def test_wrapper_input_checks():
    """The CUDA path's checks, reached without a card: what the kernel does
    not take raises before any launch."""
    jcfg = tiny_test_config()
    pack = tfs.repack_decoder_fused(_carry(jdia.init_params(jcfg, jax.random.PRNGKey(0))))
    inp = _step_inputs(jcfg, "f32", False, seed=3)
    caches = [_t(c) for c in inp["caches"]]
    pos, ends, vf = (_t(inp[k]) for k in ("pos", "ends", "vf"))
    x = _t(inp["x"])
    ok = dict(pack=pack, x=x, position=pos, self_k=caches[0], self_v=caches[1],
              cross_k=caches[2], cross_v=caches[3], cross_ends=ends, valid_from=vf,
              scales=(None,) * 4)
    tfs._check(*ok.values())
    bad = [
        dict(self_k=caches[0].half()),
        dict(cross_v=caches[3].to(torch.bfloat16)),
        dict(scales=(torch.ones(1),) * 4),
        dict(position=pos.long()),
        dict(self_k=caches[0].transpose(3, 4)),
        dict(x=torch.zeros(17, x.shape[1])),
    ]
    for change in bad:
        with pytest.raises((TypeError, ValueError)):
            tfs._check(*dict(ok, **change).values())
