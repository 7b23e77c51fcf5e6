"""The port's pruned (block-sparse) serving path against the JAX package's, on
the CPU.

* Plans (``plan_block_sparsity``, ``sparse_kernel_from_weight``): indices,
  counts, density and values equal the JAX ones exactly — stacked and not,
  ragged edges, an all-zero N-tile, fully dense.
* The block-sparse matmul's plain version against the Pallas kernel run in
  interpret mode (as tests/test_kernels.py runs Pallas kernels): fp32 within
  1e-5 absolute on outputs of size ~1 (the port kernels' gate since their
  first slice; only fp32 summation order differs), bf16 within 2^-7 of the
  value plus that floor (both sides round an fp32 sum to bf16 once, half an
  ulp each).  Pallas interpret mode fills the out-of-bounds part of a ragged
  last K block with NaN, so for a K that is not a block multiple the JAX side
  gets x and w zero-padded to the next multiple — the same function.
  Poison: NaN in every unlisted block changes nothing.
* ``dense_general`` with a ``BlockSparseKernel`` against JAX
  ``_dense_general_sparse`` (its Pallas kernel in interpret mode) for every
  decoder site's kernel shape.
* Generation: greedy tokens of sparse trees equal the JAX package's; the
  packers leave a sparse decoder alone and its caches float.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.api import Dia as JaxDia
from dia_tts_prune_tpu.config import tiny_test_config
from dia_tts_prune_tpu.generate import DiaGenerator as JaxGenerator
from dia_tts_prune_tpu.models import dia as jdia
from dia_tts_prune_tpu.ops import modules as jmod
from dia_tts_prune_tpu.ops import sparse as js
from dia_tts_prune_tpu.ops.kernels import sparse_matmul as jsm
from dia_tts_prune_tpu import prune as jprune
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch import prune as tprune
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.generate import DiaGenerator, decoder_is_packed
from dia_tts_prune_tpu_torch.ops import sparse as ts
from dia_tts_prune_tpu_torch.ops.kernels import block_sparse_matmul, block_sparse_matmul_plain
from dia_tts_prune_tpu_torch.ops.kernels import sparse_matmul as tsm
from dia_tts_prune_tpu_torch.ops.modules import dense_general

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
BLOCK = (32, 64)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    """Exactly equal, dtype and shape included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _pruned_weight(rng, K, N, bk, bn, keep=0.5, zero_tile=True):
    """[K, N] fp32 ~N(0, 1/K) with about ``1 - keep`` of its blocks zeroed and,
    with ``zero_tile``, the whole first N-tile zeroed (a tile with count 0)."""
    w = (rng.normal(size=(K, N)) / np.sqrt(K)).astype(np.float32)
    kept = rng.random((-(-K // bk), -(-N // bn))) < keep
    kept[0, -1] = True  # the ragged corner block stays listed
    if zero_tile:
        kept[:, 0] = False
    return w * np.repeat(np.repeat(kept, bk, 0), bn, 1)[:K, :N]


# ---------------------------------------------------------------------------
# (a) plans
# ---------------------------------------------------------------------------

# (shape, n_in, stacked, block): a stacked projection, the stacked o_proj form,
# the logits head (ragged N), ragged K, blocks larger than the weight
PLAN_CASES = [((3, 64, 4, 16), 1, True, (32, 64)), ((3, 4, 16, 64), 2, True, (8, 16)),
              ((64, 9, 37), 1, False, (32, 64)), ((2, 100, 150), 1, True, (32, 64)),
              ((40, 37), 1, False, (256, 256))]


@pytest.mark.parametrize("shape,n_in,stacked,block", PLAN_CASES)
@pytest.mark.parametrize("kind", ["pruned", "dense", "zero"])
def test_sparse_kernel_from_weight_matches_jax(shape, n_in, stacked, block, kind):
    rng = np.random.default_rng(1)
    w = rng.normal(size=shape).astype(np.float32)
    if kind == "pruned":
        w[..., : shape[-1] // 2] = 0  # a zero N-tile or more
        w.reshape(-1)[: w.size // 3] = 0
    elif kind == "zero":
        w[:] = 0
    ref = js.sparse_kernel_from_weight(w, n_in, stacked, *block)
    out = ts.sparse_kernel_from_weight(_t(w), n_in, stacked, *block)
    for name in ("values", "indices", "counts"):
        _same(getattr(out, name), getattr(ref, name))
    assert (out.in_shape, out.out_shape, out.block_k, out.block_n) == (
        ref.in_shape, ref.out_shape, ref.block_k, ref.block_n)
    assert out.density == ref.density
    if stacked:  # one layer's slice keeps the metadata
        one = out[1]
        _same(one.indices, np.asarray(ref.indices)[1])
        assert one.in_shape == out.in_shape and one.values.dim() == 2


@pytest.mark.parametrize("K,N,bk,bn", [(96, 128, 32, 64), (100, 150, 32, 64), (40, 37, 8, 16)])
def test_plan_block_sparsity_matches_jax(K, N, bk, bn):
    w = _pruned_weight(np.random.default_rng(2), K, N, bk, bn)
    ref, out = jsm.plan_block_sparsity(w, bk, bn), tsm.plan_block_sparsity(_t(w), bk, bn)
    _same(out.indices, ref.indices)
    _same(out.counts, ref.counts)
    assert out.density == ref.density and (out.block_k, out.block_n) == (bk, bn)
    assert int(out.counts[0]) == 0


# ---------------------------------------------------------------------------
# (b) the kernel's function
# ---------------------------------------------------------------------------

MATMUL_SHAPES = [(96, 128, 32, 64), (100, 150, 32, 64), (40, 37, 8, 16)]


def _jax_matmul(x, w, plan, bk, bn):
    """JAX ``block_sparse_matmul`` in interpret mode, on inputs zero-padded to
    a K multiple of ``bk`` (the same function; see the module docstring)."""
    K = w.shape[0]
    pad = -K % bk
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (0, pad)))
    wp = jnp.pad(jnp.asarray(w), ((0, pad), (0, 0)))
    return np.asarray(jsm.block_sparse_matmul(xp, wp, jnp.asarray(plan.indices.numpy()),
                                              jnp.asarray(plan.counts.numpy()), block_k=bk,
                                              block_n=bn, interpret=True)).astype(np.float32)


@pytest.mark.parametrize("K,N,bk,bn", MATMUL_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 8, 70])
def test_plain_matches_pallas_fp32(K, N, bk, bn, M):
    rng = np.random.default_rng(3)
    w = _pruned_weight(rng, K, N, bk, bn)
    x = rng.normal(size=(M, K)).astype(np.float32)
    plan = tsm.plan_block_sparsity(_t(w), bk, bn)
    out = block_sparse_matmul(_t(x), _t(w), plan.indices, plan.counts, bk, bn)
    ref = _jax_matmul(x, w, plan, bk, bn)
    assert out.dtype == torch.float32 and out.shape == (M, N)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    assert (out[:, :bn] == 0).all()  # the tile with no listed block: exact zeros


@pytest.mark.parametrize("K,N,bk,bn", MATMUL_SHAPES)
def test_plain_matches_pallas_bf16(K, N, bk, bn):
    rng = np.random.default_rng(4)
    w = torch.from_numpy(_pruned_weight(rng, K, N, bk, bn)).bfloat16()
    x = torch.from_numpy(rng.normal(size=(8, K)).astype(np.float32)).bfloat16()
    plan = tsm.plan_block_sparsity(w, bk, bn)
    out = block_sparse_matmul_plain(x, w, plan.indices, plan.counts, bk, bn)
    to_jax = lambda a: jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    ref = _jax_matmul(to_jax(x), to_jax(w), plan, bk, bn)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-5)


@pytest.mark.parametrize("K,N,bk,bn", MATMUL_SHAPES)
def test_plain_reads_only_listed_blocks(K, N, bk, bn):
    """NaN in every unlisted block changes nothing; and a plan that leaves
    out a nonzero block gives another number (the stored zeros do not hide
    a plan error)."""
    rng = np.random.default_rng(5)
    w = _pruned_weight(rng, K, N, bk, bn)
    x = _t(rng.normal(size=(5, K)).astype(np.float32))
    plan = tsm.plan_block_sparsity(_t(w), bk, bn)
    clean = block_sparse_matmul_plain(x, _t(w), plan.indices, plan.counts, bk, bn)
    listed = tsm.listed_mask(plan.indices, plan.counts, K, N, bk, bn)
    poisoned = torch.where(listed, _t(w), float("nan"))
    out = block_sparse_matmul_plain(x, poisoned, plan.indices, plan.counts, bk, bn)
    assert torch.isfinite(out).all()
    assert torch.equal(out, clean)
    fewer = plan.counts.clone()
    j = int(torch.argmax(fewer))
    fewer[j] -= 1
    assert not torch.equal(block_sparse_matmul_plain(x, _t(w), plan.indices, fewer, bk, bn),
                           clean)


def test_launch_plan_ignores_row_count():
    """The split reads the weight's shape and plan only (a row's result must
    not depend on M), fills the card at the decode shapes, and fits the
    kernel's shared-memory slice."""
    import inspect

    assert "M" not in inspect.signature(tsm.split_plan).parameters
    for K, N in ((2048, 2048), (2048, 512), (2048, 16384), (8192, 2048), (2048, 9252)):
        for max_blocks in (K // 256 // 2, K // 256):
            n = tsm.split_plan(N, 256, 256, max_blocks, tsm.STRIP)
            assert -(-max_blocks * 256 // n) <= tsm.MAX_SLICE
            assert -(-N // 256) * 4 * n >= 132 or max_blocks * 256 // n <= tsm.MIN_SLICE * 2
    assert tsm.vector_width(torch.bfloat16, 2048, 16384, 256, 256, 0, 256) == 8
    assert tsm.vector_width(torch.bfloat16, 2048, 9252, 256, 256, 0, 256) == 4
    assert tsm.vector_width(torch.bfloat16, 2048, 16384, 256, 256, 0, 6) == 1
    assert tsm.vector_width(torch.bfloat16, 40, 37, 8, 16, 0, 0) == 1
    assert tsm.vector_width(torch.float32, 2048, 9252, 256, 256, 0, 0) == 1


def test_wrapper_input_checks():
    x, w = torch.zeros(2, 64), torch.zeros(64, 128)
    idx, cnt = torch.zeros(2, 1, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    tsm._check(x, w, idx, cnt, 32, 64)
    with pytest.raises(TypeError, match="same dtype"):
        tsm._check(x.bfloat16(), w, idx, cnt, 32, 64)
    with pytest.raises(TypeError, match="int32"):
        tsm._check(x, w, idx.long(), cnt, 32, 64)
    with pytest.raises(ValueError, match="plan"):
        tsm._check(x, w, idx, cnt, 32, 32)
    with pytest.raises(ValueError, match="shapes"):
        tsm._check(x[:, :32], w, idx, cnt, 32, 64)
    with pytest.raises(ValueError, match="contiguous"):
        tsm._check(x, torch.zeros(128, 64).t(), idx, cnt, 32, 64)
    with pytest.raises(ValueError, match="unsupported device"):
        block_sparse_matmul(x.to("meta"), w.to("meta"), idx.to("meta"), cnt.to("meta"), 32, 64)


# ---------------------------------------------------------------------------
# (c) dense_general and the packed tree
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_test_config()
    return jcfg, jdia.init_params(jcfg, jax.random.PRNGKey(0)), tcfg.tiny_test_config()


def _carry(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _sparse_pair(jp, scope, block=BLOCK):
    """(JAX sparse tree, the port's sparse tree built from the same weights)."""
    ref = js.sparsify_params_block(
        jprune.apply_masks(jp, jprune.block_masks(jp, 0.5, block=block, scope=scope)),
        block_k=block[0], block_n=block[1])
    tp = _carry(jp)
    out = ts.sparsify_params_block(
        tprune.apply_masks(tp, tprune.block_masks(tp, 0.5, block=block, scope=scope)),
        block_k=block[0], block_n=block[1])
    return ref, out


def _kernels(tree, path=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _kernels(v, path + (k,))
        elif k == "kernel":
            yield path, v


@pytest.mark.parametrize("scope", ["global", "module"])
def test_sparsified_tree_matches_jax(tiny, scope):
    """The port packs the same decoder kernels with the same plans; the
    encoder stays dense; ``params_from_jax`` carries a JAX-packed tree."""
    _, jp, _ = tiny
    ref, out = _sparse_pair(jp, scope)
    carried = _carry(ref)
    assert ts.sparsity_summary(out) == js.sparsity_summary(ref)
    assert not any(isinstance(k, ts.BlockSparseKernel) for _, k in _kernels(out["encoder"]))
    n = 0
    for (path, a), (_, b), (_, c) in zip(_kernels(out["decoder"]), _kernels(ref["decoder"]),
                                         _kernels(carried["decoder"])):
        assert isinstance(a, ts.BlockSparseKernel) and isinstance(c, ts.BlockSparseKernel), path
        for x in (a, c):
            for name in ("values", "indices", "counts"):
                _same(getattr(x, name), getattr(b, name))
            assert (x.in_shape, x.out_shape, x.block_k) == (b.in_shape, b.out_shape, b.block_k)
        n += 1
    assert n == 11
    if scope == "module":
        # every decoder kernel loses about half its blocks, except o_proj: its
        # blocks are ranked in a [Nq, H·D] view, whose zero slabs fill no
        # block of the kernel's [Nq·H, D] layout (prune.block_masks)
        for name, density in ts.sparsity_summary(out).items():
            assert density == 1.0 if "o_proj" in name else 0.3 < density < 0.7, (name, density)


SITES = [("layers", "self_attention", "q_proj"), ("layers", "self_attention", "k_proj"),
         ("layers", "self_attention", "o_proj"), ("layers", "cross_attention", "k_proj"),
         ("layers", "cross_attention", "o_proj"), ("layers", "mlp", "wi_fused"),
         ("layers", "mlp", "wo"), ("logits_dense",)]


@pytest.mark.parametrize("site", SITES, ids=lambda s: ".".join(s))
def test_dense_general_sparse_matches_jax(tiny, site, monkeypatch):
    _, jp, _ = tiny
    ref_tree, tree = _sparse_pair(jp, "module")
    a, b = tree["decoder"], ref_tree["decoder"]
    for k in site:
        a, b = a[k], b[k]
    a, b = a["kernel"], b["kernel"]
    if "layers" in site:
        a, b = a[1], jax.tree.map(lambda v: v[1], b)
    n_in = len(a.in_shape)
    axis = tuple(range(-n_in, 0))
    x = np.random.default_rng(6).normal(size=(2, 3, *a.in_shape)).astype(np.float32)
    monkeypatch.setenv("DIA_SPARSE_INTERPRET", "1")  # the JAX side's Pallas kernel
    ref = np.asarray(jmod.dense_general(jnp.asarray(x), b, axis))
    out = dense_general(_t(x), a, axis)
    assert out.shape == ref.shape == (2, 3, *a.out_shape)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="contraction axes"):
        dense_general(_t(x), a, (-1,) if n_in == 2 else (-2, -1))


# ---------------------------------------------------------------------------
# (d) generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scope", ["global", "module"])
def test_sparse_tiny_greedy_tokens_match_jax(tiny, scope):
    jcfg, jp, cfg = tiny
    ref_tree, tree = _sparse_pair(jp, scope)
    text = "[S1] sparse parity"
    ref = np.asarray(JaxGenerator(ref_tree, jcfg).generate_tokens(text, max_tokens=48,
                                                                  temperature=0.0))
    out = DiaGenerator(tree, cfg, device="cpu").generate_tokens(text, max_tokens=48,
                                                                temperature=0.0)
    assert out.shape[0] > 0
    np.testing.assert_array_equal(out, ref)


def test_fixture_prune_block_sparse_matches_jax():
    d = FIXTURES / "trained_small"
    jd, dia = JaxDia.from_pretrained(str(d)), Dia.from_pretrained(d, device="cpu")
    summary = dia.prune_block_sparse(0.5, BLOCK)
    assert summary == jd.prune_block_sparse(0.5, BLOCK)
    assert min(summary.values()) < 1.0 and dia.generator.params is dia.params
    kw = dict(max_tokens=96, temperature=0.0)
    text = "[S1] The birch canoe slid. [S2]"
    np.testing.assert_array_equal(dia.generate_codes(text, **kw),
                                  np.asarray(jd.generate_codes(text, **kw)))


def test_prune_block_sparse_per_module_scope(tiny):
    """``prune_block_sparse(scope="module")`` is ``block_masks(scope=
    "module")`` + ``apply_masks`` + ``sparsify_block``."""
    _, jp, cfg = tiny
    ref_tree, tree = _sparse_pair(jp, "module")
    dia = Dia(cfg, _carry(jp), device="cpu")
    assert dia.prune_block_sparse(0.5, BLOCK, scope="module") == js.sparsity_summary(ref_tree)
    for (_, a), (_, b) in zip(_kernels(dia.params["decoder"]), _kernels(tree["decoder"])):
        _same(a.values, b.values)
        _same(a.indices, b.indices)


def test_sparsify_block_equals_masked_dense(tiny):
    """``sparsify_block`` on pre-pruned weights prunes nothing more: its
    tokens equal the masked-dense run's, and its values are the dense
    kernels' own storage (a view: no second copy of the decoder)."""
    _, jp, cfg = tiny
    tp = _carry(jp)
    pruned = tprune.apply_masks(tp, tprune.block_masks(tp, 0.5, block=BLOCK, scope="module"))
    dia = Dia(cfg, pruned, device="cpu")
    text = "[S1] prepruned"
    dense = dia.generate_codes(text, max_tokens=40, temperature=0.0)
    summary = dia.sparsify_block(BLOCK)
    assert min(summary.values()) < 1.0
    wo = dia.params["decoder"]["layers"]["mlp"]["wo"]["kernel"]
    assert wo.values.data_ptr() == pruned["decoder"]["layers"]["mlp"]["wo"]["kernel"].data_ptr()
    np.testing.assert_array_equal(dia.generate_codes(text, max_tokens=40, temperature=0.0), dense)


def test_quantize_after_pruning_keeps_sparse_kernels(monkeypatch):
    """``quantize_int8`` / ``quantize_int4`` leave block-sparse kernels as
    they are, so the decoder stays unpacked and the caches float (the JAX
    package reads the same from ``mlp.wo``); greedy tokens equal JAX's."""
    import dia_tts_prune_tpu_torch.generate as tgen

    d = FIXTURES / "trained_small"
    jd, dia = JaxDia.from_pretrained(str(d)), Dia.from_pretrained(d, device="cpu")
    for m in (jd, dia):
        m.prune_block_sparse(0.5, BLOCK)
        m.quantize_int8()
    dia.quantize_int4()
    assert all(isinstance(k, ts.BlockSparseKernel) for _, k in _kernels(dia.params["decoder"]))
    assert not decoder_is_packed(dia.params)
    seen = []
    real = tgen.new_self_cache
    monkeypatch.setattr(tgen, "new_self_cache",
                        lambda *a, **kw: seen.append(kw.get("quant")) or real(*a, **kw))
    kw = dict(max_tokens=64, temperature=0.0)
    text = "[S1] Quantized after pruning."
    out = dia.generate_codes(text, **kw)
    assert seen == [False]
    np.testing.assert_array_equal(out, np.asarray(jd.generate_codes(text, **kw)))
