"""The port's quantized serving path against the JAX package's, on the CPU.

* Packers (``ops/quant.py``): ``values`` and ``scale`` must equal the JAX
  packers' exactly — same bytes, same fp32 bits — and the dequantized kernels
  too (0 ulp).
* The int8-matmul and int4-GEMV plain versions against the Pallas kernels run
  in interpret mode (as tests/test_kernels.py and tests/test_int4_gemv.py run
  them) and against the JAX package's XLA forms.  fp32: 1e-5 of the output's
  scale (sums of K <= 512 fp32 products in another order).  bf16: 2^-7
  relative plus the same floor — both sides round an fp32 result to bf16 once
  (half an ulp each); the Pallas int4 body also rounds its scaled weights in
  its compute dtype, which interpret mode raises to fp32.
* ``dense_general`` and the model (``decoder_prefill`` + ``decode_step``
  against JAX ``decoder_prefill`` + ``decode_step_scan``) on the very same
  packed bytes (packed by the JAX packer, carried over by
  ``params_from_jax``), with float and int8 KV caches: logits at 1e-4, the
  tolerance of tests/test_torch_model.py (a few layers of fp32 sums in
  another order).
* The slice: greedy ``generate_codes`` of a quantized trained fixture equals
  the JAX package's, token for token.
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
from dia_tts_prune_tpu.ops import modules as jmod
from dia_tts_prune_tpu.ops import quant as jq
from dia_tts_prune_tpu.ops.kernels import int4_matmul as j4
from dia_tts_prune_tpu.ops.kernels.int4_gemv import int4_gemv_halfsplit as jax_int4_gemv
from dia_tts_prune_tpu.ops.kernels.int8_matmul import int8_matmul as jax_int8_matmul
from dia_tts_prune_tpu.ops.kernels.int8_matmul import int8_matmul_reference
from dia_tts_prune_tpu.state import cross_attention_mask as jax_cross_mask
from dia_tts_prune_tpu.state import new_encoder_state as jax_encoder_state
from dia_tts_prune_tpu_torch import Dia
from dia_tts_prune_tpu_torch import config as tcfg
from dia_tts_prune_tpu_torch.checkpoint import params_from_jax
from dia_tts_prune_tpu_torch.generate import decoder_is_packed
from dia_tts_prune_tpu_torch.models import dia as tdia
from dia_tts_prune_tpu_torch.ops import quant as tq
from dia_tts_prune_tpu_torch.ops.kernels import (
    decode_attention,
    int4_gemv,
    int4_gemv_plain,
    int8_matmul,
    int8_matmul_plain,
    launch_counts,
)
from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import ends_from_padding_mask
from dia_tts_prune_tpu_torch.ops.modules import dense_general
from dia_tts_prune_tpu_torch.state import cross_attention_mask, new_encoder_state

# Several pytest workers run at once: one intra-op thread each keeps torch's
# thread pools from spinning on each other's cores (these tensors are tiny).
torch.set_num_threads(1)

FIXTURES = Path(__file__).parent / "fixtures"
ATOL = 1e-4  # model logits and hidden states


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _same(a, b):
    """Exactly equal, dtype and shape included."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _close_rel(out, ref, rel):
    """|out - ref| <= rel * max|ref| (a tolerance relative to the output's scale)."""
    out, ref = np.asarray(out, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * float(np.abs(ref).max()))


# ---------------------------------------------------------------------------
# (a) packers
# ---------------------------------------------------------------------------

# (shape, n_in, stacked): a stacked 1-axis kernel, the stacked o_proj form,
# the logits head (unstacked, N not a multiple of 16), a group-aligned one, an
# odd K
KERNEL_SHAPES = [((3, 64, 4, 16), 1, True), ((3, 4, 16, 64), 2, True), ((64, 9, 33), 1, False),
                 ((2, 256, 2, 24), 1, True), ((2, 63, 10), 1, True)]


@pytest.mark.parametrize("shape,n_in,stacked", KERNEL_SHAPES)
def test_quantize_int8_is_byte_identical(shape, n_in, stacked):
    w = _normal(np.random.default_rng(40), shape)
    w[..., 0] = 0.0  # an all-zero column: the 1e-12 floor of its scale
    ref = jq.quantize_int8(jnp.asarray(w), n_in, stacked)
    out = tq.quantize_int8(_t(w), n_in, stacked)
    _same(out.values, ref.values)
    _same(out.scale, ref.scale)
    assert (out.in_shape, out.out_shape) == (ref.in_shape, ref.out_shape)
    _same(tq.dequantize(out), jq.dequantize(ref))


@pytest.mark.parametrize("halfsplit", [True, False])
@pytest.mark.parametrize("group", [128, None, 48, 32])
@pytest.mark.parametrize("shape,n_in,stacked", KERNEL_SHAPES)
def test_quantize_int4_is_byte_identical(shape, n_in, stacked, group, halfsplit):
    """Every fallback of the packer: group > K is clipped to K, an
    indivisible group (48) gives per-column scales, halves that do not align
    with the groups give row parity, an odd K gives one value per byte."""
    w = _normal(np.random.default_rng(41), shape)
    ref = jq.quantize_int4(jnp.asarray(w), n_in, stacked, group=group, nibble=True,
                           halfsplit=halfsplit)
    out = tq.quantize_int4(_t(w), n_in, stacked, group=group, halfsplit=halfsplit)
    assert (out.group, out.nibble, out.halfsplit) == (ref.group, ref.nibble, ref.halfsplit)
    ref_values = np.asarray(ref.values).astype(np.int8)
    if not ref.nibble:  # XLA's 4-bit dtype, grouped [K/G, G, N]: the port keeps int8 [K, N]
        ref_values = ref_values.reshape(out.values.shape)
    _same(out.values, ref_values)
    _same(out.scale, ref.scale)
    _same(tq.dequantize4(out), jq.dequantize4(ref))


def test_packer_fallbacks_are_the_expected_ones():
    w = torch.zeros(256, 8)
    assert tq.quantize_int4(w, halfsplit=True).layout == "halfsplit"
    assert tq.quantize_int4(w[:128], halfsplit=True).layout == "parity"  # 64 % 128 != 0
    assert tq.quantize_int4(w[:128], group=None, halfsplit=True).layout == "halfsplit"
    assert tq.quantize_int4(w[:96]).group == 96  # a group above K is clipped to K: one group
    assert tq.quantize_int4(w, group=96).group is None  # 256 % 96 != 0: per-column scales
    odd = tq.quantize_int4(w[:63], halfsplit=True)
    assert odd.layout == "unpacked" and odd.values.shape == (63, 8)
    with pytest.raises(ValueError, match="nibble"):
        tq.quantize_int4(w, nibble=False)


def test_unpack_nibble_rows_inverts_both_packings():
    q = _t(np.random.default_rng(42).integers(-7, 8, (2, 10, 5)).astype(np.int8))
    for halfsplit in (False, True):
        pack = tq._pack_nibble_rows_halfsplit if halfsplit else tq._pack_nibble_rows
        packed = torch.stack([pack(q[0]), pack(q[1])])
        _same(tq.unpack_nibble_rows(packed, halfsplit), q)
        _same(packed, (jq._pack_nibble_rows_halfsplit if halfsplit else jq._pack_nibble_rows)(
            jnp.asarray(q.numpy())))


@pytest.fixture(scope="module")
def tiny():
    jcfg = tiny_test_config()
    return jcfg, jdia.init_params(jcfg, jax.random.PRNGKey(0)), tcfg.tiny_test_config()


def _carry(jparams):
    return params_from_jax(jax.tree.map(np.asarray, jparams), device="cpu")


def _kernels(tree, path=()):
    """(path, kernel) pairs in sorted key order (``jax.tree.map`` sorts keys)."""
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _kernels(v, path + (k,))
        elif k == "kernel":
            yield path, v


MODES = {
    "int8": lambda p, q: q.quantize_params_int8_packed(p, **_no_fused(q)),
    "int4": lambda p, q: q.quantize_params_int4_packed(p, halfsplit=True, **_nibble(q)),
    "hybrid": lambda p, q: q.quantize_params_int8_packed(
        q.quantize_params_int4_packed(p, mlp_only=True, halfsplit=True, **_nibble(q)),
        **_no_fused(q)),
}


def _no_fused(q):
    return {"fused": False} if q is jq else {}


def _nibble(q):
    return {"nibble": True} if q is jq else {}


@pytest.mark.parametrize("mode", list(MODES) + ["fake"])
def test_param_packers_match_jax_tree(tiny, mode):
    """The port packs a float tree to the bytes the JAX packer gives, and
    ``params_from_jax`` carries a JAX-packed tree across unchanged."""
    _, jp, _ = tiny
    if mode == "fake":
        ref, out = jq.quantize_params_int8(jp), tq.quantize_params_int8(_carry(jp))
        for (path, a), (_, b) in zip(_kernels(out), _kernels(ref)):
            _same(a, b)
        return
    ref = MODES[mode](jp, jq)
    out, carried = MODES[mode](_carry(jp), tq), _carry(ref)
    assert not any(isinstance(k, tq.PACKED_TYPES) for _, k in _kernels(out["encoder"]))
    n = 0
    for (path, a), (_, b), (_, c) in zip(_kernels(out["decoder"]), _kernels(ref["decoder"]),
                                         _kernels(carried["decoder"])):
        assert type(a).__name__ == type(b).__name__ == type(c).__name__, path
        want4 = mode == "int4" or (mode == "hybrid" and "mlp" in path)
        assert isinstance(a, tq.Quantized4Kernel if want4 else tq.QuantizedKernel), path
        for x in (a, c):
            _same(x.values, b.values)
            _same(x.scale, b.scale)
            assert (x.in_shape, x.out_shape) == (b.in_shape, b.out_shape)
        n += 1
    assert n == 11  # 4 + 4 attention kernels, 2 MLP kernels, the logits head


def test_layer_slices_packed_kernels(tiny):
    _, jp, _ = tiny
    packed = tq.quantize_params_int4_packed(_carry(jp), halfsplit=True)
    lp = tdia._layer(packed["decoder"]["layers"], 1)
    qk, full = lp["mlp"]["wo"]["kernel"], packed["decoder"]["layers"]["mlp"]["wo"]["kernel"]
    assert isinstance(qk, tq.Quantized4Kernel) and qk.values.dim() == 2
    _same(qk.values, full.values[1])
    _same(qk.scale, full.scale[1])
    assert (qk.group, qk.layout, qk.in_shape) == (full.group, full.layout, full.in_shape)
    moved = full.to("cpu")
    assert type(moved) is type(full) and (moved.group, moved.layout) == (full.group, full.layout)
    _same(moved.values, full.values)
    assert decoder_is_packed(packed) and not decoder_is_packed(_carry(jp))


def test_quantization_error_matches_jax(tiny):
    _, jp, _ = tiny
    sub = {"mlp": jp["encoder"]["layers"]["mlp"]}
    assert tq.quantization_error(_carry(sub)) == pytest.approx(jq.quantization_error(sub),
                                                               rel=1e-5)


# ---------------------------------------------------------------------------
# (b) the kernels' plain versions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,K,N", [(2, 256, 512), (8, 192, 640), (1, 64, 128)])
def test_int8_plain_matches_pallas_and_reference(B, K, N):
    rng = np.random.default_rng(43)
    x, w = _normal(rng, (B, K)), _normal(rng, (K, N))
    qk = jq.quantize_int8(jnp.asarray(w))
    scale = qk.scale.reshape(N)
    before = launch_counts()["int8_matmul"]
    out = int8_matmul(_t(x), _t(qk.values), _t(scale))
    assert launch_counts()["int8_matmul"] == before  # CPU: plain version, no launch
    _close_rel(out, jax_int8_matmul(jnp.asarray(x), qk.values, scale, interpret=True), 1e-5)
    _close_rel(out, int8_matmul_reference(jnp.asarray(x), qk.values, scale), 1e-5)


def test_int8_plain_bf16():
    rng = np.random.default_rng(44)
    x, w = _normal(rng, (4, 256)), _normal(rng, (256, 384))
    qk = jq.quantize_int8(jnp.asarray(w))
    scale = qk.scale.reshape(-1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax_int8_matmul(xb, qk.values, scale, interpret=True).astype(jnp.float32)
    out = int8_matmul_plain(_t(x).bfloat16(), _t(qk.values), _t(scale))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), rtol=2.0 ** -7,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("B", [2, 16])
@pytest.mark.parametrize("group", [128, None])
def test_int4_plain_matches_pallas_halfsplit(group, B):
    rng = np.random.default_rng(45)
    K, N = 512, 256
    x, w = _normal(rng, (B, K)), _normal(rng, (K, N))
    qk = jq.quantize_int4(jnp.asarray(w), group=group, nibble=True, halfsplit=True)
    assert qk.halfsplit
    before = launch_counts()["int4_gemv"]
    out = int4_gemv(_t(x), _t(qk.values), _t(qk.scale), "halfsplit")
    assert launch_counts()["int4_gemv"] == before
    _close_rel(out, jax_int4_gemv(jnp.asarray(x), qk.values, qk.scale, interpret=True), 1e-5)
    xla = j4.int4_matmul_halfsplit if group is None else j4.int4_matmul_halfsplit_grouped
    _close_rel(out, xla(jnp.asarray(x), qk.values, qk.scale), 1e-5)
    # and it is the dequantized kernel's product
    _close_rel(out, x @ np.asarray(jq.dequantize4(qk)), 1e-5)


@pytest.mark.parametrize("group", [64, None])
def test_int4_plain_matches_xla_parity(group):
    rng = np.random.default_rng(46)
    K, N = 192, 130
    x, w = _normal(rng, (3, K)), _normal(rng, (K, N))
    qk = jq.quantize_int4(jnp.asarray(w), group=group, nibble=True, halfsplit=False)
    out = int4_gemv_plain(_t(x), _t(qk.values), _t(qk.scale), "parity")
    xla = j4.int4_matmul_nibble if group is None else j4.int4_matmul_nibble_grouped
    _close_rel(out, xla(jnp.asarray(x), qk.values, qk.scale), 1e-5)


@pytest.mark.parametrize("group", [21, None])
def test_int4_plain_unpacked_odd_k(group):
    rng = np.random.default_rng(47)
    x, w = _normal(rng, (2, 63)), _normal(rng, (63, 40))
    qk = tq.quantize_int4(_t(w), group=group)
    assert qk.layout == "unpacked" and qk.group == group
    out = int4_gemv_plain(_t(x), qk.values, qk.scale, "unpacked")
    _close_rel(out, x @ tq.dequantize4(qk).numpy(), 1e-5)


def test_int4_plain_bf16():
    rng = np.random.default_rng(48)
    x, w = _normal(rng, (2, 256)), _normal(rng, (256, 128))
    qk = jq.quantize_int4(jnp.asarray(w), group=128, nibble=True, halfsplit=True)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    ref = jax_int4_gemv(xb, qk.values, qk.scale, interpret=True).astype(jnp.float32)
    out = int4_gemv_plain(_t(x).bfloat16(), _t(qk.values), _t(qk.scale))
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref), rtol=2.0 ** -7,
                               atol=1e-5 * float(np.abs(ref).max()))


@pytest.mark.parametrize("with_new", [False, True])
def test_decode_plain_int8_cache_matches_jax(with_new):
    """The int8-cache form against ``_sdpa_quant`` (cross-attention: per-row
    ends, end = 0 gives exact zeros) and, with the current token, against a
    float softmax over the dequantized prefix plus that token."""
    rng = np.random.default_rng(49)
    B, T, Nkv, G, H = 3, 96, 2, 2, 32
    q = _normal(rng, (B, Nkv * G, H))
    k8, ks = jdia.quantize_kv(jnp.asarray(_normal(rng, (B, T, Nkv, H))))
    v8, vs = jdia.quantize_kv(jnp.asarray(_normal(rng, (B, T, Nkv, H))))
    ends = np.array([0, 37, 96])
    args = (_t(q), _t(k8), _t(v8), torch.zeros(B, dtype=torch.int32),
            _t(ends.astype(np.int32)), _t(ks), _t(vs))
    mask = (np.arange(T)[None] < ends[:, None])[:, None, None, :]
    if not with_new:
        ref = jdia._sdpa_quant(jnp.asarray(q)[:, None], k8, v8, ks, vs, jnp.asarray(mask))[:, 0]
        out = decode_attention(*args).numpy()
        assert np.all(out[0] == 0.0)
        np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
        return
    k_new, v_new = _normal(rng, (B, Nkv, H)), _normal(rng, (B, Nkv, H))
    out = decode_attention(*args, _t(k_new), _t(v_new)).numpy()
    kd = np.concatenate([np.asarray(k8, np.float32) * np.asarray(ks)[..., None], k_new[:, None]], 1)
    vd = np.concatenate([np.asarray(v8, np.float32) * np.asarray(vs)[..., None], v_new[:, None]], 1)
    full = np.concatenate([mask, np.ones((B, 1, 1, 1), bool)], axis=-1)
    ref = jmod.sdpa(jnp.asarray(q)[:, None], jnp.asarray(kd), jnp.asarray(vd),
                    jnp.asarray(full))[:, 0]
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[0], np.repeat(v_new[0], G, axis=0), rtol=0, atol=1e-6)


def test_quantize_kv_is_identical():
    x = _normal(np.random.default_rng(50), (2, 3, 5, 4, 16))
    x[0, 0, 0, 0] = 0.0
    (q, s), (rq, rs) = tdia.quantize_kv(_t(x)), jdia.quantize_kv(jnp.asarray(x))
    _same(q, rq)
    _same(s, rs)


@pytest.mark.parametrize("bad", ["dtype", "rows", "scale_shape", "contiguity", "weights", "k"])
def test_gemv_input_checks(bad):
    """What the two CUDA wrappers check before they launch (they raise, and
    never fall back to the plain version)."""
    import importlib

    m8 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int8_matmul")
    m4 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int4_gemv")
    x, w, s = torch.zeros(2, 64), torch.zeros(64, 48, dtype=torch.int8), torch.zeros(48)
    b, s4 = torch.zeros(32, 48, dtype=torch.int8), torch.zeros(2, 48)
    m8._check(x, w, s)
    assert m4._check(x, b, s4, "halfsplit") == (64, 32)
    assert m4._check(x, b, s, "parity") == (64, None)
    assert m4._check(x, w, s, "unpacked") == (64, None)
    if bad == "dtype":
        x = x.half()
    elif bad == "rows":  # any row count from one up (above 64 in groups of 64): none raises
        x = torch.zeros(0, 64)
    elif bad == "scale_shape":
        s, s4 = torch.zeros(1, 48), torch.zeros(2, 47)
    elif bad == "contiguity":
        x = torch.zeros(64, 2).t()
    elif bad == "weights":
        w, b = w.float(), b.float()
    else:
        x = torch.zeros(2, 66)
    with pytest.raises((TypeError, ValueError)):
        m8._check(x, w, s)
    with pytest.raises((TypeError, ValueError)):
        m4._check(x, b, s4, "halfsplit")


def test_int4_layout_checks():
    import importlib

    m4 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int4_gemv")
    x, b = torch.zeros(2, 64), torch.zeros(32, 8, dtype=torch.int8)
    with pytest.raises(ValueError, match="layout"):
        m4._check(x, b, torch.zeros(8), "kng")
    with pytest.raises(ValueError, match="halfsplit"):
        m4._check(x, b, torch.zeros(1, 8), "halfsplit")  # group 64: halves not aligned
    assert m4._check(x, b, torch.zeros(1, 8), "parity") == (64, 64)
    with pytest.raises(ValueError, match="divide"):
        m4._check(x, b, torch.zeros(3, 8), "parity")
    with pytest.raises(ValueError, match="unsupported device"):
        int4_gemv(x.to("meta"), b.to("meta"), torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        int8_matmul(x.to("meta"), torch.zeros(64, 8, dtype=torch.int8, device="meta"),
                    torch.zeros(8, device="meta"))


@pytest.mark.parametrize("K,N,ptr,copy,cluster,slice_rows,vec,splits", [
    (2048, 2048, 0, 16, 16, 128, 4, 32), (2048, 512, 0, 16, 16, 128, 4, 32),
    (2048, 16384, 0, 16, 2, 1024, 4, 9), (8192, 2048, 0, 16, 16, 512, 4, 66),
    (2048, 9252, 0, 16, 4, 512, 4, 15), (2048, 9252, 2, 1, 4, 512, 1, 4),
    (40, 7, 0, 1, 1, 64, 1, 1)])
def test_int8_launch_plan(K, N, ptr, copy, cluster, slice_rows, vec, splits):
    """bf16: the copy width divides the row length and the address; the
    clusters fill the card, each slice whole stages of the ring.  fp32: the load width
    likewise; the slices fill the card and fit the kernel's shared-memory
    slice."""
    from dia_tts_prune_tpu_torch.ops.kernels.int8_matmul import (
        MAX_SLICE,
        cluster_plan,
        copy_width,
        split_plan,
        vector_width,
    )

    assert copy_width(N, ptr) == copy
    assert cluster_plan(K, N) == (cluster, slice_rows)
    assert vector_width(N, ptr) == vec
    n = split_plan(K, N, vec)
    assert n == splits and -(-K // n) <= MAX_SLICE


@pytest.mark.parametrize("R,N,ptr,vec,splits,copy,cluster,slice_rows", [
    (1024, 2048, 0, 4, 16, 16, 16, 64), (1024, 512, 0, 4, 16, 16, 16, 64),
    (1024, 16384, 0, 4, 9, 16, 2, 512), (4096, 2048, 0, 4, 64, 16, 16, 256),
    (1024, 9252, 0, 4, 15, 16, 4, 256), (1024, 9252, 2, 1, 4, 1, 4, 256), (20, 7, 0, 1, 1, 1, 1, 64),
    (500, 1027, 0, 1, 7, 1, 4, 128)])
def test_int4_launch_plan(R, N, ptr, vec, splits, copy, cluster, slice_rows):
    """The CUDA-core route (fp32, one value a byte) plans its byte rows with
    the fp32 int8 route's functions and its own shared-memory slice; the
    tensor-core route (bf16 nibbles) copies as the bf16 int8 route does and
    plans byte rows with its cluster rule, each slice whole stages."""
    import importlib

    m4 = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.int4_gemv")
    assert m4.vector_width(N, ptr) == vec
    n = m4.split_plan(R, N, vec, max_slice=m4.MAX_SLICE)
    assert n == splits and -(-R // n) <= m4.MAX_SLICE
    assert m4.copy_width(N, ptr) == copy
    assert m4.cluster_plan(R, N) == (cluster, slice_rows)
    assert slice_rows % 64 == 0 and cluster * slice_rows >= R


# ---------------------------------------------------------------------------
# (c) dense_general
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4_halfsplit", "int4_parity", "int4_column"])
@pytest.mark.parametrize("n_in", [1, 2])
def test_dense_general_packed_matches_jax(mode, n_in):
    rng = np.random.default_rng(51)
    shape = (256, 4, 24) if n_in == 1 else (4, 64, 96)  # o_proj contracts (heads, head_dim)
    w = _normal(rng, shape)
    x = _normal(rng, (2, 3, 256) if n_in == 1 else (2, 3, 4, 64))
    axis = (-1,) if n_in == 1 else (-2, -1)
    if mode == "int8":
        ref_k = jq.quantize_int8(jnp.asarray(w), n_in)
    else:
        ref_k = jq.quantize_int4(jnp.asarray(w), n_in, group=None if mode == "int4_column" else 128,
                                 nibble=True, halfsplit=mode != "int4_parity")
        assert ref_k.halfsplit == (mode != "int4_parity")
    kernel = _carry({"kernel": ref_k})["kernel"]
    ref = jmod.dense_general(jnp.asarray(x), ref_k, axis)
    out = dense_general(_t(x), kernel, axis)
    assert out.shape == ref.shape
    _close_rel(out, ref, 1e-5)
    with pytest.raises(ValueError, match="contraction axes"):
        dense_general(_t(x), kernel, (-1,) if n_in == 2 else (-2, -1))


# ---------------------------------------------------------------------------
# (d) the model
# ---------------------------------------------------------------------------


def _model_case(jcfg, jp, cfg, mode, kv_int8, rng, n_steps=3):
    """One prompt prefill and ``n_steps`` decode steps through both packages
    on the same packed bytes; asserts closeness.  With int8 caches the K/V
    entries are compared dequantized, to one quantization step (a value on a
    rounding boundary may land on either side), and the port's cache then
    takes the JAX bytes, so that each step's logits are compared on equal
    caches."""
    ref_params = MODES[mode](jp, jq)
    params = _carry(ref_params)
    T = cfg.data.text_length
    ids = rng.integers(1, 200, (2, T)).astype(np.int32)
    ids[0, :] = 0  # unconditional row
    ids[1, 70:] = 0
    js = jax_encoder_state(jcfg, jnp.asarray(ids))
    j_enc = jdia.encoder_forward(ref_params, jcfg, jnp.asarray(ids), js.positions, js.attn_mask)
    j_cross = jdia.precompute_cross_cache(ref_params, jcfg, j_enc, js.positions)
    ts = new_encoder_state(cfg, _t(ids))
    t_cross = tdia.precompute_cross_cache(params, cfg, _t(j_enc), ts.positions)
    np.testing.assert_allclose(t_cross.k.numpy(), np.asarray(j_cross.k), rtol=0, atol=ATOL)
    np.testing.assert_allclose(t_cross.v.numpy(), np.asarray(j_cross.v), rtol=0, atol=ATOL)

    W, P = 128, 37
    prompt = rng.integers(0, 1024, (1, W, 9)).astype(np.int32)
    tgt = np.concatenate([prompt, prompt])
    rows = np.broadcast_to(np.arange(W)[None], (2, W))
    valid = rows < P
    pm = jnp.asarray(valid)
    prefill_mask = (pm[:, :, None] == pm[:, None, :])[:, None] & jnp.tril(jnp.ones((W, W), bool))
    j_mask = jax_cross_mask(js.padding_mask)
    j_logits, j_cache = jdia.decoder_prefill(
        ref_params, jcfg, jnp.asarray(tgt), jnp.asarray(rows, jnp.int32), prefill_mask, j_cross,
        j_mask, jdia.new_self_cache(jcfg, 2, quant=kv_int8),
        dec_segment_ids=jnp.asarray(valid, jnp.int32),
        enc_segment_ids=js.padding_mask.astype(jnp.int32))
    t_cache = tdia.new_self_cache(params, cfg, 2, device="cpu", quant=kv_int8)
    t_logits = tdia.decoder_prefill(
        params, cfg, _t(tgt), _t(rows), t_cross, t_cache, _t(valid.astype(np.int32)),
        ts.padding_mask.to(torch.int32))
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits), rtol=0, atol=ATOL)

    def sync_cache(slots):
        for name in ("k", "v"):
            a, sa = getattr(t_cache, name), getattr(t_cache, name + "s")
            b, sb = (np.asarray(getattr(j_cache, n)) for n in (name, name + "s"))
            got = a[:, :, slots].float() * sa[:, :, slots, :, None]
            want = b[:, :, slots].astype(np.float32) * sb[:, :, slots, :, None]
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=float(sb.max()) + ATOL)
            a[:, :, slots], sa[:, :, slots] = _t(b[:, :, slots]), _t(sb[:, :, slots])

    if kv_int8:  # the loop's caches: both int8, the cross cache quantized after prefill
        assert isinstance(t_cache, tdia.QuantKVCache) and t_cache.k.dtype == torch.int8
        sync_cache(slice(0, P))
        kq, ks = jdia.quantize_kv(j_cross.k)
        vq, vs = jdia.quantize_kv(j_cross.v)
        j_cross = jdia.QuantKVCache(k=kq, v=vq, ks=ks, vs=vs)
        t_cross = tdia.quantize_cache(t_cross)
    ends = ends_from_padding_mask(cross_attention_mask(ts.padding_mask))
    worst = 0.0
    for t in range(P, P + n_steps):
        tok = rng.integers(0, 1024, (1, 1, 9)).astype(np.int32)
        tgt1 = np.concatenate([tok, tok])
        pos = np.full((2, 1), t, np.int32)
        j_step, j_cache = jdia.decode_step_scan(
            ref_params, jcfg, jnp.asarray(tgt1), jnp.asarray(pos), jnp.asarray(t - 1, jnp.int32),
            j_cache, j_cross, j_mask)
        t_step = tdia.decode_step(params, cfg, _t(tgt1), _t(pos), t - 1, t_cache, t_cross, ends)
        np.testing.assert_allclose(t_step.numpy(), np.asarray(j_step), rtol=0, atol=ATOL)
        worst = max(worst, float(np.abs(np.asarray(j_step)).max()))
        if kv_int8:
            sync_cache(slice(t - 1, t))
        else:
            np.testing.assert_allclose(t_cache.k.numpy(), np.asarray(j_cache.k), rtol=0, atol=ATOL)
    assert worst > 0.1  # the logits are not trivially small


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_packed_model_matches_jax_tiny(tiny, mode, kv_int8):
    jcfg, jp, cfg = tiny
    _model_case(jcfg, jp, cfg, mode, kv_int8, np.random.default_rng(52))


@pytest.fixture(scope="module")
def trained_small():
    d = FIXTURES / "trained_small"
    return JaxDia.from_pretrained(str(d)), tcfg.DiaConfig.load(d / "config.json")


@pytest.mark.parametrize("kv_int8", [False, True])
@pytest.mark.parametrize("mode", list(MODES))
def test_packed_model_matches_jax_trained(trained_small, mode, kv_int8):
    """Trained weights at head_dim 64 and widths where the packer keeps the
    halfsplit layout (the tiny config falls back to row parity everywhere)."""
    jd, cfg = trained_small
    packed = MODES[mode](jd.params, jq)
    wo = packed["decoder"]["layers"]["mlp"]["wo"]["kernel"]
    assert mode == "int8" or wo.halfsplit
    _model_case(jd.config, jd.params, cfg, mode, kv_int8, np.random.default_rng(53), n_steps=2)


def test_quantize_then_attend_would_differ(tiny):
    """The fault the int8 step avoids: attending the current token through
    its quantized cache entry moves the logits by more than the parity
    tolerance, so the model test above does tell the two orders apart."""
    jcfg, jp, cfg = tiny
    params = _carry(MODES["int8"](jp, jq))
    rng = np.random.default_rng(54)
    ids = np.zeros((2, cfg.data.text_length), np.int32)
    ids[1, :30] = 7
    ts = new_encoder_state(cfg, _t(ids))
    cross = tdia.precompute_cross_cache(
        params, cfg, tdia.encoder_forward(params, cfg, _t(ids), ts.positions), ts.positions)
    ends = ends_from_padding_mask(cross_attention_mask(ts.padding_mask))
    tok = _t(rng.integers(0, 1024, (2, 1, 9)).astype(np.int32))
    pos = torch.zeros(2, 1, dtype=torch.int64)

    def step(attend):
        cache = tdia.new_self_cache(params, cfg, 2, 8, device="cpu", quant=True)
        import unittest.mock as mock

        with mock.patch.object(tdia, "decode_attention", attend):
            return tdia.decode_step(params, cfg, tok, pos, 0, cache, cross, ends)

    def quantized_first(q, k, v, start, end, ks=None, vs=None, k_new=None, v_new=None,
                        queries_per_row=1):
        if k_new is None:
            return decode_attention(q, k, v, start, end, ks, vs, queries_per_row=queries_per_row)
        (k8, s8), (v8, t8) = tdia.quantize_kv(k_new), tdia.quantize_kv(v_new)
        return decode_attention(q, k, v, start, end, ks, vs, k8.float() * s8[..., None],
                                v8.float() * t8[..., None])

    diff = (step(decode_attention) - step(quantized_first)).abs().max().item()
    assert diff > ATOL, diff


# ---------------------------------------------------------------------------
# (e) the slice
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["int8", "int4", "hybrid"])
def test_quantized_fixture_greedy_codes_match_jax(mode, monkeypatch):
    """``Dia.quantize_*`` then greedy ``generate_codes`` equals the JAX
    package's codes for the same fixture quantized the same way, with int8 KV
    caches on both sides (the JAX package's accelerator default, forced on
    its CPU backend by DIA_KV_INT8=1; the port's default for a packed
    decoder)."""
    monkeypatch.setenv("DIA_KV_INT8", "1")
    d = FIXTURES / "trained_small"
    jd, dia = JaxDia.from_pretrained(str(d)), Dia.from_pretrained(d, device="cpu")
    if mode == "int8":
        jd.quantize_int8()
        dia.quantize_int8()
    else:
        jd.quantize_int4(mlp_only=mode == "hybrid")
        dia.quantize_int4(mlp_only=mode == "hybrid")
    assert decoder_is_packed(dia.params) and dia.generator.params is dia.params
    for (path, a), (_, b) in zip(_kernels(dia.params["decoder"]), _kernels(jd.params["decoder"])):
        _same(a.values, b.values)
        _same(a.scale, b.scale)
    kw = dict(max_tokens=96, temperature=0.0)
    ref = np.asarray(jd.generate_codes("[S1] The birch canoe slid. [S2]", **kw))
    out = dia.generate_codes("[S1] The birch canoe slid. [S2]", **kw)
    assert out.shape[0] > 0
    np.testing.assert_array_equal(out, ref)


def test_kv_int8_argument(tiny):
    """``kv_int8=None`` follows the decoder's packing; an explicit value
    overrides it, and both cache kinds generate valid codes."""
    from dia_tts_prune_tpu_torch.generate import DiaGenerator

    _, jp, cfg = tiny
    gen = DiaGenerator(_carry(MODES["int8"](jp, jq)), cfg, device="cpu")
    seen = []
    real = tdia.new_self_cache

    def spy(*a, **kw):
        seen.append(kw.get("quant"))
        return real(*a, **kw)

    import dia_tts_prune_tpu_torch.generate as tgen

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tgen, "new_self_cache", spy)
        outs = [gen.generate_tokens("[S1] hi", max_tokens=24, temperature=0.0, kv_int8=flag)
                for flag in (None, False, True)]
        DiaGenerator(_carry(jp), cfg, device="cpu").generate_tokens(
            "[S1] hi", max_tokens=24, temperature=0.0)
    assert seen == [True, False, True, False]
    np.testing.assert_array_equal(outs[0], outs[2])
    assert all(o.shape[1] == 9 and (o >= 0).all() and (o < 1028).all() for o in outs)


def test_quantize_frees_the_float_decoder_kernels():
    """After ``quantize_int8`` nothing of the model holds a float decoder
    kernel (that memory is half the point); the encoder stays float."""
    dia = Dia.from_pretrained(FIXTURES / "trained_small", device="cpu")
    import weakref

    old = weakref.ref(dia.params["decoder"]["layers"]["mlp"]["wo"]["kernel"])
    enc = dia.params["encoder"]["layers"]["mlp"]["wo"]["kernel"]
    dia.quantize_int8()
    assert old() is None
    assert dia.params["encoder"]["layers"]["mlp"]["wo"]["kernel"] is enc
    assert all(isinstance(k, tq.QuantizedKernel) for _, k in _kernels(dia.params["decoder"]))


# ---------------------------------------------------------------------------
# quantization-aware training: straight-through fake-quant
# ---------------------------------------------------------------------------

QAT_MODES = ["int8", "int4", "int4_hybrid"]


def test_ste_gradient_is_identity():
    w = torch.from_numpy(np.random.default_rng(40).normal(size=(6, 5)).astype(np.float32))
    w.requires_grad_(True)
    fq = tq.dequantize(tq.quantize_int8(w.detach()))
    out = tq.fake_quant_ste(w, fq)
    assert torch.equal(out.detach(), fq)  # the forward sees the quantized values
    cot = torch.arange(30, dtype=torch.float32).reshape(6, 5)
    (grad,) = torch.autograd.grad((out * cot).sum(), w)
    assert torch.equal(grad, cot)  # the backward sees the identity


@pytest.mark.parametrize("mode", QAT_MODES)
def test_fake_quant_params_ste_matches_jax(tiny, mode):
    """Same fake-quantized values as the JAX function, kernel by kernel; the
    encoder is out of scope and shared as it is; gradients reach the float
    weights unchanged."""
    _, jp, _ = tiny
    tp = _carry(jp)
    ref = jq.fake_quant_params_ste(jp, mode)
    out = tq.fake_quant_params_ste(tp, mode)
    for (path, a), (_, b) in zip(_kernels(out), _kernels(ref)):
        _same(a, b)
        if path[0] == "encoder":
            assert a is _get(tp, path)["kernel"]
    with pytest.raises(ValueError, match="Unknown QAT mode"):
        tq.fake_quant_params_ste(tp, "int2")

    w = tp["decoder"]["layers"]["mlp"]["wo"]["kernel"].requires_grad_(True)
    view = tq.fake_quant_params_ste(tp, mode)["decoder"]["layers"]["mlp"]["wo"]["kernel"]
    (grad,) = torch.autograd.grad(view.sum(), w)
    assert torch.equal(grad, torch.ones_like(w))
    w.requires_grad_(False)


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mode", QAT_MODES)
def test_qat_forward_equals_packed_serving_forward(tiny, mode):
    """The QAT view of the weights is the dequantized packed tree of the
    serving quantizer (same grids, same scales), so the training loss under
    QAT is the loss of the weights a packed model serves with — within the
    fp32 rounding of w + (fq - w)."""
    from dia_tts_prune_tpu_torch.train import build_train_batch, compute_loss

    _, jp, cfg = tiny
    tp = _carry(jp)
    packed = {"int8": lambda p: tq.quantize_params_int8_packed(p),
              "int4": lambda p: tq.quantize_params_int4_packed(p),
              "int4_hybrid": lambda p: tq.quantize_params_int8_packed(
                  tq.quantize_params_int4_packed(p, mlp_only=True))}[mode](tp)
    deq = tq._map_kernels(packed, lambda k, path: (
        tq.dequantize(k) if isinstance(k, tq.QuantizedKernel)
        else tq.dequantize4(k) if isinstance(k, tq.Quantized4Kernel) else k))
    view = tq.fake_quant_params_ste(tp, mode)
    for (path, a), (_, b) in zip(_kernels(view), _kernels(deq)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-7)

    rng = np.random.default_rng(41)
    text = rng.integers(1, 200, (2, cfg.data.text_length)).astype(np.int32)
    text[:, 50:] = 0
    codes = [rng.integers(0, 1024, (60, 9)).astype(np.int32) for _ in range(2)]
    batch = {k: torch.from_numpy(v) for k, v in build_train_batch(cfg, text, codes).items()}
    with torch.no_grad():
        qat = compute_loss(tp, cfg, batch, qat_mode=mode)
        served = compute_loss(deq, cfg, batch)
        plain = compute_loss(tp, cfg, batch)
    torch.testing.assert_close(qat, served, rtol=1e-6, atol=0)
    assert float(qat) != float(plain)
