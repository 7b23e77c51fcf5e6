"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each skips without a CUDA device.  This file imports no JAX,
so it runs on a machine that has only PyTorch:
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu_torch.models.dia import quantize_kv
from dia_tts_prune_tpu_torch.ops import quant
from dia_tts_prune_tpu_torch.ops.kernels import (
    block_sparse_matmul,
    block_sparse_matmul_plain,
    decode_attention,
    decode_attention_plain,
    flash_attention,
    flash_attention_bwd_kv,
    flash_attention_bwd_plain,
    flash_attention_bwd_q,
    flash_attention_lse,
    flash_attention_lse_plain,
    flash_attention_plain,
    flash_attention_trainable,
    int4_gemv,
    int4_gemv_plain,
    int8_matmul,
    int8_matmul_plain,
)
from dia_tts_prune_tpu_torch.ops.kernels.sparse_matmul import listed_mask, plan_block_sparsity


def _t(a):
    return torch.from_numpy(np.array(a))


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _wide(*args):
    """The same input values in fp32 (bf16 widens exactly)."""
    return tuple(a.float() if a.is_floating_point() else a for a in args)


# The reference is the plain version in fp32 on the same values, so fp32 differs
# only in summation order and bf16 also by the kernel's one rounding of its
# fp32 result: at most half an ulp, <= 2^-8 of the value.
TOLS = [(torch.float32, 0.0, 2e-5), (torch.bfloat16, 2.0 ** -8, 2e-5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: python -m pytest -m gpu tests/)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, rtol, atol):
    rng = np.random.default_rng(15)
    B, T, Nq, Nkv, H = 2, 300, 4, 2, 64
    q, k, v = (_t(_normal(rng, s)).to(cuda_device, dtype)
               for s in ((B, T, Nq, H), (B, T, Nkv, H), (B, T, Nkv, H)))
    seg = torch.ones(B, T, dtype=torch.int32, device=cuda_device)
    seg[1, 211:] = 0
    for causal in (False, True):
        out = flash_attention(q, k, v, seg, seg, causal)
        ref = flash_attention_plain(*_wide(q, k, v, seg, seg), causal)
        torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)


# Gradients sum up to T products of size ~|dO|.|v| per element, so their fp32
# summation-order error is larger than the forward's: atol 1e-4 (the JAX
# package's own limit for its backward kernels), plus the one rounding to bf16.
GRAD_TOLS = [(torch.float32, 1e-5, 1e-4), (torch.bfloat16, 2.0 ** -8, 1e-4)]
FLASH_BWD_SHAPES = [  # B, Tq, Tk, Nq, Nkv, H
    (2, 320, 320, 4, 2, 64), (2, 100, 77, 4, 4, 128), (1, 33, 65, 8, 2, 32)]


def _flash_training_inputs(device, dtype, shape, seed=21):
    rng = np.random.default_rng(seed)
    B, Tq, Tk, Nq, Nkv, H = shape
    q, k, v, dout = (_t(_normal(rng, s)).to(device, dtype) for s in (
        (B, Tq, Nq, H), (B, Tk, Nkv, H), (B, Tk, Nkv, H), (B, Tq, Nq, H)))
    q_seg = torch.ones(B, Tq, dtype=torch.int32, device=device)
    kv_seg = torch.ones(B, Tk, dtype=torch.int32, device=device)
    kv_seg[-1, Tk * 2 // 3:] = 0  # ragged real length
    q_seg[0, 5] = 7  # one fully masked query row
    return q, k, v, q_seg, kv_seg, dout


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", GRAD_TOLS)
@pytest.mark.parametrize("shape", FLASH_BWD_SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_flash_training_kernels_match_plain_on_card(cuda_device, dtype, rtol, atol, shape, causal):
    q, k, v, q_seg, kv_seg, dout = _flash_training_inputs(cuda_device, dtype, shape)
    out, lse = flash_attention_lse(q, k, v, q_seg, kv_seg, causal)
    assert torch.equal(out, flash_attention(q, k, v, q_seg, kv_seg, causal))
    ref_out, ref_lse = flash_attention_lse_plain(*_wide(q, k, v, q_seg, kv_seg), causal)
    fwd_rtol, fwd_atol = dict((t[0], t[1:]) for t in TOLS)[dtype]
    torch.testing.assert_close(out.float(), ref_out, rtol=fwd_rtol, atol=fwd_atol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-5)
    assert torch.all(out[0, 5] == 0) and torch.all(lse[0, :, 5] == lse[0, 0, 5])

    dk, dv = flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, causal)
    dq = flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, causal)
    again = flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, causal)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])  # no atomics: repeatable
    refs = flash_attention_bwd_plain(*_wide(q, k, v, q_seg, kv_seg, out, lse, dout), causal)
    for got, ref in zip((dq, dk, dv), refs):
        assert got.dtype == dtype
        torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol)
    assert torch.all(dq[0, 5] == 0)  # a fully masked row gets exactly no gradient


# The bf16 forward, dK/dV and dQ run on the tensor cores in 64 x 64 tiles: head dims
# 32/64/128, GQA groups 1/2/4, lengths that are not multiples of 64, and ids
# t % 3, which put every id in every tile, so that no tile may be skipped by
# its segment range.  Gates as above.
TC_CASES = [  # B, Tq, Tk, Nq, Nkv, H, causal, ids
    (2, 77, 77, 4, 4, 32, True, "prefix"),
    (2, 320, 250, 4, 2, 64, False, "prefix"),
    (2, 1000, 1000, 8, 2, 128, True, "prefix"),
    (2, 320, 320, 8, 2, 32, False, "interleaved"),
    (1, 1000, 1000, 8, 8, 64, True, "interleaved"),
    (2, 250, 320, 4, 1, 128, False, "interleaved"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", TC_CASES, ids=lambda c: "x".join(map(str, c[:6])) + (
    "_causal" if c[6] else "") + "_" + c[7])
def test_flash_bf16_tensor_core_kernels_match_plain_on_card(cuda_device, case):
    B, Tq, Tk, Nq, Nkv, H, causal, ids = case
    rng = np.random.default_rng(23)
    q, k, v, dout = (_t(_normal(rng, s)).to(cuda_device, torch.bfloat16) for s in (
        (B, Tq, Nq, H), (B, Tk, Nkv, H), (B, Tk, Nkv, H), (B, Tq, Nq, H)))

    def seg(T):
        t = torch.arange(T, device=cuda_device)
        if ids == "interleaved":
            return (t % 3).to(torch.int32)[None].repeat(B, 1).contiguous()
        real = torch.tensor([T, T * 3 // 10][:B], device=cuda_device)
        return (t[None] < real[:, None]).to(torch.int32).contiguous()

    q_seg, kv_seg = seg(Tq), seg(Tk)
    q_seg[0, 5] = 7  # one fully masked query row
    counts = lambda: (flash_attention_lse.launches, flash_attention_bwd_kv.launches,  # noqa: E731
                      flash_attention_bwd_q.launches)
    n0 = counts()
    out, lse = flash_attention_lse(q, k, v, q_seg, kv_seg, causal)
    dk, dv = flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, causal)
    dq = flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, causal)
    assert counts() == tuple(n + 1 for n in n0)
    again = flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout, causal)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])  # no atomics: repeatable
    assert torch.equal(dq, flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, causal))
    assert torch.all(dq[0, 5] == 0)  # a fully masked row gets exactly zero dq

    ref_out, ref_lse = flash_attention_lse_plain(*_wide(q, k, v, q_seg, kv_seg), causal)
    fwd_rtol, fwd_atol = dict((t[0], t[1:]) for t in TOLS)[torch.bfloat16]
    torch.testing.assert_close(out.float(), ref_out, rtol=fwd_rtol, atol=fwd_atol)
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=2e-5)
    assert torch.all(out[0, 5] == 0)  # a fully masked row comes out as exact zeros
    ref_dq, ref_dk, ref_dv = flash_attention_bwd_plain(
        *_wide(q, k, v, q_seg, kv_seg, out, lse, dout), causal)
    rtol, atol = dict((t[0], t[1:]) for t in GRAD_TOLS)[torch.bfloat16]
    for got, ref in ((dk, ref_dk), (dv, ref_dv), (dq, ref_dq)):
        assert got.dtype == torch.bfloat16
        torch.testing.assert_close(got.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [False, True])
def test_flash_trainable_gradients_on_card(cuda_device, causal):
    """The autograd.Function (kernels both ways) against autograd through the
    plain version, fp32, at the JAX backward tests' limits."""
    q, k, v, q_seg, kv_seg, dout = _flash_training_inputs(
        cuda_device, torch.float32, FLASH_BWD_SHAPES[0])
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    n0 = (flash_attention_lse.launches, flash_attention_bwd_kv.launches,
          flash_attention_bwd_q.launches)
    out = flash_attention_trainable(*leaves, q_seg, kv_seg, causal)
    grads = torch.autograd.grad((out * dout).sum(), leaves)
    assert (flash_attention_lse.launches, flash_attention_bwd_kv.launches,
            flash_attention_bwd_q.launches) == tuple(n + 1 for n in n0)
    ref_leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = flash_attention_plain(*ref_leaves, q_seg, kv_seg, causal)
    ref_grads = torch.autograd.grad((ref * dout).sum(), ref_leaves)
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-5)
    for got, want in zip(grads, ref_grads):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-4)


@pytest.mark.gpu
def test_flash_training_wrappers_raise_on_the_card(cuda_device):
    q, k, v, q_seg, kv_seg, dout = _flash_training_inputs(
        cuda_device, torch.float32, FLASH_BWD_SHAPES[0])
    with pytest.raises(TypeError):
        flash_attention_trainable(q.half(), k.half(), v.half(), q_seg, kv_seg)
    with pytest.raises(TypeError):
        flash_attention_lse(q, k, v, q_seg.long(), kv_seg)
    out, lse = flash_attention_lse(q, k, v, q_seg, kv_seg)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse.transpose(1, 2), dout)
    with pytest.raises(ValueError, match="dd"):
        flash_attention_bwd_q(q, k, v, q_seg, kv_seg, out, lse, dout, False, lse[:, :, :-1])
    with pytest.raises(ValueError, match="dout"):
        flash_attention_bwd_kv(q, k, v, q_seg, kv_seg, out, lse, dout[:, :-1])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_decode_kernel_matches_plain_on_card(cuda_device, dtype, rtol, atol):
    rng = np.random.default_rng(16)
    B, T, Nq, Nkv, H = 3, 700, 8, 2, 128
    q = _t(_normal(rng, (B, Nq, H))).to(cuda_device, dtype)
    k, v = (_t(_normal(rng, (B, T, Nkv, H))).to(cuda_device, dtype) for _ in range(2))
    start = torch.tensor([0, 0, 5], dtype=torch.int32, device=cuda_device)
    end = torch.tensor([0, 1, 700], dtype=torch.int32, device=cuda_device)
    out = decode_attention(q, k, v, start, end)
    assert torch.all(out[0] == 0)
    ref = decode_attention_plain(*_wide(q, k, v, start, end))
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
@pytest.mark.parametrize("with_new", [False, True])
def test_decode_kernel_int8_cache_matches_plain_on_card(cuda_device, dtype, rtol, atol, with_new):
    rng = np.random.default_rng(17)
    B, T, Nq, Nkv, H = 3, 300, 8, 2, 64
    q = _t(_normal(rng, (B, Nq, H))).to(cuda_device, dtype)
    (k8, ks), (v8, vs) = (quantize_kv(_t(_normal(rng, (B, T, Nkv, H))).to(cuda_device))
                          for _ in range(2))
    start = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    end = torch.tensor([0, 129, 300], dtype=torch.int32, device=cuda_device)
    args = [q, k8, v8, start, end, ks, vs]
    if with_new:
        args += [_t(_normal(rng, (B, Nkv, H))).to(cuda_device, dtype) for _ in range(2)]
    out = decode_attention(*args)
    ref = decode_attention_plain(*_wide(*args))
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    if with_new:  # an empty prefix leaves the current token alone
        torch.testing.assert_close(out[0].float(), args[8][0].float().repeat_interleave(4, 0),
                                   rtol=rtol, atol=atol)
    else:
        assert torch.all(out[0] == 0)


def _decode_args(rng, device, dtype, B, T, Nq, Nkv, H, starts, ends, int8, with_new=False):
    q = _t(_normal(rng, (B, Nq, H))).to(device, dtype)
    start = torch.tensor(starts, dtype=torch.int32, device=device)
    end = torch.tensor(ends, dtype=torch.int32, device=device)
    if not int8:
        k, v = (_t(_normal(rng, (B, T, Nkv, H))).to(device, dtype) for _ in range(2))
        return [q, k, v, start, end]
    (k8, ks), (v8, vs) = (quantize_kv(_t(_normal(rng, (B, T, Nkv, H))).to(device))
                          for _ in range(2))
    new = [_t(_normal(rng, (B, Nkv, H))).to(device, dtype) for _ in range(2)] if with_new else []
    return [q, k8, v8, start, end, ks, vs, *new]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_decode_rows_do_not_depend_on_the_batch_and_repeat(cuda_device, dtype, int8):
    """Eight rows (four CFG streams) equal the same rows called two at a time,
    bit for bit, and a second call gives the same bits: a row's splits come
    from its own range, and every sum runs in a fixed order."""
    rng = np.random.default_rng(20)
    ends = [1537, 1537, 0, 900, 61, 3072, 1, 2000]
    args = _decode_args(rng, cuda_device, dtype, 8, 3072, 16, 4, 128, [0] * 8, ends, int8,
                        with_new=int8)
    n0 = decode_attention.launches
    out = decode_attention(*args)
    assert decode_attention.launches == n0 + 1
    assert torch.equal(decode_attention(*args), out)
    for i in range(0, 8, 2):
        assert torch.equal(decode_attention(*(a[i:i + 2].contiguous() for a in args)),
                           out[i:i + 2])


@pytest.mark.gpu
@pytest.mark.parametrize("int8", [False, True])
def test_decode_slots_outside_the_range_are_never_read(cuda_device, int8):
    rng = np.random.default_rng(21)
    T, starts, ends = 400, [0, 37, 5, 390], [0, 300, 6, 400]
    args = _decode_args(rng, cuda_device, torch.bfloat16, 4, T, 8, 2, 64, starts, ends, int8)
    out = decode_attention(*args)
    slots = torch.arange(T, device=cuda_device)
    outside = (slots[None] < args[3][:, None].long()) | (slots[None] >= args[4][:, None].long())
    poisoned = list(args)
    if int8:  # int8 codes hold no NaN: poison the scales
        poisoned[5], poisoned[6] = (torch.where(outside[..., None], float("nan"), s)
                                    for s in args[5:7])
    else:
        poisoned[1], poisoned[2] = (torch.where(outside[..., None, None], float("nan"), c)
                                    for c in args[1:3])
    assert torch.equal(decode_attention(*poisoned), out)
    assert torch.all(out[0] == 0)


@pytest.mark.gpu
def test_decode_kernel_replays_from_a_cuda_graph(cuda_device):
    rng = np.random.default_rng(22)
    args = _decode_args(rng, cuda_device, torch.bfloat16, 2, 1024, 16, 16, 128, [0, 0],
                        [0, 700], True)
    eager = decode_attention(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = decode_attention(*args)
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
def test_decode_kernel_one_query_head_per_kv_head_with_start(cuda_device, dtype, rtol, atol):
    """G = 1 at H = 128 (Dia's cross-attention) with ranges that start past 0,
    one shorter than the cluster's splits and one empty."""
    rng = np.random.default_rng(23)
    args = _decode_args(rng, cuda_device, dtype, 4, 1024, 16, 16, 128, [100, 1000, 3, 8],
                        [700, 1024, 6, 8], False)
    out = decode_attention(*args)
    ref = decode_attention_plain(*_wide(*args))
    torch.testing.assert_close(out.float(), ref, rtol=rtol, atol=atol)
    assert torch.all(out[3] == 0)


# The GEMV kernels sum K fp32 products in another order than the plain matmul:
# the error scales with the sum of the products' magnitudes (1e-6 of it, ~17
# fp32 ulps; measured on the card at most 0.2e-6), plus the one rounding to bf16.
def _assert_gemv_close(out, ref, x, w_deq, rtol):
    tol = 1e-6 * (x.float().abs() @ w_deq.abs()) + rtol * ref.abs()
    assert bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
@pytest.mark.parametrize("B,K,N,offset", [(2, 512, 1024, 0), (5, 1000, 520, 0), (64, 256, 1027, 0),
                                          (1, 40, 7, 0), (3, 2048, 512, 4), (9, 1000, 1040, 1)])
def test_int8_kernel_matches_plain_on_card(cuda_device, dtype, rtol, atol, B, K, N, offset):
    """``offset`` > 0: the weight is a view that starts that many bytes into
    its storage, so its address is not 16-byte aligned."""
    rng = np.random.default_rng(18)
    qk = quant.quantize_int8(_t(_normal(rng, (K, N))).to(cuda_device))
    values = qk.values
    if offset:
        values = torch.empty(K * N + offset, dtype=torch.int8, device=cuda_device)[offset:]
        values = values.view(K, N)
        values.copy_(qk.values)
        assert values.data_ptr() % 16 != 0 and values.is_contiguous()
    x = _t(_normal(rng, (B, K))).to(cuda_device, dtype)
    scale = qk.scale.reshape(N)
    out = int8_matmul(x, values, scale)
    assert out.dtype == dtype and out.shape == (B, N)
    assert torch.equal(out, int8_matmul(x, values, scale))  # no atomics: repeatable
    _assert_gemv_close(out, int8_matmul_plain(x.float(), qk.values, scale), x,
                       quant.dequantize(qk), rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("K,N", [(2048, 2048), (1000, 1027)])
def test_int8_rows_do_not_depend_on_the_batch(cuda_device, dtype, K, N):
    """The rows of a B = 8 and a B = 64 call equal the same rows called two
    at a time, bit for bit, and a second call gives the same bits: the
    slices come from the weight's shape, never from B."""
    rng = np.random.default_rng(24)
    qk = quant.quantize_int8(_t(_normal(rng, (K, N))).to(cuda_device))
    scale = qk.scale.reshape(N)
    x = _t(_normal(rng, (64, K))).to(cuda_device, dtype)
    for B in (8, 64):
        out = int8_matmul(x[:B].contiguous(), qk.values, scale)
        assert torch.equal(int8_matmul(x[:B].contiguous(), qk.values, scale), out)
        for i in range(0, B, 2):
            assert torch.equal(int8_matmul(x[i:i + 2].contiguous(), qk.values, scale),
                               out[i:i + 2])


@pytest.mark.gpu
@pytest.mark.parametrize("B", [2, 64])
def test_int8_bf16_call_is_one_kernel(cuda_device, B):
    """A bf16 call runs one kernel (no finish pass) and allocates nothing
    but its output: a CUDA graph that captures one call holds one node."""
    import chip_smoke

    rng = np.random.default_rng(25)
    qk = quant.quantize_int8(_t(_normal(rng, (2048, 2048))).to(cuda_device))
    x = _t(_normal(rng, (B, 2048))).to(cuda_device, torch.bfloat16)
    scale = qk.scale.reshape(-1)
    int8_matmul(x, qk.values, scale)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = int8_matmul(x, qk.values, scale)
    assert torch.cuda.memory_allocated() - before == out.untyped_storage().nbytes()
    assert chip_smoke.kernels_per_call(torch, lambda: int8_matmul(x, qk.values, scale)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
@pytest.mark.parametrize("B,K,N,group,layout,offset", [
    (2, 512, 1024, 128, "halfsplit", 0), (2, 512, 1024, None, "halfsplit", 0),
    (5, 1000, 520, 50, "parity", 0), (64, 256, 1027, None, "parity", 0),
    (3, 256, 36, 128, "parity", 0), (3, 1000, 520, 100, "halfsplit", 0),
    (8, 2048, 9252, 128, "halfsplit", 4), (64, 2048, 9252, 128, "halfsplit", 1),
    (2, 2048, 9252, None, "parity", 4),
    (3, 1023, 520, 33, "unpacked", 0), (2, 63, 7, None, "unpacked", 0)])
def test_int4_kernel_matches_plain_on_card(cuda_device, dtype, rtol, atol, B, K, N, group, layout,
                                           offset):
    """``offset`` > 0: the bytes are a view that starts that many bytes into
    its storage, so its address is not 16-byte aligned (4: copies of 4 bytes;
    1: single bytes)."""
    rng = np.random.default_rng(19)
    qk = quant.quantize_int4(_t(_normal(rng, (K, N))).to(cuda_device), group=group,
                             halfsplit=layout == "halfsplit")
    assert (qk.layout, qk.group) == (layout, group)
    values = qk.values
    if offset:
        values = torch.empty(values.numel() + offset, dtype=torch.int8, device=cuda_device)
        values = values[offset:].view(qk.values.shape)
        values.copy_(qk.values)
        assert values.data_ptr() % 16 != 0 and values.is_contiguous()
    x = _t(_normal(rng, (B, K))).to(cuda_device, dtype)
    out = int4_gemv(x, values, qk.scale, layout)
    assert out.dtype == dtype and out.shape == (B, N)
    assert torch.equal(out, int4_gemv(x, values, qk.scale, layout))
    _assert_gemv_close(out, int4_gemv_plain(x.float(), qk.values, qk.scale, layout), x,
                       quant.dequantize4(qk), rtol)


INT4_FORMS = [(128, "halfsplit"), (None, "halfsplit"), (128, "parity"), (None, "parity")]


@pytest.mark.gpu
@pytest.mark.parametrize("K,N,group,layout", [(2048, 2048, g, lay) for g, lay in INT4_FORMS] + [
    (1000, 1027, None, "halfsplit"), (1000, 1027, 100, "halfsplit"), (1000, 1027, 50, "parity")])
def test_int4_rows_do_not_depend_on_the_batch(cuda_device, K, N, group, layout):
    """bf16: the rows of a B = 8 and a B = 64 call equal the same rows called
    two at a time and one at a time, bit for bit, and a second call gives the
    same bits: the slices and the scale flushes come from the weight's shape,
    never from B."""
    rng = np.random.default_rng(26)
    qk = quant.quantize_int4(_t(_normal(rng, (K, N))).to(cuda_device), group=group,
                             halfsplit=layout == "halfsplit")
    assert (qk.layout, qk.group) == (layout, group)
    x = _t(_normal(rng, (64, K))).to(cuda_device, torch.bfloat16)
    for B in (8, 64):
        out = int4_gemv(x[:B].contiguous(), qk.values, qk.scale, layout)
        assert torch.equal(int4_gemv(x[:B].contiguous(), qk.values, qk.scale, layout), out)
        for i in range(0, B, 2):
            assert torch.equal(int4_gemv(x[i:i + 2].contiguous(), qk.values, qk.scale, layout),
                               out[i:i + 2])
        for i in (0, B - 1):
            assert torch.equal(int4_gemv(x[i:i + 1].contiguous(), qk.values, qk.scale, layout),
                               out[i:i + 1])


@pytest.mark.gpu
@pytest.mark.parametrize("group,layout", INT4_FORMS)
@pytest.mark.parametrize("B", [1, 2, 8, 64])
def test_int4_bf16_call_is_one_kernel(cuda_device, group, layout, B):
    """A bf16 call of either nibble layout runs one kernel (no finish pass)
    and allocates nothing but its output: a CUDA graph that captures one call
    holds one node.  (``torch.profiler`` is not asked: on the card its short
    sessions returned no CUDA events for this kernel after a process's first
    session, while the graph's node count is exact.)"""
    import chip_smoke

    rng = np.random.default_rng(27)
    qk = quant.quantize_int4(_t(_normal(rng, (2048, 2048))).to(cuda_device), group=group,
                             halfsplit=layout == "halfsplit")
    assert (qk.layout, qk.group) == (layout, group)
    x = _t(_normal(rng, (B, 2048))).to(cuda_device, torch.bfloat16)
    int4_gemv(x, qk.values, qk.scale, layout)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    out = int4_gemv(x, qk.values, qk.scale, layout)
    assert torch.cuda.memory_allocated() - before == out.untyped_storage().nbytes()
    assert chip_smoke.kernels_per_call(torch, lambda: int4_gemv(x, qk.values, qk.scale,
                                                                layout)) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("D", [2048, 1024])
def test_rms_norm_rows_do_not_depend_on_the_batch(cuda_device, D):
    """A row's RMSNorm is the same bits whether the call holds 1, 2, 8, 20
    or 64 rows of one token, or 2048 rows (the decode step's and the
    encoder's shapes)."""
    from dia_tts_prune_tpu_torch.ops.modules import rms_norm

    rng = np.random.default_rng(28)
    x = _t(_normal(rng, (2048, 1, D))).to(cuda_device, torch.bfloat16)
    scale = _t(_normal(rng, (D,))).to(cuda_device, torch.bfloat16)
    full = rms_norm(x, scale, 1e-5)
    for B in (1, 2, 8, 20, 64):
        for i in (0, 5, 64 - B):
            assert torch.equal(rms_norm(x[i:i + B], scale, 1e-5), full[i:i + B])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [((2048,), (9, 1028)), ((2048,), (2048,)), ((2048,), (512,)),
                                   ((2048,), (2, 8192)), ((8192,), (2048,)), ((16, 128), (2048,))])
def test_float_dense_rows_do_not_depend_on_the_batch(cuda_device, dtype, shape):
    """A float decode-step contraction (``dense_general``, up to 64 rows)
    gives a row the same bits whether the call holds 1, 2, 4, 8, 16 or 64
    rows: the Dia-1.6B decode shapes, the logits head (2048 x 9 x 1028)
    first, whose cuBLAS sums at 4 rows once differed from those at 2."""
    from dia_tts_prune_tpu_torch.ops.modules import dense_general

    k_in, k_out = shape
    rng = np.random.default_rng(31)
    kernel = _t(_normal(rng, k_in + k_out) / np.sqrt(np.prod(k_in))).to(cuda_device, dtype)
    x = _t(_normal(rng, (64, 1, *k_in))).to(cuda_device, dtype)
    axis = tuple(range(-len(k_in), 0))
    full = dense_general(x, kernel, axis)
    assert full.shape == (64, 1, *k_out)
    for B in (1, 2, 4, 8, 16, 64):
        for i in (0, 6, 64 - B):
            assert torch.equal(dense_general(x[i:i + B], kernel, axis), full[i:i + B]), (B, i)


@pytest.mark.gpu
def test_batched_lanes_equal_single_stream_runs_op_for_op(cuda_device):
    """``chip_smoke.batch_lane_probe`` on the card: each of four batched
    streams of ``trained_small`` (bf16) equals its single-stream run in every
    op of the conditioning and the first decode steps, and in its codes."""
    from pathlib import Path

    import chip_smoke
    from dia_tts_prune_tpu_torch import Dia

    dia = Dia.from_pretrained(Path(__file__).parent / "fixtures" / "trained_small",
                              compute_dtype="bfloat16", device="cuda")
    texts = ["[S1] The birch canoe slid. [S2]", "[S2] Hello there, friend.", "[S1] Three.",
             "[S2] A fourth stream, a little longer than the others. [S1] Yes."]
    for lane in range(len(texts)):
        rec = chip_smoke.batch_lane_probe(torch, dia, texts, lane, steps=3, max_tokens=64)
        assert rec["first_differing_op"] is None, rec
    kw = dict(max_tokens=64, temperature=0.0)
    for out, t in zip(dia.generator.generate_tokens_batch(texts, **kw), texts):
        np.testing.assert_array_equal(out, dia.generate_codes(t, **kw))


@pytest.mark.gpu
def test_gemv_wrappers_raise_on_the_card(cuda_device):
    """On CUDA tensors the wrappers raise on what the kernels do not take;
    they do not give way to the plain versions."""
    x = torch.zeros(65, 64, device=cuda_device)
    w = torch.zeros(64, 48, dtype=torch.int8, device=cuda_device)
    s = torch.zeros(48, device=cuda_device)
    with pytest.raises(ValueError, match="rows"):
        int8_matmul(x, w, s)
    with pytest.raises(ValueError, match="rows"):
        int4_gemv(x, w[:32].contiguous(), s)
    with pytest.raises(TypeError):
        int8_matmul(x[:2].half(), w, s)
    with pytest.raises(ValueError, match="one device"):
        int8_matmul(x[:2].contiguous(), w, s.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        int4_gemv(x[:2].contiguous(), w[::2], s)
    q = torch.zeros(2, 4, 64, device=cuda_device)
    k8 = torch.zeros(2, 8, 2, 64, dtype=torch.int8, device=cuda_device)
    ends = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    with pytest.raises(TypeError):
        decode_attention(q, k8, k8, ends, ends)  # int8 caches without scales


def _sparse_case(rng, K, N, bk, bn, device, dtype):
    """A weight with about half its blocks zeroed and its first N-tile empty,
    its plan, and the weight with NaN in every unlisted block."""
    w = _normal(rng, (K, N)) / np.sqrt(K)
    kept = rng.random((-(-K // bk), -(-N // bn))) < 0.5
    kept[0, -1], kept[:, 0] = True, False
    w = _t(w * np.repeat(np.repeat(kept, bk, 0), bn, 1)[:K, :N]).to(device, dtype)
    plan = plan_block_sparsity(w, bk, bn)
    idx, cnt = plan.indices.to(device), plan.counts.to(device)
    poisoned = torch.where(listed_mask(idx, cnt, K, N, bk, bn), w, float("nan"))
    return w, idx, cnt, poisoned


# shapes with ragged K and N, small blocks, and a decode shape at 256 x 256
SPARSE_SHAPES = [(100, 150, 32, 64), (40, 37, 8, 16), (2048, 9252, 256, 256)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
@pytest.mark.parametrize("K,N,bk,bn", SPARSE_SHAPES)
@pytest.mark.parametrize("M", [1, 2, 8, 70])
def test_block_sparse_kernel_matches_plain_on_card(cuda_device, dtype, rtol, atol, K, N, bk, bn,
                                                   M):
    """Against the plain version in fp32 on the same values, within the GEMV
    tolerance (sums of listed products in another order); NaN in every
    unlisted block changes nothing; an empty tile gives exact zeros; the
    result is bit-identical from run to run."""
    rng = np.random.default_rng(24)
    w, idx, cnt, poisoned = _sparse_case(rng, K, N, bk, bn, cuda_device, dtype)
    x = _t(_normal(rng, (M, K))).to(cuda_device, dtype)
    out = block_sparse_matmul(x, w, idx, cnt, bk, bn)
    assert out.dtype == dtype and out.shape == (M, N)
    ref = block_sparse_matmul_plain(x.float(), w.float(), idx, cnt, bk, bn)
    _assert_gemv_close(out, ref, x, w.float(), rtol)
    assert torch.all(out[:, :bn] == 0)
    assert torch.equal(block_sparse_matmul(x, poisoned, idx, cnt, bk, bn), out)
    assert torch.equal(block_sparse_matmul(x, w, idx, cnt, bk, bn), out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,N", [(64, 2048), (512, 16384)])
def test_block_sparse_rows_do_not_depend_on_the_row_count(cuda_device, dtype, M, N):
    """Row i of an M-row product equals the same row computed with 2, 8 or
    16 rows: batched lanes repeat their single-stream runs.  In bf16 the 64
    rows take 64-row tiles and the 512 rows 128-row tiles in which one block
    runs every slice; 2-16 rows take 16-row tiles with a finish pass."""
    rng = np.random.default_rng(25)
    w, idx, cnt, _ = _sparse_case(rng, 2048, N, 256, 256, cuda_device, dtype)
    x = _t(_normal(rng, (M, 2048))).to(cuda_device, dtype)
    full = block_sparse_matmul(x, w, idx, cnt, 256, 256)
    for rows in (2, 8, 16):
        for r0 in range(0, M, rows if M <= 64 else 8 * rows):
            assert torch.equal(block_sparse_matmul(x[r0:r0 + rows].contiguous(), w, idx, cnt,
                                                   256, 256), full[r0:r0 + rows])


@pytest.mark.gpu
@pytest.mark.parametrize("M,K,N,bk,bn", [(70, 2048, 2048, 256, 256), (130, 1024, 9252, 256, 256),
                                         (40, 320, 200, 32, 64)])
def test_block_sparse_bf16_tiles_and_slice_maps_agree_on_card(cuda_device, M, K, N, bk, bn):
    """Every bf16 tile (16, 64, 128 rows) and both slice maps (a block per
    slice with the finish pass, or one block running every slice) give the
    same bits: a row's sum does not depend on its place in a tile."""
    from dia_tts_prune_tpu_torch.ops.kernels import sparse_matmul as tsm

    rng = np.random.default_rng(26)
    w, idx, cnt, poisoned = _sparse_case(rng, K, N, bk, bn, cuda_device, torch.bfloat16)
    x = _t(_normal(rng, (M, K))).to(cuda_device, torch.bfloat16)
    vec = tsm.vector_width(torch.bfloat16, K, N, bk, bn, x.data_ptr(), w.data_ptr())
    n_split = tsm.bf16_split(N, bk, bn, idx.shape[1])
    assert vec >= 4 and n_split > 1
    ref = tsm.launch(x, w, idx, cnt, bk, bn, vec, n_split, 0, False)
    for tile, fused in ((1, False), (1, True), (2, False), (2, True)):
        assert torch.equal(tsm.launch(x, w, idx, cnt, bk, bn, vec, n_split, tile, fused), ref)
        assert torch.equal(tsm.launch(x, poisoned, idx, cnt, bk, bn, vec, n_split, tile, fused),
                           ref)
    assert torch.equal(block_sparse_matmul(x, w, idx, cnt, bk, bn), ref)


@pytest.mark.gpu
def test_block_sparse_wrapper_raises_on_the_card(cuda_device):
    x = torch.zeros(3, 64, device=cuda_device)
    w = torch.zeros(64, 128, device=cuda_device)
    idx = torch.zeros(2, 1, dtype=torch.int32, device=cuda_device)
    cnt = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    assert torch.equal(block_sparse_matmul(x, w, idx, cnt, 32, 64), torch.zeros_like(x[:, :1])
                       .expand(3, 128))
    with pytest.raises(TypeError):
        block_sparse_matmul(x.bfloat16(), w, idx, cnt, 32, 64)
    with pytest.raises(ValueError, match="one device"):
        block_sparse_matmul(x, w, idx.cpu(), cnt, 32, 64)
    with pytest.raises(ValueError, match="plan"):
        block_sparse_matmul(x, w, idx, cnt, 32, 32)


# ---------------------------------------------------------------------------
# the fused decode step
# ---------------------------------------------------------------------------

FUSED_DIMS = dict(L=3, D=256, F=1024, Nq=4, Nkv=2, Ncq=4, H=64)  # trained_small's widths
# both sides round xn, sa, ca and h (and the RoPE partner) to bf16: fp32 sums
# in another order flip some of those roundings, which later layers carry on;
# 2e-2 of each output's largest magnitude (the JAX package's kernel gate)
FUSED_TOL = 2e-2


def _fused_pack(device, int4, seed=0):
    from dia_tts_prune_tpu_torch.ops.kernels.fused_step import repack_decoder_fused

    g = torch.Generator(device="cpu").manual_seed(seed)
    L, D, F, Nq, Nkv, Ncq, H = FUSED_DIMS.values()

    def dense(*shape, fan_in):
        return {"kernel": torch.randn(L, *shape, generator=g) / fan_in ** 0.5}

    ones = {"scale": torch.ones(L, D)}
    params = {"decoder": {"layers": {
        "pre_sa_norm": ones, "pre_ca_norm": ones, "pre_mlp_norm": ones,
        "self_attention": {"q_proj": dense(D, Nq, H, fan_in=D), "k_proj": dense(D, Nkv, H, fan_in=D),
                           "v_proj": dense(D, Nkv, H, fan_in=D),
                           "o_proj": dense(Nq, H, D, fan_in=Nq * H)},
        "cross_attention": {"q_proj": dense(D, Ncq, H, fan_in=D),
                            "o_proj": dense(Ncq, H, D, fan_in=Ncq * H)},
        "mlp": {"wi_fused": dense(D, 2, F, fan_in=D), "wo": dense(F, D, fan_in=F)}}}}
    return repack_decoder_fused(params, mlp_int4=int4).to(device)


def _fused_inputs(device, B, kind, T=96, S=40, write_slot=70, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    L, D, F, Nq, Nkv, Ncq, H = FUSED_DIMS.values()
    caches = [torch.randn(L, B, n, h, H, generator=g) for n, h in ((T, Nkv), (T, Nkv),
                                                                  (S, Ncq), (S, Ncq))]
    scales = [None] * 4
    if kind == torch.int8:
        q = [quantize_kv(c) for c in caches]
        caches, scales = [c for c, _ in q], [s for _, s in q]
    else:
        caches = [c.to(kind) for c in caches]
    n = B // 2
    off = [(5 * i) % 30 for i in range(n)] * 2
    i32 = dict(dtype=torch.int32, device=device)
    dev = lambda t: None if t is None else t.to(device)  # noqa: E731
    return dict(x_emb=(0.1 * torch.randn(B, D, generator=g)).to(device),
                position=torch.tensor([write_slot + 1 - o for o in off], **i32),
                write_slot=write_slot, self_k=dev(caches[0]), self_v=dev(caches[1]),
                cross_k=dev(caches[2]), cross_v=dev(caches[3]),
                cross_ends=torch.tensor([0] * n + [S - 3 * i for i in range(n)], **i32),
                valid_from=torch.tensor(off, **i32), self_ks=dev(scales[0]),
                self_vs=dev(scales[1]), cross_ks=dev(scales[2]), cross_vs=dev(scales[3]))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("int4", [False, True])
@pytest.mark.parametrize("B", [2, 6, 36])  # 36: five n-tiles of 8 rows
def test_fused_kernel_matches_plain_on_card(cuda_device, kind, int4, B):
    from dia_tts_prune_tpu_torch.ops.kernels import fused_decode_step, fused_decode_step_plain

    pack = _fused_pack(cuda_device, int4)
    inp = _fused_inputs(cuda_device, B, kind)
    n0 = fused_decode_step.launches
    out = fused_decode_step(pack, **inp)
    assert fused_decode_step.launches == n0 + 1
    ref = fused_decode_step_plain(pack, **inp)
    for o, r in zip(out, ref):
        assert o.dtype == r.dtype and o.shape == r.shape
        err = (o.float() - r.float()).abs().max().item()
        assert err <= FUSED_TOL * r.float().abs().max().item(), err
    again = fused_decode_step(pack, **inp)
    assert all(torch.equal(a, b) for a, b in zip(out, again))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", [torch.bfloat16, torch.int8])
def test_fused_rows_do_not_depend_on_the_batch_or_poison(cuda_device, kind):
    """Rows of a 36-row step (five of the kernel's n-tiles of 8 rows) equal the same
    rows run 2 or 6 at a time, bit for bit; NaN wherever a row may not read
    leaves every output as it was."""
    from dia_tts_prune_tpu_torch.ops.kernels import fused_decode_step

    pack = _fused_pack(cuda_device, False)
    B = 36
    inp = _fused_inputs(cuda_device, B, kind)
    full = fused_decode_step(pack, **inp)
    rows = ("x_emb", "position", "cross_ends", "valid_from")
    for pair in ([0, 18], [17, 35], [2, 15, 16, 20, 33, 34]):
        idx = torch.tensor(pair, device=cuda_device)
        sub = {k: v.index_select(0, idx) if k in rows else
               v.index_select(1, idx).contiguous() if isinstance(v, torch.Tensor) else v
               for k, v in inp.items()}
        part = fused_decode_step(pack, **sub)
        assert torch.equal(part[0], full[0][idx])
        assert all(torch.equal(p, f[:, idx]) for p, f in zip(part[1:], full[1:]))
    poisoned = dict(inp)
    names = ("self_ks", "self_vs", "cross_ks", "cross_vs") if kind == torch.int8 else (
        "self_k", "self_v", "cross_k", "cross_v")
    for n in names:
        t = poisoned[n].clone()
        size = t.shape[2]
        for b in range(B):
            at = torch.arange(size, device=cuda_device)
            if n.startswith("self"):
                bad = (at < int(inp["valid_from"][b])) | (at >= inp["write_slot"])
            else:
                bad = at >= int(inp["cross_ends"][b])
            t[:, b, bad] = float("nan")
        poisoned[n] = t
    assert all(torch.equal(a, b) for a, b in zip(fused_decode_step(pack, **poisoned), full))


@pytest.mark.gpu
def test_fused_wrapper_raises_on_the_card(cuda_device):
    from dia_tts_prune_tpu_torch.ops.kernels import fused_decode_step

    pack = _fused_pack(cuda_device, False)
    inp = _fused_inputs(cuda_device, 2, torch.bfloat16)
    for change in (dict(write_slot=96), dict(self_k=inp["self_k"].half()),
                   dict(cross_ends=inp["cross_ends"].long()), dict(self_ks=inp["cross_ends"])):
        with pytest.raises((TypeError, ValueError)):
            fused_decode_step(pack, **dict(inp, **change))


@pytest.mark.gpu
def test_fused_batch_of_nine_streams_on_card(cuda_device):
    """Nine streams (18 rows, more than the kernel stages at once) through
    ``quantize_int8(fused=True)``: one fused launch a decode step, no
    decode-attention launch, and every stream's codes."""
    from pathlib import Path

    from dia_tts_prune_tpu_torch import Dia
    from dia_tts_prune_tpu_torch.ops.kernels import launch_counts, reset_launch_counts

    dia = Dia.from_pretrained(Path(__file__).parent / "fixtures" / "trained_small",
                              device=cuda_device)
    dia.quantize_int8(fused=True)
    texts = [f"[S1] Stream number {i} speaks. [S2]" for i in range(9)]
    reset_launch_counts()
    outs = dia.generator.generate_tokens_batch(texts, max_tokens=24, temperature=0.0)
    counts = launch_counts()
    assert len(outs) == 9 and all(o.ndim == 2 and o.shape[1] == dia.config.data.channels
                                  for o in outs)
    assert counts["fused_decode_step"] > 0 and counts["decode_attention"] == 0


# ---------------------------------------------------------------------------
# the decode loop replayed from CUDA graphs
# ---------------------------------------------------------------------------

GRAPH_ROUTES = ["float", "int8", "int4", "fused_int8", "batched"]


def _graph_model(device, route):
    from pathlib import Path

    from dia_tts_prune_tpu_torch import Dia

    dia = Dia.from_pretrained(Path(__file__).parent / "fixtures" / "trained_small",
                              compute_dtype="bfloat16", device=device)
    if route == "int8":
        dia.quantize_int8()
    elif route == "int4":
        dia.quantize_int4()
    elif route == "fused_int8":
        dia.quantize_int8(fused=True)
    return dia


def _graph_run(dia, route, loop, **kw):
    texts = ["[S1] The birch canoe slid. [S2]", "[S2] Hello there, friend.", "[S1] Three."]
    if route == "batched":
        return dia.generator.generate_tokens_batch(texts, loop=loop, seeds=[3, 4, 5], **kw)
    return [dia.generator.generate_tokens(texts[0], loop=loop, seed=3, **kw)]


@pytest.mark.gpu
@pytest.mark.parametrize("route", GRAPH_ROUTES)
@pytest.mark.parametrize("temperature", [0.0, 1.3])
def test_graph_codes_equal_eager_codes(cuda_device, route, temperature):
    """The graph loop (the default on the card) and the eager loop run the
    same kernels in the same order: greedy and seeded-sampled codes equal
    bit for bit, on every route, and each step's launches were made by the
    host only while warming up and capturing."""
    from dia_tts_prune_tpu_torch.generate import GRAPH_STEPS, WARMUP_STEPS

    dia = _graph_model(cuda_device, route)
    kw = dict(max_tokens=80, temperature=temperature)
    eager = _graph_run(dia, route, "eager", **kw)
    graph = _graph_run(dia, route, None, **kw)
    stats = dia.generator.last_stats
    assert stats.loop == "graph" and stats.replays > 0
    assert stats.host_steps == WARMUP_STEPS + GRAPH_STEPS
    assert all(e.shape[0] > 0 for e in eager)
    for e, g in zip(eager, graph):
        np.testing.assert_array_equal(g, e)


@pytest.mark.gpu
def test_graph_second_call_of_a_key_captures_nothing_new(cuda_device):
    """A second call with the same key (streams, cache length, cross window,
    caches, sampling scalars) replays the kept graph: no capture, no step
    launched from the host, the same graph object, and the same codes; a
    call with other sampling scalars captures its own."""
    dia = _graph_model(cuda_device, "float")
    kw = dict(max_tokens=80, temperature=0.0)
    first = _graph_run(dia, "float", None, **kw)
    graphs = dict(dia.generator._graphs)
    again = _graph_run(dia, "float", None, **kw)
    stats = dia.generator.last_stats
    assert stats.host_steps == 0 and stats.capture_seconds == 0.0 and stats.replays > 0
    assert dict(dia.generator._graphs) == graphs
    assert all(dia.generator._graphs[k].graph is b.graph for k, b in graphs.items())
    np.testing.assert_array_equal(again[0], first[0])
    _graph_run(dia, "float", None, max_tokens=80, temperature=1.3)
    assert len(dia.generator._graphs) == len(graphs) + 1


@pytest.mark.gpu
def test_host_read_inside_a_captured_step_raises(cuda_device, monkeypatch):
    """A step that reads the device back (a planted ``.item()``) cannot be
    captured: the graph loop raises instead of falling back to the eager
    loop."""
    import dia_tts_prune_tpu_torch.generate as gen

    dia = _graph_model(cuda_device, "float")
    real = gen.step_function

    def reading_step(params):
        step = real(params)

        def step_with_read(*args, **kwargs):
            logits = step(*args, **kwargs)
            logits[0, 0, 0, 0].item()
            return logits

        return step_with_read

    monkeypatch.setattr(gen, "step_function", reading_step)
    with pytest.raises(Exception):
        _graph_run(dia, "float", None, max_tokens=80, temperature=0.0)
    monkeypatch.setattr(gen, "step_function", real)
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# streaming segments and concurrent calls on the graph loop
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("temperature", [0.0, 1.3])
def test_graph_stream_codes_equal_generate_tokens(cuda_device, temperature):
    """Streamed segments run exactly their steps on the graph loop (16-step
    replays, then one-step replays): the chunks concatenate to
    ``generate_tokens``'s codes bit for bit, seeded draws included, at every
    segment length, on a cold key and on a warm one."""
    dia = _graph_model(cuda_device, "float")
    gen = dia.generator
    kw = dict(max_tokens=200, temperature=temperature, seed=3)
    text = "[S1] The birch canoe slid. [S2]"
    for segment_steps in (16, 20, 24, 128, 7):
        gen._graphs.clear()  # a cold key first
        captures = []
        for _ in range(2):
            chunks = list(gen.generate_tokens_stream(text, segment_steps=segment_steps, **kw))
            stats = gen.last_stats
            assert stats.loop == "graph" and stats.replays + stats.step_replays > 0
            captures.append(stats.captures)
            np.testing.assert_array_equal(np.concatenate(chunks),
                                          gen.generate_tokens(text, **kw))
        assert captures[0] > 0 and captures[1] == 0  # the stream gave its buffers back


@pytest.mark.gpu
def test_threads_on_one_key_get_their_solo_results_on_card(cuda_device):
    """Threads that call one key at once (codes, a stream of that key, a
    stream closed after its first chunk), then the server: each gets the
    result it gets alone (``DiaGenerator.lock``; a stream owns its key's
    buffers until it ends)."""
    import json
    import threading
    import urllib.request

    from dia_tts_prune_tpu_torch.app import make_server

    dia = _graph_model(cuda_device, "float")
    gen = dia.generator
    text = "[S1] The birch canoe slid. [S2]"
    kw = dict(max_tokens=120, temperature=1.3)
    solo = {s: gen.generate_tokens(text, seed=s, **kw) for s in range(3)}
    results, errors = {}, []

    def call(i):
        try:
            if i < 3:
                results[i] = gen.generate_tokens(text, seed=i, **kw)
            elif i == 3:
                results[i] = np.concatenate(list(gen.generate_tokens_stream(
                    text, segment_steps=20, seed=0, **kw)))
            else:
                stream = gen.generate_tokens_stream(text, segment_steps=20, seed=1, **kw)
                next(stream)
                stream.close()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(5)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not any(t.is_alive() for t in threads)
    for i in range(3):
        np.testing.assert_array_equal(results[i], solo[i])
    np.testing.assert_array_equal(results[3], solo[0])
    np.testing.assert_array_equal(gen.generate_tokens(text, seed=1, **kw), solo[1])

    server = make_server(dia, host="127.0.0.1", port=0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}/generate"
    body = json.dumps({"text": text, "max_new_tokens": 120, "temperature": 1.3,
                       "seed": 2}).encode()
    out = {}

    def post(i):
        req = urllib.request.Request(url, data=body, headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as r:
            out[i] = r.read()

    try:
        clients = [threading.Thread(target=post, args=(i,)) for i in range(2)]
        for c in clients:
            c.start()
        for c in clients:
            c.join(timeout=600)
    finally:
        server.shutdown()
        server.server_close()
    assert len(out) == 2 and out[0] == out[1] and out[0][:4] == b"RIFF"


# ---------------------------------------------------------------------------
# continuous batching: resident lanes, one graph a batcher
# ---------------------------------------------------------------------------

CB_TEXTS = ["[S1] The birch canoe slid. [S2]", "[S2] Hello there, friend.", "[S1] Three.",
            "[S2] A fourth request, admitted late. [S1] Yes.", "[S1] And a fifth."]


def _cb_requests():
    """(text, kwargs) of five requests: greedy and seeded lanes with their own
    temperature, top_p and cfg_scale, one voice-prompted, one shorter cap."""
    from pathlib import Path

    golden = np.load(Path(__file__).parent / "fixtures" / "trained_small" / "golden.npz")
    prompted = dict(audio_prompt_codes=golden["tokens"][:20], audio_prompt_text="[S1] A voice.")
    kws = [dict(temperature=0.0, seed=0), dict(temperature=1.3, seed=5, max_tokens=60),
           dict(temperature=1.1, top_p=0.9, cfg_scale=2.5, seed=9, **prompted),
           dict(temperature=0.0, seed=1, **prompted), dict(temperature=0.9, top_p=0.8,
                                                          cfg_scale=4.0, seed=13)]
    return [(t, {"max_tokens": 128, **kw}) for t, kw in zip(CB_TEXTS, kws)]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["float", "int8"])
def test_cbatch_lanes_equal_their_solo_runs_on_card(cuda_device, route):
    """Five requests through three lanes, the last two queued behind the
    first: each lane's codes equal its solo graph-loop ``generate_tokens``
    bit for bit, greedy and seeded, float and int8 caches; the batcher
    captured one graph."""
    import time

    from dia_tts_prune_tpu_torch.cbatch import ContinuousBatcher

    dia = _graph_model(cuda_device, route)
    reqs = _cb_requests()
    solo = [dia.generator.generate_tokens(t, **kw) for t, kw in reqs]
    cb = ContinuousBatcher(dia, n_slots=3, segment_steps=32, max_tokens=128, text_window=128)
    try:
        futs = [cb.submit(t, **kw) for t, kw in reqs[:3]]
        while cb.stats["segments"] < 1:
            time.sleep(0.005)
        futs += [cb.submit(t, **kw) for t, kw in reqs[3:]]
        outs = [f.result(600) for f in futs]
    finally:
        cb.shutdown()
    assert cb.kv_int8 == (route == "int8") and cb.stats["captures"] == 1
    for i, (out, ref) in enumerate(zip(outs, solo)):
        assert ref.shape[0] > 0
        np.testing.assert_array_equal(out, ref, err_msg=f"request {i}")


@pytest.mark.gpu
def test_sampler_one_form_draws_equal_on_card(cuda_device):
    """The trap of two sampler forms: on CUDA ATen divides by a Python float
    as a multiply by its reciprocal and by a device tensor as a true
    division.  Every route passes the temperature as a device tensor
    (``generate.sample_streams``): a lane of four draws what the one stream
    of a solo call draws, over many steps, and the scaled logits are the
    correctly rounded quotients."""
    from types import SimpleNamespace

    from dia_tts_prune_tpu_torch.generate import sample_streams

    rng = np.random.default_rng(4)
    temps, top_p = [0.0, 0.9, 1.3, 1.1], [1.0, 0.95, 0.9, 0.8]

    def state(idx):
        return SimpleNamespace(
            temperature=torch.tensor([temps[i] for i in idx], device=cuda_device),
            top_p=torch.tensor([top_p[i] for i in idx], device=cuda_device),
            greedy=torch.tensor([temps[i] == 0.0 for i in idx], device=cuda_device))

    lanes, solo = state(range(4)), state([2])
    gens = [torch.Generator(device=cuda_device).manual_seed(s) for s in (1, 2, 7, 3)]
    one = [torch.Generator(device=cuda_device).manual_seed(7)]
    for _ in range(400):
        guided = _t(rng.normal(size=(4, 9, 1028)).astype(np.float32) * 4).to(cuda_device)
        batch = sample_streams(guided, lanes, 35, gens)
        alone = sample_streams(guided[2:3], solo, 35, one)
        assert torch.equal(batch[2], alone[0])
        assert torch.equal(batch[0], guided[0].argmax(-1))  # the greedy lane
    quotient = guided / lanes.temperature[2]
    assert torch.equal(quotient, (guided.double() / lanes.temperature[2].double()).float())


@pytest.mark.gpu
def test_cbatch_captures_one_graph_and_replays_it(cuda_device):
    """The batcher captures its graph at construction (every lane idle) and
    never again: later segments, mixed greedy and seeded lanes, replay that
    graph; no step is issued from the host after the capture.  A segment
    that is not whole replays raises."""
    from dia_tts_prune_tpu_torch.cbatch import ContinuousBatcher
    from dia_tts_prune_tpu_torch.generate import GRAPH_STEPS, WARMUP_STEPS

    dia = _graph_model(cuda_device, "float")
    with pytest.raises(ValueError, match="multiple"):
        ContinuousBatcher(dia, n_slots=2, segment_steps=20)
    cb = ContinuousBatcher(dia, n_slots=2, segment_steps=16, max_tokens=128, text_window=128)
    graph = cb._buffers.graph
    try:
        assert cb.stats["captures"] == 1 and graph is not None
        reqs = _cb_requests()
        outs = [cb.submit(t, **kw).result(600) for t, kw in reqs[:2]]
    finally:
        cb.shutdown()
    assert cb.stats["segments"] >= 4 and cb.stats["replays"] == cb.stats["steps"] // GRAPH_STEPS
    assert cb._buffers.graph is graph and cb.run_stats.captures == 1
    assert cb.run_stats.host_steps == WARMUP_STEPS + GRAPH_STEPS
    assert all(o.shape[0] > 0 for o in outs)
