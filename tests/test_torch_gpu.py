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
    decode_attention,
    decode_attention_plain,
    flash_attention,
    flash_attention_plain,
    int4_gemv,
    int4_gemv_plain,
    int8_matmul,
    int8_matmul_plain,
)


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


# The GEMV kernels sum K fp32 products in another order than the plain matmul:
# the error scales with the sum of the products' magnitudes (1e-6 of it, ~17
# fp32 ulps; measured on the card at most 0.2e-6), plus the one rounding to bf16.
def _assert_gemv_close(out, ref, x, w_deq, rtol):
    tol = 1e-6 * (x.float().abs() @ w_deq.abs()) + rtol * ref.abs()
    assert bool(((out.float() - ref).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
@pytest.mark.parametrize("B,K,N", [(2, 512, 1024), (5, 1000, 520), (64, 256, 1027), (1, 40, 7)])
def test_int8_kernel_matches_plain_on_card(cuda_device, dtype, rtol, atol, B, K, N):
    rng = np.random.default_rng(18)
    qk = quant.quantize_int8(_t(_normal(rng, (K, N))).to(cuda_device))
    x = _t(_normal(rng, (B, K))).to(cuda_device, dtype)
    scale = qk.scale.reshape(N)
    out = int8_matmul(x, qk.values, scale)
    assert out.dtype == dtype and out.shape == (B, N)
    assert torch.equal(out, int8_matmul(x, qk.values, scale))  # no atomics: repeatable
    _assert_gemv_close(out, int8_matmul_plain(x.float(), qk.values, scale), x,
                       quant.dequantize(qk), rtol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,rtol,atol", TOLS)
@pytest.mark.parametrize("B,K,N,group,layout", [
    (2, 512, 1024, 128, "halfsplit"), (2, 512, 1024, None, "halfsplit"),
    (5, 1000, 520, 50, "parity"), (64, 256, 1027, None, "parity"), (3, 256, 36, 128, "parity"),
    (3, 1023, 520, 33, "unpacked"), (2, 63, 7, None, "unpacked")])
def test_int4_kernel_matches_plain_on_card(cuda_device, dtype, rtol, atol, B, K, N, group, layout):
    rng = np.random.default_rng(19)
    qk = quant.quantize_int4(_t(_normal(rng, (K, N))).to(cuda_device), group=group,
                             halfsplit=layout == "halfsplit")
    assert (qk.layout, qk.group) == (layout, group)
    x = _t(_normal(rng, (B, K))).to(cuda_device, dtype)
    out = int4_gemv(x, qk.values, qk.scale, layout)
    assert out.dtype == dtype and out.shape == (B, N)
    assert torch.equal(out, int4_gemv(x, qk.values, qk.scale, layout))
    _assert_gemv_close(out, int4_gemv_plain(x.float(), qk.values, qk.scale, layout), x,
                       quant.dequantize4(qk), rtol)


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
