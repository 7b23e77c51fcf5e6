"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each skips without a CUDA device.  This file imports no JAX,
so it runs on a machine that has only PyTorch:
``python -m pytest -m gpu tests/test_torch_gpu.py``.
"""

import numpy as np
import pytest
import torch

from dia_tts_prune_tpu_torch.ops.kernels import (
    decode_attention,
    decode_attention_plain,
    flash_attention,
    flash_attention_plain,
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
