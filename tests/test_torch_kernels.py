"""The port's attention kernels against the JAX package's Pallas kernels.

On the CPU the port's wrappers take their plain PyTorch versions; these are
held against the Pallas kernels run in interpret mode (as tests/test_kernels.py
runs them) on the same numpy inputs, fp32, atol 1e-5.  The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_gpu.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dia_tts_prune_tpu.ops.kernels.decode_attention import decode_attention as jax_decode_attention
from dia_tts_prune_tpu.ops.kernels.flash_attention import flash_attention as jax_flash_attention
from dia_tts_prune_tpu.ops.modules import sdpa as jax_sdpa
from dia_tts_prune_tpu_torch.ops.kernels import (
    decode_attention,
    decode_attention_plain,
    flash_attention,
    flash_attention_plain,
    launch_counts,
)
from dia_tts_prune_tpu_torch.ops.kernels.decode_attention import ends_from_padding_mask

ATOL = 1e-5


def _normal(rng, shape):
    return rng.normal(size=shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("causal,Nq,Nkv,H", [
    (False, 4, 4, 64), (False, 4, 2, 32), (True, 4, 2, 64), (True, 4, 1, 128)])
def test_flash_plain_matches_pallas(causal, Nq, Nkv, H):
    rng = np.random.default_rng(10)
    B, T = 3, 256
    q = _normal(rng, (B, T, Nq, H))
    k, v = _normal(rng, (B, T, Nkv, H)), _normal(rng, (B, T, Nkv, H))
    seg = np.ones((B, T), np.int32)
    seg[0, :] = 0  # CFG unconditional row: all padding
    seg[1, 200:] = 0  # padded tail
    seg[2, 77:] = 0
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(seg), jnp.asarray(seg), causal=causal,
                                         block_q=128, block_k=128, interpret=True))
    before = launch_counts()["flash_attention"]
    out = flash_attention(_t(q), _t(k), _t(v), _t(seg), _t(seg), causal).numpy()
    assert launch_counts()["flash_attention"] == before  # CPU: plain version, no launch
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_flash_plain_fully_masked_rows_are_zero():
    """Queries whose segment matches no key (cross-attention of the
    unconditional row) come out as exact zeros, as in the Pallas kernel."""
    rng = np.random.default_rng(11)
    B, Tq, Tk, N, H = 2, 128, 256, 4, 64
    q, k, v = _normal(rng, (B, Tq, N, H)), _normal(rng, (B, Tk, N, H)), _normal(rng, (B, Tk, N, H))
    sq = np.ones((B, Tq), np.int32)
    sk = np.zeros((B, Tk), np.int32)
    sk[1, :150] = 1
    ref = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                         jnp.asarray(sq), jnp.asarray(sk),
                                         block_q=128, block_k=128, interpret=True))
    out = flash_attention_plain(_t(q), _t(k), _t(v), _t(sq), _t(sk)).numpy()
    assert np.all(out[0] == 0.0) and np.all(ref[0] == 0.0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


@pytest.mark.parametrize("valid", [1, 255, 256, 257, 512])
def test_decode_plain_matches_pallas(valid):
    rng = np.random.default_rng(12)
    B, T, Nkv, G, H = 2, 512, 2, 4, 64
    q = _normal(rng, (B, Nkv * G, H))
    k, v = _normal(rng, (B, T, Nkv, H)), _normal(rng, (B, T, Nkv, H))
    ref = np.asarray(jax_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          jnp.asarray(valid, jnp.int32), chunk=256,
                                          interpret=True))
    start = torch.zeros(B, dtype=torch.int32)
    end = torch.full((B,), valid, dtype=torch.int32)
    out = decode_attention(_t(q), _t(k), _t(v), start, end).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_decode_plain_ignores_garbage_past_end():
    rng = np.random.default_rng(13)
    B, T, Nkv, G, H = 2, 256, 2, 2, 32
    q = _t(_normal(rng, (B, Nkv * G, H)))
    k, v = _normal(rng, (B, T, Nkv, H)), _normal(rng, (B, T, Nkv, H))
    start = torch.zeros(B, dtype=torch.int32)
    end = torch.tensor([60, 100], dtype=torch.int32)
    out1 = decode_attention_plain(q, _t(k), _t(v), start, end)
    k[0, 60:], v[0, 60:], k[1, 100:], v[1, 100:] = 1e4, -1e4, 1e4, -1e4
    out2 = decode_attention_plain(q, _t(k), _t(v), start, end)
    assert torch.equal(out1, out2)


def test_decode_per_row_end_matches_cross_sdpa():
    """The cross-attention form: per-row text lengths from the padding mask,
    against the JAX decode step's masked sdpa; end = 0 gives exact zeros."""
    rng = np.random.default_rng(14)
    B, S, N, H = 3, 128, 4, 64
    q = _normal(rng, (B, N, H))
    k, v = _normal(rng, (B, S, N, H)), _normal(rng, (B, S, N, H))
    lengths = np.array([0, 37, 128])
    pad_mask = np.arange(S)[None, :] < lengths[:, None]  # [B, S]
    cross_mask = pad_mask[:, None, None, :]  # the decode step's [B, 1, 1, S]
    ref = np.asarray(jax_sdpa(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(cross_mask)))[:, 0]
    end = ends_from_padding_mask(_t(cross_mask))
    assert end.tolist() == lengths.tolist()
    out = decode_attention(_t(q), _t(k), _t(v), torch.zeros(B, dtype=torch.int32), end).numpy()
    assert np.all(out[0] == 0.0)
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_ends_from_padding_mask_rejects_non_prefix():
    mask = torch.tensor([[True, False, True], [True, True, False]])
    with pytest.raises(ValueError, match="prefix"):
        ends_from_padding_mask(mask)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "head_dim", "group", "seg_dtype"])
def test_kernel_input_checks(bad):
    """What a CUDA wrapper checks before it launches (it raises, and never
    falls back to the plain version)."""
    import importlib

    dmod = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.decode_attention")
    fmod = importlib.import_module("dia_tts_prune_tpu_torch.ops.kernels.flash_attention")

    q, k = torch.zeros(2, 8, 4, 64), torch.zeros(2, 8, 2, 64)
    q1 = torch.zeros(2, 4, 64)  # one decode token per row
    seg, ends = torch.zeros(2, 8, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    if bad == "dtype":
        q, q1 = q.half(), q1.half()
    elif bad == "contiguity":
        q = torch.zeros(2, 4, 8, 64).transpose(1, 2)
        q1 = torch.zeros(2, 64, 4).transpose(1, 2)
    elif bad == "head_dim":
        q, q1, k = q[..., :48].contiguous(), q1[..., :48].contiguous(), k[..., :48].contiguous()
    elif bad == "group":
        k = torch.zeros(2, 8, 3, 64)
    else:
        seg, ends = seg.long(), ends.long()
    fmod._check(torch.zeros(2, 8, 4, 64), torch.zeros(2, 8, 2, 64), torch.zeros(2, 8, 2, 64),
                torch.zeros(2, 8, dtype=torch.int32), torch.zeros(2, 8, dtype=torch.int32))
    with pytest.raises((TypeError, ValueError)):
        fmod._check(q, k, k, seg, seg)
    with pytest.raises((TypeError, ValueError)):
        dmod._check(q1, k, k, ends, ends)


def test_non_cuda_device_raises():
    q = torch.zeros(1, 8, 4, 64, device="meta")
    seg = torch.zeros(1, 8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q, seg, seg)
