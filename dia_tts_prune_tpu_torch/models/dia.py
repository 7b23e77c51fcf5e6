"""Dia text→dialogue-speech model (counterpart of ``dia_tts_prune_tpu/models/dia.py``).

Functions over a params dict of tensors in the JAX package's layout:
stacked per-layer weights with a leading ``L`` axis, so a JAX checkpoint maps
one to one (``checkpoint.params_from_jax``).

* Encoder: byte embedding → N pre-norm blocks {RMSNorm → MHA self-attention
  (RoPE, segment mask, flash kernel) → RMSNorm → SwiGLU MLP} → RMSNorm
  (dia/layers.py:419-462).
* Decoder: 9 per-channel embeddings summed → N blocks {RMSNorm → GQA causal
  self-attention (KV cache) → RMSNorm → MHA cross-attention over the static
  text K/V → RMSNorm → SwiGLU MLP} → RMSNorm → logits [C, V]
  (dia/layers.py:465-766).

The KV cache is time-major ``[L, B, T, N, H]``.  Unlike the JAX package,
which returns a new cache from every call, ``decoder_prefill`` and
``decode_step`` write the caller's cache in place — a copy of the cache per
token would dominate the step's memory traffic.  Every decode-step attention
(self and cross) runs the decode-attention kernel over each row's valid slot
range; full-sequence attention (encoder, prompt prefill) runs the flash
kernel.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ..config import DiaConfig
from ..ops.kernels.decode_attention import decode_attention
from ..ops.modules import (
    attention,
    attention_out,
    attention_qkv,
    dense_general,
    full_attention,
    mlp_block,
    rms_norm,
    rope,
)

Params = dict[str, Any]


class KVCache(NamedTuple):
    """Stacked per-layer K/V: [L, B, T, N, H]."""

    k: torch.Tensor
    v: torch.Tensor


def _layer(layers: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in layers.items()}


def init_params(config: DiaConfig, seed: int = 0, dtype=torch.float32,
                device: str | torch.device = "cuda") -> Params:
    """Random weights from a numpy seed in the JAX package's shapes
    (normal / sqrt(fan_in) kernels, 0.02-scaled embeddings, unit norms), for
    runs at full width without a checkpoint.  The draws differ from
    ``jax.random``'s; tests that need equal weights in both packages use
    ``checkpoint.params_from_jax``."""
    rng = np.random.default_rng(seed)
    m = config.model
    enc, dec = m.encoder, m.decoder
    C = config.data.channels

    def t(a):
        return torch.from_numpy(a).to(device=device, dtype=dtype)

    def normal(shape, scale):
        a = rng.standard_normal(size=shape, dtype=np.float32)
        a *= np.float32(scale)
        return t(a)

    def dense(shape, n_in_axes):
        fan_in = int(np.prod(shape[1:1 + n_in_axes]))  # axis 0 is the layer stack
        return {"kernel": normal(shape, 1.0 / np.sqrt(fan_in))}

    def ones(*shape):
        return {"scale": t(np.ones(shape, np.float32))}

    def attn(L, d_q, d_kv, nq, nkv, h):
        return {
            "q_proj": dense((L, d_q, nq, h), 1),
            "k_proj": dense((L, d_kv, nkv, h), 1),
            "v_proj": dense((L, d_kv, nkv, h), 1),
            "o_proj": dense((L, nq, h, d_q), 2),
        }

    def mlp(L, d, f):
        return {"wi_fused": dense((L, d, 2, f), 1), "wo": dense((L, f, d), 1)}

    return {
        "encoder": {
            "embedding": {"embedding": normal((m.src_vocab_size, enc.n_embd), 0.02)},
            "layers": {
                "pre_sa_norm": ones(enc.n_layer, enc.n_embd),
                "self_attention": attn(enc.n_layer, enc.n_embd, enc.n_embd, enc.n_head,
                                       enc.n_head, enc.head_dim),
                "post_sa_norm": ones(enc.n_layer, enc.n_embd),
                "mlp": mlp(enc.n_layer, enc.n_embd, enc.n_hidden),
            },
            "norm": ones(enc.n_embd),
        },
        "decoder": {
            "embeddings": {"embedding": normal((C, m.tgt_vocab_size, dec.n_embd), 0.02)},
            "layers": {
                "pre_sa_norm": ones(dec.n_layer, dec.n_embd),
                "self_attention": attn(dec.n_layer, dec.n_embd, dec.n_embd, dec.gqa_query_heads,
                                       dec.kv_heads, dec.gqa_head_dim),
                "pre_ca_norm": ones(dec.n_layer, dec.n_embd),
                "cross_attention": attn(dec.n_layer, dec.n_embd, enc.n_embd,
                                        dec.cross_query_heads, dec.cross_query_heads,
                                        dec.cross_head_dim),
                "pre_mlp_norm": ones(dec.n_layer, dec.n_embd),
                "mlp": mlp(dec.n_layer, dec.n_embd, dec.n_hidden),
            },
            "norm": ones(dec.n_embd),
            "logits_dense": {"kernel": normal((dec.n_embd, C, m.tgt_vocab_size),
                                              1.0 / np.sqrt(dec.n_embd))},
        },
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def encoder_forward(
    params: Params,
    config: DiaConfig,
    x_ids: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T]
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Encoder stack (reference: dia/layers.py:445-462).  Returns [B, T, D].
    The padding mask is the flash kernel's segment ids (pad attends pad,
    non-pad attends non-pad)."""
    m = config.model
    eps = m.normalization_layer_epsilon
    x = params["encoder"]["embedding"]["embedding"][x_ids.long()].to(compute_dtype)
    seg = (x_ids != config.data.text_pad_value).to(torch.int32)
    layers = params["encoder"]["layers"]
    for i in range(m.encoder.n_layer):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["pre_sa_norm"]["scale"], eps)
        sa = attention(lp["self_attention"], h, h, positions, positions,
                       m.rope_min_timescale, m.rope_max_timescale, False, seg, seg)
        x = x + sa.to(x.dtype)
        h = rms_norm(x, lp["post_sa_norm"]["scale"], eps)
        x = x + mlp_block(lp["mlp"], h).to(x.dtype)
    return rms_norm(x, params["encoder"]["norm"]["scale"], eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _embed_channels(params: Params, tgt_BxTxC: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Sum the per-channel codebook embeddings (reference: dia/layers.py:690-697)."""
    embs = params["decoder"]["embeddings"]["embedding"]  # [C, V, D]
    ids = tgt_BxTxC.long()
    per_channel = torch.stack([embs[c][ids[..., c]] for c in range(embs.shape[0])])
    return per_channel.sum(dim=0).to(compute_dtype)


def precompute_cross_cache(
    params: Params,
    config: DiaConfig,
    enc_out: torch.Tensor,  # [B, S, E]
    enc_positions: torch.Tensor,  # [B, S]
) -> KVCache:
    """Static cross-attention K/V for all layers (reference: dia/layers.py:632-669):
    RoPE on keys with encoder positions, raw value projections.  [L, B, S, N, H]."""
    m = config.model
    ca = params["decoder"]["layers"]["cross_attention"]
    ks, vs = [], []
    for i in range(m.decoder.n_layer):
        k = dense_general(enc_out, ca["k_proj"]["kernel"][i])
        ks.append(rope(k, enc_positions, m.rope_min_timescale, m.rope_max_timescale))
        vs.append(dense_general(enc_out, ca["v_proj"]["kernel"][i]))
    return KVCache(k=torch.stack(ks), v=torch.stack(vs))


def new_self_cache(config: DiaConfig, batch: int, max_len: int | None = None,
                   dtype=torch.float32, device: str | torch.device = "cuda") -> KVCache:
    """Preallocated decoder self-attention cache [L, B, T, Nkv, H]
    (reference: dia/state.py:72-109, time-major)."""
    dec = config.model.decoder
    T = max_len if max_len is not None else config.data.audio_length
    shape = (dec.n_layer, batch, T, dec.kv_heads, dec.gqa_head_dim)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device))


def decoder_prefill(
    params: Params,
    config: DiaConfig,
    tgt_BxTxC: torch.Tensor,  # [B, P, C]
    dec_positions: torch.Tensor,  # [B, P]
    cross_cache: KVCache,
    self_cache: KVCache,
    dec_segment_ids: torch.Tensor,  # int [B, P]: 1 = valid prompt row
    enc_segment_ids: torch.Tensor,  # int [B, S]: text padding mask
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Prefill the self-attention cache from prompt tokens: causal flash
    self-attention (segment = valid row) and flash cross-attention (segment =
    text non-pad), K/V written into cache slots [0, P) in place.  Returns
    logits [B, P, C, V] fp32 (reference: dia/model.py:403-419, without its
    prefill off-by-one, quirk Q5)."""
    m = config.model
    eps = m.normalization_layer_epsilon
    P = tgt_BxTxC.shape[1]
    x = _embed_channels(params, tgt_BxTxC, compute_dtype)
    ones = torch.ones_like(dec_segment_ids)
    layers = params["decoder"]["layers"]
    for i in range(m.decoder.n_layer):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["pre_sa_norm"]["scale"], eps)
        q, k, v = attention_qkv(lp["self_attention"], h, h, dec_positions, dec_positions,
                                m.rope_min_timescale, m.rope_max_timescale)
        sa = full_attention(q, k, v, True, dec_segment_ids, dec_segment_ids)
        x = x + attention_out(lp["self_attention"], sa).to(x.dtype)

        h = rms_norm(x, lp["pre_ca_norm"]["scale"], eps)
        cq = dense_general(h, lp["cross_attention"]["q_proj"]["kernel"])
        cq = rope(cq, dec_positions, m.rope_min_timescale, m.rope_max_timescale)
        ca = full_attention(cq, cross_cache.k[i], cross_cache.v[i], False, ones, enc_segment_ids)
        x = x + attention_out(lp["cross_attention"], ca).to(x.dtype)

        h = rms_norm(x, lp["pre_mlp_norm"]["scale"], eps)
        x = x + mlp_block(lp["mlp"], h).to(x.dtype)
        self_cache.k[i, :, :P] = k.to(self_cache.k.dtype)
        self_cache.v[i, :, :P] = v.to(self_cache.v.dtype)
    x = rms_norm(x, params["decoder"]["norm"]["scale"], eps)
    return dense_general(x, params["decoder"]["logits_dense"]["kernel"]).float()


def decode_step(
    params: Params,
    config: DiaConfig,
    tgt_Bx1xC: torch.Tensor,  # [B, 1, C]
    position: torch.Tensor,  # [B, 1] RoPE position of this token
    write_slot: int,  # cache slot to write (== #valid slots - 1)
    self_cache: KVCache,
    cross_cache: KVCache,
    cross_ends: torch.Tensor,  # int32 [B]: text keys per row (0 = fully masked)
    compute_dtype=torch.float32,
) -> torch.Tensor:
    """Single autoregressive decode step (reference: dia/layers.py:671-720).
    Writes this token's K/V into slot ``write_slot`` of every layer (in
    place) and returns logits [B, 1, C, V] fp32.

    Self-attention reads slots [0, write_slot]; cross-attention reads each
    row's first ``cross_ends[b]`` text keys — both through the
    decode-attention kernel.  The JAX step's ``skip_uncond_cross`` has no
    counterpart: the CFG unconditional row has ``cross_ends == 0``, and for
    such a row every block of the kernel skips the cache and the combine pass
    writes exact zeros, so that row already reads no keys or values."""
    m = config.model
    eps = m.normalization_layer_epsilon
    B = tgt_Bx1xC.shape[0]
    dev = tgt_Bx1xC.device
    self_start = torch.zeros(B, dtype=torch.int32, device=dev)
    self_end = torch.full((B,), write_slot + 1, dtype=torch.int32, device=dev)
    cross_start = torch.zeros_like(cross_ends)

    x = _embed_channels(params, tgt_Bx1xC, compute_dtype)  # [B, 1, D]
    layers = params["decoder"]["layers"]
    for i in range(m.decoder.n_layer):
        lp = _layer(layers, i)
        h = rms_norm(x, lp["pre_sa_norm"]["scale"], eps)
        q, k, v = attention_qkv(lp["self_attention"], h, h, position, position,
                                m.rope_min_timescale, m.rope_max_timescale)
        self_cache.k[i, :, write_slot] = k[:, 0].to(self_cache.k.dtype)
        self_cache.v[i, :, write_slot] = v[:, 0].to(self_cache.v.dtype)
        sa = decode_attention(q[:, 0].contiguous(), self_cache.k[i], self_cache.v[i],
                              self_start, self_end)[:, None]
        x = x + attention_out(lp["self_attention"], sa)

        h = rms_norm(x, lp["pre_ca_norm"]["scale"], eps)
        cq = dense_general(h, lp["cross_attention"]["q_proj"]["kernel"])
        cq = rope(cq, position, m.rope_min_timescale, m.rope_max_timescale)[:, 0].contiguous()
        ca = decode_attention(cq, cross_cache.k[i], cross_cache.v[i], cross_start, cross_ends)
        x = x + attention_out(lp["cross_attention"], ca[:, None])

        h = rms_norm(x, lp["pre_mlp_norm"]["scale"], eps)
        x = x + mlp_block(lp["mlp"], h)

    x = rms_norm(x, params["decoder"]["norm"]["scale"], eps)
    return dense_general(x, params["decoder"]["logits_dense"]["kernel"]).float()
