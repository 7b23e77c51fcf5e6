"""Attention-mask builders (counterpart of ``dia_tts_prune_tpu/ops/masks.py``).

Reference mask semantics (dia/state.py:8-39): a query position may attend a
key position iff both are non-padding OR both are padding, optionally AND-ed
with a causal triangle.  This is exactly equality of the padding mask used as
segment ids, which is what the flash kernel takes.  Masks are boolean
[B, 1, Tq, Tk] (True = attend), broadcast over heads.
"""

from __future__ import annotations

import torch


def create_attn_mask(
    q_padding_mask_1d: torch.Tensor,  # bool [B, Tq]
    k_padding_mask_1d: torch.Tensor,  # bool [B, Tk]
    is_causal: bool = False,
) -> torch.Tensor:
    """Segment-style padding mask, optionally causal (reference: dia/state.py:8-39)."""
    p_q = q_padding_mask_1d[:, :, None]
    p_k = k_padding_mask_1d[:, None, :]
    mask = (p_q & p_k) | (~p_q & ~p_k)  # [B, Tq, Tk]
    if is_causal:
        Tq, Tk = q_padding_mask_1d.shape[1], k_padding_mask_1d.shape[1]
        mask = mask & torch.ones(Tq, Tk, dtype=torch.bool, device=mask.device).tril()[None]
    return mask[:, None, :, :]
