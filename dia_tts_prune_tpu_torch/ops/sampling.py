"""CFG combination, constraint masking and token sampling (counterpart of
``dia_tts_prune_tpu/ops/sampling.py``).

Order as in the reference (dia/model.py:32-82, 429-488): classifier-free
guidance, the EOS/PAD/BOS bans, then temperature → top-k → top-p → a
categorical draw.  Draws are Gumbel-max over explicit uniform noise — the
same rule ``jax.random.categorical`` uses — so a test can hand both packages
the same noise; in generation the noise comes from a ``torch.Generator``.

The scalars (``cfg_scale``, ``temperature``, ``top_p``) may be Python numbers
or tensors (a stream's values on the device, ``generate.LoopState``): the
decode loop passes tensors on every route.  The division by the temperature
is why: on CUDA, ATen divides by a Python number (a CPU scalar) as a multiply
by its fp32 reciprocal, and by a device tensor as a true division, which can
differ by an ulp of the scaled logits and so flip a draw.  One form on every
route keeps a stream's draws its own whatever route it rides; the true
division is also the JAX package's (and the CPU's, in both forms).
"""

from __future__ import annotations

import torch

NEG = torch.finfo(torch.float32).min
TINY = torch.finfo(torch.float32).tiny


def cfg_combine(logits_2xCxV: torch.Tensor, cfg_scale) -> torch.Tensor:
    """guided = cond + scale * (cond - uncond)  (reference: dia/model.py:449-457).
    ``cfg_scale``: a number, or a tensor broadcast against ``[..., C, V]``
    (one scale a stream)."""
    uncond, cond = logits_2xCxV[0], logits_2xCxV[1]
    return cond + cfg_scale * (cond - uncond)


def apply_constraints(logits_CxV: torch.Tensor, eos_value: int, pad_value: int,
                      bos_value: int) -> torch.Tensor:
    """Ban EOS outside channel 0 and PAD/BOS everywhere (reference: dia/model.py:460-478).
    ``[..., C, V]``: leading axes (streams) take the same bans."""
    C, V = logits_CxV.shape[-2:]
    col = torch.arange(V, device=logits_CxV.device)[None, :]
    chan = torch.arange(C, device=logits_CxV.device)[:, None]
    ban = ((col == eos_value) & (chan > 0)) | (col == pad_value) | (col == bos_value)
    return logits_CxV.masked_fill(ban, NEG)


def top_p_filter(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filtering with the reference's shift-by-one keep rule
    (dia/model.py:55-70): drop a token iff the probability mass of tokens
    ranked strictly above it exceeds ``top_p``; the top-1 is always kept.
    Tied tokens at the boundary are all kept, as in the JAX package."""
    probs = torch.softmax(logits.float(), dim=-1)
    gt = (probs[..., :, None] < probs[..., None, :]).float()  # gt[t, j]: p_j > p_t
    mass_above = (gt * probs[..., None, :]).sum(dim=-1)
    return logits.masked_fill(mass_above > top_p, NEG)


def gumbel_argmax(logits: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    """Categorical draw over the last axis from uniform noise in [0, 1):
    ``argmax(logits - log(-log(u)))`` (``jax.random.categorical``'s rule)."""
    u = uniform.clamp(min=TINY, max=1.0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


def filtered_topk(logits: torch.Tensor, temperature, top_p,
                  cfg_filter_top_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Temperature, top-k (reference: dia/model.py:46-52) and nucleus
    filtering over the k survivors.
    Returns (values [..., K] sorted descending with filtered entries at NEG,
    their vocab ids [..., K])."""
    vals, idx = torch.topk(logits / temperature, cfg_filter_top_k, dim=-1)  # sorted desc
    cum = torch.cumsum(torch.softmax(vals, dim=-1), dim=-1)
    remove = torch.roll(cum > top_p, 1, dims=-1)
    remove[..., 0] = False
    return vals.masked_fill(remove, NEG), idx


def sample_next_token(logits: torch.Tensor, temperature, top_p,
                      cfg_filter_top_k: int | None, uniform: torch.Tensor | None = None,
                      generator: torch.Generator | None = None) -> torch.Tensor:
    """Temperature → top-k → top-p → categorical; argmax at temperature 0
    (reference: dia/model.py:32-82).  The noise is ``uniform`` when given
    (shape [..., K] with top-k, else [..., V]), else drawn from ``generator``.
    A tensor ``temperature`` always samples (the caller routes greedy
    streams around the sampler: no host read decides).  Returns int64 [...]."""
    if not torch.is_tensor(temperature) and temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    if cfg_filter_top_k is not None and cfg_filter_top_k > 0:
        vals, idx = filtered_topk(logits, temperature, top_p, cfg_filter_top_k)
    else:
        vals, idx = top_p_filter(logits / temperature, top_p), None
    if uniform is None:
        uniform = torch.rand(vals.shape, generator=generator, device=vals.device)
    choice = gumbel_argmax(vals, uniform)
    if idx is None:
        return choice
    return torch.gather(idx, -1, choice[..., None])[..., 0]
