"""The whole decoder stack for one token in one kernel: the fused-step weight
pack, the CUDA kernel's wrapper and its plain PyTorch version.

Kernel: ``csrc/fused_step.cu`` (hand-written for sm_90a, loaded with ctypes,
one cooperative launch per decode step, any number of rows: copying warps
stream every block's weight tiles through a shared-memory ring across phases
and barriers, ``mma.sync`` GEMV items, three grid barriers a layer).  It replaces
the Pallas kernel ``dia_tts_prune_tpu/ops/kernels/fused_step.py::
fused_decode_step`` (``pallas_call`` :1018), which walks ``(layers,
phases)`` on one TPU core with the activations in VMEM.  Per layer: folded-norm → qkv → RoPE → cached
GQA self-attention (prefix plus the current token) → o_proj → folded-norm →
cq → RoPE → masked cross-attention → co_proj → folded-norm → gate/up →
SiLU·up → wm, with the residuals; it returns x [B, D] fp32 before the final
norm and this token's K/V [L, B, Nkv, H].

The pack (``repack_decoder_fused``, from unquantized weights) is the JAX
package's, byte for byte: RMSNorm gains folded in fp32 into the next
projection's rows before quantization; q/k/v merged into one ``[D,
(Nq+2Nkv)H]`` matrix; gate/up split; every matrix symmetric per-column int8,
or (``mlp_int4``) the three MLP matrices nibble-int4: ``wg``/``wu`` pair row
k with row k + D/2 (scales ``[L, 2, F]``), ``wm`` pairs rows within each of
``mlp_tiles`` K-tiles (local row r with r + tile/2, scales
``[L, MT, 2, D]``).  The JAX pack's last two fields, ``jq``/``jk`` (the TPU
kernel's RoPE half-swap permutations), stay None: the port's kernel swaps
RoPE halves directly.

Not ported on purpose: ``attn_impl`` (four TPU formulations of one
attention), ``ablate``, ``interpret``, ``skip_uncond`` (a row with
``cross_ends == 0`` reads no cross keys or values and gets exact zeros), and
the ``DIA_FUSED_*`` environment variables.
"""

from __future__ import annotations

import ctypes
import math
from typing import Any, NamedTuple

import torch

Params = dict[str, Any]

MLP_TILES = 4  # the JAX kernel's F tiling; int4 packs pair wm's rows per tile
NEG = -1e30
_CACHE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_ARGTYPES = ([ctypes.c_void_p] * 31 + [ctypes.c_int] * 13
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])


def slot_tensor(write_slot, device) -> torch.Tensor:
    """The write slot as an int32 [1] tensor on ``device``: a tensor is
    taken as it is (a CUDA graph's steps read theirs from device memory); an
    int becomes one with a fill, which no queued work waits for."""
    if torch.is_tensor(write_slot):
        return write_slot.reshape(1).to(device=device, dtype=torch.int32)
    return torch.full((1,), int(write_slot), dtype=torch.int32, device=device)


class FusedPack(NamedTuple):
    """Decoder weights repacked for the fused step (all stacked ``[L, ...]``;
    the JAX ``FusedPack``'s fields and layouts)."""

    wqkv: torch.Tensor  # s8 [L, D, (Nq+2Nkv)H], pre_sa_norm folded
    sqkv: torch.Tensor  # f32 [L, 1, (Nq+2Nkv)H]
    wo: torch.Tensor    # s8 [L, NqH, D]
    so: torch.Tensor    # f32 [L, 1, D]
    wcq: torch.Tensor   # s8 [L, D, NcqH], pre_ca_norm folded
    scq: torch.Tensor   # f32 [L, 1, NcqH]
    wco: torch.Tensor   # s8 [L, NcqH, D]
    sco: torch.Tensor   # f32 [L, 1, D]
    wg: torch.Tensor    # s8 [L, D, F] | nibble-int4 [L, D/2, F]
    sg: torch.Tensor    # f32 [L, 1, F] | [L, 2, F]
    wu: torch.Tensor    # s8 [L, D, F] | [L, D/2, F]
    su: torch.Tensor    # f32 [L, 1, F] | [L, 2, F]
    wm: torch.Tensor    # s8 [L, F, D] | nibble-int4 tile-paired [L, F/2, D]
    sm: torch.Tensor    # f32 [L, 1, D] | [L, MT, 2, D]
    jq: None = None     # the TPU kernel's RoPE half-swap matrices: not kept
    jk: None = None

    @property
    def mlp_int4(self) -> bool:
        return self.sg.shape[1] == 2

    @property
    def mlp_tiles(self) -> int:
        """wm's nibble-pairing tiles (int4); the int8 kernel has no tiling."""
        return self.sm.shape[1] if self.mlp_int4 else 1

    def to(self, device) -> "FusedPack":
        return FusedPack(*(t.to(device) for t in self[:14]))

    def weight_bytes(self) -> int:
        """Bytes of weights and scales a decode step streams."""
        return sum(t.numel() * t.element_size() for t in self[:14])


def _q8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-column symmetric int8 of one [K, N] fp32 matrix."""
    scale = w.abs().amax(dim=-2, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(w / scale).clamp(-127, 127).to(torch.int8), scale


# XLA turns the JAX packer's ``/ 7.0`` inside ``lax.map`` into a product with
# the fp32 reciprocal; the same product gives the same scale bits
_INV7 = torch.tensor(1.0, dtype=torch.float32) / 7.0


def _nibbles(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    # in int32 (hi << 4) | (lo & 15) lies in [-112, 127]: the narrowing is exact
    return ((hi.to(torch.int32) << 4) | (lo.to(torch.int32) & 0x0F)).to(torch.int8)


def _q4_nibble(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One [K, N] matrix nibble-packed across contraction halves: byte row k
    holds row k (low nibble) and row k + K/2 (high), symmetric int4 with one
    scale per (half, column): (s8 [K/2, N], f32 [2, N])."""
    K, N = w.shape
    halves = w.reshape(2, K // 2, N)
    scale = halves.abs().amax(dim=1, keepdim=True).clamp_min(1e-12) * _INV7  # [2, 1, N]
    q = torch.round(halves / scale).clamp(-7, 7)
    return _nibbles(q[0], q[1]), scale[:, 0, :]


def _q4_nibble_tiled(w: torch.Tensor, tiles: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One [K, N] matrix consumed in ``tiles`` K-tiles, rows paired within
    each tile (local row r with r + tile/2): (s8 [K/2, N], f32 [tiles, 2, N])."""
    K, N = w.shape
    tile = K // tiles
    wt = w.reshape(tiles, 2, tile // 2, N)
    scale = wt.abs().amax(dim=2, keepdim=True).clamp_min(1e-12) * _INV7  # [T, 2, 1, N]
    q = torch.round(wt / scale).clamp(-7, 7)
    return _nibbles(q[:, 0], q[:, 1]).reshape(K // 2, N), scale[:, :, 0, :]


def repack_decoder_fused(params: Params, mlp_int4: bool = False,
                         mlp_tiles: int = MLP_TILES) -> FusedPack:
    """The fused-step pack from unquantized decoder weights (the JAX
    ``repack_decoder_fused``, equal values and scales).  Norm gains are
    folded in fp32 before quantization, one layer at a time, so the fp32
    temporaries stay one layer large.  ``mlp_tiles`` sets wm's int4 row
    pairing and is unused for int8."""
    layers = params["decoder"]["layers"]
    sa, ca, mlp = layers["self_attention"], layers["cross_attention"], layers["mlp"]
    L, D = layers["pre_sa_norm"]["scale"].shape
    parts: dict[str, list] = {}

    def add(name, q_s):
        parts.setdefault("w" + name, []).append(q_s[0])
        parts.setdefault("s" + name, []).append(q_s[1])

    for i in range(L):
        f32 = lambda a: a[i].float()  # noqa: E731
        g_sa = f32(layers["pre_sa_norm"]["scale"])[:, None]
        g_ca = f32(layers["pre_ca_norm"]["scale"])[:, None]
        g_mlp = f32(layers["pre_mlp_norm"]["scale"])[:, None]
        wqkv = torch.cat([f32(sa[p]["kernel"]).reshape(D, -1)
                          for p in ("q_proj", "k_proj", "v_proj")], dim=-1) * g_sa
        add("qkv", _q8(wqkv))
        add("o", _q8(f32(sa["o_proj"]["kernel"]).reshape(-1, D)))
        add("cq", _q8(f32(ca["q_proj"]["kernel"]).reshape(D, -1) * g_ca))
        add("co", _q8(f32(ca["o_proj"]["kernel"]).reshape(-1, D)))
        wi = f32(mlp["wi_fused"]["kernel"])  # [D, 2, F]
        wg, wu, wm = wi[:, 0] * g_mlp, wi[:, 1] * g_mlp, f32(mlp["wo"]["kernel"])
        del wi
        if mlp_int4:
            add("g", _q4_nibble(wg))
            add("u", _q4_nibble(wu))
            add("m", _q4_nibble_tiled(wm, mlp_tiles))
        else:
            add("g", _q8(wg))
            add("u", _q8(wu))
            add("m", _q8(wm))
        del wg, wu, wm
    return FusedPack(**{k: torch.stack(v) for k, v in parts.items()})


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _rms_nogain(x32: torch.Tensor, eps: float) -> torch.Tensor:
    return x32 * torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)


def _rope_flat(x32: torch.Tensor, position: torch.Tensor, H: int, inv_freq: torch.Tensor):
    """Split-half RoPE on head-flattened [B, N*H] fp32: lane d of a head
    turns with its partner d ± H/2 by ``position * inv_freq[d % (H/2)]``.
    The partner enters rounded to bf16, as in the TPU kernel, whose
    half-swap is a bf16 permutation matmul (``_rope_mat``, :261); the JAX
    reference keeps it fp32, 3-5e-3 away after a few layers."""
    B, NH = x32.shape
    theta = position.float()[:, None] * inv_freq[None, :]  # [B, H/2]
    cos, sin = torch.cos(theta).repeat(1, 2), torch.sin(theta)
    ssin = torch.cat([-sin, sin], dim=-1)  # first half -sin, second +sin
    xm = x32.reshape(B, NH // H, 2, H // 2)
    partner = torch.cat([xm[:, :, 1:2], xm[:, :, 0:1]], dim=2).reshape(B, NH // H, H)
    partner = partner.to(torch.bfloat16).float()
    out = x32.reshape(B, NH // H, H) * cos[:, None] + partner * ssin[:, None]
    return out.reshape(B, NH)


def _unpack4(w8: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) signed nibbles of int8 bytes as fp32 (shifts on int32)."""
    w32 = w8.to(torch.int32)
    return ((w32 << 28) >> 28).float(), (w32 >> 4).float()


def _dot(x_bf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 activations against exact fp32 weights: every product is exact
    in fp32, as in the TPU kernel's bf16 × bf16 → fp32 dots."""
    return x_bf.float() @ w.float()


def fused_decode_step_plain(
    pack: FusedPack,
    x_emb: torch.Tensor,       # [B, D] summed channel embeddings
    position: torch.Tensor,    # int [B] RoPE positions
    write_slot,                # int, or an int [1] tensor: the slot this token's K/V go to
                               # (read: [valid_from, write_slot))
    self_k: torch.Tensor,      # [L, B, T, Nkv, H] float, or int8 codes
    self_v: torch.Tensor,
    cross_k: torch.Tensor,     # [L, B, S, Ncq, H]
    cross_v: torch.Tensor,
    cross_ends: torch.Tensor,  # int32 [B]: text keys per row (0 = reads none)
    eps: float = 1e-5,
    rope_min: float = 1.0,
    rope_max: float = 10000.0,
    valid_from: torch.Tensor | None = None,  # int32 [B] first valid self slot
    self_ks: torch.Tensor | None = None,     # f32 [L, B, T, Nkv] int8-cache scales
    self_vs: torch.Tensor | None = None,
    cross_ks: torch.Tensor | None = None,    # f32 [L, B, S, Ncq]
    cross_vs: torch.Tensor | None = None,
):
    """Plain PyTorch version, the math and bf16 rounding points of the JAX
    ``fused_step_reference`` (:298): ``xn``, ``sa``, ``ca`` and ``h`` are
    rounded to bf16 before their dots; int8 key scales multiply the scores,
    value scales the probabilities.  Slots outside ``[valid_from, write_slot)``
    and text keys past ``cross_ends`` are masked out of keys, values and
    scales alike, so whatever they hold (NaN included) changes nothing; a row
    with ``cross_ends == 0`` gets exact zeros from cross-attention.  The int8
    ``wm`` takes its scales once after the whole sum, as the TPU kernel does.
    Returns (x [B, D] fp32, k_new, v_new [L, B, Nkv, H]): in the cache dtype
    for float caches, fp32 for int8 ones (the caller quantizes)."""
    from ..modules import _inv_freq

    L, B, T, Nkv, H = self_k.shape
    S, Ncq = cross_k.shape[2], cross_k.shape[3]
    Nq = pack.wo.shape[1] // H
    G = Nq // Nkv
    dev = x_emb.device
    kv_quant = self_ks is not None
    scale = 1.0 / math.sqrt(H)
    inv_freq = _inv_freq(H, float(rope_min), float(rope_max), dev)
    position = position.reshape(-1).to(dev).expand(B)
    slots = torch.arange(T, device=dev)[None, :]
    vf = (torch.zeros(B, dtype=torch.int32, device=dev) if valid_from is None
          else valid_from.to(dev))
    ws = slot_tensor(write_slot, dev)
    prefix = (slots < ws) & (slots >= vf[:, None])  # [B, T]
    cmask = torch.arange(S, device=dev)[None, :] < cross_ends.to(dev)[:, None]  # [B, S]
    bf = torch.bfloat16

    def masked(t, mask):  # [B, T, N(, H)] with invalid slots zeroed
        m = mask.reshape(*mask.shape, *([1] * (t.dim() - 2)))
        return torch.where(m, t.float(), torch.zeros((), device=dev))

    x = x_emb.float()
    ks_out, vs_out = [], []
    for i in range(L):
        xn = _rms_nogain(x, eps).to(bf)
        qkv = _dot(xn, pack.wqkv[i]) * pack.sqkv[i]
        q = _rope_flat(qkv[:, : Nq * H], position, H, inv_freq)
        kn = _rope_flat(qkv[:, Nq * H: (Nq + Nkv) * H], position, H, inv_freq).reshape(B, Nkv, H)
        vn = qkv[:, (Nq + Nkv) * H:].reshape(B, Nkv, H)

        qg = q.reshape(B, Nkv, G, H)
        kc, vc = masked(self_k[i], prefix), masked(self_v[i], prefix)
        s_pre = torch.einsum("bngh,btnh->bngt", qg, kc) * scale
        if kv_quant:
            s_pre = s_pre * masked(self_ks[i], prefix).permute(0, 2, 1)[:, :, None, :]
        s_pre = torch.where(prefix[:, None, None, :], s_pre, NEG)
        s_cur = torch.einsum("bngh,bnh->bng", qg, kn)[..., None] * scale
        m_all = torch.maximum(s_pre.amax(-1, keepdim=True), s_cur)
        p_pre, p_cur = torch.exp(s_pre - m_all), torch.exp(s_cur - m_all)
        denom = p_pre.sum(-1, keepdim=True) + p_cur
        if kv_quant:
            p_pre = p_pre * masked(self_vs[i], prefix).permute(0, 2, 1)[:, :, None, :]
        acc = torch.einsum("bngt,btnh->bngh", p_pre, vc) + p_cur * vn[:, :, None, :]
        sa = (acc / denom).reshape(B, Nq * H).to(bf)
        x = x + _dot(sa, pack.wo[i]) * pack.so[i]

        xn = _rms_nogain(x, eps).to(bf)
        cq = _rope_flat(_dot(xn, pack.wcq[i]) * pack.scq[i], position, H, inv_freq)
        ck, cv = masked(cross_k[i], cmask), masked(cross_v[i], cmask)
        s_c = torch.einsum("bnh,bsnh->bns", cq.reshape(B, Ncq, H), ck) * scale
        if kv_quant:
            s_c = s_c * masked(cross_ks[i], cmask).permute(0, 2, 1)
        s_c = torch.where(cmask[:, None, :], s_c, NEG)
        m_c = s_c.amax(-1, keepdim=True)
        m_c = torch.where(m_c <= NEG * 0.5, 0.0, m_c)
        p_c = torch.exp(s_c - m_c)
        p_cv = p_c * masked(cross_vs[i], cmask).permute(0, 2, 1) if kv_quant else p_c
        ca = torch.einsum("bns,bsnh->bnh", p_cv, cv)
        ca = (ca / p_c.sum(-1, keepdim=True).clamp_min(1e-30)).reshape(B, Ncq * H).to(bf)
        x = x + _dot(ca, pack.wco[i]) * pack.sco[i]

        xn = _rms_nogain(x, eps).to(bf)
        if pack.mlp_int4:
            D = xn.shape[-1]
            xl, xh = xn[:, : D // 2], xn[:, D // 2:]
            sg, su, sm = pack.sg[i], pack.su[i], pack.sm[i]
            glo, ghi = _unpack4(pack.wg[i])
            g = _dot(xl, glo) * sg[0] + _dot(xh, ghi) * sg[1]
            ulo, uhi = _unpack4(pack.wu[i])
            u = _dot(xl, ulo) * su[0] + _dot(xh, uhi) * su[1]
            h = (torch.nn.functional.silu(g) * u).to(bf)
            tiles = sm.shape[0]
            tile = h.shape[-1] // tiles
            mlo, mhi = _unpack4(pack.wm[i])
            acc_m = torch.zeros_like(x)
            for t in range(tiles):
                rows = slice(t * (tile // 2), (t + 1) * (tile // 2))
                acc_m = acc_m + (_dot(h[:, t * tile: t * tile + tile // 2], mlo[rows]) * sm[t, 0]
                                 + _dot(h[:, t * tile + tile // 2: (t + 1) * tile], mhi[rows])
                                 * sm[t, 1])
            x = x + acc_m
        else:
            g = _dot(xn, pack.wg[i]) * pack.sg[i]
            u = _dot(xn, pack.wu[i]) * pack.su[i]
            h = (torch.nn.functional.silu(g) * u).to(bf)
            x = x + _dot(h, pack.wm[i]) * pack.sm[i]
        out_dt = torch.float32 if kv_quant else self_k.dtype
        ks_out.append(kn.to(out_dt))
        vs_out.append(vn.to(out_dt))
    return x, torch.stack(ks_out), torch.stack(vs_out)


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------


def _check(pack: FusedPack, x, position, self_k, self_v, cross_k, cross_v, cross_ends,
           valid_from, scales):
    L, B, T, Nkv, H = self_k.shape
    if self_k.dtype not in _CACHE_CODES:
        raise TypeError(f"fused_decode_step: cache dtype {self_k.dtype} not supported")
    caches = (self_k, self_v, cross_k, cross_v)
    if any(c.dtype != self_k.dtype for c in caches):
        raise TypeError("fused_decode_step: the four caches must share one dtype")
    if [s is not None for s in scales] != [self_k.dtype == torch.int8] * 4:
        raise ValueError("fused_decode_step: int8 caches need all four scale tensors, "
                         "float caches none")
    if B < 1:
        raise ValueError("fused_decode_step: no rows")
    if H % 2 or H > 256 or cross_k.shape[-1] != H:
        raise ValueError(f"fused_decode_step: head_dim {H} (even, <= 256, shared)")
    if self_v.shape != self_k.shape or cross_v.shape != cross_k.shape or \
            cross_k.shape[:2] != (L, B):
        raise ValueError("fused_decode_step: cache shapes disagree")
    D = x.shape[1]
    if x.dim() != 2 or x.shape[0] != B or any(t.shape != (B,) for t in (position, cross_ends,
                                                                          valid_from)):
        raise ValueError(f"fused_decode_step: x must be [{B}, D] and positions, cross_ends, "
                         f"valid_from [{B}]")
    for w in (pack.wqkv, pack.wo, pack.wcq, pack.wco, pack.wg, pack.wu, pack.wm):
        if w.dtype != torch.int8 or w.shape[0] != L or w.shape[-1] % 4:
            raise ValueError(f"fused_decode_step: weights must be int8 [L, K, N] with "
                             f"N % 4 == 0, got {w.dtype} {tuple(w.shape)}")
    for s in pack[1:14:2]:
        if s.dtype != torch.float32:
            raise TypeError("fused_decode_step: pack scales must be float32")
    if pack.wqkv.shape[1] != D or pack.wo.shape[2] != D or pack.wm.shape[2] != D:
        raise ValueError("fused_decode_step: pack and x widths disagree")
    if pack.mlp_int4:
        F = pack.wg.shape[2]
        if pack.wm.shape[1] * 2 != F or F % (2 * pack.mlp_tiles) or D % 2:
            raise ValueError("fused_decode_step: int4 MLP shapes")
    tensors = [x, position, cross_ends, valid_from, *caches, *pack[:14],
               *(s for s in scales if s is not None)]
    if any(t.device != x.device for t in tensors):
        raise ValueError("fused_decode_step: inputs must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_decode_step: inputs must be contiguous")
    if any(t.dtype != torch.int32 for t in (position, cross_ends, valid_from)):
        raise TypeError("fused_decode_step: positions, cross_ends and valid_from are int32")


def fused_decode_step(
    pack: FusedPack,
    x_emb: torch.Tensor,
    position: torch.Tensor,
    write_slot,
    self_k: torch.Tensor,
    self_v: torch.Tensor,
    cross_k: torch.Tensor,
    cross_v: torch.Tensor,
    cross_ends: torch.Tensor,
    eps: float = 1e-5,
    rope_min: float = 1.0,
    rope_max: float = 10000.0,
    valid_from: torch.Tensor | None = None,
    self_ks: torch.Tensor | None = None,
    self_vs: torch.Tensor | None = None,
    cross_ks: torch.Tensor | None = None,
    cross_vs: torch.Tensor | None = None,
):
    """The decoder stack for one token (see ``fused_decode_step_plain`` for
    the arguments and results).  CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise.  An int ``write_slot`` outside the
    cache raises here; a tensor one is the caller's to keep inside (the
    kernel reads it on the card and clamps it to the cache)."""
    if x_emb.device.type == "cpu":
        return fused_decode_step_plain(pack, x_emb, position, write_slot, self_k, self_v,
                                       cross_k, cross_v, cross_ends, eps, rope_min, rope_max,
                                       valid_from, self_ks, self_vs, cross_ks, cross_vs)
    if x_emb.device.type != "cuda":
        raise ValueError(f"fused_decode_step: unsupported device {x_emb.device}")
    L, B, T, Nkv, H = self_k.shape
    dev = x_emb.device
    position = position.reshape(-1).to(dev, torch.int32).expand(B).contiguous()
    if valid_from is None:
        valid_from = torch.zeros(B, dtype=torch.int32, device=dev)
    scales = (self_ks, self_vs, cross_ks, cross_vs)
    x_in = x_emb.float().contiguous()
    _check(pack, x_in, position, self_k, self_v, cross_k, cross_v, cross_ends, valid_from,
           scales)
    if not torch.is_tensor(write_slot) and not 0 <= int(write_slot) < T:
        raise ValueError(f"fused_decode_step: write_slot {write_slot} outside [0, {T})")
    ws = slot_tensor(write_slot, dev)
    with torch.cuda.device(dev):
        x, kv = launch(pack, x_in, position, ws, self_k, self_v, cross_k, cross_v,
                       cross_ends, valid_from, scales, eps, rope_min, rope_max,
                       torch.cuda.current_stream(dev).cuda_stream)
    fused_decode_step.launches += 1
    out_dt = torch.float32 if self_k.dtype == torch.int8 else self_k.dtype
    return x, kv[0].to(out_dt), kv[1].to(out_dt)


# (shapes, rope timescales, device) -> (workspace bytes, inv_freq): what a
# launch needs that depends on nothing but its shapes, asked for once
_STATIC: dict[tuple, tuple[int, torch.Tensor]] = {}


def _static(shapes: tuple, rope_min, rope_max, dev) -> tuple[int, torch.Tensor]:
    key = (shapes, float(rope_min), float(rope_max), dev)
    hit = _STATIC.get(key)
    if hit is None:
        from ..modules import _inv_freq
        from ._build import kernel_function

        need = ctypes.c_longlong(0)
        size_fn = kernel_function("fused_step", "fused_step_workspace_bytes",
                                  [ctypes.c_int] * 11 + [ctypes.c_void_p])
        if size_fn(*shapes, ctypes.byref(need)) != 0:
            raise ValueError(f"fused_decode_step: shapes {shapes} refused")
        hit = _STATIC[key] = (need.value, _inv_freq(shapes[6], float(rope_min), float(rope_max),
                                                    dev))
    return hit


def launch(pack: FusedPack, x_in, position, write_slot: torch.Tensor, self_k, self_v, cross_k,
           cross_v, cross_ends, valid_from, scales, eps, rope_min, rope_max, stream: int):
    """One launch of the kernel on checked inputs (``fused_decode_step``
    checks them; ``write_slot`` int32 [1] on the card): returns (x [B, D]
    fp32, kv [2, L, B, Nkv, H] fp32), fresh tensors on every call (under
    CUDA graph capture they come from the graph's pool and keep their
    addresses on every replay)."""
    from ._build import kernel_function

    L, B, T, Nkv, H = self_k.shape
    S, Ncq = cross_k.shape[2], cross_k.shape[3]
    D, F, Nq = x_in.shape[1], pack.wg.shape[2], pack.wo.shape[1] // H
    dev = x_in.device
    shapes = (B, D, F, Nq, Nkv, Ncq, H, T, S, int(pack.mlp_int4), pack.mlp_tiles)
    need, inv_freq = _static(shapes, rope_min, rope_max, dev)
    work = torch.empty(need, dtype=torch.uint8, device=dev)
    x = torch.empty(B, D, dtype=torch.float32, device=dev)
    kv = torch.empty(2, L, B, Nkv, H, dtype=torch.float32, device=dev)
    ptrs = [t.data_ptr() for t in pack[:14]] + [
        t.data_ptr() for t in (x_in, position, valid_from, cross_ends, write_slot, inv_freq,
                               self_k, self_v, cross_k, cross_v)]
    ptrs += [0 if s is None else s.data_ptr() for s in scales]
    ptrs += [x.data_ptr(), kv.data_ptr(), work.data_ptr()]
    fn = kernel_function("fused_step", "fused_step_fwd", _ARGTYPES)
    err = fn(*ptrs, L, B, D, F, Nq, Nkv, Ncq, H, T, S, _CACHE_CODES[self_k.dtype],
             int(pack.mlp_int4), pack.mlp_tiles, work.numel(), float(eps), stream)
    if err != 0:
        raise RuntimeError(f"fused_decode_step kernel launch failed (cudaError {err})")
    return x, kv


fused_decode_step.launches = 0
