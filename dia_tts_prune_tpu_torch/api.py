"""Top-level user API: class ``Dia`` (counterpart of ``dia_tts_prune_tpu/api.py``;
reference: dia/model.py:101-846).

``Dia.from_pretrained(local_dir)`` / ``Dia.from_local(config, checkpoint)``,
``generate_codes(text)`` → codec tokens, ``generate(text)`` → waveform and
``save_audio`` (16-bit PCM WAV); ``quantize_int8()`` / ``quantize_int4()``
switch the decoder to packed weights before generating; ``load_audio`` turns
a WAV file into codec tokens (voice-cloning prompts, fine-tuning data);
``prune_block_sparse()`` / ``sparsify_block()`` swap the decoder to
block-sparse kernels (pruned blocks are never read); ``generate_batch``
decodes N texts in one loop;
``load_adapter_weights`` / ``unload_adapter`` / ``set_adapter`` fuse a LoRA
adapter into the weights and take it out again; ``save_pretrained`` writes a
model directory both packages load.  Everything runs on ``device``, ``"cuda"``
unless the caller passes another; asking for CUDA on a machine without it
raises — nothing moves to the CPU on its own.
"""

from __future__ import annotations

import json
import wave
from pathlib import Path

import numpy as np
import torch

from .checkpoint import load_checkpoint, to_torch_state_dict
from .config import DiaConfig
from .generate import DTYPES, DiaGenerator
from .models.dac import (
    DEFAULT_SAMPLE_RATE,
    DACConfig,
    decode_codes,
    encode_audio,
    load_dac_safetensors,
    pad_audio,
)
from .ops.quant import quantize_params_int4_packed, quantize_params_int8_packed
from .utils.audio_io import load_audio_mono


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing CUDA where there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available; "
                           "pass device='cpu' to run on the CPU")
    return dev


def load_dac_config(spec) -> DACConfig | None:
    """Accept a DACConfig, a JSON path describing one, or None."""
    if spec is None or isinstance(spec, DACConfig):
        return spec
    data = json.loads(Path(spec).read_text())
    for k in ("encoder_rates", "decoder_rates"):
        if k in data:
            data[k] = tuple(data[k])
    return DACConfig(**data)


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int = DEFAULT_SAMPLE_RATE) -> None:
    """Mono float audio → 16-bit PCM WAV, clipped to [-1, 1]."""
    pcm = np.round(np.clip(np.asarray(audio, np.float32), -1.0, 1.0) * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dicts/lists of tensors → flat dotted-key dict of numpy arrays
    (list indices become numeric key segments; the layout of
    ``dac.safetensors``, read back by ``models.dac.load_dac_safetensors``)."""
    flat = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) else tree.items()
    for k, v in items:
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = np.ascontiguousarray(v.detach().float().cpu().numpy())
    return flat


class Dia:
    """Model params + generator + codec (reference: dia/model.py:101)."""

    def __init__(self, config: DiaConfig, params, compute_dtype: str = "float32",
                 dac_params=None, dac_config: DACConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.config = config
        self.params = params
        self.compute_dtype = compute_dtype
        self.dac_config = dac_config or DACConfig()
        self.dac_params = dac_params
        self._active_adapter = None
        self.generator = DiaGenerator(params, config, compute_dtype, self.device)

    @classmethod
    def from_local(cls, config_path: str | Path, checkpoint_path: str | Path,
                   compute_dtype: str = "float32", dac_config=None,
                   device: str | torch.device = "cuda") -> "Dia":
        """Load a reference-format config.json + checkpoint (safetensors, or a
        torch ``.bin`` / ``.pth`` state dict)."""
        dev = resolve_device(device)
        config = DiaConfig.load(config_path)
        if config is None:
            raise FileNotFoundError(f"Config file not found at {config_path}")
        params = load_checkpoint(checkpoint_path, config, DTYPES[compute_dtype], dev)
        return cls(config, params, compute_dtype, dac_config=load_dac_config(dac_config),
                   device=dev)

    @classmethod
    def from_pretrained(cls, model_dir: str | Path, compute_dtype: str = "float32",
                        device: str | torch.device = "cuda") -> "Dia":
        """Load a local model directory: config.json + model.safetensors (or
        pytorch_model.bin, as the fine-tuning CLI writes), and, when present,
        dac_config.json + dac.safetensors (the codec)."""
        dev = resolve_device(device)
        path = Path(model_dir)
        if not path.is_dir():
            raise FileNotFoundError(f"'{model_dir}' is not a local model directory")
        ckpt = next((path / c for c in ("model.safetensors", "pytorch_model.bin")
                     if (path / c).exists()), None)
        if ckpt is None:
            raise FileNotFoundError(f"No checkpoint found under {path}")
        dac_cfg = path / "dac_config.json"
        dia = cls.from_local(path / "config.json", ckpt, compute_dtype,
                             dac_config=dac_cfg if dac_cfg.exists() else None, device=dev)
        if (path / "dac.safetensors").exists():
            dia.dac_params = load_dac_safetensors(path / "dac.safetensors", dev)
        return dia

    # codec-decode chunking (api.py:276-310): each emitted sample keeps the
    # decoder's receptive field on both sides, so the result equals a
    # whole-array decode while only a few fixed shapes are ever decoded
    _DEC_BODY = 256
    _DEC_OV = 32
    _DEC_LA = 32

    def _require_dac(self) -> None:
        if self.dac_params is None:
            raise RuntimeError("DAC weights not loaded: set dac_params or load a model "
                               "directory with dac.safetensors")

    def _decode_waveform(self, codes_TxC: np.ndarray) -> np.ndarray:
        self._require_dac()
        hop = self.dac_config.hop_length
        T = codes_TxC.shape[0]
        body, ov, la = self._DEC_BODY, self._DEC_OV, self._DEC_LA
        W = ov + body + la

        def dec(span):
            codes = torch.from_numpy(np.ascontiguousarray(span)).to(self.device)[None]
            return decode_codes(self.dac_params, self.dac_config, codes)[0].float().cpu().numpy()

        if T <= W:
            return dec(codes_TxC).astype(np.float32)
        out = np.empty(T * hop, np.float32)
        out[: body * hop] = dec(codes_TxC[: body + la])[: body * hop]
        s = body
        while s + body + la <= T:
            w = dec(codes_TxC[s - ov: s + body + la])
            out[s * hop: (s + body) * hop] = w[ov * hop: (ov + body) * hop]
            s += body
        w = dec(codes_TxC[T - W: T])  # end-aligned tail window
        out[s * hop:] = w[(s - (T - W)) * hop:]
        return out

    def generate_codes(self, text: str, **kwargs) -> np.ndarray:
        """Text → undelayed codec tokens [T, C] (no codec decode)."""
        return self.generator.generate_tokens(text, **kwargs)

    def generate(self, text: str, max_tokens: int | None = None, cfg_scale: float = 3.0,
                 temperature: float = 1.3, top_p: float = 0.95, cfg_filter_top_k: int = 35,
                 audio_prompt: np.ndarray | None = None, audio_prompt_text: str | None = None,
                 seed: int | None = None, verbose: bool = False) -> np.ndarray | None:
        """Text → waveform (float32 [T_audio]), None when nothing was generated.
        ``audio_prompt`` is a WAV path (encoded by ``load_audio``) or a
        pre-encoded [T, C] code array."""
        if isinstance(audio_prompt, (str, Path)):
            audio_prompt = self.load_audio(audio_prompt)
        codes = self.generate_codes(
            text, max_tokens=max_tokens, cfg_scale=cfg_scale, temperature=temperature,
            top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
            audio_prompt_codes=None if audio_prompt is None else np.asarray(audio_prompt),
            audio_prompt_text=audio_prompt_text, seed=seed, verbose=verbose)
        if codes.shape[0] == 0:
            return None
        return self._decode_waveform(codes)

    def generate_batch(self, texts: list[str], max_tokens: int | None = None,
                       cfg_scale: float = 3.0, temperature: float = 1.3, top_p: float = 0.95,
                       cfg_filter_top_k: int = 35,
                       audio_prompts: list[str | np.ndarray | None] | None = None,
                       audio_prompt_texts: list[str | None] | None = None,
                       seed: int | None = None,
                       seeds: list[int | None] | None = None) -> list[np.ndarray | None]:
        """N texts → N waveforms (None where nothing was generated), decoded
        in one loop over 2N CFG rows, then one codec decode per stream.
        ``audio_prompts`` are per-stream WAV paths or [T, C] code arrays
        (batched voice cloning); ``seeds`` per-stream seeds, ``seed`` one for
        all — each stream repeats its single-stream run
        (``DiaGenerator.generate_tokens_batch``)."""
        prompt_codes = None
        if audio_prompts is not None:
            prompt_codes = [self.load_audio(p) if isinstance(p, (str, Path))
                            else (None if p is None else np.asarray(p)) for p in audio_prompts]
        codes_list = self.generator.generate_tokens_batch(
            texts, max_tokens=max_tokens, cfg_scale=cfg_scale, temperature=temperature,
            top_p=top_p, cfg_filter_top_k=cfg_filter_top_k, audio_prompt_codes=prompt_codes,
            audio_prompt_texts=audio_prompt_texts, seed=seed, seeds=seeds)
        self._require_dac()
        return [self._decode_waveform(c) if c.shape[0] else None for c in codes_list]

    def _set_params(self, params) -> None:
        """Swap the weights and rebuild the generator, so that nothing keeps
        the replaced tensors alive: their device memory is freed here."""
        self.params = params
        self.generator = DiaGenerator(params, self.config, self.compute_dtype, self.device)

    def quantize_int8(self) -> None:
        """Swap the decoder's dense kernels to packed int8 (values +
        per-column scales) and free the float ones.  Decode steps then stream
        int8 weights through the int8-matmul kernel, and generation keeps its
        KV caches int8 (``generate_tokens(kv_int8=...)``)."""
        self._set_params(quantize_params_int8_packed(self.params))

    def quantize_int4(self, group: int | None = 128, mlp_only: bool = False,
                      halfsplit: bool = True) -> None:
        """Swap the decoder's dense kernels to packed int4 nibble bytes and
        free the float ones.  ``group`` rows of each contraction share one
        scale per output column (None = per column).  ``mlp_only`` packs just
        the MLP kernels at int4 and the decoder's other kernels at int8 (the
        hybrid).  ``halfsplit`` pairs contraction halves per byte, falling
        back per kernel to row parity where the halves do not align with the
        groups.  (The JAX signature's ``nibble`` has no counterpart: nibble
        bytes are the port's only stored form.)"""
        params = quantize_params_int4_packed(self.params, group=group, mlp_only=mlp_only,
                                             halfsplit=halfsplit)
        self._set_params(quantize_params_int8_packed(params) if mlp_only else params)

    def prune_block_sparse(self, amount: float, block: tuple[int, int] = (256, 256),
                           scope: str = "global") -> dict:
        """Block-granular magnitude pruning wired into inference: the
        ``amount`` fraction of (block_k, block_n) blocks with the smallest L1
        norms is zeroed (``prune.block_masks``), then the decoder's kernels
        become ``BlockSparseKernel``s, whose matmul never reads a pruned
        block.  Returns the per-module block densities.

        ``scope="global"`` ranks all dense kernels together, as the JAX
        method does; at Dia-1.6B width that spends the budget on ``o_proj``
        slabs no kernel block holds and leaves every decoder kernel dense
        (see ``prune.block_masks``).  ``scope="module"`` (not in the JAX
        signature) ranks each kernel on its own."""
        from .prune import apply_masks, block_masks

        self._set_params(apply_masks(self.params, block_masks(self.params, amount, block=block,
                                                              scope=scope)))
        return self.sparsify_block(block)

    def sparsify_block(self, block: tuple[int, int] = (256, 256)) -> dict:
        """Pack the zero blocks the weights already have (a checkpoint written
        by ``offline_prune --prune-mode block``, or masks applied by hand) into
        ``BlockSparseKernel``s, pruning nothing more; their values are the
        dense kernels' storage, viewed 2-D.  Returns the per-module block
        densities."""
        from .ops.sparse import sparsify_params_block, sparsity_summary

        self._set_params(sparsify_params_block(self.params, block_k=block[0], block_n=block[1]))
        return sparsity_summary(self.params)

    def load_audio(self, audio_path: str | Path) -> np.ndarray:
        """WAV file → DAC codes int32 [T_codes, C] (reference:
        dia/model.py:546-576): mono, resampled to the codec's rate, padded to a
        hop multiple, encoded on this model's device."""
        self._require_dac()
        mono = load_audio_mono(audio_path, self.dac_config.sample_rate)
        mono = pad_audio(mono[None, :], self.dac_config.hop_length)
        codes = encode_audio(self.dac_params, self.dac_config,
                             torch.from_numpy(np.ascontiguousarray(mono)).to(self.device))
        return codes[0].cpu().numpy()

    # ---- adapters ----------------------------------------------------

    def load_adapter_weights(self, adapter_path: str | Path, fuse: bool = True) -> None:
        """Load a LoRA adapter directory (this package's, the JAX package's,
        or torch-peft's) and fuse it into the base weights (reference intent:
        dia/model.py:598-628).  The fused adapter is remembered so that
        ``unload_adapter`` / ``set_adapter`` can switch adapters (the fp32
        merge is invertible).  A packed (quantized) model raises: merge
        first, then quantize."""
        from .lora import load_adapter, merge_lora

        if not fuse:
            raise NotImplementedError(
                "Unfused adapters are not supported: fusion is free at inference "
                "(W + (alpha/r)·A@B folds into the kernels) and unload_adapter() "
                "reverses it. Use fuse=True.")
        adapter = load_adapter(adapter_path, self.device)
        self.unload_adapter()
        self._set_params(merge_lora(self.params, adapter))
        self._active_adapter = adapter

    def unload_adapter(self) -> None:
        """Un-merge the active adapter (the inverse of the fuse)."""
        from .lora import merge_lora

        if self._active_adapter is not None:
            self._set_params(merge_lora(self.params, self._active_adapter, sign=-1.0))
            self._active_adapter = None

    def set_adapter(self, adapter_path: str | Path) -> None:
        """Swap the active adapter (unload the current one, fuse the new)."""
        self.load_adapter_weights(adapter_path, fuse=True)

    def save_pretrained(self, directory: str | Path, include_dac: bool = True) -> None:
        """Write a model directory both packages load: config.json +
        model.safetensors (reference key schema, float32), plus — when codec
        weights are loaded and ``include_dac`` — dac.safetensors +
        dac_config.json."""
        from dataclasses import asdict

        from safetensors.numpy import save_file

        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        self.config.save(directory / "config.json")
        save_file({k: np.ascontiguousarray(v)
                   for k, v in to_torch_state_dict(self.params, self.config).items()},
                  str(directory / "model.safetensors"))
        bundle_dac = include_dac and self.dac_params is not None
        if bundle_dac:
            save_file(flatten_tree(self.dac_params), str(directory / "dac.safetensors"))
        if bundle_dac or self.dac_config != DACConfig():
            (directory / "dac_config.json").write_text(
                json.dumps(asdict(self.dac_config), indent=2))

    def save_audio(self, path: str | Path, audio: np.ndarray | None,
                   sample_rate: int = DEFAULT_SAMPLE_RATE) -> None:
        """Waveform → WAV file."""
        if audio is not None:
            write_wav(path, audio, sample_rate)
