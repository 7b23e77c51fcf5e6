"""Top-level user API: class ``Dia`` (counterpart of ``dia_tts_prune_tpu/api.py``;
reference: dia/model.py:101-846).

``Dia.from_pretrained(local_dir)`` / ``Dia.from_local(config, checkpoint)``,
``generate_codes(text)`` → codec tokens, ``generate(text)`` → waveform and
``save_audio`` (16-bit PCM WAV).  Everything runs on ``device``, ``"cuda"``
unless the caller passes another; asking for CUDA on a machine without it
raises — nothing moves to the CPU on its own.
"""

from __future__ import annotations

import json
import wave
from pathlib import Path

import numpy as np
import torch

from .checkpoint import load_safetensors_checkpoint
from .config import DiaConfig
from .generate import DTYPES, DiaGenerator
from .models.dac import DEFAULT_SAMPLE_RATE, DACConfig, decode_codes, load_dac_safetensors


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
        self.generator = DiaGenerator(params, config, compute_dtype, self.device)

    @classmethod
    def from_local(cls, config_path: str | Path, checkpoint_path: str | Path,
                   compute_dtype: str = "float32", dac_config=None,
                   device: str | torch.device = "cuda") -> "Dia":
        """Load a reference-format config.json + safetensors checkpoint."""
        dev = resolve_device(device)
        config = DiaConfig.load(config_path)
        if config is None:
            raise FileNotFoundError(f"Config file not found at {config_path}")
        params = load_safetensors_checkpoint(checkpoint_path, config, DTYPES[compute_dtype], dev)
        return cls(config, params, compute_dtype, dac_config=load_dac_config(dac_config),
                   device=dev)

    @classmethod
    def from_pretrained(cls, model_dir: str | Path, compute_dtype: str = "float32",
                        device: str | torch.device = "cuda") -> "Dia":
        """Load a local model directory: config.json + model.safetensors, and,
        when present, dac_config.json + dac.safetensors (the codec)."""
        dev = resolve_device(device)
        path = Path(model_dir)
        if not path.is_dir():
            raise FileNotFoundError(f"'{model_dir}' is not a local model directory")
        dac_cfg = path / "dac_config.json"
        dia = cls.from_local(path / "config.json", path / "model.safetensors", compute_dtype,
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

    def _decode_waveform(self, codes_TxC: np.ndarray) -> np.ndarray:
        if self.dac_params is None:
            raise RuntimeError("DAC weights not loaded: set dac_params or load a model "
                               "directory with dac.safetensors")
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
        ``audio_prompt`` is a pre-encoded [T, C] code array (voice cloning
        from an audio file needs the DAC encoder, not ported yet)."""
        if isinstance(audio_prompt, (str, Path)):
            raise NotImplementedError("audio prompts from files need the DAC encoder, which "
                                      "the port does not have yet; pass [T, C] codes")
        codes = self.generate_codes(
            text, max_tokens=max_tokens, cfg_scale=cfg_scale, temperature=temperature,
            top_p=top_p, cfg_filter_top_k=cfg_filter_top_k,
            audio_prompt_codes=None if audio_prompt is None else np.asarray(audio_prompt),
            audio_prompt_text=audio_prompt_text, seed=seed, verbose=verbose)
        if codes.shape[0] == 0:
            return None
        return self._decode_waveform(codes)

    def save_audio(self, path: str | Path, audio: np.ndarray | None,
                   sample_rate: int = DEFAULT_SAMPLE_RATE) -> None:
        """Waveform → WAV file."""
        if audio is not None:
            write_wav(path, audio, sample_rate)
