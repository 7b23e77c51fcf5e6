"""PyTorch/CUDA port of the Dia text→dialogue-speech system.

A package of its own beside ``dia_tts_prune_tpu`` (the JAX reference, which
it never imports): the same module names, PyTorch inside, and hand-written
CUDA kernels for Hopper where the JAX package has Pallas kernels.  Entry
points run on ``device="cuda"`` unless the caller passes another device.
"""

from .api import Dia
from .config import DiaConfig, dia_1_6b_config, tiny_test_config

__all__ = ["Dia", "DiaConfig", "dia_1_6b_config", "tiny_test_config"]
