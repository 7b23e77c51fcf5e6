"""The decode step's share of the chip's peaks: the least time the chip
could take for the window's needed steps (the larger of operations over
989 TFLOP/s and bytes over 3.35 TB/s; bytes: the decoder's weights or
packs read once a step, the rows' embeddings and activations, the caches
read and this step's K/V written) over the device time of the steps
replayed.  Layer: model step.  Moves ``audio_s_per_s``."""

from readers import step_mfu


def read(ctx):
    return step_mfu(ctx)
