"""Device milliseconds of one decode step, from CUDA events around the
decode loop's graph replays, over every step replayed in the window (a
replay's steps past a stream's stop included): the calls'
``last_stats``.  Layer: model step.  Moves
``audio_s_per_s``."""

from readers import step_device_ms


def read(ctx):
    return step_device_ms(ctx)
