"""The fused decode step kernel's share of its roofline, over the launches
of the traced request: each launch's least time (its pack's values and
scales, the int8 cache slots it reads for both rows, the text keys of the
conditional row, x in and out, this step's K/V out; over 3.35 TB/s, or its
operations over 989 TFLOP/s if larger) over the launches' device time from
the profiler.  Launch i of the request is its step i + 1; launches past the
stream's stop repeat its last step.  Layer: kernels.  Moves
``audio_s_per_s``."""

from readers import fused_roofline


def read(ctx):
    return fused_roofline(ctx)
