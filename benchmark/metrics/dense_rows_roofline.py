"""The ``dense_rows`` kernel's share of its roofline: the byte bound of its
launches in the traced window (each launch one of the step's 145 products,
weight + x + output, in bf16, at a stream's 2 rows) over their device time
from the profiler.  Layer: kernels.  Moves ``audio_s_per_s``."""

from readers import dense_rows_roofline


def read(ctx):
    return dense_rows_roofline(ctx)
