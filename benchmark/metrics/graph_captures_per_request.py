"""CUDA graph captures a request, over the window's calls of
``Dia.generate`` (``DiaGenerator.last_stats.captures``): the decode loop
keeps the graphs of the last few keys (cache-length bucket, text window,
greedy or sampled), and a request of another key captures its own.
Layer: generation loop.  Moves ``audio_s_per_s``."""


def read(ctx):
    calls = ctx.window.layer.get("calls") or []
    if not calls:
        return None
    return sum(c["captures"] for c in calls) / len(calls)
