"""Host milliseconds a decode step beyond the device's, over the window's
calls: (the calls' wall time, conditioning and codes read-back included,
minus the device time of their graph replays) over the steps replayed
(``DiaGenerator.last_stats``).  Layer: generation loop.  Moves
``audio_s_per_s``."""


def read(ctx):
    calls = ctx.window.layer.get("calls") or []
    steps = sum(c["replays"] * c["graph_steps"] + c["step_replays"] for c in calls)
    if steps <= 0:
        return None
    wall = sum(c["wall_seconds"] for c in calls)
    device = sum(c["replay_device_seconds"] for c in calls)
    return 1e3 * (wall - device) / steps
