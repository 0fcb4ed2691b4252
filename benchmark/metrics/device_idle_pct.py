"""``device_idle_pct``: the share of a steady frame's time in which nothing
ran on the card: one less the card's busy time a frame (kernels, copies
and fills, merged, over the traced frames) over the host-clock
milliseconds a frame of the window's last seconds, which run just before
the traced frames and, like them, after the process's slow start. The
traced frames' own wall time is not used: the profiler lengthens every
graph launch on the host."""

from harness.trace import busy_us


def read(ctx):
    if not ctx.frames or not ctx.device_ops or ctx.steady_frame_ms <= 0:
        return None
    busy_ms = busy_us(ctx) / 1e3 / ctx.frames
    return 100.0 * (1.0 - busy_ms / ctx.steady_frame_ms)
