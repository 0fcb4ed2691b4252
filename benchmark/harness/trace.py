"""The traced slice of a ``--trace 1`` run: frames replayed under
``torch.profiler`` (CUPTI), read into device intervals and host events.

What the per-layer readers get (:class:`TraceContext`): the device
operations of the slice (kernels, copies, fills) as (name, start us, end
us), the slice's window, each traced frame's time and the reference's work
of each traced frame; from the untraced window of the same run, the
milliseconds a frame of its last seconds and the checked frames' work
with each one's time;
and the program's record of its capture.

The profiler lengthens each graph launch on the host (CUPTI prepares every
node of the graph for its timestamps), so the traced frames take longer
than the window's while the card's work in them does not change: device
times come from the slice, a frame's wall time from the window's last
seconds, which run just before the slice.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TraceContext:
    device_ops: list                 # [(name, start_us, end_us)]
    host_ops: list                   # [(name, start_us, end_us)]
    window_us: tuple                 # (start, end) of the traced frames
    frame_ms: list                   # each traced frame's time
    work: list = field(default_factory=list)   # reference work a frame
    info: dict = field(default_factory=dict)   # render_animation's record
    steady_frame_ms: float = 0.0     # the window's last seconds' ms a frame
    checked: list = field(default_factory=list)  # [(work, frame ms)]

    @property
    def frames(self) -> int:
        return len(self.frame_ms)


def _merged(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def clipped(ops, window):
    """``ops`` (name, start, end) cut to ``window``; those outside go."""
    a, b = window
    return [(n, max(s, a), min(e, b)) for n, s, e in ops if e > a and s < b]


def busy_us(ctx: TraceContext) -> float:
    """Microseconds of the window in which some operation ran on the card."""
    return sum(e - s for s, e in _merged(
        (s, e) for _, s, e in clipped(ctx.device_ops, ctx.window_us)))


def idle_gaps(ctx: TraceContext, top: int = 10) -> list:
    """The longest gaps with nothing on the card, each named by the
    innermost host operation running at its middle: [[name, seconds]]."""
    a, b = ctx.window_us
    busy = _merged((s, e) for _, s, e in clipped(ctx.device_ops,
                                                 ctx.window_us))
    gaps, cur = [], a
    for s, e in busy:
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if b > cur:
        gaps.append((cur, b))
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
        mid = 0.5 * (s + e)
        inner = [(hs, n) for n, hs, he in ctx.host_ops if hs <= mid <= he]
        name = max(inner)[1] if inner else "no host op"
        out.append([name, (e - s) / 1e6])
    return out


def device_ops_top(ctx: TraceContext, top: int = 10) -> list:
    """The device operations that took the most time in the window, summed
    by name: [[name, seconds]]."""
    by = {}
    for n, s, e in clipped(ctx.device_ops, ctx.window_us):
        by[n] = by.get(n, 0.0) + (e - s)
    rows = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    return [[n[:120], us / 1e6] for n, us in rows]


def collect(prof) -> tuple[list, list]:
    """(device ops, host ops) of a finished ``torch.profiler.profile``,
    each (name, start us, end us) on the profiler's one clock. The device's
    copies of host annotations (a range over the kernels launched inside
    one) are left out: they are no operation."""
    from torch.autograd import DeviceType
    dev, host = [], []
    for ev in prof.events():
        tr = ev.time_range
        row = (ev.name, float(tr.start), float(tr.end))
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False):
                dev.append(row)
        else:
            host.append(row)
    return dev, host
