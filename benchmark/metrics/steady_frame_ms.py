"""``steady_frame_ms``: the host-clock milliseconds a frame over the
window's last seconds (``harness.cell.STEADY_S``), after the slow first
seconds of the process that ``frame_ms`` takes in whole: the steady frame
time, which shows a gain or a loss smaller than ``frame_ms``'s bound."""


def read(ctx):
    v = ctx.steady_frame_ms
    return float(v) if v > 0 else None
