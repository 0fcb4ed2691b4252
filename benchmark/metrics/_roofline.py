"""Shared by the ``<kernel>_roofline`` readers: a kernel's least time at
the published peaks, from the reference's work of the traced frames, over
its device time in the trace."""

from __future__ import annotations

from _kernels import device_us, matcher
from reference.work import least_s


def share(ctx, kernels, piece: str):
    """Percent of the roofline, or None where the trace holds none of the
    kernel's time or the frames none of its work."""
    us = device_us(ctx, matcher(kernels))
    least = sum(least_s(w[piece]["flops"], w[piece]["bytes"])[0]
                for w in ctx.work if piece in w)
    if us <= 0 or least <= 0:
        return None
    return 100.0 * least / (us / 1e6)
