"""``side_dropped_splats``: splats a frame that the side channels (the
corner, mid-lo, mid and coarse fans of ``ops/gs.py`` ``_bin_splats``)
dropped whole because their channel was full, a mean over the run's LOD
frames, from the port's frame counters."""

from _counters import totals


def read(ctx):
    c = totals()
    if c is None or "side_dropped_splats" not in c:
        return None
    return c["side_dropped_splats"] / c["frames"]
