"""``lod_kept_pct``: the share of the pairs the binning emitted that the
LOD composites (the head, and the decimated tail where there is one):
100 x (1 - pairs dropped / pairs emitted) over the run's LOD frames, from
the port's frame counters."""

from _counters import totals


def read(ctx):
    c = totals()
    if c is None or not c.get("pairs_emitted"):
        return None
    return 100.0 * (1.0 - c["pairs_dropped"] / c["pairs_emitted"])
