"""``glue_device_ms``: device milliseconds a traced frame of every
operation that is not one of the port's own CUDA kernels (the 3DGS glue
of ``ops/gs.py``: binning, the sort, the grants, the record pack, finalize,
the encode, and the copies and fills around them). The port's kernels are
named in ``glue_device_ms.json``."""

from _kernels import device_us, matcher
from harness.spec import metric_data

_PORT = matcher(metric_data(__file__)["port_kernels"])


def read(ctx):
    if not ctx.frames or not ctx.device_ops:
        return None
    us = device_us(ctx, lambda n: not _PORT(n))
    return us / 1e3 / ctx.frames if us > 0 else None
