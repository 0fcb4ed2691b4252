"""Shared by the per-layer readers: which device operations belong to a
kernel named in a reader's data file."""

from __future__ import annotations

import re


def matcher(names):
    """A predicate on device-operation names: true for the operations of
    the CUDA kernels ``names`` (function names, compared as whole words, so
    a template's arguments and the signature do not matter)."""
    pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
    return lambda op: pat.search(op) is not None


def device_us(ctx, pred) -> float:
    """Microseconds of the traced window's device operations that ``pred``
    selects."""
    from harness.trace import clipped
    return sum(e - s for n, s, e in clipped(ctx.device_ops, ctx.window_us)
               if pred(n))
