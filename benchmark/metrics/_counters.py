"""Shared by the readers of the port's frame counters: the totals that its
LOD frames added on the card over the run (``ray_eater_tpu_torch``'s
``utils.profiler.read_counters``: frames, valid splats, pairs emitted,
pairs dropped, splats the side channels dropped), read once the run's
frames are done. A program without the counters, or one that counted no
frame, gives None."""

from __future__ import annotations


def totals() -> dict | None:
    try:
        from ray_eater_tpu_torch.utils import profiler
    except ImportError:
        return None
    read = getattr(profiler, "read_counters", None)
    c = read() if read is not None else None
    return c if c and c.get("frames") else None
