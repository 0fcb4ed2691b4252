"""Scoped loggers (counterpart of ``ray_eater_tpu/utils/logging.py``,
stdlib only): one logger per component scope under the ``rayeater`` root,
the reference's ``std.log.scoped`` convention, so output filters per
subsystem. Importing this module configures nothing; :func:`configure`
installs one stderr handler.
"""

from __future__ import annotations

import logging

_ROOT = "rayeater"

#: Scope names of the reference's components.
SCOPES = (
    "validation", "instance", "device", "surface", "swapchain", "queue",
    "command_buffer", "renderpass", "graphics_pipeline", "buffer",
    "descriptor", "image", "shader", "depth_buffer", "graph", "present",
    "raster", "splat", "gs", "bench", "parallel", "io", "native",
    "animation",
)


def scoped(name: str) -> logging.Logger:
    """The logger of a component scope (``rayeater.<name>``)."""
    return logging.getLogger(f"{_ROOT}.{name}")


def configure(level: int | str = "WARNING") -> None:
    """Give the ``rayeater`` root logger one stderr handler at ``level``
    (once; later calls change nothing). An unknown level name falls back
    to WARNING with a warning."""
    root = logging.getLogger(_ROOT)
    if root.handlers:
        return
    handler = logging.StreamHandler()
    handler.setFormatter(
        logging.Formatter("%(levelname).1s %(name)s: %(message)s"))
    root.addHandler(handler)
    try:
        root.setLevel(level.upper() if isinstance(level, str) else level)
    except ValueError:
        root.setLevel(logging.WARNING)
        root.warning("unknown log level %r; using WARNING", level)
