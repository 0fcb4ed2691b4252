"""The import guard: a run of the port may not have loaded JAX or the JAX
package. Module names are compared by their top-level name, whole: the
port's ``ray_eater_tpu_torch`` begins with ``ray_eater_tpu`` and is not
it."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_eater_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (``sys.modules``
    by default)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
