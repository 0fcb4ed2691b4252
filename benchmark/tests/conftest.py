"""The benchmark's tests import its folder's modules (``harness``,
``reference``) and the port from the checkout's root, as ``run.py`` does.
Run them from the root: ``python -m pytest benchmark/tests -q``."""

import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
for p in (str(BENCH.parent), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)


def shrink(cell, num_splats: int, width: int, height: int):
    """``cell`` at a test's size: ``num_splats`` splats (the side channels'
    budgets scaled with them) and a ``width`` x ``height`` frame; every
    other knob, the traffic's views and the limits as the cell has them."""
    import copy
    cell = copy.deepcopy(cell)
    n0 = cell.config["scene_params"]["num_splats"]
    cell.config["scene_params"]["num_splats"] = num_splats
    knobs = cell.config["knobs"]
    for k in ("big_splat_cap", "mid_splat_cap", "mid_lo_splat_cap",
              "corner_cap"):
        if knobs.get(k):
            knobs[k] = max(1, knobs[k] * num_splats // n0)
    cell.traffic = dict(cell.traffic, width=width, height=height,
                        check=dict(cell.traffic["check"], stride=4))
    return cell
