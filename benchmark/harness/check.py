"""The check that decides ``correct``: frames of the window against the
reference, once the window has closed.

The reference renders, at the timed size, with the same scene and the same
views:

* the first ``start_frames`` frames from the first budget, carrying its
  own budget from frame to frame (the start of the temporal LOD);
* a sample of the kept frames, drawn from the seed, each from the budget
  the program carried into it (the reference cannot reach frame i of the
  window but by i frames, so it follows the program's state there, and
  checks that state's step, the next budget, on each frame).

Numbers (those that ``limits/<cell>.json`` gives a limit are compared,
the others reported beside them):

* ``img_mean_gap``: the mean of |program - reference| over every u8 code
  of the compared frames;
* ``img_max_gap``: the largest such gap;
* ``img_codes_over_1``: the most codes whose gap exceeds 1 in one compared
  frame (a frame at a time, so that one wrong tile of one frame shows);
* ``budget_off``: with a temporal budget, the budget entries (tile, channel)
  where the program's next budget differs from the reference's, summed
  over the compared frames.
"""

from __future__ import annotations

import numpy as np
import torch

from reference import render as ref
from reference.camera import orbit_view


def sample(kept: list, seed: int, start: int, count: int) -> list:
    """The start frames, then ``count`` of the later kept frames drawn
    from the seed."""
    head = [k for k in kept if k.index < start]
    rest = [k for k in kept if k.index >= start]
    rng = np.random.default_rng([seed % (1 << 64), 0x5A])
    pick = sorted(rng.choice(len(rest), size=min(count, len(rest)),
                             replace=False).tolist()) if rest else []
    return head + [rest[j] for j in pick]


def reference_frame(cloud, config, sched, index, budget, blend=torch.float32):
    view, proj, eye = orbit_view(sched.view(index), sched.camera,
                                 sched.width, sched.height)
    return ref.render(cloud, view, proj, sched.width, sched.height,
                      config["knobs"], sched.lod, budget, blend, eye)


def reference_budget(config: dict, sched, dev):
    """The reference's first budget (None without a temporal LOD)."""
    knobs = config["knobs"]
    if not (sched.lod and knobs.get("temporal", False)):
        return None
    ntx, nty = ref.num_tiles(sched.width, sched.height, knobs["tile_w"])
    return ref.initial_budget(ntx * nty, knobs["max_splats_per_tile"], dev)


def compare(kept: list, cloud: dict, config: dict, sched, seed: int,
            limits: dict, initial_budget, on_reference=None) -> dict:
    """The numbers of the check over the sampled frames, the compared ones
    with their limits, and how many frames failed: {"numbers": {name:
    (value, limit)}, "info": {name: value}, "failed": n, "correct": bool,
    "frames": [indices]}.
    ``on_reference(index, frame)`` sees each reference frame."""
    chk = sched.check
    frames = sample(kept, seed, chk["start_frames"], chk["sampled_frames"])
    temporal = sched.lod and config["knobs"].get("temporal", False)
    gap_sum, codes, gap_max, over1, budget_off = 0.0, 0, 0, 0, 0
    failed = 0
    ref_budget = initial_budget
    for k in frames:
        b_in = (ref_budget if k.index < chk["start_frames"]
                else k.budget_in)
        fr = reference_frame(cloud, config, sched, k.index, b_in)
        if on_reference is not None:
            on_reference(k.index, fr)
        got = k.image.to(fr.image.device)
        d = (got.to(torch.int16) - fr.image.to(torch.int16)).abs()
        one = {"img_mean_gap": float(d.sum(dtype=torch.float64)) / d.numel(),
               "img_max_gap": int(d.max()),
               "img_codes_over_1": int((d > 1).sum())}
        gap_sum += one["img_mean_gap"] * d.numel()
        codes += d.numel()
        gap_max = max(gap_max, one["img_max_gap"])
        over1 = max(over1, one["img_codes_over_1"])
        if temporal:
            one["budget_off"] = int((k.budget_out.to(fr.budget.device)
                                     != fr.budget).sum())
            budget_off += one["budget_off"]
            ref_budget = fr.budget
        failed += any(v > limits[n] for n, v in one.items() if n in limits)
        del fr
    values = {"img_mean_gap": gap_sum / max(codes, 1),
              "img_max_gap": gap_max, "img_codes_over_1": over1}
    if temporal:
        values["budget_off"] = budget_off
    numbers = {n: (v, limits[n]) for n, v in values.items() if n in limits}
    info = {n: v for n, v in values.items() if n not in limits}
    correct = (bool(frames) and bool(numbers)
               and all(v <= lim for v, lim in numbers.values()))
    return {"numbers": numbers, "info": info, "failed": failed,
            "correct": correct, "frames": [k.index for k in frames]}
