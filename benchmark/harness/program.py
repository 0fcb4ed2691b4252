"""The system under test: the port's frame, one ``render_animation`` call a
frame (the closed loop of one viewer, as ``gs_viewer.ServeFrames`` serves
it), and the control that stands in its place when the check is proven.

Every program answers ``frame(az, budget) -> (u8 image, next budget)``
and ``initial_budget()`` (None when the frame carries no budget).
"""

from __future__ import annotations

import torch

from reference import render as ref
from reference.camera import orbit_view

from .check import reference_budget

#: the configuration's knobs that ``render_gaussians`` takes in LOD mode;
#: exact mode keeps those of :data:`EXACT_KEYS` and no pair cap
LOD_KEYS = ("payload_sort", "pairs_cap_factor", "max_splats_per_tile",
            "big_splat_cap", "mid_splat_cap", "mid_lo_splat_cap",
            "corner_cap", "tile_w", "lod_seg", "lod_tail_decim", "lod_tail_d")
EXACT_KEYS = ("payload_sort", "big_splat_cap", "mid_splat_cap",
              "mid_lo_splat_cap", "corner_cap", "tile_w")


class PortFrames:
    """The port's frame step, captured once by ``render_animation`` and
    replayed a frame a call. The step calls only the port's public
    functions: ``ops.gs.render_gaussians`` with the configuration's knobs
    and the eye (``cam_pos``, at which it evaluates the splats' SH colours),
    ``update_lod_budget``, ``initial_lod_budget`` and ``num_tiles``; its
    carry is the view's azimuth and, with a temporal LOD, the budget."""

    def __init__(self, cloud: dict, config: dict, sched, dev):
        from ray_eater_tpu_torch.core import animation
        from ray_eater_tpu_torch.models.gaussians import GaussianCloud
        from ray_eater_tpu_torch.ops import gs
        self.gs, self.animation, self.dev = gs, animation, dev
        self.cloud = GaussianCloud(**cloud)
        self.sched = sched
        knobs = config["knobs"]
        self.knobs = knobs
        if sched.lod:
            self.kw = {k: knobs[k] for k in LOD_KEYS if k in knobs}
            self.kw["return_stats"] = True
        else:
            self.kw = {k: knobs[k] for k in EXACT_KEYS if k in knobs}
            self.kw["pairs_cap_factor"] = None
        self.temporal = sched.lod and knobs.get("temporal", False)
        self.ntx, self.nty = gs.num_tiles(sched.width, sched.height,
                                          knobs["tile_w"])
        # one bound method object: render_animation caches graphs by it
        self.step = self._step
        self.info: dict = {}

    def _step(self, t, carry):
        s = self.sched
        view, proj, eye = orbit_view(carry["az"], s.camera, s.width,
                                     s.height)
        if not s.lod:
            return self.gs.render_gaussians(self.cloud, view, proj, s.width,
                                            s.height, cam_pos=eye,
                                            **self.kw), carry
        budget = carry.get("budget")
        img, st = self.gs.render_gaussians(self.cloud, view, proj, s.width,
                                           s.height, cam_pos=eye,
                                           lod_budget=budget, **self.kw)
        if budget is None:
            return img, carry
        nb = self.gs.update_lod_budget(
            st["tile_exec"], self.knobs["max_splats_per_tile"], self.ntx,
            self.nty, st["tile_kept"], st["tile_count"],
            dry_floor=self.knobs["dry_floor"])
        return img, {"az": carry["az"], "budget": nb}

    def initial_budget(self):
        if not self.temporal:
            return None
        return self.gs.initial_lod_budget(
            self.sched.width, self.sched.height, self.knobs["tile_w"],
            self.knobs["max_splats_per_tile"], self.dev)

    def frame(self, az, budget):
        carry = {"az": az} if budget is None else {"az": az,
                                                   "budget": budget}
        info = {}
        img = self.animation.render_animation(
            self.step, 1, keep="last", carry=carry, device=self.dev,
            info=info)
        if info.get("captured"):
            self.info = info
        return img, (info["carry"]["budget"] if budget is not None
                     else None)

    def release(self) -> None:
        """Free the captured graph and its pool."""
        self.animation.release(self.step)
        self.cloud = None


class ReferenceFrames:
    """The reference in the program's place: with ``blend`` bfloat16, the
    control that the check must refuse."""

    def __init__(self, cloud: dict, config: dict, sched, dev,
                 blend=torch.bfloat16):
        self.cloud, self.config, self.sched, self.dev = (cloud, config,
                                                         sched, dev)
        self.blend = blend
        self.info = {}

    def initial_budget(self):
        return reference_budget(self.config, self.sched, self.dev)

    def frame(self, az, budget):
        s = self.sched
        view, proj, eye = orbit_view(az, s.camera, s.width, s.height)
        fr = ref.render(self.cloud, view, proj, s.width, s.height,
                        self.config["knobs"], s.lod, budget, self.blend, eye)
        return fr.image, fr.budget

    def release(self) -> None:
        pass
