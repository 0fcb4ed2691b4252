"""Render knobs and camera of the 3DGS flythrough, for the port.

The port's own copy of ``resolve_knobs``, ``render_kwargs``,
``LOD_ONLY_KNOBS`` and ``flythrough_camera`` from the repository's
``bench.py`` (which stays the JAX benchmark). The knob values and their
environment overrides must stay equal to that file's; a test holds them
together. ``bench_cloud`` and ``layout_kwargs`` define the bench frames
whose composites ``chip_smoke.py`` checks and ``time_composite.py`` times.
"""

from __future__ import annotations

import os

import torch

from . import rmath
from .models.gaussians import inria_cloud, random_cloud
from .ops import gs
from .utils import on_device

#: knobs that exist only on the measured (LOD) config: the PSNR gate's exact
#: reference differs from the measured config in exactly these keys
LOD_ONLY_KNOBS = ("max_splats_per_tile", "lod_seg", "lod_tail_decim",
                  "lod_tail_d", "return_stats")


def resolve_knobs(scene: str, n: int, env=None) -> dict:
    """Every render knob of a bench scene ("fog", "shell", "inria",
    "trained") for an ``n``-splat cloud, from per-scene defaults and
    ``RAYEATER_BENCH_*`` environment overrides. One source for the measured
    frame, the PSNR gate's exact reference and the warmed temporal frames."""
    env = os.environ if env is None else env

    # three-level binning budgets for large splats (0 disables)
    big_cap_default = {"inria": n // 32, "trained": n // 16}.get(scene, 0)
    mid_cap_default = {"inria": n // 16, "trained": n // 8}.get(scene, 0)
    midlo_cap_default = {"inria": n // 5, "trained": n // 4}.get(scene, 0)
    big_cap = int(env.get("RAYEATER_BENCH_BIGCAP",
                          big_cap_default)) or None
    mid_cap = (int(env.get("RAYEATER_BENCH_MIDCAP",
                           mid_cap_default)) or None) if big_cap else None
    midlo_cap = (int(env.get("RAYEATER_BENCH_MIDLOCAP",
                             midlo_cap_default)) or None) \
        if mid_cap else None

    # pair buffers sized at 4 pairs/splat; 0 = exact worst-case buffers
    capf = int(env.get("RAYEATER_BENCH_CAP_FACTOR", 4)) or None

    # per-tile LOD pool average; RAYEATER_BENCH_MPT=0 renders exact
    mpt_default = {"fog": 176, "shell": 640, "inria": 128,
                   "trained": 128}.get(scene, 384)
    # certified mode: pool sized at the saturation need
    certified = env.get("RAYEATER_BENCH_CERTIFIED", "0") != "0"
    if certified:
        mpt_default = {"fog": 384, "shell": 704, "inria": 768}.get(
            scene, 512)
    mpt = int(env.get("RAYEATER_BENCH_MPT", mpt_default)) or None

    # decimated-tail pool (0 = off); never in certified mode
    tail_default = 0 if certified else {
        "inria": 768, "trained": 768}.get(scene, 0)
    tail = int(env.get("RAYEATER_BENCH_TAIL", tail_default)) or None
    if tail is not None and not mpt:
        tail = None
    tail_d = int(env.get("RAYEATER_BENCH_TAIL_D",
                         {"inria": 4, "trained": 4}.get(scene, 2)))

    tile_w = int(env.get("RAYEATER_BENCH_TILEW",
                         {"inria": 64, "trained": 64}.get(scene, 32)))

    # K-reduction corner channel (0 = off)
    corner_cap = int(env.get(
        "RAYEATER_BENCH_CORNER_CAP",
        {"inria": n // 8, "trained": n // 8}.get(scene, 0))) or None

    payload = env.get("RAYEATER_BENCH_PAYLOAD", "1") != "0"

    # temporal adaptive LOD: on for fog/shell, off for inria-style scenes
    temporal_default = "0" if scene in ("inria", "trained") else "1"
    temporal = bool(mpt) and (
        env.get("RAYEATER_BENCH_TEMPORAL", temporal_default) != "0")

    lod_seg = int(env.get("RAYEATER_BENCH_LODSEG", 1))

    dry_floor = env.get("RAYEATER_BENCH_DRYFLOOR",
                        {"inria": "static",
                         "trained": "static"}.get(scene, "jump"))

    return dict(payload_sort=payload, pairs_cap_factor=capf,
                max_splats_per_tile=mpt, big_splat_cap=big_cap,
                mid_splat_cap=mid_cap, mid_lo_splat_cap=midlo_cap,
                corner_cap=corner_cap, tile_w=tile_w, lod_seg=lod_seg,
                lod_tail_decim=tail, lod_tail_d=tail_d,
                temporal=temporal, certified=certified,
                dry_floor=dry_floor)


def render_kwargs(knobs: dict, exact: bool, interpret: bool) -> dict:
    """``render_gaussians`` kwargs for the measured config (exact=False) or
    the PSNR gate's exact reference (exact=True), from one knob dict; the
    exact side drops exactly ``LOD_ONLY_KNOBS`` and uses exact buffers."""
    kw = dict(payload_sort=knobs["payload_sort"],
              pairs_cap_factor=knobs["pairs_cap_factor"],
              big_splat_cap=knobs["big_splat_cap"],
              mid_splat_cap=knobs["mid_splat_cap"],
              mid_lo_splat_cap=knobs["mid_lo_splat_cap"],
              corner_cap=knobs["corner_cap"],
              tile_w=knobs["tile_w"],
              interpret=interpret)
    if exact:
        kw["pairs_cap_factor"] = None
    else:
        kw.update(max_splats_per_tile=knobs["max_splats_per_tile"],
                  lod_seg=knobs["lod_seg"],
                  lod_tail_decim=knobs["lod_tail_decim"],
                  lod_tail_d=knobs["lod_tail_d"],
                  return_stats=True)
    return kw


#: the ``render_kwargs`` that ``render_gaussians`` hands to the layout
#: (``gs._frame_layout``)
LAYOUT_KEYS = ("pairs_cap_factor", "max_splats_per_tile", "big_splat_cap",
               "mid_splat_cap", "mid_lo_splat_cap", "corner_cap", "tile_w",
               "lod_tail_decim")


def layout_kwargs(knobs: dict, exact: bool, W: int, H: int, device) -> dict:
    """``gs._frame_layout`` kwargs of a bench scene's first frame, as
    ``render_gaussians`` lays it out under ``render_kwargs(knobs, exact)``:
    the measured LOD frame, with the first temporal budget
    (``gs.initial_lod_budget``) where the scene uses temporal budgets, or
    the PSNR gate's exact reference."""
    kw = render_kwargs(knobs, exact, interpret=False)
    out = {k: kw[k] for k in LAYOUT_KEYS if k in kw}
    if knobs["temporal"] and not exact:
        out["lod_budget"] = gs.initial_lod_budget(
            W, H, knobs["tile_w"], knobs["max_splats_per_tile"], device)
    return out


def bench_cloud(scene: str, n: int, device):
    """The bench scene's ``n``-splat cloud (seed 1): ``inria_cloud`` for
    inria; for fog ``random_cloud`` with extent 1 and scales in
    (0.004, 0.02)."""
    if scene == "inria":
        return inria_cloud(n, seed=1, device=device)
    if scene == "fog":
        return random_cloud(n, seed=1, extent=1.0, scale_range=(0.004, 0.02),
                            device=device)
    raise ValueError(f"bench_cloud: no cloud for scene {scene!r}")


def flythrough_camera(t, W: int, H: int, device="cuda"):
    """The bench flythrough camera at time ``t`` (seconds): an orbit of
    radius 2.5 at height 0.8 around the origin, 30°/s, 60° vertical FOV.
    Returns (view, proj) (4, 4) f32 on ``device``."""
    t = (t.to(torch.float32) if isinstance(t, torch.Tensor)
         else on_device(t, device))
    ang = rmath.radians(30.0, device=t.device) * t
    eye = torch.stack([2.5 * torch.cos(ang), on_device(0.8, t.device),
                       2.5 * torch.sin(ang)])
    view = rmath.look_at_zforward(eye, rmath.vec(0.0, 0.0, 0.0,
                                                 device=t.device))
    proj = rmath.perspective(rmath.radians(60.0, device=t.device), W / H,
                             0.05, 50.0)
    return view, proj
