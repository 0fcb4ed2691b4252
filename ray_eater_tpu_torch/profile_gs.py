"""Where the time of one flythrough frame, one training step, or one
raster frame goes on a CUDA device.

    python3 -m ray_eater_tpu_torch.profile_gs [--scene fog|inria|sh|train|
        basic_planes|multipass|grid10k|compute_drawing] [--frames 5]

``fog``/``inria`` render a bench scene (1M splats, 1920x1080, the scene's
knobs) through the port's ``render_gaussians``: a few warm LOD frames (with
temporal budgets where the scene uses them), then ``--frames`` LOD frames
and as many exact frames under ``torch.profiler``. ``train`` profiles
``--frames`` steps of ``make_train_step_pallas`` in the trainer's plain
configuration (1M splats at 1920x1080, mpt 256, tile_w 128, Adam lr 5e-3;
``gs_trainer``) after one warm-up step. The raster scenes render one frame
at t = 0.5 of ``raster_scenes.scene``: ``basic_planes`` (900x600),
``multipass`` (1920x1080, prepass + lit pass) and ``grid10k`` (the
10,082-triangle grid of ``tools/profile_raster.py`` at 1920x1080,
mip-sampled); ``compute_drawing`` one frame of that sample (900x600, the
splatted image on a quad). ``sh`` profiles the ``gs_viewer`` frame at its
defaults on the fog cloud with 15 SH bands from ``RandomState(1)`` (the
SH path of ``chip_smoke.py``) at t = 0.5, its budgets warmed over 8
frames, and ``eval_sh_colors`` alone.
Prints, per mode, the CUDA-event
time per frame (or step), the summed device time per frame of the top
kernels by name, the number of kernel launches per frame, the device
busy share (summed kernel time over wall time) and the device extent of
the render path's spans (``gs.bin.channels``, ``gs.bin.tail``: first to
last kernel inside each, idle gaps included). Needs a CUDA device; exits
2 without one.
"""

from __future__ import annotations

import argparse
import sys


def _profile(torch, frame, frames: int):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    frame()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(frames):
            frame()
        b.record()
        b.synchronize()
    wall_ms = a.elapsed_time(b)
    rows, spans = [], []
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.is_user_annotation \
                and e.key.startswith("gs."):
            # the render path's spans (ops/gs.py): on the device, first
            # to last kernel launched inside each, idle gaps included
            spans.append((e.device_time_total / 1e3 / frames, e.key))
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            # host-side ops, and annotated ranges such as the optimizer's
            # step: their kernels are rows too
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / frames, e.count / frames, e.key))
    rows.sort(reverse=True)
    return wall_ms / frames, rows, sorted(spans, reverse=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("fog", "inria", "sh", "train",
                                        "compute_drawing", *RASTER_SCENES),
                    default="fog")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_gs: no CUDA device", file=sys.stderr)
        return 2
    W, H, n = 1920, 1080, 1_000_000
    dev = torch.device("cuda")
    if args.scene == "train":
        modes = {"train step": _train_step(W, H, n, dev)}
    elif args.scene in RASTER_SCENES:
        modes = {f"{args.scene} frame": _raster_frame(args.scene, dev)}
    elif args.scene == "compute_drawing":
        from .compute_drawing import setup
        drawing = setup(dev)
        modes = {"compute_drawing frame": lambda: drawing.frame(0.5)}
    elif args.scene == "sh":
        modes = _sh_modes(n, dev)
    else:
        modes = _render_modes(args.scene, W, H, n, dev)
    for name, frame in modes.items():
        ms, rows, spans = _profile(torch, frame, args.frames)
        busy = sum(r[0] for r in rows)
        launches = sum(r[1] for r in rows)
        print(f"== {name}: {ms:.3f} ms/frame (CUDA events), device busy "
              f"{busy:.3f} ms/frame ({100 * busy / ms:.1f}%), "
              f"{launches:.0f} kernel launches/frame")
        for dev_ms, count, key in rows[:args.top]:
            print(f"  {dev_ms:9.4f} ms/frame  {count:6.1f}/frame  {key[:90]}")
        for dev_ms, key in spans:
            print(f"  {dev_ms:9.4f} ms/frame  span {key} (first to last "
                  "kernel, gaps included)")
    return 0


RASTER_SCENES = ("basic_planes", "multipass", "grid10k")


def _raster_frame(scene, dev):
    """One frame of a raster scene at t = 0.5 (camera included), as a
    closure."""
    from .raster_scenes import scene as raster_scene
    sc = raster_scene(scene, dev)
    return lambda: sc.frame(0.5)


def _sh_modes(n, dev):
    """The gs_viewer frame (defaults, SH colours) and eval_sh_colors alone
    on the synthetic cloud with 15 SH bands, budgets warmed over 8
    frames."""
    from .gs_viewer import parse_args, synthetic_cloud, viewer
    from .models.gaussians import eval_sh_colors
    cloud = synthetic_cloud(n, 15, dev)
    v = viewer(parse_args([]), cloud)
    budget = v.initial_budget()
    for _ in range(8):
        _, st = v.frame(0.5, budget)
        budget = v.next_budget(st, budget)
    eye = v.camera(0.5)[2]
    return {"sh LOD": lambda: v.frame(0.5, budget),
            "eval_sh_colors": lambda: eval_sh_colors(cloud, eye)}


def _train_step(W, H, n, dev):
    """One training step of the trainer's plain run, as a closure."""
    from .gs_trainer import train_setup
    from .models import gs_training as tr
    view, proj, target, params = train_setup(n, W, H, dev)
    step = tr.make_train_step_pallas(tr.adam(params, 5e-3), view, proj)
    return lambda: step(params, target)


def _render_modes(scene, W, H, n, dev):
    """The LOD and exact frame closures of a flythrough scene, its temporal
    budgets (if any) warmed over 8 frames."""
    from .bench_knobs import (bench_cloud, flythrough_camera, render_kwargs,
                              resolve_knobs)
    from .ops import gs
    knobs = resolve_knobs(scene, n, env={})
    kw_meas = render_kwargs(knobs, exact=False, interpret=False)
    kw_exact = render_kwargs(knobs, exact=True, interpret=False)
    mpt, tile_w = knobs["max_splats_per_tile"], knobs["tile_w"]
    ntx, nty = gs.num_tiles(W, H, tile_w)
    cloud = bench_cloud(scene, n, dev)
    view, proj = flythrough_camera(0.5, W, H, device=dev)
    budget = None
    if knobs["temporal"]:     # warm the temporal budgets over 8 frames
        budget = gs.initial_lod_budget(W, H, tile_w, mpt, dev)
        for _ in range(8):
            _, st = gs.render_gaussians(cloud, view, proj, W, H,
                                        lod_budget=budget, **kw_meas)
            budget = gs.update_lod_budget(st["tile_exec"], mpt, ntx, nty,
                                          st["tile_kept"], st["tile_count"],
                                          dry_floor=knobs["dry_floor"])

    return {
        f"{scene} LOD": lambda: gs.render_gaussians(
            cloud, view, proj, W, H, lod_budget=budget, **kw_meas),
        "exact": lambda: gs.render_gaussians(cloud, view, proj, W, H,
                                             **kw_exact),
    }


if __name__ == "__main__":
    sys.exit(main())
