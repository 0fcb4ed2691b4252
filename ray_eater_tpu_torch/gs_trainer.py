"""Fit a Gaussian-splat scene to rendered target images (counterpart of
``samples/gs_trainer.py``).

    python3 -m ray_eater_tpu_torch.gs_trainer [--splats N] [--steps N]
        [--width W] [--height H] [--path pallas|jnp] [--out DIR]
        [--device cuda|cpu]
    torchrun --nproc-per-node D -m ray_eater_tpu_torch.gs_trainer --dp
        [--device cuda|cpu] ...
    python3 -m ray_eater_tpu_torch.gs_trainer --adc [--splats N]
        [--capacity C] [--views V] [--densify-every K] [--steps N]
        [--save-ply PATH]

The plain run renders a target from a hidden ``random_cloud(seed=42)``
through the differentiable path, then fits a ``random_cloud(seed=7)`` to it
with Adam from one camera. ``--adc`` reconstructs a hidden scene from a
ring of views, starting from a small random cloud and growing it with the
INRIA adaptive density control loop, and scores two held-out views;
``--save-ply`` writes its live splats as a 3DGS PLY. ``--path pallas``
(the default above 4096 splats) trains through the kernels (K4 forward,
K5 backward on CUDA); ``jnp`` through the plain ``render_diff``. ``--dp``
trains the plain run data-parallel over the launcher's ranks
(``make_train_step_dp`` through ``render_diff``; NCCL on CUDA, one card a
rank, gloo with ``--device cpu``); only rank 0 prints and writes files.
Runs on CUDA unless ``--device cpu``. The first view's target and fitted
images go to ``--out`` as ``target.png`` and ``fitted.png``.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import rmath
from .io.image import save_png, to_srgb_u8
from .models.gaussians import GaussianCloud, random_cloud, save_ply
from .models.gs_densify import (densify_and_prune, init_densify_state,
                                make_train_window_adc, pad_params,
                                reset_new_slots, reset_opacity)
from .models.gs_training import (adam, cloud_from_params, make_train_step,
                                 make_train_step_dp, make_train_step_pallas,
                                 params_from_cloud, render_diff,
                                 render_diff_pallas)


class _Clock:
    """Elapsed ms: CUDA events on a CUDA device, the host clock on CPU."""

    def __init__(self, dev: torch.device):
        self.cuda = dev.type == "cuda"

    def start(self):
        if self.cuda:
            self.a = torch.cuda.Event(enable_timing=True)
            self.b = torch.cuda.Event(enable_timing=True)
            self.a.record()
        else:
            self.t = time.perf_counter()

    def stop_ms(self) -> float:
        if self.cuda:
            self.b.record()
            self.b.synchronize()
            return self.a.elapsed_time(self.b)
        return (time.perf_counter() - self.t) * 1e3


def _renderer(path: str):
    if path == "jnp":
        return render_diff
    return lambda p, v, pr, w, h: render_diff_pallas(p, v, pr, w, h)


def train_setup(n: int, w: int, h: int, dev, path: str = "pallas"):
    """The plain run's problem: (view, proj, target, params). The camera
    sits at (0, 0.3, -2.5) looking at the origin with a 60° vertical field
    of view; the target is the hidden ``random_cloud(n, seed=42)`` rendered
    through the differentiable ``path``; ``params`` start from
    ``random_cloud(n, seed=7)``. Both clouds have extent 0.6 and scales in
    (0.04, 0.1)."""
    view = rmath.look_at_zforward(rmath.vec(0.0, 0.3, -2.5, device=dev),
                                  rmath.vec(0.0, 0.0, 0.0, device=dev))
    proj = rmath.perspective(rmath.radians(60.0, device=dev), w / h, 0.1,
                             30.0, device=dev)
    kw = dict(extent=0.6, scale_range=(0.04, 0.1), device=dev)
    with torch.no_grad():
        target = _renderer(path)(params_from_cloud(random_cloud(
            n, seed=42, **kw)), view, proj, w, h)
    return view, proj, target, params_from_cloud(random_cloud(n, seed=7,
                                                              **kw))


def first_frame(n: int, w: int, h: int, dev):
    """The plain run's first step taken apart at its composite: (lay, args,
    (planes, exec, ckpt, ck_off), dplanes, loss) — the init cloud's packed
    training layout, K4's arguments and outputs on it, and the cotangent
    of the MSE loss on K4's planes (K5's input). One definition of the
    frame on which ``chip_smoke.py`` checks and ``time_composite.py``
    times K4 and K5."""
    from .models.gs_training import cloud_from_params
    from .ops import gs
    view, proj, target, params = train_setup(n, w, h, dev)
    with torch.no_grad():
        c = cloud_from_params(params)
        lay = gs._diff_layout(c.means, c.scales, c.quats, c.opacities,
                              c.colors, view, proj, w, h)
    b = lay.binned
    args = (lay.records, b.row_begin, b.row_end, lay.ntx, lay.nty,
            lay.tile_w)
    planes, ex, ck, off = gs._composite_call_ckpt(*args)
    leaf = planes.clone().requires_grad_(True)
    img = gs.finalize_planes(leaf, b.visited, lay.nty, lay.ntx,
                             (0.0, 0.0, 0.0), lay.tile_w)[:h, :w]
    loss = torch.mean((img - target) ** 2)
    loss.backward()
    return lay, args, (planes, ex, ck, off), leaf.grad.contiguous(), \
        loss.item()


def _psnr(mse: float) -> float:
    return float(10 * np.log10(1.0 / max(mse, 1e-12)))


def train(args) -> dict:
    """The plain run: one camera, a fixed splat count. Returns the losses
    (the first is the warm-up step's), ms/step over the timed steps (all
    but the warm-up), the peak device memory and the (target, fitted)
    images. With ``args.dp`` the steps are data-parallel over the
    launcher's ranks (``make_train_step_dp``, the ``render_diff`` path)."""
    mesh = None
    if args.dp:
        from .parallel import make_device_mesh
        mesh = make_device_mesh(device=args.device)
    dev = torch.device(args.device)
    path = ("jnp" if mesh is not None
            else args.path or ("pallas" if args.splats > 4096 else "jnp"))
    view, proj, target, params = train_setup(args.splats, args.width,
                                             args.height, dev, path)
    opt = adam(params, args.lr)
    if mesh is not None:
        step = make_train_step_dp(opt, view, proj, mesh)
    elif path == "pallas":
        step = make_train_step_pallas(opt, view, proj)
    else:
        step = make_train_step(opt, view, proj)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses = [step(params, target)]          # warm-up
    clock = _Clock(dev)
    clock.start()
    for _ in range(1, args.steps):
        losses.append(step(params, target))
    ms = clock.stop_ms() / max(args.steps - 1, 1)
    with torch.no_grad():
        fitted = _renderer(path)(params, view, proj, args.width, args.height)
    return dict(path="dp" if mesh is not None else path,
                rank=0 if mesh is None else mesh.get_rank(),
                losses=[float(x) for x in losses], ms_per_step=ms,
                peak_bytes=(torch.cuda.max_memory_allocated(dev)
                            if dev.type == "cuda" else None),
                params=params, images=(target, fitted))


def train_adc(args) -> dict:
    """From-scratch multi-view reconstruction with the INRIA adaptive
    density control loop: clone/split high-gradient splats, prune
    transparent ones, reset opacities. Returns steps/s over the windows
    after the first, the live counts, every densify event's stats, the
    window losses, the PSNR on the training and held-out views, the first
    view's (target, fitted) images, and the parameters with their
    ``live`` mask. ``args.save_ply`` writes the live splats as a PLY."""
    dev = torch.device(args.device)
    w, h = args.width, args.height
    cap = args.capacity or 4 * args.splats
    proj = rmath.perspective(rmath.radians(60.0, device=dev), w / h, 0.1,
                             30.0, device=dev)
    path = args.path or ("pallas" if cap > 4096 else "jnp")
    render = _renderer(path)

    # hidden scene + a ring of training cameras + 2 held-out views at
    # half-offset angles (never trained on)
    tp = params_from_cloud(random_cloud(args.splats, seed=42, extent=0.5,
                                        scale_range=(0.03, 0.08),
                                        device=dev))
    views, targets = [], []
    with torch.no_grad():
        for k in range(args.views + 2):
            held = k >= args.views
            ang = 2.0 * np.pi * ((k + 0.5) if held else k) / args.views
            eye = rmath.vec(float(2.3 * np.cos(ang)), 0.4,
                            float(2.3 * np.sin(ang)), device=dev)
            v = rmath.look_at_zforward(eye, rmath.vec(0.0, 0.0, 0.0,
                                                      device=dev))
            views.append(v)
            targets.append(render(tp, v, proj, w, h))
    del tp
    held_views, held_targets = views[-2:], targets[-2:]
    views, targets = views[:-2], targets[:-2]

    n0 = max(args.splats // 16, 16)
    params = pad_params(params_from_cloud(random_cloud(
        n0, seed=7, extent=0.5, scale_range=(0.05, 0.1), device=dev)), cap)
    dstate = init_densify_state(cap, n0, device=dev)
    opt = adam(params, args.lr)
    window = make_train_window_adc(opt, w, h, use_pallas=path == "pallas",
                                   nsteps=args.densify_every)
    windows = {args.densify_every: window}
    targets_s, views_s = torch.stack(targets), torch.stack(views)
    gen = torch.Generator(device=dev).manual_seed(0)

    last_densify = args.steps - 2 * args.densify_every
    clock = _Clock(dev)
    timed_from, pos, events, losses = 0, 0, [], []
    while pos < args.steps:
        nwin = min(args.densify_every, args.steps - pos)
        if nwin not in windows:           # remainder window
            windows[nwin] = make_train_window_adc(
                opt, w, h, use_pallas=path == "pallas", nsteps=nwin)
        dstate, loss = windows[nwin](params, dstate, targets_s, views_s,
                                     proj, pos)
        losses.append(loss)
        if pos == 0:                      # the first window is warm-up
            clock.start()
            timed_from = nwin
        pos += nwin
        i = pos - 1                       # last executed global step
        if (i % args.densify_every == args.densify_every - 1
                and i < last_densify):
            # threshold: a live-quantile of the mean view-space gradient
            avg = (dstate.grad_accum / dstate.grad_count.clamp(min=1.0))
            lv = dstate.live
            thr = (float(torch.quantile(avg[lv], 0.7)) if bool(lv.any())
                   else 0.0)
            prev = dstate.live
            params, dstate, st = densify_and_prune(
                params, dstate, gen, grad_threshold=max(thr, 1e-12),
                scene_extent=1.0, prune_scale3d=0.5)
            reset_new_slots(opt, prev, dstate.live)
            events.append({"step": i, **{k: int(v) for k, v in st.items()}})
        # fire when the window crossed a 1500-step boundary
        if (pos // 1500) > ((pos - nwin) // 1500) and i < last_densify:
            reset_opacity(params, dstate)
    ms = clock.stop_ms()

    psnrs, held_psnrs = [], []
    with torch.no_grad():
        for vlist, tlist, out in ((views, targets, psnrs),
                                  (held_views, held_targets, held_psnrs)):
            for v, t in zip(vlist, tlist):
                img = render(params, v, proj, w, h)
                out.append(_psnr(float(torch.mean((img - t) ** 2))))
        fitted = render(params, views[0], proj, w, h)
    if args.save_ply:
        # the live splats, activated, as a 3DGS PLY (load_ply reads it)
        full = cloud_from_params(params)
        save_ply(args.save_ply, GaussianCloud(*(
            getattr(full, k).detach()[dstate.live]
            for k in ("means", "scales", "quats", "opacities", "colors"))))
    return dict(path=path, n0=n0, capacity=cap,
                n_live=int(dstate.live.sum()), events=events,
                losses=[float(x) for x in losses],
                steps_per_s=(args.steps - timed_from) / max(ms * 1e-3, 1e-9),
                psnr=psnrs, heldout_psnr=held_psnrs,
                images=(targets[0], fitted), params=params, live=dstate.live)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--splats", type=int, default=256)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=192)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--path", choices=("pallas", "jnp"), default=None,
                    help="differentiable renderer: the kernels (scales to "
                         "1M splats) or the plain render_diff. Default: "
                         "pallas above 4096 splats (--adc: capacity)")
    ap.add_argument("--adc", action="store_true",
                    help="scene reconstruction with adaptive density "
                         "control from a small random init")
    ap.add_argument("--capacity", type=int, default=0,
                    help="--adc slot capacity (default 4x --splats)")
    ap.add_argument("--views", type=int, default=6,
                    help="--adc camera count around the scene")
    ap.add_argument("--densify-every", type=int, default=100)
    ap.add_argument("--dp", action="store_true",
                    help="data-parallel over the launcher's ranks (torchrun; "
                         "NCCL on CUDA, gloo with --device cpu)")
    ap.add_argument("--save-ply", default=None,
                    help="--adc: write the reconstructed live splats as a "
                         "3DGS PLY")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rayeater_train"),
                    help="directory of target.png and fitted.png")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be >= 1")
    return args


def _save_images(out: str, images) -> str:
    """``target.png`` and ``fitted.png`` (sRGB) in ``out``; returns the
    fitted image's path."""
    os.makedirs(out, exist_ok=True)
    for name, img in zip(("target.png", "fitted.png"), images):
        save_png(os.path.join(out, name), to_srgb_u8(img))
    return os.path.join(out, "fitted.png")


def _where(device: str) -> str:
    """The card's name, or "cpu" (asked after training: under --dp the
    process group picks each rank's card first)."""
    if torch.device(device).type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.adc:
        r = train_adc(args)
        png = _save_images(args.out, r["images"])
        print(f"gs_trainer[adc/{r['path']}]: {args.steps} steps, {r['n0']} "
              f"-> {r['n_live']} live splats (cap {r['capacity']}), "
              f"{args.views} views {args.width}x{args.height} on "
              f"{_where(args.device)}, "
              f"{r['steps_per_s']:.2f} steps/s after the first window; "
              f"mean PSNR {np.mean(r['psnr']):.2f} dB (min "
              f"{min(r['psnr']):.2f}), held-out "
              f"{np.mean(r['heldout_psnr']):.2f} dB; densify events "
              f"{r['events']} (saved {png}"
              + (f", {args.save_ply}" if args.save_ply else "") + ")")
        return 0
    import torch.distributed as dist
    owned = args.dp and not dist.is_initialized()
    try:
        r = train(args)
    finally:
        if owned and dist.is_initialized():
            dist.destroy_process_group()
    if args.dp and r["rank"] != 0:
        return 0
    png = _save_images(args.out, r["images"])
    peak = ("" if r["peak_bytes"] is None
            else f", peak memory {r['peak_bytes'] / 2**30:.3f} GiB")
    print(f"gs_trainer[{r['path']}]: {args.steps} steps {args.splats} "
          f"splats {args.width}x{args.height} on {_where(args.device)}, "
          f"{r['ms_per_step']:.3f} ms/step after the warm-up step; loss "
          f"{r['losses'][0]:.6f} -> {r['losses'][-1]:.6f}{peak} (saved "
          f"{png})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
