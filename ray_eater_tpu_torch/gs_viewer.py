"""gs_viewer — 3D Gaussian Splatting scenes along an orbit camera on the port.

Renders a 3DGS PLY file (``--ply``; its spherical-harmonic colours are
evaluated at the eye every frame) or a synthetic N-splat cloud
(:func:`synthetic_cloud`) along the orbit camera of ``samples/gs_viewer.py``: radius 2.5, height
0.8, 30 degrees a second, 60 degree vertical field of view. Frames render
in LOD mode with temporal per-tile budgets (``--max-per-tile`` pairs a
tile on average, 0 = exact). By default the ``--frames`` frames at
t = i/60 (t = 0 with ``--static-camera``) run as one animation through
``render_animation``, the (ntiles, 2) budget carried from frame to frame
(on a CUDA device: one captured frame step, replayed a frame at a time);
``--host-loop`` renders one warm-up frame and then each frame eagerly and
presents it through the ``Swapchain`` ring. The last frame goes to
``OUT/frame_last.png``.

    python -m ray_eater_tpu_torch.gs_viewer [--ply FILE | --splats N]
        [--frames 30] [--width 1920 --height 1080] [--max-per-tile 192]
        [--tile-w 32] [--cap-factor 4] [--big-splat-cap 0]
        [--static-camera] [--host-loop] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from . import rmath
from .io.image import save_png
from .models.gaussians import GaussianCloud, load_ply, random_cloud
from .ops import gs
from .raster_scenes import device_loop, host_loop
from .utils import on_device

_F32 = torch.float32


def orbit_at(azimuth, height: float, radius: float, fov_deg: float = 60.0,
             aspect: float = 16 / 9, device="cuda"):
    """Orbit camera from explicit (azimuth, height, radius): the eye at
    (radius cos az, height, radius sin az) looking at the origin. Returns
    (view, proj, eye), f32 on ``device``."""
    az = (azimuth.to(_F32) if isinstance(azimuth, torch.Tensor)
          else on_device(azimuth, device))
    r = on_device(radius, az.device)
    eye = torch.stack([r * torch.cos(az), on_device(height, az.device),
                       r * torch.sin(az)])
    view = rmath.look_at_zforward(eye, rmath.vec(0.0, 0.0, 0.0,
                                                 device=az.device))
    proj = rmath.perspective(rmath.radians(fov_deg, device=az.device),
                             aspect, 0.05, 50.0)
    return view, proj, eye


def orbit_camera(t, radius: float = 2.5, height: float = 0.8,
                 fov_deg: float = 60.0, aspect: float = 16 / 9,
                 device="cuda"):
    """The flythrough: :func:`orbit_at` at azimuth 30 degrees a second
    times ``t``."""
    t = t.to(_F32) if isinstance(t, torch.Tensor) else on_device(t, device)
    ang = rmath.radians(30.0, device=t.device) * t
    return orbit_at(ang, height, radius, fov_deg=fov_deg, aspect=aspect,
                    device=t.device)


def synthetic_cloud(n: int, sh_bands: int = 0,
                    device="cuda") -> GaussianCloud:
    """The synthetic scene: ``random_cloud(n, seed=1, extent=1.0,
    scale_range=(0.004, 0.02))`` (the fog cloud) and, when ``sh_bands`` >
    0, that many SH bands ``RandomState(1).randn(n, sh_bands, 3) * 0.1``
    (degree 3 at 15 bands)."""
    cloud = random_cloud(n, seed=1, extent=1.0, scale_range=(0.004, 0.02),
                         device=device)
    if sh_bands:
        cloud.sh_rest = torch.from_numpy(np.random.RandomState(1).randn(
            n, sh_bands, 3).astype(np.float32) * 0.1).to(device)
    return cloud


@dataclasses.dataclass
class Viewer:
    """One scene's frames on the orbit camera: ``max_per_tile`` None
    renders exact, else LOD with temporal budgets. Built by
    :func:`viewer` from the command line's arguments."""
    cloud: GaussianCloud
    width: int
    height: int
    max_per_tile: int | None
    cap_factor: int | None
    big_splat_cap: int | None
    tile_w: int
    static_camera: bool

    @property
    def temporal(self) -> bool:
        return self.max_per_tile is not None

    def camera(self, t: float):
        """(view, proj, eye) at time ``t``."""
        return orbit_camera(0.0 if self.static_camera else t,
                            aspect=self.width / self.height,
                            device=self.cloud.means.device)

    def frame(self, t: float, budget=None):
        """(image, stats) at time ``t`` with SH colours at the eye: LOD
        under ``budget`` with the stats that feed :meth:`next_budget`, or
        exact with stats None."""
        view, proj, eye = self.camera(t)
        out = gs.render_gaussians(
            self.cloud, view, proj, self.width, self.height, cam_pos=eye,
            max_splats_per_tile=self.max_per_tile,
            pairs_cap_factor=self.cap_factor,
            big_splat_cap=self.big_splat_cap, return_stats=self.temporal,
            lod_budget=budget, tile_w=self.tile_w)
        return out if self.temporal else (out, None)

    def exact(self, t: float) -> torch.Tensor:
        """The exact frame at time ``t`` (exact mode, exact pair buffers):
        the reference of the LOD quality gate."""
        view, proj, eye = self.camera(t)
        return gs.render_gaussians(
            self.cloud, view, proj, self.width, self.height, cam_pos=eye,
            big_splat_cap=self.big_splat_cap, tile_w=self.tile_w)

    def initial_budget(self):
        """The first frame's (ntiles, 2) budget: ``max_per_tile`` a tile,
        no dry need (None in exact mode)."""
        if not self.temporal:
            return None
        return gs.initial_lod_budget(self.width, self.height, self.tile_w,
                                     self.max_per_tile,
                                     self.cloud.means.device)

    def step(self, t, budget):
        """The device loop's frame step: (image at ``t`` under
        ``budget``, the next budget)."""
        img, st = self.frame(t, budget)
        return img, self.next_budget(st, budget)

    def next_budget(self, stats, budget):
        """The next frame's budget from this frame's stats."""
        if not self.temporal:
            return budget
        ntx, nty = gs.num_tiles(self.width, self.height, self.tile_w)
        return gs.update_lod_budget(stats["tile_exec"], self.max_per_tile,
                                    ntx, nty, stats["tile_kept"],
                                    stats["tile_count"])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--splats", type=int, default=1_000_000)
    ap.add_argument("--ply", default=None)
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--static-camera", action="store_true")
    ap.add_argument("--max-per-tile", type=int, default=192,
                    help="per-tile LOD pool average (pairs a tile), "
                         "allocated by need each frame; 0 = exact")
    ap.add_argument("--tile-w", type=int, default=32)
    ap.add_argument("--cap-factor", type=int, default=4,
                    help="pair buffer in pairs a splat (0 = exact worst "
                         "case)")
    ap.add_argument("--big-splat-cap", type=int, default=0,
                    help="budget of splats above the 15 px level-1 radius "
                         "that render through the coarse fan (0 = clamp)")
    ap.add_argument("--host-loop", action="store_true",
                    help="render each frame eagerly and present it through "
                         "the swapchain ring instead of the device loop")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rayeater_gs"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def viewer(args, cloud: GaussianCloud | None = None) -> Viewer:
    """The :class:`Viewer` of ``args`` on ``cloud``, or on the scene the
    arguments name (``--ply``, else the synthetic cloud)."""
    if cloud is None:
        cloud = (load_ply(args.ply, device=args.device) if args.ply
                 else synthetic_cloud(args.splats, device=args.device))
    return Viewer(cloud, args.width, args.height,
                  max_per_tile=args.max_per_tile or None,
                  cap_factor=args.cap_factor or None,
                  big_splat_cap=args.big_splat_cap or None,
                  tile_w=args.tile_w, static_camera=args.static_camera)


def run(args, cloud: GaussianCloud | None = None) -> dict:
    """Render the flythrough by the path the arguments select; returns
    :func:`raster_scenes.device_loop`'s or :func:`raster_scenes.host_loop`'s
    record (``path`` names it) with "frames" (the count), "splats", "last"
    (the last u8 frame, a numpy array) and "png"; the host loop's also has
    "image", its last frame as rendered."""
    v = viewer(args, cloud)
    dev = v.cloud.means.device
    if args.host_loop:
        budget = v.initial_budget()

        def render(t):
            nonlocal budget
            img, st = v.frame(t, budget)
            budget = v.next_budget(st, budget)
            return img

        r = host_loop(render, args.frames, dev, v.width, v.height)
        r["image"] = r.pop("frame")
    elif v.temporal:
        r = device_loop(v.step, args.frames, dev,
                        carry=v.initial_budget())
        r["last"] = r.pop("frames")[-1].cpu().numpy()
    else:
        r = device_loop(lambda t: v.frame(t)[0], args.frames, dev)
        r["last"] = r.pop("frames")[-1].cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    r["png"] = os.path.join(args.out, "frame_last.png")
    save_png(r["png"], r["last"])
    r.update(frames=args.frames, splats=v.cloud.num_splats)
    return r


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    mode = "static" if args.static_camera else "flythrough"
    print(f"gs_viewer[{mode}, {r['path']}]: {r['frames']} frames {args.width}x"
          f"{args.height} {r['splats']} splats at {r['ms_per_frame']:.3f} "
          f"ms/frame on {args.device} (saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
