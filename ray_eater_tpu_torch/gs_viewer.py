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

``--serve PORT`` runs the interactive loop instead (:func:`serve`): frames
go out as an MJPEG stream through the live viewer (``io.viewer``,
``http://HOST:PORT/``); a left drag orbits, the wheel zooms, Escape or
``/close`` ends it, and a resize of the browser window renders at the new
extent. Each frame replays one captured CUDA graph of the frame at the
camera's state (:class:`ServeFrames`). JPEG encoding needs PIL: without
it ``--serve`` exits at once with a message, before it binds the port.

    python -m ray_eater_tpu_torch.gs_viewer [--ply FILE | --splats N]
        [--frames 30] [--width 1920 --height 1080] [--max-per-tile 192]
        [--tile-w 32] [--cap-factor 4] [--big-splat-cap 0]
        [--static-camera] [--host-loop] [--serve PORT] [--out DIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import tempfile
import time

import numpy as np
import torch

from . import rmath
from .core import animation
from .io.image import save_png
from .models.gaussians import GaussianCloud, load_ply, random_cloud
from .ops import gs
from .raster_scenes import device_loop, host_loop
from .utils import on_device
from .utils.logging import scoped

_log = scoped("application")

_F32 = torch.float32


def _scalar(x, device) -> torch.Tensor:
    return x.to(_F32) if isinstance(x, torch.Tensor) else on_device(x, device)


def orbit_at(azimuth, height, radius, fov_deg: float = 60.0,
             aspect: float = 16 / 9, device="cuda"):
    """Orbit camera from explicit (azimuth, height, radius), numbers or 0-d
    tensors: the eye at (radius cos az, height, radius sin az) looking at
    the origin. Returns (view, proj, eye), f32 on ``device`` (the
    azimuth tensor's device when it is one)."""
    az = _scalar(azimuth, device)
    r = _scalar(radius, az.device)
    eye = torch.stack([r * torch.cos(az), _scalar(height, az.device),
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

    def orbit_step(self, t, carry):
        """The serve loop's frame step (``render_animation``'s with a
        carry; ``t`` is unused): ``carry`` = (azimuth, height, radius,
        budget), three 0-d f32 tensors and the (ntiles, 2) i32 budget
        (unused in exact mode). Renders at :func:`orbit_at` of the
        camera state with SH colours at the eye and returns (image, the
        carry with the next budget)."""
        az, hgt, rad, budget = carry
        view, proj, eye = orbit_at(az, hgt, rad,
                                   aspect=self.width / self.height)
        out = gs.render_gaussians(
            self.cloud, view, proj, self.width, self.height, cam_pos=eye,
            max_splats_per_tile=self.max_per_tile,
            pairs_cap_factor=self.cap_factor,
            big_splat_cap=self.big_splat_cap, return_stats=self.temporal,
            lod_budget=budget if self.temporal else None,
            tile_w=self.tile_w)
        if not self.temporal:
            return out, carry
        img, stats = out
        return img, (az, hgt, rad, self.next_budget(stats, budget))


class ServeFrames:
    """The ``--serve`` loop's frames at one extent: :meth:`Viewer.orbit_step`
    run by ``render_animation`` one frame a call, so on a CUDA device each
    served frame replays one captured graph whose inputs are the static
    camera scalars and budget of its carry; the budget is carried from
    frame to frame. :meth:`release` drops the graph (a resize builds new
    frames and releases the old)."""

    def __init__(self, cloud: GaussianCloud, args, width: int, height: int):
        self.viewer = dataclasses.replace(viewer(args, cloud), width=width,
                                          height=height)
        self.device = cloud.means.device
        ntx, nty = gs.num_tiles(width, height, args.tile_w)
        self.budget = (self.viewer.initial_budget() if self.viewer.temporal
                       else torch.zeros((ntx * nty, 2), dtype=torch.int32,
                                        device=self.device))
        # one bound method object: render_animation caches graphs by it
        self.step = self.viewer.orbit_step
        self.info: dict = {}
        self.capture_s = 0.0

    def carry(self, az: float, hgt: float, rad: float):
        """The step's carry at this camera state and the current budget."""
        return (*(on_device(float(x), self.device) for x in (az, hgt, rad)),
                self.budget)

    def __call__(self, az: float, hgt: float, rad: float) -> torch.Tensor:
        """The (H, W, 3) u8 frame at the camera state; advances the
        budget. ``info`` holds ``render_animation``'s record of the call
        (``path``, ``captured``, ``launches_per_frame``); ``capture_s``
        the seconds of this extent's capture (0 on the CPU)."""
        self.info = {}
        img = animation.render_animation(
            self.step, 1, keep="last", carry=self.carry(az, hgt, rad),
            device=self.device, info=self.info)
        self.budget = self.info["carry"][3]
        self.capture_s += self.info["capture_s"]
        return img

    def release(self) -> None:
        animation.release(self.step)


def _serve_extent(w: int, h: int) -> tuple[int, int]:
    """A resize request bucketed to 64 px, within 256..3840 x 256..2160."""
    return max(256, min(3840, w // 64 * 64)), max(256, min(2160,
                                                           h // 64 * 64))


def serve(args, cloud: GaussianCloud | None = None, host: str = "0.0.0.0",
          on_ready=None) -> int:
    """The interactive loop of ``--serve`` (``samples/gs_viewer.py``
    ``_serve_live``): each iteration reads the viewer's input, steps the
    camera (30 degrees a second unless ``--static-camera``; left drag
    orbits azimuth and height, the wheel zooms the radius, w/a/s/d
    nudge), renders through :class:`ServeFrames` and presents the frame
    as a JPEG. A resize request renders at the bucketed extent from the
    next frame on. Escape or ``/close`` ends it. ``on_ready`` gets the
    :class:`io.viewer.LiveViewer` once it listens. Returns the frames
    served."""
    from .io.viewer import LiveViewer
    if cloud is None:
        cloud = (load_ply(args.ply, device=args.device) if args.ply
                 else synthetic_cloud(args.splats, device=args.device))
    w, h = args.width, args.height
    frames = ServeFrames(cloud, args, w, h)
    live = LiveViewer(port=args.serve, host=host)
    _log.info("live viewer: http://%s:%d/ (drag orbits, wheel zooms, "
              "Escape quits)", host, live.port)
    if on_ready is not None:
        on_ready(live)
    az, hgt, rad = 0.0, 0.8, 2.5
    lx = ly = None
    n, t0 = 0, time.perf_counter()
    try:
        while not live.should_close:
            keys = live.poll_events()
            ms = live.poll_mouse()
            if not args.static_camera:
                az += math.radians(30.0) / 60.0
            if 0 in ms.buttons:                     # left-drag orbit
                if lx is not None:
                    az += (ms.x - lx) * 4.0
                    hgt = min(max(hgt - (ms.y - ly) * 4.0, -3.0), 3.0)
                lx, ly = ms.x, ms.y
            else:
                lx = ly = None
            if ms.wheel:                            # zoom
                rad = min(max(rad * (1.0 + 0.001 * ms.wheel), 0.3), 20.0)
            az += 0.05 * (keys.get("a", 0) - keys.get("d", 0))
            hgt += 0.05 * (keys.get("w", 0) - keys.get("s", 0))
            rq = live.poll_resize()
            if rq and _serve_extent(*rq) != (w, h):
                w, h = _serve_extent(*rq)
                _log.info("resize -> %dx%d", w, h)
                frames.release()
                frames = ServeFrames(cloud, args, w, h)
            live.present(frames(az, hgt, rad).cpu().numpy())
            n += 1
    except KeyboardInterrupt:
        pass
    finally:
        live.stop()
        frames.release()
    el = time.perf_counter() - t0
    print(f"gs_viewer[serve]: {n} frames in {el:.1f}s -> "
          f"{n / max(el, 1e-9):.2f} FPS served")
    return n


def has_pil() -> bool:
    """Whether PIL imports (``--serve`` encodes its frames as JPEG)."""
    try:
        import PIL.Image  # noqa: F401
    except ImportError:
        return False
    return True


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
    ap.add_argument("--serve", type=int, default=None, metavar="PORT",
                    help="serve frames live over HTTP on PORT (0: any free "
                         "port) instead of rendering --frames frames")
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
    if args.serve is not None:
        if not has_pil():
            print("gs_viewer --serve: PIL (pillow) is not installed, and "
                  "the live viewer needs it to encode frames as JPEG",
                  file=sys.stderr)
            return 2
        serve(args)
        return 0
    r = run(args)
    mode = "static" if args.static_camera else "flythrough"
    print(f"gs_viewer[{mode}, {r['path']}]: {r['frames']} frames {args.width}x"
          f"{args.height} {r['splats']} splats at {r['ms_per_frame']:.3f} "
          f"ms/frame on {args.device} (saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
