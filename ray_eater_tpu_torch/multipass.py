"""multipass — a depth prepass, then a textured LESS_EQUAL pass, through
the render graph on the port (``samples/multipass.py``, BASELINE.json
config 3).

A grid of textured quads at random heights (2 n^2 triangles), or a
Wavefront OBJ mesh (``--obj``), is drawn twice into one framebuffer per
frame: a depth-only prepass, then the lit textured pass with depth
compare LESS_EQUAL (``raster_scenes.scene("multipass")``). The frame is a
``RenderGraph`` of three passes, ``setup`` (the uniforms at the external
time ``t`` and a cleared framebuffer), ``depth_prepass`` and ``lit``. By
default the ``--frames`` frames at t = i/60 run as one animation through
``render_animation`` (on a CUDA device: one captured frame step, replayed
a frame at a time); ``--host-loop`` renders each frame eagerly and
presents it through the ``Swapchain`` ring (``--no-present``: only the
last). The last frame goes to ``OUT/frame_last.png``.

    python -m ray_eater_tpu_torch.multipass [--frames 60]
        [--width 1920 --height 1080] [--grid 4 | --obj FILE]
        [--host-loop [--no-present]] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

from .core.resources import create_framebuffer
from .graph.render_graph import FrameProgram, RenderGraph
from .io.image import save_png
from .io.obj import load_obj
from .ops.raster import render_mesh
from .raster_scenes import (EXTENTS, RasterScene, device_loop, host_loop,
                            scene)


def parse_args(argv=None):
    w, h = EXTENTS["multipass"]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=w)
    ap.add_argument("--height", type=int, default=h)
    ap.add_argument("--grid", type=int, default=4)
    ap.add_argument("--obj", default=None,
                    help="render a Wavefront OBJ mesh instead of the grid")
    ap.add_argument("--host-loop", action="store_true",
                    help="render each frame eagerly and present it through "
                         "the swapchain ring instead of the device loop")
    ap.add_argument("--no-present", action="store_true",
                    help="with --host-loop: present only the last frame")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rayeater_multipass"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def frame_graph(sc: RasterScene) -> FrameProgram:
    """The baked frame of the multipass scene ``sc``: passes ``setup``
    (reads the external ``t``; writes ``fb`` and ``uniforms``),
    ``depth_prepass`` and ``lit`` (each reads and writes ``fb``); output
    ``fb``."""
    (depth_only, _), (lit, lit_res) = sc.passes

    def setup(i):
        return {"fb": create_framebuffer(sc.width, sc.height,
                                         device=sc.device),
                "uniforms": sc.uniforms(i["t"])}

    def prepass(i):
        return {"fb": render_mesh(depth_only, sc.mesh, i["uniforms"], {},
                                  i["fb"])}

    def litpass(i):
        return {"fb": render_mesh(lit, sc.mesh, i["uniforms"], lit_res,
                                  i["fb"])}

    return (RenderGraph("prepass_lit")
            .external("t")
            .add_pass("setup", setup, reads=("t",),
                      writes=("fb", "uniforms"))
            .add_pass("depth_prepass", prepass, reads=("fb", "uniforms"),
                      writes=("fb",))
            .add_pass("lit", litpass, reads=("fb", "uniforms"),
                      writes=("fb",))
            .output("fb")
            .bake())


def multipass_scene(args) -> RasterScene:
    """The scene of ``args``: the quad grid, or the ``--obj`` mesh."""
    sc = scene("multipass", args.device, args.width, args.height,
               grid=args.grid)
    if args.obj:
        sc = dataclasses.replace(sc, mesh=load_obj(args.obj,
                                                   device=args.device))
    return sc


def run(args, on_image=None) -> dict:
    """Render the animation by the path the arguments select; returns
    :func:`raster_scenes.device_loop`'s or :func:`raster_scenes.host_loop`'s
    record (``path`` names it) with "frames" (the count), "triangles",
    "passes" (the baked schedule), "last" (the last u8 frame, a numpy
    array) and "png"."""
    sc = multipass_scene(args)
    frame = frame_graph(sc)

    def frame_t(t):
        return frame(t=t)["fb"]

    if args.host_loop:
        r = host_loop(frame_t, args.frames, args.device, sc.width,
                      sc.height, present=not args.no_present,
                      on_image=on_image)
    else:
        r = device_loop(frame_t, args.frames, args.device)
        r["last"] = r.pop("frames")[-1].cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    r["png"] = os.path.join(args.out, "frame_last.png")
    save_png(r["png"], r["last"])
    r.update(frames=args.frames, triangles=sc.mesh.num_triangles,
             passes=frame.pass_names)
    return r


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    print(f"multipass[{r['path']}]: {r['frames']} frames {args.width}x"
          f"{args.height} ({r['triangles']} tris x2 passes, "
          f"{' -> '.join(r['passes'])}) at {r['ms_per_frame']:.3f} "
          f"ms/frame on {args.device} (saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
