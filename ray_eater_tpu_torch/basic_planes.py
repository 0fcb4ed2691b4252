"""basic_planes — the end-to-end graphics sample on the port.

Two textured quads (8 vertices, 12 indices) with per-vertex colours and
uv, depth-tested, the model spinning about Y at 45 degrees a second, the
camera at (2, 2, 2) looking at the origin (basic_planes.zig:245-350;
``samples/basic_planes.py``), textured with the samples' procedural
checkerboard (``raster_scenes.scene("basic_planes")``). A host loop renders
``--frames`` frames at t = i/60, timed by CUDA events, and writes the last
one to ``OUT/frame_last.png``.

    python -m ray_eater_tpu_torch.basic_planes [--frames 60]
        [--width 900 --height 600] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from .io.image import save_png, to_srgb_u8
from .raster_scenes import EXTENTS, frame_loop, scene


def parse_args(argv=None):
    w, h = EXTENTS["basic_planes"]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=w)
    ap.add_argument("--height", type=int, default=h)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rayeater_basic_planes"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Render the animation; returns {"ms_per_frame", "frames", "fb" (the
    last framebuffer), "png"}."""
    sc = scene("basic_planes", args.device, args.width, args.height)
    ms, fb, _ = frame_loop(sc.frame, args.frames, args.device)
    os.makedirs(args.out, exist_ok=True)
    png = os.path.join(args.out, "frame_last.png")
    if fb is not None:
        save_png(png, to_srgb_u8(fb.color[:sc.height, :sc.width]))
    return {"ms_per_frame": ms, "frames": args.frames, "fb": fb, "png": png}


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    print(f"basic_planes: {r['frames']} frames {args.width}x{args.height} "
          f"at {r['ms_per_frame']:.3f} ms/frame on {args.device} "
          f"(saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
