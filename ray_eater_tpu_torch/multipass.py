"""multipass — a depth prepass, then a textured LESS_EQUAL pass, on the
port (``samples/multipass.py``, BASELINE.json config 3).

A grid of textured quads at random heights (2 n^2 triangles) is drawn
twice into one framebuffer per frame: a depth-only prepass, then the lit
textured pass with depth compare LESS_EQUAL, as three plain calls (setup,
prepass, lit; the render graph is not ported;
``raster_scenes.scene("multipass")``). A host loop renders ``--frames``
frames at t = i/60, timed by CUDA events, and writes the last one to
``OUT/frame_last.png``.

    python -m ray_eater_tpu_torch.multipass [--frames 60]
        [--width 1920 --height 1080] [--grid 4] [--out DIR]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from .io.image import save_png, to_srgb_u8
from .raster_scenes import EXTENTS, frame_loop, scene


def parse_args(argv=None):
    w, h = EXTENTS["multipass"]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=w)
    ap.add_argument("--height", type=int, default=h)
    ap.add_argument("--grid", type=int, default=4)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rayeater_multipass"))
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> dict:
    """Render the animation; returns {"ms_per_frame", "frames",
    "triangles", "fb" (the last framebuffer), "png"}."""
    sc = scene("multipass", args.device, args.width, args.height,
               grid=args.grid)
    ms, fb, _ = frame_loop(sc.frame, args.frames, args.device)
    os.makedirs(args.out, exist_ok=True)
    png = os.path.join(args.out, "frame_last.png")
    if fb is not None:
        save_png(png, to_srgb_u8(fb.color[:sc.height, :sc.width]))
    return {"ms_per_frame": ms, "frames": args.frames,
            "triangles": sc.mesh.num_triangles, "fb": fb, "png": png}


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    print(f"multipass: {r['frames']} frames {args.width}x{args.height} "
          f"({r['triangles']} tris x2 passes) at {r['ms_per_frame']:.3f} "
          f"ms/frame on {args.device} (saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
