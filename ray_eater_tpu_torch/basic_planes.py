"""basic_planes — the end-to-end graphics sample on the port.

Two textured quads (8 vertices, 12 indices) with per-vertex colours and
uv, depth-tested, the model spinning about Y at 45 degrees a second, the
camera at (2, 2, 2) looking at the origin (basic_planes.zig:245-350;
``samples/basic_planes.py``). The texture is searched as the JAX sample
searches it (:func:`load_texture`), less the sample's path outside the
checkout: the image file named by the ``RAYEATER_TEXTURE`` environment
variable, then the samples' procedural checkerboard. By default the
``--frames`` frames at t = i/60 run as one animation through
``render_animation`` (on a CUDA device: one captured frame step, replayed
a frame at a time); ``--host-loop`` renders each frame eagerly and
presents it through the ``Swapchain`` ring (``--no-present``: only the
last). The last frame goes to ``OUT/frame_last.png``; ``--save-every N``
also writes every N-th frame i to ``OUT/frame_{i:04d}.png`` (the device
loop keeps all frames; the host loop saves every N-th presented frame),
after the timed frames.

    python -m ray_eater_tpu_torch.basic_planes [--frames 60]
        [--width 900 --height 600] [--host-loop [--no-present]]
        [--save-every N] [--out DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

from .core.resources import texture_from_array, texture_from_file
from .io.image import save_png
from .raster_scenes import EXTENTS, checker_rgba, device_loop, host_loop, scene
from .utils.logging import scoped

_log = scoped("application")


def texture_candidates() -> tuple[str, ...]:
    """The texture files searched, in order: ``$RAYEATER_TEXTURE``. Nothing
    outside the checkout is read unless the caller names it."""
    return (os.environ.get("RAYEATER_TEXTURE", ""),)


def load_texture(device="cuda"):
    """The first existing file of :func:`texture_candidates` as a texture
    (``texture_from_file``), else the procedural checkerboard."""
    for path in texture_candidates():
        if path and os.path.exists(path):
            _log.info("texture: %s", path)
            return texture_from_file(path, device=device)
    return texture_from_array(checker_rgba(), device=device)


def parse_args(argv=None):
    w, h = EXTENTS["basic_planes"]
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--width", type=int, default=w)
    ap.add_argument("--height", type=int, default=h)
    ap.add_argument("--host-loop", action="store_true",
                    help="render each frame eagerly and present it through "
                         "the swapchain ring instead of the device loop")
    ap.add_argument("--no-present", action="store_true",
                    help="with --host-loop: present only the last frame")
    ap.add_argument("--save-every", type=int, default=0,
                    help="save every Nth frame (0 = last frame only)")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rayeater_basic_planes"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.save_every < 0:
        ap.error("--save-every must be 0 or more")
    return args


def run(args, on_image=None) -> dict:
    """Render the animation by the path the arguments select; returns
    :func:`raster_scenes.device_loop`'s or :func:`raster_scenes.host_loop`'s
    record (``path`` names it; ``on_image`` gets each frame the host loop
    presents) with "frames" (the count), "last" (the last u8 frame, a
    numpy array), "png" and "saved" (the ``--save-every`` PNGs by frame
    index)."""
    sc = scene("basic_planes", args.device, args.width, args.height,
               texture=load_texture(args.device))
    every = args.save_every
    keep = {}     # frame index -> u8 frame, written after the timed frames
    if args.host_loop:
        count = 0

        def presented(img):
            # the ring presents the frames in order; with --no-present only
            # the last one is presented, and nothing is saved
            nonlocal count
            if every and not args.no_present and count % every == 0:
                keep[count] = img
            count += 1
            if on_image is not None:
                on_image(img)

        r = host_loop(sc.frame, args.frames, args.device, sc.width,
                      sc.height, present=not args.no_present,
                      on_image=presented)
    else:
        r = device_loop(sc.frame, args.frames, args.device)
        frames = r.pop("frames")
        if every:
            keep = {i: frames[i].cpu().numpy()
                    for i in range(0, args.frames, every)}
        r["last"] = frames[-1].cpu().numpy()
    os.makedirs(args.out, exist_ok=True)
    r["saved"] = {}
    for i, img in keep.items():
        r["saved"][i] = os.path.join(args.out, f"frame_{i:04d}.png")
        save_png(r["saved"][i], img)
    r["png"] = os.path.join(args.out, "frame_last.png")
    save_png(r["png"], r["last"])
    r["frames"] = args.frames
    return r


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    print(f"basic_planes[{r['path']}]: {r['frames']} frames {args.width}x"
          f"{args.height} at {r['ms_per_frame']:.3f} ms/frame on "
          f"{args.device} (saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
