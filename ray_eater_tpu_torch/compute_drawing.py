"""compute_drawing — the compute + graphics interop sample on the port.

A compute pass splats 1024 yellow 40 px squares, at positions drawn from
``np.random.RandomState(seed)``, into a 900x600 RGBA image with alpha 1,
once at start-up (kernel K10; main.zig:306-319,
``samples/compute_drawing.py``). Every frame then samples that image onto
a fullscreen quad (render_quad.zig:116-127) through ``render_mesh``
(kernel K6) with a clamp-to-edge linear sampler. By default the
``--frames`` frames at t = i/60 run as one animation through
``render_animation`` keeping the last frame (on a CUDA device: one
captured frame step, replayed a frame at a time); ``--host-loop`` renders
each frame eagerly and presents it through the ``Swapchain`` ring
(``--device-loop``, the JAX sample's flag, names the default path and is
refused together with ``--host-loop``). Frames are encoded without sRGB,
as the sample presents them; the last one goes to
``OUT/frame_last.png``.

    python -m ray_eater_tpu_torch.compute_drawing [--frames 60] [--out DIR]
        [--seed 0] [--device-loop | --host-loop] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import tempfile

import numpy as np
import torch

from .core import shaders
from .core.pipeline import ComputePipeline, GraphicsPipeline, RasterState
from .core.resources import (AddressMode, Framebuffer, Sampler, Texture,
                             create_framebuffer)
from .io.image import save_png
from .models.mesh import Mesh, fullscreen_quad
from .ops.raster import render_mesh
from .ops.splat import splat_particles
from .raster_scenes import device_loop, host_loop

WIDTH, HEIGHT = 900, 600
PARTICLE_COUNT = 1024           # main.zig:82
PIXELS_RAD = 20                 # main.zig:276
COLOR = (1.0, 1.0, 0.0)         # main.zig:273, yellow


def particle_positions(seed: int, width: int = WIDTH, height: int = HEIGHT,
                       n: int = PARTICLE_COUNT) -> np.ndarray:
    """(n, 2) float32 pixel positions, x then y drawn uniformly over the
    image from one ``RandomState(seed)`` stream (main.zig:279-300)."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.rand(n) * width, rng.rand(n) * height],
                    -1).astype(np.float32)


def compute_image(positions: torch.Tensor, width: int,
                  height: int) -> torch.Tensor:
    """The compute pass (testCompute, main.zig:306-319): the particles'
    squares over a black image with alpha 1, (height, width, 4) f32."""
    image = torch.zeros((height, width, 4), dtype=torch.float32,
                        device=positions.device)
    image[..., 3] = 1.0
    return splat_particles(image, positions, COLOR, PIXELS_RAD)


@dataclasses.dataclass
class Drawing:
    """The sample's state after the compute pass: the splatted image, the
    texture that wraps it and the quad pipeline that draws it."""
    width: int
    height: int
    image: torch.Tensor
    texture: Texture
    quad: Mesh
    pipeline: GraphicsPipeline

    def frame(self, t: float) -> Framebuffer:
        """Draw the frame at time ``t`` (the sample's uniform, unused by its
        shaders, frag.glsl:6-9)."""
        fb = create_framebuffer(self.width, self.height,
                                device=self.image.device)
        return render_mesh(self.pipeline, self.quad, {"time": t},
                           {"compute_image": self.texture}, fb)


def setup(device="cuda", seed: int = 0, width: int = WIDTH,
          height: int = HEIGHT, particles: int = PARTICLE_COUNT) -> Drawing:
    """Run the compute pass once and build the quad's draw."""
    pos = torch.from_numpy(particle_positions(seed, width, height,
                                              particles)).to(device)
    compute = ComputePipeline(
        fn=lambda p: compute_image(p, width, height), name="compute_slime")
    image = compute.fn(pos)
    tex = Texture(data=image,
                  sampler=Sampler(address_mode=AddressMode.CLAMP_TO_EDGE))
    pipe = GraphicsPipeline(vertex_fn=shaders.passthrough_vertex,
                            fragment_fn=shaders.quad_sample_fragment,
                            state=RasterState(depth_test=False,
                                              depth_write=False),
                            name="render_quad")
    return Drawing(width, height, image, tex,
                   fullscreen_quad(device=device), pipe)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "rayeater_compute_drawing"))
    ap.add_argument("--seed", type=int, default=0)
    loop = ap.add_mutually_exclusive_group()
    loop.add_argument("--device-loop", action="store_true",
                      help="render the frames as one animation through "
                           "render_animation (the default)")
    loop.add_argument("--host-loop", action="store_true",
                      help="render each frame eagerly and present it "
                           "through the swapchain ring instead of the "
                           "device loop")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The compute pass, then the frames by the path the arguments select.
    Returns :func:`raster_scenes.device_loop`'s or
    :func:`raster_scenes.host_loop`'s record (``path`` names it) with
    "frames" (the count), "drawing", "u8" (the last presented frame, a
    uint8 tensor) and "png"."""
    d = setup(args.device, args.seed)
    if args.host_loop:
        r = host_loop(d.frame, args.frames, args.device, WIDTH, HEIGHT,
                      srgb=False)
        r["u8"] = torch.from_numpy(r.pop("last"))
    else:
        r = device_loop(d.frame, args.frames, args.device, srgb=False,
                        keep="last")
        r["u8"] = r.pop("frames")
    os.makedirs(args.out, exist_ok=True)
    r["png"] = os.path.join(args.out, "frame_last.png")
    save_png(r["png"], r["u8"].cpu().numpy())
    r.update(frames=args.frames, drawing=d)
    return r


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    print(f"compute_drawing[{r['path']}]: {r['frames']} frames {WIDTH}x"
          f"{HEIGHT} at {r['ms_per_frame']:.3f} ms/frame on {args.device} "
          f"(saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
