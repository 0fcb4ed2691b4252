"""compute_drawing — the compute + graphics interop sample on the port.

A compute pass splats 1024 yellow 40 px squares, at positions drawn from
``np.random.RandomState(seed)``, into a 900x600 RGBA image with alpha 1,
once at start-up (kernel K10; main.zig:306-319,
``samples/compute_drawing.py``). Every frame then samples that image onto
a fullscreen quad (render_quad.zig:116-127) through ``render_mesh``
(kernel K6) with a clamp-to-edge linear sampler. A host loop renders
``--frames`` frames at t = i/60, timed by CUDA events, and writes the last
one, encoded without sRGB as the sample presents it, to
``OUT/frame_last.png``.

    python -m ray_eater_tpu_torch.compute_drawing [--frames 60] [--out DIR]
        [--seed 0] [--device cuda|cpu]
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
from .core.swapchain import encode_present
from .io.image import save_png
from .models.mesh import Mesh, fullscreen_quad
from .ops.raster import render_mesh
from .ops.splat import splat_particles
from .raster_scenes import frame_loop

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
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> dict:
    """The compute pass, then the timed frames. Returns {"ms_per_frame"
    (CUDA events on a CUDA device), "host_ms_per_frame", "frames",
    "drawing", "fb" (the last framebuffer), "u8" (its presented frame,
    a uint8 tensor), "png"}."""
    d = setup(args.device, args.seed)
    ms, fb, host_ms = frame_loop(d.frame, args.frames, args.device)
    os.makedirs(args.out, exist_ok=True)
    png = os.path.join(args.out, "frame_last.png")
    u8 = None
    if fb is not None:
        u8 = encode_present(fb.color, WIDTH, HEIGHT, srgb=False)
        save_png(png, u8.cpu().numpy())
    return {"ms_per_frame": ms, "host_ms_per_frame": host_ms,
            "frames": args.frames, "drawing": d, "fb": fb, "u8": u8,
            "png": png}


def main(argv=None) -> int:
    args = parse_args(argv)
    r = run(args)
    print(f"compute_drawing: {r['frames']} frames {WIDTH}x{HEIGHT} at "
          f"{r['ms_per_frame']:.3f} ms/frame on {args.device} "
          f"(saved {r['png']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
