"""Scenes of the raster path, each defined once: :func:`scene` builds the
frame that the entry points (``basic_planes``, ``multipass``), the
profiler and the chip smoke test render, from the procedural checkerboard
texture, the basic_planes camera and the meshes here (the two planes, the
multipass quads, the CPU tests' 288-triangle grid and the 10,082-triangle
measurement grid of ``tools/profile_raster.py``). :func:`device_loop`
(``render_animation``, the entry points' default) and :func:`host_loop`
(eager frames presented through a ``Swapchain``) run an entry point's
frames; :func:`draw_setup` builds one pass's draw setup, and :func:`cull_probe` a
hand-made setup of the fold's hard cases.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import rmath
from .core import shaders
from .core.animation import (encode_frame, frame_times, release,
                             render_animation)
from .core.context import Context, ContextConfig
from .core.pipeline import CompareOp, CullMode, GraphicsPipeline, RasterState
from .core.resources import Sampler, create_framebuffer, texture_from_array
from .core.swapchain import Swapchain
from .io.image import srgb_to_linear
from .models.mesh import Mesh, mesh, two_planes
from .ops import raster

# scene name -> default (width, height): basic_planes' swapchain extent
# (basic_planes.zig:126-128), the full-HD frames, the CPU-sized small grid
EXTENTS = {"basic_planes": (900, 600), "multipass": (1920, 1080),
           "grid10k": (1920, 1080), "grid288": (480, 270)}


def checker_rgba() -> np.ndarray:
    """The samples' procedural 256x256 checkerboard (32-texel squares),
    (H, W, 4) uint8 (samples/basic_planes.py:40-48)."""
    y, x = np.mgrid[0:256, 0:256]
    checker = ((x // 32 + y // 32) % 2).astype(np.float32)
    rgba = np.stack([checker, 0.5 * np.ones_like(checker), 1 - checker,
                     np.ones_like(checker)], -1)
    return (rgba * 255).astype(np.uint8)


def frame_uniforms(t: float, aspect: float, spin_deg: float = 45.0,
                   device="cuda") -> dict:
    """The per-frame UBO of basic_planes (basic_planes.zig:295-314): the
    model spins about Y at ``spin_deg`` degrees a second, the camera at
    (2, 2, 2) looks at the origin through a 45 degree perspective."""
    return {
        "model": rmath.rotate_y(rmath.identity(device),
                                rmath.radians(spin_deg, device=device) * t),
        "view": rmath.look_at(rmath.vec(2.0, 2.0, 2.0, device=device),
                              rmath.vec(0.0, 0.0, 0.0, device=device)),
        "projection": rmath.perspective(rmath.radians(45.0, device=device),
                                        aspect, 0.1, 30.0, device=device),
    }


def grid_mesh(g: int, seed: int, extent: float, zscale: float,
              device="cuda"):
    """A g x g quad grid (2 g^2 triangles) over [-extent, extent]^2 with
    random heights, per-vertex colours and planar uv, drawn from one numpy
    stream (``tests/test_raster.py:_grid_scene``: g 12, seed 9, extent
    0.9, zscale 0.1; ``tools/profile_raster.py:95-118``: g 71, seed 3,
    extent 1.1, zscale 0.2)."""
    rng = np.random.RandomState(seed)
    xs, ys = np.meshgrid(np.linspace(-extent, extent, g + 1),
                         np.linspace(-extent, extent, g + 1))
    pos = np.stack([xs, ys, zscale * rng.rand(g + 1, g + 1)],
                   -1).reshape(-1, 3)
    col = rng.rand((g + 1) * (g + 1), 3)
    uv = np.stack([xs, ys], -1).reshape(-1, 2) * 0.5 + 0.5
    quads = []
    for j in range(g):
        for i in range(g):
            a = j * (g + 1) + i
            quads += [[a, a + 1, a + g + 2], [a + g + 2, a + g + 1, a]]
    return mesh(pos, quads, device=device, color=col, uv=uv)


def mip_checker_u8() -> np.ndarray:
    """The measurement grid's texels: the checkerboard decoded from sRGB
    and requantized to u8 by truncation (``tools/profile_raster.py``,
    RAYEATER_PROF_MIP)."""
    f = checker_rgba().astype(np.float32) / 255.0
    f[..., :3] = srgb_to_linear(f[..., :3])
    return np.clip(f * 255, 0, 255).astype(np.uint8)


def mip_checker_texture(device="cuda"):
    """:func:`mip_checker_u8` uploaded linear with a trilinear
    4x-anisotropic sampler (mip pyramid and window table)."""
    return texture_from_array(mip_checker_u8(),
                              Sampler(mipmap=True, max_anisotropy=4.0),
                              srgb=False, device=device)


def grid_pipeline() -> GraphicsPipeline:
    """Double-sided textured-border pipeline of the grid scenes."""
    return GraphicsPipeline(vertex_fn=shaders.mvp_vertex,
                            fragment_fn=shaders.textured_border_fragment,
                            state=RasterState(cull_mode=CullMode.NONE),
                            name="grid")


def quad_grid_mesh(n_grid: int = 4, device="cuda") -> Mesh:
    """multipass's grid of textured quads at random heights, 2 n^2
    triangles in one buffer (``samples/multipass.py:35``)."""
    pos, col, uv, idx = [], [], [], []
    rng = np.random.RandomState(7)
    for gy in range(n_grid):
        for gx in range(n_grid):
            x0 = -1.0 + 2.0 * gx / n_grid
            z0 = -1.0 + 2.0 * gy / n_grid
            s = 2.0 / n_grid
            y = float(rng.rand() * 0.6)
            base = len(pos)
            pos += [[x0, y, z0], [x0 + s, y, z0],
                    [x0 + s, y, z0 + s], [x0, y, z0 + s]]
            c = rng.rand(3).tolist()
            col += [c, c, c, c]
            uv += [[1, 0], [0, 0], [0, 1], [1, 1]]
            idx += [[base, base + 1, base + 2], [base + 2, base + 3, base]]
    return mesh(pos, idx, device=device, color=col, uv=uv)


def basic_planes_pipeline() -> GraphicsPipeline:
    """basic_planes' pipeline: mvp vertex shader, textured-border fragment
    shader, the reference's default raster state (cull back, LESS)."""
    return GraphicsPipeline(vertex_fn=shaders.mvp_vertex,
                            fragment_fn=shaders.textured_border_fragment,
                            name="basic_planes")


def _zeros_fragment(varyings, resources):
    uv = varyings["uv"]
    return torch.zeros((*uv.shape[:-1], 4), dtype=torch.float32,
                       device=uv.device)


def multipass_pipelines():
    """multipass's (depth prepass, LESS_EQUAL lit pass) pipelines."""
    depth_only = GraphicsPipeline(vertex_fn=shaders.mvp_vertex,
                                  fragment_fn=_zeros_fragment,
                                  name="depth_prepass")
    lit = GraphicsPipeline(
        vertex_fn=shaders.mvp_vertex,
        fragment_fn=shaders.textured_border_fragment,
        state=RasterState(depth_compare=CompareOp.LESS_EQUAL), name="lit")
    return depth_only, lit


@dataclasses.dataclass
class RasterScene:
    """One scene's frame: ``mesh`` drawn by each (pipeline, resources) of
    ``passes`` in order into one framebuffer, under the basic_planes camera
    with the model spinning at ``spin_deg`` degrees a second."""
    name: str
    width: int
    height: int
    mesh: Mesh
    passes: list
    spin_deg: float
    device: torch.device

    def uniforms(self, t: float) -> dict:
        return frame_uniforms(t, self.width / self.height, self.spin_deg,
                              device=self.device)

    def frame(self, t: float):
        """Render the frame at time ``t``; returns the framebuffer."""
        uni = self.uniforms(t)
        fb = create_framebuffer(self.width, self.height, device=self.device)
        for pipe, res in self.passes:
            fb = raster.render_mesh(pipe, self.mesh, uni, res, fb)
        return fb


def scene(name: str, device="cuda", width: int | None = None,
          height: int | None = None, grid: int = 4,
          texture=None) -> RasterScene:
    """The raster scene ``name`` (one of :data:`EXTENTS`) at its default
    extent unless ``width``/``height`` are given:

    * ``basic_planes``: :func:`two_planes`, the checkerboard (or
      ``texture``, a ``Texture``) through the default sampler (packed quad
      gather), spin 45;
    * ``multipass``: :func:`quad_grid_mesh` (``grid``), a depth prepass,
      then the LESS_EQUAL lit pass with the checkerboard (or ``texture``),
      spin 30;
    * ``grid10k`` / ``grid288``: the double-sided 10,082- / 288-triangle
      :func:`grid_mesh` through :func:`mip_checker_texture`, spin 45.
    """
    dw, dh = EXTENTS[name]
    w, h, dev = width or dw, height or dh, torch.device(device)
    spin = 45.0
    if name in ("grid10k", "grid288"):
        m = (grid_mesh(71, 3, 1.1, 0.2, device=dev) if name == "grid10k"
             else grid_mesh(12, 9, 0.9, 0.1, device=dev))
        passes = [(grid_pipeline(), {"tex": mip_checker_texture(dev)})]
    else:
        tex = (texture_from_array(checker_rgba(), device=dev)
               if texture is None else texture)
        if name == "basic_planes":
            m = two_planes(device=dev)
            passes = [(basic_planes_pipeline(), {"tex": tex})]
        else:
            m, spin = quad_grid_mesh(grid, device=dev), 30.0
            depth_only, lit = multipass_pipelines()
            passes = [(depth_only, {}), (lit, {"tex": tex})]
    return RasterScene(name, w, h, m, passes, spin, dev)


def draw_setup(sc: RasterScene, t: float, pass_: int = -1):
    """The cleared framebuffer and the draw setup of pass ``pass_`` of
    ``sc``'s frame at time ``t``."""
    fb = create_framebuffer(sc.width, sc.height, device=sc.device)
    return fb, raster._vertex_stage(sc.passes[pass_][0], sc.mesh,
                                    sc.uniforms(t), fb)


#: :func:`cull_probe`'s frame (powers of two: the viewport maps its
#: corners exactly) and screen-space corners
PROBE_EXTENT = (1024, 64)
PROBE_SLIVER = [[704.5, 40.5], [767.25, 40.5], [735.875, 40.50002]]
PROBE_ON_CENTRE = [[300.5, 20.5], [420.25, 12.75], [350.0, 60.0]]
PROBE_BEHIND = [[560.0, 0.0], [1000.0, 8.0], [820.0, 63.0]]


def cull_probe(device="cuda") -> torch.Tensor:
    """The (16, 128) triangle setup, cull mode none, of three triangles on
    the :data:`PROBE_EXTENT` frame: column 0 a sliver (|area2| ~1.2e-3 at
    x ~700, z 0.3) whose float planes cover pixel centres outside its
    bbox, in warp footprints (32x8) that the bbox does not reach; column 1
    a triangle with a vertex exactly on the pixel centre (300.5, 20.5), z
    from 0.2 to 0.6; column 2 a large triangle behind both (z 0.7)."""
    w, h = PROBE_EXTENT
    xy = np.array(PROBE_SLIVER + PROBE_ON_CENTRE + PROBE_BEHIND, np.float32)
    clip = np.ones((9, 4), np.float32)
    clip[:, 0] = xy[:, 0] / np.float32(w / 2) - 1
    clip[:, 1] = xy[:, 1] / np.float32(h / 2) - 1
    clip[:, 2] = [0.3, 0.3, 0.3, 0.2, 0.6, 0.4, 0.7, 0.7, 0.7]
    setup, *_ = raster._triangle_setup(
        torch.from_numpy(clip).to(device),
        torch.arange(9, device=device).reshape(3, 3),
        RasterState(cull_mode=CullMode.NONE), w, h)
    return setup


def device_loop(frame_fn, frames: int, device, srgb: bool = True,
                keep: str = "all", carry=None) -> dict:
    """The entry points' default path: the animation of ``frames`` frames
    through ``render_animation``. On a CUDA device a first call of one
    frame captures the frame step and a second, timed one replays it
    ``frames`` times (CUDA events and the host clock); on the CPU one
    timed call runs the eager loop. Returns {"ms_per_frame",
    "host_ms_per_frame", "path", "frames" (the u8 frames, or the last one
    for ``keep="last"``), "capture_s", "launches_per_frame" (the kernel
    launches of one replayed frame)}. The captured graph is released at
    the end."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    kw = dict(srgb=srgb, keep=keep, carry=carry, device=dev)
    first: dict = {}
    if cuda:
        render_animation(frame_fn, 1, info=first, **kw)
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    t0 = time.perf_counter()
    info: dict = {}
    out = render_animation(frame_fn, frames, info=info, **kw)
    if cuda:
        e1.record()
        e1.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / frames
    release(frame_fn)
    return {"ms_per_frame": e0.elapsed_time(e1) / frames if cuda else host,
            "host_ms_per_frame": host,
            "path": ("device-loop (CUDA graph replay)" if cuda
                     else "device-loop (eager steps on the CPU)"),
            "frames": out, "capture_s": first.get("capture_s", 0.0),
            "launches_per_frame": first.get("launches_per_frame")}


def host_loop(frame_fn, frames: int, device, width: int, height: int,
              srgb: bool = True, present: bool = True,
              on_image=None) -> dict:
    """``--host-loop``: one warm-up frame, then ``frames`` eager frames of
    ``frame_fn(t)`` (a Framebuffer or an image) at the times of
    ``frame_times``, each encoded on its device and presented through a
    :class:`Swapchain` ring (with ``present`` False only the last frame
    is); ``on_image`` gets every presented host frame, oldest first.
    Returns {"ms_per_frame" (CUDA events on a CUDA device, else the host
    clock), "host_ms_per_frame", "path", "presented", "last" (the last
    presented u8 frame, a numpy array), "frame" (the last frame's
    result)}."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sc = Swapchain(Context(ContextConfig(platform=dev.type)), width, height,
                   srgb=srgb)
    out = frame_fn(0.0)
    if cuda:
        torch.cuda.synchronize(dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
    presented, last = 0, None

    def got(img):
        nonlocal presented, last
        if img is not None:
            presented, last = presented + 1, img
            if on_image is not None:
                on_image(img)

    t0 = time.perf_counter()
    for t in frame_times(frames).tolist():
        out = frame_fn(t)
        if present:
            got(sc.present_encoded(encode_frame(out, srgb)))
    if not present:
        got(sc.present_encoded(encode_frame(out, srgb)))
    for img in sc.drain():
        got(img)
    if cuda:
        e1.record()
        e1.synchronize()
    host = (time.perf_counter() - t0) * 1e3 / frames
    return {"ms_per_frame": e0.elapsed_time(e1) / frames if cuda else host,
            "host_ms_per_frame": host, "path": "host-loop",
            "presented": presented, "last": last, "frame": out}
