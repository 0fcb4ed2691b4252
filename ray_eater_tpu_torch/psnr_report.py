"""psnr_report — the port's frames against independent float64 oracles
(counterpart of ``tools/psnr_report.py``, at its sizes and inputs).

Prints one line per configuration, ``PSNR <name>: <x> dB``, then one JSON
line ``{"psnr": {<name>: <x>, ...}}``:

* ``raster_two_planes_vs_float64_oracle``: the 25-degree-rotated
  ``two_planes`` at 256x128 through ``render_mesh`` (kernel K6 on a CUDA
  device) against the float64 rasterizer :func:`rasterize_reference`;
* ``gs_composite_vs_float64_oracle``: ``random_cloud(200, seed=5,
  extent=0.8, scale_range=(0.02, 0.08))`` at 256x128 through
  ``render_gaussians`` (K1, K2) against the float64 compositor
  :func:`reference_composite`;
* ``gs_lod512_vs_exact``: the same frame at ``max_splats_per_tile=512``
  against the exact frame.

The oracles are numpy copies of the repository's test oracles, kept here
so that the report runs where neither JAX nor the tests' modules can be
imported. The report computes and gates nothing (99.0 dB stands for a
mean squared error under 1e-12).

    python -m ray_eater_tpu_torch.psnr_report [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from . import rmath
from .core import shaders
from .core.pipeline import GraphicsPipeline
from .core.resources import create_framebuffer
from .models.gaussians import random_cloud
from .models.mesh import two_planes
from .ops import gs
from .ops.gs import project_gaussians, render_gaussians
from .ops.raster import render_mesh

W, H = 256, 128


# ---- float64 oracles ---------------------------------------------------------

def viewport(clip, width, height):
    """Clip coordinates to (pixel xy, NDC z, 1/w); a copy of
    ``tests/golden_raster.py:14``."""
    w = clip[..., 3:4]
    ndc = clip[..., :3] / w
    x = (ndc[..., 0] + 1) * 0.5 * width
    y = (ndc[..., 1] + 1) * 0.5 * height
    return np.stack([x, y], -1), ndc[..., 2], 1.0 / w[..., 0]


def rasterize_reference(clip, indices, width, height,
                        cull="back", front="cw", depth_test=True,
                        init_depth=None):
    """Float64 per-pixel rasterizer (pixel centres at +0.5, y-down
    viewport, depth in [0, 1], CW front, back cull, depth LESS); a copy of
    ``tests/golden_raster.py:54``. Returns (depth (H,W), tri (H,W) int,
    bary (H,W,3) float64, inv_w (T,3))."""
    clip = np.asarray(clip, np.float64)
    tri = clip[indices]                    # (T,3,4)
    xy, z, inv_w = viewport(tri, width, height)
    T = tri.shape[0]

    ys, xs = np.mgrid[0:height, 0:width]
    px = xs + 0.5
    py = ys + 0.5

    depth = (np.full((height, width), np.inf) if init_depth is None
             else np.asarray(init_depth, np.float64).copy())
    if not depth_test:
        depth = np.full((height, width), np.inf)
    tri_id = np.full((height, width), -1, np.int64)
    bary = np.zeros((height, width, 3))

    for t in range(T):
        (x0, y0), (x1, y1), (x2, y2) = xy[t]
        area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        sign = 1.0 if front == "cw" else -1.0
        if cull == "back" and not (area2 * sign > 0):
            continue
        if cull == "front" and not (area2 * sign < 0):
            continue
        if abs(area2) < 1e-12 or np.any(tri[t, :, 3] <= 1e-6):
            continue
        l0 = ((x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)) / area2
        l1 = ((x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)) / area2
        l2 = 1.0 - l0 - l1
        zp = l0 * z[t, 0] + l1 * z[t, 1] + l2 * z[t, 2]
        cov = (l0 >= 0) & (l1 >= 0) & (l2 >= 0) & (zp >= 0) & (zp <= 1)
        if depth_test:
            win = cov & (zp < depth)
        else:
            win = cov  # draw order: later triangles overwrite
        depth = np.where(win, zp, depth)
        tri_id = np.where(win, t, tri_id)
        for i, l in enumerate((l0, l1, l2)):
            bary[..., i] = np.where(win, l, bary[..., i])
    return depth, tri_id, bary, inv_w


def interpolate(values, indices, tri_id, bary, inv_w):
    """Perspective-correct interpolation of per-vertex values (N,K); a
    copy of ``tests/golden_raster.py:100``."""
    tv = np.asarray(values, np.float64)[indices]    # (T,3,K)
    t = np.maximum(tri_id, 0)
    iw = inv_w[t]                                   # (H,W,3)
    lp = bary * iw
    lp /= np.maximum(lp.sum(-1, keepdims=True), 1e-300)
    return np.einsum("hwi,hwik->hwk", lp, tv[t])


def reference_composite(ps, width, height, bg,
                        two_level=False, return_sensitive=False,
                        tile_w=None):
    """Float64 per-pixel compositor with the kernel's tile-footprint rule:
    a splat contributes exactly to the pixels of the tiles it bins into;
    a copy of ``tests/test_gs.py:63`` with the constants of this package's
    ``ops/gs.py``. ``ps`` holds a ``ProjectedSplats``'s fields as arrays.
    ``two_level=True`` gives splats over the level-1 radius limit the
    coarse fan's span cap. ``return_sensitive=True`` also returns the
    (H, W) bool mask of pixels where some splat's alpha lies within
    f32 rounding of the ``_ALPHA_MIN`` cutoff."""
    tw = gs.TILE_W if tile_w is None else tile_w
    order = np.argsort(np.asarray(ps.depth), kind="stable")
    ys, xs = np.mgrid[0:height, 0:width]
    px, py = xs + 0.5, ys + 0.5
    img = np.zeros((height, width, 3))
    T = np.ones((height, width))
    sensitive = np.zeros((height, width), bool)
    ntx = -(-width // tw)
    nty = -(-height // gs.TILE_H)
    # per-axis level-1 span limits (the kernel's anisotropic routing)
    r1x = (gs.KX - 1) * tw // 2 - 1
    r1y = (gs.KY - 1) * gs.TILE_H // 2 - 1
    for i in order:
        if not np.isfinite(float(ps.depth[i])):
            continue
        mx, my = (float(ps.mean2d[i, 0]), float(ps.mean2d[i, 1]))
        r = float(ps.radius[i])
        # bbox spans use the per-axis extents; the circle corner cull
        # uses the circumscribed radius
        rx = float(ps.ext[i, 0]) if ps.ext is not None else r
        ry = float(ps.ext[i, 1]) if ps.ext is not None else r
        tx0 = int(np.clip(np.floor((mx - rx) / tw), 0, ntx - 1))
        tx1 = int(np.clip(np.floor((mx + rx) / tw), 0, ntx - 1))
        ty0 = int(np.clip(np.floor((my - ry) / gs.TILE_H), 0, nty - 1))
        ty1 = int(np.clip(np.floor((my + ry) / gs.TILE_H), 0, nty - 1))
        kx, ky = ((gs._kx2(tw), gs.KY2)
                  if two_level and (rx > r1x or ry > r1y)
                  else (gs.KX, gs.KY))
        tx1 = min(tx1, tx0 + kx - 1)      # span cap, like the kernel
        ty1 = min(ty1, ty0 + ky - 1)
        # footprint = union of span tiles whose rect the circle touches
        # (the kernel's circle-vs-tile emission cull)
        box = np.zeros_like(px, bool)
        for tty in range(ty0, ty1 + 1):
            for ttx in range(tx0, tx1 + 1):
                rx0, ry0 = ttx * tw, tty * gs.TILE_H
                ddx = max(rx0 - mx, mx - (rx0 + tw), 0.0)
                ddy = max(ry0 - my, my - (ry0 + gs.TILE_H), 0.0)
                if ddx * ddx + ddy * ddy <= r * r:
                    box |= ((px >= rx0) & (px < rx0 + tw)
                            & (py >= ry0) & (py < ry0 + gs.TILE_H))
        dx, dy = px - mx, py - my
        ca, cb, cc = np.asarray(ps.conic[i], np.float64)
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = float(ps.opacity[i]) * np.exp(power)
        alpha = np.minimum(alpha, gs._ALPHA_MAX)
        sensitive |= box & (np.abs(alpha - gs._ALPHA_MIN)
                            < 1e-5 * gs._ALPHA_MIN)
        alpha = np.where(alpha < gs._ALPHA_MIN, 0.0, alpha)
        alpha = np.where(box, alpha, 0.0)
        img += (T * alpha)[..., None] * np.asarray(ps.color[i], np.float64)
        T *= 1.0 - alpha
    out = img + T[..., None] * np.asarray(bg, np.float64)
    return (out, sensitive) if return_sensitive else out


# ---- the report ----------------------------------------------------------------

def psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64)
                         - np.asarray(b, np.float64)) ** 2))
    return 99.0 if mse < 1e-12 else float(10 * np.log10(1.0 / mse))


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def raster_two_planes(dev) -> float:
    """``render_mesh`` of the rotated two_planes vs the float64 raster."""
    m = two_planes(device=dev)
    uni = {
        "model": rmath.rotate_y(rmath.identity(device=dev),
                                rmath.radians(25.0, device=dev)),
        "view": rmath.look_at(rmath.vec(2., 2., 2., device=dev),
                              rmath.vec(0., 0., 0., device=dev)),
        "projection": rmath.perspective(rmath.radians(45.0, device=dev),
                                        W / H, 0.1, 30.0, device=dev),
    }

    def frag(v, r):
        c = v["color"]
        return torch.cat([c, torch.ones_like(c[..., :1])], -1)

    pipe = GraphicsPipeline(vertex_fn=shaders.mvp_vertex, fragment_fn=frag)
    out = render_mesh(pipe, m, uni, {}, create_framebuffer(W, H, device=dev))
    got = _numpy(out.color)[:H, :W, :3]

    mvp = _numpy(rmath.mul(rmath.mul(uni["projection"], uni["view"]),
                           uni["model"])).astype(np.float64)
    pos = _numpy(m.positions).astype(np.float64)
    idx = _numpy(m.indices)
    clip = np.concatenate([pos, np.ones((len(pos), 1))], -1) @ mvp.T
    depth, tri, bary, inv_w = rasterize_reference(clip, idx, W, H)
    col = interpolate(_numpy(m.attributes["color"]), idx, tri, bary, inv_w)
    want = np.where((tri >= 0)[..., None], col, 0.0)
    return psnr(got, want)


def gs_frames(dev) -> tuple[float, float]:
    """(exact frame vs the float64 compositor, LOD 512 frame vs exact)."""
    cloud = random_cloud(200, seed=5, extent=0.8, scale_range=(0.02, 0.08),
                         device=dev)
    view = rmath.look_at_zforward(rmath.vec(0.0, 0.0, -3.0, device=dev),
                                  rmath.vec(0.0, 0.0, 0.0, device=dev))
    proj = rmath.perspective(rmath.radians(60.0, device=dev), W / H, 0.1,
                             30.0, device=dev)
    img = _numpy(render_gaussians(cloud, view, proj, W, H))
    ps = project_gaussians(cloud.means, cloud.scales, cloud.quats,
                           cloud.opacities, cloud.colors, view, proj, W, H)
    ref = reference_composite(gs.ProjectedSplats(*map(_numpy, ps)), W, H,
                              (0.0, 0.0, 0.0))
    lod = _numpy(render_gaussians(cloud, view, proj, W, H,
                                  max_splats_per_tile=512))
    return psnr(img, ref), psnr(lod, img)


def report(device="cuda") -> dict:
    """The three PSNR figures by name, in dB."""
    dev = torch.device(device)
    out = {"raster_two_planes_vs_float64_oracle": raster_two_planes(dev)}
    (out["gs_composite_vs_float64_oracle"],
     out["gs_lod512_vs_exact"]) = gs_frames(dev)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    figures = report(args.device)
    for name, x in figures.items():
        print(f"PSNR {name}: {x:.1f} dB")
    print(json.dumps({"psnr": figures}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
