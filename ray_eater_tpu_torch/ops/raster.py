"""Triangle rasterization (counterpart of ``ray_eater_tpu/ops/raster.py``;
the reference's vertex fetch, vkCmdDrawIndexed, fixed-function raster and
fragment dispatch, base.zig:608-642).

One draw runs:

1. **Vertex stage** — the pipeline's ``vertex_fn`` on the whole vertex
   buffer, near-plane clipping (1 triangle to at most 2, :func:`_clip_near`)
   and the viewport transform, baked into per-triangle screen-space plane
   equations: two barycentric planes (λ0, λ1), a depth plane, the
   cull/degenerate mask and the screen bbox (:func:`_triangle_setup`, a
   ``(16, Tpad)`` setup table, one column per clipped triangle).
2. **Raster** — per 32x128-pixel tile, a fold of triangles in column
   order into the per-pixel winner (coverage, scissor, z in [0, 1], and
   LESS / LESS_EQUAL / last-wins / static depth test). Draws of at most
   ``_BIN_MIN_TRIS`` clipped triangles fold every column into every tile:
   kernel K6 (``csrc/raster.cu``). Larger draws bin first
   (:func:`_bin_triangles`: ``tile << idb | column`` keys through a 2x2
   fan and a budgeted all-tiles fan for big triangles, one sort), then
   kernel K7 folds each tile's packed row range and records the winning
   pack slot, and kernel K8 fetches the winner's feature row per pixel.
3. **Deferred shade** — perspective-correct varyings for each pixel's
   winner, the pipeline's ``fragment_fn``, blend and depth write
   (:func:`_shade`).

Vulkan semantics as in the JAX package: pixel centres at +0.5, y-down NDC,
depth in [0, 1], clockwise front faces, near-plane clipping at z_clip = 0,
no top-left fill rule. Each kernel has a plain PyTorch version here; its
wrapper runs that version only for CPU tensors. The plane equations keep
the JAX package's operands and order on both sides, so coverage at λ = 0
decides the same winner.
"""

from __future__ import annotations

import ctypes
from typing import Any, NamedTuple

import torch

from ..core.pipeline import (CompareOp, CullMode, FrontFace,
                             GraphicsPipeline, blend_color)
from ..core.resources import Framebuffer
from ..models.mesh import Mesh
from ..utils import pad_to as _pad_to
from . import _cuda

TILE_H = 32
TILE_W = 128
CHUNK = 128      # setup columns are padded to a multiple of this
_PIX = TILE_H * TILE_W

# setup rows; XMIN..YMAX is the screen bbox, GID the setup column as f32
_ROWS = 16
(_A0, _B0, _C0, _A1, _B1, _C1, _AZ, _BZ, _CZ, _VALID,
 _XMIN, _XMAX, _YMIN, _YMAX, _GID) = range(15)

#: a warp's footprint in K6/K7, the pixels each cull decision covers: the
#: default of :func:`_fold_culled` on the CPU; the kernels report theirs
#: (:func:`_fold_shape`)
_FOOT_W, _FOOT_H = 32, 8

#: clipped-triangle counts above this bin by tile (K7 + K8) instead of
#: folding every triangle into every tile (K6)
_BIN_MIN_TRIS = 512
#: budget of triangles whose bbox exceeds the 2x2-tile fan; each emits a
#: pair for every tile its bbox touches
_BIG_TRI_CAP = 512

_W_EPS = 1e-6
_AREA_EPS = 1e-12

# kernel mode bits
_DEPTH_TEST, _LAST_WINS, _LESS_EQUAL, _STATIC_TEST = 1, 2, 4, 8

_F32 = torch.float32
_I32 = torch.int32


# ---------------------------------------------------------------------------
# Vertex stage
# ---------------------------------------------------------------------------

def viewport_transform(clip: torch.Tensor, width: int, height: int):
    """Clip to framebuffer coordinates (Vulkan viewport, y-down NDC):
    ``x=(x/w+1)/2*W``, ``y=(y/w+1)/2*H``, ``z=z/w``. Returns (xy (..., 2),
    z (...), inv_w (...))."""
    w = clip[..., 3]
    inv_w = 1.0 / torch.where(w.abs() < _W_EPS, _W_EPS, w)
    ndc = clip[..., :3] * inv_w[..., None]
    x = (ndc[..., 0] + 1.0) * 0.5 * width
    y = (ndc[..., 1] + 1.0) * 0.5 * height
    return torch.stack([x, y], -1), ndc[..., 2], inv_w


def _clip_near(tri_clip: torch.Tensor):
    """Clip (T, 3, 4) clip-space triangles against the near plane z = 0.

    Each input yields up to two triangles, stacked as (2T, 3, 4): slot t is
    the primary (the triangle itself when fully inside), slot T + t the
    secondary of the two-inside case. Corners are first rotated so that
    the one inside vertex (one-inside case) or the one outside vertex
    (two-inside case, at slot 2) sits in place, which keeps the winding.
    Also returns ``bary`` (2T, 3, 3), row i of triangle j holding corner
    i's barycentric coordinates against the original corners, and
    ``valid`` (2T,) bool. (The JAX package rotates by static selects to
    dodge a TPU miscompile; indexing gives the same numbers.)"""
    t3 = tri_clip.shape[0]
    dev = tri_clip.device
    z = tri_clip[..., 2]
    inside = z >= 0.0
    count = inside.sum(-1)
    first_in = torch.argmax(inside.to(torch.uint8), -1)
    first_out = torch.argmax((~inside).to(torch.uint8), -1)
    rot = torch.where(count == 1, first_in,
                      torch.where(count == 2, (first_out + 1) % 3, 0))
    ar3 = torch.arange(3, device=dev)
    perm = (ar3[None] + rot[:, None]) % 3                  # (T, 3)
    v = torch.gather(tri_clip, 1, perm[:, :, None].expand(t3, 3, 4))
    zv = v[..., 2]

    def isect(za, zb):
        """Lerp factor t with z = 0 on segment a->b (guarded)."""
        den = za - zb
        t = za / torch.where(den.abs() < 1e-20, 1e-20, den)
        return t.clamp(0.0, 1.0)[:, None]

    t01 = isect(zv[:, 0], zv[:, 1])
    t12 = isect(zv[:, 1], zv[:, 2])
    t20 = isect(zv[:, 2], zv[:, 0])
    i01 = v[:, 0] + t01 * (v[:, 1] - v[:, 0])
    i12 = v[:, 1] + t12 * (v[:, 2] - v[:, 1])
    i20 = v[:, 2] + t20 * (v[:, 0] - v[:, 2])
    e = torch.eye(3, dtype=_F32, device=dev)
    b01 = (1 - t01) * e[0] + t01 * e[1]                    # (T, 3)
    b12 = (1 - t12) * e[1] + t12 * e[2]
    b20 = (1 - t20) * e[2] + t20 * e[0]
    e0 = e[0].expand(t3, 3)
    e1 = e[1].expand(t3, 3)

    c2 = (count == 2)[:, None, None]
    c3 = (count == 3)[:, None, None]
    # primary: count 3 -> (v0, v1, v2); 2 -> (v0, v1, i12); 1 -> (v0, i01, i20)
    tri_a = torch.where(
        c3, v, torch.where(c2, torch.stack([v[:, 0], v[:, 1], i12], 1),
                           torch.stack([v[:, 0], i01, i20], 1)))
    bary_a = torch.where(
        c3, e[None], torch.where(c2, torch.stack([e0, e1, b12], 1),
                                 torch.stack([e0, b01, b20], 1)))
    # secondary (two-inside case only): (v0, i12, i20)
    tri_b = torch.stack([v[:, 0], i12, i20], 1)
    bary_b = torch.stack([e0, b12, b20], 1)

    # un-rotate the barycentric columns: output column j = column (j - rot)
    unperm = ((ar3[None] - rot[:, None]) % 3)[:, None, :].expand(t3, 3, 3)
    tris = torch.cat([tri_a, tri_b], 0)
    bary = torch.cat([torch.gather(bary_a, 2, unperm),
                      torch.gather(bary_b, 2, unperm)], 0)
    valid = torch.cat([count >= 1, count == 2], 0)
    return tris, bary, valid


def _triangle_setup(clip: torch.Tensor, indices: torch.Tensor, state,
                    width: int, height: int):
    """Bake triangles into plane equations for the raster kernels.

    Returns ``setup`` (16, Tpad) float32, one clipped triangle per column:
    rows a0,b0,c0 / a1,b1,c1 are the barycentric planes (λ = a·px + b·py +
    c), az,bz,cz the depth plane, VALID the cull/degenerate mask,
    XMIN..YMAX the screen bbox and GID the column index. Also the clipped
    corners' inv_w (2T, 3) and NDC z (2T, 3), and ``bary_mix`` (2T, 3, 3)
    mapping original corner attributes to clipped-corner attributes."""
    tri_clip, bary_mix, clip_valid = _clip_near(clip[indices])
    xy, z, inv_w = viewport_transform(tri_clip, width, height)
    x0, x1, x2 = xy[:, 0, 0], xy[:, 1, 0], xy[:, 2, 0]
    y0, y1, y2 = xy[:, 0, 1], xy[:, 1, 1], xy[:, 2, 1]

    # signed doubled area; in y-down screen space clockwise > 0
    area2 = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    front_sign = 1.0 if state.front_face is FrontFace.CLOCKWISE else -1.0
    facing = area2 * front_sign
    if state.cull_mode is CullMode.BACK:
        keep = facing > 0
    elif state.cull_mode is CullMode.FRONT:
        keep = facing < 0
    else:
        keep = area2.abs() > _AREA_EPS
    keep = keep & clip_valid
    # degenerate projections (w ~ 0 at z >= 0) are culled
    keep = keep & (tri_clip[..., 3] > _W_EPS).all(-1)
    keep = keep & (area2.abs() > _AREA_EPS)

    inv_area = 1.0 / torch.where(area2.abs() < _AREA_EPS, 1.0, area2)
    a0 = -(y2 - y1) * inv_area                # λ0 plane: edge v1 -> v2
    b0 = (x2 - x1) * inv_area
    c0 = ((y2 - y1) * x1 - (x2 - x1) * y1) * inv_area
    a1 = -(y0 - y2) * inv_area                # λ1 plane: edge v2 -> v0
    b1 = (x0 - x2) * inv_area
    c1 = ((y0 - y2) * x2 - (x0 - x2) * y2) * inv_area
    z0, z1, z2 = z[:, 0], z[:, 1], z[:, 2]    # z = λ0 z0 + λ1 z1 + λ2 z2
    az = a0 * (z0 - z2) + a1 * (z1 - z2)
    bz = b0 * (z0 - z2) + b1 * (z1 - z2)
    cz = c0 * (z0 - z2) + c1 * (z1 - z2) + z2

    t2 = x0.shape[0]
    rows = torch.stack([a0, b0, c0, a1, b1, c1, az, bz, cz, keep.to(_F32),
                        torch.minimum(torch.minimum(x0, x1), x2),
                        torch.maximum(torch.maximum(x0, x1), x2),
                        torch.minimum(torch.minimum(y0, y1), y2),
                        torch.maximum(torch.maximum(y0, y1), y2),
                        torch.arange(t2, dtype=_F32, device=clip.device)])
    tpad = max(_pad_to(t2, CHUNK), CHUNK)
    setup = torch.zeros((_ROWS, tpad), dtype=_F32, device=clip.device)
    setup[:15, :t2] = rows
    return setup, inv_w, z, bary_mix


# ---------------------------------------------------------------------------
# The fold (plain versions of K6 and K7)
# ---------------------------------------------------------------------------

def _mode_bits(depth_test: bool, last_wins: bool, less_equal: bool,
               static_test: bool) -> int:
    return ((_DEPTH_TEST if depth_test else 0)
            | (_LAST_WINS if last_wins else 0)
            | (_LESS_EQUAL if less_equal else 0)
            | (_STATIC_TEST if static_test else 0))


def _fold_plain(rows, live, gids, px, py, dinit, width, height, mode,
                block: int = 16):
    """The raster fold for groups of pixels: group g folds its rows
    ``rows[g]`` (R, 16) in order, skipping rows where ``live`` is False,
    into the winner of each of its pixels (``px``, ``py``, ``dinit`` (G,
    P); ``rows``/``live``/``gids`` may have one group for all).

    Blocks of ``block`` rows are reduced at once by the kernels' tie rule:
    LESS keeps the first row with the smallest key below the running key,
    LESS_EQUAL the last one at or below it (so last-wins keys ``-gid``
    pick the largest covered row). Returns (key, row index or -1, gid or
    -1, λ0, λ1), each (G, P)."""
    last_wins = bool(mode & _LAST_WINS)
    less_equal = bool(mode & _LESS_EQUAL)
    static = bool(mode & _STATIC_TEST)
    inf = torch.tensor(float("inf"), dtype=_F32, device=px.device)
    g, p = px.shape
    if mode & _DEPTH_TEST and not static:
        cur = dinit.clone()
    else:
        cur = torch.full((g, p), float("inf"), dtype=_F32, device=px.device)
    win = torch.full((g, p), -1, dtype=torch.long, device=px.device)
    gid = torch.full((g, p), -1, dtype=_I32, device=px.device)
    l0 = torch.zeros((g, p), dtype=_F32, device=px.device)
    l1 = torch.zeros_like(l0)
    scissor = (px < width) & (py < height)
    pxe, pye, de, sce = px[:, None], py[:, None], dinit[:, None], \
        scissor[:, None]
    for b in range(0, rows.shape[1], block):
        r = rows[:, b:b + block, :, None]                  # (G, B, 16, 1)
        lv = live[:, b:b + block, None]
        lam0 = r[:, :, _A0] * pxe + r[:, :, _B0] * pye + r[:, :, _C0]
        lam1 = r[:, :, _A1] * pxe + r[:, :, _B1] * pye + r[:, :, _C1]
        zval = r[:, :, _AZ] * pxe + r[:, :, _BZ] * pye + r[:, :, _CZ]
        covered = ((lam0 >= 0.0) & (lam1 >= 0.0) & (lam0 + lam1 <= 1.0)
                   & sce & (zval >= 0.0) & (zval <= 1.0))
        if static:
            covered &= (zval <= de) if less_equal else (zval < de)
        gb = gids[:, b:b + block, None]
        if last_wins:
            key = torch.where(covered, -gb.to(_F32), inf)
        else:
            key = torch.where(covered, zval, inf)
        bmin = torch.where(lv, key, inf).amin(1)           # (G, P)
        cand = lv & (key == bmin[:, None])
        nb = cand.shape[1]
        if less_equal:
            idx = nb - 1 - torch.argmax(cand.flip(1).to(torch.uint8), 1)
            upd = cand.any(1) & (bmin <= cur)
        else:
            idx = torch.argmax(cand.to(torch.uint8), 1)
            upd = cand.any(1) & (bmin < cur)
        take = idx[:, None]

        def pick(a):
            return torch.gather(a.expand(g, nb, p), 1, take)[:, 0]

        cur = torch.where(upd, bmin, cur)
        win = torch.where(upd, b + idx, win)
        gid = torch.where(upd, pick(gb.to(_I32)), gid)
        l0 = torch.where(upd, pick(lam0), l0)
        l1 = torch.where(upd, pick(lam1), l1)
    return cur, win, gid, l0, l1


def _plane_misses(q, x0, x1, y0, y1):
    """The kernels' cull test (``csrc/raster.cu`` ``misses``, the same
    float32 operations): True where the setup row ``q[..., :9]`` provably
    covers no pixel centre of the rectangle [x0, x1] x [y0, y1] (positive
    coordinates; everything broadcasts against ``q[..., 0]``). The file
    header there derives the widening E."""
    scale = torch.tensor(2.0 ** -20, dtype=_F32, device=q.device)
    tiny = torch.tensor(2.0 ** -126, dtype=_F32, device=q.device)
    one = torch.tensor(1.0, dtype=_F32, device=q.device)

    def span(a, b, c):
        up_a, up_b = a > 0, b > 0
        hi = (a * torch.where(up_a, x1, x0) + b * torch.where(up_b, y1, y0)
              + c)
        lo = (a * torch.where(up_a, x0, x1) + b * torch.where(up_b, y0, y1)
              + c)
        e = (a.abs() * x1 + b.abs() * y1 + c.abs()) * scale + tiny
        return lo, hi, e

    lo0, hi0, e0 = span(q[..., _A0], q[..., _B0], q[..., _C0])
    lo1, hi1, e1 = span(q[..., _A1], q[..., _B1], q[..., _C1])
    loz, hiz, ez = span(q[..., _AZ], q[..., _BZ], q[..., _CZ])
    return ((hi0 < -e0) | (hi1 < -e1) | ((lo0 - e0) + (lo1 - e1) > one)
            | (hiz < -ez) | (loz - ez > one))


def _fold_culled(rows, live, gids, px, py, dinit, width, height, mode,
                 foot=(_FOOT_W, _FOOT_H)):
    """The fold as K6 and K7 run it: :func:`_fold_plain` per warp
    footprint (``foot``, (columns, rows) of a tile's pixels), without the
    live rows that :func:`_plane_misses` rejects for the footprint; then
    the LESS_EQUAL repair: a pixel whose key is still inf takes the
    group's last live row, its λ0 and λ1 evaluated at the pixel. Groups
    are whole tiles (``px``, ``py``, ``dinit`` (G, 4096) in tile layout;
    ``rows``/``live``/``gids`` as for :func:`_fold_plain`).

    Returns the outputs of :func:`_fold_plain`, then the count of skipped
    (live row, footprint) pairs and the count of all of them, each (G,
    footprints), row-major in the tile. Tests and ``chip_smoke.py`` hold
    it bit-equal to :func:`_fold_plain` and read the counts (on the card,
    with the kernels' ``_fold_shape().foot``); the main path never calls
    it."""
    fw, fh = foot
    if TILE_W % fw or TILE_H % fh:
        raise ValueError(f"footprint {fw}x{fh} does not tile a tile")
    g = px.shape[0]
    ny, nx = TILE_H // fh, TILE_W // fw
    nf, fp = ny * nx, fh * fw

    def by_foot(a):                  # (G, 4096) -> (G, nf, fp)
        return a.reshape(g, ny, fh, nx, fw).transpose(2, 3).reshape(g, nf,
                                                                     fp)

    def by_tile(a):                   # (G, nf, fp) -> (G, 4096)
        return a.reshape(g, ny, nx, fh, fw).transpose(2, 3) \
            .reshape(g, TILE_H * TILE_W)

    fx, fy = by_foot(px), by_foot(py)
    q = rows[:, None]                                      # (G|1, 1, R, 16)
    skip = _plane_misses(q, *(t.unsqueeze(-1) for t in (
        fx.amin(-1), fx.amax(-1), fy.amin(-1), fy.amax(-1))))
    nr = rows.shape[1]
    lv = live[:, None].expand(g, nf, nr)
    pairs, skipped = lv.sum(-1), (lv & skip).sum(-1)

    def per_foot(a):
        return a if a.shape[0] == 1 else a.repeat_interleave(nf, 0)

    key, win, gid, l0, l1 = (a.reshape(g, nf, fp) for a in _fold_plain(
        per_foot(rows), (lv & ~skip).reshape(g * nf, nr), per_foot(gids),
        fx.reshape(g * nf, fp), fy.reshape(g * nf, fp),
        by_foot(dinit).reshape(g * nf, fp), width, height, mode))
    if mode & _LESS_EQUAL:
        idx = torch.arange(nr, device=px.device)
        last = torch.where(live, idx, -1).amax(1)         # (G|1,)
        at = torch.arange(last.shape[0], device=px.device)
        lr = rows[at, last.clamp(min=0)][:, None, None]   # (G|1, 1, 1, 16)
        fix = (key == float("inf")) & (last >= 0)[:, None, None]
        win = torch.where(fix, last[:, None, None], win)
        gid = torch.where(fix, gids[at, last.clamp(min=0)][:, None, None],
                          gid)
        l0 = torch.where(fix, lr[..., _A0] * fx + lr[..., _B0] * fy
                         + lr[..., _C0], l0)
        l1 = torch.where(fix, lr[..., _A1] * fx + lr[..., _B1] * fy
                         + lr[..., _C1], l1)
    return tuple(by_tile(a) for a in (key, win, gid, l0, l1)), skipped, pairs


def _tile_pixels(ntx: int, nty: int, dev):
    """Pixel-centre planes (ntiles, 4096) of every tile, tile-major."""
    r = torch.arange(TILE_H, dtype=_F32, device=dev)[:, None].expand(
        TILE_H, TILE_W).reshape(-1)
    c = torch.arange(TILE_W, dtype=_F32, device=dev)[None, :].expand(
        TILE_H, TILE_W).reshape(-1)
    t = torch.arange(ntx * nty, device=dev)
    py = ((t // ntx) * TILE_H).to(_F32)[:, None] + r[None] + 0.5
    px = ((t % ntx) * TILE_W).to(_F32)[:, None] + c[None] + 0.5
    return px, py


def _tiles(plane: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """(Hp, Wp) image plane to (ntiles, 4096) tile-major rows."""
    return plane.reshape(nty, TILE_H, ntx, TILE_W).permute(
        0, 2, 1, 3).reshape(ntx * nty, _PIX)


def _untile(rows: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """(ntiles, 4096[, F]) tile rows to the (Hp, Wp[, F]) image."""
    tail = rows.shape[2:]
    return rows.reshape(nty, ntx, TILE_H, TILE_W, *tail).transpose(
        1, 2).reshape(nty * TILE_H, ntx * TILE_W, *tail)


def _fold_bound(n_tris: int | None, tpad: int) -> int:
    """Setup columns the dense fold visits: a single-chunk draw stops at
    its clipped-triangle count padded to 8 (the JAX ``nfold`` rule); the
    columns past it are padding and invalid either way."""
    if n_tris is not None and tpad == CHUNK:
        return max(_pad_to(n_tris, 8), 8)
    return tpad


def _dense_fold_inputs(setup, depth_init, ncols: int):
    """The dense fold's groups: every setup column below ``ncols`` for
    every tile. Returns the :func:`_fold_plain` inputs (rows, live, gids,
    px, py, dinit) and (ntx, nty)."""
    hp, wp = depth_init.shape
    ntx, nty = wp // TILE_W, hp // TILE_H
    dev = setup.device
    rows = setup[:, :ncols].T[None]                        # (1, R, 16)
    live = rows[:, :, _VALID] > 0.5
    gids = torch.arange(ncols, dtype=_I32, device=dev)[None]
    px, py = _tile_pixels(ntx, nty, dev)
    return (rows, live, gids, px, py, _tiles(depth_init, ntx, nty)), \
        (ntx, nty)


def _raster_dense_plain(setup, depth_init, ncols: int, width: float,
                        height: float, mode: int):
    """Plain version of K6: every setup column below ``ncols`` folded into
    every tile of the (Hp, Wp) frame (Hp a multiple of 32). Returns
    (depth/key, winner column i32, λ0, λ1), each (Hp, Wp)."""
    fin, (ntx, nty) = _dense_fold_inputs(setup, depth_init, ncols)
    key, _, gid, l0, l1 = _fold_plain(*fin, width, height, mode)
    return tuple(_untile(a, ntx, nty) for a in (key, gid, l0, l1))


def _raster_dense_culled(setup, depth_init, ncols: int, width: float,
                         height: float, mode: int, foot=(_FOOT_W, _FOOT_H)):
    """K6's fold as the kernel culls it (:func:`_fold_culled` with the
    warp footprint ``foot``): the outputs of :func:`_raster_dense_plain`,
    then the skipped and all (live row, footprint) pair counts of each
    tile's footprints (ntiles, footprints)."""
    fin, (ntx, nty) = _dense_fold_inputs(setup, depth_init, ncols)
    (key, _, gid, l0, l1), skipped, pairs = _fold_culled(
        *fin, width, height, mode, foot)
    return tuple(_untile(a, ntx, nty) for a in (key, gid, l0, l1)), \
        skipped, pairs


def _raster_dense_fake(setup, depth_init, ncols, width, height, mode):
    return tuple(depth_init.new_empty(depth_init.shape, dtype=dt)
                 for dt in (_F32, _I32, _F32, _F32))


@_cuda.kernel_op("k6_raster", _raster_dense_plain, _raster_dense_fake)
def _k6_op(setup: torch.Tensor, depth_init: torch.Tensor, ncols: int,
           width: float, height: float, mode: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """K6's launch: (depth/key, winner column i32, λ0, λ1), each (Hp,
    Wp)."""
    dev = _cuda.cuda_device(setup, "K6 raster")
    hp, wp = depth_init.shape
    tpad = setup.shape[1]
    if hp % TILE_H or wp % TILE_W or not 0 <= ncols <= tpad:
        raise ValueError(f"K6 raster: frame {hp}x{wp}, {ncols} of {tpad} "
                         "columns")
    _cuda.check_arg(setup, "setup", _F32, (_ROWS, tpad), dev)
    _cuda.check_arg(depth_init, "depth_init", _F32, (hp, wp), dev)
    outs = [torch.empty((hp, wp), dtype=dt, device=dev)
            for dt in (_F32, _I32, _F32, _F32)]
    with torch.cuda.device(dev):
        err = _cuda.lib().raster_dense(
            setup.data_ptr(), tpad, ncols, depth_init.data_ptr(), hp, wp,
            width, height, mode, *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K6 raster")
    _cuda.launches["k6_raster"] += 1
    return tuple(outs)


def _raster_dense_k6(setup, depth_init, ncols: int, width: float,
                     height: float, mode: int):
    """K6 wrapper (the op ``rayeater::k6_raster``; same outputs as
    :func:`_raster_dense_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    _cuda.op_device(setup, "K6 raster")
    return _k6_op(setup, depth_init, ncols, float(width), float(height),
                  mode)


def _binned_fold_inputs(pack, row_begin, row_end, depth_init):
    """The binned fold's groups: each tile's packed rows [row_begin,
    row_end), padded to the longest. Returns the :func:`_fold_plain`
    inputs (rows, live, gids, px, py, dinit), each row's pack slot
    (ntiles, R) and (ntx, nty)."""
    hp, wp = depth_init.shape
    ntx, nty = wp // TILE_W, hp // TILE_H
    dev = pack.device
    count = (row_end - row_begin).long()
    nmax = max(int(count.max()), 1) if count.numel() else 1
    j = torch.arange(nmax, device=dev)
    slot = (row_begin.long()[:, None] + j[None]).clamp(max=pack.shape[0] - 1)
    rows = pack[slot]                                      # (ntiles, R, 16)
    live = (j[None] < count[:, None]) & (rows[:, :, _VALID] > 0.5)
    gids = rows[:, :, _GID].to(_I32)
    px, py = _tile_pixels(ntx, nty, dev)
    return (rows, live, gids, px, py, _tiles(depth_init, ntx, nty)), slot, \
        (ntx, nty)


def _binned_outputs(fold, slot, ntx: int, nty: int):
    """(depth/key, gid, λ0, λ1, winner pack slot) images of a binned
    fold's (key, row index, gid, λ0, λ1)."""
    key, win, gid, l0, l1 = fold
    wslot = torch.where(win >= 0,
                        torch.gather(slot, 1, win.clamp(min=0)), -1)
    return tuple(_untile(a, ntx, nty)
                 for a in (key, gid, l0, l1, wslot.to(_I32)))


def _raster_binned_plain(pack, row_begin, row_end, depth_init, width: float,
                         height: float, mode: int):
    """Plain version of K7: each tile folds its packed rows
    [row_begin, row_end) in order. Returns (depth/key, winner id i32 (the
    rows' GID), λ0, λ1, winner pack slot i32), each (Hp, Wp); tiles with
    no rows hold the fold's initial state (callers mask them)."""
    fin, slot, (ntx, nty) = _binned_fold_inputs(pack, row_begin, row_end,
                                                depth_init)
    return _binned_outputs(_fold_plain(*fin, width, height, mode), slot,
                           ntx, nty)


def _raster_binned_culled(pack, row_begin, row_end, depth_init,
                          width: float, height: float, mode: int,
                          foot=(_FOOT_W, _FOOT_H)):
    """K7's fold as the kernel culls it (:func:`_fold_culled` with the
    warp footprint ``foot``): the outputs of :func:`_raster_binned_plain`,
    then the skipped and all (live row, footprint) pair counts of each
    tile's footprints (ntiles, footprints)."""
    fin, slot, (ntx, nty) = _binned_fold_inputs(pack, row_begin, row_end,
                                                depth_init)
    fold, skipped, pairs = _fold_culled(*fin, width, height, mode, foot)
    return _binned_outputs(fold, slot, ntx, nty), skipped, pairs


class FoldShape(NamedTuple):
    """How K6 or K7 covers a tile, as the kernel library reports it."""
    foot: tuple[int, int]     # a warp's footprint (columns, rows)
    region: tuple[int, int]   # a CTA's region of a tile (columns, rows)
    ctas: int                 # CTAs a tile
    threads: int              # threads a CTA
    resident: int             # CTAs the card holds at once


def _fold_shape(kernel: int, mode: int = 0) -> FoldShape:
    """The geometry of K6 (``kernel`` 6) or K7 (7) as it runs ``mode``
    (``raster_fold_shape`` in ``csrc/raster.cu``; builds the kernel
    library, needs a CUDA device)."""
    fn = _cuda.lib().raster_fold_shape
    i, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes, fn.restype = [i, i] + [pi] * 7, i
    v = [i() for _ in range(7)]
    _cuda.check(fn(kernel, mode, *(ctypes.byref(x) for x in v)),
                f"K{kernel} shape")
    fw, fh, cw, ch, ctas, threads, resident = (x.value for x in v)
    return FoldShape((fw, fh), (cw, ch), ctas, threads, resident)


def _raster_binned_fake(pack, row_begin, row_end, depth_init, width,
                        height, mode):
    return tuple(depth_init.new_empty(depth_init.shape, dtype=dt)
                 for dt in (_F32, _I32, _F32, _F32, _I32))


@_cuda.kernel_op("k7_raster_binned", _raster_binned_plain,
                 _raster_binned_fake)
def _k7_op(pack: torch.Tensor, row_begin: torch.Tensor,
           row_end: torch.Tensor, depth_init: torch.Tensor, width: float,
           height: float, mode: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                      torch.Tensor]:
    """K7's launch: (depth/key, winner id, λ0, λ1, winner pack slot), each
    (Hp, Wp); tiles with no rows are left unwritten."""
    dev = _cuda.cuda_device(pack, "K7 binned raster")
    hp, wp = depth_init.shape
    ntx, nty = wp // TILE_W, hp // TILE_H
    ntiles = ntx * nty
    if hp % TILE_H or wp % TILE_W:
        raise ValueError(f"K7 binned raster: frame {hp}x{wp}")
    _cuda.check_arg(pack, "pack", _F32, (pack.shape[0], _ROWS), dev)
    _cuda.check_arg(row_begin, "row_begin", _I32, (ntiles,), dev)
    _cuda.check_arg(row_end, "row_end", _I32, (ntiles,), dev)
    _cuda.check_arg(depth_init, "depth_init", _F32, (hp, wp), dev)
    outs = [torch.empty((hp, wp), dtype=dt, device=dev)
            for dt in (_F32, _I32, _F32, _F32, _I32)]
    with torch.cuda.device(dev):
        err = _cuda.lib().raster_binned(
            pack.data_ptr(), row_begin.data_ptr(), row_end.data_ptr(),
            ntiles, ntx, depth_init.data_ptr(), hp, wp, width, height, mode,
            *(o.data_ptr() for o in outs),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K7 binned raster")
    _cuda.launches["k7_raster_binned"] += 1
    return tuple(outs)


def _raster_binned_k7(pack, row_begin, row_end, depth_init, width: float,
                      height: float, mode: int):
    """K7 wrapper (the op ``rayeater::k7_raster_binned``; same outputs as
    :func:`_raster_binned_plain`; tiles with no rows are left unwritten).
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    _cuda.op_device(pack, "K7 binned raster")
    return _k7_op(pack, row_begin, row_end, depth_init, float(width),
                  float(height), mode)


# ---------------------------------------------------------------------------
# Winner-feature fetch (K8)
# ---------------------------------------------------------------------------

def _tile_mask(visited: torch.Tensor, ntx: int, nty: int) -> torch.Tensor:
    """(ntiles,) bool to the (Hp, Wp) per-pixel mask."""
    return visited.reshape(nty, 1, ntx, 1).expand(
        nty, TILE_H, ntx, TILE_W).reshape(nty * TILE_H, ntx * TILE_W)


def _shade_fetch_plain(fpack, slot, visited):
    """Plain version of K8: ``fpack[slot]`` per pixel, (Hp, Wp, F) float32,
    zeros where the slot is -1 or the tile is unvisited."""
    hp, wp = slot.shape
    # K7 leaves unvisited tiles' slots unwritten: never index with them
    ok = _tile_mask(visited, wp // TILE_W, hp // TILE_H) & (slot >= 0)
    rows = fpack[torch.where(ok, slot, 0).long()]
    return torch.where(ok[..., None], rows, 0.0)


def _shade_fetch_fake(fpack, slot, visited):
    return fpack.new_empty((*slot.shape, fpack.shape[1]))


@_cuda.kernel_op("k8_shade_fetch", _shade_fetch_plain, _shade_fetch_fake)
def _k8_op(fpack: torch.Tensor, slot: torch.Tensor,
           visited: torch.Tensor) -> torch.Tensor:
    """K8's launch: (Hp, Wp, F) f32 winner-row features."""
    dev = _cuda.cuda_device(fpack, "K8 shade fetch")
    hp, wp = slot.shape
    ntx, nty = wp // TILE_W, hp // TILE_H
    if hp % TILE_H or wp % TILE_W:
        raise ValueError(f"K8 shade fetch: frame {hp}x{wp}")
    cap, nfeat = fpack.shape
    _cuda.check_arg(fpack, "fpack", _F32, (cap, nfeat), dev)
    _cuda.check_arg(slot, "slot", _I32, (hp, wp), dev)
    _cuda.check_arg(visited, "visited", torch.bool, (ntx * nty,), dev)
    out = torch.empty((hp, wp, nfeat), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().shade_fetch(
            slot.data_ptr(), fpack.data_ptr(), visited.data_ptr(), ntx, hp,
            wp, nfeat, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K8 shade fetch")
    _cuda.launches["k8_shade_fetch"] += 1
    return out


def _shade_fetch_k8(fpack, slot, visited):
    """K8 wrapper (the op ``rayeater::k8_shade_fetch``; same output as
    :func:`_shade_fetch_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    _cuda.op_device(fpack, "K8 shade fetch")
    return _k8_op(fpack, slot, visited)


# ---------------------------------------------------------------------------
# Binning
# ---------------------------------------------------------------------------

class BinnedTris(NamedTuple):
    pack: torch.Tensor          # (cap, 16) setup rows in pair order
    fpack: torch.Tensor | None  # (cap, F) feature rows in pair order
    row_begin: torch.Tensor     # (ntiles,) int32 first packed row
    row_end: torch.Tensor       # (ntiles,) int32 one past the last
    visited: torch.Tensor       # (ntiles,) bool: the tile has rows
    overflow_big: torch.Tensor  # () int32 big triangles past the budget
    sorted_key: torch.Tensor    # (cap,) int32 tile << idb | column


def _bin_triangles(setup, ntx: int, nty: int, feat=None) -> BinnedTris:
    """Tile binning (the design of ``gs._bin_splats``): each live triangle
    emits ``tile << idb | column`` keys for the tiles its bbox touches — a
    2x2 fan for triangles within 2x2 tiles, and a budgeted
    (``_BIG_TRI_CAP``) all-tiles fan for larger ones, selected by
    cumsum/searchsorted. One sort groups the pairs into per-tile runs in
    column (draw) order; keys are unique apart from the sentinel, so the
    order is deterministic. Setup rows (and ``feat`` (T, F) rows, when
    given) are packed into pair order by one gather each."""
    t2 = setup.shape[1]
    ntiles = ntx * nty
    dev = setup.device
    idb = max(t2 - 1, 1).bit_length()
    if ntiles.bit_length() + idb > 31:
        raise ValueError("tile|id key overflows int32")
    sentinel = ntiles << idb
    col = torch.arange(t2, dtype=_I32, device=dev)
    valid = setup[_VALID] > 0.5

    def span(row, tile, n):
        return torch.floor(setup[row] / tile).clamp(0, n - 1).to(_I32)

    tx0, tx1 = span(_XMIN, TILE_W, ntx), span(_XMAX, TILE_W, ntx)
    ty0, ty1 = span(_YMIN, TILE_H, nty), span(_YMAX, TILE_H, nty)
    small = valid & (tx1 - tx0 < 2) & (ty1 - ty0 < 2)
    keys = []
    for dy in range(2):
        for dx in range(2):
            ty, tx = ty0 + dy, tx0 + dx
            ok = small & (ty <= ty1) & (tx <= tx1)
            keys.append(torch.where(ok, ((ty * ntx + tx) << idb) | col,
                                    sentinel))
    # budgeted big-triangle stream: bbox-culled all-tiles fan
    big = valid & ~small
    csum = torch.cumsum(big.to(_I32), 0, dtype=_I32)
    nbig = csum[-1]
    overflow_big = (nbig - _BIG_TRI_CAP).clamp(min=0)
    slot = torch.arange(_BIG_TRI_CAP, dtype=_I32, device=dev)
    bidx = torch.searchsorted(csum, slot + 1, side="left").clamp(
        0, t2 - 1).to(_I32)
    bvalid = slot < nbig
    tid = torch.arange(ntiles, dtype=_I32, device=dev)
    t_x, t_y = tid % ntx, tid // ntx
    bl = bidx.long()
    bok = (bvalid[:, None] & (t_x[None] >= tx0[bl][:, None])
           & (t_x[None] <= tx1[bl][:, None])
           & (t_y[None] >= ty0[bl][:, None])
           & (t_y[None] <= ty1[bl][:, None]))             # (B, ntiles)
    bkey = torch.where(bok, (tid[None] << idb) | bidx[:, None], sentinel)
    key_flat = torch.cat(keys + [bkey.reshape(-1)])
    m = key_flat.shape[0]
    cap = _pad_to(m, CHUNK)
    sorted_key = torch.sort(key_flat).values
    if cap > m:
        sorted_key = torch.cat([sorted_key, torch.full(
            (cap - m,), sentinel, dtype=_I32, device=dev)])
    ids = (sorted_key & ((1 << idb) - 1)).clamp(0, t2 - 1).long()
    pack = setup.T[ids].contiguous()
    fpack = None
    if feat is not None:
        if feat.shape[0] < t2:       # setup columns are CHUNK-padded
            feat = torch.cat([feat, feat.new_zeros(
                (t2 - feat.shape[0], feat.shape[1]))])
        fpack = feat[ids].contiguous()
    tvec = torch.arange(ntiles + 1, dtype=_I32, device=dev)
    start = torch.searchsorted(sorted_key, tvec << idb,
                               side="left").to(_I32)
    row_begin, row_end = start[:-1].contiguous(), start[1:].contiguous()
    return BinnedTris(pack, fpack, row_begin, row_end, row_end > row_begin,
                      overflow_big, sorted_key)


# ---------------------------------------------------------------------------
# Raster calls
# ---------------------------------------------------------------------------

def _init_depth(depth_init, depth_test: bool, static_test: bool):
    """The running key a tile starts from (and unvisited tiles keep)."""
    if depth_test and not static_test:
        return depth_init
    return torch.full_like(depth_init, float("inf"))


def _pad_rows(depth):
    """The fold's incoming depth: tiles are TILE_H tall, so rows of inf
    (they fail the scissor test) pad ``depth`` to a multiple of TILE_H;
    callers slice the outputs back."""
    hp0, wp = depth.shape
    hp = max(_pad_to(hp0, TILE_H), TILE_H)
    if hp == hp0:
        return depth
    return torch.cat([depth, torch.full((hp - hp0, wp), float("inf"),
                                        dtype=_F32, device=depth.device)])


def _raster_call_binned(setup, depth_init, width, height, depth_test,
                        last_wins, less_equal=False, static_test=False,
                        feat_table=None):
    hp, wp = depth_init.shape
    ntx, nty = wp // TILE_W, hp // TILE_H
    b = _bin_triangles(setup, ntx, nty, feat=feat_table)
    mode = _mode_bits(depth_test, last_wins, less_equal, static_test)
    depth, tri, l0, l1, slot = _raster_binned_k7(
        b.pack, b.row_begin, b.row_end, depth_init, float(width),
        float(height), mode)
    # tiles with no rows are never written: fill them with the cleared state
    vis = _tile_mask(b.visited, ntx, nty)
    feats = None
    if b.fpack is not None:
        feats = _shade_fetch_k8(b.fpack, slot, b.visited)
    return [torch.where(vis, depth, _init_depth(depth_init, depth_test,
                                                static_test)),
            torch.where(vis, tri, -1),
            torch.where(vis, l0, 0.0),
            torch.where(vis, l1, 0.0),
            feats]


def _raster_call(setup, depth_init, width, height, depth_test, last_wins,
                 less_equal=False, static_test=False, n_tris=None,
                 feat_table=None):
    """Returns [depth/key, winner id, λ0, λ1, feats], each (H, W) for the
    (H, W) ``depth_init``; ``feats`` is the (H, W, F) winner-feature plane
    when the binned path ran with a ``feat_table``, else None."""
    hp0 = depth_init.shape[0]
    depth_init = _pad_rows(depth_init)
    tpad = setup.shape[1]
    if n_tris is not None and n_tris > _BIN_MIN_TRIS:
        out = _raster_call_binned(setup, depth_init, width, height,
                                  depth_test, last_wins,
                                  less_equal=less_equal,
                                  static_test=static_test,
                                  feat_table=feat_table)
    else:
        mode = _mode_bits(depth_test, last_wins, less_equal, static_test)
        out = list(_raster_dense_k6(setup, depth_init,
                                    _fold_bound(n_tris, tpad), float(width),
                                    float(height), mode)) + [None]
    return [o[:hp0] if o is not None else None for o in out]


# ---------------------------------------------------------------------------
# Deferred shade
# ---------------------------------------------------------------------------

def _feature_table(tri_vary: dict, inv_w, z_tri=None):
    """One per-triangle feature table [inv_w (3) | z (3)? | per varying
    (3*K)...], the layout :func:`_shade` reads per pixel."""
    num_tris = inv_w.shape[0]
    cols = [inv_w]
    if z_tri is not None:
        cols.append(z_tri)
    for name in tri_vary:
        cols.append(tri_vary[name].reshape(num_tris, -1))
    return torch.cat(cols, -1).contiguous()


class PixelVaryings(NamedTuple):
    vary: dict              # name -> (H, W, K), plus "_coverage" (H, W)
    lam: torch.Tensor       # (H, W, 3) screen-space barycentrics
    z_px: torch.Tensor | None   # (H, W, 3) winner corner depths
    mask: torch.Tensor      # (H, W) bool: a triangle won the pixel


def _interpolate(gtri, gl0, gl1, tri_vary: dict, inv_w, z_tri=None,
                 feats=None) -> PixelVaryings:
    """Perspective-correct varyings of each pixel's winner triangle. The
    features come from ``feats`` (K8's plane) or from one row gather of
    :func:`_feature_table` by winner id (the JAX package's one-hot matmul
    for small draws is a TPU workaround with the same result)."""
    mask = gtri >= 0
    hw = gtri.shape
    l2 = 1.0 - gl0 - gl1
    lam = torch.stack([gl0, gl1, l2], -1)
    if feats is None:
        table = _feature_table(tri_vary, inv_w, z_tri)
        feats = table[gtri.clamp(min=0).reshape(-1).long()].reshape(*hw, -1)
    iw = feats[..., :3]
    offs = 3
    z_px = None
    if z_tri is not None:
        z_px = feats[..., 3:6]
        offs = 6
    lp = lam * iw
    denom = (lp[..., 0] + lp[..., 1] + lp[..., 2])[..., None]
    lp = lp / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    vary = {}
    for name, tv in tri_vary.items():
        k = tv.shape[-1]
        f = feats[..., offs:offs + 3 * k].reshape(*hw, 3, k)
        offs += 3 * k
        vary[name] = (lp[..., 0, None] * f[..., 0, :]
                      + lp[..., 1, None] * f[..., 1, :]
                      + lp[..., 2, None] * f[..., 2, :])
    # coverage for the fragment shader: uncovered pixels carry triangle
    # 0's varyings; block samplers leave them out of their footprints
    vary["_coverage"] = mask
    return PixelVaryings(vary, lam, z_px, mask)


def _shade(pipe: GraphicsPipeline, fb: Framebuffer, gdepth, gtri, gl0, gl1,
           tri_vary: dict, inv_w, resources, z_tri=None,
           feats=None) -> Framebuffer:
    """Deferred shading: the fragment function on the winners' varyings,
    blended and merged into ``fb``. With ``z_tri`` (the last-wins modes,
    whose key plane holds ``-id``) the depth written is interpolated from
    the winner's corner depths."""
    pv = _interpolate(gtri, gl0, gl1, tri_vary, inv_w, z_tri, feats)
    mask = pv.mask
    rgba = pipe.fragment_fn(pv.vary, resources)
    out = blend_color(pipe.state.blend, rgba, fb.color)
    color = torch.where(mask[..., None], out, fb.color)
    state = pipe.state
    if pv.z_px is not None and state.depth_write:
        z = pv.lam * pv.z_px
        depth = torch.where(mask, z[..., 0] + z[..., 1] + z[..., 2],
                            fb.depth)
    elif state.depth_test and state.depth_write:
        depth = gdepth        # the fold already min-folded fb's depth
    elif state.depth_write:
        depth = torch.where(mask, gdepth, fb.depth)
    else:
        depth = fb.depth
    return Framebuffer(color=color, depth=depth, width=fb.width,
                       height=fb.height)


def _depth_modes(state):
    """(last_wins, less_equal, static_test) of a raster state. Depth test
    off or ALWAYS: the last covering triangle wins. Test on, write off:
    every fragment tests against the incoming buffer and the last passing
    one wins (Vulkan), not a min-fold."""
    last_wins = not state.depth_test
    if state.depth_compare is CompareOp.ALWAYS:
        last_wins = True
    static_test = (state.depth_test and not state.depth_write
                   and state.depth_compare is not CompareOp.ALWAYS)
    if static_test:
        last_wins = True
    return (last_wins, state.depth_compare is CompareOp.LESS_EQUAL,
            static_test)


class DrawSetup(NamedTuple):
    setup: torch.Tensor     # (16, Tpad) plane equations
    inv_w: torch.Tensor     # (2T, 3)
    z_tri: torch.Tensor     # (2T, 3)
    tri_vary: dict          # name -> (2T, 3, K) clipped-corner varyings


def _vertex_stage(pipe: GraphicsPipeline, mesh_: Mesh, uniforms,
                  fb: Framebuffer) -> DrawSetup:
    """The vertex function, triangle setup, and the varyings of the
    clipped corners (corner i of clipped triangle j mixes the original
    corners by ``bary_mix[j, i]``)."""
    clip, varyings = pipe.vertex_fn(mesh_.positions, mesh_.attributes,
                                    uniforms)
    setup, inv_w, z_tri, bary_mix = _triangle_setup(
        clip, mesh_.indices, pipe.state, fb.width, fb.height)
    tri_vary = {}
    for name, vals in varyings.items():
        tv = vals[mesh_.indices]                           # (T, 3, K)
        tv2 = torch.cat([tv, tv], 0)
        tri_vary[name] = (bary_mix[..., 0, None] * tv2[:, 0:1]
                          + bary_mix[..., 1, None] * tv2[:, 1:2]
                          + bary_mix[..., 2, None] * tv2[:, 2:3])
    return DrawSetup(setup, inv_w, z_tri, tri_vary)


def _raster_draw(pipe: GraphicsPipeline, ds: DrawSetup, fb: Framebuffer,
                 shade_fetch: bool = True):
    """The raster stage of a draw: [depth/key, winner id, λ0, λ1, feats]
    and the corner depths ``z_tri`` the shade needs (or None). Binned
    draws fetch the winners' features in K8; with ``shade_fetch=False``
    they gather them per pixel from the feature table by winner id
    instead, with K8's zeros where no triangle won, so the frame is the
    same (the samplers' derivatives read uncovered neighbours too)."""
    state = pipe.state
    last_wins, less_equal, static_test = _depth_modes(state)
    zt = ds.z_tri if (last_wins and state.depth_write) else None
    n_tris = ds.inv_w.shape[0]
    binned = n_tris > _BIN_MIN_TRIS
    table = _feature_table(ds.tri_vary, ds.inv_w, zt) if binned else None
    out = _raster_call(ds.setup, fb.depth, fb.width, fb.height,
                       depth_test=state.depth_test, last_wins=last_wins,
                       less_equal=less_equal, static_test=static_test,
                       n_tris=n_tris,
                       feat_table=table if shade_fetch else None)
    if binned and not shade_fetch:
        tri = out[1]
        rows = table[tri.clamp(min=0).reshape(-1).long()]
        out[4] = torch.where((tri >= 0)[..., None],
                             rows.reshape(*tri.shape, -1), 0.0)
    return out, zt


def render_mesh(pipe: GraphicsPipeline, mesh_: Mesh, uniforms: Any,
                resources: Any, fb: Framebuffer,
                shade_fetch: bool = True) -> Framebuffer:
    """Draw one mesh through a graphics pipeline into ``fb`` (the
    reference's bind-and-drawIndexed, basic_planes.zig:329-335).
    ``shade_fetch=False`` (the JAX package's ``RAYEATER_SHADE_FETCH=0``)
    fetches a binned draw's winner features by a per-pixel row gather
    instead of kernel K8; the frame is the same (see
    :func:`_raster_draw`)."""
    ds = _vertex_stage(pipe, mesh_, uniforms, fb)
    (gdepth, gtri, gl0, gl1, feats), zt = _raster_draw(pipe, ds, fb,
                                                       shade_fetch)
    return _shade(pipe, fb, gdepth, gtri, gl0, gl1, ds.tri_vary, ds.inv_w,
                  resources, z_tri=zt, feats=feats)
