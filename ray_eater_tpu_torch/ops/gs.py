"""3D Gaussian Splatting render path in PyTorch + CUDA (counterpart of
``ray_eater_tpu/ops/gs.py``).

One frame runs:

1. **Project** — kernel K1 (``csrc/gs_project.cu``): EWA projection of every
   splat, one thread per splat (:func:`_project_fast`).
2. **Bin** — PyTorch ops: each splat emits ``KX*ky`` candidate
   ``tile << db | qdepth`` keys; one sort groups them into per-tile runs that
   are front-to-back within each run. Exact mode keeps every pair (up to the
   positional ``cap_pairs`` drop); the LOD mode grants each tile a
   block-granular share of a global pool (:func:`_bin_splats`).
3. **Pack** — one row gather of the (N, 12) record table into packed order.
4. **Composite** — kernel K2 (``csrc/gs_composite.cu``): one CTA per tile
   walks the tile's packed rows front to back, with tile-level saturation
   checked at 128-row chunk ends (:func:`_composite_call`).
5. **Finalize** — mask unvisited tiles, untile, blend the background.

The float32 arithmetic of every step that feeds an integer (radii, tile
spans, depth keys, pool grants) keeps the JAX package's operands and order,
so the two packages bin the same pairs. Each kernel has a plain PyTorch
version here; its wrapper runs that version only for CPU tensors.

Ported here: the level-1 fan, exact and LOD modes, temporal budgets.
Not ported yet (``render_gaussians`` raises ``NotImplementedError``): the
big/mid/mid-lo/corner side channels, the LOD tail proxy, the decimated
tail composite and view-dependent SH colours.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..utils import pad_to as _pad_to
from . import _cuda

TILE_H = 32
TILE_W = 128
CHUNK = 128      # rows of a composite chunk; saturation is checked per chunk
KX = 2           # max horizontal tile span per splat
KY = 2           # default max vertical tile span per splat
#: per-tile LOD desire ceiling, in multiples of max_splats_per_tile
LOD_DESIRE_CAP = 32
#: dry-tile floor-channel jump ceiling, in multiples of max_splats_per_tile
_DRY_FLOOR_CAP = 4
_ALPHA_MIN = 1.0 / 255.0   # 3DGS convention: skip ultra-faint contributions
_ALPHA_MAX = 0.99
_T_EPS = 1e-4              # tile saturated when every pixel has T < eps

# record columns: one (12,) f32 row per splat, 9 used; validity is op == 0
_MX, _MY, _CA, _CB, _CC, _OP, _CR, _CG, _CB2 = range(9)
_ROWS = 12

_F32 = torch.float32
_I32 = torch.int32


def level1_max_radius(ky: int = KY, tile_w: int = TILE_W) -> int:
    """Largest radius whose [m-r, m+r] span fits in KX×ky tiles."""
    return min((ky - 1) * TILE_H // 2 - 1, (KX - 1) * tile_w // 2 - 1)


def num_tiles(width: int, height: int,
              tile_w: int = TILE_W) -> tuple[int, int]:
    """(ntx, nty) tile-grid shape for a framebuffer size."""
    return ((width + tile_w - 1) // tile_w,
            (height + TILE_H - 1) // TILE_H)


class ProjectedSplats(NamedTuple):
    mean2d: torch.Tensor    # (N, 2) screen px
    conic: torch.Tensor     # (N, 3) inverse covariance (a, b, c)
    depth: torch.Tensor     # (N,) view depth (+inf if culled)
    radius: torch.Tensor    # (N,) int32 circumscribed extent in px
    color: torch.Tensor     # (N, 3)
    opacity: torch.Tensor   # (N,)
    ext: torch.Tensor       # (N, 2) int32 per-axis bbox extents (rx, ry)


# ---------------------------------------------------------------------------
# K1: projection
# ---------------------------------------------------------------------------

def _project_scalars(view, proj, width, height, near, max_radius):
    """(24,) f32 scalar packet read by :func:`_project_math`: 12 view
    scalars (row-major R, then t), then fx, fy, proj00, proj11, W, H, near,
    max_radius, then 4 zeros."""
    rv, tv = view[:3, :3], view[:3, 3]
    fx = proj[0, 0] * width * 0.5
    fy = proj[1, 1] * height * 0.5
    tail = torch.tensor([width, height, near, max_radius, 0, 0, 0, 0],
                        dtype=_F32, device=view.device)
    return torch.cat([rv.reshape(-1), tv.reshape(-1),
                      torch.stack([fx, fy, proj[0, 0], proj[1, 1]]),
                      tail]).to(_F32)


def _cov3d_math(sx, sy, sz, qw, qx, qy, qz):
    """(scales, quats) → the 6 unique entries of the world-space covariance
    Σ = (R S)(R S)ᵀ, elementwise. The quaternion norm's inverse square root
    is taken as ``1 / sqrt`` so it rounds the same in the kernel."""
    inv_n = 1.0 / torch.sqrt(
        torch.clamp(qw * qw + qx * qx + qy * qy + qz * qz, min=1e-24))
    w, x, y, z = qw * inv_n, qx * inv_n, qy * inv_n, qz * inv_n
    m = [[(1 - 2 * (y * y + z * z)) * sx, 2 * (x * y - w * z) * sy,
          2 * (x * z + w * y) * sz],
         [2 * (x * y + w * z) * sx, (1 - 2 * (x * x + z * z)) * sy,
          2 * (y * z - w * x) * sz],
         [2 * (x * z - w * y) * sx, 2 * (y * z + w * x) * sy,
          (1 - 2 * (x * x + y * y)) * sz]]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
    return dot(0, 0), dot(0, 1), dot(0, 2), dot(1, 1), dot(1, 2), dot(2, 2)


def _project_math(px_, py_, pz_, s00, s01, s02, s11, s12, s22, op, scal):
    """Elementwise EWA projection (the JAX ``_project_math``, operand for
    operand). Returns (mx, my, conic_a, conic_b, conic_c, depth (+inf when
    culled), radius, rx, ry), all f32. ``radius`` is the circumscribed
    extent at the opacity-aware cutoff s = min(3, √(2·ln(op/_ALPHA_MIN))),
    ``rx``/``ry`` the per-axis bbox extents of the same ellipse."""
    def v(k):
        return scal[k]
    r_v = [[v(0), v(1), v(2)], [v(3), v(4), v(5)], [v(6), v(7), v(8)]]
    tv = (v(9), v(10), v(11))
    fx, fy, p00, p11 = v(12), v(13), v(14), v(15)
    width, height, near, max_radius = v(16), v(17), v(18), v(19)

    pvx = r_v[0][0] * px_ + r_v[0][1] * py_ + r_v[0][2] * pz_ + tv[0]
    pvy = r_v[1][0] * px_ + r_v[1][1] * py_ + r_v[1][2] * pz_ + tv[1]
    zv = r_v[2][0] * px_ + r_v[2][1] * py_ + r_v[2][2] * pz_ + tv[2]
    sig = [[s00, s01, s02], [s01, s11, s12], [s02, s12, s22]]
    t = [[r_v[i][0] * sig[0][j] + r_v[i][1] * sig[1][j]
          + r_v[i][2] * sig[2][j] for j in range(3)] for i in range(3)]

    z_safe = torch.maximum(zv, near)
    inv_z = 1.0 / z_safe
    lim_x = 1.3 * (width * 0.5) / torch.abs(fx)
    lim_y = 1.3 * (height * 0.5) / torch.abs(fy)
    txz = torch.clamp(pvx * inv_z, -lim_x, lim_x)
    tyz = torch.clamp(pvy * inv_z, -lim_y, lim_y)

    j00 = fx * inv_z
    j02 = -fx * txz * inv_z
    j11 = fy * inv_z
    j12 = -fy * tyz * inv_z

    def cv(i, j):
        return (t[i][0] * r_v[j][0] + t[i][1] * r_v[j][1]
                + t[i][2] * r_v[j][2])
    c00, c01, c02 = cv(0, 0), cv(0, 1), cv(0, 2)
    c11, c12, c22 = cv(1, 1), cv(1, 2), cv(2, 2)
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + 0.3
    bb = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + 0.3

    det = a * c - bb * bb
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    scut = torch.clamp(torch.sqrt(torch.clamp(
        2.0 * torch.log(torch.clamp(op, min=_ALPHA_MIN) * (1.0 / _ALPHA_MIN)),
        min=1e-6)), max=3.0)
    radius = torch.ceil(scut * torch.sqrt(torch.clamp(lam_max, min=0.0)))
    radius = torch.minimum(radius, max_radius)
    rx = torch.minimum(torch.ceil(scut * torch.sqrt(torch.clamp(a, min=0.0))),
                       radius)
    ry = torch.minimum(torch.ceil(scut * torch.sqrt(torch.clamp(c, min=0.0))),
                       radius)

    inv_det = 1.0 / torch.where(det > 1e-12, det, 1.0)

    mx = (pvx * inv_z * p00 + 1.0) * 0.5 * width
    my = (pvy * inv_z * p11 + 1.0) * 0.5 * height

    valid = ((zv > near) & (det > 1e-12) & (radius >= 1.0)
             & (mx + rx > 0) & (mx - rx < width)
             & (my + ry > 0) & (my - ry < height)
             & (op > _ALPHA_MIN))
    depth = torch.where(valid, zv, math.inf)
    return (mx, my, c * inv_det, -bb * inv_det, a * inv_det, depth,
            radius, rx, ry)


def _project_plain(means, scales, quats, opacities, scal) -> torch.Tensor:
    """Plain PyTorch version of K1: (9, N) f32 planes (mx, my, conic a/b/c,
    depth, radius, rx, ry)."""
    cov = _cov3d_math(scales[:, 0], scales[:, 1], scales[:, 2],
                      quats[:, 0], quats[:, 1], quats[:, 2], quats[:, 3])
    return torch.stack(_project_math(means[:, 0], means[:, 1], means[:, 2],
                                     *cov, opacities, scal))


def _check_arg(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def _project_k1(means, scales, quats, opacities, scal) -> torch.Tensor:
    """K1 wrapper: (9, N) f32 projection planes. CPU tensors take the plain
    version; CUDA tensors launch the kernel (or raise)."""
    dev = means.device
    if dev.type == "cpu":
        return _project_plain(means, scales, quats, opacities, scal)
    if dev.type != "cuda":
        raise ValueError(f"K1 projection: unsupported device {dev}")
    n = means.shape[0]
    _check_arg(means, "means", _F32, (n, 3), dev)
    _check_arg(scales, "scales", _F32, (n, 3), dev)
    _check_arg(quats, "quats", _F32, (n, 4), dev)
    _check_arg(opacities, "opacities", _F32, (n,), dev)
    _check_arg(scal, "scal", _F32, (24,), dev)
    out = torch.empty((9, n), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().gs_project(
            means.data_ptr(), scales.data_ptr(), quats.data_ptr(),
            opacities.data_ptr(), scal.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K1 projection")
    _cuda.launches["k1_project"] += 1
    return out


def _splats(planes, colors, opacities) -> ProjectedSplats:
    return ProjectedSplats(
        mean2d=planes[0:2].T, conic=planes[2:5].T, depth=planes[5],
        radius=planes[6].to(_I32), color=colors, opacity=opacities,
        ext=planes[7:9].T.to(_I32))


def project_gaussians(means, scales, quats, opacities, colors,
                      view, proj, width: int, height: int,
                      near: float = 0.05,
                      max_radius: float | None = None,
                      ky: int = KY) -> ProjectedSplats:
    """EWA splat projection through the plain PyTorch path (the
    differentiable one) under the ``rmath.look_at_zforward`` +
    ``rmath.perspective`` camera conventions."""
    if max_radius is None:
        max_radius = level1_max_radius(ky)
    scal = _project_scalars(view, proj, width, height, near,
                            float(max_radius))
    return _splats(_project_plain(means, scales, quats, opacities, scal),
                   colors, opacities)


def _project_fast(means, scales, quats, opacities, colors, view, proj,
                  width: int, height: int, near: float = 0.05,
                  max_radius: float | None = None, ky: int = KY,
                  interpret: bool = False) -> ProjectedSplats:
    """The render path's projection: kernel K1 on CUDA tensors.
    ``interpret`` is accepted for signature parity and ignored."""
    if max_radius is None:
        max_radius = level1_max_radius(ky)
    scal = _project_scalars(view, proj, width, height, near,
                            float(max_radius))
    return _splats(_project_k1(means, scales, quats, opacities, scal),
                   colors, opacities)


def _make_records(ps: ProjectedSplats) -> torch.Tensor:
    """(N, 12) f32 splat records, one row per splat; culled splats carry
    opacity 0."""
    n = ps.depth.shape[0]
    rec = torch.zeros((n, _ROWS), dtype=_F32, device=ps.depth.device)
    rec[:, _MX:_MY + 1] = ps.mean2d
    rec[:, _CA:_CC + 1] = ps.conic
    rec[:, _OP] = ps.opacity * torch.isfinite(ps.depth).to(_F32)
    rec[:, _CR:_CB2 + 1] = ps.color
    return rec


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def _quantize_depth(depth, valid, db: int):
    """Depth → int32 in [0, 2^db - 1] over the frame's valid [dmin, dmax].
    ``db`` ≤ 22 keeps the f32 product integer-exact (2^22 < 2^24), so the
    deepest splat never rounds up into the tile bits."""
    qmax = (1 << db) - 1
    dfin = torch.where(valid, depth, math.inf)
    dmin = torch.min(dfin)
    dmax = torch.max(torch.where(valid, depth, -math.inf))
    dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
    span = torch.clamp(dmax - dmin, min=1e-9)
    qd = torch.clamp((dfin - dmin) / span * qmax, 0.0, float(qmax))
    qd = torch.clamp(qd.to(_I32), 0, qmax)
    return torch.where(valid, qd, 0)


def _emit_fan(mx, my, rx, ry, r, valid, qd, kx_fan: int, ky_fan: int,
              ntx: int, nty: int, db: int, tile_w: int = TILE_W):
    """Candidate ``tile << db | qdepth`` keys of a kx_fan×ky_fan tile fan
    over the footprint's per-axis bbox, minus span tiles the circumscribed
    circle misses. Returns a list of (N,) int32 key streams; culled
    candidates hold the sentinel key ``ntiles << db``."""
    sentinel = (ntx * nty) << db
    tx0 = torch.floor((mx - rx) / tile_w).to(_I32).clamp(0, ntx - 1)
    tx1 = torch.floor((mx + rx) / tile_w).to(_I32).clamp(0, ntx - 1)
    ty0 = torch.floor((my - ry) / TILE_H).to(_I32).clamp(0, nty - 1)
    ty1 = torch.floor((my + ry) / TILE_H).to(_I32).clamp(0, nty - 1)
    r2 = r * r
    keys = []
    for dy in range(ky_fan):
        for dx in range(kx_fan):
            ty = ty0 + dy
            tx = tx0 + dx
            ok = valid & (ty <= ty1) & (tx <= tx1)
            rx0 = (tx * tile_w).to(_F32)
            ry0 = (ty * TILE_H).to(_F32)
            ddx = torch.clamp(torch.maximum(rx0 - mx, mx - (rx0 + tile_w)),
                              min=0.0)
            ddy = torch.clamp(torch.maximum(ry0 - my, my - (ry0 + TILE_H)),
                              min=0.0)
            ok &= ddx * ddx + ddy * ddy <= r2
            keys.append(torch.where(ok, ((ty * ntx + tx) << db) | qd,
                                    sentinel).to(_I32))
    return keys


def _pool3(a, nty: int, ntx: int):
    """3×3 max over the tile grid with edge replication, flattened."""
    g = a.reshape(nty, ntx)
    ri = torch.arange(nty, device=a.device)
    ci = torch.arange(ntx, device=a.device)
    out = None
    for d in (-1, 0, 1):
        rows = g[(ri + d).clamp(0, nty - 1)]
        for e in (-1, 0, 1):
            v = rows[:, (ci + e).clamp(0, ntx - 1)]
            out = v if out is None else torch.maximum(out, v)
    return out.reshape(-1)


def _pool_grant(floor, desired, pool_pairs: int):
    """Floor-guaranteed proportional pool allocation (pre-snap): every tile
    first receives its floor (scaled down only if the floors alone
    oversubscribe the pool), and the surplus funds the extra above it
    proportionally. Same f32 operands and order as the JAX version."""
    fsum = floor.sum().to(_F32)
    pool = torch.full((), pool_pairs, dtype=_F32, device=floor.device)
    fscale = torch.clamp(pool / torch.clamp(fsum, min=1.0), max=1.0)
    floor = torch.minimum((floor.to(_F32) * fscale).to(_I32), floor)
    extra = desired - floor
    spare = (pool_pairs - floor.sum()).to(_F32)
    escale = torch.clamp(spare / torch.clamp(extra.sum(), min=1).to(_F32),
                         0.0, 1.0)
    return floor + (extra.to(_F32) * escale).to(_I32)


def _block_snap(kept, desired, cap_steps: int, ntiles: int):
    """Largest-remainder snap of pair grants to whole CHUNK-row blocks, so
    that sum(ceil(kept/CHUNK)) ≤ cap_steps. Tiles whose whole grant is
    sub-block sort first, then the largest remainders round up. The
    argsort must be stable, as ``jnp.argsort`` is, or ties hand blocks to
    other tiles."""
    kq = (kept // CHUNK) * CHUNK
    rem = kept - kq
    must = (kq == 0) & (kept > 0)
    nup = cap_steps - kq.sum() // CHUNK
    prio = torch.where(must, rem + CHUNK, torch.where(rem > 0, rem, -1))
    order = torch.argsort(-prio, stable=True)
    rank = torch.empty_like(order)
    rank[order] = torch.arange(ntiles, device=kept.device)
    bonus = (rank < nup) & (prio > 0)
    return torch.where(bonus, torch.minimum(desired, kq + CHUNK), kq)


def _aligned_pack_idx(startc, kept, cap_steps: int, sorted_splat):
    """Aligned LOD layout: tile t's kept list starts at its own 128-row
    block boundary ``blk_off[t] * CHUNK`` of the packed array, so a block
    belongs to one tile. Returns (pack_idx (cap_steps*CHUNK,) splat indices,
    row_begin (ntiles,)). Rows past a tile's kept list point at splat 0 and
    are never read."""
    dev = kept.device
    ntiles = kept.shape[0]
    nblocks_t = (kept + CHUNK - 1) // CHUNK
    blk_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(nblocks_t, 0)])
    p = torch.arange(cap_steps * CHUNK, device=dev)
    owner = (torch.searchsorted(blk_off, p // CHUNK, right=True) - 1) \
        .clamp(0, ntiles - 1)
    j = p - blk_off[owner] * CHUNK
    live = j < kept[owner]
    srow = torch.where(live, startc[owner].to(torch.int64) + j, 0)
    return sorted_splat[srow], blk_off[:-1] * CHUNK


class Binned(NamedTuple):
    pack_idx: torch.Tensor    # (R,) splat index of each packed row
    row_begin: torch.Tensor   # (ntiles,) i32 first packed row of each tile
    row_end: torch.Tensor     # (ntiles,) i32 one past its last kept row
    visited: torch.Tensor     # (ntiles,) bool: kept > 0
    overflow: torch.Tensor    # () dropped pairs
    kept: torch.Tensor        # (ntiles,) i32 pairs kept
    count: torch.Tensor       # (ntiles,) i32 pairs emitted


def _bin_splats(mx, my, rad, valid, depth, ntx: int, nty: int,
                cap_pairs: int, ky: int = KY,
                max_per_tile: int | None = None, budget=None,
                tile_w: int = TILE_W, nseg: int = 1, ext=None) -> Binned:
    """Per-tile front-to-back pair lists from ONE sort of the combined
    ``tile << db | qdepth`` keys.

    * exact (``max_per_tile=None``): the packed array is the sorted pair
      order itself; pairs past ``cap_pairs`` are dropped positionally.
      ``cap_pairs`` is rounded to ``CHUNK * nseg`` rows as the JAX layout
      rounds it, so ``nseg`` (``exact_seg``) matters only when the cap binds.
    * LOD (``max_per_tile=m``): each tile desires its list up to a depth
      cut (its m-th pair's depth, or its ``budget``), 3×3-max-pooled over
      the tile grid and capped at ``LOD_DESIRE_CAP*m``; a global pool of
      ``ceil(ntiles*m/CHUNK)`` blocks is granted floor-first then
      proportionally, and snapped to whole blocks. A (ntiles, 2)
      ``budget`` carries the dry-need channel of :func:`update_lod_budget`.
    """
    n = mx.shape[0]
    dev = mx.device
    ntiles = ntx * nty
    r = rad.to(_F32)
    if ext is not None:
        rx, ry = ext[:, 0].to(_F32), ext[:, 1].to(_F32)
    else:
        rx = ry = r

    tile_bits = max(ntiles.bit_length(), 1)   # ids 0..ntiles-1 + sentinel
    db = min(31 - tile_bits, 22)
    qd = _quantize_depth(depth, valid, db)
    keys = _emit_fan(mx, my, rx, ry, r, valid, qd, KX, ky, ntx, nty, db,
                     tile_w)
    key_flat = torch.cat(keys)
    m = key_flat.shape[0]
    sorted_key, perm = torch.sort(key_flat, stable=True)
    sorted_splat = perm % n          # key streams are concatenated per slot

    tvec = torch.arange(ntiles + 1, dtype=_I32, device=dev)
    start = torch.searchsorted(sorted_key, tvec << db, out_int32=True)
    startc = start[:-1]
    count = start[1:] - startc
    if max_per_tile is not None:
        qmask = (1 << db) - 1
        dry_need = None
        if budget is not None and budget.ndim == 2:
            budget, dry_need = budget[:, 0], budget[:, 1]
        if budget is None:
            nthr = torch.clamp(count, max=max_per_tile)
        else:
            nthr = torch.minimum(count, budget.to(_I32))
        cut_i = torch.clamp(startc + nthr - 1, 0, m - 1)
        cut_qd = torch.where(count > 0, sorted_key[cut_i.long()] & qmask, 0)
        pooled = _pool3(cut_qd, nty, ntx)
        kend = torch.searchsorted(sorted_key, (tvec[:-1] << db) | pooled,
                                  right=True, out_int32=True)
        need = torch.maximum(nthr, kend - startc)
        if dry_need is not None:
            need = torch.maximum(need, torch.minimum(count,
                                                     dry_need.to(_I32)))
        desired = torch.minimum(
            torch.clamp(need, min=0),
            torch.clamp(count, max=LOD_DESIRE_CAP * max_per_tile))
        cap_steps = -(-ntiles * max_per_tile // CHUNK)
        kept = _pool_grant(torch.minimum(nthr, desired), desired,
                           cap_steps * CHUNK)
        kept = _block_snap(kept, desired, cap_steps, ntiles).to(_I32)
        overflow = (count - kept).sum().to(_I32)
        pack_idx, row_begin = _aligned_pack_idx(startc, kept, cap_steps,
                                                sorted_splat)
        row_begin = row_begin.to(_I32)
    else:
        blk = CHUNK * nseg
        mpad = _pad_to(m, blk)
        cap_pairs = min(_pad_to(min(cap_pairs, mpad), blk), mpad)
        overflow = torch.clamp(start[ntiles] - cap_pairs, min=0)
        kept = torch.clamp(torch.minimum(count, cap_pairs - startc),
                           min=0).to(_I32)
        pack_idx = sorted_splat[:min(cap_pairs, m)]
        row_begin = startc
    return Binned(pack_idx=pack_idx, row_begin=row_begin.contiguous(),
                  row_end=(row_begin + kept).contiguous(),
                  visited=kept > 0, overflow=overflow, kept=kept,
                  count=count)


def _pack_records(records: torch.Tensor, pack_idx: torch.Tensor):
    """One row gather of the (N, 12) records into packed order."""
    return records[pack_idx]


# ---------------------------------------------------------------------------
# K2: composite
# ---------------------------------------------------------------------------

def _composite_plain(records, row_begin, row_end, ntx: int, nty: int,
                     tile_w: int = TILE_W):
    """Plain PyTorch version of K2. Returns (planes (4, ntiles, 32*tile_w)
    f32 = r, g, b, T; exec (ntiles,) i32).

    Tile t composites packed rows [row_begin[t], row_end[t]) front to back,
    in chunks cut at absolute multiples of CHUNK rows; after each chunk the
    tile stops if every one of its pixels has T < _T_EPS, and ``exec``
    counts the rows of every chunk that ran. Chunks of all running tiles go
    in parallel; inside a chunk the transmittance prefix is a ``cumprod``
    (the kernel's running product, reassociated)."""
    dev = records.device
    ntiles = ntx * nty
    pix = TILE_H * tile_w
    nrows = records.shape[0]
    tid = torch.arange(ntiles, device=dev)
    i = torch.arange(pix, device=dev)
    shift = tile_w.bit_length() - 1
    px = ((i & (tile_w - 1))[None] + ((tid % ntx) * tile_w)[:, None]) \
        .to(_F32) + 0.5
    py = ((i >> shift)[None] + ((tid // ntx) * TILE_H)[:, None]) \
        .to(_F32) + 0.5
    rgb = torch.zeros((3, ntiles, pix), dtype=_F32, device=dev)
    tt = torch.ones((ntiles, pix), dtype=_F32, device=dev)
    exec_ = torch.zeros(ntiles, dtype=_I32, device=dev)
    begin = row_begin.long()
    end = torch.clamp(row_end.long(), max=nrows)
    first = (begin // CHUNK) * CHUNK
    nch = torch.where(end > begin, (end - first + CHUNK - 1) // CHUNK, 0)
    running = nch > 0
    group = max(1, (1 << 25) // (CHUNK * pix))   # bounds the temporaries
    rows = torch.arange(CHUNK, device=dev)
    nmax = int(nch.max()) if ntiles else 0
    for j in range(nmax):
        act = torch.nonzero(running & (nch > j)).flatten()
        if act.numel() == 0:
            break
        for s in range(0, act.numel(), group):
            g = act[s:s + group]
            idx = (first[g] + j * CHUNK)[:, None] + rows[None]   # (G, C)
            live = (idx >= begin[g][:, None]) & (idx < end[g][:, None])
            rec = records[idx.clamp(0, max(nrows - 1, 0))]      # (G, C, 12)

            def col(c):
                return rec[:, :, c, None]                         # (G, C, 1)
            dx = px[g][:, None, :] - col(_MX)
            dy = py[g][:, None, :] - col(_MY)
            power = (-0.5 * (col(_CA) * dx * dx + col(_CC) * dy * dy)
                     - col(_CB) * dx * dy)
            alpha = torch.clamp(col(_OP) * torch.exp(power), max=_ALPHA_MAX)
            alpha = torch.where(live[:, :, None] & (alpha >= _ALPHA_MIN),
                                alpha, 0.0)
            incl = torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
            t_in = tt[g]
            w = alpha * excl * t_in[:, None, :]
            rgb[:, g] += torch.einsum("gcr,gcp->rgp",
                                      rec[:, :, _CR:_CB2 + 1], w)
            t_new = t_in * incl[:, -1]
            tt[g] = t_new
            exec_[g] += live.sum(1).to(_I32)
            running[g] = t_new.amax(1) >= _T_EPS
    return torch.stack([rgb[0], rgb[1], rgb[2], tt]), exec_


def _composite_call(records, row_begin, row_end, ntx: int, nty: int,
                    tile_w: int = TILE_W):
    """K2 wrapper: (planes (4, ntiles, 32*tile_w) f32, exec (ntiles,) i32),
    initialised for every tile. CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    dev = records.device
    if dev.type == "cpu":
        return _composite_plain(records, row_begin, row_end, ntx, nty,
                                tile_w)
    if dev.type != "cuda":
        raise ValueError(f"K2 composite: unsupported device {dev}")
    if tile_w not in (32, 64, 128):
        raise ValueError(f"K2 composite: tile_w {tile_w} not in 32/64/128")
    ntiles = ntx * nty
    _check_arg(records, "records", _F32, (records.shape[0], _ROWS), dev)
    _check_arg(row_begin, "row_begin", _I32, (ntiles,), dev)
    _check_arg(row_end, "row_end", _I32, (ntiles,), dev)
    planes = torch.empty((4, ntiles, TILE_H * tile_w), dtype=_F32,
                         device=dev)
    exec_ = torch.empty(ntiles, dtype=_I32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().gs_composite(
            records.data_ptr(), records.shape[0], row_begin.data_ptr(),
            row_end.data_ptr(), planes.data_ptr(), exec_.data_ptr(), ntiles,
            ntx, tile_w, torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K2 composite")
    _cuda.launches["k2_composite"] += 1
    return planes, exec_


# ---------------------------------------------------------------------------
# finalize + render
# ---------------------------------------------------------------------------

def _untile(plane, nty: int, ntx: int, tile_w: int = TILE_W):
    """(ntiles, 32*tile_w) tile-flattened → (nty*32, ntx*tile_w) plane."""
    t = plane[:nty * ntx].reshape(nty, ntx, TILE_H, tile_w)
    return t.permute(0, 2, 1, 3).reshape(nty * TILE_H, ntx * tile_w)


def finalize_planes(planes, visited, nty: int, ntx: int, background,
                    tile_w: int = TILE_W) -> torch.Tensor:
    """Mask never-visited tiles to background (T = 1), untile the planes
    and blend the background through the remaining transmittance →
    (nty*32, ntx*tile_w, 3). Only the no-tail branch of the JAX function
    is ported."""
    vis = visited[:, None]
    r, g, b, t = planes
    rgb = torch.stack([_untile(torch.where(vis, p, 0.0), nty, ntx, tile_w)
                       for p in (r, g, b)], -1)
    tt = _untile(torch.where(vis, t, 1.0), nty, ntx, tile_w)
    bg = torch.as_tensor(background, dtype=_F32).to(planes.device)
    return rgb + tt[..., None] * bg


class FrameLayout(NamedTuple):
    """A frame's composite input: packed records and per-tile row ranges."""
    records: torch.Tensor     # (R, 12) f32 packed records
    binned: Binned
    ntx: int
    nty: int
    tile_w: int


def _on(x, dev, name: str) -> torch.Tensor:
    """``x`` as an f32/int tensor on the cloud's device: array-likes are
    placed there, a tensor on another device is refused."""
    if isinstance(x, torch.Tensor):
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, the cloud on {dev}")
        return x
    return torch.from_numpy(np.array(x)).to(dev)


def _frame_layout(cloud, view, proj, width: int, height: int, *,
                  pairs_cap_factor: int | None = None, ky: int = KY,
                  max_splats_per_tile: int | None = None, lod_budget=None,
                  tile_w: int = TILE_W, exact_seg: int = 8) -> FrameLayout:
    """Project (K1), bin and pack one frame: everything before K2."""
    dev = cloud.means.device
    view = _on(view, dev, "view").to(_F32)
    proj = _on(proj, dev, "proj").to(_F32)
    ps = _project_fast(cloud.means, cloud.scales, cloud.quats,
                       cloud.opacities, cloud.colors, view, proj,
                       width, height, ky=ky)
    records = _make_records(ps)
    ntx, nty = num_tiles(width, height, tile_w)
    n = cloud.num_splats
    ntiles = ntx * nty
    exact_cap = n * KX * ky + ntiles * CHUNK
    if pairs_cap_factor is None:
        cap_pairs = exact_cap
    else:
        cap_pairs = min(exact_cap, max(pairs_cap_factor * n, 4 * CHUNK)
                        + ntiles * CHUNK)
    cap_pairs = _pad_to(cap_pairs, CHUNK)
    if lod_budget is not None:
        lod_budget = _on(lod_budget, dev, "lod_budget")
    binned = _bin_splats(ps.mean2d[:, 0], ps.mean2d[:, 1], ps.radius,
                         torch.isfinite(ps.depth), ps.depth, ntx, nty,
                         cap_pairs, ky=ky, max_per_tile=max_splats_per_tile,
                         budget=lod_budget, tile_w=tile_w, nseg=exact_seg,
                         ext=ps.ext)
    return FrameLayout(records=_pack_records(records, binned.pack_idx),
                       binned=binned, ntx=ntx, nty=nty, tile_w=tile_w)


def render_gaussians(cloud, view, proj, width: int, height: int,
                     background=(0.0, 0.0, 0.0),
                     pairs_cap_factor: int | None = None,
                     cam_pos=None,
                     ky: int = KY,
                     max_splats_per_tile: int | None = None,
                     big_splat_cap: int | None = None,
                     mid_splat_cap: int | None = None,
                     mid_lo_splat_cap: int | None = None,
                     corner_cap: int | None = None,
                     lod_budget=None,
                     lod_tail: bool = False,
                     lod_tail_decim: int | None = None,
                     lod_tail_d: int | None = None,
                     return_stats: bool = False,
                     interpret: bool = False,
                     tile_w: int = TILE_W,
                     payload_sort: bool = True,
                     exact_seg: int = 8,
                     lod_seg: int = 1):
    """Render a ``GaussianCloud`` → (height, width, 3) f32 linear image on
    the cloud's device (K1 and K2 on CUDA, their plain versions on CPU).

    The signature is the JAX ``render_gaussians``'s. Ported: exact mode
    (``max_splats_per_tile=None``, ``pairs_cap_factor`` positional cap) and
    the LOD pool with temporal ``lod_budget`` (see :func:`_bin_splats`).
    ``payload_sort``, ``lod_seg`` and ``interpret`` do not change the
    output and are ignored; ``exact_seg`` only rounds the exact-mode pair
    cap, as in the JAX layout. The side channels (``big_splat_cap``,
    ``mid_splat_cap``, ``mid_lo_splat_cap``, ``corner_cap``), ``lod_tail``,
    ``lod_tail_decim`` and SH colours (``cam_pos`` with ``sh_rest``) raise
    ``NotImplementedError``.

    ``return_stats=True`` also returns ``overflow_pairs``,
    ``overflow_big_splats``, ``tile_exec`` (rows composited before
    saturation, 0 for unvisited tiles), ``tile_kept``, ``tile_count`` and
    the ``lossless`` certificate."""
    if mid_splat_cap is not None and big_splat_cap is None:
        raise ValueError("mid_splat_cap requires big_splat_cap")
    if mid_lo_splat_cap is not None and mid_splat_cap is None:
        raise ValueError("mid_lo_splat_cap requires mid_splat_cap")
    if lod_tail_decim is not None and max_splats_per_tile is None:
        raise ValueError("lod_tail_decim requires max_splats_per_tile")
    unported = {"big_splat_cap": big_splat_cap is not None,
                "mid_splat_cap": mid_splat_cap is not None,
                "mid_lo_splat_cap": mid_lo_splat_cap is not None,
                "corner_cap": corner_cap is not None,
                "lod_tail": bool(lod_tail),
                "lod_tail_decim": lod_tail_decim is not None,
                "cam_pos with sh_rest": (cam_pos is not None
                                         and cloud.sh_rest is not None)}
    for name, on in unported.items():
        if on:
            raise NotImplementedError(f"{name} is not ported yet")

    lay = _frame_layout(cloud, view, proj, width, height,
                        pairs_cap_factor=pairs_cap_factor, ky=ky,
                        max_splats_per_tile=max_splats_per_tile,
                        lod_budget=lod_budget, tile_w=tile_w,
                        exact_seg=exact_seg)
    b = lay.binned
    planes, texec = _composite_call(lay.records, b.row_begin, b.row_end,
                                    lay.ntx, lay.nty, tile_w)
    img = finalize_planes(planes, b.visited, lay.nty, lay.ntx, background,
                          tile_w)[:height, :width]
    if not return_stats:
        return img
    tile_exec = torch.where(b.visited, texec, 0)
    overflow_big = torch.zeros((), dtype=_I32, device=img.device)
    if max_splats_per_tile is not None:
        # certificate: every truncated tile saturated strictly inside its
        # kept list, so every dropped pair lies behind T < _T_EPS
        dry = (b.kept < b.count) & (tile_exec >= b.kept) & (b.count > 0)
        lossless = (~torch.any(dry)) & (overflow_big == 0)
    else:
        lossless = (b.overflow == 0) & (overflow_big == 0)
    stats = {"overflow_pairs": b.overflow,
             "overflow_big_splats": overflow_big,
             "tile_exec": tile_exec,
             "tile_kept": b.kept, "tile_count": b.count,
             "lossless": lossless}
    return img, stats


def update_lod_budget(tile_exec, max_splats_per_tile: int,
                      ntx: int, nty: int,
                      tile_kept=None, tile_count=None,
                      dry_floor: str = "jump"):
    """Next-frame per-tile LOD budget from this frame's executed depth:
    3×3-max-pooled, grown 1.5x + one chunk, clamped to [CHUNK,
    LOD_DESIRE_CAP·mpt]. With ``tile_kept``/``tile_count``, tiles that ran
    dry (exec ≥ kept < count) get a floor treatment (``"jump"``:
    min(count, _DRY_FLOOR_CAP·mpt); ``"static"``: back to mpt) and their
    full count in a second dry-need channel → (ntiles, 2) int32."""
    cap = LOD_DESIRE_CAP * max_splats_per_tile
    b = (_pool3(tile_exec, nty, ntx).to(_F32) * 1.5).to(_I32) + CHUNK
    b = torch.clamp(b, CHUNK, cap)
    if tile_kept is None or tile_count is None:
        return b
    e = tile_exec.to(_I32)
    dry = (tile_kept > 0) & (e >= tile_kept) & (tile_kept < tile_count)
    if dry_floor == "static":
        b = torch.where(dry, max_splats_per_tile, b)
    else:
        jump = torch.clamp(tile_count, max=_DRY_FLOOR_CAP * max_splats_per_tile)
        b = torch.maximum(b, torch.where(dry, jump, 0))
    need = torch.clamp(torch.where(dry, tile_count, 0), 0, cap)
    return torch.stack([b, need], -1).to(_I32)
