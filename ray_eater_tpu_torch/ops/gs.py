"""3D Gaussian Splatting render path in PyTorch + CUDA (counterpart of
``ray_eater_tpu/ops/gs.py``).

One frame runs:

1. **Project** — kernel K1 (``csrc/gs_project.cu``): EWA projection of every
   splat, one thread per splat (:func:`_project_fast`).
2. **Bin** — PyTorch ops: each splat emits candidate ``tile << db | qdepth``
   keys through the level-1 fan (or the 2-slot fan plus a budgeted corner
   channel), and splats too large for it through budgeted mid-lo, mid and
   coarse side-channel fans; one sort groups all pairs into per-tile runs
   that are front-to-back within each run. Exact mode keeps every pair (up
   to the positional ``cap_pairs`` drop); the LOD mode grants each tile a
   block-granular share of a global pool, and optionally a second pool for
   the decimated tail (:func:`_bin_splats`).
3. **Pack** — one row gather of the (N, 12) record table into packed order
   (and one for the tail rows).
4. **Composite** — kernel K2 (``csrc/gs_composite.cu``): one CTA per tile
   walks the tile's packed rows front to back, with tile-level saturation
   checked at 128-row chunk ends (:func:`_composite_call`).
5. **Tail** — kernel K3 (same source): the tail rows composited on a
   decim×decim-decimated grid, entered at the head's per-quad mean
   transmittance (:func:`_composite_tail_call`).
6. **Finalize** — mask unvisited tiles, untile, add the bilinearly
   upsampled tail, blend the background.

Training (:func:`render_gaussians_diff`) differentiates the plain
projection, bins in LOD mode on detached inputs, and composites through
:func:`composite_diff`: kernel K4 (``csrc/gs_composite.cu``, K2 plus the
transmittance at the entry of every chunk it runs) forward and kernel K5
(``csrc/gs_composite_bwd.cu``, one front-to-back walk per tile) backward.

The float32 arithmetic of every step that feeds an integer (radii, tile
spans, depth keys, pool grants, the tail proxy's quantised aux) keeps the
JAX package's operands and order, so the two packages bin the same pairs.
Each kernel has a plain PyTorch version here and is a ``torch.library``
custom op (``rayeater::k1_project`` .. ``k5_composite_bwd``): its wrapper
runs the plain version only for CPU tensors.

Everything ``render_gaussians`` takes is ported: exact and LOD modes, the
side channels, the decimated tail, the ``lod_tail`` slab proxy
(:func:`_pack_tail_aux`, :func:`_tail_sums`) and view-dependent SH
colours.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.gaussians import eval_sh_colors
from ..utils import on_device
from ..utils import pad_to as _pad_to
from . import _cuda

TILE_H = 32
TILE_W = 128
CHUNK = 128      # rows of a composite chunk; saturation is checked per chunk
KX = 2           # max horizontal tile span per splat
KY = 2           # default max vertical tile span per splat
KY2 = 8          # coarse (level-2) fan: vertical span, 111 px radius ceiling
KX2 = 3          # its horizontal span at 128-wide tiles (see _kx2)
KY_M = 4         # mid fan vertical span: 47 px radius ceiling
KY_ML = 3        # mid-lo fan vertical span: 31 px radius ceiling
#: decimation factor of the decimated-tail composite when the call does not
#: give ``lod_tail_d``
_TAIL_D = 2
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


def _fan_limits(kx: int, ky: int, tile_w: int) -> tuple[int, int]:
    """(rx_max, ry_max): the largest per-axis extents whose [m-r, m+r] span
    fits in a kx×ky tile fan."""
    return (kx - 1) * tile_w // 2 - 1, (ky - 1) * TILE_H // 2 - 1


def level1_max_radius(ky: int = KY, tile_w: int = TILE_W) -> int:
    """Largest radius whose [m-r, m+r] span fits in KX×ky tiles."""
    return min(_fan_limits(KX, ky, tile_w))


def _fan_kx(ky_fan: int, tile_w: int) -> int:
    """Horizontal slot count of a side-channel fan ky_fan tiles tall, chosen
    so that its radius ceiling stays vertical-bound whatever ``tile_w``."""
    rv = _fan_limits(1, ky_fan, tile_w)[1]
    return -(-2 * (rv + 1) // tile_w) + 1


def _kx2(tile_w: int) -> int:
    """Slots across the coarse (level-2) fan: 3 at 128-wide tiles, 5 at 64,
    8 at 32."""
    return _fan_kx(KY2, tile_w)


def level2_max_radius(tile_w: int = TILE_W) -> int:
    """Radius ceiling of the coarse _kx2×KY2 fan (two-level binning)."""
    return min(_fan_limits(_kx2(tile_w), KY2, tile_w))


def _kxm(tile_w: int) -> int:
    """Slots across the mid fan."""
    return _fan_kx(KY_M, tile_w)


def _kxml(tile_w: int) -> int:
    """Slots across the mid-lo fan."""
    return _fan_kx(KY_ML, tile_w)


def level_mid_max_radius(tile_w: int = TILE_W) -> int:
    """Radius ceiling of the mid _kxm×KY_M fan (three-level binning)."""
    return min(_fan_limits(_kxm(tile_w), KY_M, tile_w))


def level_midlo_max_radius(tile_w: int = TILE_W) -> int:
    """Radius ceiling of the mid-lo _kxml×KY_ML fan (four-level binning
    via ``mid_lo_cap``)."""
    return min(_fan_limits(_kxml(tile_w), KY_ML, tile_w))


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
    tail = on_device([width, height, near, max_radius, 0, 0, 0, 0],
                     view.device)
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


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """(N, 4) wxyz quaternions → (N, 3, 3) rotation matrices."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True).clamp(min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], -2)


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
    # the integer radii take no gradient (JAX's ceil gives a symbolic zero);
    # from detached operands, so autograd never meets sqrt'(0) = inf where
    # mid² = det (a circular footprint), which would turn the zero into NaN
    ad, cd, detd, opd = a.detach(), c.detach(), det.detach(), op.detach()
    mid = 0.5 * (ad + cd)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - detd, min=0.0))
    scut = torch.clamp(torch.sqrt(torch.clamp(
        2.0 * torch.log(torch.clamp(opd, min=_ALPHA_MIN) * (1.0 / _ALPHA_MIN)),
        min=1e-6)), max=3.0)
    radius = torch.ceil(scut * torch.sqrt(torch.clamp(lam_max, min=0.0)))
    radius = torch.minimum(radius, max_radius)
    rx = torch.minimum(torch.ceil(scut * torch.sqrt(torch.clamp(ad, min=0.0))),
                       radius)
    ry = torch.minimum(torch.ceil(scut * torch.sqrt(torch.clamp(cd, min=0.0))),
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


def _project_fake(means, scales, quats, opacities, scal):
    return means.new_empty((9, means.shape[0]))


@_cuda.kernel_op("k1_project", _project_plain, _project_fake)
def _k1_op(means: torch.Tensor, scales: torch.Tensor, quats: torch.Tensor,
           opacities: torch.Tensor, scal: torch.Tensor) -> torch.Tensor:
    """K1's launch: (9, N) f32 projection planes."""
    dev = _cuda.cuda_device(means, "K1 projection")
    n = means.shape[0]
    _cuda.check_arg(means, "means", _F32, (n, 3), dev)
    _cuda.check_arg(scales, "scales", _F32, (n, 3), dev)
    _cuda.check_arg(quats, "quats", _F32, (n, 4), dev)
    _cuda.check_arg(opacities, "opacities", _F32, (n,), dev)
    _cuda.check_arg(scal, "scal", _F32, (24,), dev)
    out = torch.empty((9, n), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().gs_project(
            means.data_ptr(), scales.data_ptr(), quats.data_ptr(),
            opacities.data_ptr(), scal.data_ptr(), out.data_ptr(), n,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K1 projection")
    _cuda.launches["k1_project"] += 1
    return out


def _project_k1(means, scales, quats, opacities, scal) -> torch.Tensor:
    """K1 wrapper (the op ``rayeater::k1_project``): (9, N) f32
    projection planes. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise)."""
    _cuda.op_device(means, "K1 projection")
    return _k1_op(means, scales, quats, opacities, scal)


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

def _quantize_depth(depth, valid, db: int, depth_range=None):
    """Depth → int32 in [0, 2^db - 1] over the frame's valid [dmin, dmax]
    (or over ``depth_range`` = (dmin, dmax), 0-d tensors, when given).
    ``db`` ≤ 22 keeps the f32 product integer-exact (2^22 < 2^24), so the
    deepest splat never rounds up into the tile bits."""
    qmax = (1 << db) - 1
    dfin = torch.where(valid, depth, math.inf)
    if depth_range is None:
        dmin = torch.min(dfin)
        dmax = torch.max(torch.where(valid, depth, -math.inf))
        dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
    else:
        dmin, dmax = depth_range
    span = torch.clamp(dmax - dmin, min=1e-9)
    qd = torch.clamp((dfin - dmin) / span * qmax, 0.0, float(qmax))
    qd = torch.clamp(qd.to(_I32), 0, qmax)
    return torch.where(valid, qd, 0)


def _tile_span(mx, my, rx, ry, ntx: int, nty: int, tile_w: int):
    """(tx0, tx1, ty0, ty1) int32: the tiles under the per-axis bbox."""
    tx0 = torch.floor((mx - rx) / tile_w).to(_I32).clamp(0, ntx - 1)
    tx1 = torch.floor((mx + rx) / tile_w).to(_I32).clamp(0, ntx - 1)
    ty0 = torch.floor((my - ry) / TILE_H).to(_I32).clamp(0, nty - 1)
    ty1 = torch.floor((my + ry) / TILE_H).to(_I32).clamp(0, nty - 1)
    return tx0, tx1, ty0, ty1


def _emit_fan(mx, my, rx, ry, r, valid, qd, kx_fan: int, ky_fan: int,
              ntx: int, nty: int, db: int, tile_w: int = TILE_W):
    """Candidate ``tile << db | qdepth`` keys of a kx_fan×ky_fan tile fan
    over the footprint's per-axis bbox, minus span tiles the circumscribed
    circle misses. Returns a list of (N,) int32 key streams; culled
    candidates hold the sentinel key ``ntiles << db``."""
    sentinel = (ntx * nty) << db
    tx0, tx1, ty0, ty1 = _tile_span(mx, my, rx, ry, ntx, nty, tile_w)
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


def _emit_pair(mx, my, rx, ry, valid, qd, ntx: int, nty: int, db: int,
               tile_w: int):
    """Two-slot fan for splats whose bbox crosses at most one tile grid
    line: slot 0 is the home tile (tx0, ty0), slot 1 the one crossed
    neighbour. No circle cull: an ellipse whose bbox crosses one line
    within its row or column band overlaps the neighbour on that axis.
    Splats crossing both a vertical and a horizontal line go to the corner
    channel (``corner_cap``)."""
    sentinel = (ntx * nty) << db
    tx0, tx1, ty0, ty1 = _tile_span(mx, my, rx, ry, ntx, nty, tile_w)
    cx = (tx1 > tx0).to(_I32)
    cy = (ty1 > ty0).to(_I32)
    home = ty0 * ntx + tx0
    k0 = torch.where(valid, (home << db) | qd, sentinel).to(_I32)
    other = (ty0 + cy) * ntx + (tx0 + cx)
    ok1 = valid & ((cx + cy) == 1)
    k1 = torch.where(ok1, (other << db) | qd, sentinel).to(_I32)
    return [k0, k1]


def _compact_channel(ch_mask, ch_cap: int):
    """Indices of the first ``ch_cap`` set entries of ``ch_mask`` (N,),
    ascending, from one sort of ``where(mask, iota, N)``. Returns (n_set
    () int, idx (ch_cap,) in [0, N-1], valid (ch_cap,) bool)."""
    n = ch_mask.shape[0]
    dev = ch_mask.device
    iota = torch.arange(n, dtype=_I32, device=dev)
    skey = torch.sort(torch.where(ch_mask, iota, n)).values[:min(ch_cap, n)]
    if ch_cap > n:        # budget exceeds the splat count: pad sentinels
        skey = torch.cat([skey, torch.full((ch_cap - n,), n, dtype=_I32,
                                           device=dev)])
    return (ch_mask.sum().to(_I32), torch.clamp(skey, max=n - 1),
            skey < n)


def _compact_channels(masks, caps):
    """:func:`_compact_channel` for several disjoint masks through one sort:
    the key carries the channel id above the splat index, so channel c's
    indices land contiguously at offset Σ_{j<c} n_j of the sorted keys.
    The sorted keys are padded with ``max(caps)`` sentinels so no channel's
    window runs off the end; a slot is valid only where its channel id
    matches, so reads past a channel's run (into the next channel or the
    padding) are rejected. Returns a list of (n_set, idx, valid)."""
    n = masks[0].shape[0]
    nch = len(masks)
    if nch == 1:
        return [_compact_channel(masks[0], caps[0])]
    dev = masks[0].device
    shift = max(n.bit_length(), 1)
    assert shift + (nch + 1).bit_length() < 31
    iota = torch.arange(n, dtype=_I32, device=dev)
    key = torch.full((n,), nch << shift, dtype=_I32, device=dev)
    for c, m in enumerate(masks):
        key = torch.where(m, (c << shift) | iota, key)
    skey = torch.cat([torch.sort(key).values,
                      torch.full((max(caps),), nch << shift, dtype=_I32,
                                 device=dev)])
    out = []
    off = torch.zeros((), dtype=torch.int64, device=dev)
    for c, (m, cap) in enumerate(zip(masks, caps)):
        head = skey[off + torch.arange(cap, device=dev)]
        vld = (head >> shift) == c
        idx = torch.where(vld, head & ((1 << shift) - 1), 0)
        nset = m.sum()
        out.append((nset.to(_I32), torch.clamp(idx, max=n - 1), vld))
        off = off + nset
    return out


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


# ---------------------------------------------------------------------------
# The LOD tail proxy: a per-splat quantised aux rides the binning sort, and
# the pairs the LOD drops are summed per tile into a homogeneous slab that
# finalize_planes composites behind the kept lists (render_gaussians'
# ``lod_tail``).
# ---------------------------------------------------------------------------

#: aux quantisation: -log1p(-alpha_eff) in 15 bits over [0, _TAIL_LA_MAX]
#: (sqrt domain), RGB as 5:6:5 in the low 16 bits
_TAIL_LA_MAX = 4.0
_TAIL_BS = 512   # block of the tail sums


def _pack_tail_aux(alpha_full, colors, n_pairs, pix: int = TILE_H * TILE_W):
    """Per-splat int32 aux: ``alpha_full`` = op·2π/sqrt(det(conic)) (the
    Gaussian's alpha integral in px²) split evenly among its ``n_pairs``
    emitted tiles and averaged over the tile area ``pix``, as
    la = -log1p(-alpha_eff) quantised to 15 bits in the sqrt domain, above
    the colour as 5:6:5. The JAX ``_pack_tail_aux``, operand for
    operand."""
    a_eff = torch.clamp(alpha_full / (pix * torch.clamp(n_pairs, min=1)
                                      .to(_F32)), 0.0, 0.98)
    la = -torch.log1p(-a_eff)
    q = torch.clamp((torch.sqrt(la / _TAIL_LA_MAX) * 32767.0 + 0.5)
                    .to(_I32), 0, 32767)
    c = torch.clamp(colors, 0.0, 1.0)
    r5 = (c[:, 0] * 31.0 + 0.5).to(_I32)
    g6 = (c[:, 1] * 63.0 + 0.5).to(_I32)
    b5 = (c[:, 2] * 31.0 + 0.5).to(_I32)
    return (q << 16) | (r5 << 11) | (g6 << 5) | b5


def _tail_sums(aux_sorted, lo, hi):
    """Homogeneous-slab sums over the pair ranges [lo, hi) of the sorted
    aux: (4, ntiles) = S_la, S_la·r, S_la·g, S_la·b. As the JAX
    ``_tail_sums``: per-block partial sums of :data:`_TAIL_BS` pairs, an
    exclusive cumsum of the block sums, and the masked remainder of the
    block holding each boundary."""
    sq = ((aux_sorted >> 16) & 0x7fff).to(_F32) * (1.0 / 32767.0)
    la = sq * sq * _TAIL_LA_MAX
    cr = ((aux_sorted >> 11) & 31).to(_F32) * (1.0 / 31.0)
    cg = ((aux_sorted >> 5) & 63).to(_F32) * (1.0 / 63.0)
    cb = (aux_sorted & 31).to(_F32) * (1.0 / 31.0)
    m = aux_sorted.shape[0]
    bs = _TAIL_BS
    stack = torch.stack([la, la * cr, la * cg, la * cb])     # (4, m)
    stack = F.pad(stack, (0, _pad_to(m, bs) - m))
    blocks = stack.reshape(4, -1, bs)
    cumblk = F.pad(torch.cumsum(blocks.sum(-1), 1), (1, 0))   # exclusive
    lane = torch.arange(bs, device=aux_sorted.device)

    def s_excl(p):                                            # (4, nt)
        p = p.long()
        rows = blocks[:, p // bs]                             # (4, nt, bs)
        mask = lane[None] < (p % bs)[:, None]
        return cumblk[:, p // bs] + (rows * mask[None]).sum(-1)

    return s_excl(hi) - s_excl(lo)


class Binned(NamedTuple):
    pack_idx: torch.Tensor    # (R,) splat index of each packed row
    row_begin: torch.Tensor   # (ntiles,) i32 first packed row of each tile
    row_end: torch.Tensor     # (ntiles,) i32 one past its last kept row
    visited: torch.Tensor     # (ntiles,) bool: kept > 0
    overflow: torch.Tensor    # () dropped pairs (behind the tail, if any)
    kept: torch.Tensor        # (ntiles,) i32 pairs kept
    count: torch.Tensor       # (ntiles,) i32 pairs emitted
    overflow_big: torch.Tensor    # () splats the side channels dropped
    # decimated tail (None without ``tail_decim``): its own aligned pack
    pack_idx_tl: torch.Tensor | None = None
    row_begin_tl: torch.Tensor | None = None
    row_end_tl: torch.Tensor | None = None
    kept_tl: torch.Tensor | None = None
    # the lod_tail slab (None without ``tail``): (tail_la (ntiles,),
    # tail_rgb (ntiles, 3)) over each tile's dropped pairs
    tail_slab: tuple | None = None


def _bin_splats(mx, my, rad, valid, depth, ntx: int, nty: int,
                cap_pairs: int, ky: int = KY,
                max_per_tile: int | None = None, budget=None,
                tile_w: int = TILE_W, nseg: int = 1, ext=None,
                big_cap: int | None = None, mid_cap: int | None = None,
                mid_lo_cap: int | None = None,
                corner_cap: int | None = None,
                tail_decim: int | None = None, tail=None,
                depth_range=None) -> Binned:
    """Per-tile front-to-back pair lists from ONE sort of the combined
    ``tile << db | qdepth`` keys.

    * Emission: splats whose per-axis extents fit the KX×ky span take the
      level-1 fan. With ``corner_cap`` (ky = 2) that fan is 2-slot
      (:func:`_emit_pair`) and splats crossing both a vertical and a
      horizontal grid line go to a budgeted 2×2 corner channel. With
      ``big_cap`` the larger splats go, by per-axis extent, to the budgeted
      mid-lo (``mid_lo_cap``), mid (``mid_cap``) and coarse (``big_cap``)
      fans. Each channel keeps its first ``cap`` splats by index
      (:func:`_compact_channels`); the rest are dropped whole and counted
      in ``overflow_big``. Every key stream carries its splat ids through
      the sort.
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
    * tail (``tail_decim=d``, LOD only): a second pool averaging ``d``
      pairs per tile grants each tile the next pairs of its sorted list
      beyond the head grant, granted and snapped the same way, in its own
      aligned pack. ``overflow`` then counts the pairs behind the tail.
    * ``depth_range`` (dmin, dmax): quantise the depth keys over it
      instead of the rows' own valid range (a subset of a frame's splats
      then gets the frame's keys, so its ties break as the frame's do).
    * slab proxy (``tail=(alpha_full (N,), colors (N, 3))``): each key
      carries its splat's :func:`_pack_tail_aux` (split among the splat's
      emitted tiles of its channel) through the sort, and each tile's
      pairs past its head grant, [start + kept, end), are summed by
      :func:`_tail_sums` into ``tail_slab``.
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
    qd = _quantize_depth(depth, valid, db, depth_range)

    # level-1 fan: splats whose per-axis extents fit the KX×ky span (all
    # valid splats without side channels: projection clamped their radii)
    def fits(kx_fan, ky_fan):
        lx, ly = _fan_limits(kx_fan, ky_fan, tile_w)
        return (rx <= lx) & (ry <= ly)

    small = valid if big_cap is None else valid & fits(KX, ky)
    comp = []     # budgeted side channels: (mask, cap, kx, ky)
    if corner_cap is not None and ky == 2 and KX == 2:
        tx0, tx1, ty0, ty1 = _tile_span(mx, my, rx, ry, ntx, nty, tile_w)
        corner = small & (tx1 > tx0) & (ty1 > ty0)
        keys = _emit_pair(mx, my, rx, ry, small & ~corner, qd, ntx, nty,
                          db, tile_w)
        comp.append((corner, corner_cap, KX, ky))
    else:
        keys = _emit_fan(mx, my, rx, ry, r, small, qd, KX, ky, ntx, nty,
                         db, tile_w)
    nl1 = len(keys)
    sentinel = ntiles << db
    pix = TILE_H * tile_w
    auxs = []
    if tail is not None:
        n_pairs = sum((k != sentinel).to(_I32) for k in keys)
        auxs.append(_pack_tail_aux(tail[0], tail[1], n_pairs, pix)
                    .repeat(nl1))
    if big_cap is not None:
        over1 = valid & ~small
        if mid_cap is not None:
            kxm = _kxm(tile_w)
            fits_mid = fits(kxm, KY_M)
            if mid_lo_cap is not None:
                kxl = _kxml(tile_w)
                fits_lo = fits(kxl, KY_ML)
                comp.append((over1 & fits_lo, mid_lo_cap, kxl, KY_ML))
                comp.append((over1 & ~fits_lo & fits_mid, mid_cap, kxm,
                             KY_M))
            else:
                comp.append((over1 & fits_mid, mid_cap, kxm, KY_M))
            comp.append((over1 & ~fits_mid, big_cap, _kx2(tile_w), KY2))
        else:
            comp.append((over1, big_cap, _kx2(tile_w), KY2))
    overflow_big = torch.zeros((), dtype=_I32, device=dev)
    # the splat id of every key, i32: the level-1 slots hold every splat in
    # index order, each channel's slots its compacted indices
    ids = [torch.arange(n, dtype=_I32, device=dev).repeat(nl1)]
    if comp:
        side = torch.stack([mx, my, rx, ry, r, qd.to(_F32)], -1)
        results = _compact_channels([c[0] for c in comp],
                                    [c[1] for c in comp])
        for (_, ch_cap, ch_kx, ch_ky), (nset, bidx, bvalid) \
                in zip(comp, results):
            overflow_big = overflow_big + torch.clamp(nset - ch_cap, min=0)
            bs = side[bidx]                               # (ch_cap, 6)
            bkeys = _emit_fan(bs[:, 0], bs[:, 1], bs[:, 2], bs[:, 3],
                              bs[:, 4], bvalid, bs[:, 5].to(_I32), ch_kx,
                              ch_ky, ntx, nty, db, tile_w)
            keys += bkeys
            ids.append(bidx.repeat(len(bkeys)))
            if tail is not None:
                np_big = sum((k != sentinel).to(_I32) for k in bkeys)
                auxs.append(_pack_tail_aux(tail[0][bidx], tail[1][bidx],
                                           np_big, pix).repeat(len(bkeys)))
    key_flat = torch.cat(keys)
    m = key_flat.shape[0]
    sorted_key, perm = torch.sort(key_flat, stable=True)
    sorted_splat = (torch.cat(ids) if len(ids) > 1 else ids[0])[perm]

    tvec = torch.arange(ntiles + 1, dtype=_I32, device=dev)
    start = torch.searchsorted(sorted_key, tvec << db, out_int32=True)
    startc = start[:-1]
    count = start[1:] - startc
    tail_tl = {}
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
        if tail_decim is not None:
            # the tail extends each tile's sorted prefix past its head
            # grant: uniform floor + proportional surplus by remaining
            # depth, from a second pool, block-snapped
            want_tl = torch.clamp(count - kept, max=LOD_DESIRE_CAP
                                  * tail_decim)
            cap_steps_tl = -(-ntiles * tail_decim // CHUNK)
            kept_tl = _pool_grant(torch.clamp(want_tl, max=tail_decim),
                                  want_tl, cap_steps_tl * CHUNK)
            kept_tl = _block_snap(kept_tl, want_tl, cap_steps_tl,
                                  ntiles).to(_I32)
            overflow = (count - kept - kept_tl).sum().to(_I32)
            pack_tl, begin_tl = _aligned_pack_idx(
                startc + kept, kept_tl, cap_steps_tl, sorted_splat)
            begin_tl = begin_tl.to(_I32).contiguous()
            tail_tl = dict(pack_idx_tl=pack_tl, row_begin_tl=begin_tl,
                           row_end_tl=(begin_tl + kept_tl).contiguous(),
                           kept_tl=kept_tl)
    else:
        blk = CHUNK * nseg
        mpad = _pad_to(m, blk)
        cap_pairs = min(_pad_to(min(cap_pairs, mpad), blk), mpad)
        overflow = torch.clamp(start[ntiles] - cap_pairs, min=0)
        kept = torch.clamp(torch.minimum(count, cap_pairs - startc),
                           min=0).to(_I32)
        pack_idx = sorted_splat[:min(cap_pairs, m)]
        row_begin = startc
    if tail is not None:
        # slab sums over each tile's dropped range [startc+kept, end): LOD
        # drops and positional cap drops alike
        sums = _tail_sums(torch.cat(auxs)[perm], startc + kept, start[1:])
        tail_rgb = (sums[1:4] / torch.clamp(sums[0:1], min=1e-9)).T
        tail_tl["tail_slab"] = (sums[0], tail_rgb)
    return Binned(pack_idx=pack_idx, row_begin=row_begin.contiguous(),
                  row_end=(row_begin + kept).contiguous(),
                  visited=kept > 0, overflow=overflow, kept=kept,
                  count=count, overflow_big=overflow_big, **tail_tl)


def _pack_records(records: torch.Tensor, pack_idx: torch.Tensor):
    """One row gather of the (N, 12) records into packed order."""
    return records[pack_idx]


# ---------------------------------------------------------------------------
# K2 (head) and K3 (decimated tail): composite
# ---------------------------------------------------------------------------

def _tile_samples(ntx: int, nty: int, tile_w: int, decim: int, dev):
    """(px, py) (ntiles, pixd) f32: sample i of tile t at the centre of its
    decim×decim quad, pixd = (32/decim)·(tile_w/decim)."""
    ntiles = ntx * nty
    twd = tile_w // decim
    pix = (TILE_H // decim) * twd
    tid = torch.arange(ntiles, device=dev)
    i = torch.arange(pix, device=dev)
    shift = twd.bit_length() - 1
    px = ((i & (twd - 1))[None] * decim + ((tid % ntx) * tile_w)[:, None]) \
        .to(_F32) + 0.5 * decim
    py = ((i >> shift)[None] * decim + ((tid // ntx) * TILE_H)[:, None]) \
        .to(_F32) + 0.5 * decim
    return px, py


def _chunk_spans(row_begin, row_end, nrows: int):
    """(begin, end, first, nch) i64 (ntiles,): each tile's row range (end
    clipped to ``nrows``), the 128-row block holding its first row, and the
    number of chunks its range spans (0 when empty)."""
    begin = row_begin.long()
    end = torch.clamp(row_end.long(), max=nrows)
    first = (begin // CHUNK) * CHUNK
    nch = torch.where(end > begin, (end - first + CHUNK - 1) // CHUNK, 0)
    return begin, end, first, nch


def _composite_grid_plain(records, row_begin, row_end, t_entry, ntx: int,
                          nty: int, tile_w: int, decim: int, ckpt=None,
                          ck_off=None, merge: bool = False):
    """Plain PyTorch composite of every tile's packed rows over a sample
    grid decimated by ``decim``, the body of K2's (``decim`` 1, ``t_entry``
    None: T starts at 1), K3's and K4's plain versions. Returns (planes (4,
    ntiles, pixd) f32 = r, g, b, absolute T; exec (ntiles,) i32), pixd =
    (32/decim)·(tile_w/decim); ``t_entry`` is (ntiles, pixd). With ``ckpt``
    (nslots, pixd), each tile's T at the entry of its chunk j is written to
    row ``ck_off[t] + j``, for the chunks it runs (K4). With ``merge``,
    each chunk's colour is composited from T = 1 and then merged, C ← C +
    T·C_loc, as K3's kernel merges its chunks (``_composite_tail_merged``).

    Sample i of tile t sits at the centre of its decim×decim quad. Tile t
    composites packed rows [row_begin[t], row_end[t]) front to back, in
    chunks cut at absolute multiples of CHUNK rows. A tile whose entry T is
    below _T_EPS everywhere runs nothing; after each chunk the tile stops
    if every sample has T < _T_EPS, and ``exec`` counts the rows of every
    chunk that ran. Chunks of all running tiles go in parallel; inside a
    chunk the transmittance prefix is a ``cumprod`` (the kernel's running
    product, reassociated)."""
    dev = records.device
    ntiles = ntx * nty
    pix = (TILE_H // decim) * (tile_w // decim)
    nrows = records.shape[0]
    px, py = _tile_samples(ntx, nty, tile_w, decim, dev)
    rgb = torch.zeros((3, ntiles, pix), dtype=_F32, device=dev)
    tt = (torch.ones((ntiles, pix), dtype=_F32, device=dev)
          if t_entry is None else t_entry.to(_F32).clone())
    exec_ = torch.zeros(ntiles, dtype=_I32, device=dev)
    begin, end, first, nch = _chunk_spans(row_begin, row_end, nrows)
    running = (nch > 0) & (tt.amax(1) >= _T_EPS)
    group = max(1, (1 << 25) // (CHUNK * pix))   # bounds the temporaries
    rows = torch.arange(CHUNK, device=dev)
    nmax = int(nch.max()) if ntiles else 0
    for j in range(nmax):
        act = torch.nonzero(running & (nch > j)).flatten()
        if act.numel() == 0:
            break
        for s in range(0, act.numel(), group):
            g = act[s:s + group]
            if ckpt is not None:
                ckpt[ck_off[g].long() + j] = tt[g]
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
            if merge:
                loc = torch.einsum("gcr,gcp->rgp", rec[:, :, _CR:_CB2 + 1],
                                   alpha * excl)
                rgb[:, g] = rgb[:, g] + t_in[None] * loc
            else:
                w = alpha * excl * t_in[:, None, :]
                rgb[:, g] += torch.einsum("gcr,gcp->rgp",
                                          rec[:, :, _CR:_CB2 + 1], w)
            t_new = t_in * incl[:, -1]
            tt[g] = t_new
            exec_[g] += live.sum(1).to(_I32)
            running[g] = t_new.amax(1) >= _T_EPS
    return torch.stack([rgb[0], rgb[1], rgb[2], tt]), exec_


def _composite_plain(records, row_begin, row_end, ntx: int, nty: int,
                     tile_w: int = TILE_W):
    """Plain PyTorch version of K2: (planes (4, ntiles, 32*tile_w) f32 =
    r, g, b, T; exec (ntiles,) i32), every tile entered at T = 1."""
    return _composite_grid_plain(records, row_begin, row_end, None, ntx, nty,
                                 tile_w, 1)


def _composite_tail_plain(records, row_begin, row_end, t_entry, ntx: int,
                          nty: int, tile_w: int = TILE_W, decim: int = 2):
    """Plain PyTorch version of K3: (planes (4, ntiles, pixd) f32 = r, g,
    b, absolute T; exec (ntiles,) i32), each tile entered at its
    ``t_entry`` row (the head's decimated T)."""
    return _composite_grid_plain(records, row_begin, row_end, t_entry, ntx,
                                 nty, tile_w, decim)


def _composite_tail_merged(records, row_begin, row_end, t_entry, ntx: int,
                           nty: int, tile_w: int = TILE_W, decim: int = 2):
    """K3's kernel order in plain PyTorch, for tests and ``chip_smoke.py``
    (the wrapper's CPU path is ``_composite_tail_plain``): each chunk of a
    tile's tail composited from T = 1 into (C_loc, T_loc), then merged in
    order, C ← C + T·C_loc, T ← T·T_loc, with the tile-wide vote after
    each chunk. T and exec equal the plain version's; the colours differ
    by the reassociation only."""
    return _composite_grid_plain(records, row_begin, row_end, t_entry, ntx,
                                 nty, tile_w, decim, merge=True)


def _cull_threshold(op):
    """Plain twin of K2's warp row cull (``cull_threshold`` in
    ``csrc/gs_composite.cu``): the power below which a row of opacity
    ``op`` (f32) leaves a sample untouched, alpha < 1/255. With L =
    ln(alpha_min / op): min(L, 80) - 1e-3; NaN (no sample below it) for a
    NaN or negative opacity."""
    lim = torch.log(torch.full_like(op, _ALPHA_MIN) / op)
    return torch.where(lim >= 80.0, 80.0, lim) - 1e-3


def _composite_footprint(tile_w: int) -> tuple[int, int]:
    """(columns, rows) of the samples one warp of K2 covers at ``tile_w``,
    the unit its warp row cull skips a row for, as the kernel reports it
    (``gs_composite_footprint``; builds the kernel library)."""
    cols, rows = ctypes.c_int(), ctypes.c_int()
    _cuda.check(_cuda.lib().gs_composite_footprint(
        tile_w, ctypes.byref(cols), ctypes.byref(rows)), "K2 footprint")
    return cols.value, rows.value


def _composite_shape(kernel: int, tile_w: int, decim: int = 1):
    """(CTAs a tile, threads a CTA, CTAs the card holds at once) of K4
    (``kernel`` 4, one thread-block cluster a tile, at ``tile_w``) or of
    K3's first pass (3, at ``tile_w`` and ``decim``), as the kernel
    library reports them (``gs_composite_shape``; builds the library, needs
    a CUDA device)."""
    fn = _cuda.lib().gs_composite_shape
    i, pi = ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    fn.argtypes, fn.restype = [i, i, i, pi, pi, pi], i
    c, t, r = i(), i(), i()
    _cuda.check(fn(kernel, tile_w, decim, ctypes.byref(c), ctypes.byref(t),
                   ctypes.byref(r)), f"K{kernel} shape")
    return c.value, t.value, r.value


def _composite_args(name, records, row_begin, row_end, ntiles, tile_w, dev):
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    if tile_w not in (32, 64, 128):
        raise ValueError(f"{name}: tile_w {tile_w} not in 32/64/128")
    _cuda.check_arg(records, "records", _F32, (records.shape[0], _ROWS), dev)
    _cuda.check_arg(row_begin, "row_begin", _I32, (ntiles,), dev)
    _cuda.check_arg(row_end, "row_end", _I32, (ntiles,), dev)


def _composite_fake(records, row_begin, row_end, ntx, nty, tile_w=TILE_W,
                    decim=1):
    ntiles = ntx * nty
    pix = (TILE_H // decim) * (tile_w // decim)
    return (records.new_empty((4, ntiles, pix)),
            records.new_empty((ntiles,), dtype=_I32))


@_cuda.kernel_op("k2_composite", _composite_plain, _composite_fake)
def _k2_op(records: torch.Tensor, row_begin: torch.Tensor,
           row_end: torch.Tensor, ntx: int, nty: int,
           tile_w: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's launch: (planes (4, ntiles, 32*tile_w) f32, exec (ntiles,)
    i32)."""
    dev = records.device          # _composite_args refuses non-CUDA
    ntiles = ntx * nty
    _composite_args("K2 composite", records, row_begin, row_end, ntiles,
                    tile_w, dev)
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


def _composite_call(records, row_begin, row_end, ntx: int, nty: int,
                    tile_w: int = TILE_W):
    """K2 wrapper (the op ``rayeater::k2_composite``): (planes (4, ntiles,
    32*tile_w) f32, exec (ntiles,) i32), initialised for every tile. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    _cuda.op_device(records, "K2 composite")
    return _k2_op(records, row_begin, row_end, ntx, nty, tile_w)


def _composite_tail_fake(records, row_begin, row_end, t_entry, ntx, nty,
                         tile_w, decim):
    return _composite_fake(records, row_begin, row_end, ntx, nty, tile_w,
                           decim)


@_cuda.kernel_op("k3_composite_tail", _composite_tail_plain,
                 _composite_tail_fake)
def _k3_op(records: torch.Tensor, row_begin: torch.Tensor,
           row_end: torch.Tensor, t_entry: torch.Tensor, ntx: int, nty: int,
           tile_w: int, decim: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K3's launch (two passes): (planes (4, ntiles, pixd) f32, exec
    (ntiles,) i32)."""
    dev = records.device
    ntiles = ntx * nty
    _composite_args("K3 tail composite", records, row_begin, row_end,
                    ntiles, tile_w, dev)
    if decim not in (1, 2, 4):
        raise ValueError(f"K3 tail composite: decim {decim} not in 1/2/4")
    pixd = (TILE_H // decim) * (tile_w // decim)
    _cuda.check_arg(t_entry, "t_entry", _F32, (ntiles, pixd), dev)
    planes = torch.empty((4, ntiles, pixd), dtype=_F32, device=dev)
    exec_ = torch.empty(ntiles, dtype=_I32, device=dev)
    # each chunk's partials between the kernel's two passes, one slot per
    # (tile, chunk): at most ceil(nrows/128) + ntiles
    scratch = torch.empty((-(-records.shape[0] // CHUNK) + ntiles, 4, pixd),
                          dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().gs_composite_tail(
            records.data_ptr(), records.shape[0], row_begin.data_ptr(),
            row_end.data_ptr(), t_entry.data_ptr(), planes.data_ptr(),
            exec_.data_ptr(), ntiles, ntx, tile_w, decim,
            torch.cuda.current_stream(dev).cuda_stream, scratch.data_ptr())
    _cuda.check(err, "K3 tail composite")
    _cuda.launches["k3_composite_tail"] += 1
    return planes, exec_


def _composite_tail_call(records, row_begin, row_end, t_entry, ntx: int,
                         nty: int, tile_w: int = TILE_W, decim: int = 2):
    """K3 wrapper (the op ``rayeater::k3_composite_tail``): (planes (4,
    ntiles, pixd) f32 = r, g, b, absolute T; exec (ntiles,) i32),
    initialised for every tile (a tile with no rows, or skipped at entry,
    keeps rgb 0 and its entry T). CPU tensors take the plain version; CUDA
    tensors launch the kernel's two passes (or raise), which need row
    ranges that ascend with the tile index and do not overlap, as every
    packed layout here does."""
    _cuda.op_device(records, "K3 tail composite")
    return _k3_op(records, row_begin, row_end, t_entry, ntx, nty, tile_w,
                  decim)


# ---------------------------------------------------------------------------
# K4 (forward + entry-T checkpoints), K5 (backward) and the
# differentiable composite built from them
# ---------------------------------------------------------------------------

def _ckpt_offsets(row_begin, row_end, nrows: int):
    """Checkpoint layout of K4/K5: (ck_off (ntiles,) i32, nslots). Tile t's
    chunk j (counted from the 128-row block holding its first row) has its
    entry T in row ``ck_off[t] + j``; ``ck_off`` is the exclusive cumsum of
    the chunk counts. A block shared by two tiles (direct layout) has a
    slot per tile. ``nslots`` = ceil(nrows/128) + ntiles bounds the sum of
    the chunk counts without a host sync."""
    nch = _chunk_spans(row_begin, row_end, nrows)[3]
    off = torch.cumsum(nch, 0) - nch
    return off.to(_I32), -(-nrows // CHUNK) + row_begin.shape[0]


def _composite_ckpt_plain(records, row_begin, row_end, ntx: int, nty: int,
                          tile_w: int = TILE_W):
    """Plain PyTorch version of K4: K2's (planes, exec) plus (ckpt (nslots,
    32*tile_w) f32, ck_off (ntiles,) i32); rows of chunks that did not run
    stay 0."""
    ck_off, nslots = _ckpt_offsets(row_begin, row_end, records.shape[0])
    ckpt = torch.zeros((nslots, TILE_H * tile_w), dtype=_F32,
                       device=records.device)
    planes, exec_ = _composite_grid_plain(records, row_begin, row_end, None,
                                          ntx, nty, tile_w, 1, ckpt, ck_off)
    return planes, exec_, ckpt, ck_off


def _composite_ckpt_fake(records, row_begin, row_end, ntx, nty,
                         tile_w=TILE_W):
    ntiles = ntx * nty
    nslots = -(-records.shape[0] // CHUNK) + ntiles
    planes, exec_ = _composite_fake(records, row_begin, row_end, ntx, nty,
                                    tile_w)
    return (planes, exec_, records.new_empty((nslots, TILE_H * tile_w)),
            records.new_empty((ntiles,), dtype=_I32))


@_cuda.kernel_op("k4_composite_ckpt", _composite_ckpt_plain,
                 _composite_ckpt_fake)
def _k4_op(records: torch.Tensor, row_begin: torch.Tensor,
           row_end: torch.Tensor, ntx: int, nty: int, tile_w: int
           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's launch: (planes, exec, ckpt (nslots, 32*tile_w), ck_off)."""
    dev = records.device
    ntiles = ntx * nty
    _composite_args("K4 composite ckpt", records, row_begin, row_end, ntiles,
                    tile_w, dev)
    ck_off, nslots = _ckpt_offsets(row_begin, row_end, records.shape[0])
    pix = TILE_H * tile_w
    planes = torch.empty((4, ntiles, pix), dtype=_F32, device=dev)
    exec_ = torch.empty(ntiles, dtype=_I32, device=dev)
    ckpt = torch.empty((nslots, pix), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().gs_composite_ckpt(
            records.data_ptr(), records.shape[0], row_begin.data_ptr(),
            row_end.data_ptr(), ck_off.data_ptr(), planes.data_ptr(),
            exec_.data_ptr(), ckpt.data_ptr(), ntiles, ntx, tile_w,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K4 composite ckpt")
    _cuda.launches["k4_composite_ckpt"] += 1
    return planes, exec_, ckpt, ck_off


def _composite_call_ckpt(records, row_begin, row_end, ntx: int, nty: int,
                         tile_w: int = TILE_W):
    """K4 wrapper (the op ``rayeater::k4_composite_ckpt``): (planes (4,
    ntiles, 32*tile_w), exec (ntiles,) i32, ckpt (nslots, 32*tile_w),
    ck_off (ntiles,) i32); only the checkpoint rows of chunks that ran are
    defined. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise)."""
    _cuda.op_device(records, "K4 composite ckpt")
    return _k4_op(records, row_begin, row_end, ntx, nty, tile_w)


def _executed_chunks(begin, first, exec_):
    """Chunks each tile ran in the forward: its rows b .. b+exec-1 end in
    chunk (b+exec-1)//128 - first//128."""
    ex = exec_.long()
    return torch.where(ex > 0, (begin + ex - 1) // CHUNK - first // CHUNK + 1,
                       0)


def _composite_bwd_plain(records, row_begin, row_end, exec_, ck_off, ckpt,
                         planes, dplanes, ntx: int, nty: int,
                         tile_w: int = TILE_W):
    """Plain PyTorch version of K5: dL/d(packed records) (R, 12) f32 in the
    columns mx, my, conic a, b, c, opacity, r, g, b, 0, 0, 0, from K4's
    (r, g, b, T) ``planes`` and their cotangent ``dplanes`` (both (4,
    ntiles, 32*tile_w)). Only the T plane is read here; the kernel also
    reads the colour planes (Σ c·w over every executed row), which give it
    the suffix sums in a first-to-last walk.

    Each tile's executed chunks are walked last to first (all running
    tiles in parallel), T_i rebuilt inside a chunk from its checkpoint by a
    ``cumprod`` of (1 - α), the within-chunk suffix Σ_{j>i} (c_j·dC) w_j by
    a reversed ``cumsum``, the later chunks' part carried per sample.
    dL/dα_i = (c_i·dC) T_i − (suffix_i + dT·T_final) / (1 − α_i); no
    gradient through α where it was clamped at 0.99 or floored below 1/255,
    and none for rows outside [row_begin, row_end) or in chunks the forward
    did not run."""
    dev = records.device
    ntiles = ntx * nty
    pix = TILE_H * tile_w
    nrows = records.shape[0]
    px, py = _tile_samples(ntx, nty, tile_w, 1, dev)
    begin, end, first, _ = _chunk_spans(row_begin, row_end, nrows)
    nex = _executed_chunks(begin, first, exec_)
    off = ck_off.long()
    grad = torch.zeros((nrows, _ROWS), dtype=_F32, device=dev)
    carry = torch.zeros((ntiles, pix), dtype=_F32, device=dev)
    dtt = dplanes[3] * planes[3]
    group = max(1, (1 << 24) // (CHUNK * pix))   # bounds the temporaries
    rows = torch.arange(CHUNK, device=dev)
    nmax = int(nex.max()) if ntiles else 0
    for j in range(nmax - 1, -1, -1):
        act = torch.nonzero(nex > j).flatten()
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
            ep = torch.exp(power)
            araw = col(_OP) * ep
            keep = live[:, :, None] & (araw >= _ALPHA_MIN)
            alpha = torch.where(keep, torch.clamp(araw, max=_ALPHA_MAX), 0.0)
            om = 1.0 - alpha
            incl = torch.cumprod(om, dim=1)
            excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
            t_i = ckpt[off[g] + j][:, None, :] * excl
            w = alpha * t_i
            d_c = [dplanes[c][g][:, None, :] for c in range(3)]
            a_dot = col(_CR) * d_c[0] + col(_CG) * d_c[1] + col(_CB2) * d_c[2]
            aw = a_dot * w
            later = torch.flip(torch.cumsum(torch.flip(aw, [1]), 1), [1]) - aw
            suffix = later + carry[g][:, None, :]
            d_alpha = (a_dot * t_i - (suffix + dtt[g][:, None, :])
                       / torch.clamp(om, min=1e-6))
            gm = keep & (araw < _ALPHA_MAX)
            gpow = torch.where(gm, alpha * d_alpha, 0.0)
            out = torch.stack([
                (gpow * (col(_CA) * dx + col(_CB) * dy)).sum(2),
                (gpow * (col(_CB) * dx + col(_CC) * dy)).sum(2),
                (gpow * (-0.5) * dx * dx).sum(2),
                (gpow * (-dx * dy)).sum(2),
                (gpow * (-0.5) * dy * dy).sum(2),
                torch.where(gm, ep * d_alpha, 0.0).sum(2),
                (w * d_c[0]).sum(2), (w * d_c[1]).sum(2),
                (w * d_c[2]).sum(2)], -1)                      # (G, C, 9)
            grad[idx[live], :9] = out[live]
            carry[g] += aw.sum(1)
    return grad


def _composite_bwd_fake(records, *args):
    return records.new_empty((records.shape[0], _ROWS))


@_cuda.kernel_op("k5_composite_bwd", _composite_bwd_plain,
                 _composite_bwd_fake)
def _k5_op(records: torch.Tensor, row_begin: torch.Tensor,
           row_end: torch.Tensor, exec_: torch.Tensor, ck_off: torch.Tensor,
           ckpt: torch.Tensor, planes: torch.Tensor, dplanes: torch.Tensor,
           ntx: int, nty: int, tile_w: int) -> torch.Tensor:
    """K5's launch: dL/d(packed records) (R, 12) f32."""
    dev = records.device
    ntiles = ntx * nty
    pix = TILE_H * tile_w
    _composite_args("K5 composite bwd", records, row_begin, row_end, ntiles,
                    tile_w, dev)
    _cuda.check_arg(exec_, "exec", _I32, (ntiles,), dev)
    _cuda.check_arg(ck_off, "ck_off", _I32, (ntiles,), dev)
    _cuda.check_arg(ckpt, "ckpt", _F32, (ckpt.shape[0], pix), dev)
    _cuda.check_arg(planes, "planes", _F32, (4, ntiles, pix), dev)
    _cuda.check_arg(dplanes, "dplanes", _F32, (4, ntiles, pix), dev)
    grad = torch.zeros((records.shape[0], _ROWS), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().gs_composite_bwd(
            records.data_ptr(), records.shape[0], row_begin.data_ptr(),
            row_end.data_ptr(), exec_.data_ptr(), ck_off.data_ptr(),
            ckpt.data_ptr(), planes.data_ptr(), dplanes.data_ptr(),
            grad.data_ptr(), ntiles, ntx, tile_w,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K5 composite bwd")
    _cuda.launches["k5_composite_bwd"] += 1
    return grad


def _composite_bwd_call(records, row_begin, row_end, exec_, ck_off, ckpt,
                        planes, dplanes, ntx: int, nty: int,
                        tile_w: int = TILE_W):
    """K5 wrapper (the op ``rayeater::k5_composite_bwd``): dL/d(packed
    records) (R, 12) f32 from K4's outputs (its planes among them) and the
    (4, ntiles, 32*tile_w) cotangent ``dplanes``; zero-filled, the kernel
    adds into every row of every chunk the forward ran. CPU tensors take
    the plain version; CUDA tensors launch the kernel (or raise)."""
    _cuda.op_device(records, "K5 composite bwd")
    return _k5_op(records, row_begin, row_end, exec_, ck_off, ckpt, planes,
                  dplanes, ntx, nty, tile_w)


class _CompositeDiff(torch.autograd.Function):
    """K4 forward, K5 backward (through their ops); the row ranges get no
    gradient."""

    @staticmethod
    def forward(ctx, packed, row_begin, row_end, ntx, nty, tile_w):
        planes, exec_, ckpt, ck_off = _composite_call_ckpt(
            packed, row_begin, row_end, ntx, nty, tile_w)
        ctx.save_for_backward(packed, row_begin, row_end, exec_, ck_off,
                              ckpt, planes)
        ctx.grid = (ntx, nty, tile_w)
        return planes

    @staticmethod
    def backward(ctx, d_planes):
        packed, row_begin, row_end, exec_, ck_off, ckpt, planes = \
            ctx.saved_tensors
        grad = _composite_bwd_call(packed, row_begin, row_end, exec_, ck_off,
                                   ckpt, planes, d_planes.contiguous(),
                                   *ctx.grid)
        return grad, None, None, None, None, None


def composite_diff(packed, row_begin, row_end, ntx: int, nty: int,
                   tile_w: int = TILE_W) -> torch.Tensor:
    """Differentiable composite → planes (4, ntiles, 32*tile_w) = r, g, b,
    T (the JAX ``composite_diff``). When autograd records the call, the
    forward is K4 (saving its entry-T checkpoints) and the backward K5;
    otherwise it is K2 alone, as the JAX primal is."""
    if torch.is_grad_enabled() and packed.requires_grad:
        return _CompositeDiff.apply(packed, row_begin, row_end, ntx, nty,
                                    tile_w)
    return _composite_call(packed, row_begin, row_end, ntx, nty, tile_w)[0]


def _decimate_t(t_plane, tile_w: int, decim: int):
    """(ntiles, 32*tile_w) head transmittance → (ntiles, pixd) means over
    each decim×decim quad (K3's entry T)."""
    nt = t_plane.shape[0]
    t4 = t_plane.reshape(nt, TILE_H // decim, decim, tile_w // decim, decim)
    return t4.mean(dim=(2, 4)).reshape(nt, -1)


# ---------------------------------------------------------------------------
# finalize + render
# ---------------------------------------------------------------------------

def _untile(plane, nty: int, ntx: int, tile_w: int = TILE_W):
    """(ntiles, 32*tile_w) tile-flattened → (nty*32, ntx*tile_w) plane."""
    return _untile_decim(plane, nty, ntx, tile_w, 1)


def _untile_decim(plane, nty: int, ntx: int, tile_w: int, decim: int):
    """:func:`_untile` for decimated tail planes: (..., ntiles, pixd) →
    (..., nty*32/d, ntx*tile_w/d)."""
    th, tw = TILE_H // decim, tile_w // decim
    t = plane[..., :nty * ntx, :].reshape(*plane.shape[:-2], nty, ntx, th, tw)
    return t.transpose(-3, -2).reshape(*plane.shape[:-2], nty * th, ntx * tw)


def _upsample(grid, size):
    """Bilinear upsampling of (C, h, w) to (C, *size) with half-pixel
    centres, as ``jax.image.resize``'s "bilinear" enlarges."""
    return F.interpolate(grid[None], size=tuple(size), mode="bilinear",
                         align_corners=False)[0]


def finalize_planes(planes, visited, nty: int, ntx: int, background,
                    tile_w: int = TILE_W, tail_decim_planes=None,
                    decim: int = 2, tail_slab=None) -> torch.Tensor:
    """Mask never-visited tiles to background (T = 1), untile the planes
    and blend the background through the remaining transmittance →
    (nty*32, ntx*tile_w, 3).

    ``tail_decim_planes`` = (tail planes (4, ntiles, pixd) with absolute T,
    entry T (ntiles, pixd), tail-visited (ntiles,) bool): the tail's colour
    and its transmittance ratio (absolute over entry, clipped to [0, 1])
    are upsampled bilinearly (half-pixel centres, as ``jax.image.resize``),
    the colour added and the head's T multiplied by the ratio.

    ``tail_slab`` = (tail_la (ntiles,) optical thickness, tail_rgb
    (ntiles, 3) mean colour) of the pairs the LOD dropped: both are
    upsampled bilinearly across tile centres, the thickness is modulated
    per pixel by the head's occupancy 1 - T over its upsampled tile mean
    (clipped to [0, 3]), and the slab is composited behind the head."""
    vis = visited[:, None]
    r, g, b, t = planes
    t_vis = torch.where(vis, t, 1.0)
    rgb = torch.stack([_untile(torch.where(vis, p, 0.0), nty, ntx, tile_w)
                       for p in (r, g, b)], -1)
    tt = _untile(t_vis, nty, ntx, tile_w)
    if tail_decim_planes is not None:
        tail, td, vis_t = tail_decim_planes
        vt = vis_t[:, None]
        ratio = torch.clamp(tail[3] / torch.clamp(td, min=1e-20), 0.0, 1.0)
        low = torch.stack([torch.where(vt, tail[0], 0.0),
                           torch.where(vt, tail[1], 0.0),
                           torch.where(vt, tail[2], 0.0),
                           torch.where(vt, ratio, 1.0)])
        up = _upsample(_untile_decim(low, nty, ntx, tile_w, decim),
                       tt.shape)
        rgb = rgb + up[:3].permute(1, 2, 0)
        tt = tt * up[3]
    if tail_slab is not None:
        tail_la, tail_rgb = tail_slab
        occ_mean = torch.mean(1.0 - t_vis, -1)                # (ntiles,)
        up = _upsample(torch.cat([tail_la[None], tail_rgb.T, occ_mean[None]])
                       .reshape(5, nty, ntx), tt.shape)
        w = torch.clamp((1.0 - tt) / torch.clamp(up[4], min=1e-3), 0.0, 3.0)
        a_img = 1.0 - torch.exp(-up[0] * w)
        rgb = rgb + (tt * a_img)[..., None] * up[1:4].permute(1, 2, 0)
        tt = tt * (1.0 - a_img)
    bg = (background.to(planes.device, _F32)
          if isinstance(background, torch.Tensor)
          else on_device(background, planes.device))
    return rgb + tt[..., None] * bg


class FrameLayout(NamedTuple):
    """A frame's composite input: packed records and per-tile row ranges."""
    records: torch.Tensor     # (R, 12) f32 packed records
    binned: Binned
    ntx: int
    nty: int
    tile_w: int
    records_tl: torch.Tensor | None = None    # packed tail records


def _exact_pair_cap(n: int, ntiles: int, ky: int, tile_w: int, corner_cap,
                    big_cap, mid_cap, mid_lo_cap) -> int:
    """The most pairs ``n`` splats can emit over ``ntiles`` tiles through
    the level-1 fan (or the 2-slot fan and the corner channel) and the
    side channels' budgets, plus a chunk of slack a tile: exact mode's
    pair cap before rounding."""
    if corner_cap is not None and ky == 2 and KX == 2:
        cap = n * 2 + corner_cap * KX * ky + ntiles * CHUNK
    else:
        cap = n * KX * ky + ntiles * CHUNK
    if big_cap is not None:
        cap += big_cap * _kx2(tile_w) * KY2
        if mid_cap is not None:
            cap += mid_cap * _kxm(tile_w) * KY_M
            if mid_lo_cap is not None:
                cap += mid_lo_cap * _kxml(tile_w) * KY_ML
    return cap


def _check_channels(max_splats_per_tile, big_splat_cap, mid_splat_cap,
                    mid_lo_splat_cap, lod_tail_decim) -> None:
    """Raise on side-channel and tail knobs that need another one."""
    if mid_splat_cap is not None and big_splat_cap is None:
        raise ValueError("mid_splat_cap requires big_splat_cap")
    if mid_lo_splat_cap is not None and mid_splat_cap is None:
        raise ValueError("mid_lo_splat_cap requires mid_splat_cap")
    if lod_tail_decim is not None and max_splats_per_tile is None:
        raise ValueError("lod_tail_decim requires max_splats_per_tile")


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
                  tile_w: int = TILE_W, exact_seg: int = 8,
                  big_splat_cap: int | None = None,
                  mid_splat_cap: int | None = None,
                  mid_lo_splat_cap: int | None = None,
                  corner_cap: int | None = None,
                  lod_tail_decim: int | None = None,
                  lod_tail: bool = False) -> FrameLayout:
    """Project (K1), bin and pack one frame: everything before K2. With
    ``lod_tail`` (LOD mode) the binning also sums the slab proxy
    (``binned.tail_slab``)."""
    dev = cloud.means.device
    view = _on(view, dev, "view").to(_F32)
    proj = _on(proj, dev, "proj").to(_F32)
    max_radius = (float(level2_max_radius(tile_w))
                  if big_splat_cap is not None else None)
    ps = _project_fast(cloud.means, cloud.scales, cloud.quats,
                       cloud.opacities, cloud.colors, view, proj,
                       width, height, ky=ky, max_radius=max_radius)
    records = _make_records(ps)
    ntx, nty = num_tiles(width, height, tile_w)
    n = cloud.num_splats
    ntiles = ntx * nty
    exact_cap = _exact_pair_cap(n, ntiles, ky, tile_w, corner_cap,
                                big_splat_cap, mid_splat_cap,
                                mid_lo_splat_cap)
    if pairs_cap_factor is None:
        cap_pairs = exact_cap
    else:
        cap_pairs = min(exact_cap, max(pairs_cap_factor * n, 4 * CHUNK)
                        + ntiles * CHUNK)
    cap_pairs = _pad_to(cap_pairs, CHUNK)
    if lod_budget is not None:
        lod_budget = _on(lod_budget, dev, "lod_budget")
    tail_in = None
    if max_splats_per_tile is not None and lod_tail:
        # each splat's alpha integral op·2π/sqrt(det(conic)) (det(conic) =
        # 1/det(cov2d)); culled splats zeroed
        cn = ps.conic
        detc = torch.clamp(cn[:, 0] * cn[:, 2] - cn[:, 1] * cn[:, 1],
                           min=1e-12)
        a_full = (ps.opacity * torch.isfinite(ps.depth).to(_F32)
                  * (2.0 * math.pi) * torch.rsqrt(detc))
        tail_in = (a_full, ps.color)
    binned = _bin_splats(ps.mean2d[:, 0], ps.mean2d[:, 1], ps.radius,
                         torch.isfinite(ps.depth), ps.depth, ntx, nty,
                         cap_pairs, ky=ky, max_per_tile=max_splats_per_tile,
                         budget=lod_budget, tile_w=tile_w, nseg=exact_seg,
                         ext=ps.ext, big_cap=big_splat_cap,
                         mid_cap=mid_splat_cap, mid_lo_cap=mid_lo_splat_cap,
                         corner_cap=corner_cap,
                         tail_decim=(lod_tail_decim if max_splats_per_tile
                                     is not None else None), tail=tail_in)
    records_tl = (None if binned.pack_idx_tl is None
                  else _pack_records(records, binned.pack_idx_tl))
    return FrameLayout(records=_pack_records(records, binned.pack_idx),
                       binned=binned, ntx=ntx, nty=nty, tile_w=tile_w,
                       records_tl=records_tl)


def _tail_entry(head_t, visited, tile_w: int, decim: int):
    """K3's entry T: the head's T decimated, with head-unvisited tiles
    (their true entry T is 1) masked to 1."""
    return _decimate_t(torch.where(visited[:, None], head_t, 1.0), tile_w,
                       decim).contiguous()


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
    the cloud's device (K1, K2 and K3 on CUDA, their plain versions on
    CPU).

    The signature is the JAX ``render_gaussians``'s. Ported: exact mode
    (``max_splats_per_tile=None``, ``pairs_cap_factor`` positional cap),
    the LOD pool with temporal ``lod_budget``, the budgeted side channels
    (``big_splat_cap``, ``mid_splat_cap``, ``mid_lo_splat_cap``,
    ``corner_cap``; see :func:`_bin_splats`) and the decimated tail
    (``lod_tail_decim`` pairs per tile at ``lod_tail_d``, default
    ``_TAIL_D``), the ``lod_tail`` slab proxy (LOD mode only: the pairs
    the LOD drops composited as a per-tile homogeneous slab behind the
    kept lists, see :func:`finalize_planes`) and view-dependent SH colours
    (``cam_pos`` with a cloud that has ``sh_rest``, evaluated by
    ``eval_sh_colors`` before the projection). ``payload_sort``,
    ``lod_seg`` and ``interpret`` do not change the output and are
    ignored; ``exact_seg`` only rounds the exact-mode pair cap, as in the
    JAX layout.

    ``return_stats=True`` also returns ``overflow_pairs`` (pairs dropped
    behind the head, or behind the tail when there is one),
    ``overflow_big_splats`` (splats the side channels dropped),
    ``tile_exec`` (head rows composited before saturation, 0 for unvisited
    tiles), ``tile_kept``, ``tile_count`` and the head-based ``lossless``
    certificate."""
    _check_channels(max_splats_per_tile, big_splat_cap, mid_splat_cap,
                    mid_lo_splat_cap, lod_tail_decim)
    tail_d = _TAIL_D if lod_tail_d is None else lod_tail_d
    if cam_pos is not None and cloud.sh_rest is not None:
        cloud = dataclasses.replace(cloud,
                                    colors=eval_sh_colors(cloud, cam_pos))

    lay = _frame_layout(cloud, view, proj, width, height,
                        pairs_cap_factor=pairs_cap_factor, ky=ky,
                        max_splats_per_tile=max_splats_per_tile,
                        lod_budget=lod_budget, tile_w=tile_w,
                        exact_seg=exact_seg, big_splat_cap=big_splat_cap,
                        mid_splat_cap=mid_splat_cap,
                        mid_lo_splat_cap=mid_lo_splat_cap,
                        corner_cap=corner_cap, lod_tail_decim=lod_tail_decim,
                        lod_tail=lod_tail)
    b = lay.binned
    planes, texec = _composite_call(lay.records, b.row_begin, b.row_end,
                                    lay.ntx, lay.nty, tile_w)
    tail_planes = None
    if lay.records_tl is not None:
        td = _tail_entry(planes[3], b.visited, tile_w, tail_d)
        planes_tl, _ = _composite_tail_call(
            lay.records_tl, b.row_begin_tl, b.row_end_tl, td, lay.ntx,
            lay.nty, tile_w, tail_d)
        tail_planes = (planes_tl, td, b.kept_tl > 0)
    img = finalize_planes(planes, b.visited, lay.nty, lay.ntx, background,
                          tile_w, tail_planes, tail_d,
                          b.tail_slab)[:height, :width]
    if not return_stats:
        return img
    tile_exec = torch.where(b.visited, texec, 0)
    if max_splats_per_tile is not None:
        # certificate: every truncated tile saturated strictly inside its
        # kept list, so every dropped pair lies behind T < _T_EPS
        dry = (b.kept < b.count) & (tile_exec >= b.kept) & (b.count > 0)
        lossless = (~torch.any(dry)) & (b.overflow_big == 0)
    else:
        lossless = (b.overflow == 0) & (b.overflow_big == 0)
    stats = {"overflow_pairs": b.overflow,
             "overflow_big_splats": b.overflow_big,
             "tile_exec": tile_exec,
             "tile_kept": b.kept, "tile_count": b.count,
             "lossless": lossless}
    return img, stats


def _diff_layout(means, scales, quats, opacities, colors, view, proj,
                 width: int, height: int, max_splats_per_tile: int = 256,
                 ky: int = KY, tile_w: int = TILE_W,
                 mean2d_offset=None) -> FrameLayout:
    """The training frame up to the composite: the plain projection (under
    autograd when the inputs require grad), LOD binning on detached
    inputs, and the row gather of the records into packed order."""
    dev = means.device
    view = _on(view, dev, "view").to(_F32)
    proj = _on(proj, dev, "proj").to(_F32)
    ps = project_gaussians(means, scales, quats, opacities, colors, view,
                           proj, width, height, ky=ky)
    if mean2d_offset is not None:
        ps = ps._replace(mean2d=ps.mean2d + mean2d_offset)
    records = _make_records(ps)
    ntx, nty = num_tiles(width, height, tile_w)
    cap_pairs = _pad_to(means.shape[0] * KX * ky + ntx * nty * CHUNK, CHUNK)
    mean2d, depth = ps.mean2d.detach(), ps.depth.detach()
    b = _bin_splats(mean2d[:, 0], mean2d[:, 1], ps.radius,
                    torch.isfinite(depth), depth, ntx, nty, cap_pairs, ky=ky,
                    max_per_tile=max_splats_per_tile, tile_w=tile_w,
                    ext=ps.ext)
    # index_select, not records[pack_idx]: the backward of advanced
    # indexing sorts the indices and walks each run of equal ones serially,
    # and the pool's unfilled rows all point at one splat (~80k of them at
    # 1M splats / 1080p); index_select's backward is index_add_
    return FrameLayout(records=records.index_select(0, b.pack_idx),
                       binned=b, ntx=ntx, nty=nty, tile_w=tile_w)


def render_gaussians_diff(means, scales, quats, opacities, colors,
                          view, proj, width: int, height: int,
                          background=(0.0, 0.0, 0.0),
                          max_splats_per_tile: int = 256,
                          ky: int = KY,
                          interpret: bool = False,
                          tile_w: int = TILE_W,
                          mean2d_offset=None) -> torch.Tensor:
    """Differentiable render → (height, width, 3), the 1M-splat training
    path (the JAX ``render_gaussians_diff``).

    The projection is the plain, autograd-friendly :func:`project_gaussians`
    (not K1: the JAX package differentiates its jnp path too). Binning runs
    in LOD mode on detached inputs (the JAX ``stop_gradient``), the pack is
    a row gather whose backward scatter-adds the packed rows' gradients
    onto the splat records, and the composite is :func:`composite_diff`
    (K4 forward, K5 backward on CUDA). ``mean2d_offset`` (N, 2), usually
    zeros, is added to the projected screen means: its gradient is the
    per-splat view-space positional gradient that densification thresholds
    on. ``interpret`` is accepted for signature parity and ignored."""
    lay = _diff_layout(means, scales, quats, opacities, colors, view, proj,
                       width, height, max_splats_per_tile, ky, tile_w,
                       mean2d_offset)
    b = lay.binned
    planes = composite_diff(lay.records, b.row_begin, b.row_end, lay.ntx,
                            lay.nty, tile_w)
    img = finalize_planes(planes, b.visited, lay.nty, lay.ntx, background,
                          tile_w)
    return img[:height, :width]


def initial_lod_budget(width: int, height: int, tile_w: int,
                       max_splats_per_tile: int, device):
    """The first frame's (ntiles, 2) int32 LOD budget of a temporal
    window: ``max_splats_per_tile`` a tile and no dry need; later frames
    take :func:`update_lod_budget` of the frame before."""
    ntx, nty = num_tiles(width, height, tile_w)
    return torch.stack([
        torch.full((ntx * nty,), max_splats_per_tile, dtype=_I32,
                   device=device),
        torch.zeros(ntx * nty, dtype=_I32, device=device)], -1)


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
