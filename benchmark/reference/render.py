"""Plain PyTorch reference of one 3D Gaussian Splatting frame, the yardstick
that the benchmark holds the program's frames to.

A frozen copy of the semantics of the port's frame (``render_gaussians``
in exact and LOD mode, the temporal LOD budget, the u8 sRGB encode),
written as plain tensor operations with no kernel, imported from nothing
of the program:

1. the splats' view-dependent colours (degree-3 SH, ``sh.py``) and the
   EWA projection of every splat (the port's K1);
2. binning: the level-1 fan (or the 2-slot fan plus the corner channel),
   the budgeted mid-lo, mid and coarse side-channel fans, one stable sort
   of ``tile << db | qdepth`` keys, per-tile runs;
3. exact mode: every pair up to the positional cap; LOD mode: a per-tile
   desire from the depth cut (or the carried budget), 3x3-max-pooled, a
   global pool granted floor-first then proportionally and snapped to
   whole 128-pair blocks; the decimated tail's second pool;
4. the record pack;
5. the head composite front to back with tile-level saturation checked
   at 128-row chunk ends (the port's K2) and the decimated-tail composite
   entered at the head's mean transmittance (K3);
6. finalize (unvisited tiles to background, untile, the bilinearly
   upsampled tail), the sRGB u8 encode, and the next frame's budget.

``blend`` selects the dtype of the composite's blend (alpha, the
transmittance product and the colour sums): float32 is the reference;
bfloat16 is the control, the step below float32 that the check must
refuse.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import sh

TILE_H = 32
CHUNK = 128
KX = 2
KY = 2
KY2 = 8
KY_M = 4
KY_ML = 3
LOD_DESIRE_CAP = 32
DRY_FLOOR_CAP = 4
ALPHA_MIN = 1.0 / 255.0
ALPHA_MAX = 0.99
T_EPS = 1e-4

_F32 = torch.float32
_I32 = torch.int32
# record columns: mean x, mean y, conic a, b, c, opacity, r, g, b
_MX, _MY, _CA, _CB, _CC, _OP, _CR, _CG, _CB2 = range(9)
_ROWS = 12


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def fan_limits(kx: int, ky: int, tile_w: int) -> tuple[int, int]:
    """Largest per-axis extents whose [m-r, m+r] span fits kx x ky tiles."""
    return (kx - 1) * tile_w // 2 - 1, (ky - 1) * TILE_H // 2 - 1


def fan_kx(ky_fan: int, tile_w: int) -> int:
    rv = fan_limits(1, ky_fan, tile_w)[1]
    return -(-2 * (rv + 1) // tile_w) + 1


def level1_max_radius(tile_w: int) -> int:
    return min(fan_limits(KX, KY, tile_w))


def level2_max_radius(tile_w: int) -> int:
    return min(fan_limits(fan_kx(KY2, tile_w), KY2, tile_w))


def num_tiles(width: int, height: int, tile_w: int) -> tuple[int, int]:
    return (width + tile_w - 1) // tile_w, (height + TILE_H - 1) // TILE_H


# ---------------------------------------------------------------------------
# projection
# ---------------------------------------------------------------------------

def project(cloud: dict, view, proj, width: int, height: int,
            max_radius: float, near: float = 0.05) -> torch.Tensor:
    """(9, N) float32 planes: mean x, mean y, conic a, b, c, depth (+inf
    when culled), radius, rx, ry."""
    s, q = cloud["scales"], cloud["quats"]
    sx, sy, sz = s[:, 0], s[:, 1], s[:, 2]
    inv_n = 1.0 / torch.sqrt(torch.clamp(
        q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
        + q[:, 3] * q[:, 3], min=1e-24))
    w, x, y, z = (q[:, k] * inv_n for k in range(4))
    m = [[(1 - 2 * (y * y + z * z)) * sx, 2 * (x * y - w * z) * sy,
          2 * (x * z + w * y) * sz],
         [2 * (x * y + w * z) * sx, (1 - 2 * (x * x + z * z)) * sy,
          2 * (y * z - w * x) * sz],
         [2 * (x * z - w * y) * sx, 2 * (y * z + w * x) * sy,
          (1 - 2 * (x * x + y * y)) * sz]]

    def dot(i, j):
        return m[i][0] * m[j][0] + m[i][1] * m[j][1] + m[i][2] * m[j][2]
    sig = [[dot(0, 0), dot(0, 1), dot(0, 2)], [dot(0, 1), dot(1, 1),
                                               dot(1, 2)],
           [dot(0, 2), dot(1, 2), dot(2, 2)]]
    r_v = view[:3, :3]
    tv = view[:3, 3]
    fx = proj[0, 0] * width * 0.5
    fy = proj[1, 1] * height * 0.5
    p00, p11 = proj[0, 0], proj[1, 1]
    mu = cloud["means"]
    px_, py_, pz_ = mu[:, 0], mu[:, 1], mu[:, 2]
    pv = [r_v[i, 0] * px_ + r_v[i, 1] * py_ + r_v[i, 2] * pz_ + tv[i]
          for i in range(3)]
    pvx, pvy, zv = pv
    t = [[r_v[i, 0] * sig[0][j] + r_v[i, 1] * sig[1][j]
          + r_v[i, 2] * sig[2][j] for j in range(3)] for i in range(3)]
    near_t = torch.full((), near, dtype=_F32, device=mu.device)
    z_safe = torch.maximum(zv, near_t)
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
        return t[i][0] * r_v[j, 0] + t[i][1] * r_v[j, 1] + t[i][2] * r_v[j, 2]
    c00, c01, c02 = cv(0, 0), cv(0, 1), cv(0, 2)
    c11, c12, c22 = cv(1, 1), cv(1, 2), cv(2, 2)
    a = j00 * (j00 * c00 + j02 * c02) + j02 * (j00 * c02 + j02 * c22) + 0.3
    bb = j00 * (j11 * c01 + j12 * c02) + j02 * (j11 * c12 + j12 * c22)
    c = j11 * (j11 * c11 + j12 * c12) + j12 * (j11 * c12 + j12 * c22) + 0.3
    det = a * c - bb * bb
    op = cloud["opacities"]
    mid = 0.5 * (a + c)
    lam_max = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.0))
    scut = torch.clamp(torch.sqrt(torch.clamp(
        2.0 * torch.log(torch.clamp(op, min=ALPHA_MIN) * (1.0 / ALPHA_MIN)),
        min=1e-6)), max=3.0)
    radius = torch.ceil(scut * torch.sqrt(torch.clamp(lam_max, min=0.0)))
    radius = torch.clamp(radius, max=max_radius)
    rx = torch.minimum(torch.ceil(scut * torch.sqrt(torch.clamp(a, min=0.0))),
                       radius)
    ry = torch.minimum(torch.ceil(scut * torch.sqrt(torch.clamp(c, min=0.0))),
                       radius)
    inv_det = 1.0 / torch.where(det > 1e-12, det, 1.0)
    mx = (pvx * inv_z * p00 + 1.0) * 0.5 * width
    my = (pvy * inv_z * p11 + 1.0) * 0.5 * height
    valid = ((zv > near) & (det > 1e-12) & (radius >= 1.0)
             & (mx + rx > 0) & (mx - rx < width)
             & (my + ry > 0) & (my - ry < height) & (op > ALPHA_MIN))
    depth = torch.where(valid, zv, math.inf)
    return torch.stack([mx, my, c * inv_det, -bb * inv_det, a * inv_det,
                        depth, radius, rx, ry])


def make_records(planes, cloud, colors=None) -> torch.Tensor:
    """(N, 12) float32 records; culled splats carry opacity 0. ``colors``
    (N, 3), the frame's view-dependent colours, default to the cloud's
    DC colours."""
    n = planes.shape[1]
    rec = torch.zeros((n, _ROWS), dtype=_F32, device=planes.device)
    rec[:, _MX] = planes[0]
    rec[:, _MY] = planes[1]
    rec[:, _CA:_CC + 1] = planes[2:5].T
    rec[:, _OP] = cloud["opacities"] * torch.isfinite(planes[5]).to(_F32)
    rec[:, _CR:_CB2 + 1] = cloud["colors"] if colors is None else colors
    return rec


# ---------------------------------------------------------------------------
# binning
# ---------------------------------------------------------------------------

def quantize_depth(depth, valid, db: int):
    qmax = (1 << db) - 1
    dfin = torch.where(valid, depth, math.inf)
    dmin = torch.min(dfin)
    dmax = torch.max(torch.where(valid, depth, -math.inf))
    dmin = torch.where(torch.isfinite(dmin), dmin, 0.0)
    span = torch.clamp(dmax - dmin, min=1e-9)
    qd = torch.clamp((dfin - dmin) / span * qmax, 0.0, float(qmax))
    qd = torch.clamp(qd.to(_I32), 0, qmax)
    return torch.where(valid, qd, 0)


def tile_span(mx, my, rx, ry, ntx, nty, tile_w):
    tx0 = torch.floor((mx - rx) / tile_w).to(_I32).clamp(0, ntx - 1)
    tx1 = torch.floor((mx + rx) / tile_w).to(_I32).clamp(0, ntx - 1)
    ty0 = torch.floor((my - ry) / TILE_H).to(_I32).clamp(0, nty - 1)
    ty1 = torch.floor((my + ry) / TILE_H).to(_I32).clamp(0, nty - 1)
    return tx0, tx1, ty0, ty1


def emit_fan(mx, my, rx, ry, r, valid, qd, kx_fan, ky_fan, ntx, nty, db,
             tile_w):
    """Keys of a kx_fan x ky_fan fan over the bbox, minus the span tiles
    the circumscribed circle misses; culled slots hold the sentinel."""
    sentinel = (ntx * nty) << db
    tx0, tx1, ty0, ty1 = tile_span(mx, my, rx, ry, ntx, nty, tile_w)
    r2 = r * r
    keys = []
    for dy in range(ky_fan):
        for dx in range(kx_fan):
            ty, tx = ty0 + dy, tx0 + dx
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


def emit_pair(mx, my, rx, ry, valid, qd, ntx, nty, db, tile_w):
    """The 2-slot fan: the home tile and the one crossed neighbour."""
    sentinel = (ntx * nty) << db
    tx0, tx1, ty0, ty1 = tile_span(mx, my, rx, ry, ntx, nty, tile_w)
    cx = (tx1 > tx0).to(_I32)
    cy = (ty1 > ty0).to(_I32)
    k0 = torch.where(valid, ((ty0 * ntx + tx0) << db) | qd, sentinel)
    ok1 = valid & ((cx + cy) == 1)
    k1 = torch.where(ok1, (((ty0 + cy) * ntx + (tx0 + cx)) << db) | qd,
                     sentinel)
    return [k0.to(_I32), k1.to(_I32)]


def compact_channels(masks, caps):
    """For each disjoint mask, the first ``cap`` set indices ascending:
    a list of (n_set, idx (cap,), valid (cap,))."""
    n = masks[0].shape[0]
    dev = masks[0].device
    out = []
    iota = torch.arange(n, dtype=torch.int64, device=dev)
    for m, cap in zip(masks, caps):
        key = torch.sort(torch.where(m, iota, n)).values[:min(cap, n)]
        if cap > n:
            key = torch.cat([key, torch.full((cap - n,), n, dtype=torch.int64,
                                             device=dev)])
        out.append((m.sum().to(_I32), torch.clamp(key, max=n - 1), key < n))
    return out


def pool3(a, nty: int, ntx: int):
    """3x3 max over the tile grid with edge replication, flattened."""
    g = a.reshape(1, 1, nty, ntx).to(torch.float64)
    g = F.pad(g, (1, 1, 1, 1), mode="replicate")
    return F.max_pool2d(g, 3, stride=1).reshape(-1).to(a.dtype)


def pool_grant(floor, desired, pool_pairs: int):
    """Floor first (scaled down if the floors oversubscribe the pool), the
    surplus proportionally, in float32 as the port rounds it."""
    fsum = floor.sum().to(_F32)
    pool = torch.full((), pool_pairs, dtype=_F32, device=floor.device)
    fscale = torch.clamp(pool / torch.clamp(fsum, min=1.0), max=1.0)
    floor = torch.minimum((floor.to(_F32) * fscale).to(_I32), floor)
    extra = desired - floor
    spare = (pool_pairs - floor.sum()).to(_F32)
    escale = torch.clamp(spare / torch.clamp(extra.sum(), min=1).to(_F32),
                         0.0, 1.0)
    return floor + (extra.to(_F32) * escale).to(_I32)


def block_snap(kept, desired, cap_steps: int, ntiles: int):
    """Largest-remainder snap of grants to whole CHUNK-pair blocks; tiles
    with a sub-block grant first, ties by tile index."""
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


def tile_rows(startc, kept, sorted_splat):
    """Per-tile kept lists laid out tile after tile, each starting at its
    own CHUNK boundary: (pack_idx, row_begin). Rows between lists point at
    splat 0 and are never read."""
    dev = kept.device
    nblocks = (kept.long() + CHUNK - 1) // CHUNK
    blk_off = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(nblocks, 0)])
    total = int(blk_off[-1]) * CHUNK
    p = torch.arange(total, device=dev)
    owner = torch.searchsorted(blk_off, p // CHUNK, right=True) - 1
    j = p - blk_off[owner] * CHUNK
    live = j < kept[owner]
    srow = torch.where(live, startc[owner].long() + j, 0)
    return sorted_splat[srow], (blk_off[:-1] * CHUNK).to(_I32)


class Binned(NamedTuple):
    pack_idx: torch.Tensor
    row_begin: torch.Tensor
    row_end: torch.Tensor
    kept: torch.Tensor
    count: torch.Tensor
    pack_idx_tl: torch.Tensor | None = None
    row_begin_tl: torch.Tensor | None = None
    row_end_tl: torch.Tensor | None = None
    kept_tl: torch.Tensor | None = None


def exact_pair_cap(n, ntiles, tile_w, knobs) -> int:
    """The most pairs ``n`` splats can emit, plus a chunk a tile."""
    if knobs.get("corner_cap"):
        cap = n * 2 + knobs["corner_cap"] * KX * KY + ntiles * CHUNK
    else:
        cap = n * KX * KY + ntiles * CHUNK
    if knobs.get("big_splat_cap"):
        cap += knobs["big_splat_cap"] * fan_kx(KY2, tile_w) * KY2
        if knobs.get("mid_splat_cap"):
            cap += knobs["mid_splat_cap"] * fan_kx(KY_M, tile_w) * KY_M
            if knobs.get("mid_lo_splat_cap"):
                cap += knobs["mid_lo_splat_cap"] * fan_kx(KY_ML, tile_w) \
                    * KY_ML
    return cap


def bin_splats(planes, ntx, nty, knobs, lod: bool, budget=None) -> Binned:
    """Per-tile front-to-back pair lists from one stable sort of the
    combined keys, then the exact positional cap or the LOD grants."""
    mx, my = planes[0], planes[1]
    valid = torch.isfinite(planes[5])
    r, rx, ry = planes[6], planes[7], planes[8]
    n = mx.shape[0]
    dev = mx.device
    ntiles = ntx * nty
    tile_w = knobs["tile_w"]
    tile_bits = max(ntiles.bit_length(), 1)
    db = min(31 - tile_bits, 22)
    qd = quantize_depth(planes[5], valid, db)
    big, mid, midlo = (knobs.get("big_splat_cap"), knobs.get("mid_splat_cap"),
                       knobs.get("mid_lo_splat_cap"))
    corner_cap = knobs.get("corner_cap")

    def fits(kx_fan, ky_fan):
        lx, ly = fan_limits(kx_fan, ky_fan, tile_w)
        return (rx <= lx) & (ry <= ly)

    small = valid if not big else valid & fits(KX, KY)
    comp = []
    if corner_cap:
        tx0, tx1, ty0, ty1 = tile_span(mx, my, rx, ry, ntx, nty, tile_w)
        corner = small & (tx1 > tx0) & (ty1 > ty0)
        keys = emit_pair(mx, my, rx, ry, small & ~corner, qd, ntx, nty, db,
                         tile_w)
        comp.append((corner, corner_cap, KX, KY))
    else:
        keys = emit_fan(mx, my, rx, ry, r, small, qd, KX, KY, ntx, nty, db,
                        tile_w)
    nl1 = len(keys)
    if big:
        over1 = valid & ~small
        if mid:
            kxm = fan_kx(KY_M, tile_w)
            fits_mid = fits(kxm, KY_M)
            if midlo:
                kxl = fan_kx(KY_ML, tile_w)
                fits_lo = fits(kxl, KY_ML)
                comp.append((over1 & fits_lo, midlo, kxl, KY_ML))
                comp.append((over1 & ~fits_lo & fits_mid, mid, kxm, KY_M))
            else:
                comp.append((over1 & fits_mid, mid, kxm, KY_M))
            comp.append((over1 & ~fits_mid, big, fan_kx(KY2, tile_w), KY2))
        else:
            comp.append((over1, big, fan_kx(KY2, tile_w), KY2))
    ids = [torch.arange(n, dtype=_I32, device=dev).repeat(nl1)]
    if comp:
        for (_, cap, kx_c, ky_c), (nset, bidx, bvalid) in zip(
                comp, compact_channels([c[0] for c in comp],
                                       [c[1] for c in comp])):
            bkeys = emit_fan(mx[bidx], my[bidx], rx[bidx], ry[bidx], r[bidx],
                             bvalid, qd[bidx], kx_c, ky_c, ntx, nty, db,
                             tile_w)
            keys += bkeys
            ids.append(bidx.to(_I32).repeat(len(bkeys)))
    key_flat = torch.cat(keys)
    m = key_flat.shape[0]
    sorted_key, perm = torch.sort(key_flat, stable=True)
    sorted_splat = torch.cat(ids)[perm]
    tvec = torch.arange(ntiles + 1, dtype=_I32, device=dev)
    start = torch.searchsorted(sorted_key, tvec << db, out_int32=True)
    startc = start[:-1]
    count = start[1:] - startc
    if not lod:
        cap_pairs = exact_pair_cap(n, ntiles, tile_w, knobs)
        blk = CHUNK * 8
        mpad = pad_to(m, blk)
        cap_pairs = min(pad_to(min(pad_to(cap_pairs, CHUNK), mpad), blk),
                        mpad)
        kept = torch.clamp(torch.minimum(count, cap_pairs - startc),
                           min=0).to(_I32)
        pack_idx = sorted_splat[:min(cap_pairs, m)]
        return Binned(pack_idx, startc, startc + kept, kept, count)
    mpt = knobs["max_splats_per_tile"]
    qmask = (1 << db) - 1
    dry_need = None
    if budget is not None:
        budget, dry_need = budget[:, 0], budget[:, 1]
        nthr = torch.minimum(count, budget.to(_I32))
    else:
        nthr = torch.clamp(count, max=mpt)
    cut_i = torch.clamp(startc + nthr - 1, 0, m - 1)
    cut_qd = torch.where(count > 0, sorted_key[cut_i.long()] & qmask, 0)
    pooled = pool3(cut_qd, nty, ntx)
    kend = torch.searchsorted(sorted_key, (tvec[:-1] << db) | pooled,
                              right=True, out_int32=True)
    need = torch.maximum(nthr, kend - startc)
    if dry_need is not None:
        need = torch.maximum(need, torch.minimum(count, dry_need.to(_I32)))
    desired = torch.minimum(torch.clamp(need, min=0),
                            torch.clamp(count, max=LOD_DESIRE_CAP * mpt))
    cap_steps = -(-ntiles * mpt // CHUNK)
    kept = pool_grant(torch.minimum(nthr, desired), desired,
                      cap_steps * CHUNK)
    kept = block_snap(kept, desired, cap_steps, ntiles).to(_I32)
    pack_idx, row_begin = tile_rows(startc, kept, sorted_splat)
    out = dict(pack_idx=pack_idx, row_begin=row_begin,
               row_end=row_begin + kept, kept=kept, count=count)
    decim_pairs = knobs.get("lod_tail_decim")
    if decim_pairs:
        want = torch.clamp(count - kept, max=LOD_DESIRE_CAP * decim_pairs)
        steps_tl = -(-ntiles * decim_pairs // CHUNK)
        kept_tl = pool_grant(torch.clamp(want, max=decim_pairs), want,
                             steps_tl * CHUNK)
        kept_tl = block_snap(kept_tl, want, steps_tl, ntiles).to(_I32)
        pack_tl, begin_tl = tile_rows(startc + kept, kept_tl, sorted_splat)
        out.update(pack_idx_tl=pack_tl, row_begin_tl=begin_tl,
                   row_end_tl=begin_tl + kept_tl, kept_tl=kept_tl)
    return Binned(**out)


# ---------------------------------------------------------------------------
# composite
# ---------------------------------------------------------------------------

def tile_samples(ntx, nty, tile_w, decim, dev):
    """(px, py) (ntiles, pixd): sample i of tile t at its quad's centre."""
    twd = tile_w // decim
    pix = (TILE_H // decim) * twd
    tid = torch.arange(ntx * nty, device=dev)
    i = torch.arange(pix, device=dev)
    px = ((i % twd)[None] * decim + ((tid % ntx) * tile_w)[:, None]) \
        .to(_F32) + 0.5 * decim
    py = ((i // twd)[None] * decim + ((tid // ntx) * TILE_H)[:, None]) \
        .to(_F32) + 0.5 * decim
    return px, py


def composite(records, row_begin, row_end, t_entry, ntx, nty, tile_w, decim,
              blend=_F32):
    """Every tile's rows [row_begin, row_end) composited front to back over
    its (decimated) sample grid, from ``t_entry`` (or T = 1), in chunks cut
    at absolute multiples of CHUNK rows; a tile stops after the chunk at
    whose end every sample has T < T_EPS (or at entry). Returns (planes (4,
    ntiles, pixd) float32 = r, g, b, T; exec (ntiles,) int32 rows of the
    chunks run). The blend runs in ``blend``."""
    dev = records.device
    ntiles = ntx * nty
    pix = (TILE_H // decim) * (tile_w // decim)
    nrows = records.shape[0]
    px, py = tile_samples(ntx, nty, tile_w, decim, dev)
    rgb = torch.zeros((3, ntiles, pix), dtype=blend, device=dev)
    tt = (torch.ones((ntiles, pix), dtype=blend, device=dev)
          if t_entry is None else t_entry.to(blend).clone())
    exec_ = torch.zeros(ntiles, dtype=_I32, device=dev)
    begin = row_begin.long()
    end = torch.clamp(row_end.long(), max=nrows)
    first = (begin // CHUNK) * CHUNK
    nch = torch.where(end > begin, (end - first + CHUNK - 1) // CHUNK, 0)
    running = (nch > 0) & (tt.float().amax(1) >= T_EPS)
    group = max(1, (1 << 24) // (CHUNK * pix))
    rows = torch.arange(CHUNK, device=dev)
    nmax = int(nch.max()) if ntiles else 0
    for j in range(nmax):
        act = torch.nonzero(running & (nch > j)).flatten()
        if act.numel() == 0:
            break
        for s in range(0, act.numel(), group):
            g = act[s:s + group]
            idx = (first[g] + j * CHUNK)[:, None] + rows[None]
            live = (idx >= begin[g][:, None]) & (idx < end[g][:, None])
            rec = records[idx.clamp(0, max(nrows - 1, 0))]

            def col(c):
                return rec[:, :, c, None]
            dx = px[g][:, None, :] - col(_MX)
            dy = py[g][:, None, :] - col(_MY)
            power = (-0.5 * (col(_CA) * dx * dx + col(_CC) * dy * dy)
                     - col(_CB) * dx * dy)
            alpha = torch.clamp(col(_OP) * torch.exp(power), max=ALPHA_MAX)
            alpha = torch.where(live[:, :, None] & (alpha >= ALPHA_MIN),
                                alpha, 0.0).to(blend)
            incl = torch.cumprod(1.0 - alpha, dim=1)
            excl = torch.cat([torch.ones_like(incl[:, :1]), incl[:, :-1]], 1)
            t_in = tt[g]
            w = alpha * excl * t_in[:, None, :]
            rgb[:, g] += torch.einsum("gcr,gcp->rgp",
                                      rec[:, :, _CR:_CB2 + 1].to(blend), w)
            t_new = t_in * incl[:, -1]
            tt[g] = t_new
            exec_[g] += live.sum(1).to(_I32)
            running[g] = t_new.float().amax(1) >= T_EPS
    return torch.stack([rgb[0], rgb[1], rgb[2], tt]).to(_F32), exec_


# ---------------------------------------------------------------------------
# finalize, encode, budget
# ---------------------------------------------------------------------------

def untile(plane, nty, ntx, tile_w, decim):
    th, tw = TILE_H // decim, tile_w // decim
    t = plane[..., :nty * ntx, :].reshape(*plane.shape[:-2], nty, ntx, th, tw)
    return t.transpose(-3, -2).reshape(*plane.shape[:-2], nty * th, ntx * tw)


def finalize(planes, visited, nty, ntx, tile_w, tail=None, decim=2):
    """Unvisited tiles to background (black, T = 1), untile, add the
    bilinearly upsampled tail colour and multiply T by its transmittance
    ratio; the background is black, so T adds nothing."""
    vis = visited[:, None]
    r, g, b, t = planes
    rgb = torch.stack([untile(torch.where(vis, p, 0.0), nty, ntx, tile_w, 1)
                       for p in (r, g, b)], -1)
    if tail is not None:
        tl, td, vis_t = tail
        vt = vis_t[:, None]
        ratio = torch.clamp(tl[3] / torch.clamp(td, min=1e-20), 0.0, 1.0)
        low = torch.stack([torch.where(vt, tl[0], 0.0),
                           torch.where(vt, tl[1], 0.0),
                           torch.where(vt, tl[2], 0.0),
                           torch.where(vt, ratio, 1.0)])
        up = F.interpolate(untile(low, nty, ntx, tile_w, decim)[None],
                           size=tuple(rgb.shape[:2]), mode="bilinear",
                           align_corners=False)[0]
        rgb = rgb + up[:3].permute(1, 2, 0)
    return rgb


def encode_u8(rgb) -> torch.Tensor:
    """IEC 61966-2-1 sRGB encode of a linear image, rounded to uint8."""
    c = rgb.clamp(0.0, 1.0)
    s = torch.where(c <= 0.0031308, c * 12.92,
                    1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    return torch.round(s * 255.0).to(torch.uint8)


def next_budget(tile_exec, kept, count, mpt, ntx, nty, dry_floor):
    """The next frame's (ntiles, 2) int32 budget from this frame's executed
    depth: 3x3-max-pooled, grown 1.5x plus a chunk, clamped to [CHUNK,
    LOD_DESIRE_CAP * mpt]; tiles that ran dry get the floor ("jump":
    min(count, DRY_FLOOR_CAP * mpt); "static": mpt) and their count as
    dry need."""
    cap = LOD_DESIRE_CAP * mpt
    b = (pool3(tile_exec, nty, ntx).to(_F32) * 1.5).to(_I32) + CHUNK
    b = torch.clamp(b, CHUNK, cap)
    dry = (kept > 0) & (tile_exec >= kept) & (kept < count)
    if dry_floor == "static":
        b = torch.where(dry, mpt, b)
    else:
        b = torch.maximum(b, torch.where(
            dry, torch.clamp(count, max=DRY_FLOOR_CAP * mpt), 0))
    need = torch.clamp(torch.where(dry, count, 0), 0, cap)
    return torch.stack([b, need], -1).to(_I32)


def initial_budget(ntiles: int, mpt: int, dev) -> torch.Tensor:
    return torch.stack([torch.full((ntiles,), mpt, dtype=_I32, device=dev),
                        torch.zeros(ntiles, dtype=_I32, device=dev)], -1)


class Frame(NamedTuple):
    image: torch.Tensor          # (H, W, 3) uint8 sRGB
    budget: torch.Tensor | None  # the next frame's budget (temporal LOD)
    binned: Binned
    exec_head: torch.Tensor      # (ntiles,) rows the head composite ran
    exec_tail: torch.Tensor | None


def render(cloud: dict, view, proj, width: int, height: int, knobs: dict,
           lod: bool, budget=None, blend=_F32, eye=None) -> Frame:
    """One frame of ``cloud`` under ``knobs`` (exact, or LOD with the
    carried ``budget`` when the knobs are temporal), its splats' colours
    evaluated at ``eye`` where the cloud has higher SH bands."""
    tile_w = knobs["tile_w"]
    ntx, nty = num_tiles(width, height, tile_w)
    max_r = float(level2_max_radius(tile_w) if knobs.get("big_splat_cap")
                  else level1_max_radius(tile_w))
    planes = project(cloud, view, proj, width, height, max_r)
    records = make_records(planes, cloud, sh.colors(cloud, eye))
    temporal = lod and knobs.get("temporal", False)
    b = bin_splats(planes, ntx, nty, knobs, lod,
                   budget if temporal else None)
    head, exec_h = composite(records[b.pack_idx], b.row_begin, b.row_end,
                             None, ntx, nty, tile_w, 1, blend)
    visited = b.kept > 0
    tail, exec_t = None, None
    decim = knobs.get("lod_tail_d", 2)
    if lod and b.pack_idx_tl is not None:
        th = torch.where(visited[:, None], head[3], 1.0)
        nt = th.shape[0]
        td = th.reshape(nt, TILE_H // decim, decim, tile_w // decim,
                        decim).mean(dim=(2, 4)).reshape(nt, -1)
        planes_tl, exec_t = composite(records[b.pack_idx_tl], b.row_begin_tl,
                                      b.row_end_tl, td, ntx, nty, tile_w,
                                      decim, blend)
        tail = (planes_tl, td, b.kept_tl > 0)
    rgb = finalize(head, visited, nty, ntx, tile_w, tail, decim)
    img = encode_u8(rgb[:height, :width])
    nb = None
    if temporal:
        tile_exec = torch.where(visited, exec_h, 0)
        nb = next_budget(tile_exec, b.kept, b.count,
                         knobs["max_splats_per_tile"], ntx, nty,
                         knobs["dry_floor"])
    return Frame(img, nb, b, torch.where(visited, exec_h, 0), exec_t)
