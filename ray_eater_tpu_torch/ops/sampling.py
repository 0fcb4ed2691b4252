"""Texture sampling, the combined-image-sampler analog (counterpart of
``ray_eater_tpu/ops/sampling.py``).

Vulkan-convention normalized-coordinate sampling (``texture(tex, uv)`` of
shader.frag:19) with the reference sampler's address modes and filters
(image.zig:85-129). The gather paths (NEAREST, the packed quad-texel
table, the unpacked float table, the per-pixel trilinear mip gather) are
torch indexing. The subtile window sampler (:func:`_sample_subtile`) picks
one mip level per 16x16 subtile on the host side of the call, then kernel
K9 (``csrc/sampling.cu``) fetches and filters both trilinear taps from the
texture's window table; subtiles whose per-pixel LOD range escapes the
chosen levels re-sample through the gather path under a budget, worst
first.

The float32 arithmetic keeps the JAX package's operands and order, so the
two packages pick the same levels, windows and texels.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.resources import _WIN, _WIN_STRIDE, AddressMode, Filter, Texture
from . import _cuda

_F32 = torch.float32
_I32 = torch.int32

_SUB = 16            # subtile pixel extent (16x16 px)
_SPIX = _SUB * _SUB
_C = 4


def _fmod(x: torch.Tensor, y) -> torch.Tensor:
    """Floor-signed float remainder as JAX computes ``jnp.mod``: C ``fmod``,
    then ``+ y`` where the signs differ."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _wrap(i: torch.Tensor, n: int, mode: AddressMode) -> torch.Tensor:
    """Apply an address mode to integer texel indices."""
    if mode is AddressMode.REPEAT:
        return torch.remainder(i, n)
    if mode is AddressMode.MIRRORED_REPEAT:
        m = torch.remainder(i, 2 * n)
        return torch.where(m >= n, 2 * n - 1 - m, m)
    return i.clamp(0, n - 1)  # CLAMP_TO_EDGE


def _lerp2(t00, t10, t01, t11, fx, fy):
    top = t00 * (1.0 - fx) + t10 * fx
    bot = t01 * (1.0 - fx) + t11 * fx
    return top * (1.0 - fy) + bot * fy


def sample(tex: Texture, uv: torch.Tensor,
           valid: torch.Tensor | None = None) -> torch.Tensor:
    """Sample ``tex`` at normalized ``uv`` (..., 2): (..., 4) linear RGBA.

    Texel addressing ``t = uv * size - 0.5``, the filter applied in texel
    space. ``valid`` (same shape as ``uv[..., 0]``, bool) is the deferred
    G-buffer's coverage: the subtile sampler leaves uncovered pixels out of
    each subtile's footprint (their output is unspecified; the caller masks
    it)."""
    data = tex.data
    h, w = data.shape[0], data.shape[1]
    s = tex.sampler
    u = uv[..., 0] * w - 0.5
    v = uv[..., 1] * h - 0.5

    if s.filter is Filter.NEAREST:
        xi = _wrap(torch.floor(u + 0.5).to(_I32), w, s.address_mode)
        yi = _wrap(torch.floor(v + 0.5).to(_I32), h, s.address_mode)
        return data[yi.long(), xi.long()]

    if s.mipmap and tex.mip_table is not None and uv.ndim >= 3:
        if (tex.win_table is not None and uv.ndim == 3 and s.subtile
                and min(uv.shape[0], uv.shape[1]) >= _SUB):
            return _sample_subtile(tex, uv, valid=valid)
        return _sample_mip(tex, uv)

    if tex.packed is not None:
        # quad-texel table: one 4-int32 row gather fetches the 2x2 RGBA8
        # neighbourhood, decoded after the gather
        xi, fx = _packed_coords(uv[..., 0], w, s.address_mode)
        yi, fy = _packed_coords(uv[..., 1], h, s.address_mode)
        quad = tex.packed.reshape(h * w, 4)[(yi * w + xi).reshape(-1).long()]
        quad = quad.reshape(*yi.shape, 4)
        t00, t10, t01, t11 = (_decode_rgba8(quad[..., k], tex.packed_srgb)
                              for k in range(4))
        return _lerp2(t00, t10, t01, t11, fx[..., None], fy[..., None])
    x0 = torch.floor(u).to(_I32)
    y0 = torch.floor(v).to(_I32)
    fx = (u - x0.to(_F32))[..., None]
    fy = (v - y0.to(_F32))[..., None]
    x0w = _wrap(x0, w, s.address_mode).long()
    y0w = _wrap(y0, h, s.address_mode).long()
    x1w = _wrap(x0 + 1, w, s.address_mode).long()
    y1w = _wrap(y0 + 1, h, s.address_mode).long()
    return _lerp2(data[y0w, x0w], data[y0w, x1w], data[y1w, x0w],
                  data[y1w, x1w], fx, fy)


def _decode_rgba8(q: torch.Tensor, srgb: bool) -> torch.Tensor:
    """(...,) int32 little-endian RGBA8 to (..., 4) float32; RGB through the
    IEC 61966-2-1 decode when ``srgb``. (``pow`` may differ from XLA's by
    an ulp.)"""
    ch = [((q >> (8 * k)) & 255).to(_F32) * (1.0 / 255.0) for k in range(4)]
    if srgb:
        ch[:3] = [torch.where(c <= 0.04045, c * (1.0 / 12.92),
                              torch.pow((c + 0.055) * (1.0 / 1.055), 2.4))
                  for c in ch[:3]]
    return torch.stack(ch, -1)


def _packed_coords(u_norm: torch.Tensor, n: int, mode: AddressMode):
    """Base index and filter fraction for the quad-texel table; the address
    mode is applied in continuous coordinates so the base index is always
    in range."""
    if mode is AddressMode.REPEAT:
        t = u_norm * n - 0.5
        i0 = torch.floor(t).to(_I32)
        return torch.remainder(i0, n), t - i0.to(_F32)
    if mode is AddressMode.MIRRORED_REPEAT:
        m = _fmod(u_norm, 2.0)
        u_norm = torch.where(m <= 1.0, m, 2.0 - m)
    else:  # CLAMP_TO_EDGE
        u_norm = u_norm.clamp(0.0, 1.0)
    t = (u_norm * n - 0.5).clamp(0.0, n - 1.0)
    i0 = torch.floor(t).to(_I32)
    return i0, t - i0.to(_F32)


def _packed_coords_n(u_norm: torch.Tensor, n: torch.Tensor,
                     mode: AddressMode):
    """:func:`_packed_coords` with a per-pixel level size ``n`` (int32)."""
    nf = n.to(_F32)
    if mode is AddressMode.REPEAT:
        t = u_norm * nf - 0.5
        i0 = torch.floor(t).to(_I32)
        return torch.remainder(i0, n), t - i0.to(_F32)
    if mode is AddressMode.MIRRORED_REPEAT:
        m = _fmod(u_norm, 2.0)
        u_norm = torch.where(m <= 1.0, m, 2.0 - m)
    else:  # CLAMP_TO_EDGE
        u_norm = u_norm.clamp(0.0, 1.0)
    t = torch.minimum((u_norm * nf - 0.5).clamp(min=0.0), nf - 1.0)
    i0 = torch.floor(t).to(_I32)
    return i0, t - i0.to(_F32)


def _mip_tap(tex: Texture, u, v, level: torch.Tensor) -> torch.Tensor:
    """One bilinear tap at a per-pixel integer mip level: one row gather
    into the flat quad-packed pyramid."""
    s = tex.sampler
    h0, w0 = tex.mip_dims[0][0], tex.mip_dims[0][1]
    hl = (torch.full_like(level, h0) >> level).clamp(min=1)
    wl = (torch.full_like(level, w0) >> level).clamp(min=1)
    off = torch.zeros_like(level)
    for li, (_, _, o) in enumerate(tex.mip_dims):
        off = torch.where(level == li, o, off)
    xi, fx = _packed_coords_n(u, wl, s.address_mode)
    yi, fy = _packed_coords_n(v, hl, s.address_mode)
    quad = tex.mip_table[(off + yi * wl + xi).reshape(-1).long()]
    quad = quad.reshape(*yi.shape, 4)
    t00, t10, t01, t11 = (_decode_rgba8(quad[..., k], tex.packed_srgb)
                          for k in range(4))
    return _lerp2(t00, t10, t01, t11, fx[..., None], fy[..., None])


def _ddiff(a: torch.Tensor, dim: int) -> torch.Tensor:
    """Forward difference along ``dim``, the last one repeated."""
    d = torch.diff(a, dim=dim)
    return torch.cat([d, d.narrow(dim, d.shape[dim] - 1, 1)], dim)


def _pixel_lod(tex: Texture, u, v, nlev: int) -> torch.Tensor:
    """Per-pixel LOD from screen-space uv derivatives (edge-replicated
    forward differences) with the anisotropic LOD-sharpening
    approximation, clipped to [0, nlev - 1]."""
    h0, w0 = tex.mip_dims[0][0], tex.mip_dims[0][1]
    dudx, dvdx = _ddiff(u, -1) * w0, _ddiff(v, -1) * h0
    dudy, dvdy = _ddiff(u, -2) * w0, _ddiff(v, -2) * h0
    ddx = dudx * dudx + dvdx * dvdx
    ddy = dudy * dudy + dvdy * dvdy
    r_max = torch.sqrt(torch.maximum(ddx, ddy).clamp(min=1e-20))
    r_min = torch.sqrt(torch.minimum(ddx, ddy).clamp(min=1e-20))
    aniso = (r_max / r_min).clamp(1.0, float(tex.sampler.max_anisotropy))
    lod = torch.log2((r_max / aniso).clamp(min=1.0))
    return lod.clamp(0.0, float(nlev - 1))


def _sample_mip(tex: Texture, uv: torch.Tensor) -> torch.Tensor:
    """Trilinear mipmapped sampling with a per-pixel LOD: two gather taps
    at adjacent levels, lerped."""
    nlev = len(tex.mip_dims)
    u, v = uv[..., 0], uv[..., 1]
    lod = _pixel_lod(tex, u, v, nlev)
    l0 = torch.floor(lod).to(_I32)
    frac = (lod - l0.to(_F32))[..., None]
    a = _mip_tap(tex, u, v, l0)
    b = _mip_tap(tex, u, v, torch.clamp(l0 + 1, max=nlev - 1))
    return a * (1.0 - frac) + b * frac


def _tcoord(c, n, repeat: bool):
    """Continuous texel coordinate at level size ``n`` (the -0.5 Vulkan
    convention). REPEAT keeps it unwrapped (window content wraps
    cyclically); pre-wrapped CLAMP/MIRRORED coordinates clip into
    [0, n - 1]."""
    t = c * n - 0.5
    if repeat:
        return t
    if isinstance(n, torch.Tensor):
        return torch.minimum(t.clamp(min=0.0), n - 1.0)
    return t.clamp(0.0, n - 1.0)


class SubtilePlan(NamedTuple):
    """The per-subtile inputs of K9 and of the fallback, for ``ns`` 16x16
    subtiles of a frame padded to (hp, wp)."""
    w0i: torch.Tensor     # (ns,) int32 window of the lsub tap
    w1i: torch.Tensor     # (ns,) int32 window of the l1 tap
    planes: tuple         # ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac
    cus: torch.Tensor     # (ns, 256) pre-wrapped u
    cvs: torch.Tensor     # (ns, 256) pre-wrapped v
    lods: torch.Tensor    # (ns, 256) per-pixel LOD
    lsub: torch.Tensor    # (ns,) int32 window-fitted level
    l1: torch.Tensor      # (ns,) int32 second tap level
    hp: int
    wp: int


def _subtile_plan(tex: Texture, uv: torch.Tensor,
                  valid: torch.Tensor | None = None) -> SubtilePlan:
    """Level choice of the subtile sampler: per 16x16 subtile, the finest
    level that its derivative LOD allows and whose texel footprint fits a
    32x32 window of the table (the exact fit test: the window origin snaps
    down to the 16 grid), then window ids and window-local coordinate
    planes for both taps (lsub, lsub + 1)."""
    s = tex.sampler
    nlev = len(tex.win_dims)
    repeat = s.address_mode is AddressMode.REPEAT
    u, v = uv[..., 0], uv[..., 1]
    H, W = u.shape
    lod = _pixel_lod(tex, u, v, nlev)

    # continuous address pre-wrap
    if s.address_mode is AddressMode.MIRRORED_REPEAT:
        mu, mv = _fmod(u, 2.0), _fmod(v, 2.0)
        cu = torch.where(mu <= 1.0, mu, 2.0 - mu)
        cv = torch.where(mv <= 1.0, mv, 2.0 - mv)
    elif repeat:
        cu, cv = u, v
    else:
        cu, cv = u.clamp(0.0, 1.0), v.clamp(0.0, 1.0)

    # pad to subtile multiples (edge-replicate) and cut into subtiles
    hp, wp = -(-H // _SUB) * _SUB, -(-W // _SUB) * _SUB
    dev = u.device
    rows = torch.arange(hp, device=dev).clamp(max=H - 1)
    cols = torch.arange(wp, device=dev).clamp(max=W - 1)

    def st(a):
        a = a[rows][:, cols]
        return a.reshape(hp // _SUB, _SUB, wp // _SUB, _SUB).permute(
            0, 2, 1, 3).reshape(-1, _SPIX)

    cus, cvs, lods = st(cu), st(cv), st(lod)
    if valid is not None:
        # uncovered pixels take the subtile's covered-mean coordinates and
        # covered-max LOD, so the footprint sees only covered pixels
        vs = st(valid)
        cnt = vs.sum(1, keepdim=True).clamp(min=1)
        mu = torch.where(vs, cus, 0.0).sum(1, keepdim=True) / cnt
        mv = torch.where(vs, cvs, 0.0).sum(1, keepdim=True) / cnt
        ml = torch.where(vs, lods, 0.0).amax(1, keepdim=True)
        cus = torch.where(vs, cus, mu)
        cvs = torch.where(vs, cvs, mv)
        lods = torch.where(vs, lods, ml)

    cu_min, cu_max = cus.amin(1), cus.amax(1)
    cv_min, cv_max = cvs.amin(1), cvs.amax(1)
    lmin = torch.floor(lods.amin(1)).to(_I32)
    lsub = torch.full(cu_min.shape, nlev - 1, dtype=_I32, device=dev)

    def axfit(cmin, cmax, n):
        lo = torch.floor(_tcoord(cmin, float(n), repeat))
        hi = torch.floor(_tcoord(cmax, float(n), repeat))
        org = torch.floor(lo / _WIN_STRIDE) * _WIN_STRIDE
        return hi + 1 - org <= _WIN - 1

    for li in range(nlev - 1, -1, -1):
        hh, ww_ = tex.mip_dims[li][0], tex.mip_dims[li][1]
        fit = (axfit(cu_min, cu_max, ww_) & axfit(cv_min, cv_max, hh)
               & (lmin <= li))
        lsub = torch.where(fit, li, lsub)
    l1 = torch.clamp(lsub + 1, max=nlev - 1)
    frac = (lods - lsub[:, None].to(_F32)).clamp(0.0, 1.0)

    def tap_planes(lvl):
        zero = torch.zeros_like(lvl)
        wl, hl, off, nwy, nwx = zero, zero, zero, zero, zero
        for li, (ny, nx, o) in enumerate(tex.win_dims):
            sel = lvl == li
            hh, ww_ = tex.mip_dims[li][0], tex.mip_dims[li][1]
            wl = torch.where(sel, ww_, wl)
            hl = torch.where(sel, hh, hl)
            off = torch.where(sel, o, off)
            nwy = torch.where(sel, ny, nwy)
            nwx = torch.where(sel, nx, nwx)
        tu = _tcoord(cus, wl[:, None].to(_F32), repeat)
        tv = _tcoord(cvs, hl[:, None].to(_F32), repeat)
        ty, tx = torch.floor(tv), torch.floor(tu)
        fy, fx = tv - ty, tu - tx
        ty, tx = ty.to(_I32), tx.to(_I32)
        oy = torch.div(ty.amin(1), _WIN_STRIDE, rounding_mode="floor")
        ox = torch.div(tx.amin(1), _WIN_STRIDE, rounding_mode="floor")
        widx = (off + torch.remainder(oy, nwy) * nwx
                + torch.remainder(ox, nwx)).to(_I32)
        ty_l = (ty - oy[:, None] * _WIN_STRIDE).clamp(0, _WIN - 2)
        tx_l = (tx - ox[:, None] * _WIN_STRIDE).clamp(0, _WIN - 2)
        return widx, (ty_l.to(_I32).contiguous(), fy.contiguous(),
                      tx_l.to(_I32).contiguous(), fx.contiguous())

    w0i, p0 = tap_planes(lsub)
    w1i, p1 = tap_planes(l1)
    return SubtilePlan(w0i.contiguous(), w1i.contiguous(),
                       (*p0, *p1, frac.contiguous()), cus, cvs, lods, lsub,
                       l1, hp, wp)


def _fallback_budget(ns: int, fb_frac: float) -> int:
    """Subtiles the binding fallback may re-sample: ceil(ns * fb_frac) to a
    multiple of 8, at least 8, at most ns."""
    return min(ns, max(8, -(-int(ns * fb_frac) // 8) * 8))


def _binding(plan: SubtilePlan):
    """(severity, binding): how far each subtile's per-pixel LOD range
    escapes its tap levels [lsub, l1], and whether that exceeds 0.01."""
    sev = ((plan.lsub.to(_F32) - plan.lods.amin(1)).clamp(min=0.0)
           + (plan.lods.amax(1) - plan.l1.to(_F32)).clamp(min=0.0))
    return sev, sev > 0.01


def _subtile_plain(w0i, w1i, ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac,
                   win_table) -> torch.Tensor:
    """Plain version of K9: per pixel, the two bilinear taps read from the
    32x32 windows ``w0i``/``w1i`` at window-local (ty, tx), lerped by
    ``frac``. With a bfloat16 ``win_table`` the x weights (1 - fx, fx) are
    rounded to bfloat16 first (the JAX kernel's bf16 contraction) and the
    sums run in float32. Returns (ns, 4, 256) float32."""
    flat = win_table.reshape(-1)
    bf16 = win_table.dtype == torch.bfloat16

    def weight(v):
        return v.to(torch.bfloat16).to(_F32) if bf16 else v

    def tap(wid, ty, fy, tx, fx):
        base = (wid.long() * (_C * _WIN * _WIN))[:, None] + (
            ty.long() * _WIN + tx.long())
        gx, wx = weight(1.0 - fx), weight(fx)
        out = []
        for c in range(_C):
            i = base + c * _WIN * _WIN
            r0 = flat[i].to(_F32) * gx + flat[i + 1].to(_F32) * wx
            r1 = (flat[i + _WIN].to(_F32) * gx
                  + flat[i + _WIN + 1].to(_F32) * wx)
            out.append(r0 * (1.0 - fy) + r1 * fy)
        return out

    a = tap(w0i, ty0, fy0, tx0, fx0)
    b = tap(w1i, ty1, fy1, tx1, fx1)
    return torch.stack([a[c] * (1.0 - frac) + b[c] * frac
                        for c in range(_C)], 1)


def _subtile_fake(w0i, w1i, ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac,
                  win_table):
    return frac.new_empty((frac.shape[0], _C, _SPIX))


@_cuda.kernel_op("k9_subtile", _subtile_plain, _subtile_fake)
def _k9_op(w0i: torch.Tensor, w1i: torch.Tensor, ty0: torch.Tensor,
           fy0: torch.Tensor, tx0: torch.Tensor, fx0: torch.Tensor,
           ty1: torch.Tensor, fy1: torch.Tensor, tx1: torch.Tensor,
           fx1: torch.Tensor, frac: torch.Tensor,
           win_table: torch.Tensor) -> torch.Tensor:
    """K9's launch: (ns, 4, 256) f32; the float32 or the bfloat16
    instantiation by the window table's dtype."""
    dev = _cuda.cuda_device(frac, "K9 subtile sampler")
    args = (w0i, w1i, ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac,
            win_table)
    ns = frac.shape[0]
    nwin = win_table.shape[0]
    _cuda.check_arg(w0i, "w0i", _I32, (ns,), dev)
    _cuda.check_arg(w1i, "w1i", _I32, (ns,), dev)
    for name, t, dt in (("ty0", ty0, _I32), ("fy0", fy0, _F32),
                        ("tx0", tx0, _I32), ("fx0", fx0, _F32),
                        ("ty1", ty1, _I32), ("fy1", fy1, _F32),
                        ("tx1", tx1, _I32), ("fx1", fx1, _F32),
                        ("frac", frac, _F32)):
        _cuda.check_arg(t, name, dt, (ns, _SPIX), dev)
    bf16 = win_table.dtype == torch.bfloat16
    _cuda.check_arg(win_table, "win_table", torch.bfloat16 if bf16 else _F32,
                    (nwin, _C * _WIN, _WIN), dev)
    out = torch.empty((ns, _C, _SPIX), dtype=_F32, device=dev)
    entry = (_cuda.lib().subtile_sample_bf16 if bf16
             else _cuda.lib().subtile_sample)
    with torch.cuda.device(dev):
        err = entry(
            *(t.data_ptr() for t in args), out.data_ptr(), ns,
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K9 subtile sampler")
    _cuda.launches["k9_subtile"] += 1
    return out


def _subtile_call(w0i, w1i, ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac,
                  win_table) -> torch.Tensor:
    """K9 wrapper (the op ``rayeater::k9_subtile``): (ns, 4, 256) float32.
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    _cuda.op_device(frac, "K9 subtile sampler")
    return _k9_op(w0i, w1i, ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac,
                  win_table)


def _sample_subtile(tex: Texture, uv: torch.Tensor,
                    valid: torch.Tensor | None = None) -> torch.Tensor:
    """Subtile window sampler: trilinear mipmapped sampling with no
    per-pixel gather outside the binding fallback.

    The level per subtile comes from :func:`_subtile_plan`; K9 fetches and
    filters both taps. A subtile is binding when its tap range [lsub, l1]
    does not cover its per-pixel LOD range; up to
    ``ceil(subtile_fallback * ns)`` of them, worst first (a stable sort of
    the severities, so ties at the cut pick the lower subtile index),
    re-sample through the per-pixel gather path and replace their kernel
    rows."""
    s = tex.sampler
    nlev = len(tex.win_dims)
    H, W = uv.shape[0], uv.shape[1]
    plan = _subtile_plan(tex, uv, valid)
    ns = plan.cus.shape[0]
    flat = _subtile_call(plan.w0i, plan.w1i, *plan.planes, tex.win_table)

    if s.subtile_fallback > 0.0:
        nb = _fallback_budget(ns, s.subtile_fallback)
        sev, bind = _binding(plan)
        sel = torch.argsort(-sev, stable=True)[:nb]
        lod_s = plan.lods[sel]
        l0s = torch.floor(lod_s).to(_I32)
        frs = (lod_s - l0s.to(_F32))[..., None]
        a = _mip_tap(tex, plan.cus[sel], plan.cvs[sel], l0s)
        b = _mip_tap(tex, plan.cus[sel], plan.cvs[sel],
                     torch.clamp(l0s + 1, max=nlev - 1))
        fb = (a * (1.0 - frs) + b * frs).transpose(1, 2)   # (nb, C, SPIX)
        slot = torch.zeros(ns, dtype=torch.long, device=uv.device)
        slot[sel] = torch.arange(nb, device=uv.device)
        use = torch.zeros(ns, dtype=torch.bool, device=uv.device)
        use[sel] = bind[sel]
        flat = torch.where(use[:, None, None], fb[slot], flat)
    hp, wp = plan.hp, plan.wp
    img = flat.reshape(hp // _SUB, wp // _SUB, _C, _SUB, _SUB).permute(
        0, 3, 1, 4, 2).reshape(hp, wp, _C)
    return img[:H, :W]
