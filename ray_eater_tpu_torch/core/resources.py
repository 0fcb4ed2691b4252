"""Framebuffers, samplers and textures as tensors (counterpart of
``ray_eater_tpu/core/resources.py``; the reference's frame_buffer.zig,
depth.zig, image.zig and texture.zig).

Upload-time tables (the quad-texel pack, the mip pyramid and the subtile
sampler's window table) are built with numpy, bit-identical to the JAX
package's, and then moved to the device. Window tables are float32 only.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from ..io.image import linear_to_srgb, load_image, srgb_to_linear
from ..utils import on_device
from ..utils import pad_to as _pad


# ---------------------------------------------------------------------------
# Framebuffer (frame_buffer.zig + depth.zig + renderpass clear semantics)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Framebuffer:
    """Render target: colour ``(Hp, Wp, 4)`` float32 linear light and depth
    ``(Hp, Wp)`` float32. The width is padded to a multiple of 128 and the
    height to a multiple of 8 at creation; ``width``/``height`` are the
    logical extent (crop on present)."""

    color: torch.Tensor
    depth: torch.Tensor
    width: int
    height: int

    @property
    def padded_width(self) -> int:
        return self.color.shape[1]

    @property
    def padded_height(self) -> int:
        return self.color.shape[0]


def create_framebuffer(width: int, height: int,
                       clear_color=(0.0, 0.0, 0.0, 1.0),
                       clear_depth: float = 1.0, row_align: int = 8,
                       lane_align: int = 128,
                       device="cuda") -> Framebuffer:
    """Allocate and clear a framebuffer (the reference clears to black and
    depth 1.0 at vkCmdBeginRenderPass, renderpass.zig:128-132)."""
    wp, hp = _pad(width, lane_align), _pad(height, row_align)
    color = on_device(clear_color, device).expand(hp, wp, 4).contiguous()
    depth = torch.full((hp, wp), clear_depth, dtype=torch.float32,
                       device=device)
    return Framebuffer(color=color, depth=depth, width=width, height=height)


def clear(fb: Framebuffer, clear_color=(0.0, 0.0, 0.0, 1.0),
          clear_depth: float = 1.0) -> Framebuffer:
    """A cleared framebuffer of the same size (renderpass.zig:126-141)."""
    color = on_device(clear_color, fb.color.device).expand(
        fb.color.shape).contiguous()
    return Framebuffer(color=color,
                       depth=torch.full_like(fb.depth, clear_depth),
                       width=fb.width, height=fb.height)


# ---------------------------------------------------------------------------
# Textures + samplers (image.zig:85-129, texture.zig)
# ---------------------------------------------------------------------------

class Filter(enum.Enum):
    NEAREST = "nearest"
    LINEAR = "linear"


class AddressMode(enum.Enum):
    """Wrap modes of the reference sampler (image.zig:96-101)."""
    REPEAT = "repeat"
    MIRRORED_REPEAT = "mirrored_repeat"
    CLAMP_TO_EDGE = "clamp_to_edge"


@dataclasses.dataclass(frozen=True)
class Sampler:
    """Static sampler state (image.zig:85-129). ``mipmap`` builds a pyramid
    at upload and samples trilinearly with a per-pixel LOD; with a window
    table, ``subtile`` selects the subtile window sampler (kernel K9) over
    the per-pixel gather; ``subtile_fallback`` is the share of a frame's
    subtiles that may re-sample through the gather path when their LOD
    range escapes the window level (0 disables)."""
    filter: Filter = Filter.LINEAR
    address_mode: AddressMode = AddressMode.MIRRORED_REPEAT
    mipmap: bool = False
    max_anisotropy: float = 1.0
    subtile: bool = True
    subtile_fallback: float = 0.125


@dataclasses.dataclass
class Texture:
    """2D texture: ``data`` ``(H, W, 4)`` float32 linear light, plus the
    upload-time tables of the LINEAR paths: ``packed`` ``(H, W, 4)`` int32
    quad-texel table (texels [t00, t10, t01, t11] as little-endian RGBA8,
    neighbours resolved under the address mode), ``mip_table`` the
    quad-packed pyramid ``(sum h_l*w_l, 4)`` int32 with
    ``mip_dims = ((h_l, w_l, row_offset), ...)``, and ``win_table``
    ``(NWIN, 4*32, 32)`` float32 (or bfloat16, ``window_dtype``): every
    16-strided 32x32 texel window of every level, channel-blocked, with
    ``win_dims = ((nwy_l, nwx_l, window_offset), ...)``."""
    data: torch.Tensor
    sampler: Sampler = dataclasses.field(default=Sampler())
    packed: torch.Tensor | None = None
    packed_srgb: bool = False
    mip_table: torch.Tensor | None = None
    mip_dims: tuple = ()
    win_table: torch.Tensor | None = None
    win_dims: tuple = ()

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]


def _pack_quad_texels(u8: np.ndarray, mode: AddressMode) -> np.ndarray:
    """(H, W, 4) uint8 to (H, W, 4) int32: [t00, t10, t01, t11], each texel
    RGBA8 packed little-endian, the +1 neighbour wrapped (REPEAT) or
    clamped (MIRRORED_REPEAT, CLAMP: the sampler pre-wraps coordinates in
    continuous space, so base indices always land in range)."""
    h, w = u8.shape[:2]

    def nxt(n, size):
        i = np.arange(size) + n
        if mode is AddressMode.REPEAT:
            return np.mod(i, size)
        return np.clip(i, 0, size - 1)

    def rgba8(t):
        t = t.astype(np.int64)
        q = t[..., 0] | (t[..., 1] << 8) | (t[..., 2] << 16) | (t[..., 3] << 24)
        return q.astype(np.uint32).astype(np.int32)  # wrap, not overflow

    x1 = nxt(1, w)
    y1 = nxt(1, h)
    return np.stack([rgba8(u8), rgba8(u8[:, x1]), rgba8(u8[y1, :]),
                     rgba8(u8[y1][:, x1])], -1)


def _build_mip_pyramid(u8: np.ndarray, linear: np.ndarray, srgb: bool,
                       mode: AddressMode):
    """Box-filtered pyramid, filtered in linear light and re-encoded to
    RGBA8 (sRGB when the base is), quad-packed per level into one flat
    table. Returns (table (sum h_l*w_l, 4) int32, mip_dims, level u8s)."""
    levels, dims, u8s, off = [], [], [], 0
    lvl_lin = linear
    lvl_u8 = u8
    while True:
        h, w = lvl_u8.shape[:2]
        levels.append(_pack_quad_texels(lvl_u8, mode).reshape(h * w, 4))
        dims.append((h, w, off))
        u8s.append(lvl_u8)
        off += h * w
        if h == 1 and w == 1:
            break
        h2, w2 = max(h // 2, 1), max(w // 2, 1)
        # 2x2 box in linear light (odd tails fold into the last cell)
        acc = np.zeros((h2, w2, 4), np.float64)
        cnt = np.zeros((h2, w2, 1), np.float64)
        for dy in range(2):
            for dx in range(2):
                sub = lvl_lin[dy::2, dx::2][:h2, :w2]
                acc[:sub.shape[0], :sub.shape[1]] += sub
                cnt[:sub.shape[0], :sub.shape[1]] += 1
        lvl_lin = (acc / cnt).astype(np.float32)
        enc = lvl_lin.copy()
        if srgb:
            enc[..., :3] = linear_to_srgb(enc[..., :3])
        lvl_u8 = np.clip(np.round(enc * 255.0), 0, 255).astype(np.uint8)
    return np.concatenate(levels), tuple(dims), u8s


#: window geometry of the subtile sampler: 32x32-texel windows at stride 16
_WIN = 32
_WIN_STRIDE = 16


def _build_win_table(lvl_u8s, srgb: bool, mode: AddressMode):
    """Every 16-strided 32x32 window of every mip level as a channel-blocked
    (4*32, 32) float32 block of linear texels decoded from the same u8
    levels as the pyramid. REPEAT wraps window content cyclically;
    CLAMP/MIRRORED clamp. Returns (table (NWIN, 128, 32), win_dims)."""
    wins, dims, off = [], [], 0
    for lvl_u8 in lvl_u8s:
        h, w = lvl_u8.shape[:2]
        f = lvl_u8.astype(np.float32) / 255.0
        if srgb:
            f[..., :3] = srgb_to_linear(f[..., :3])
        if mode is AddressMode.REPEAT:
            nwy = max(h // _WIN_STRIDE, 1)
            nwx = max(w // _WIN_STRIDE, 1)
        else:
            nwy, nwx = -(-h // _WIN_STRIDE), -(-w // _WIN_STRIDE)
        iy = np.arange(nwy * _WIN_STRIDE + _WIN_STRIDE)
        ix = np.arange(nwx * _WIN_STRIDE + _WIN_STRIDE)
        if mode is AddressMode.REPEAT:
            iy, ix = iy % h, ix % w
        else:
            iy, ix = np.clip(iy, 0, h - 1), np.clip(ix, 0, w - 1)
        ext = f[iy][:, ix]                              # (Hext, Wext, 4)
        sw = np.lib.stride_tricks.sliding_window_view(
            ext, (_WIN, _WIN), axis=(0, 1))[::_WIN_STRIDE, ::_WIN_STRIDE]
        wins.append(np.ascontiguousarray(sw).reshape(
            nwy * nwx, 4 * _WIN, _WIN))
        dims.append((nwy, nwx, off))
        off += nwy * nwx
    return np.concatenate(wins).astype(np.float32), tuple(dims)


def _windows_fit(h0: int, w0: int, mode: AddressMode) -> bool:
    """Whether the window table can cover every level: clamp-extended
    windows fit any size; REPEAT windows wrap cyclically, so every level
    must tile the 16-texel stride (n % 16 == 0) or divide it."""
    if mode is not AddressMode.REPEAT:
        return True

    def rep_ok(n):
        while n > 1:
            if n % 16 and 16 % n:
                return False
            n = max(n // 2, 1)
        return True
    return rep_ok(h0) and rep_ok(w0)


def texture_from_array(rgba_u8: np.ndarray, sampler: Sampler | None = None,
                       srgb: bool = True, pack: bool = True,
                       device="cuda",
                       window_dtype: torch.dtype = torch.float32) -> Texture:
    """Upload an ``(H, W, 4)`` uint8 image as a texture (Image.fromFile
    analog, image.zig:436-463): host decode, then one copy per table.

    ``window_dtype=torch.bfloat16`` (the JAX package's
    ``RAYEATER_WIN_BF16=1``) stores the subtile sampler's window table in
    bfloat16 (rounded to nearest even): half the bytes a window, at ~2^-9
    relative texel error; the sampler then rounds its tap weights to
    bfloat16 too and accumulates in float32."""
    if window_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_dtype {window_dtype} is not float32 or "
                         "bfloat16")
    sampler = sampler or Sampler()
    rgba_u8 = np.asarray(rgba_u8)
    f = rgba_u8.astype(np.float32) / 255.0
    if srgb:
        f[..., :3] = srgb_to_linear(f[..., :3])

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    packed = mip_table = win_table = None
    mip_dims = win_dims = ()
    if pack and sampler.filter is Filter.LINEAR:
        packed = put(_pack_quad_texels(rgba_u8, sampler.address_mode))
        if sampler.mipmap:
            table, mip_dims, lvl_u8s = _build_mip_pyramid(
                rgba_u8, f, srgb, sampler.address_mode)
            mip_table = put(table)
            if _windows_fit(*rgba_u8.shape[:2], sampler.address_mode):
                wt, win_dims = _build_win_table(lvl_u8s, srgb,
                                                sampler.address_mode)
                win_table = put(wt).to(window_dtype)
    return Texture(data=put(f), sampler=sampler, packed=packed,
                   packed_srgb=bool(srgb), mip_table=mip_table,
                   mip_dims=mip_dims, win_table=win_table,
                   win_dims=win_dims)


def texture_from_file(path: str, sampler: Sampler | None = None,
                      srgb: bool = True, pack: bool = True,
                      device="cuda",
                      window_dtype: torch.dtype = torch.float32) -> Texture:
    """``TexImage.fromFile`` (texture.zig:52-74): decode the image file
    with :func:`load_image` and upload it as :func:`texture_from_array`
    does."""
    return texture_from_array(load_image(path), sampler, srgb=srgb,
                              pack=pack, device=device,
                              window_dtype=window_dtype)
