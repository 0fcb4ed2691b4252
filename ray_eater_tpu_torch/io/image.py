"""sRGB transfer functions, a PNG writer and reader (counterpart of
``ray_eater_tpu/io/image.py``).

The port keeps its own copy: the JAX module's encoders import ``jax.numpy``.
``save_png`` writes the file with the standard library alone (``zlib`` +
``struct``), and :func:`decode_png` reads the PNGs the native decoder
reads (8-bit, non-interlaced, grey, grey + alpha, RGB, RGBA) the same way,
so the port needs no image package. :func:`load_image` takes the native
tier's decoder when it is built, then :func:`decode_png`, then PIL where
it can be imported (other formats, 16-bit, palette or interlaced PNGs).
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import torch

from ..utils.logging import scoped

_log = scoped("io")
_PNG_SIG = b"\x89PNG\r\n\x1a\n"
#: channels of each supported PNG colour type: grey, RGB, grey + alpha, RGBA
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def srgb_to_linear(c: np.ndarray) -> np.ndarray:
    """IEC 61966-2-1 decode (what the hardware does when sampling an
    _srgb-format image, image.zig:449)."""
    c = np.asarray(c, np.float32)
    return np.where(c <= 0.04045, c / 12.92, ((c + 0.055) / 1.055) ** 2.4)


def linear_to_srgb(c):
    """IEC 61966-2-1 encode, on a numpy array or a tensor."""
    if isinstance(c, torch.Tensor):
        c = c.clamp(0.0, 1.0)
        return torch.where(c <= 0.0031308, c * 12.92,
                           1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    c = np.clip(c, 0.0, 1.0)
    return np.where(c <= 0.0031308, c * 12.92,
                    1.055 * np.power(c, 1.0 / 2.4) - 0.055)


def to_srgb_u8(img) -> np.ndarray:
    """Linear-light float image (array or tensor) to sRGB-encoded uint8 on
    the host."""
    if isinstance(img, torch.Tensor):
        enc = torch.round(linear_to_srgb(img.float()) * 255.0)
        return enc.to(torch.uint8).cpu().numpy()
    return np.round(linear_to_srgb(np.asarray(img, np.float32)) * 255.0
                    ).astype(np.uint8)


def _chunk(tag: bytes, data: bytes) -> bytes:
    body = tag + data
    return (struct.pack(">I", len(data)) + body
            + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))


def encode_png(rgba_u8: np.ndarray) -> bytes:
    """``(H, W, 3|4)`` uint8 to PNG bytes: 8-bit RGB or RGBA, every row
    with filter 0, one zlib stream."""
    img = np.ascontiguousarray(rgba_u8, np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected (H, W, 3|4) uint8, got {img.shape}")
    h, w, ch = img.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, w * ch)], 1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6 if ch == 4 else 2, 0, 0, 0)
    return (_PNG_SIG + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, rgba_u8: np.ndarray) -> None:
    """Write ``(H, W, 3|4)`` uint8 to a PNG file (the 'present to disk'
    egress that replaces swapchain present, queue.zig:77-91)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba_u8))


class UnsupportedPNG(ValueError):
    """A PNG outside :func:`decode_png`'s scope (bit depth, colour type or
    interlace), named in the message."""


def _png_chunks(data: bytes):
    """(tag, body) of each chunk after the signature, up to IEND."""
    pos = len(_PNG_SIG)
    while pos + 8 <= len(data):
        n, = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        yield tag, body
        if tag == b"IEND":
            return
        pos += 12 + n


def _paeth_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        line[i] = (line[i] + (a if pa <= pb and pa <= pc
                              else b if pb <= pc else c)) & 255


def _average_row(line: bytearray, prior: bytes, bpp: int) -> None:
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        line[i] = (line[i] + ((a + prior[i]) >> 1)) & 255


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes to an (h, w, c) uint8 array, c the colour type's channels
    (grey 1, grey + alpha 2, RGB 3, RGBA 4), with the standard library
    alone: ``zlib`` and the five row filters (None, Sub, Up, Average,
    Paeth). Only 8-bit non-interlaced PNGs of colour types 0, 2, 4 and 6
    are read, the native decoder's scope; any other raises
    :class:`UnsupportedPNG` naming the bit depth, colour type or
    interlace. Sub and Up rows are reconstructed with numpy across the
    row; Average and Paeth depend on the byte to the left and run byte by
    byte."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG (bad signature)")
    head, idat = None, []
    for tag, body in _png_chunks(data):
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"IDAT":
            idat.append(body)
    if head is None:
        raise ValueError("PNG without an IHDR chunk")
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8:
        raise UnsupportedPNG(f"PNG bit depth {depth} is not supported "
                             "(8-bit only)")
    if ctype not in _PNG_CHANNELS:
        kind = "palette" if ctype == 3 else "unknown"
        raise UnsupportedPNG(f"PNG colour type {ctype} ({kind}) is not "
                             "supported (grey, grey + alpha, RGB, RGBA)")
    if interlace != 0:
        raise UnsupportedPNG(f"interlaced PNG (method {interlace}) is not "
                             "supported")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, -1)
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line
        elif ft == 1:
            cur = np.cumsum(line.reshape(w, bpp), 0, dtype=np.uint8)
        elif ft == 2:
            cur = line + prior
        elif ft in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ft == 3 else _paeth_row)(buf, prior.tobytes(),
                                                      bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y} has filter type {ft}")
        out[y] = cur.reshape(-1)
        prior = out[y]
    return out.reshape(h, w, bpp)


def _to_rgba(arr: np.ndarray) -> np.ndarray:
    """(h, w, c) uint8 with c = 1 (grey), 2 (grey + alpha), 3 or 4 to
    (h, w, 4) RGBA; a missing alpha is 255."""
    if arr.shape[-1] == 4:
        return arr
    if arr.shape[-1] == 3:
        a = np.full((*arr.shape[:2], 1), 255, np.uint8)
        return np.concatenate([arr, a], -1)
    if arr.shape[-1] == 1:
        return np.concatenate([arr] * 3 + [np.full_like(arr, 255)], -1)
    rgb = np.repeat(arr[..., :1], 3, -1)    # grey + alpha
    return np.concatenate([rgb, arr[..., 1:2]], -1)


def load_image(path: str) -> np.ndarray:
    """Decode an image file to ``(H, W, 4)`` uint8 RGBA. A PNG goes to the
    native tier's decoder when it is built, else to :func:`decode_png`;
    what neither reads goes to PIL where it can be imported, and otherwise
    raises (:class:`UnsupportedPNG` for a PNG outside their scope)."""
    with open(path, "rb") as f:
        data = f.read()
    unsupported = None
    if data[:8] == _PNG_SIG:
        from ..native import loader as native
        if native.available():
            try:
                return _to_rgba(native.png_decode(data))
            except ValueError as e:
                _log.debug("native PNG decode of %s failed (%s)", path, e)
        try:
            return _to_rgba(decode_png(data))
        except UnsupportedPNG as e:
            unsupported = e
    try:
        from PIL import Image
    except ImportError:
        if unsupported is not None:
            raise unsupported
        raise ValueError(f"{path}: not a PNG, and PIL is not available "
                         "to read it") from None
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGBA"), np.uint8)
