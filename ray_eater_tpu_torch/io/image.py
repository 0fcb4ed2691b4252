"""sRGB transfer functions and a PNG writer (counterpart of
``ray_eater_tpu/io/image.py``).

The port keeps its own copy: the JAX module's encoders import ``jax.numpy``.
``save_png`` writes the file with the standard library alone (``zlib`` +
``struct``), since the port needs no image package; ``load_image`` is not
ported (textures are uploaded from arrays).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


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
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def save_png(path: str, rgba_u8: np.ndarray) -> None:
    """Write ``(H, W, 3|4)`` uint8 to a PNG file (the 'present to disk'
    egress that replaces swapchain present, queue.zig:77-91)."""
    with open(path, "wb") as f:
        f.write(encode_png(rgba_u8))
