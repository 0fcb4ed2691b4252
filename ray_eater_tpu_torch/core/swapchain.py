"""Present encode (counterpart of ``ray_eater_tpu/core/swapchain.py``'s
:func:`encode_present`; the r8g8b8a8 surface-format conversion of
swapchain.zig:44-49). The present ring and resize are not ported.
"""

from __future__ import annotations

import torch

from ..io.image import linear_to_srgb


def encode_present(color: torch.Tensor, width: int, height: int,
                   srgb: bool = True) -> torch.Tensor:
    """Crop ``color`` (Hp, Wp, 4) to its logical extent, encode linear to
    sRGB when ``srgb`` (alpha clipped to [0, 1]) or else clip all four
    channels, and round to uint8 RGBA on the tensor's device."""
    img = color[:height, :width, :]
    if srgb:
        rgb = linear_to_srgb(img[..., :3])
        img = torch.cat([rgb, img[..., 3:].clamp(0.0, 1.0)], -1)
    else:
        img = img.clamp(0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)
