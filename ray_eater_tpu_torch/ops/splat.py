"""Particle splatting, the compute pass of the compute_drawing sample
(counterpart of ``ray_eater_tpu/ops/splat.py``;
samples/compute_drawing/shaders/compute_slime.glsl).

Each particle writes a ``2*radius``-wide square of one colour into a
storage image. Box semantics as in the GLSL and the JAX package:
``pos = ivec2(int(x), int(y))`` truncates toward zero, and the box is
``[max(0, p - radius), min(res, p + radius))``, half-open, on each axis. A
particle whose box lies wholly off the image writes nothing. The GLSL's
dispatch quirks are not reproduced: every particle passed in is splatted.

Kernel K10 (``csrc/splat.cu``) builds the coverage mask on CUDA tensors
in one launch that writes each mask word once (each CTA gathers the boxes
that meet its region); :func:`_splat_plain` builds it on CPU tensors.
"""

from __future__ import annotations

import torch

from ..utils import pad_to
from . import _cuda

_F32 = torch.float32
_I32 = torch.int32

TILE_H = 8     # the mask is padded to (8, 128) tiles, as in the JAX package
TILE_W = 128


def _splat_plain(positions: torch.Tensor, height: int, width: int,
                 radius: int) -> torch.Tensor:
    """Plain version of K10: each non-empty box adds +1 at two corners and
    -1 at the other two of an integer difference image, whose 2D prefix
    sum counts the boxes covering each pixel; covered pixels are 1.0."""
    dev = positions.device
    xi = positions[:, 0].to(_I32).long()      # truncation toward zero
    yi = positions[:, 1].to(_I32).long()
    x0, x1 = (xi - radius).clamp(min=0), (xi + radius).clamp(max=width)
    y0, y1 = (yi - radius).clamp(min=0), (yi + radius).clamp(max=height)
    live = (x0 < x1) & (y0 < y1)
    x0, x1, y0, y1 = x0[live], x1[live], y0[live], y1[live]
    diff = torch.zeros((height + 1, width + 1), dtype=_I32, device=dev)
    one = torch.ones_like(x0, dtype=_I32)
    for ys, xs, sign in ((y0, x0, 1), (y0, x1, -1), (y1, x0, -1),
                         (y1, x1, 1)):
        diff.index_put_((ys, xs), one * sign, accumulate=True)
    count = diff.cumsum(0).cumsum(1)[:height, :width]
    mask = torch.zeros((pad_to(height, TILE_H), pad_to(width, TILE_W)),
                       dtype=_F32, device=dev)
    mask[:height, :width] = (count > 0).to(_F32)
    return mask


def _splat_fake(positions, height, width, radius):
    return positions.new_empty((pad_to(height, TILE_H), pad_to(width,
                                                               TILE_W)))


@_cuda.kernel_op("k10_splat", _splat_plain, _splat_fake)
def _k10_op(positions: torch.Tensor, height: int, width: int,
            radius: int) -> torch.Tensor:
    """K10's launch: the (pad_to(height, 8), pad_to(width, 128)) f32
    mask, written whole by the kernel."""
    dev = _cuda.cuda_device(positions, "K10 splat")
    n = positions.shape[0]
    _cuda.check_arg(positions, "positions", _F32, (n, 2), dev)
    if positions.data_ptr() % 8:        # the kernel reads float2
        positions = positions.clone()
    hp, wp = pad_to(height, TILE_H), pad_to(width, TILE_W)
    mask = torch.empty((hp, wp), dtype=_F32, device=dev)
    with torch.cuda.device(dev):
        err = _cuda.lib().splat_mask(
            positions.data_ptr(), n, int(radius), width, height, hp, wp,
            mask.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(err, "K10 splat")
    _cuda.launches["k10_splat"] += 1
    return mask


def _splat_k10(positions: torch.Tensor, height: int, width: int,
               radius: int) -> torch.Tensor:
    """K10 wrapper (the op ``rayeater::k10_splat``; same output as
    :func:`_splat_plain`). CPU tensors take the plain version; CUDA
    tensors launch the kernel (or raise)."""
    _cuda.op_device(positions, "K10 splat")
    return _k10_op(positions, int(height), int(width), int(radius))


def launch_floor() -> None:
    """Launch one empty kernel on the current CUDA stream (the floor under
    any single launch, timed beside K10); raises if the loaded kernel
    library has none (an older ``csrc``)."""
    import ctypes
    fn = _cuda.lib().splat_launch_floor
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    _cuda.check(fn(torch.cuda.current_stream().cuda_stream), "launch floor")


def splat_mask(positions: torch.Tensor, height: int, width: int,
               radius: int) -> torch.Tensor:
    """Coverage mask ``(pad_to(height, 8), pad_to(width, 128))`` float32 of
    square splats at ``positions`` (N, 2) pixel coordinates: 1.0 inside
    any particle's box, 0.0 elsewhere and in the padding."""
    return _splat_k10(positions.to(_F32).contiguous(), height, width, radius)


def splat_particles(image: torch.Tensor, positions: torch.Tensor, color,
                    radius: int) -> torch.Tensor:
    """The compute pass: ``color`` squares over ``image`` (H, W, 4); an RGB
    colour gets alpha 1. Returns the new image (the functional
    ``imageStore``)."""
    h, w = image.shape[0], image.shape[1]
    mask = splat_mask(positions, h, w, radius)[:h, :w]
    col = torch.as_tensor(color, dtype=_F32, device=image.device)
    if col.shape[-1] == 3:
        col = torch.cat([col, torch.ones(1, dtype=_F32, device=col.device)])
    return torch.where(mask[..., None] > 0.5, col, image)
