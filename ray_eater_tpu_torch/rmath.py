"""Camera math for the 3DGS path, in float32 with the JAX ``rmath`` op order.

Counterpart of ``ray_eater_tpu/rmath.py`` (the subset the flythrough camera
needs). Matrices are logical row-major ``(4, 4)`` float32 tensors that
multiply column vectors on the right. Functions that take tensors follow
their device; functions that build tensors from Python numbers take
``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import math

import torch

#: World up vector of the reference engine (math.zig:8).
GLOBAL_UP = (0.0, -1.0, 0.0)

_F32 = torch.float32


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return torch.tensor(x, dtype=_F32, device=device)


def vec(*vals, device="cuda") -> torch.Tensor:
    """Float32 vector from scalars (or from one sequence of scalars)."""
    if len(vals) == 1 and not isinstance(vals[0], (int, float)):
        vals = tuple(vals[0])
    return torch.stack([_f32(v, device).reshape(()) for v in vals])


def radians(deg, device="cuda") -> torch.Tensor:
    """Degrees to radians, as float32 ``deg * f32(pi/180)``."""
    d = _f32(deg, device)
    return d * torch.tensor(math.pi / 180.0, dtype=_F32, device=d.device)


def mag(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length ``sqrt(sum(v * v))``."""
    return torch.sqrt(torch.sum(v * v))


def norm(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|``."""
    return v / mag(v)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D cross product."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vector subtract."""
    return a - b


def look_at_zforward(eye: torch.Tensor, center: torch.Tensor,
                     world_up: torch.Tensor | None = None) -> torch.Tensor:
    """Right-handed view matrix: rows (right, up, +forward), translation
    ``-R @ eye``, so camera-forward maps to +z_view = distance in front
    (the 3DGS convention of ``rmath.look_at_zforward`` in the JAX package).
    The product ``-R @ eye`` is written out as three ordered multiply-adds so
    that it rounds the same on every device."""
    eye = eye.to(_F32)
    center = center.to(_F32)
    if world_up is None:
        world_up = torch.tensor(GLOBAL_UP, dtype=_F32, device=eye.device)
    z = norm(sub(center, eye))       # forward
    x = norm(cross(z, world_up))     # right
    y = norm(cross(x, z))            # up
    rot3 = torch.stack([x, y, z])
    nr = -rot3
    t = nr[:, 0] * eye[0] + nr[:, 1] * eye[1] + nr[:, 2] * eye[2]
    top = torch.cat([rot3, t[:, None]], 1)
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=_F32,
                          device=eye.device)
    return torch.cat([top, bottom], 0)


def perspective(fov, aspect, near, far, device="cuda") -> torch.Tensor:
    """Vulkan-style projection: ``vp = 1/tan(fov/2)``, Y negated, depth in
    [0, 1], ``w_clip = +z_view``."""
    fov = _f32(fov, device)
    dev = fov.device
    aspect = torch.tensor(aspect, dtype=_F32, device=dev)
    near = torch.tensor(near, dtype=_F32, device=dev)
    far = torch.tensor(far, dtype=_F32, device=dev)
    vp = 1.0 / torch.tan(fov / 2.0)
    as_ = vp / aspect
    z = torch.zeros_like(vp)
    o = torch.ones_like(vp)
    return torch.stack([
        torch.stack([as_, z, z, z]),
        torch.stack([z, -vp, z, z]),
        torch.stack([z, z, o * (far / (far - near)),
                     o * (-(near * far) / (far - near))]),
        torch.stack([z, z, o, z]),
    ])
