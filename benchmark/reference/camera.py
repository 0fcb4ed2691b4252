"""The orbit camera of the benchmark's traffic, in plain PyTorch.

A frozen copy of the flythrough camera of the repository's ``bench.py``
(radius 2.5, height 0.8 above the origin, 60 degree vertical field of
view), with ``rmath.look_at_zforward`` and ``rmath.perspective`` written
out. The azimuth comes in as a 0-d float32 tensor, so the same function
builds the camera inside a captured frame step (every constant is a fill
on the device, no host-to-device copy) and in the reference.
"""

from __future__ import annotations

import torch

_F32 = torch.float32
#: the view matrix's world up, as ``rmath.GLOBAL_UP``
_UP = (0.0, -1.0, 0.0)


def _const(value: float, dev) -> torch.Tensor:
    return torch.full((), value, dtype=_F32, device=dev)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def look_at_zforward(eye: torch.Tensor) -> torch.Tensor:
    """(4, 4) view matrix looking from ``eye`` at the origin: rows (right,
    up, +forward), translation ``-R @ eye`` as three ordered multiply-adds
    (``rmath.look_at_zforward``)."""
    dev = eye.device
    up = torch.stack([_const(u, dev) for u in _UP])
    z = _norm(-eye)
    x = _norm(_cross(z, up))
    y = _norm(_cross(x, z))
    rot3 = torch.stack([x, y, z])
    nr = -rot3
    t = nr[:, 0] * eye[0] + nr[:, 1] * eye[1] + nr[:, 2] * eye[2]
    bottom = torch.stack([_const(0.0, dev), _const(0.0, dev),
                          _const(0.0, dev), _const(1.0, dev)])[None]
    return torch.cat([torch.cat([rot3, t[:, None]], 1), bottom], 0)


def perspective(fov_deg: float, aspect: float, near: float, far: float,
                dev) -> torch.Tensor:
    """Vulkan-style projection (``rmath.perspective``): ``1/tan(fov/2)``,
    Y negated, depth in [0, 1], ``w_clip = +z_view``."""
    fov = _const(fov_deg, dev) * _const(3.141592653589793 / 180.0, dev)
    vp = 1.0 / torch.tan(fov / 2.0)
    as_ = vp / _const(aspect, dev)
    z, o = torch.zeros_like(vp), torch.ones_like(vp)
    return torch.stack([
        torch.stack([as_, z, z, z]),
        torch.stack([z, -vp, z, z]),
        torch.stack([z, z, o * (far / (far - near)),
                     o * (-(near * far) / (far - near))]),
        torch.stack([z, z, o, z]),
    ])


def orbit_view(az: torch.Tensor, cam: dict, width: int, height: int):
    """(view, proj, eye): the (4, 4) float32 matrices of the orbit camera at
    azimuth ``az`` (0-d float32 radians) for the traffic's ``cam``
    parameters (radius, height, fov_deg, near, far), and its (3,) eye, at
    which the splats' view-dependent colours are evaluated."""
    dev = az.device
    eye = torch.stack([cam["radius"] * torch.cos(az),
                       _const(cam["height"], dev),
                       cam["radius"] * torch.sin(az)])
    view = look_at_zforward(eye)
    proj = perspective(cam["fov_deg"], width / height, cam["near"],
                       cam["far"], dev)
    return view, proj, eye
