"""The unbounded scene: a Mip-NeRF 360-like capture (Barron et al. 2022)
at the scale of 3DGS's largest trained scenes, whose orbit camera stands
inside it. Four parts, in this order, drawn on the device from the run's
generator:

* the object (``object_share``): flat tangent disks on a bumpy shell of
  radius ``object_radius`` about the origin, log-normal sizes (median
  ``object_size``), Beta(5, 1.2) opacities;
* the ground (``ground_share``): flat disks on the plane y =
  ``ground_y`` at a log-uniform distance from the y axis in
  ``ground_radius``, sized ``ground_size`` x (1 + distance), Beta(5, 1.2)
  opacities;
* the background (``background_share``): disks facing the origin on a
  shell at a log-uniform radius in ``background_radius`` (inside the
  camera's far plane), sized ``background_size`` x radius, Beta(5, 1.2)
  opacities;
* the floaters (the rest): faint splats (Beta(1.3, 4)) with log-normal
  per-axis sizes (median ``floater_size``) in the box ``floater_box``
  (low corner, high corner), which holds the camera's path;

every size with a log-normal spread of ``size_sigma``, random DC colours,
and where the parameters give an ``sh_degree`` higher SH bands
(``reference.sh.draw_rest``)."""

from __future__ import annotations

import math

import torch

from .. import sh
from .inria import _beta


def _facing(normal: torch.Tensor) -> torch.Tensor:
    """(n, 4) unit quaternions (w, x, y, z) that turn +z onto the unit
    ``normal`` (n, 3)."""
    z = torch.zeros_like(normal)
    z[:, 2] = 1.0
    axis = torch.linalg.cross(z, normal)
    axn = torch.linalg.norm(axis, dim=1, keepdim=True)
    cosang = normal[:, 2:3]
    w = torch.sqrt(torch.clamp((1.0 + cosang) * 0.5, min=0.0))
    s = torch.sqrt(torch.clamp((1.0 - cosang) * 0.5, min=0.0))
    xaxis = torch.zeros_like(normal)
    xaxis[:, 0] = 1.0
    axis = torch.where(axn > 1e-6, axis / axn.clamp(min=1e-9), xaxis)
    return torch.cat([w, axis * s], -1)


def _unit(n: int, f32: dict) -> torch.Tensor:
    v = torch.randn((n, 3), **f32)
    return v / torch.linalg.norm(v, dim=1, keepdim=True).clamp(min=1e-9)


def _log_uniform(lo: float, hi: float, n: int, f32: dict) -> torch.Tensor:
    return torch.exp(math.log(lo) + torch.rand(n, **f32)
                     * (math.log(hi) - math.log(lo)))


def _disks(size: torch.Tensor, sigma: float, f32: dict) -> torch.Tensor:
    """(n, 3) scales of flat disks: the tangent axes ``size`` (n,) each
    with a log-normal spread, the normal axis a tenth of the smaller."""
    n = size.shape[0]
    t = size[:, None] * torch.exp(torch.randn((n, 2), **f32) * sigma)
    return torch.cat([t, 0.1 * t.min(1, keepdim=True).values], -1)


def make(p: dict, gen: torch.Generator, dev) -> dict:
    n = p["num_splats"]
    n_obj = int(n * p["object_share"])
    n_gnd = int(n * p["ground_share"])
    n_bg = int(n * p["background_share"])
    n_fl = n - n_obj - n_gnd - n_bg
    sig = p["size_sigma"]
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)

    # the object: a bumpy shell, disks tangent to it
    v = _unit(n_obj, f32)
    bump = (0.08 * torch.sin(4.0 * v[:, 0] + 1.0) * torch.sin(5.0 * v[:, 1])
            + 0.05 * torch.sin(7.0 * v[:, 2]))
    means_o = v * (p["object_radius"] * (1.0 + bump))[:, None]
    scales_o = _disks(torch.full((n_obj,), p["object_size"], device=dev),
                      sig, f32)
    quats_o = _facing(v)

    # the ground: disks on the plane y = ground_y, normal along y
    r = _log_uniform(*p["ground_radius"], n_gnd, f32)
    phi = torch.rand(n_gnd, **f32) * (2.0 * math.pi)
    means_g = torch.stack([r * torch.cos(phi),
                           torch.full_like(r, p["ground_y"]),
                           r * torch.sin(phi)], -1)
    scales_g = _disks(p["ground_size"] * (1.0 + r), sig, f32)
    up = torch.zeros((n_gnd, 3), device=dev)
    up[:, 1] = 1.0
    quats_g = _facing(up)

    # the background: disks on a far shell, facing the origin
    u = _unit(n_bg, f32)
    rb = _log_uniform(*p["background_radius"], n_bg, f32)
    means_b = u * rb[:, None]
    scales_b = _disks(p["background_size"] * rb, sig, f32)
    quats_b = _facing(-u)

    # the floaters, through the camera's path
    lo = torch.tensor(p["floater_box"][0], dtype=torch.float32, device=dev)
    hi = torch.tensor(p["floater_box"][1], dtype=torch.float32, device=dev)
    means_f = lo + torch.rand((n_fl, 3), **f32) * (hi - lo)
    scales_f = p["floater_size"] * torch.exp(
        torch.randn((n_fl, 3), **f32) * p["floater_sigma"])
    q = torch.randn((n_fl, 4), **f32)
    quats_f = q / torch.linalg.norm(q, dim=1, keepdim=True).clamp(min=1e-9)

    n_solid = n_obj + n_gnd + n_bg
    opac = torch.cat([
        torch.clamp(_beta(5.0, 1.2, n_solid, gen, dev), 0.05, 1.0),
        torch.clamp(_beta(1.3, 4.0, n_fl, gen, dev), 0.02, 0.95)])
    colors = torch.rand((n, 3), **f32)
    return dict(means=torch.cat([means_o, means_g, means_b, means_f]),
                scales=torch.cat([scales_o, scales_g, scales_b, scales_f]),
                quats=torch.cat([quats_o, quats_g, quats_b, quats_f]),
                opacities=opac, colors=colors,
                **sh.draw_rest(p, n, gen, dev))
