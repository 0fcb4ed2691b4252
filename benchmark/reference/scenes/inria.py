"""The INRIA-like scene (the distributions of ``inria_cloud`` in
``models/gaussians.py``): 90% flat tangent disks on a bumpy unit sphere
shell with log-normal sizes (median ~6e-3) and Beta(5, 1.2) opacities, 10%
faint floaters with log-normal per-axis sizes and Beta(1.3, 4) opacities
through the camera orbit's volume, and where the parameters give an
``sh_degree`` higher SH bands (``reference.sh.draw_rest``), drawn on the
device from the run's generator."""

from __future__ import annotations

import torch

from .. import sh


def _beta(a: float, b: float, n: int, gen, dev) -> torch.Tensor:
    """Beta(a, b) as X / (X + Y) of two Gamma draws. ``_standard_gamma``
    takes no generator argument, so the run's generator is the device's
    default one (``benchmark/harness/scene.py`` seeds it)."""
    x = torch._standard_gamma(torch.full((n,), a, device=dev))
    y = torch._standard_gamma(torch.full((n,), b, device=dev))
    return x / (x + y)


def make(p: dict, gen: torch.Generator, dev) -> dict:
    n = p["num_splats"]
    n_surf = int(n * p["surface_share"])
    n_fl = n - n_surf
    lo, hi = p["disk_scale_range"]
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    # the shell: uniform directions, low-frequency radial bumps
    v = torch.randn((n_surf, 3), **f32)
    v = v / torch.linalg.norm(v, dim=1, keepdim=True).clamp(min=1e-9)
    bump = (0.08 * torch.sin(4.0 * v[:, 0] + 1.0) * torch.sin(5.0 * v[:, 1])
            + 0.05 * torch.sin(7.0 * v[:, 2]))
    means_s = v * (1.0 + bump)[:, None]
    s_t = lo + torch.rand((n_surf, 2), **f32) * (hi - lo)
    scales_s = torch.cat([s_t, torch.full((n_surf, 1), 0.1 * lo,
                                          device=dev)], -1)
    # the quaternion that turns +z onto the outward normal
    z = torch.zeros_like(v)
    z[:, 2] = 1.0
    axis = torch.linalg.cross(z, v)
    axn = torch.linalg.norm(axis, dim=1, keepdim=True)
    cosang = v[:, 2:3]
    w = torch.sqrt(torch.clamp((1.0 + cosang) * 0.5, min=0.0))
    s = torch.sqrt(torch.clamp((1.0 - cosang) * 0.5, min=0.0))
    xaxis = torch.zeros_like(v)
    xaxis[:, 0] = 1.0
    axis = torch.where(axn > 1e-6, axis / axn.clamp(min=1e-9), xaxis)
    quats_s = torch.cat([w, axis * s], -1)
    # heavy-tailed disk sizes: log-normal, median ~6e-3
    ln = torch.exp(torch.randn((n_surf, 1), **f32) * 0.7 - 5.1)
    scales_s = scales_s * (ln / 0.008)
    opac_s = torch.clamp(_beta(5.0, 1.2, n_surf, gen, dev), 0.05, 1.0)
    colors_s = 0.25 + 0.75 * torch.rand((n_surf, 3), **f32)
    # the floaters, through the orbit's volume
    box = torch.tensor(p["floater_box"], dtype=torch.float32, device=dev)
    means_f = (torch.rand((n_fl, 3), **f32) * 2 - 1) * box
    scales_f = torch.exp(torch.randn((n_fl, 3), **f32) * 1.0 - 4.2)
    q = torch.randn((n_fl, 4), **f32)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True).clamp(min=1e-9)
    opac_f = torch.clamp(_beta(1.3, 4.0, n_fl, gen, dev), 0.02, 0.95)
    colors_f = torch.rand((n_fl, 3), **f32)
    return dict(means=torch.cat([means_s, means_f]),
                scales=torch.cat([scales_s, scales_f]),
                quats=torch.cat([quats_s, q]),
                opacities=torch.cat([opac_s, opac_f]),
                colors=torch.cat([colors_s, colors_f]),
                **sh.draw_rest(p, n, gen, dev))
