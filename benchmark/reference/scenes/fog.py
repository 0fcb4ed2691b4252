"""The fog scene: ``n`` splats uniform in a cube, random anisotropic scales
and rotations, opacities in [0.3, 1) and DC colours (the distributions of
``random_cloud`` in ``models/gaussians.py``, as ``bench_cloud("fog")``
calls it: extent 1, scales in [0.004, 0.02)), and where the parameters
give an ``sh_degree`` higher SH bands (``reference.sh.draw_rest``), drawn
on the device from the run's generator."""

from __future__ import annotations

import torch

from .. import sh


def make(p: dict, gen: torch.Generator, dev) -> dict:
    n, ext = p["num_splats"], p["extent"]
    lo, hi = p["scale_range"]
    f32 = dict(dtype=torch.float32, device=dev, generator=gen)
    means = (torch.rand((n, 3), **f32) * 2 - 1) * ext
    scales = lo + torch.rand((n, 3), **f32) * (hi - lo)
    q = torch.randn((n, 4), **f32)
    q = q / torch.linalg.norm(q, dim=1, keepdim=True)
    opac = 0.3 + 0.7 * torch.rand(n, **f32)
    colors = torch.rand((n, 3), **f32)
    return dict(means=means, scales=scales, quats=q, opacities=opac,
                colors=colors, **sh.draw_rest(p, n, gen, dev))
