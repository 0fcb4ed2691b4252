"""Gaussian splat scenes (counterpart of ``ray_eater_tpu/models/gaussians.py``).

The generators draw from the same ``np.random.RandomState`` stream as the
JAX package, so a seed gives bit-identical arrays in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

_FIELDS = ("means", "scales", "quats", "opacities", "colors")


@dataclass
class GaussianCloud:
    """Struct-of-arrays splat scene (all float32, one device):
    means (N,3) world positions; scales (N,3) linear std-devs;
    quats (N,4) rotations (w,x,y,z); opacities (N,) in [0,1];
    colors (N,3) linear RGB; sh_rest (N, B, 3) optional higher-order
    spherical-harmonic coefficients (their evaluation is not ported)."""

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    colors: torch.Tensor
    sh_rest: torch.Tensor | None = None

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]


def gaussian_cloud(means, scales, quats, opacities, colors, sh_rest=None,
                   device="cuda") -> GaussianCloud:
    """Build a cloud from array-likes, as float32 on ``device``."""
    def f(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)
    n = np.asarray(means).reshape(-1, 3).shape[0]
    return GaussianCloud(means=f(means).reshape(-1, 3),
                         scales=f(scales).reshape(-1, 3),
                         quats=f(quats).reshape(-1, 4),
                         opacities=f(opacities).reshape(-1),
                         colors=f(colors).reshape(-1, 3),
                         sh_rest=(None if sh_rest is None
                                  else f(sh_rest).reshape(n, -1, 3)))


def cloud_from_numpy(d: Mapping[str, np.ndarray],
                     device="cuda") -> GaussianCloud:
    """Cloud from a mapping of numpy arrays keyed by field name (``means``,
    ``scales``, ``quats``, ``opacities``, ``colors``, optional
    ``sh_rest``) — the way a JAX cloud's fields cross into the port."""
    return gaussian_cloud(*(d[k] for k in _FIELDS),
                          sh_rest=d.get("sh_rest"), device=device)


def random_cloud(n: int, seed: int = 0, extent: float = 1.0,
                 scale_range=(0.005, 0.03), device="cuda") -> GaussianCloud:
    """Synthetic benchmark scene: n splats in a cube, random anisotropic
    scales/rotations/colors (the 1M-splat "fog" generator)."""
    rng = np.random.RandomState(seed)
    means = (rng.rand(n, 3).astype(np.float32) * 2 - 1) * extent
    scales = (scale_range[0] + rng.rand(n, 3).astype(np.float32)
              * (scale_range[1] - scale_range[0]))
    q = rng.randn(n, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    opac = (0.3 + 0.7 * rng.rand(n)).astype(np.float32)
    colors = rng.rand(n, 3).astype(np.float32)
    return gaussian_cloud(means, scales, q, opac, colors, device=device)
