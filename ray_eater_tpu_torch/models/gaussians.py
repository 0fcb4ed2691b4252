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


def _shell_arrays(n: int, seed: int, radius: float, scale_range):
    """numpy float32 (means, scales, quats, opacities, colors) of
    :func:`shell_cloud`."""
    rng = np.random.RandomState(seed)
    # uniform directions + low-frequency radial bumps for parallax
    v = rng.randn(n, 3).astype(np.float32)
    v /= np.linalg.norm(v, axis=1, keepdims=True).clip(1e-9)
    bump = (0.08 * np.sin(4.0 * v[:, 0] + 1.0) * np.sin(5.0 * v[:, 1])
            + 0.05 * np.sin(7.0 * v[:, 2]))
    r = radius * (1.0 + bump).astype(np.float32)
    means = v * r[:, None]
    # tangent disks: thin along the normal
    s_t = (scale_range[0] + rng.rand(n, 2).astype(np.float32)
           * (scale_range[1] - scale_range[0]))
    scales = np.concatenate([s_t, np.full((n, 1), 0.1 * scale_range[0],
                                          np.float32)], -1)
    # quaternion rotating +z onto the outward normal v: axis = z x v
    z = np.array([0.0, 0.0, 1.0], np.float32)
    axis = np.cross(np.broadcast_to(z, v.shape), v)
    axn = np.linalg.norm(axis, axis=1, keepdims=True)
    cosang = v[:, 2:3]
    w = np.sqrt(np.maximum((1.0 + cosang) * 0.5, 0.0))
    s = np.sqrt(np.maximum((1.0 - cosang) * 0.5, 0.0))
    axis = np.where(axn > 1e-6, axis / np.maximum(axn, 1e-9),
                    np.array([1.0, 0.0, 0.0], np.float32))
    quats = np.concatenate([w, axis * s], -1).astype(np.float32)
    opac = (0.55 + 0.45 * rng.rand(n)).astype(np.float32)
    colors = (0.25 + 0.75 * rng.rand(n, 3)).astype(np.float32)
    return tuple(np.asarray(a, np.float32)
                 for a in (means, scales, quats, opac, colors))


def shell_cloud(n: int, seed: int = 0, radius: float = 1.0,
                scale_range=(0.004, 0.012), device="cuda") -> GaussianCloud:
    """Surface-like scene: n flat tangent-disk splats on a bumpy sphere
    shell (the depth/opacity statistics of a trained reconstruction)."""
    return gaussian_cloud(*_shell_arrays(n, seed, radius, scale_range),
                          device=device)


def inria_cloud(n: int, seed: int = 0, extent: float = 1.4,
                device="cuda") -> GaussianCloud:
    """INRIA-like synthetic scene (the "inria" bench scene): 90% shell
    disks with log-normal sizes and high opacities, 10% faint floaters
    through the camera orbit volume, some of which project to huge
    footprints near the eye. ``extent`` is accepted for signature parity
    and unused, as in the JAX generator."""
    rng = np.random.RandomState(seed)
    n_surf = int(n * 0.9)
    means_s, scales_s, quats_s, _, colors_s = _shell_arrays(
        n_surf, seed + 1, 1.0, (0.004, 0.012))
    # heavy-tailed sizes for the surface disks: log-normal, median ~6e-3
    ln = np.exp(rng.randn(n_surf, 1).astype(np.float32) * 0.7 - 5.1)
    scales_s = scales_s * (ln / 0.008)
    opac_s = np.clip(rng.beta(5.0, 1.2, n_surf), 0.05, 1.0)

    n_fl = n - n_surf
    means_f = ((rng.rand(n_fl, 3).astype(np.float32) * 2 - 1)
               * np.array([2.8, 1.4, 2.8], np.float32))  # orbit volume
    ln_f = np.exp(rng.randn(n_fl, 3).astype(np.float32) * 1.0 - 4.2)
    q = rng.randn(n_fl, 4).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True).clip(1e-9)
    opac_f = np.clip(rng.beta(1.3, 4.0, n_fl), 0.02, 0.95)
    colors_f = rng.rand(n_fl, 3).astype(np.float32)

    return gaussian_cloud(
        np.concatenate([means_s, means_f]),
        np.concatenate([scales_s.astype(np.float32),
                        ln_f.astype(np.float32)]),
        np.concatenate([quats_s, q]),
        np.concatenate([opac_s.astype(np.float32),
                        opac_f.astype(np.float32)]),
        np.concatenate([colors_s, colors_f]), device=device)
