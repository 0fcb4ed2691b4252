"""Meshes as struct-of-arrays tensors (counterpart of
``ray_eater_tpu/models/mesh.py``): positions ``(N, 3)`` float32, one
``(N, K)`` float32 tensor per attribute, indices ``(T, 3)`` int64 (a
triangle list, the reference's only topology,
graphics_pipeline.zig:83-86)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Mesh:
    positions: torch.Tensor
    attributes: dict[str, torch.Tensor]
    indices: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return self.positions.shape[0]

    @property
    def num_triangles(self) -> int:
        return self.indices.shape[0]


def mesh(positions, indices, device="cuda", **attributes) -> Mesh:
    """A Mesh from host data, one copy per array (the setData analog,
    vertex_buffer.zig:108-120)."""
    pos = torch.from_numpy(
        np.asarray(positions, np.float32).reshape(-1, 3)).to(device)
    idx = torch.from_numpy(
        np.asarray(indices, np.int64).reshape(-1, 3)).to(device)
    attrs = {k: torch.from_numpy(np.asarray(v, np.float32).reshape(
        pos.shape[0], -1)).to(device) for k, v in attributes.items()}
    return Mesh(positions=pos, attributes=attrs, indices=idx)


def two_planes(device="cuda") -> Mesh:
    """The basic_planes geometry: two stacked quads, 8 vertices and 12
    indices, with per-vertex colour and uv (basic_planes.zig:245-267)."""
    positions = [
        [-0.5, 0.0, -0.5], [0.5, 0.0, -0.5], [0.5, 0.0, 0.5], [-0.5, 0.0, 0.5],
        [-0.5, 0.5, -0.5], [0.5, 0.5, -0.5], [0.5, 0.5, 0.5], [-0.5, 0.5, 0.5],
    ]
    colors = [
        [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1],
        [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1],
    ]
    uvs = [
        [1, 0], [0, 0], [0, 1], [1, 1],
        [1, 0], [0, 0], [0, 1], [1, 1],
    ]
    indices = [[0, 1, 2], [2, 3, 0], [4, 5, 6], [6, 7, 4]]
    return mesh(positions, indices, device=device, color=colors, uv=uvs)


def fullscreen_quad(device="cuda") -> Mesh:
    """The RenderQuad geometry (render_quad.zig:28-52): two triangles
    covering NDC, uv (0,0) at the top left."""
    positions = [[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]]
    uvs = [[0, 0], [1, 0], [1, 1], [0, 1]]
    indices = [[0, 1, 2], [2, 3, 0]]
    return mesh(positions, indices, device=device, uv=uvs)
