"""Wavefront OBJ mesh loading (counterpart of ``ray_eater_tpu/io/obj.py``).

The common triangle-mesh subset: ``v`` (position and the optional vertex
colour extension), ``vt``, ``f`` in the v, v/vt, v/vt/vn and v//vn forms,
polygons fan-triangulated. Per-corner attributes are de-indexed into one
flat vertex buffer (OBJ indexes positions and uvs independently; the
raster path takes one index space).
"""

from __future__ import annotations

import numpy as np

from ..utils.logging import scoped

_log = scoped("io")


def load_obj(path: str, default_color=(1.0, 1.0, 1.0), device="cuda"):
    """Parse an OBJ file into a ``models.mesh.Mesh`` (positions, colour,
    uv, indices) on ``device``."""
    from ..models.mesh import mesh

    positions: list[list[float]] = []
    colors: list[list[float]] = []
    uvs: list[list[float]] = []
    corners: list[tuple[int, int]] = []   # (position index, uv index)
    tris: list[list[int]] = []

    def parse_index(tok: str, n: int) -> tuple[int, int]:
        parts = tok.split("/")
        vi = int(parts[0])
        vi = vi - 1 if vi > 0 else n + vi
        ti = -1
        if len(parts) > 1 and parts[1]:
            t = int(parts[1])
            ti = t - 1 if t > 0 else len(uvs) + t
        return vi, ti

    with open(path) as f:
        for line in f:
            t = line.split("#", 1)[0].split()
            if not t:
                continue
            if t[0] == "v":
                positions.append([float(x) for x in t[1:4]])
                colors.append([float(x) for x in t[4:7]]
                              if len(t) >= 7 else list(default_color))
            elif t[0] == "vt":
                uvs.append([float(t[1]), float(t[2]) if len(t) > 2 else 0.0])
            elif t[0] == "f":
                face = [parse_index(tok, len(positions)) for tok in t[1:]]
                for i in range(1, len(face) - 1):   # fan triangulation
                    base = len(corners)
                    corners.extend([face[0], face[i], face[i + 1]])
                    tris.append([base, base + 1, base + 2])

    if not tris:
        raise ValueError(f"no faces in OBJ {path}")
    pos = np.asarray(positions, np.float32)
    col = np.asarray(colors, np.float32)
    uv = (np.asarray(uvs, np.float32) if uvs
          else np.zeros((1, 2), np.float32))
    vi = np.asarray([c[0] for c in corners], np.int64)
    ti = np.asarray([max(c[1], 0) for c in corners], np.int64)
    has_uv = np.asarray([c[1] >= 0 for c in corners])
    corner_uv = np.where(has_uv[:, None], uv[ti], 0.0)
    _log.info("loaded %s: %d verts, %d tris", path, len(pos), len(tris))
    return mesh(pos[vi], tris, device=device, color=col[vi], uv=corner_uv)
