"""Gaussian splat scenes (counterpart of ``ray_eater_tpu/models/gaussians.py``).

The generators draw from the same ``np.random.RandomState`` stream as the
JAX package, so a seed gives bit-identical arrays in both packages. PLY
interchange follows the INRIA 3DGS export convention (x, y, z, f_dc_0..2
spherical-harmonic DC terms, f_rest_* higher bands, opacity logit,
scale_0..2 in log space, rot_0..3 quaternion) and decodes in numpy, as the
JAX package's pure-Python reader does, before the arrays move to the
device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping

import numpy as np
import torch

from ..ops import _cuda

_FIELDS = ("means", "scales", "quats", "opacities", "colors")


@dataclass
class GaussianCloud:
    """Struct-of-arrays splat scene (all float32, one device):
    means (N,3) world positions; scales (N,3) linear std-devs;
    quats (N,4) rotations (w,x,y,z); opacities (N,) in [0,1];
    colors (N,3) linear RGB (the SH-DC term); sh_rest (N, B, 3) optional
    higher-order spherical-harmonic coefficients (B = (deg+1)^2 - 1) for
    view-dependent colour, evaluated by :func:`eval_sh_colors`."""

    means: torch.Tensor
    scales: torch.Tensor
    quats: torch.Tensor
    opacities: torch.Tensor
    colors: torch.Tensor
    sh_rest: torch.Tensor | None = None

    @property
    def num_splats(self) -> int:
        return self.means.shape[0]

    @property
    def sh_degree(self) -> int:
        if self.sh_rest is None:
            return 0
        return _sh_degree(self.sh_rest.shape[1])


def _sh_degree(bands: int) -> int:
    """The SH degree of ``bands`` higher-band coefficients a channel."""
    return int(round((bands + 1) ** 0.5)) - 1


def gaussian_cloud(means, scales, quats, opacities, colors, sh_rest=None,
                   device="cuda") -> GaussianCloud:
    """Build a cloud from array-likes, as contiguous float32 on
    ``device`` (the SH colour kernel reads ``sh_rest`` as it lies)."""
    def f(x):
        return torch.from_numpy(np.array(x, np.float32, order="C")).to(device)
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


# ---------------------------------------------------------------------------
# View-dependent colour and PLY interchange (INRIA 3DGS convention)
# ---------------------------------------------------------------------------

#: SH DC basis constant: color = 0.5 + C0 * f_dc
SH_C0 = 0.28209479177387814

_PLY_PROPS = ("x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity",
              "scale_0", "scale_1", "scale_2", "rot_0", "rot_1", "rot_2",
              "rot_3")

# real SH basis constants for degrees 1..3 (the 3DGS convention)
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)
#: the band counts the SH colour kernel takes (degree 1, 2, 3)
_SH_BANDS = (3, 8, 15)


def _sh_colors_plain(means: torch.Tensor, colors: torch.Tensor,
                     sh_rest: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """Plain version of the SH colour kernel (``csrc/gs_sh.cu``): the
    (N, 3) colours of splats at ``means`` with DC ``colors`` and higher
    bands ``sh_rest`` (N, B, 3), seen from ``eye`` (3,). The bands are
    summed in the JAX package's order (the original 3DGS evaluation,
    bands y, z, x)."""
    d = means - eye
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True)).clamp(min=1e-12)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sh = sh_rest
    deg = _sh_degree(sh.shape[1])
    out = colors - 0.5
    out = out + _SH_C1 * (-y * sh[:, 0] + z * sh[:, 1] - x * sh[:, 2])
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out = out + (_SH_C2[0] * xy * sh[:, 3]
                     + _SH_C2[1] * yz * sh[:, 4]
                     + _SH_C2[2] * (2.0 * zz - xx - yy) * sh[:, 5]
                     + _SH_C2[3] * xz * sh[:, 6]
                     + _SH_C2[4] * (xx - yy) * sh[:, 7])
    if deg >= 3:
        out = out + (_SH_C3[0] * y * (3 * xx - yy) * sh[:, 8]
                     + _SH_C3[1] * xy * z * sh[:, 9]
                     + _SH_C3[2] * y * (4 * zz - xx - yy) * sh[:, 10]
                     + _SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 11]
                     + _SH_C3[4] * x * (4 * zz - xx - yy) * sh[:, 12]
                     + _SH_C3[5] * z * (xx - yy) * sh[:, 13]
                     + _SH_C3[6] * x * (xx - 3 * yy) * sh[:, 14])
    return torch.clamp(out + 0.5, 0.0, 1.0)


def _sh_colors_fake(means, colors, sh_rest, eye):
    return colors.new_empty(colors.shape)


@_cuda.kernel_op("sh_colors", _sh_colors_plain, _sh_colors_fake)
def _sh_colors_op(means: torch.Tensor, colors: torch.Tensor,
                  sh_rest: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    """The SH colour kernel's launch: the (N, 3) f32 colours, one thread a
    splat, for B = 3, 8 or 15 (degree 1, 2, 3)."""
    dev = _cuda.cuda_device(means, "SH colours")
    n = means.shape[0]
    bands = sh_rest.shape[1] if sh_rest.dim() == 3 else -1
    if bands not in _SH_BANDS:
        raise ValueError(f"sh_rest has shape {tuple(sh_rest.shape)}, "
                         f"expected (N, B, 3) with B in {_SH_BANDS}")
    _cuda.check_arg(means, "means", torch.float32, (n, 3), dev)
    _cuda.check_arg(colors, "colors", torch.float32, (n, 3), dev)
    _cuda.check_arg(sh_rest, "sh_rest", torch.float32, (n, bands, 3), dev)
    _cuda.check_arg(eye, "eye", torch.float32, (3,), dev)
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n:
        with torch.cuda.device(dev):
            err = _cuda.lib().sh_colors(
                means.data_ptr(), colors.data_ptr(), sh_rest.data_ptr(),
                eye.data_ptr(), n, bands, out.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _cuda.check(err, "SH colours")
        _cuda.launches["sh_colors"] += 1
    return out


def eval_sh_colors(cloud: GaussianCloud, cam_pos) -> torch.Tensor:
    """View-dependent colours: the cloud's SH evaluated at the direction
    from ``cam_pos`` (3,) (array-like or tensor) to each splat, (N, 3)
    linear RGB clipped to [0, 1]. Degree 0 returns ``cloud.colors``
    itself, unclipped. The op ``rayeater::sh_colors``: one kernel launch
    on CUDA tensors (or raises), :func:`_sh_colors_plain` on CPU
    tensors."""
    base = cloud.colors
    if cloud.sh_rest is None or cloud.sh_rest.shape[1] == 0:
        return base
    eye = torch.as_tensor(cam_pos, dtype=torch.float32).to(base.device)
    _cuda.op_device(base, "SH colours")
    return _sh_colors_op(cloud.means.contiguous(), base.contiguous(),
                         cloud.sh_rest.contiguous(), eye)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def load_ply(path: str, device="cuda") -> GaussianCloud:
    """Load a 3DGS PLY (binary_little_endian or ascii) onto ``device``.
    Activations applied in numpy: exp() on log-scales, sigmoid() on
    opacity logits, SH-DC to RGB; ``f_rest_*`` (sorted by their integer
    suffix, stored channel-major) become ``sh_rest`` (N, B, 3)."""
    props, data = _read_ply_vertices(path)
    cols = {name: data[:, i] for i, name in enumerate(props)}
    missing = [p for p in _PLY_PROPS if p not in cols]
    if missing:
        raise ValueError(f"PLY {path} missing 3DGS properties: {missing}")
    means = np.stack([cols["x"], cols["y"], cols["z"]], -1)
    colors = np.clip(0.5 + SH_C0 * np.stack(
        [cols["f_dc_0"], cols["f_dc_1"], cols["f_dc_2"]], -1), 0.0, 1.0)
    opac = _sigmoid(cols["opacity"])
    scales = np.exp(np.stack(
        [cols["scale_0"], cols["scale_1"], cols["scale_2"]], -1))
    quats = np.stack([cols["rot_0"], cols["rot_1"], cols["rot_2"],
                      cols["rot_3"]], -1)
    quats /= np.maximum(np.linalg.norm(quats, axis=1, keepdims=True), 1e-12)
    rest_names = sorted((p for p in props if p.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    sh_rest = None
    if rest_names:
        rest = np.stack([cols[p] for p in rest_names], -1)   # (N, 3*B)
        b = rest.shape[1] // 3
        sh_rest = rest.reshape(-1, 3, b).transpose(0, 2, 1)  # (N, B, 3)
    return gaussian_cloud(means, scales, quats, opac, colors, sh_rest,
                          device=device)


def save_ply(path: str, cloud: GaussianCloud) -> None:
    """Write a 3DGS PLY (binary little-endian) with inverse activations,
    in the INRIA exporter's property order: x, y, z, nx, ny, nz
    (zero-filled normals), f_dc, f_rest, opacity, scale, rot."""
    def host(t):
        return t.detach().cpu().numpy().astype(np.float32)
    means = host(cloud.means)
    colors = host(cloud.colors)
    opac = np.clip(host(cloud.opacities), 1e-6, 1 - 1e-6)
    scales = np.maximum(host(cloud.scales), 1e-12)
    quats = host(cloud.quats)
    f_dc = (colors - 0.5) / SH_C0
    logit = np.log(opac / (1 - opac))
    normals = np.zeros_like(means)
    parts = [means, normals, f_dc]
    props = ["x", "y", "z", "nx", "ny", "nz", "f_dc_0", "f_dc_1", "f_dc_2"]
    if cloud.sh_rest is not None:
        rest = host(cloud.sh_rest)                              # (N, B, 3)
        b = rest.shape[1]
        parts.append(rest.transpose(0, 2, 1).reshape(len(means), -1))
        props += [f"f_rest_{i}" for i in range(3 * b)]
    parts += [logit[:, None], np.log(scales), quats]
    props += ["opacity", "scale_0", "scale_1", "scale_2",
              "rot_0", "rot_1", "rot_2", "rot_3"]
    rec = np.concatenate(parts, -1).astype("<f4")
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {len(rec)}"]
    header += [f"property float {p}" for p in props]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())


def _read_ply_vertices(path: str):
    """PLY vertex reader, float32 properties only (what 3DGS exports use):
    (property names, (N, P) float32), through the native tier's
    ``read_ply`` when it is built, else :func:`_read_ply_numpy`."""
    from ..native import loader as native
    if native.available():
        return native.read_ply(path)
    return _read_ply_numpy(path)


def _read_ply_numpy(path: str):
    """The numpy PLY vertex reader. Elements after the vertices (e.g.
    ``element face 0``) are ignored."""
    with open(path, "rb") as f:
        props: list[str] = []
        n = 0
        fmt = None
        in_vertex = False
        while True:
            line = f.readline().decode("ascii", "replace").strip()
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element vertex"):
                n = int(line.split()[-1])
                in_vertex = True
            elif line.startswith("element"):
                in_vertex = False
            elif line.startswith("property") and in_vertex:
                kind, name = line.split()[1], line.split()[-1]
                if kind != "float":
                    raise ValueError(f"non-float property {name}")
                props.append(name)
            elif line == "end_header":
                break
            elif line == "":
                raise ValueError("unexpected EOF in PLY header")
        if fmt == "binary_little_endian":
            data = np.frombuffer(f.read(4 * n * len(props)), "<f4")
            data = data.reshape(n, len(props)).astype(np.float32)
        elif fmt == "ascii":
            data = np.loadtxt(f, dtype=np.float32, max_rows=n)
            data = data.reshape(n, len(props))
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return props, data
