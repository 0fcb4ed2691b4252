"""View-dependent splat colour in plain PyTorch: the real spherical
harmonics of 3D Gaussian Splatting (Kerbl et al. 2023), up to degree 3,
evaluated in float32 at the direction from the eye to each splat.

A splat's colour is its DC colour plus the sum, over the higher bands, of
each band's basis value times its (3,) coefficients, clipped to [0, 1]
(the port's ``eval_sh_colors`` semantics: ``0.5 + C0 f_dc`` is the DC
colour the scene stores). The basis is the standard real SH basis in the
3DGS band order (degree 1: y, z, x with signs -, +, -; then the five
degree-2 and seven degree-3 functions).
"""

from __future__ import annotations

import torch

C1 = 0.4886025119029199
C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
      -1.0925484305920792, 0.5462742152960396)
C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
      0.3731763325901154, -0.4570457994644658, 1.445305721320277,
      -0.5900435899266435)

#: float32 operations a splat of :func:`colors` for 0, 3, 8 or 15 higher
#: bands: the direction (difference 3, squared norm 5, clamp, sqrt and
#: divide 3, scale 3: 14), the basis (degree 1: 3; degree 2: six products
#: and 9: 15; degree 3: 25), a multiply-add a band and channel, the clip (6)
FLOPS_PER_SPLAT = {0: 0, 3: 14 + 3 + 3 * 3 * 2 + 6,
                   8: 14 + 3 + 15 + 8 * 3 * 2 + 6,
                   15: 14 + 3 + 15 + 25 + 15 * 3 * 2 + 6}


def basis(d: torch.Tensor, bands: int) -> torch.Tensor:
    """(N, bands) basis values of the unit directions ``d`` (N, 3)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    out = [-C1 * y, C1 * z, -C1 * x]
    if bands > 3:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [C2[0] * xy, C2[1] * yz, C2[2] * (2.0 * zz - xx - yy),
                C2[3] * xz, C2[4] * (xx - yy)]
    if bands > 8:
        t = 4.0 * zz - xx - yy
        out += [C3[0] * y * (3.0 * xx - yy), C3[1] * xy * z,
                C3[2] * y * t, C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                C3[4] * x * t, C3[5] * z * (xx - yy),
                C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, 1)


def colors(cloud: dict, eye: torch.Tensor | None) -> torch.Tensor:
    """(N, 3) float32 colours of ``cloud`` seen from ``eye`` (3,): its DC
    ``colors`` where it has no ``sh_rest`` (N, bands, 3) or no eye is
    given."""
    rest = cloud.get("sh_rest")
    if rest is None or eye is None or rest.shape[1] == 0:
        return cloud["colors"]
    d = cloud["means"] - eye
    d = d / torch.sqrt(torch.clamp((d * d).sum(1, keepdim=True), min=1e-24))
    b = basis(d, rest.shape[1])
    rgb = cloud["colors"] + (b[:, :, None] * rest).sum(1)
    return torch.clamp(rgb, 0.0, 1.0)


def draw_rest(p: dict, n: int, gen: torch.Generator, dev) -> dict:
    """``{"sh_rest": (n, bands, 3)}`` float32 higher-band coefficients
    drawn N(0, ``sh_rest_std``²) from ``gen`` for the scene parameters'
    ``sh_degree`` (``{}`` at degree 0)."""
    deg = p.get("sh_degree", 0)
    if not deg:
        return {}
    bands = (deg + 1) ** 2 - 1
    rest = torch.randn((n, bands, 3), dtype=torch.float32, device=dev,
                       generator=gen) * p["sh_rest_std"]
    return {"sh_rest": rest}
