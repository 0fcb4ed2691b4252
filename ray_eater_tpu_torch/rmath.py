"""Camera and transform math in float32 with the JAX ``rmath`` op order.

Counterpart of ``ray_eater_tpu/rmath.py``: the flythrough camera of the
3DGS path and the model/view/projection math of the raster path, including
the reference's **mirrored** ``look_at`` (math.zig:295-314; kept as it is
for image parity). Matrices are logical row-major ``(4, 4)`` float32
tensors that multiply column vectors on the right. Products are written out
as ordered multiply-adds, so they round the same on every device. Functions
that take tensors follow their device; functions that build tensors from
Python numbers take ``device`` (default ``"cuda"``).
"""

from __future__ import annotations

import math

import torch

from .utils import on_device

#: World up vector of the reference engine (math.zig:8).
GLOBAL_UP = (0.0, -1.0, 0.0)

_F32 = torch.float32


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(_F32)
    return on_device(x, device)


def vec(*vals, device="cuda") -> torch.Tensor:
    """Float32 vector from scalars (or from one sequence of scalars)."""
    if len(vals) == 1 and not isinstance(vals[0], (int, float)):
        vals = tuple(vals[0])
    return torch.stack([_f32(v, device).reshape(()) for v in vals])


def radians(deg, device="cuda") -> torch.Tensor:
    """Degrees to radians, as float32 ``deg * f32(pi/180)``."""
    d = _f32(deg, device)
    return d * on_device(math.pi / 180.0, d.device)


def mag(v: torch.Tensor) -> torch.Tensor:
    """Euclidean length ``sqrt(sum(v * v))``."""
    return torch.sqrt(torch.sum(v * v))


def norm(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|``."""
    return v / mag(v)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D cross product."""
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def smult(v: torch.Tensor, s) -> torch.Tensor:
    """Scalar multiply (math.zig:112-119): ``v * f32(s)``."""
    v = v.to(_F32)
    return v * _f32(s, v.device)


def sdiv(v: torch.Tensor, s) -> torch.Tensor:
    """Scalar divide (math.zig:121-128): ``v / f32(s)``, divided by a
    device tensor (a CUDA division by a host scalar is a reciprocal
    multiply, which rounds differently)."""
    v = v.to(_F32)
    return v / _f32(s, v.device)


def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vector subtract."""
    return a - b


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """3D dot product, summed in index order."""
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def mat4(rows, device="cuda") -> torch.Tensor:
    """Row-major (4, 4) float32 matrix (math.zig:179-190)."""
    return _f32(rows, device).reshape(4, 4)


def mat4_cm(cols, device="cuda") -> torch.Tensor:
    """Column-major constructor (``Mat4.createCM``, math.zig:192-194): the
    transpose of :func:`mat4` of the same numbers."""
    return mat4(cols, device).T


def of(val, device="cuda") -> torch.Tensor:
    """Constant-filled (4, 4) float32 matrix (math.zig:205-220)."""
    if isinstance(val, torch.Tensor):
        return val.to(_F32).reshape(()).expand(4, 4).clone()
    return torch.full((4, 4), float(val), dtype=_F32, device=device)


def identity(device="cuda") -> torch.Tensor:
    """4x4 identity (math.zig:196-203)."""
    return torch.eye(4, dtype=_F32, device=device)


def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Matrix product ``a @ b`` (math.zig:340-359), each entry summed over
    the inner index in order."""
    out = a[:, 0:1] * b[0:1, :]
    for k in range(1, 4):
        out = out + a[:, k:k + 1] * b[k:k + 1, :]
    return out


def transpose(m: torch.Tensor) -> torch.Tensor:
    """Transpose (math.zig:328-338)."""
    return m.to(_F32).T


def _rot_z(c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The Z rotation block of cosine ``c`` and sine ``s`` (0-d)."""
    z, o = torch.zeros_like(c), torch.ones_like(c)
    return torch.stack([torch.stack([c, -s, z, z]),
                        torch.stack([s, c, z, z]),
                        torch.stack([z, z, o, z]),
                        torch.stack([z, z, z, o])])


def rotate_z(m: torch.Tensor, rads) -> torch.Tensor:
    """Post-multiply by the Z rotation (math.zig:222-232)."""
    r = _f32(rads, m.device)
    return mul(m, _rot_z(torch.cos(r), torch.sin(r)))


def rotate_x(m: torch.Tensor, rads) -> torch.Tensor:
    """Post-multiply by the reference's X rotation (math.zig:234-243): the
    block is ``[[c, s], [-s, c]]``, the transpose of the textbook form,
    kept as the reference has it."""
    r = _f32(rads, m.device)
    c, s = torch.cos(r), torch.sin(r)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([o, z, z, z]),
                       torch.stack([z, c, s, z]),
                       torch.stack([z, -s, c, z]),
                       torch.stack([z, z, z, o])])
    return mul(m, rot)


def rotate_y(m: torch.Tensor, rads) -> torch.Tensor:
    """Post-multiply by the Y rotation (math.zig:245-251)."""
    r = _f32(rads, m.device)
    c, s = torch.cos(r), torch.sin(r)
    z, o = torch.zeros_like(c), torch.ones_like(c)
    rot = torch.stack([torch.stack([c, z, s, z]),
                       torch.stack([z, o, z, z]),
                       torch.stack([-s, z, c, z]),
                       torch.stack([z, z, z, o])])
    return mul(m, rot)


def translate(m: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
    """The reference's ``Mat4.translate`` (math.zig:287-293): column 3
    becomes ``(m[3, 0] + by[0], m[3, 1] + by[1], m[3, 2] + by[2],
    m[3, 3])``. It reads the bottom row, not the translation column; for
    a bottom row (0, 0, 0, 1), the only kind the reference translates,
    that is the same. Kept as the reference has it."""
    m = m.to(_F32)
    col = torch.cat([m[3, :3] + by.to(_F32)[:3], m[3:4, 3]])
    return torch.cat([m[:, :3], col[:, None]], 1)


def look_at(eye: torch.Tensor, center: torch.Tensor,
            world_up: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's view matrix (math.zig:295-314): rows (right, up,
    -forward), translation ``(-right.eye, -up.eye, -forward.eye)``. Its
    depth row evaluates to ``const - distance``, so the raster path resolves
    overlaps far-over-near, as the reference renders; do not "fix" it (3DGS
    uses :func:`look_at_zforward`)."""
    eye = eye.to(_F32)
    center = center.to(_F32)
    if world_up is None:
        world_up = on_device(GLOBAL_UP, eye.device)
    z = norm(sub(center, eye))       # forward
    x = norm(cross(z, world_up))     # right
    y = norm(cross(x, z))            # up
    rot3 = torch.stack([x, y, -z])
    t = torch.stack([-dot(x, eye), -dot(y, eye), -dot(z, eye)])
    top = torch.cat([rot3, t[:, None]], 1)
    bottom = on_device([[0.0, 0.0, 0.0, 1.0]], eye.device)
    return torch.cat([top, bottom], 0)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply a 4x4 matrix to ``(N, 3)`` points: ``(N, 4)`` clip coordinates
    ``m @ (x, y, z, 1)`` (shaders/shader.vert:16)."""
    pts = pts.to(_F32)
    out = (pts[:, 0:1] * m[:, 0][None] + pts[:, 1:2] * m[:, 1][None]
           + pts[:, 2:3] * m[:, 2][None])
    return out + m[:, 3][None]


def look_at_zforward(eye: torch.Tensor, center: torch.Tensor,
                     world_up: torch.Tensor | None = None) -> torch.Tensor:
    """Right-handed view matrix: rows (right, up, +forward), translation
    ``-R @ eye``, so camera-forward maps to +z_view = distance in front
    (the 3DGS convention of ``rmath.look_at_zforward`` in the JAX package).
    The product ``-R @ eye`` is written out as three ordered multiply-adds so
    that it rounds the same on every device."""
    eye = eye.to(_F32)
    center = center.to(_F32)
    if world_up is None:
        world_up = on_device(GLOBAL_UP, eye.device)
    z = norm(sub(center, eye))       # forward
    x = norm(cross(z, world_up))     # right
    y = norm(cross(x, z))            # up
    rot3 = torch.stack([x, y, z])
    nr = -rot3
    t = nr[:, 0] * eye[0] + nr[:, 1] * eye[1] + nr[:, 2] * eye[2]
    top = torch.cat([rot3, t[:, None]], 1)
    bottom = on_device([[0.0, 0.0, 0.0, 1.0]], eye.device)
    return torch.cat([top, bottom], 0)


def perspective(fov, aspect, near, far, device="cuda") -> torch.Tensor:
    """Vulkan-style projection: ``vp = 1/tan(fov/2)``, Y negated, depth in
    [0, 1], ``w_clip = +z_view``."""
    fov = _f32(fov, device)
    dev = fov.device
    aspect = on_device(aspect, dev)
    near = on_device(near, dev)
    far = on_device(far, dev)
    vp = 1.0 / torch.tan(fov / 2.0)
    as_ = vp / aspect
    z = torch.zeros_like(vp)
    o = torch.ones_like(vp)
    return torch.stack([
        torch.stack([as_, z, z, z]),
        torch.stack([z, -vp, z, z]),
        torch.stack([z, z, o * (far / (far - near)),
                     o * (-(near * far) / (far - near))]),
        torch.stack([z, z, o, z]),
    ])


def to_column_major(m: torch.Tensor) -> torch.Tensor:
    """The 16 floats in the reference's memory order (math.zig:148-155),
    column after column."""
    return m.to(_F32).T.reshape(-1)


def from_column_major(flat: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`to_column_major`."""
    return flat.to(_F32).reshape(4, 4).T
