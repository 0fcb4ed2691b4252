"""Port vs JAX: camera math and splat clouds (``ray_eater_tpu_torch.rmath``,
``ray_eater_tpu_torch.models.gaussians``, ``bench_knobs.flythrough_camera``).

Tolerances: camera matrices within rtol 1e-6 / atol 1e-6 (the same float32
operations, but XLA's and PyTorch's sin/cos/tan may differ in the last ulp);
clouds drawn from one numpy seed are bit-identical.
"""

import inspect
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from ray_eater_tpu import rmath as jrmath  # noqa: E402
from ray_eater_tpu.models import gaussians as jgauss  # noqa: E402
from ray_eater_tpu_torch import rmath  # noqa: E402
from ray_eater_tpu_torch.bench_knobs import flythrough_camera  # noqa: E402
from ray_eater_tpu_torch.models import gaussians  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("means", "scales", "quats", "opacities", "colors")


@pytest.mark.parametrize("t", [0.0, 0.25, 0.5, 0.983333])
def test_flythrough_camera_matches_jax(t):
    jv, jp = bench.flythrough_camera(np.float32(t), 1920, 1080)
    v, p = flythrough_camera(float(np.float32(t)), 1920, 1080, device="cpu")
    assert v.dtype == p.dtype == torch.float32
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)


def test_look_at_and_perspective_match_jax():
    eye, ctr = (0.3, -0.7, -3.1), (0.2, 0.1, 0.4)
    jv = jrmath.look_at_zforward(jrmath.vec(*eye), jrmath.vec(*ctr))
    v = rmath.look_at_zforward(rmath.vec(*eye, device="cpu"),
                               rmath.vec(*ctr, device="cpu"))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-6,
                               atol=1e-6)
    jp = jrmath.perspective(jrmath.radians(47.0), 256 / 96, 0.1, 30.0)
    p = rmath.perspective(rmath.radians(47.0, device="cpu"), 256 / 96,
                          0.1, 30.0)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=1e-6)
    a = rmath.vec(1.0, 2.0, 3.0, device="cpu")
    b = rmath.vec(-0.5, 0.25, 2.0, device="cpu")
    np.testing.assert_array_equal(
        rmath.cross(a, b).numpy(),
        np.asarray(jrmath.cross(jrmath.vec(1.0, 2.0, 3.0),
                                jrmath.vec(-0.5, 0.25, 2.0))))
    np.testing.assert_allclose(rmath.norm(a).numpy(),
                               np.asarray(jrmath.norm(jrmath.vec(1., 2., 3.))),
                               rtol=1e-7)


def test_random_cloud_bit_identical():
    jc = jgauss.random_cloud(5000, seed=1, extent=1.0,
                             scale_range=(0.004, 0.02))
    c = gaussians.random_cloud(5000, seed=1, extent=1.0,
                               scale_range=(0.004, 0.02), device="cpu")
    assert c.num_splats == jc.num_splats == 5000
    for f in FIELDS:
        got = getattr(c, f)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jc, f)))


def test_cloud_from_numpy_round_trip():
    jc = jgauss.random_cloud(300, seed=4)
    d = {f: np.asarray(getattr(jc, f)) for f in FIELDS}
    c = gaussians.cloud_from_numpy(d, device="cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(c, f).numpy(), d[f])
    assert c.sh_rest is None
    sh = np.arange(300 * 3 * 3, dtype=np.float32).reshape(300, 3, 3)
    c2 = gaussians.cloud_from_numpy(dict(d, sh_rest=sh), device="cpu")
    np.testing.assert_array_equal(c2.sh_rest.numpy(), sh)


def test_generators_default_to_cuda():
    for fn in (gaussians.random_cloud, gaussians.gaussian_cloud,
               gaussians.cloud_from_numpy, flythrough_camera, rmath.vec):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_raster_math_matches_jax():
    """identity, mat4, mul, rotate_y, transform_points and the mirrored
    look_at of the raster path, against the JAX package (rtol 1e-6: the
    port sums products in index order, XLA's dot in its own)."""
    rows = [[1, 2, 3, 4], [3, 2, 1, 1], [1, 2, 3, 2], [2, 3, 7, 3]]
    rows2 = [[4, 5, 6, 7], [6, 5, 4, 3], [4, 6, 5, 9], [2, 8, 5, 3]]
    m1, m2 = rmath.mat4(rows, device="cpu"), rmath.mat4(rows2, device="cpu")
    np.testing.assert_array_equal(
        rmath.mul(m1, m2).numpy(),
        [[36, 65, 49, 52], [30, 39, 36, 39], [32, 49, 39, 46],
         [60, 91, 74, 95]])
    np.testing.assert_array_equal(rmath.identity("cpu").numpy(), np.eye(4))
    for t in (0.0, 0.3, 0.983333):
        r = rmath.radians(45.0, device="cpu") * t
        got = rmath.rotate_y(rmath.identity("cpu"), r).numpy()
        want = np.asarray(jrmath.rotate_y(jrmath.identity(),
                                          jrmath.radians(45.0) * t))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    eye, ctr = (2.0, 2.0, 2.0), (0.0, 0.0, 0.0)
    v = rmath.look_at(rmath.vec(*eye, device="cpu"),
                      rmath.vec(*ctr, device="cpu")).numpy()
    np.testing.assert_allclose(
        v, np.asarray(jrmath.look_at(jrmath.vec(*eye), jrmath.vec(*ctr))),
        rtol=1e-6, atol=1e-6)
    # tests/test_math.py's golden: rows right / up / -forward, t = (0, 0,
    # 2 sqrt 3), so the centre lands at +z_view (the mirrored convention)
    r2, r3, r6 = np.sqrt(2) / 2, 1 / np.sqrt(3), 1 / np.sqrt(6)
    np.testing.assert_allclose(v, [[-r2, 0, r2, 0], [r6, -2 * r6, r6, 0],
                                   [r3, r3, r3, 2 * np.sqrt(3)],
                                   [0, 0, 0, 1]], atol=1e-6)
    pts = np.random.RandomState(0).randn(5, 3).astype(np.float32)
    m = rmath.perspective(1.0, 1.5, 0.1, 30.0, device="cpu")
    got = rmath.transform_points(m, torch.from_numpy(pts)).numpy()
    want = np.asarray(jrmath.transform_points(np.asarray(m.numpy()), pts))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def _ulp(got, want, maxulp=1):
    np.testing.assert_array_max_ulp(np.asarray(got, np.float32),
                                    np.asarray(want, np.float32), maxulp)


def test_rest_of_rmath_matches_jax():
    """rotate_x, rotate_z (and _rot_z), translate with its bottom-row quirk,
    to/from_column_major, of, mat4_cm, transpose, smult and sdiv on
    tests/test_math.py's cases, within 1 ulp of the JAX package."""
    rows = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 1, 2, 3], [4, 5, 6, 7]]
    m, jm = rmath.mat4(rows, device="cpu"), jrmath.mat4(rows)
    eye, jeye = rmath.identity("cpu"), jrmath.identity()
    # column-major order: columns contiguous, and back
    cm = rmath.to_column_major(rmath.mat4([[1, 2, 3, 4]] * 4, device="cpu"))
    np.testing.assert_array_equal(cm.numpy(), [1] * 4 + [2] * 4 + [3] * 4
                                  + [4] * 4)
    np.testing.assert_array_equal(rmath.to_column_major(m).numpy(),
                                  np.asarray(jrmath.to_column_major(jm)))
    np.testing.assert_array_equal(
        rmath.from_column_major(rmath.to_column_major(m)).numpy(),
        m.numpy())
    # translate: the reference fixture and the bottom-row quirk
    by = rmath.vec(10.0, 20.0, 30.0, device="cpu")
    np.testing.assert_array_equal(
        rmath.translate(eye, by).numpy(),
        [[1, 0, 0, 10], [0, 1, 0, 20], [0, 0, 1, 30], [0, 0, 0, 1]])
    quirk = [[1, 0, 0, 5], [0, 1, 0, 6], [0, 0, 1, 7], [2, 3, 4, 1]]
    got = rmath.translate(rmath.mat4(quirk, device="cpu"), by).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jrmath.translate(jrmath.mat4(quirk),
                                         jrmath.vec(10.0, 20.0, 30.0))))
    np.testing.assert_array_equal(got[:, 3], [12, 23, 34, 1])
    # rotations: the reference's X layout, textbook Z; post-multiplies
    for r in (0.0, 0.5, 0.7, float(np.float32(np.pi / 4))):
        _ulp(rmath.rotate_x(eye, r).numpy(), jrmath.rotate_x(jeye, r))
        _ulp(rmath.rotate_z(eye, r).numpy(), jrmath.rotate_z(jeye, r))
        rz = rmath._rot_z(torch.cos(torch.tensor(r)),
                          torch.sin(torch.tensor(r)))
        _ulp(rz.numpy(), jrmath._rot_z(np.cos(np.float32(r)),
                                       np.sin(np.float32(r))))
        np.testing.assert_allclose(rmath.rotate_z(m, r).numpy(),
                                   np.asarray(jrmath.rotate_z(jm, r)),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(rmath.rotate_x(m, r).numpy(),
                                   np.asarray(jrmath.rotate_x(jm, r)),
                                   rtol=1e-6, atol=1e-6)
    c = np.cos(0.7)
    np.testing.assert_allclose(rmath.rotate_x(eye, 0.7).numpy()[1:3, 1:3],
                               [[c, np.sin(0.7)], [-np.sin(0.7), c]],
                               atol=1e-6)
    # constructors and scalar ops
    np.testing.assert_array_equal(rmath.of(2.5, "cpu").numpy(),
                                  np.asarray(jrmath.of(2.5)))
    np.testing.assert_array_equal(rmath.of(torch.tensor(1.5)).numpy(),
                                  np.full((4, 4), 1.5))
    np.testing.assert_array_equal(rmath.mat4_cm(rows, "cpu").numpy(),
                                  np.asarray(jrmath.mat4_cm(rows)))
    np.testing.assert_array_equal(rmath.transpose(m).numpy(),
                                  np.asarray(jrmath.transpose(jm)))
    v, jv = rmath.vec(1.0, -2.5, 3.3, device="cpu"), jrmath.vec(1.0, -2.5, 3.3)
    for s in (3.0, 0.1, 7.7):
        _ulp(rmath.smult(v, s).numpy(), jrmath.smult(jv, s), 0)
        _ulp(rmath.sdiv(v, s).numpy(), jrmath.sdiv(jv, s), 0)
