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
