"""Port vs the repository's oracles: ``ray_eater_tpu_torch.psnr_report``.

Its float64 oracles (``viewport``, ``rasterize_reference``,
``interpolate``, ``reference_composite``) are copies, kept in the port so
that the report runs on a machine without JAX; here each is held to the
original (``tests/golden_raster.py``, ``tests/test_gs.py``) on the same
float64 numpy inputs, the composite on the JAX package's
``ProjectedSplats``. Then the report on the CPU: the three lines of
``tools/psnr_report.py`` under its names, each at least 60 dB (the JAX
tool prints 99.0 dB, a mean squared error under 1e-12, on all three on
the CPU), and its JSON line.

Tolerances: the oracles are equal to the last bit (the same numpy
operations); the report's gate is 60 dB.
"""

import json
import os
import re
import sys

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS)
sys.path.insert(0, ROOT)
sys.path.insert(0, TESTS)

import golden_raster as gold  # noqa: E402
from test_gs import reference_composite as jreference_composite  # noqa: E402
from ray_eater_tpu import rmath as jrmath  # noqa: E402
from ray_eater_tpu.models.gaussians import random_cloud as jrandom_cloud  # noqa: E402
from ray_eater_tpu.ops.gs import project_gaussians as jproject  # noqa: E402
from ray_eater_tpu_torch import psnr_report  # noqa: E402


def clip_coords(rng, n_tris):
    """Random float64 clip coordinates of ``n_tris`` triangles in front of
    the camera, some crossing the image edges, and their indices."""
    ndc = rng.uniform(-1.3, 1.3, (3 * n_tris, 3))
    ndc[:, 2] = rng.uniform(0.05, 0.95, 3 * n_tris)
    w = rng.uniform(0.5, 4.0, (3 * n_tris, 1))
    clip = np.concatenate([ndc * w, w], -1)
    return clip, np.arange(3 * n_tris).reshape(n_tris, 3)


@pytest.mark.parametrize("cull,front,depth_test", [
    ("back", "cw", True), ("front", "ccw", True), ("none", "cw", False)])
def test_raster_oracles_equal_the_originals(cull, front, depth_test):
    rng = np.random.RandomState(3)
    clip, idx = clip_coords(rng, 12)
    w, h = 48, 40
    np.testing.assert_array_equal(psnr_report.viewport(clip, w, h)[0],
                                  gold.viewport(clip, w, h)[0])
    got = psnr_report.rasterize_reference(clip, idx, w, h, cull=cull,
                                          front=front, depth_test=depth_test)
    want = gold.rasterize_reference(clip, idx, w, h, cull=cull, front=front,
                                    depth_test=depth_test)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert (want[1] >= 0).any()
    values = rng.rand(len(clip), 4)
    np.testing.assert_array_equal(
        psnr_report.interpolate(values, idx, *got[1:]),
        gold.interpolate(values, idx, *want[1:]))


@pytest.mark.parametrize("kw", [
    {}, {"tile_w": 32}, {"two_level": True, "return_sensitive": True}])
def test_composite_oracle_equals_the_original(kw):
    w, h = 128, 64
    cloud = jrandom_cloud(60, seed=5, extent=0.8, scale_range=(0.02, 0.12))
    view = jrmath.look_at_zforward(jrmath.vec(0.0, 0.0, -3.0),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), w / h, 0.1, 30.0)
    ps = jproject(cloud.means, cloud.scales, cloud.quats, cloud.opacities,
                  cloud.colors, view, proj, w, h)
    bg = (0.1, 0.2, 0.3)
    got = psnr_report.reference_composite(ps, w, h, bg, **kw)
    want = jreference_composite(ps, w, h, bg, **kw)
    if kw.get("return_sensitive"):
        np.testing.assert_array_equal(got[1], want[1])
        got, want = got[0], want[0]
    assert got.dtype == np.float64 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)
    assert np.abs(want - np.asarray(bg)).max() > 0.1   # splats landed


def test_report_on_cpu(capsys):
    assert psnr_report.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    src = open(os.path.join(ROOT, "tools", "psnr_report.py")).read()
    names = re.findall(r'print\(f"PSNR (\w+): ', src)
    assert len(names) == 3
    assert [ln.split(":")[0] for ln in lines[:3]] == [f"PSNR {n}"
                                                      for n in names]
    figures = json.loads(lines[3])["psnr"]
    assert list(figures) == names
    for n, line in zip(names, lines):
        assert line == f"PSNR {n}: {figures[n]:.1f} dB"
        assert figures[n] >= 60.0, (n, figures[n])
