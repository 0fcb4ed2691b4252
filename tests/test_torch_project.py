"""Port vs JAX: the projection (K1's plain version) against JAX
``project_gaussians`` and the Pallas ``_project_fast`` in interpret mode.

Tolerances: float outputs of splats valid on both sides within rtol 1e-5
(same f32 operations; XLA's and PyTorch's CPU log/sqrt may differ in the
last ulp); radius/rx/ry and the valid mask equal on ≥ 99.9% of splats and
within 1 elsewhere (a last-ulp change can move a ``ceil``).
"""

import numpy as np
import pytest
import torch

from ray_eater_tpu import rmath as jrmath
from ray_eater_tpu.models import gaussians as jgauss
from ray_eater_tpu.ops import gs as jgs
from ray_eater_tpu_torch.models import gaussians
from ray_eater_tpu_torch.ops import gs

torch.set_num_threads(1)

W, H = 256, 96
FIELDS = ("means", "scales", "quats", "opacities", "colors")


def _scene():
    jc = jgauss.random_cloud(4000, seed=7, extent=1.6,
                             scale_range=(0.004, 0.08))
    d = {f: np.array(getattr(jc, f)) for f in FIELDS}
    # faint splats exercise the opacity-aware cutoff and the alpha cull
    d["opacities"][:200] = np.linspace(0.001, 0.05, 200, dtype=np.float32)
    jc = jgauss.gaussian_cloud(*(d[f] for f in FIELDS))
    view = jrmath.look_at_zforward(jrmath.vec(0.4, -0.3, -2.2),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), W / H, 0.1, 30.0)
    return jc, d, view, proj


@pytest.fixture(scope="module")
def projected():
    jc, d, view, proj = _scene()
    args = (jc.means, jc.scales, jc.quats, jc.opacities, jc.colors, view,
            proj, W, H)
    ref_jnp = jgs.project_gaussians(*args)
    ref_pallas = jgs._project_fast(*args, interpret=True)
    c = gaussians.cloud_from_numpy(d, device="cpu")
    v = torch.from_numpy(np.array(view))
    p = torch.from_numpy(np.array(proj))
    got = gs.project_gaussians(c.means, c.scales, c.quats, c.opacities,
                               c.colors, v, p, W, H)
    fast = gs._project_fast(c.means, c.scales, c.quats, c.opacities,
                            c.colors, v, p, W, H)
    return ref_jnp, ref_pallas, got, fast


def _compare(ref, got):
    n = got.depth.shape[0]
    vr = np.isfinite(np.asarray(ref.depth))
    vg = np.isfinite(got.depth.numpy())
    assert (vr != vg).sum() <= 1e-3 * n
    both = vr & vg
    assert both.sum() > 1000            # the scene is mostly on screen
    for name in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy()[both],
                                   np.asarray(getattr(ref, name))[both],
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    for name in ("radius", "ext"):
        a = getattr(got, name).numpy().reshape(n, -1)
        b = np.asarray(getattr(ref, name)).reshape(n, -1)
        assert a.dtype == np.int32
        diff = np.abs(a.astype(np.int64) - b)
        assert diff.max() <= 1, name
        assert (diff.max(1) > 0).sum() <= 1e-3 * n, name


@pytest.mark.parametrize("ref", ["jnp", "pallas"])
@pytest.mark.parametrize("path", ["plain", "wrapper"])
def test_projection_matches_jax(projected, ref, path):
    ref_jnp, ref_pallas, got, fast = projected
    _compare(ref_jnp if ref == "jnp" else ref_pallas,
             got if path == "plain" else fast)


def test_projection_culls_like_jax(projected):
    ref_jnp, _, got, _ = projected
    vr = np.isfinite(np.asarray(ref_jnp.depth))
    vg = np.isfinite(got.depth.numpy())
    # the faint splats below 1/255 are culled on both sides
    assert not vg[:12].any() and not vr[:12].any()
    assert 0 < vg.sum() < vg.size


def test_k1_wrapper_refuses_other_devices():
    m = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError):
        gs._project_k1(m, m, torch.empty((4, 4), device="meta"),
                       torch.empty(4, device="meta"),
                       torch.empty(24, device="meta"))
