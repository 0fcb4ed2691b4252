"""Port vs JAX: texture upload tables (``core.resources``) and sampling
(``ops.sampling``): the gather paths, the per-pixel mip gather, and the
subtile window sampler with K9's plain version and the binding-subtile
fallback.

Tolerances and why:
- Upload tables (quad-texel pack, mip pyramid, window table) and the
  linear texel data: bit-equal (the same numpy code).
- ``sample`` and ``_sample_mip``: within 2e-6 (eager JAX rounds each
  operation as the port does; the sRGB decode's ``pow`` and the LOD's
  ``log2`` may differ by an ulp between XLA and PyTorch).
- ``_sample_subtile`` against the Pallas version in interpret mode: within
  2e-6. The JAX kernel contracts the bilinear weights against the window
  as a dot product (XLA may fuse a multiply-add there); level choice,
  window ids and the fallback's subtile selection are integer decisions
  on identically rounded inputs.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ray_eater_tpu.core import resources as jres  # noqa: E402
from ray_eater_tpu.ops import sampling as jsp  # noqa: E402
from ray_eater_tpu_torch.core import resources as tres  # noqa: E402
from ray_eater_tpu_torch.ops import sampling as sp  # noqa: E402

torch.set_num_threads(1)

MODES = ("repeat", "mirrored_repeat", "clamp_to_edge")


def T(a):
    return torch.from_numpy(np.array(a))


def _noise(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 4) * 255).astype(np.uint8)


def _pair(u8, srgb=False, pack=True, **kw):
    """(JAX texture, port texture) of one image and sampler."""
    jkw = {k: (getattr(jres.AddressMode, v.upper()) if k == "address_mode"
               else getattr(jres.Filter, v.upper()) if k == "filter" else v)
           for k, v in kw.items()}
    tkw = {k: (getattr(tres.AddressMode, v.upper()) if k == "address_mode"
               else getattr(tres.Filter, v.upper()) if k == "filter" else v)
           for k, v in kw.items()}
    return (jres.texture_from_array(u8, jres.Sampler(**jkw), srgb=srgb,
                                    pack=pack),
            tres.texture_from_array(u8, tres.Sampler(**tkw), srgb=srgb,
                                    pack=pack, device="cpu"))


def _uv_perspective(H=64, W=96):
    """``tests/test_sampling.py``'s image-shaped uv: magnified near rows,
    minified far rows, several mip levels in one plane."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 0.25 + 2.5 * (ys / H)
    u = (xs / W - 0.5) * depth + 0.5
    v = (ys / H - 0.5) * depth + 0.5
    return np.stack([u, v], -1).astype(np.float32)


# ---- upload tables --------------------------------------------------------

@pytest.mark.parametrize("case", [
    ("noise64", "repeat", False), ("noise52x44", "clamp_to_edge", True),
    ("noise52x44", "mirrored_repeat", False), ("noise52x44", "repeat", True),
    ("checker256", "mirrored_repeat", True)])
def test_upload_tables_match_jax(case):
    img, mode, srgb = case
    if img == "noise64":
        u8 = _noise(64, 64, 5)
    elif img == "noise52x44":
        u8 = _noise(52, 44, 11)
    else:
        from ray_eater_tpu_torch.raster_scenes import checker_rgba
        u8 = checker_rgba()
    jt, tt = _pair(u8, srgb=srgb, address_mode=mode, mipmap=True)
    np.testing.assert_array_equal(tt.data.numpy(), np.asarray(jt.data))
    np.testing.assert_array_equal(tt.packed.numpy(), np.asarray(jt.packed))
    np.testing.assert_array_equal(tt.mip_table.numpy(),
                                  np.asarray(jt.mip_table))
    assert tt.mip_dims == jt.mip_dims and tt.packed_srgb == jt.packed_srgb
    assert (tt.win_table is None) == (jt.win_table is None)
    if jt.win_table is not None:
        np.testing.assert_array_equal(tt.win_table.numpy(),
                                      np.asarray(jt.win_table))
        assert tt.win_dims == jt.win_dims
    assert tt.data.device.type == "cpu"


def test_nearest_and_unpacked_upload_no_tables():
    u8 = _noise(8, 8, 1)
    _, t = _pair(u8, filter="nearest")
    assert t.packed is None and t.mip_table is None
    _, t = _pair(u8, pack=False, mipmap=True)
    assert t.packed is None and t.win_table is None


# ---- gather paths -----------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("path", ["nearest", "packed", "unpacked",
                                  "packed_srgb"])
def test_sample_matches_jax(path, mode):
    u8 = _noise(13, 37, 0)
    kw = dict(address_mode=mode)
    if path == "nearest":
        kw["filter"] = "nearest"
    jt, tt = _pair(u8, srgb=path == "packed_srgb", pack=path != "unpacked",
                   **kw)
    uv = (np.random.RandomState(1).rand(6, 9, 2) * 3 - 1).astype(np.float32)
    want = np.asarray(jsp.sample(jt, jnp.asarray(uv)))
    got = sp.sample(tt, T(uv)).numpy()
    assert got.shape == want.shape == (6, 9, 4)
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_sample_mip_matches_jax(mode):
    jt, tt = _pair(_noise(64, 64, 3), address_mode=mode, mipmap=True,
                   max_anisotropy=4.0)
    uv = _uv_perspective()
    want = np.asarray(jsp._sample_mip(jt, jnp.asarray(uv)))
    got = sp._sample_mip(tt, T(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)


# ---- the subtile sampler: K9 plain, level choice, fallback ----------------

def test_subtile_kernel_path_matches_jax():
    """Fallback off: the image is K9's output on the plan's windows and
    coordinate planes (REPEAT, the 64x64 noise texture)."""
    jt, tt = _pair(_noise(64, 64, 5), address_mode="repeat", mipmap=True,
                   subtile_fallback=0.0)
    uv = _uv_perspective()
    want = np.asarray(jsp._sample_subtile(jt, jnp.asarray(uv)))
    got = sp._sample_subtile(tt, T(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    plan = sp._subtile_plan(tt, T(uv))
    assert len(set(plan.lsub.tolist())) > 1, "several levels in one frame"


def test_subtile_fallback_with_coverage_matches_jax():
    """MIRRORED_REPEAT, a silhouette coverage mask (uncovered pixels carry
    another plane's uv), and the default 1/8 fallback budget, which this
    frame's binding subtiles overflow: the stable severity sort must pick
    the same subtiles as JAX."""
    jt, tt = _pair(_noise(64, 64, 9), address_mode="mirrored_repeat",
                   mipmap=True)
    uv = _uv_perspective()
    ys, xs = np.mgrid[0:uv.shape[0], 0:uv.shape[1]]
    cov = (ys.astype(np.float32) * 0.7 + 11.0) > xs
    uv[~cov] = uv[~cov] * 37.0 + 5.3
    want = np.asarray(jsp._sample_subtile(jt, jnp.asarray(uv),
                                          valid=jnp.asarray(cov)))
    got = sp._sample_subtile(tt, T(uv), valid=T(cov)).numpy()
    np.testing.assert_allclose(got[cov], want[cov], atol=2e-6, rtol=0)
    plan = sp._subtile_plan(tt, T(uv), T(cov))
    ns = plan.cus.shape[0]
    nb = sp._fallback_budget(ns, tt.sampler.subtile_fallback)
    _, bind = sp._binding(plan)
    assert 0 < nb < int(bind.sum()), (nb, int(bind.sum()))


def test_k9_plain_is_the_windowed_bilinear_tap():
    """K9's plain version against an independent float64 bilinear filter
    of the window table at the plan's window-local coordinates."""
    _, tt = _pair(_noise(64, 64, 5), address_mode="clamp_to_edge",
                  mipmap=True)
    plan = sp._subtile_plan(tt, T(_uv_perspective()))
    ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac = (
        p.numpy().astype(np.float64) for p in plan.planes)
    assert ty0.min() >= 0 and ty0.max() <= 30 and tx1.max() <= 30
    win = tt.win_table.numpy().astype(np.float64).reshape(-1, 4, 32, 32)

    def tap(wid, ty, fy, tx, fx):
        w = win[wid.numpy()][:, :, None]                  # (ns, 4, 1, 32, 32)
        ty, tx = ty.astype(int)[:, None], tx.astype(int)[:, None]
        s = np.arange(ty.shape[0])[:, None, None]
        c = np.arange(4)[None, :, None]

        def at(dy, dx):
            return w[s, c, 0, ty + dy, tx + dx]
        fy, fx = fy[:, None], fx[:, None]
        return ((at(0, 0) * (1 - fx) + at(0, 1) * fx) * (1 - fy)
                + (at(1, 0) * (1 - fx) + at(1, 1) * fx) * fy)

    want = (tap(plan.w0i, ty0, fy0, tx0, fx0) * (1 - frac[:, None])
            + tap(plan.w1i, ty1, fy1, tx1, fx1) * frac[:, None])
    got = sp._subtile_plain(plan.w0i, plan.w1i, *plan.planes,
                            tt.win_table).numpy()
    assert got.shape == (plan.cus.shape[0], 4, 256)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_fallback_budget_and_stable_ties():
    for ns, f in ((24, 0.125), (8160, 0.125), (100, 1.0), (5, 0.5)):
        want = min(ns, max(8, -(-int(ns * f) // 8) * 8))
        assert sp._fallback_budget(ns, f) == want
    sev = torch.tensor([0.0, 0.5, 0.5, 0.2, 0.5, 0.0])
    sel = torch.argsort(-sev, stable=True)[:3]
    assert sel.tolist() == [1, 2, 4]


def test_fmod_matches_jnp_mod():
    x = np.array([-3.5, -2.0, -0.25, -0.0, 0.0, 0.75, 2.0, 3.9, 1e-8,
                  -1e-8], np.float32)
    np.testing.assert_array_equal(sp._fmod(T(x), 2.0).numpy(),
                                  np.asarray(jnp.mod(jnp.asarray(x), 2.0)))
