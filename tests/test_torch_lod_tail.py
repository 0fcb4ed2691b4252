"""Port vs JAX: the ``lod_tail`` slab proxy of ``render_gaussians``
(``_pack_tail_aux``, ``_tail_sums``, the aux riding ``_bin_splats``'s sort
and ``finalize_planes``' slab branch).

Tolerances: ``_pack_tail_aux`` integer for integer; ``_tail_sums`` within
rtol/atol 1e-4 of float64 sums (JAX's own test); the frame within 6e-6 of
JAX's (the fog slice's bound; measured 5.4e-7 here) with equal integer
stats. The JAX frame renders once, in interpret mode.
"""

import jax
import jax.numpy as jnp
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
STATS = ("overflow_pairs", "overflow_big_splats", "tile_exec", "tile_kept",
         "tile_count", "lossless")


def _camera():
    view = jrmath.look_at_zforward(jrmath.vec(0.0, 0.0, -3.0),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), W / H, 0.1, 30.0)
    return np.asarray(view), np.asarray(proj)


def _fog(n=4000):
    """``tests/test_gs.py``'s deep stack of faint splats spread across the
    view: the LOD drops most of each list."""
    rng = np.random.RandomState(11)
    means = (rng.rand(n, 3).astype(np.float32) - 0.5) * np.array(
        [1.4, 0.8, 1.0], np.float32)
    return dict(means=means, scales=np.full((n, 3), 0.06, np.float32),
                quats=np.tile([[1.0, 0, 0, 0]], (n, 1)).astype(np.float32),
                opacities=np.full(n, 0.15, np.float32),
                colors=np.tile([[0.9, 0.7, 0.3]], (n, 1)).astype(np.float32))


D = _fog()
CLOUD = gaussians.cloud_from_numpy(D, device="cpu")


def test_pack_tail_aux_matches_jax():
    rng = np.random.RandomState(3)
    n = 4096
    alpha = np.concatenate([rng.rand(n - 4) * 10.0 ** rng.uniform(
        -2, 5, n - 4), [0.0, 1e-30, 1e9, 3e4]]).astype(np.float32)
    colors = (rng.rand(n, 3) * 1.4 - 0.2).astype(np.float32)
    npairs = rng.randint(0, 9, n).astype(np.int32)
    for pix in (32 * 32, 32 * 128):
        want = np.asarray(jax.jit(jgs._pack_tail_aux, static_argnums=3)(
            alpha, colors, npairs, pix))
        got = gs._pack_tail_aux(torch.from_numpy(alpha),
                                torch.from_numpy(colors),
                                torch.from_numpy(npairs), pix)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want >> 16)) > 1000     # the sqrt-domain levels


def test_tail_sums_match_numpy_and_jax():
    """JAX's ``test_tail_sums_match_numpy``, on the port, plus the JAX
    sums themselves."""
    rng = np.random.RandomState(7)
    m = 3000
    la = rng.rand(m).astype(np.float32) * 0.2
    cols = rng.rand(m, 3).astype(np.float32)
    q = np.clip((np.sqrt(la / gs._TAIL_LA_MAX) * 32767.0 + 0.5)
                .astype(np.int64), 0, 32767)
    r5 = (cols[:, 0] * 31 + 0.5).astype(np.int64)
    g6 = (cols[:, 1] * 63 + 0.5).astype(np.int64)
    b5 = (cols[:, 2] * 31 + 0.5).astype(np.int64)
    aux = ((q << 16) | (r5 << 11) | (g6 << 5) | b5).astype(np.int32)
    lo = np.sort(rng.randint(0, m, 17)).astype(np.int32)
    hi = np.minimum(lo + rng.randint(0, m // 4, 17), m).astype(np.int32)
    got = gs._tail_sums(torch.from_numpy(aux), torch.from_numpy(lo),
                        torch.from_numpy(hi)).numpy()
    laq = (q / 32767.0) ** 2 * gs._TAIL_LA_MAX
    ch = np.stack([laq, laq * (r5 / 31.0), laq * (g6 / 63.0),
                   laq * (b5 / 31.0)])
    want = np.stack([ch[:, a:b].sum(1) for a, b in zip(lo, hi)], -1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    jsum = np.asarray(jgs._tail_sums(jnp.asarray(aux), jnp.asarray(lo),
                                     jnp.asarray(hi)))
    np.testing.assert_allclose(got, jsum, rtol=1e-5, atol=1e-6)


def test_lod_tail_frame_matches_jax():
    """The slab proxy on the fog stack at tile_w 32, LOD 128 pairs a tile,
    against JAX's render_gaussians with the Pallas kernels interpreted."""
    view, proj = _camera()
    kw = dict(max_splats_per_tile=128, tile_w=32, lod_tail=True,
              return_stats=True, background=(0.1, 0.2, 0.3))
    jc = jgauss.gaussian_cloud(*(D[f] for f in FIELDS))
    jimg, jst = jgs.render_gaussians(jc, view, proj, W, H, interpret=True,
                                     **kw)
    img, st = gs.render_gaussians(CLOUD, view, proj, W, H, **kw)
    assert int(st["overflow_pairs"]) > 0        # the LOD drops pairs
    np.testing.assert_allclose(img.numpy(), np.asarray(jimg), rtol=0,
                               atol=6e-6)
    for k in STATS:
        np.testing.assert_array_equal(st[k].numpy(), np.asarray(jst[k]), k)
    plain = gs.render_gaussians(CLOUD, view, proj, W, H,
                                **{**kw, "lod_tail": False})[0]
    assert (img - plain).abs().max() > 0.05      # the slab adds energy


def test_lod_tail_proxy_recovers_dropped_energy():
    """JAX's ``test_lod_tail_proxy_recovers_dropped_energy`` on the port:
    the slab recovers a solid share of the energy the LOD drops."""
    view, proj = _camera()
    exact = gs.render_gaussians(CLOUD, view, proj, W, H).numpy()
    lod_no = gs.render_gaussians(CLOUD, view, proj, W, H,
                                 max_splats_per_tile=gs.CHUNK,
                                 lod_tail=False).numpy()
    lod_tail = gs.render_gaussians(CLOUD, view, proj, W, H,
                                   max_splats_per_tile=gs.CHUNK,
                                   lod_tail=True).numpy()
    err_no = np.abs(lod_no - exact).mean()
    err_tail = np.abs(lod_tail - exact).mean()
    assert err_no > 0.01, "fixture must actually drop visible energy"
    assert err_tail < 0.7 * err_no, (err_no, err_tail)


@pytest.mark.parametrize("tail_decim", [None, 64])
def test_lod_tail_without_drops_or_lod_changes_nothing(tail_decim):
    """Exact mode ignores ``lod_tail`` (as JAX's does), and an empty slab
    (no dropped pair) leaves the frame bit-equal."""
    view, proj = _camera()
    sparse = gaussians.cloud_from_numpy(
        {f: v[:200] for f, v in D.items()}, device="cpu")
    base = gs.render_gaussians(sparse, view, proj, W, H, tile_w=32)
    assert torch.equal(gs.render_gaussians(sparse, view, proj, W, H,
                                           tile_w=32, lod_tail=True), base)
    kw = dict(tile_w=32, max_splats_per_tile=512, lod_tail_decim=tail_decim,
              return_stats=True)
    no, st = gs.render_gaussians(sparse, view, proj, W, H, **kw)
    assert int(st["overflow_pairs"]) == 0
    got, _ = gs.render_gaussians(sparse, view, proj, W, H, lod_tail=True,
                                 **kw)
    assert torch.equal(got, no)
