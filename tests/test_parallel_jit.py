"""tests/test_parallel.py's sharded-vs-single renders under jax.jit.

There those renders run through an eager shard_map over the 8-device
virtual CPU mesh with interpreted kernels, minutes a test, and the root
conftest.py marks them slow. Each test here is the twin of one of them,
named with a ``_jit`` suffix: the same clouds, camera, knobs, budgets and
assertions, through the same functions under jax.jit. The single-device
references are rendered once per module, in fixtures.
"""

import numpy as np
import jax
import pytest

from ray_eater_tpu import rmath
from ray_eater_tpu.models.gaussians import random_cloud
from ray_eater_tpu.ops.gs import (num_tiles, render_gaussians,
                                  update_lod_budget)
from ray_eater_tpu.parallel.sharded import (make_device_mesh,
                                            render_gaussians_depth_sliced,
                                            render_gaussians_sharded)

W, H = 256, 128
#: the flagship knob set: per-tile LOD + tail slab + footprint-tight tile_w
FLAGSHIP = dict(max_splats_per_tile=128, big_splat_cap=128, lod_tail=True,
                tile_w=32)
#: the inria production caps: three-level binning, the mid-lo split and
#: the corner channel (the wide cloud projects 904 mid-fan splats at
#: 256x128, so the caps clear the counts and the certificate can hold)
CAPS = dict(big_splat_cap=256, mid_splat_cap=1024, mid_lo_splat_cap=1024,
            corner_cap=512, tile_w=32)


def camera():
    view = rmath.look_at_zforward(rmath.vec(0.0, 0.6, -2.5),
                                  rmath.vec(0.0, 0.0, 0.0))
    proj = rmath.perspective(rmath.radians(60.0), W / H, 0.1, 30.0)
    return view, proj


def jitted(render, cloud, traced=None, **static):
    """``render(cloud, view, proj, W, H, ..., interpret=True)`` under
    jax.jit: the cloud, the camera and the ``traced`` keywords' arrays
    traced, the ``static`` keywords closed over. Arrays come back as
    numpy."""
    view, proj = camera()
    out = jax.jit(lambda c, v, p, t: render(
        c, v, p, width=W, height=H, interpret=True, **t, **static))(
            cloud, view, proj, traced or {})
    return jax.tree.map(np.asarray, out)


def small_cloud():
    return random_cloud(512, seed=11, extent=0.8, scale_range=(0.02, 0.06))


def flagship_cloud():
    return random_cloud(1024, seed=7, extent=0.8, scale_range=(0.02, 0.06))


def big_cloud():
    return random_cloud(256, seed=3, extent=0.6, scale_range=(0.05, 0.35))


def wide_cloud():
    return random_cloud(1024, seed=5, extent=0.7, scale_range=(0.02, 0.28))


@pytest.fixture(scope="module")
def mesh():
    return make_device_mesh()


@pytest.fixture(scope="module")
def all_gather(mesh):
    """The all_gather exchange's frame of the small cloud."""
    return jitted(render_gaussians_sharded, small_cloud(), mesh=mesh,
                  background=(0.1, 0.1, 0.1))


@pytest.fixture(scope="module")
def single_small():
    return jitted(render_gaussians, small_cloud(),
                  background=(0.1, 0.1, 0.1))


def test_gaussians_sharded_matches_single_jit(single_small, all_gather):
    single, sharded = single_small, all_gather
    assert sharded.shape == single.shape
    err = np.abs(sharded - single)
    # identical math, different reduction grouping → tiny fp drift only
    assert err.max() < 1e-4, err.max()


@pytest.fixture(scope="module")
def single_flagship():
    return jitted(render_gaussians, flagship_cloud(), return_stats=True,
                  **FLAGSHIP)


def test_gaussians_sharded_flagship_config_matches_single_jit(
        single_flagship, mesh):
    # the FULL flagship knob set: per-tile LOD + temporal budget feedback +
    # stats telemetry + tail slab + footprint-tight tile_w, sharded ==
    # single-device
    cloud = flagship_cloud()
    single, st1 = single_flagship
    sharded, st2 = jitted(render_gaussians_sharded, cloud, mesh=mesh,
                          return_stats=True, **FLAGSHIP)
    # stats parity: same pair totals dropped, same telemetry shape
    assert st2["tile_exec"].shape[0] >= st1["tile_exec"].shape[0]
    assert int(st2["overflow_big_splats"]) >= 0
    err = np.abs(np.asarray(sharded) - np.asarray(single))
    # LOD pool allocation is per-band (each band scales its own pool) and
    # the tail slab's per-splat energy split is band-local, so sharded is
    # not bit-identical — but with an uncrowded pool both effects vanish
    # on most pixels
    assert err.mean() < 5e-3, err.mean()

    # temporal adaptive LOD round trip: full-grid telemetry → full-grid
    # budget → next sharded frame accepts it
    ntx, nty = num_tiles(W, H, tile_w=32)
    nty = -(-nty // 8) * 8          # sharded pads rows to the mesh size
    budget = update_lod_budget(st2["tile_exec"], 128, ntx, nty,
                               st2["tile_kept"], st2["tile_count"])
    img2 = jitted(render_gaussians_sharded, cloud, dict(lod_budget=budget),
                  mesh=mesh, **FLAGSHIP)
    err2 = np.abs(np.asarray(img2) - np.asarray(single))
    assert err2.mean() < 5e-3, err2.mean()


def test_gaussians_sharded_ring_exchange_matches_all_gather_jit(
        all_gather, mesh):
    # ring splat exchange (ppermute + band compaction, the 10M-splat
    # memory path) must match the all_gather exchange; overflow counted
    # when the ring budget is too small
    cloud = small_cloud()
    base = all_gather
    # budget = N: cannot overflow (bands here are 32 px, radii are
    # comparable — the 2N/D default is for production aspect ratios)
    ringed, st = jitted(render_gaussians_sharded, cloud, mesh=mesh,
                        background=(0.1, 0.1, 0.1), splat_exchange="ring",
                        ring_budget=512, return_stats=True)
    err = np.abs(np.asarray(ringed) - base)
    assert err.max() < 1e-4, err.max()
    assert int(st["overflow_big_splats"]) == 0
    assert bool(st["lossless"])         # exact + no channel drops
    # starve the budget: must still render (graceful) and report drops
    _, st2 = jitted(render_gaussians_sharded, cloud, mesh=mesh,
                    background=(0.1, 0.1, 0.1), splat_exchange="ring",
                    ring_budget=16, return_stats=True)
    assert int(st2["overflow_big_splats"]) > 0
    assert not bool(st2["lossless"])    # drops withdraw the certificate


@pytest.fixture(scope="module")
def single_sliced():
    """The exact frames the sort-last test holds its slices to."""
    return (jitted(render_gaussians, small_cloud(),
                   background=(0.1, 0.2, 0.3)),
            jitted(render_gaussians, big_cloud(), background=(0, 0, 0),
                   big_splat_cap=256))


def test_gaussians_depth_sliced_matches_single_jit(single_sliced, mesh):
    # sort-last mode: depth-quantile slices composited full-frame per
    # device, folded front-to-back — must match the single-device exact
    # render (different pair->device split => fp-grouping drift only)
    single, sb = single_sliced
    cloud = small_cloud()
    sliced, st = jitted(render_gaussians_depth_sliced, cloud, mesh=mesh,
                        background=(0.1, 0.2, 0.3), slice_budget=512,
                        return_stats=True)
    assert int(st["overflow_big_splats"]) == 0
    assert bool(st["lossless"])
    err = np.abs(np.asarray(sliced) - single)
    assert err.max() < 1e-4, err.max()
    # starved slice budget: graceful + counted
    _, st2 = jitted(render_gaussians_depth_sliced, cloud, mesh=mesh,
                    background=(0.1, 0.2, 0.3), slice_budget=16,
                    return_stats=True)
    assert int(st2["overflow_big_splats"]) > 0
    assert not bool(st2["lossless"])
    # two-level big-splat binning through the sort-last path
    db = jitted(render_gaussians_depth_sliced, big_cloud(), mesh=mesh,
                background=(0, 0, 0), big_splat_cap=256, slice_budget=256)
    assert np.abs(db - sb).max() < 1e-4


@pytest.fixture(scope="module")
def single_midfan():
    """The wide cloud's exact and LOD frames under the production caps."""
    return (jitted(render_gaussians, wide_cloud(), return_stats=True,
                   **CAPS),
            jitted(render_gaussians, wide_cloud(), return_stats=True,
                   max_splats_per_tile=128, **CAPS))


def test_gaussians_sharded_midfan_exact_certified_matches_single_jit(
        single_midfan, mesh):
    # the inria PRODUCTION knob set: three-level binning (mid_splat_cap
    # with big_splat_cap), payload-sort exact pack, and the
    # saturation-certified lossless flag — sharded == single on the
    # configs that actually ship. Wide radius range so all three fan
    # levels carry splats.
    cloud = wide_cloud()
    (single, st1), (s_lod, stl1) = single_midfan

    # exact mode (payload-sort): bit-near parity + certificates agree
    sharded, st2 = jitted(render_gaussians_sharded, cloud, mesh=mesh,
                          return_stats=True, **CAPS)
    assert int(st1["overflow_big_splats"]) == 0
    assert int(st2["overflow_big_splats"]) == 0
    assert bool(st1["lossless"]) and bool(st2["lossless"])
    err = np.abs(np.asarray(sharded) - np.asarray(single))
    assert err.max() < 1e-4, err.max()

    # LOD mode with the mid fan + temporal budget round trip
    kw = dict(max_splats_per_tile=128, **CAPS)
    d_lod, stl2 = jitted(render_gaussians_sharded, cloud, mesh=mesh,
                         return_stats=True, **kw)
    err2 = np.abs(np.asarray(d_lod) - np.asarray(s_lod))
    assert err2.mean() < 5e-3, err2.mean()
    ntx, nty = num_tiles(W, H, tile_w=32)
    nty = -(-nty // 8) * 8
    budget = update_lod_budget(stl2["tile_exec"], 128, ntx, nty,
                               stl2["tile_kept"], stl2["tile_count"])
    img2 = jitted(render_gaussians_sharded, cloud, dict(lod_budget=budget),
                  mesh=mesh, **kw)
    err3 = np.abs(np.asarray(img2) - np.asarray(s_lod))
    assert err3.mean() < 5e-3, err3.mean()


def tail_knobs(tail_d):
    return dict(max_splats_per_tile=64, lod_tail_decim=128,
                lod_tail_d=tail_d, **CAPS)


@pytest.fixture(scope="module", params=(2, 4))
def single_tail(request):
    """(tail_d, the wide cloud's decimated-tail frame and stats)."""
    return request.param, jitted(render_gaussians, wide_cloud(),
                                 return_stats=True,
                                 **tail_knobs(request.param))


def test_gaussians_sharded_tail_decim_matches_single_jit(single_tail, mesh):
    # the decimated-tail composite (inria production default: mpt=128 +
    # tail=768 @ lod_tail_d=4) — sharded == single at both decimation
    # factors, one case each. Pool grants are per-band, so parity is
    # statistical (mean), like the other LOD-mode checks.
    tail_d, (s, st1) = single_tail
    d, st2 = jitted(render_gaussians_sharded, wide_cloud(), mesh=mesh,
                    return_stats=True, **tail_knobs(tail_d))
    err = np.abs(np.asarray(d) - np.asarray(s))
    assert err.mean() < 5e-3, (tail_d, err.mean())
    # the tail moves dropped-pair accounting behind the second pool
    # on both paths
    assert int(st2["overflow_pairs"]) >= 0
