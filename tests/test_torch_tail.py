"""Port vs JAX: the decimated tail (K3's plain version
``_composite_tail_plain``, ``_decimate_t``, ``_untile_decim``, the tail
branch of ``finalize_planes``) and the whole inria slice through
``render_gaussians``.

Tolerances: K3's plain version against the Pallas ``_composite_tail_call``
in interpret mode within 2e-3 max abs on the tail-visited tiles (a
``cumprod`` against the TPU's doubling scan: reassociation only), ``exec``
of the port equal to the rows the JAX layout holds before saturation;
``finalize_planes`` and ``_decimate_t`` within 1e-6 (the bilinear
upsample and the quad means sum in another order); whole renders within
2e-3 max abs (XLA's and PyTorch's CPU exp may put an alpha on either side
of the 1/255 cutoff) with every integer stat equal. The JAX side makes two
``render_gaussians`` calls, cached per module.
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
from ray_eater_tpu.ops import gs as jgs  # noqa: E402
from ray_eater_tpu_torch.bench_knobs import (flythrough_camera,  # noqa: E402
                                             render_kwargs, resolve_knobs)
from ray_eater_tpu_torch.models import gaussians  # noqa: E402
from ray_eater_tpu_torch.ops import gs  # noqa: E402

torch.set_num_threads(1)

FIELDS = ("means", "scales", "quats", "opacities", "colors")
STATS = ("overflow_pairs", "overflow_big_splats", "tile_exec", "tile_kept",
         "tile_count", "lossless")
W, H, TW, N, T = 256, 96, 64, 3000, 0.25
BG = (0.1, 0.2, 0.3)


def _cloud_arrays():
    """inria_cloud(3000) with its floaters (the last tenth) grown 4x, so
    that every side channel holds splats at this small size."""
    c = gaussians.inria_cloud(N, seed=1, device="cpu")
    d = {f: getattr(c, f).numpy().copy() for f in FIELDS}
    d["scales"][N - N // 10:] *= 4.0
    return d


D = _cloud_arrays()
CLOUD = gaussians.cloud_from_numpy(D, device="cpu")
KNOBS = resolve_knobs("inria", N, env={})


def _jcloud():
    from ray_eater_tpu.models import gaussians as jgauss
    return jgauss.gaussian_cloud(*(D[f] for f in FIELDS))


@pytest.fixture(scope="module", params=["lod_tail", "exact"])
def rendered(request):
    """(kwargs, JAX image, JAX stats, port image, port stats) for the inria
    knobs: the LOD frame with the decimated tail, and the gate's exact
    frame with the side channels."""
    exact = request.param == "exact"
    kw = render_kwargs(KNOBS, exact=exact, interpret=True)
    kw["return_stats"] = True
    jv, jp = bench.flythrough_camera(np.float32(T), W, H)
    jimg, jst = jgs.render_gaussians(_jcloud(), jv, jp, W, H, BG, **kw)
    timg, tst = gs.render_gaussians(CLOUD, np.asarray(jv), np.asarray(jp),
                                    W, H, BG, **kw)
    return (kw, np.asarray(jimg), {k: np.asarray(jst[k]) for k in STATS},
            timg.numpy(), {k: tst[k].numpy() for k in STATS})


def test_inria_slice_matches_jax(rendered):
    kw, jimg, jst, timg, tst = rendered
    assert timg.shape == jimg.shape == (H, W, 3) and np.isfinite(timg).all()
    err = np.abs(timg - jimg)
    assert err.max() <= 2e-3, err.max()
    for k in STATS:
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    assert int(jst["overflow_big_splats"]) == 0


def test_inria_slice_exercises_channels_and_tail(rendered):
    # the frame routes splats through every side channel, and in LOD mode
    # the head pool binds and the tail carries pairs past it
    kw = rendered[0]
    view, proj = flythrough_camera(T, W, H, device="cpu")
    keys = ("max_splats_per_tile", "big_splat_cap", "mid_splat_cap",
            "mid_lo_splat_cap", "corner_cap", "lod_tail_decim",
            "pairs_cap_factor", "tile_w")
    lay = gs._frame_layout(CLOUD, view, proj, W, H,
                           **{k: kw.get(k) for k in keys})
    b = lay.binned
    kw_one = {k: kw.get(k) for k in keys[:5]}
    for drop in ("big_splat_cap", "mid_splat_cap", "mid_lo_splat_cap",
                 "corner_cap"):
        # dropping a channel's budget to 1 drops some of its splats
        lay1 = gs._frame_layout(CLOUD, view, proj, W, H, tile_w=TW,
                                **dict(kw_one, **{drop: 1}))
        assert int(lay1.binned.overflow_big) > 0, drop
    if kw.get("max_splats_per_tile") is None:
        assert b.kept_tl is None and b.pack_idx_tl is None
        assert int(b.overflow) == 0
    else:
        assert bool((b.kept < b.count).any())
        assert int(b.kept_tl.sum()) > 0
        # K3 reads the record table through the tail layout's splat ids
        assert lay.records.shape == (N, 12)
        assert b.pack_idx_tl.dtype == torch.int32
        assert 0 <= int(b.pack_idx_tl.min()) <= int(b.pack_idx_tl.max()) < N


def test_tail_d1_reproduces_exact():
    # with the tail pinned to decimation 1, head + tail is the same math as
    # a deeper head: it must reproduce the exact render when the two pools
    # cover every pair (the port's counterpart of test_gs.py's
    # test_tail_decim1_matches_deeper_exact)
    c = gaussians.random_cloud(600, seed=3, extent=0.5,
                               scale_range=(0.03, 0.09), device="cpu")
    from ray_eater_tpu_torch import rmath
    view = rmath.look_at_zforward(rmath.vec(0.0, 0.0, -3.0, device="cpu"),
                                  rmath.vec(0.0, 0.0, 0.0, device="cpu"))
    proj = rmath.perspective(rmath.radians(60.0, device="cpu"), W / H, 0.1,
                             30.0)
    exact = gs.render_gaussians(c, view, proj, W, H).numpy()
    head, st = gs.render_gaussians(c, view, proj, W, H,
                                   max_splats_per_tile=128,
                                   return_stats=True)
    assert int(st["overflow_pairs"]) > 0        # the head alone drops pairs
    both, st = gs.render_gaussians(c, view, proj, W, H,
                                   max_splats_per_tile=128,
                                   lod_tail_decim=512, lod_tail_d=1,
                                   return_stats=True)
    assert int(st["overflow_pairs"]) == 0

    def psnr(a):
        mse = float(np.mean((a - exact) ** 2))
        return 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr(both.numpy()) > 100.0, psnr(both.numpy())
    assert psnr(head.numpy()) < 60.0


# ---------------------------------------------------------------------------
# K3's plain version against the Pallas tail composite
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tail_layout():
    """A JAX-built tail layout of the inria frame: the record table and
    the tail layout's splat ids, the packed tail records (for the JAX
    composite), step tuple, per-tile tail grants, row ranges."""
    view, proj = flythrough_camera(T, W, H, device="cpu")
    ps = gs.project_gaussians(CLOUD.means, CLOUD.scales, CLOUD.quats,
                              CLOUD.opacities, CLOUD.colors, view, proj, W, H,
                              max_radius=gs.level2_max_radius(TW))
    records = gs._make_records(ps).numpy()
    ntx, nty = gs.num_tiles(W, H, TW)
    j = {k: jnp.asarray(v.contiguous().numpy()) for k, v in dict(
        mx=ps.mean2d[:, 0], my=ps.mean2d[:, 1], rad=ps.radius,
        valid=torch.isfinite(ps.depth), depth=ps.depth, ext=ps.ext).items()}
    jbin = jax.jit(jgs._bin_splats, static_argnums=(5, 6, 7),
                   static_argnames=("max_per_tile", "tail_decim", "tile_w",
                                    "big_cap", "mid_cap", "mid_lo_cap",
                                    "corner_cap"))
    *_, (pack_tl, steps_tl, kept_tl) = jbin(
        j["mx"], j["my"], j["rad"], j["valid"], j["depth"], ntx, nty, 1 << 20,
        max_per_tile=32, tail_decim=128, tile_w=TW, ext=j["ext"],
        big_cap=100, mid_cap=100, mid_lo_cap=100, corner_cap=100)
    kept_tl = np.asarray(kept_tl)
    blocks = (kept_tl + gs.CHUNK - 1) // gs.CHUNK
    begin = (np.concatenate([[0], np.cumsum(blocks)[:-1]])
             * gs.CHUNK).astype(np.int32)
    ids = np.asarray(pack_tl).astype(np.int32)
    return dict(records=records, ids=ids, packed=records[ids],
                steps=steps_tl,
                kept_tl=kept_tl, begin=begin,
                end=(begin + kept_tl).astype(np.int32), ntx=ntx, nty=nty)


@pytest.mark.parametrize("decim", [2, 4])
def test_composite_tail_plain_matches_jax(tail_layout, decim):
    L = tail_layout
    ntx, nty = L["ntx"], L["nty"]
    nt = ntx * nty
    pixd = (gs.TILE_H // decim) * (TW // decim)
    vis_t = L["kept_tl"] > 0
    assert vis_t.sum() >= 3
    rng = np.random.RandomState(decim)
    td = (0.2 + 0.8 * rng.rand(nt, pixd)).astype(np.float32)
    args = [torch.from_numpy(L[k]) for k in ("records", "ids", "begin",
                                              "end")]
    skip = np.flatnonzero(vis_t)[0]
    td[skip] = 5e-5            # entered saturated: the tile runs nothing
    # a tile entered just above saturation at one sample that its first
    # chunk covers (and below it elsewhere) saturates after that chunk
    sat = np.flatnonzero(L["kept_tl"] > gs.CHUNK)[0]
    end1 = args[3].clone()
    end1[sat] = args[2][sat] + gs.CHUNK
    probe, _ = gs._composite_tail_plain(args[0], args[1], args[2], end1,
                                        torch.ones(nt, pixd), ntx, nty, TW,
                                        decim)
    k = int(probe[3, sat].argmin())
    assert float(probe[3, sat, k]) < 0.5
    td[sat] = 5e-5
    td[sat, k] = 1.5e-4
    r, g, b, t = jgs._composite_tail_call(
        jnp.asarray(L["packed"]), L["steps"],
        jnp.asarray(np.concatenate([td, np.ones((1, pixd), np.float32)])
                    [:, None]), nty, ntx, True, TW, decim=decim,
        nseg=jgs._TAIL_SEG)
    want = np.stack([np.asarray(p)[:nt, 0] for p in (r, g, b, t)])
    planes, ex = gs._composite_tail_call(*args, torch.from_numpy(td), ntx,
                                         nty, TW, decim)
    assert planes.shape == (4, nt, pixd) and ex.shape == (nt,)
    p = planes.numpy()
    err = np.abs(p[:, vis_t] - want[:, vis_t])
    assert err.max() <= 2e-3, err.max()
    ex = ex.numpy()
    assert ex[skip] == 0 and (p[:3, skip] == 0).all()
    np.testing.assert_array_equal(p[3, skip], td[skip])
    assert ex[sat] == gs.CHUNK < L["kept_tl"][sat]
    run = vis_t & (np.arange(nt) != skip) & (np.arange(nt) != sat)
    np.testing.assert_array_equal(ex[run], L["kept_tl"][run])
    # tiles without tail rows keep rgb 0 and their entry T
    assert (p[:3, ~vis_t] == 0).all() and (ex[~vis_t] == 0).all()
    np.testing.assert_array_equal(p[3, ~vis_t], td[~vis_t])


@pytest.mark.parametrize("decim", [1, 2, 4])
def test_composite_tail_merged_matches_plain(tail_layout, decim):
    """K3's chunk-then-merge order (``_composite_tail_merged``, the
    kernel's plain twin) against the plain version: the colours within
    1e-6 (reassociation), T and exec equal, on a frame where one tile
    saturates inside its tail and one is entered saturated; and on an entry
    T saturated everywhere, where no tile runs."""
    L = tail_layout
    ntx, nty = L["ntx"], L["nty"]
    nt = ntx * nty
    pixd = (gs.TILE_H // decim) * (TW // decim)
    args = [torch.from_numpy(L[k]) for k in ("records", "ids", "begin",
                                              "end")]
    rng = np.random.RandomState(20 + decim)
    td = (0.2 + 0.8 * rng.rand(nt, pixd)).astype(np.float32)
    td[np.flatnonzero(L["kept_tl"] > 0)[0]] = 5e-5
    # entered just above saturation at the sample that the first chunk
    # darkens most, below it elsewhere: saturates after that chunk
    sat = np.flatnonzero(L["kept_tl"] > gs.CHUNK)[0]
    probe, _ = gs._composite_tail_plain(*args, torch.ones(nt, pixd), ntx,
                                        nty, TW, decim)
    td[sat] = 5e-5
    td[sat, int(probe[3, sat].argmin())] = 1.5e-4
    for entry in (td, np.full((nt, pixd), 5e-5, np.float32)):
        t = torch.from_numpy(entry)
        (pm, em) = gs._composite_tail_merged(*args, t, ntx, nty, TW, decim)
        (pp, ep) = gs._composite_tail_plain(*args, t, ntx, nty, TW, decim)
        assert pm.shape == (4, nt, pixd)
        assert float((pm[:3] - pp[:3]).abs().max()) <= 1e-6
        assert torch.equal(pm[3], pp[3]) and torch.equal(em, ep)
        if entry is td:
            ran = em.numpy() > 0
            assert em[sat] == gs.CHUNK < L["kept_tl"][sat]
            assert ran.sum() >= 3 and float(pm[:3, ran].abs().max()) > 0
        else:
            assert int(em.abs().sum()) == 0 and bool((pm[:3] == 0).all())
            assert torch.equal(pm[3], t)


def test_k3_wrapper_refuses_other_devices():
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        gs._composite_tail_call(
            torch.empty((128, 12), **meta),
            torch.empty(128, dtype=torch.int32, **meta),
            torch.empty(6, dtype=torch.int32, **meta),
            torch.empty(6, dtype=torch.int32, **meta),
            torch.empty((6, 128), **meta), 2, 3, 64, 4)


# ---------------------------------------------------------------------------
# decimation, untiling and the tail finalize
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decim", [1, 2, 4])
def test_tail_finalize_matches_jax(decim):
    rng = np.random.RandomState(10 + decim)
    ntx, nty, tw = 3, 2, 64
    nt = ntx * nty
    pix = gs.TILE_H * tw
    pixd = pix // decim ** 2
    head = rng.rand(4, nt, pix).astype(np.float32)
    visited = np.array([True, False, True, True, True, False])
    td = np.array(jgs._decimate_t(
        jnp.asarray(np.concatenate([head[3], np.ones((1, pix), np.float32)])
                    [:, None]), tw, decim))[:nt, 0]
    ttd = gs._decimate_t(torch.from_numpy(head[3]), tw, decim).numpy()
    np.testing.assert_allclose(ttd, td, rtol=0, atol=1e-6)
    tail = rng.rand(4, nt, pixd).astype(np.float32) * 0.3
    tail[3] = td * rng.rand(nt, pixd).astype(np.float32)
    tail[3, 2] = 1.5 * td[2]          # a ratio above 1 is clipped
    vis_t = np.array([True, True, False, True, False, True])

    def jp(a):        # (nt, P) → the JAX package's (nt+1, 1, P) planes
        return jnp.asarray(np.concatenate([a, np.zeros_like(a[:1])])[:, None])
    want = jgs.finalize_planes(
        *(jp(p) for p in head), jnp.asarray(visited), nty, ntx, BG,
        tile_w=tw, tail_decim_planes=(*(jp(p) for p in tail), jp(td),
                                      jnp.asarray(vis_t)), decim=decim)
    got = gs.finalize_planes(
        torch.from_numpy(head), torch.from_numpy(visited), nty, ntx, BG, tw,
        (torch.from_numpy(tail), torch.from_numpy(td),
         torch.from_numpy(vis_t)), decim)
    assert got.shape == (nty * gs.TILE_H, ntx * tw, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    u = gs._untile_decim(torch.from_numpy(tail[0]), nty, ntx, tw, decim)
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(jgs._untile_decim(jp(tail[0]), nty, ntx, tw,
                                                decim)))

