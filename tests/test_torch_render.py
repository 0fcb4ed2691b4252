"""Port vs JAX: the whole slice — ``render_gaussians`` (exact and LOD with a
binding pool, tile widths 32 and 128, one frame whose size is not a
multiple of the tile), the temporal budget loop, and the knobs the port
accepts, ignores or refuses.

Tolerances: images within 2e-3 max abs (XLA's and PyTorch's CPU exp may put
an alpha on either side of the 1/255 cutoff; measured ~6e-6 here); the
integer stats (``tile_exec``, ``tile_kept``, ``tile_count``,
``overflow_pairs``, ``lossless``) and the temporal budgets equal.
The JAX side runs 7 renders in interpret mode, cached per module.
"""

import inspect

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

FIELDS = ("means", "scales", "quats", "opacities", "colors")
STATS = ("overflow_pairs", "overflow_big_splats", "tile_exec", "tile_kept",
         "tile_count", "lossless")
BG = (0.1, 0.2, 0.3)


def _cloud_arrays():
    jc = jgauss.random_cloud(2500, seed=11, extent=0.9,
                             scale_range=(0.01, 0.05))
    d = {f: np.array(getattr(jc, f)) for f in FIELDS}
    # two opaque layers in front of the fog's centre, so some tiles
    # saturate inside their lists; depths 1e-5 apart (well over one 22-bit
    # depth bucket) so no two pairs of a tile share a sort key
    gx, gy = np.meshgrid(np.arange(-1.0, 0.45, 0.1),
                         np.arange(-1.0, 1.05, 0.1))
    nb = gx.size
    bm = np.concatenate([np.stack([gx.ravel(), gy.ravel(),
                                   np.full(nb, z)], -1) for z in (-1.4, -1.3)])
    bm[:, 2] += np.arange(len(bm)) * 1e-5
    nb = len(bm)
    rng = np.random.RandomState(5)
    blanket = dict(means=bm, scales=np.full((nb, 3), 0.08),
                   quats=np.tile([1.0, 0, 0, 0], (nb, 1)),
                   opacities=np.full(nb, 0.95), colors=rng.rand(nb, 3))
    return {f: np.concatenate([d[f], blanket[f]]).astype(np.float32)
            for f in FIELDS}


D = _cloud_arrays()
JCLOUD = jgauss.gaussian_cloud(*(D[f] for f in FIELDS))
CLOUD = gaussians.cloud_from_numpy(D, device="cpu")


def _camera(w, h):
    view = jrmath.look_at_zforward(jrmath.vec(0.0, 0.0, -3.0),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), w / h, 0.1, 30.0)
    return view, proj


CASES = {
    "exact_tw32": dict(w=256, h=96, tile_w=32, mpt=None),
    "exact_tw128": dict(w=256, h=96, tile_w=128, mpt=None),
    "lod_tw128": dict(w=256, h=96, tile_w=128, mpt=128),
    "lod_tw32_232x80": dict(w=232, h=80, tile_w=32, mpt=64),
}


def _both(case, budget_np=None):
    """(JAX image, JAX stats, port image, port stats) as numpy."""
    c = CASES[case]
    view, proj = _camera(c["w"], c["h"])
    kw = dict(tile_w=c["tile_w"], max_splats_per_tile=c["mpt"],
              return_stats=True)
    jimg, jst = jgs.render_gaussians(
        JCLOUD, view, proj, c["w"], c["h"], BG, interpret=True,
        lod_budget=None if budget_np is None else budget_np, **kw)
    timg, tst = gs.render_gaussians(
        CLOUD, np.asarray(view), np.asarray(proj), c["w"], c["h"], BG,
        lod_budget=(None if budget_np is None
                    else torch.from_numpy(np.array(budget_np))), **kw)
    return (np.asarray(jimg), {k: np.asarray(jst[k]) for k in STATS},
            timg.numpy(), {k: tst[k].numpy() for k in STATS})


@pytest.fixture(scope="module", params=list(CASES))
def rendered(request):
    return request.param, _both(request.param)


def _assert_same(jimg, jst, timg, tst):
    assert timg.shape == jimg.shape and np.isfinite(timg).all()
    err = np.abs(timg - jimg)
    assert err.max() <= 2e-3, err.max()
    for k in STATS:
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)


def test_render_matches_jax(rendered):
    case, (jimg, jst, timg, tst) = rendered
    c = CASES[case]
    assert timg.shape == (c["h"], c["w"], 3)
    _assert_same(jimg, jst, timg, tst)
    if c["mpt"] is None:
        assert int(jst["overflow_pairs"]) == 0 and bool(jst["lossless"])
        if c["tile_w"] == 32:
            # the blanket covers whole 32-wide tiles: they saturate inside
            # their lists
            assert ((jst["tile_exec"] < jst["tile_kept"])
                    & (jst["tile_kept"] > 0)).any()
    else:
        # the LOD pool binds
        assert int(jst["overflow_pairs"]) > 0


def test_temporal_budget_loop_matches_jax():
    # fog production shape: two-channel budgets, dry_floor="jump", each
    # frame's budget from the previous frame's stats, on both sides
    c = CASES["lod_tw32_232x80"]
    mpt = c["mpt"]
    ntx, nty = gs.num_tiles(c["w"], c["h"], c["tile_w"])
    budget = np.stack([np.full(ntx * nty, mpt, np.int32),
                       np.zeros(ntx * nty, np.int32)], -1)
    tbudget = torch.from_numpy(budget)
    for frame in range(3):
        jimg, jst, timg, tst = _both("lod_tw32_232x80", budget)
        _assert_same(jimg, jst, timg, tst)
        assert int(jst["overflow_pairs"]) > 0
        budget = np.asarray(jgs.update_lod_budget(
            jst["tile_exec"], mpt, ntx, nty, jst["tile_kept"],
            jst["tile_count"], dry_floor="jump"))
        tbudget = gs.update_lod_budget(
            torch.from_numpy(tst["tile_exec"]), mpt, ntx, nty,
            torch.from_numpy(tst["tile_kept"]),
            torch.from_numpy(tst["tile_count"]), dry_floor="jump")
        np.testing.assert_array_equal(tbudget.numpy(), budget,
                                      err_msg=f"frame {frame}")


@pytest.mark.parametrize("dry_floor", ["jump", "static", None])
def test_update_lod_budget_matches_jax(dry_floor):
    rng = np.random.RandomState(3)
    ntx, nty, mpt = 7, 5, 176
    count = rng.randint(0, 8000, ntx * nty).astype(np.int32)
    kept = np.minimum(count, rng.randint(0, 900, ntx * nty)).astype(np.int32)
    texec = np.where(rng.rand(ntx * nty) < 0.5, kept,
                     kept // 2).astype(np.int32)
    if dry_floor is None:
        want = jgs.update_lod_budget(texec, mpt, ntx, nty)
        got = gs.update_lod_budget(torch.from_numpy(texec), mpt, ntx, nty)
    else:
        want = jgs.update_lod_budget(texec, mpt, ntx, nty, kept, count,
                                     dry_floor=dry_floor)
        got = gs.update_lod_budget(
            torch.from_numpy(texec), mpt, ntx, nty, torch.from_numpy(kept),
            torch.from_numpy(count), dry_floor=dry_floor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mpt", [None, 64])
def test_bit_identical_knobs_do_not_change_output(mpt):
    view, proj = (np.asarray(m) for m in _camera(256, 96))
    kw = dict(tile_w=32, max_splats_per_tile=mpt)
    base = gs.render_gaussians(CLOUD, view, proj, 256, 96, **kw)
    for extra in (dict(payload_sort=False), dict(exact_seg=1),
                  dict(exact_seg=2), dict(lod_seg=4), dict(interpret=True)):
        img = gs.render_gaussians(CLOUD, view, proj, 256, 96, **kw, **extra)
        torch.testing.assert_close(img, base, rtol=0, atol=0,
                                   msg=str(extra))


@pytest.mark.parametrize("kw", [dict(max_splats_per_tile=2048, lod_tail=True)])
def test_unported_knobs_raise(kw):
    """No knob is left unported: ``lod_tail`` (the last one) renders. This
    pool holds every pair of every tile, so the slab is empty and the frame
    is bit-equal to the frame without it; a pool that drops pairs changes
    the frame (tests/test_torch_lod_tail.py holds the slab itself to JAX)."""
    view, proj = (np.asarray(m) for m in _camera(256, 96))
    img, st = gs.render_gaussians(CLOUD, view, proj, 256, 96,
                                  return_stats=True, **kw)
    assert img.shape == (96, 256, 3) and bool(torch.isfinite(img).all())
    assert int(st["overflow_pairs"]) == 0
    base = gs.render_gaussians(CLOUD, view, proj, 256, 96,
                               **{**kw, "lod_tail": False})
    assert torch.equal(img, base)
    small = {**kw, "max_splats_per_tile": 128}
    img, st = gs.render_gaussians(CLOUD, view, proj, 256, 96,
                                  return_stats=True, **small)
    assert int(st["overflow_pairs"]) > 0
    assert bool(torch.isfinite(img).all())
    assert not torch.equal(img, gs.render_gaussians(
        CLOUD, view, proj, 256, 96, **{**small, "lod_tail": False}))


# the side-channel and decimated-tail knobs map onto _bin_splats's names
_BIN_KW = dict(big_splat_cap="big_cap", mid_splat_cap="mid_cap",
               mid_lo_splat_cap="mid_lo_cap", corner_cap="corner_cap",
               max_splats_per_tile="max_per_tile",
               lod_tail_decim="tail_decim")
_jax_bin = jax.jit(jgs._bin_splats, static_argnums=(5, 6, 7),
                   static_argnames=tuple(_BIN_KW.values()))


@pytest.mark.parametrize("kw", [
    dict(big_splat_cap=16), dict(big_splat_cap=16, mid_splat_cap=16),
    dict(big_splat_cap=16, mid_splat_cap=16, mid_lo_splat_cap=16),
    dict(corner_cap=64), dict(max_splats_per_tile=128, lod_tail_decim=256)])
def test_ported_knobs_match_jax(kw):
    # accepted by the port's render_gaussians, whose integer stats equal
    # JAX's binning of the same projected splats under the same knobs
    view, proj = (np.asarray(m) for m in _camera(256, 96))
    img, st = gs.render_gaussians(CLOUD, view, proj, 256, 96, BG,
                                  return_stats=True, **kw)
    assert img.shape == (96, 256, 3) and bool(torch.isfinite(img).all())
    ps = gs.project_gaussians(
        CLOUD.means, CLOUD.scales, CLOUD.quats, CLOUD.opacities, CLOUD.colors,
        torch.from_numpy(np.array(view)), torch.from_numpy(np.array(proj)),
        256, 96, max_radius=(gs.level2_max_radius() if "big_splat_cap" in kw
                    else None))
    j = [jnp.asarray(np.ascontiguousarray(a.numpy())) for a in (
        ps.mean2d[:, 0], ps.mean2d[:, 1], ps.radius, torch.isfinite(ps.depth),
        ps.depth, ps.ext)]
    ntx, nty = gs.num_tiles(256, 96)
    *_, overflow, overflow_big, _, (kept, count), _ = _jax_bin(
        *j[:5], ntx, nty, 1 << 20, ext=j[5],
        **{_BIN_KW[k]: v for k, v in kw.items()})
    np.testing.assert_array_equal(st["tile_count"].numpy(), np.asarray(count))
    np.testing.assert_array_equal(st["tile_kept"].numpy(), np.asarray(kept))
    assert int(st["overflow_pairs"]) == int(overflow)
    assert int(st["overflow_big_splats"]) == int(overflow_big)


def test_sh_colors_raise_and_knob_errors_match_jax():
    # SH colours no longer raise: with cam_pos, a cloud with sh_rest renders
    # with the colours eval_sh_colors gives for that eye (the JAX order);
    # the knob errors still raise as in JAX
    view, proj = (np.asarray(m) for m in _camera(256, 96))
    n = CLOUD.num_splats
    rest = np.random.RandomState(3).randn(n, 3, 3).astype(np.float32) * 0.1
    sh = gaussians.cloud_from_numpy(dict(D, sh_rest=rest), device="cpu")
    eye = (0.0, 0.0, -3.0)
    img = gs.render_gaussians(sh, view, proj, 256, 96, cam_pos=eye)
    want = gs.render_gaussians(gaussians.cloud_from_numpy(
        dict(D, colors=gaussians.eval_sh_colors(sh, eye).numpy()),
        device="cpu"), view, proj, 256, 96)
    torch.testing.assert_close(img, want, rtol=0, atol=0)
    assert not torch.equal(img, gs.render_gaussians(sh, view, proj, 256, 96))
    for kw in (dict(mid_splat_cap=16), dict(lod_tail_decim=64)):
        with pytest.raises(ValueError):
            gs.render_gaussians(CLOUD, view, proj, 256, 96, **kw)


def test_signature_matches_jax():
    want = inspect.signature(jgs.render_gaussians).parameters
    got = inspect.signature(gs.render_gaussians).parameters
    assert list(got) == list(want)
    for k in want:
        assert got[k].default == want[k].default, k


def test_view_on_another_device_is_refused():
    view, proj = (torch.from_numpy(np.array(m)) for m in _camera(256, 96))
    with pytest.raises(ValueError):
        gs.render_gaussians(CLOUD, view.to("meta"), proj, 256, 96)
