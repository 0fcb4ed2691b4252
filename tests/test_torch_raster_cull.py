"""The per-footprint cull of K6 and K7 (``csrc/raster.cu``) through its
plain twin ``raster._fold_culled``, on the CPU.

The kernels skip a (row, warp footprint) pair only when ``misses``
proves that their own float evaluation covers no pixel of the footprint,
and under LESS_EQUAL they give a pixel whose key is still inf the last
live row. ``_fold_culled`` applies the same test with the same footprints and
the same widening E, and the same repair. Held here bit-equal (every
output plane, ``torch.equal``) to the unculled fold ``_fold_plain`` in
all four modes, on:

- the two_planes and multipass setups, and the 288-triangle grid's pack,
  built by the port alone (``raster_scenes``), with the incoming depth
  padded by +inf rows as ``_raster_call`` pads it;
- a hand-made frame (``raster_scenes.cull_probe``): a sliver (|area2|
  ~1.2e-3 at x ~700) whose float planes cover pixels outside its bbox,
  in warp footprints the bbox does not reach, a triangle with a vertex exactly
  on a pixel centre, and a large triangle behind both;
- an incoming depth with +inf rows inside the frame under LESS_EQUAL.

No JAX reference: ``tests/test_torch_raster.py`` holds ``_fold_plain``
to the Pallas kernels.
"""

import pytest
import torch

from ray_eater_tpu_torch import raster_scenes as rs
from ray_eater_tpu_torch.ops import raster

torch.set_num_threads(1)

# (depth_test, last_wins, less_equal, static_test): LESS, LESS_EQUAL,
# last-wins, the static test
MODES = [(True, False, False, False), (True, False, True, False),
         (False, True, False, False), (True, True, False, True)]
INF = float("inf")


def _assert_equal(culled, plain):
    for a, b in zip(culled, plain):
        assert torch.equal(a, b)


def _draw(name, w, h, t=0.4):
    fb, ds = rs.draw_setup(rs.scene(name, "cpu", w, h), t)
    return ds, raster._pad_rows(fb.depth)


def _dense(setup, dinit, w, h, mode, ncols=None):
    n = setup.shape[1] if ncols is None else ncols
    args = (setup, dinit, n, float(w), float(h), raster._mode_bits(*mode))
    culled, skipped, pairs = raster._raster_dense_culled(*args)
    _assert_equal(culled, raster._raster_dense_plain(*args))
    return culled, int(skipped.sum()), int(pairs.sum())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", ["basic_planes", "multipass"])
def test_dense_cull_is_exact(name, mode):
    ds, dinit = _draw(name, 300, 170)
    n = raster._fold_bound(ds.inv_w.shape[0], ds.setup.shape[1])
    (_, ids, _, _), skipped, pairs = _dense(ds.setup, dinit, 300, 170, mode,
                                            n)
    assert int((ids[:170, :300] >= 0).sum()) > 0
    assert 0 < skipped < pairs


@pytest.mark.parametrize("mode", MODES)
def test_binned_cull_is_exact_and_skips_most_grid_pairs(mode):
    w, h = rs.EXTENTS["grid288"]
    ds, dinit = _draw("grid288", w, h)
    hp, wp = dinit.shape
    ntx, nty = wp // raster.TILE_W, hp // raster.TILE_H
    b = raster._bin_triangles(ds.setup, ntx, nty)
    args = (b.pack, b.row_begin, b.row_end, dinit, float(w), float(h),
            raster._mode_bits(*mode))
    culled, skipped, pairs = raster._raster_binned_culled(*args)
    plain = raster._raster_binned_plain(*args)
    vis = raster._tile_mask(b.visited, ntx, nty)
    _assert_equal([a[vis] for a in culled], [a[vis] for a in plain])
    assert int(skipped.sum()) > int(pairs.sum()) / 2
    assert not bool(pairs[~b.visited].any())


# ---- a hand-made frame: sliver, vertex on a pixel centre ------------------

W, H = rs.PROBE_EXTENT


def _covered(col):
    """The float coverage test of setup column ``col`` at every pixel
    centre of the (H, W) frame, as the fold evaluates it."""
    py, px = torch.meshgrid(torch.arange(H, dtype=torch.float32) + 0.5,
                            torch.arange(W, dtype=torch.float32) + 0.5,
                            indexing="ij")
    lam0 = col[raster._A0] * px + col[raster._B0] * py + col[raster._C0]
    lam1 = col[raster._A1] * px + col[raster._B1] * py + col[raster._C1]
    z = col[raster._AZ] * px + col[raster._BZ] * py + col[raster._CZ]
    return ((lam0 >= 0) & (lam1 >= 0) & (lam0 + lam1 <= 1) & (z >= 0)
            & (z <= 1)), px, py


def test_hand_made_frame_is_what_it_claims():
    s = rs.cull_probe("cpu")
    assert bool((s[raster._VALID, :3] > 0.5).all())
    sl = s[:, 0]
    xs, ys = s[raster._XMAX, 0] - s[raster._XMIN, 0], \
        s[raster._YMAX, 0] - s[raster._YMIN, 0]
    assert 5e-4 < float(xs * ys) < 2e-3   # |area2|: apex above the base
    cov, px, py = _covered(sl)
    outside = cov & ((px < sl[raster._XMIN]) | (px > sl[raster._XMAX])
                     | (py < sl[raster._YMIN]) | (py > sl[raster._YMAX]))
    assert int(outside.sum()) > 0                # the bbox proves nothing
    # ... even in warp footprints that the bbox does not reach: a bbox
    # cull would lose these pixels
    fx0 = (px // raster._FOOT_W) * raster._FOOT_W + 0.5
    fy0 = (py // raster._FOOT_H) * raster._FOOT_H + 0.5
    apart = ((fx0 + raster._FOOT_W - 1 < sl[raster._XMIN])
             | (fx0 > sl[raster._XMAX])
             | (fy0 + raster._FOOT_H - 1 < sl[raster._YMIN])
             | (fy0 > sl[raster._YMAX]))
    assert int((cov & apart).sum()) > 0
    assert float(s[raster._XMIN, 1]) == 300.5    # the vertex on a centre
    assert float(s[raster._YMIN, 1]) == 12.75


def test_sliver_is_never_skipped_where_it_covers():
    s = rs.cull_probe("cpu")
    cov, px, py = _covered(s[:, 0])
    ys, xs = torch.nonzero(cov, as_tuple=True)
    fx0 = (xs // raster._FOOT_W * raster._FOOT_W).float() + 0.5
    fy0 = (ys // raster._FOOT_H * raster._FOOT_H).float() + 0.5
    tx0 = (xs // raster.TILE_W * raster.TILE_W).float() + 0.5
    ty0 = (ys // raster.TILE_H * raster.TILE_H).float() + 0.5
    q = s[:, 0][None].expand(len(xs), 16)
    assert not bool(raster._plane_misses(
        q, fx0, fx0 + raster._FOOT_W - 1, fy0, fy0 + raster._FOOT_H - 1).any())
    assert not bool(raster._plane_misses(
        q, tx0, tx0 + raster.TILE_W - 1, ty0, ty0 + raster.TILE_H - 1).any())


@pytest.mark.parametrize("mode", MODES)
def test_hand_made_frame_cull_is_exact(mode):
    s = rs.cull_probe("cpu")
    dinit = torch.full((H, W), 1.0)
    dinit[:, ::3] = 0.5
    (_, ids, _, _), skipped, pairs = _dense(s, dinit, W, H, mode, 8)
    won = set(torch.unique(ids).tolist())
    assert {0, 1, 2} <= won
    assert 0 < skipped < pairs


def test_inf_depth_rows_under_less_equal():
    ds, dinit = _draw("multipass", 300, 170)
    dinit[40:48] = INF
    dinit[100:101, 17:250] = INF
    mode = (True, False, True, False)
    (key, ids, l0, _), skipped, _ = _dense(ds.setup, dinit, 300, 170, mode,
                                           64)
    last = int(torch.nonzero(ds.setup[raster._VALID, :64] > 0.5).max())
    taken = torch.isinf(key) & (ids == last)
    # rows the last live column does not cover took it all the same, with
    # its λ evaluated at the pixel
    assert int(taken[40:48].sum()) > 0 and int(taken[170:].sum()) > 0
    assert bool((l0[taken] != 0).any())
    assert skipped > 0
