"""Port vs JAX: the inria scene generators and the binning of the side
channels and the decimated tail (``shell_cloud``, ``inria_cloud``,
``_emit_pair``, ``_compact_channel(s)``, ``_bin_splats``).

Every comparison here is exact: the clouds are drawn from one numpy seed,
and the binning functions get the same projected inputs on both sides
(the port's plain projection, handed to JAX as numpy arrays), so counts,
grants, overflows and the packed splat ids must be equal. No JAX function
here runs a Pallas kernel.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_eater_tpu.models import gaussians as jgauss
from ray_eater_tpu.ops import gs as jgs
from ray_eater_tpu_torch.bench_knobs import flythrough_camera
from ray_eater_tpu_torch.models import gaussians
from ray_eater_tpu_torch.ops import gs

torch.set_num_threads(1)

FIELDS = ("means", "scales", "quats", "opacities", "colors")
W, H, TW = 256, 96, 64


@pytest.mark.parametrize("name,kw", [
    ("shell_cloud", dict(n=4000, seed=3)),
    ("shell_cloud", dict(n=777, seed=0, radius=1.3, scale_range=(0.01, 0.02))),
    ("inria_cloud", dict(n=5000, seed=1)),
    ("inria_cloud", dict(n=1234, seed=7))])
def test_clouds_bit_identical(name, kw):
    jc = getattr(jgauss, name)(**kw)
    c = getattr(gaussians, name)(**kw, device="cpu")
    assert c.num_splats == jc.num_splats == kw["n"]
    for f in FIELDS:
        got = getattr(c, f)
        assert got.dtype == torch.float32 and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jc, f)),
                                      err_msg=f)


@pytest.mark.parametrize("tile_w", [32, 64, 128])
def test_fan_constants_match_jax(tile_w):
    for name in ("_kx2", "level2_max_radius", "_kxm", "_kxml"):
        assert getattr(gs, name)(tile_w) == getattr(jgs, name)(tile_w), name
    for name in ("KX2", "KY2", "KY_M", "KY_ML", "_TAIL_D"):
        assert getattr(gs, name) == getattr(jgs, name), name
    # each fan's per-axis limits bound the JAX radius ceiling of that fan
    for kx, ky, want in (
            (gs.KX, 2, jgs.level1_max_radius(2, tile_w)),
            (gs.KX, 4, jgs.level1_max_radius(4, tile_w)),
            (gs._kxml(tile_w), gs.KY_ML, jgs.level_midlo_max_radius(tile_w)),
            (gs._kxm(tile_w), gs.KY_M, jgs.level_mid_max_radius(tile_w)),
            (gs._kx2(tile_w), gs.KY2, jgs.level2_max_radius(tile_w))):
        assert min(gs._fan_limits(kx, ky, tile_w)) == want, (kx, ky)


def test_emit_pair_matches_jax():
    rng = np.random.RandomState(2)
    n, ntx, nty, db = 3000, 5, 4, 20
    mx = (rng.rand(n) * 340 - 10).astype(np.float32)
    my = (rng.rand(n) * 140 - 10).astype(np.float32)
    rx = rng.randint(0, 32, n).astype(np.float32)
    ry = rng.randint(0, 16, n).astype(np.float32)
    valid = rng.rand(n) < 0.9
    qd = rng.randint(0, 1 << db, n).astype(np.int32)
    want = jgs._emit_pair(jnp.asarray(mx), jnp.asarray(my), jnp.asarray(rx),
                          jnp.asarray(ry), jnp.asarray(valid),
                          jnp.asarray(qd), ntx, nty, db, TW)
    got = gs._emit_pair(*(torch.from_numpy(a) for a in
                          (mx, my, rx, ry, valid, qd)), ntx, nty, db, TW)
    assert len(got) == len(want) == 2
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=f"slot {k}")


@pytest.mark.parametrize("caps", [(64, 128, 1200), (8, 1, 16),
                                  (300, 250, 260, 5), (1000,), (7,)])
def test_compact_channels_matches_jax(caps):
    rng = np.random.RandomState(len(caps) * 100 + caps[0])
    n = 1000
    lab = rng.randint(0, len(caps) + 1, n)      # channels + "none"
    masks = [lab == c for c in range(len(caps))]
    want = jgs._compact_channels([jnp.asarray(m) for m in masks], list(caps))
    got = gs._compact_channels([torch.from_numpy(m) for m in masks],
                               list(caps))
    for c, ((gn, gi, gv), (wn, wi, wv)) in enumerate(zip(got, want)):
        assert int(gn) == int(wn) == masks[c].sum(), c
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv), str(c))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), str(c))
        # the valid slots are the channel's first members, ascending
        idx = gi.numpy()[gv.numpy()]
        np.testing.assert_array_equal(idx, np.flatnonzero(masks[c])[:caps[c]])


# ---------------------------------------------------------------------------
# _bin_splats on both sides, one projected inria frame
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def projected():
    """The port's plain projection of a small inria frame at the coarse
    fan's radius ceiling, as torch tensors and as JAX arrays. The floaters
    (the last tenth of the cloud) are grown 4x so that every side channel
    holds splats at this small size."""
    c = gaussians.inria_cloud(3000, seed=1, device="cpu")
    d = {f: getattr(c, f).numpy().copy() for f in FIELDS}
    d["scales"][2700:] *= 4.0
    cloud = gaussians.cloud_from_numpy(d, device="cpu")
    view, proj = flythrough_camera(0.25, W, H, device="cpu")
    ps = gs.project_gaussians(cloud.means, cloud.scales, cloud.quats,
                              cloud.opacities, cloud.colors, view, proj,
                              W, H, max_radius=gs.level2_max_radius(TW))
    t = dict(mx=ps.mean2d[:, 0].contiguous(), my=ps.mean2d[:, 1].contiguous(),
             rad=ps.radius, valid=torch.isfinite(ps.depth), depth=ps.depth,
             ext=ps.ext.contiguous())
    j = {k: jnp.asarray(v.numpy()) for k, v in t.items()}
    return t, j


def _call(fn, a, ntx, nty, cap, kw):
    return fn(a["mx"], a["my"], a["rad"], a["valid"], a["depth"], ntx, nty,
              cap, ext=a["ext"], tile_w=TW, **kw)


# one XLA compile per configuration instead of an eager dispatch per op
_jax_bin = jax.jit(jgs._bin_splats, static_argnums=(5, 6, 7),
                   static_argnames=("tile_w", "max_per_tile", "big_cap",
                                    "mid_cap", "mid_lo_cap", "corner_cap",
                                    "tail_decim"))


def _live(begin, kept, length):
    """Mask of the packed rows [begin[t], begin[t] + kept[t]) of all tiles."""
    rows = np.arange(length)
    m = np.zeros(length, bool)
    for b, k in zip(begin, kept):
        m |= (rows >= b) & (rows < b + k)
    return m


def _channel_sizes(t):
    """Splats per channel of the frame (level-1 incl. corner, mid-lo, mid,
    coarse) and corner crossers, with the JAX routing rule."""
    rx, ry = t["ext"][:, 0].float(), t["ext"][:, 1].float()
    v = t["valid"]

    def fits(kx, ky):
        lx, ly = gs._fan_limits(kx, ky, TW)
        return (rx <= lx) & (ry <= ly)
    small = v & fits(gs.KX, gs.KY)
    lo = v & ~small & fits(gs._kxml(TW), gs.KY_ML)
    mid = v & ~small & ~lo & fits(gs._kxm(TW), gs.KY_M)
    big = v & ~small & ~lo & ~mid
    ntx, nty = gs.num_tiles(W, H, TW)
    tx0, tx1, ty0, ty1 = gs._tile_span(t["mx"], t["my"], rx, ry, ntx, nty, TW)
    corner = small & (tx1 > tx0) & (ty1 > ty0)
    return {k: int(m.sum()) for k, m in
            dict(small=small, lo=lo, mid=mid, big=big, corner=corner).items()}


CHANNEL_CAPS = dict(big_cap=3, mid_cap=6, mid_lo_cap=12, corner_cap=20)


@pytest.mark.parametrize("mode", ["exact", "exact_capped", "lod_tail",
                                  "lod_tail_roomy"])
def test_bin_splats_matches_jax(projected, mode):
    t, j = projected
    ntx, nty = gs.num_tiles(W, H, TW)
    sizes = _channel_sizes(t)
    # every channel holds more splats than its budget: all of them overflow
    assert all(sizes[k] > CHANNEL_CAPS[c] for k, c in (
        ("big", "big_cap"), ("mid", "mid_cap"), ("lo", "mid_lo_cap"),
        ("corner", "corner_cap"))), sizes
    kw = dict(CHANNEL_CAPS)
    cap = 1 << 20
    if mode == "exact_capped":
        cap = 2000                    # the positional pair cap binds
    if mode.startswith("lod"):
        kw.update(max_per_tile=32, tail_decim=64)
        if mode == "lod_tail_roomy":
            kw.update(max_per_tile=128, tail_decim=768, big_cap=1000,
                      mid_cap=1000, mid_lo_cap=1000, corner_cap=1000)
    b = _call(gs._bin_splats, t, ntx, nty, cap, kw)
    (pack, _, visited, overflow, overflow_big, _, (kept, count),
     tail) = _call(_jax_bin, j, ntx, nty, cap, kw)
    np.testing.assert_array_equal(b.count.numpy(), np.asarray(count))
    np.testing.assert_array_equal(b.kept.numpy(), np.asarray(kept))
    np.testing.assert_array_equal(b.visited.numpy(), np.asarray(visited))
    assert int(b.overflow) == int(overflow)
    assert int(b.overflow_big) == int(overflow_big)
    if mode == "lod_tail_roomy":
        assert int(overflow_big) == 0
    else:
        assert int(overflow_big) > 0
    kept_np = b.kept.numpy()
    live = _live(b.row_begin.numpy(), kept_np, len(b.pack_idx))
    np.testing.assert_array_equal(b.pack_idx.numpy()[live],
                                  np.asarray(pack)[:len(live)][live])
    if mode == "exact":
        # no cap binds: every pair is live. No two pairs of a tile share a
        # sort key, so the unstable (JAX) and stable (port) sorts agree.
        assert int(overflow) == 0 and (kept_np == b.count.numpy()).all()
        tile_bits = max((ntx * nty).bit_length(), 1)
        qd = gs._quantize_depth(t["depth"], t["valid"],
                                min(31 - tile_bits, 22)).numpy()
        ids = b.pack_idx.numpy()
        for tb, k in zip(b.row_begin.numpy(), kept_np):
            tq = qd[ids[tb:tb + k]]
            assert len(np.unique(tq)) == k
    elif mode == "exact_capped":
        assert int(overflow) > 0
    if mode.startswith("lod"):
        pack_tl, _, kept_tl = tail
        np.testing.assert_array_equal(b.kept_tl.numpy(), np.asarray(kept_tl))
        live_tl = _live(b.row_begin_tl.numpy(), b.kept_tl.numpy(),
                        len(b.pack_idx_tl))
        assert live_tl.sum() == int(b.kept_tl.sum()) > 0
        want_tl = np.asarray(pack_tl)[:len(live_tl)]
        np.testing.assert_array_equal(b.pack_idx_tl.numpy()[live_tl],
                                      want_tl[live_tl])
        np.testing.assert_array_equal(
            (b.row_end_tl - b.row_begin_tl).numpy(), b.kept_tl.numpy())
        rem = (b.count - b.kept - b.kept_tl).numpy()
        assert (rem >= 0).all() and int(b.overflow) == rem.sum()
        if mode == "lod_tail":
            # both pools bind: pairs are left behind the head and the tail
            assert ((b.kept < b.count).numpy()).any() and rem.sum() > 0
        else:
            assert rem.sum() == 0
