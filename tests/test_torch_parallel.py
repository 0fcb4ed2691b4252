"""Port vs JAX and vs the port's single-device paths: multi-device
rendering and training (``ray_eater_tpu_torch.parallel.sharded``,
``models.gs_training.make_train_step_dp``, ``gs_trainer --dp``) on
``torch.distributed`` with the gloo backend.

One module-scoped ``torch.multiprocessing.spawn`` of D = 4 ranks (each one
process on one thread, rendezvous through ``file://``) runs every case of
``tests/torch_parallel_cases.py`` once and hands rank 0's outputs back as
arrays; the cases render under a guard that raises on any host sync. The
JAX package computes two sharded references on 4 of its virtual CPU
devices (Pallas in interpret mode, under ``jax.jit``: an eager
``shard_map`` of the interpreted kernels takes minutes) while the ranks
run. The clouds are
``tests/test_parallel.py``'s (``random_cloud`` is bit-identical across the
packages), at 256x128.

Tolerances and why:
- The flagship LOD frame (``mpt`` 128, big cap 128, ``lod_tail``, tile_w
  32, stats) against JAX's ``render_gaussians_sharded`` at D = 4: the one
  case where per-band pools and the band-local slab make sharded differ
  from single-device. Max 1e-5 (the single-device ``lod_tail`` frame
  matches JAX within 6e-6: ``exp``/``rsqrt`` may differ by an ulp), and
  ``tile_exec``, ``tile_kept``, ``tile_count`` and the overflow counts
  equal (integer decisions on identically rounded inputs).
- The dense sharded raster (two planes) against JAX's
  ``render_mesh_sharded``: within 2e-5 except on at most 0.5% of the
  pixels (knife edges: XLA contracts ``c + b·y0``, the jitted setup and
  the interpreted fold's ``a·px + b·py`` into FMAs, the port rounds each
  operation).
- Everything else against the port's single-device path on the same
  inputs: exact frames max 1e-5 for all_gather (the same pairs composite
  in the same order; JAX measured 2.7e-6 for its own), 1e-4 for the ring
  and the sort-last fold (a different association of the same
  products); LOD frames mean 5e-3 (each band grants its own pool; JAX's
  own bound, ``tests/test_parallel.py:72``); the binned raster within
  2e-5 except on 0.5% of the pixels (the ``c + b·y0`` shift rounds once
  more than the frame-coordinate planes, which moves knife-edge winners);
  ``shade_fetch=False`` equal to K8's fetch; the data-parallel step's
  loss at rtol 1e-5 and means at atol 1e-6
  (``tests/test_gs_training.py:194-196``: band sums reassociate the
  mean).
"""

import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch_parallel_cases as pc  # noqa: E402
from ray_eater_tpu_torch import gs_trainer  # noqa: E402
from ray_eater_tpu_torch.core.resources import create_framebuffer  # noqa: E402
from ray_eater_tpu_torch.models import gs_training as tr  # noqa: E402
from ray_eater_tpu_torch.models.mesh import two_planes  # noqa: E402
from ray_eater_tpu_torch.ops import gs  # noqa: E402
from ray_eater_tpu_torch.ops import raster  # noqa: E402

torch.set_num_threads(1)

W, H = pc.W, pc.H
EDGE_TOL = 2e-5       # colour/depth outside knife-edge pixels
EDGE_SHARE = 0.005    # knife-edge pixels allowed, as a share of the frame


def _jax_flagship():
    from ray_eater_tpu import rmath as jm
    from ray_eater_tpu.models.gaussians import random_cloud
    from ray_eater_tpu.parallel.sharded import (make_device_mesh,
                                                render_gaussians_sharded)
    view = jm.look_at_zforward(jm.vec(0.0, 0.6, -2.5), jm.vec(0.0, 0.0, 0.0))
    proj = jm.perspective(jm.radians(60.0), W / H, 0.1, 30.0)
    cloud = random_cloud(1024, seed=7, extent=0.8, scale_range=(0.02, 0.06))
    mesh = make_device_mesh(pc.D)
    img, st = jax.jit(lambda c, v, p: render_gaussians_sharded(
        c, v, p, W, H, mesh, return_stats=True, interpret=True,
        **pc.FLAGSHIP))(cloud, view, proj)
    return np.asarray(img), {k: np.asarray(v) for k, v in st.items()}


def _jax_planes():
    import ray_eater_tpu as jre
    from ray_eater_tpu import rmath as jm
    from ray_eater_tpu.parallel.sharded import (make_device_mesh,
                                                render_mesh_sharded)
    geo = two_planes(device="cpu")
    jgeo = jre.mesh(geo.positions.numpy(), geo.indices.numpy(),
                    **{k: v.numpy() for k, v in geo.attributes.items()})
    uni = {"model": jm.rotate_y(jm.identity(), 0.4),
           "view": jm.look_at(jm.vec(2., 2., 2.), jm.vec(0., 0., 0.)),
           "projection": jm.perspective(jm.radians(45.0), W / H, 0.1, 30.0)}

    def frag(v, r):
        c = v["color"]
        return jnp.concatenate(
            [c, jnp.ones((*c.shape[:-1], 1), jnp.float32)], -1)
    pipe = jre.GraphicsPipeline(vertex_fn=jre.shaders.mvp_vertex,
                                fragment_fn=frag)
    mesh = make_device_mesh(pc.D)
    color, depth = jax.jit(lambda u: render_mesh_sharded(
        pipe, jgeo, u, {}, W, H, mesh, interpret=True))(uni)
    return np.asarray(color), np.asarray(depth)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Rank 0's outputs of every case, and the two JAX references (computed
    while the ranks run)."""
    d = tmp_path_factory.mktemp("parallel")
    ctx = mp.spawn(pc.worker, args=(f"file://{d / 'rdzv'}", str(d)),
                   nprocs=pc.D, join=False)
    try:
        jax_flag = _jax_flagship()
        jax_planes = _jax_planes()
    finally:
        try:
            while not ctx.join():
                pass
        except Exception:
            errs = sorted(d.glob("error*.txt"))
            raise RuntimeError("\n".join(e.read_text() for e in errs)
                               or "a rank failed")
    out = dict(np.load(d / "rank0.npz"))
    out["jax_flagship"], out["jax_flagship_stats"] = jax_flag
    out["jax_planes"] = jax_planes
    out["dir"] = d
    return out


def _single(cloud_key, bg=(0.0, 0.0, 0.0), **kw):
    view, proj = pc.camera()
    return gs.render_gaussians(pc.clouds()[cloud_key], view, proj, W, H, bg,
                               **kw).numpy()


def _edge_share(a, b):
    """Share of the pixels that differ by more than EDGE_TOL."""
    err = np.abs(a - b)
    return (err.reshape(*err.shape[:2], -1).max(-1) > EDGE_TOL).mean()


# ---- row bands: JAX's sharded flagship frame ------------------------------

def test_flagship_matches_jax_sharded(run):
    jimg, jst = run["jax_flagship"], run["jax_flagship_stats"]
    assert run["flagship"].shape == jimg.shape == (H, W, 3)
    err = np.abs(run["flagship"] - jimg)
    assert err.max() <= 1e-5, err.max()
    for k in ("tile_exec", "tile_kept", "tile_count", "overflow_pairs",
              "overflow_big_splats", "lossless"):
        np.testing.assert_array_equal(run[f"flagship.{k}"], jst[k], k)


def test_flagship_budget_round_trip(run):
    """Full-grid telemetry → full-grid budget → the next sharded frame,
    under JAX's bound against the single-device frame."""
    single = _single("c1024", **pc.FLAGSHIP)
    ntx, nty = gs.num_tiles(W, H, tile_w=32)
    assert run["flagship.tile_exec"].shape == (ntx * nty,)
    assert run["flagship_budget"].shape == (ntx * nty, 2)
    for key in ("flagship", "flagship2"):
        assert np.isfinite(run[key]).all()
        err = np.abs(run[key] - single).mean()
        assert err < 5e-3, (key, err)


# ---- row bands: held to the port's single-device frame --------------------

def test_all_gather_exact_matches_single(run):
    single = _single("c512", (0.1, 0.1, 0.1))
    err = np.abs(run["ag_exact"] - single)
    assert err.max() <= 1e-5, err.max()


def test_ring_matches_all_gather(run):
    err = np.abs(run["ring"] - run["ag_exact"])
    assert err.max() <= 1e-4, err.max()
    assert int(run["ring.overflow_big_splats"]) == 0
    assert bool(run["ring.lossless"])


def test_ring_starved_budget_counts_drops(run):
    assert int(run["ring16.overflow_big_splats"]) > 0
    assert not bool(run["ring16.lossless"])


def test_midfan_exact_certified_matches_single(run):
    view, proj = pc.camera()
    single, st = gs.render_gaussians(pc.clouds()["wide"], view, proj, W, H,
                                     return_stats=True, **pc.CAPS)
    assert int(st["overflow_big_splats"]) == 0 and bool(st["lossless"])
    assert int(run["mid_exact.overflow_big_splats"]) == 0
    assert bool(run["mid_exact.lossless"])
    err = np.abs(run["mid_exact"] - single.numpy())
    assert err.max() <= 1e-4, err.max()


def test_midfan_lod_budget_round_trip(run):
    single = _single("wide", max_splats_per_tile=128, **pc.CAPS)
    for key in ("mid_lod", "mid_lod2"):
        err = np.abs(run[key] - single).mean()
        assert err < 5e-3, (key, err)


@pytest.mark.parametrize("tail_d", [2, 4])
def test_tail_decim_matches_single(run, tail_d):
    single = _single("wide", max_splats_per_tile=64, lod_tail_decim=128,
                     lod_tail_d=tail_d, **pc.CAPS)
    err = np.abs(run[f"tail{tail_d}"] - single).mean()
    assert err < 5e-3, err
    assert int(run[f"tail{tail_d}.overflow_pairs"]) >= 0


def test_exchanges_keep_the_frames_tie_order(run):
    """Two splats of one depth key over the same pixels, from shards 0
    and 2, in band 2: the ring and the sort-last slices composite them
    in the frame's splat order, as one device does (JAX's ring order
    would put shard 2 first on that band's rank)."""
    view, proj = pc.camera()
    tied = pc.tied_cloud()
    assert 64 <= pc.tied_splat_row() < 96
    single = gs.render_gaussians(tied, view, proj, W, H).numpy()
    swapped = pc.tied_cloud()
    swapped.colors[[10, 300]] = swapped.colors[[300, 10]]
    other = gs.render_gaussians(swapped, view, proj, W, H).numpy()
    assert np.abs(other - single).max() > 0.1     # the order shows
    assert np.abs(run["tied_ring"] - single).max() <= 1e-5
    assert np.abs(run["tied_sliced"] - single).max() <= 1e-4


def test_rejects_indivisible(run):
    assert "not divisible by mesh size 4" in str(run["reject"])


# ---- sort-last ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["sliced", "sliced_big"])
def test_depth_sliced_matches_exact(run, case):
    if case == "sliced":
        single = _single("c512", (0.1, 0.2, 0.3))
        assert int(run["sliced.overflow_big_splats"]) == 0
        assert bool(run["sliced.lossless"])
    else:
        single = _single("big", big_splat_cap=256)
    err = np.abs(run[case] - single)
    assert err.max() <= 1e-4, err.max()


def test_slice_keys_are_the_frames():
    """A slice's depth keys over the frame's range (``depth_range``) equal
    the frame's keys for those splats, so tied keys keep the frame's
    order; over the slice's own range they do not."""
    rng = np.random.RandomState(0)
    depth = torch.from_numpy(rng.rand(1000).astype(np.float32) * 3 + 1)
    valid = torch.from_numpy(rng.rand(1000) > 0.1)
    frame = gs._quantize_depth(depth, valid, 22)
    rng_ = (depth[valid].min(), depth[valid].max())
    part = slice(250, 500)
    sub = gs._quantize_depth(depth[part], valid[part], 22, rng_)
    assert torch.equal(sub, frame[part])
    own = gs._quantize_depth(depth[part], valid[part], 22)
    assert not torch.equal(own, frame[part])


def test_depth_sliced_starved_budget_counts_drops(run):
    assert int(run["sliced16.overflow_big_splats"]) > 0
    assert not bool(run["sliced16.lossless"])


# ---- the seam with ops/gs.py ---------------------------------------------------

#: the frame spine of ``ops/gs.py`` and the record columns that the packet
#: and the band shift read: the only private names of ``ops.gs`` that
#: ``parallel/sharded.py`` may use
SPINE = {"_frame_knobs", "_project_records", "_budget_on", "_bin_pack",
         "_composite_frame", "_frame_stats", "_ROWS", "_MX", "_MY"}


def test_sharded_uses_only_the_frame_spine():
    """The row-band and depth-sliced renders build on the frame spine of
    ``ops/gs.py`` and copy none of it: the source names no private name of
    ``ops.gs`` outside ``SPINE``."""
    path = (Path(__file__).resolve().parents[1] / "ray_eater_tpu_torch"
            / "parallel" / "sharded.py")
    tree = ast.parse(path.read_text())
    imports = [n for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    alias = {a.asname or a.name for n in imports if n.module == "ops"
             for a in n.names if a.name == "gs"}
    assert alias == {"gs_ops"}
    assert not [a.name for n in imports if n.module == "ops.gs"
                for a in n.names if a.name.startswith("_")]
    used = {n.attr for n in ast.walk(tree)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
            and n.value.id == "gs_ops" and n.attr.startswith("_")}
    assert used and used <= SPINE, sorted(used - SPINE)


# ---- D = 2: a one-hop ring --------------------------------------------------

@pytest.mark.parametrize("case", ["d2_ring", "d2_sliced"])
def test_two_devices_match_single(run, case):
    single = _single("c512", (0.1, 0.1, 0.1) if case == "d2_ring"
                     else (0.1, 0.2, 0.3))
    err = np.abs(run[case] - single)
    assert err.max() <= 1e-4, err.max()
    if case == "d2_ring":
        assert bool(run["d2_ring.lossless"])


# ---- raster ------------------------------------------------------------------

def _single_mesh(geo, shade_fetch=True, double_sided=True):
    fb = raster.render_mesh(pc.mesh_pipeline(double_sided), geo,
                            pc.mesh_uniforms(), {},
                            create_framebuffer(W, H, device="cpu"),
                            shade_fetch=shade_fetch)
    return fb.color[:H, :W].numpy(), fb.depth[:H, :W].numpy()


def test_raster_dense_matches_jax_sharded(run):
    jc, jd = run["jax_planes"]
    for got, want in ((run["planes.color"], jc), (run["planes.depth"], jd)):
        assert got.shape == want.shape
        assert _edge_share(got, want) <= EDGE_SHARE
    sc, sd = _single_mesh(two_planes(device="cpu"), double_sided=False)
    assert _edge_share(run["planes.color"], sc) <= EDGE_SHARE
    assert _edge_share(run["planes.depth"], sd) <= EDGE_SHARE


def test_raster_binned_matches_single(run):
    """578 triangles (binned: K7, K8) in four bands; the bands bin in band
    coordinates, so they match the single-device frame (JAX's sharded
    binned path does not; ROADMAP queue 3)."""
    geo = pc.grid_mesh()
    assert 2 * geo.num_triangles > raster._BIN_MIN_TRIS
    sc, sd = _single_mesh(geo)
    assert (sd < 1.0).mean() > 0.1          # the grid covers 15% of it
    for got, want in ((run["grid.color"], sc), (run["grid.depth"], sd)):
        assert got.shape == want.shape
        assert _edge_share(got, want) <= EDGE_SHARE


def test_raster_shade_fetch_off_same_frame(run):
    np.testing.assert_array_equal(run["grid_gather.color"],
                                  run["grid.color"])
    np.testing.assert_array_equal(run["grid_gather.depth"],
                                  run["grid.depth"])
    sc, sd = _single_mesh(pc.grid_mesh())
    gc, gd = _single_mesh(pc.grid_mesh(), shade_fetch=False)
    np.testing.assert_array_equal(gc, sc)
    np.testing.assert_array_equal(gd, sd)


# ---- data-parallel training ---------------------------------------------------

def test_dp_train_step_matches_single_device(run):
    view, proj, init, target = pc.train_problem()
    params = tr.params_from_cloud(init)
    loss = tr.make_train_step(tr.adam(params, 1e-3), view, proj)(params,
                                                                 target)
    np.testing.assert_allclose(float(run["dp.loss"]), float(loss),
                               rtol=1e-5)
    np.testing.assert_allclose(run["dp.means"],
                               params.means.detach().numpy(), atol=1e-6)


def test_trainer_dp_matches_single_device(run):
    args = [a for a in pc.TRAINER_ARGS]
    r = gs_trainer.train(gs_trainer.parse_args(args))
    np.testing.assert_allclose(run["trainer_dp.losses"], r["losses"],
                               rtol=1e-5)
    assert (run["dir"] / "trainer_rank0" / "fitted.png").exists()
    assert (run["dir"] / "trainer_rank0" / "target.png").exists()
    assert not (run["dir"] / "trainer_rank1").exists()


def test_host_sync_guard_raises():
    x = torch.arange(4.0)
    with pytest.raises(pc.HostSync):
        with pc.NoHostSync():
            x.sum().item()
    with pytest.raises(pc.HostSync):
        with pc.NoHostSync():
            x[x > 1]
