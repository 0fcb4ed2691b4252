"""K1–K10 and the SH colour kernel on a CUDA device against their plain
PyTorch versions (each kernel's op checked against its fake
implementation), one training step through K4 and K5, raster frames
through K6–K9, the compute_drawing sample through K10 and K6, SH colours
through the gs_viewer entry point, and ``render_animation``'s CUDA-graph
replay against its eager loop (raster, fog with its budget carry and
compute_drawing frames equal u8 for u8; a frame step that copies a host
scalar to the device fails to capture and raises).

Marked ``gpu``: each test decides inside itself whether a CUDA device is
present and skips when there is none. Run on a GPU machine with
``python -m pytest tests/test_torch_gpu.py -m gpu --noconftest`` (the
suite's conftest imports JAX, which this file does not need).

K6 and K7 also run on the cull probe of ``raster_scenes`` (a sliver that
covers pixels outside its bbox, a vertex on a pixel centre) and on frames
whose incoming depth has +inf rows, in all four modes; K6 on the
basic_planes and compute_drawing draws; K7 against its culled twin
``raster._fold_culled`` (equal outputs; the kernel reports no skip count),
whose footprint is the one the kernels report.

K2 and K5 also run on a 3x2-tile layout built by hand at tile_w 32, 64
and 128: a list over three 128-row chunks from an unaligned row_begin, a
tile that saturates in its second chunk, tiles with no rows; K4 on the
same layout with that tile's blanket split so that the CTAs of its
cluster disagree after the first chunk.

Tolerances: K1 floats within rtol 1e-5 and integers equal on all but
1e-4 of the splats (off by at most 1); K2, K3 and K4 planes within 2e-3
max abs and 1e-5 mean abs (running product vs cumprod; K3 merges chunks
composited from T = 1), exec equal on ≥ 99.9% of tiles, K4's
checkpoints within 1e-6 (the same running product on both sides); K5
within 1e-4 × the plain version's largest |gradient| (reassociated sums,
global atomics in no fixed order); the SH colour kernel within 1e-6 of
its plain version on the card (the same float32 operations in the same
order, --fmad=false; the norm's three-term sum may round differently);
K6 and K7 winner ids equal and λ0/λ1/depth within 1e-6 where they agree
(the same operations in the same order, --fmad=false), K8 equal, K9
within 1e-6, K10 equal; SH colours on CUDA within 1e-6 of the CPU's (the
direction's norm and the products may round differently).
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_eater_tpu_torch.bench_knobs import (flythrough_camera, layout_kwargs,
                                             render_kwargs, resolve_knobs)
from ray_eater_tpu_torch.models.gaussians import inria_cloud, random_cloud
from ray_eater_tpu_torch.ops import gs

pytestmark = pytest.mark.gpu

W, H = 480, 270
NO_LAUNCHES = {"k1_project": 0, "k2_composite": 0, "k3_composite_tail": 0,
               "k4_composite_ckpt": 0, "k5_composite_bwd": 0, "k6_raster": 0,
               "k7_raster_binned": 0, "k8_shade_fetch": 0, "k9_subtile": 0,
               "k10_splat": 0, "sh_colors": 0}


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def scene():
    dev = _cuda()
    cloud = random_cloud(100_000, seed=1, extent=1.0,
                         scale_range=(0.004, 0.02), device=dev)
    return cloud, *flythrough_camera(0.3, W, H, device=dev)


def test_k1_matches_plain(scene):
    cloud, view, proj = scene
    scal = gs._project_scalars(view, proj, W, H, 0.05,
                               float(gs.level1_max_radius()))
    args = (cloud.means, cloud.scales, cloud.quats, cloud.opacities, scal)
    k, p = gs._project_k1(*args), gs._project_plain(*args)
    both = torch.isfinite(k[5]) & torch.isfinite(p[5])
    torch.testing.assert_close(k[:6][:, both], p[:6][:, both], rtol=1e-5,
                               atol=1e-6)
    idiff = (k[6:9] - p[6:9]).abs()
    assert float(idiff.max()) <= 1
    n = cloud.num_splats
    assert int(((idiff > 0).any(0) | (torch.isfinite(k[5])
                                      != torch.isfinite(p[5]))).sum()) \
        <= 1e-4 * n


# rows of each tile of the crafted 3x2-tile layout, and what the forward
# runs: tile 0's list spans three 128-row chunks from an unaligned
# row_begin; tile 1's saturates in its second chunk (an opaque blanket 130
# rows in), so it runs two of its three chunks; tile 3 runs a short list in
# one chunk; tiles 2, 4 and 5 have no rows
CRAFTED_SPANS = ((37, 337), (394, 694), (694, 694), (768, 773), (0, 0),
                 (0, 0))
CRAFTED_EXEC = [300, 246, 0, 5, 0, 0]
CRAFTED_CHUNKS = [3, 2, 0, 1, 0, 0]


def _crafted_layout(dev, tile_w, halves=False):
    """K2's arguments on a frame of 3x2 tiles built by hand from a seed:
    random small Gaussians (sigma 0.5-4 px, opacity 0.05-0.6) over each
    tile with rows, and in tile 1 eight rows of a wide blanket at opacity
    0.995 (alpha clamped at 0.99) that take every sample below T = 1e-4.
    With ``halves`` the blanket is three layers of one-pixel-high strips
    (conic c = 20: below 1/255 a row away) instead: over sample rows 0-15
    20 rows into tile 1's list (its first chunk), over rows 16-31 130 rows
    in (its second)."""
    ntx, nty = 3, 2
    rng = np.random.RandomState(tile_w)
    rec = np.zeros((800, 12), np.float32)
    for t, (b, e) in enumerate(CRAFTED_SPANS):
        n = e - b
        if n == 0:
            continue
        sig = rng.uniform(0.5, 4.0, (n, 2)) ** 2
        th = rng.uniform(0.0, np.pi, n)
        c, s = np.cos(th), np.sin(th)
        a = c * c * sig[:, 0] + s * s * sig[:, 1] + 0.3
        off = c * s * (sig[:, 0] - sig[:, 1])
        d = s * s * sig[:, 0] + c * c * sig[:, 1] + 0.3
        det = a * d - off * off
        rec[b:e, 0] = (t % ntx) * tile_w + rng.uniform(-4, tile_w + 4, n)
        rec[b:e, 1] = (t // ntx) * 32 + rng.uniform(-4, 36, n)
        rec[b:e, 2:5] = np.stack([d, -off, a], 1) / det[:, None]
        rec[b:e, 5] = rng.uniform(0.05, 0.6, n)
        rec[b:e, 6:9] = rng.rand(n, 3)
    b1 = CRAFTED_SPANS[1][0]
    if halves:
        for at, y0 in ((b1 + 20, 0), (b1 + 130, 16)):
            y = np.repeat(np.arange(y0, y0 + 16) + 0.5, 3)
            strips = rec[at:at + len(y)]
            strips[:, :6] = (1.5 * tile_w, 0.0, 1e-6, 0.0, 20.0, 0.995)
            strips[:, 1] = y
    else:
        rec[b1 + 130:b1 + 138, :6] = (1.5 * tile_w, 16.0, 1e-6, 0.0, 1e-6,
                                      0.995)
    span = torch.tensor(CRAFTED_SPANS, dtype=torch.int32, device=dev)
    return (torch.from_numpy(rec).to(dev), span[:, 0].contiguous(),
            span[:, 1].contiguous(), ntx, nty, tile_w)


def _k2_args(scene, layout, tile_w):
    if layout == "crafted":
        return _crafted_layout(scene[0].means.device, tile_w)
    cloud, view, proj = scene
    mpt = {"exact": None, "lod176": 176, "lod256": 256}[layout]
    lay = gs._frame_layout(cloud, view, proj, W, H, tile_w=tile_w,
                           max_splats_per_tile=mpt)
    b = lay.binned
    return lay.records, b.row_begin, b.row_end, lay.ntx, lay.nty, tile_w


@pytest.mark.parametrize("layout", ["exact", "lod176", "crafted"])
@pytest.mark.parametrize("tile_w", [32, 64, 128])
def test_k2_matches_plain(scene, layout, tile_w):
    args = _k2_args(scene, layout, tile_w)
    (pk, ek), (pp, ep) = gs._composite_call(*args), gs._composite_plain(*args)
    err = (pk - pp).abs()
    assert float(err.max()) <= 2e-3 and float(err.mean()) <= 1e-5
    assert float((ek == ep).float().mean()) >= 0.999
    if layout == "crafted":
        assert ep.tolist() == CRAFTED_EXEC and ek.tolist() == CRAFTED_EXEC
        # tiles without rows keep rgb 0 and T 1
        empty = torch.tensor([2, 4, 5], device=pk.device)
        assert bool((pk[:3, empty] == 0).all() & (pk[3, empty] == 1).all())
        assert float(pk[3, 1].max()) < 1e-4


def test_render_is_finite_and_counts_launches(scene):
    from ray_eater_tpu_torch.ops import _cuda
    cloud, view, proj = scene
    _cuda.reset_launches()
    img = gs.render_gaussians(cloud, view, proj, W, H, tile_w=32,
                              max_splats_per_tile=176)
    assert img.shape == (H, W, 3) and img.is_cuda
    assert bool(torch.isfinite(img).all())
    assert _cuda.launches == dict(NO_LAUNCHES, k1_project=1, k2_composite=1)
    assert np.isfinite(img.cpu().numpy()).all()


@pytest.fixture
def inria():
    dev = _cuda()
    n = 100_000
    cloud = inria_cloud(n, seed=1, device=dev)
    knobs = resolve_knobs("inria", n, env={})
    return cloud, knobs, *flythrough_camera(0.0, W, H, device=dev)


@pytest.mark.parametrize("decim", [1, 2, 4])
@pytest.mark.parametrize("tile_w", [32, 64, 128])
def test_k3_matches_plain(inria, tile_w, decim):
    cloud, knobs, view, proj = inria
    lay = gs._frame_layout(cloud, view, proj, W, H, **dict(layout_kwargs(
        knobs, False, W, H, cloud.means.device), tile_w=tile_w))
    b, tw = lay.binned, lay.tile_w
    head, _ = gs._composite_call(lay.records, b.row_begin, b.row_end,
                                 lay.ntx, lay.nty, tw)
    td = gs._tail_entry(head[3], b.visited, tw, decim)
    args = (lay.records_tl, b.row_begin_tl, b.row_end_tl, td, lay.ntx,
            lay.nty, tw, decim)
    assert int(b.kept_tl.sum()) > 0
    (pk, ek) = gs._composite_tail_call(*args)
    (pp, ep) = gs._composite_tail_plain(*args)
    err = (pk - pp).abs()
    assert float(err.max()) <= 2e-3 and float(err.mean()) <= 1e-5
    assert float((ek == ep).float().mean()) >= 0.999
    ctas, threads, resident = gs._composite_shape(3, tw, decim)
    assert ctas >= 2 and 32 <= threads <= 1024 and resident >= ctas


def test_k1_at_the_coarse_radius_ceiling(inria):
    cloud, knobs, view, proj = inria
    mr = gs.level2_max_radius(knobs["tile_w"])
    scal = gs._project_scalars(view, proj, W, H, 0.05, float(mr))
    args = (cloud.means, cloud.scales, cloud.quats, cloud.opacities, scal)
    k, p = gs._project_k1(*args), gs._project_plain(*args)
    assert int((k[6] >= mr).sum()) > 0          # some radii hit the clamp
    idiff = (k[6:9] - p[6:9]).abs()
    assert float(idiff.max()) <= 1
    assert int(((idiff > 0).any(0) | (torch.isfinite(k[5])
                                      != torch.isfinite(p[5]))).sum()) \
        <= 1e-4 * cloud.num_splats


@pytest.mark.parametrize("exact", [False, True])
def test_inria_render_counts_launches(inria, exact):
    from ray_eater_tpu_torch.ops import _cuda
    cloud, knobs, view, proj = inria
    kw = render_kwargs(knobs, exact=exact, interpret=False)
    _cuda.reset_launches()
    out = gs.render_gaussians(cloud, view, proj, W, H, **kw)
    img = out if exact else out[0]
    assert img.shape == (H, W, 3) and bool(torch.isfinite(img).all())
    assert _cuda.launches == dict(NO_LAUNCHES, k1_project=1, k2_composite=1,
                                  k3_composite_tail=0 if exact else 1)


def _assert_k4_matches_plain(args):
    """K4 vs its plain version on ``args``: planes within 2e-3 max and
    1e-5 mean abs, exec equal on ≥ 99.9% of tiles, the checkpoint rows of
    the chunks both ran within 1e-6 (T before a chunk: the same running
    product); returns K4's exec and the plain version's."""
    pk, ek, ck, off = gs._composite_call_ckpt(*args)
    pp, ep, cp, offp = gs._composite_ckpt_plain(*args)
    err = (pk - pp).abs()
    assert float(err.max()) <= 2e-3 and float(err.mean()) <= 1e-5
    assert float((ek == ep).float().mean()) >= 0.999
    assert torch.equal(off, offp)
    # the checkpoint rows of chunks both versions ran
    begin, _, first, _ = gs._chunk_spans(args[1], args[2], args[0].shape[0])
    nex = torch.minimum(gs._executed_chunks(begin, first, ek),
                        gs._executed_chunks(begin, first, ep))
    rows = torch.cat([off[t].long() + torch.arange(int(nex[t]),
                                                   device=off.device)
                      for t in torch.nonzero(nex).flatten().tolist()])
    assert rows.numel() > 0
    assert float((ck[rows] - cp[rows]).abs().max()) <= 1e-6
    cluster, threads, resident = gs._composite_shape(4, args[-1])
    assert (32 * args[-1]) % (cluster * threads) == 0
    assert resident >= cluster
    return ek, ep


@pytest.mark.parametrize("tile_w", [32, 64, 128])
def test_k4_matches_plain(scene, tile_w):
    _assert_k4_matches_plain(_k2_args(scene, "lod256", tile_w))


@pytest.mark.parametrize("tile_w", [32, 64, 128])
def test_k4_cluster_vote_stops_mid_list(tile_w):
    # tile 1 of the crafted layout with its blanket split in two: the top
    # 16 sample rows saturate in its first chunk, the bottom 16 in its
    # second. K4's CTAs that own only top rows vote to stop after the first
    # chunk and must run the second with the others; the tile stops there,
    # one chunk before its list ends
    args = _crafted_layout(_cuda(), tile_w, halves=True)
    ek, ep = _assert_k4_matches_plain(args)
    assert ep.tolist() == CRAFTED_EXEC and ek.tolist() == CRAFTED_EXEC
    begin, _, first, nch = gs._chunk_spans(args[1], args[2],
                                           args[0].shape[0])
    assert gs._executed_chunks(begin, first, ek).tolist() == CRAFTED_CHUNKS
    assert int(nch[1]) == 3
    _, _, ck, off = gs._composite_call_ckpt(*args)
    t1 = ck[int(off[1]) + 1].reshape(32, tile_w)   # T entering chunk 1
    assert float(t1[:16].max()) < 1e-4 and float(t1[16:].min()) > 1e-4


@pytest.mark.parametrize("layout", ["lod256", "crafted"])
@pytest.mark.parametrize("tile_w", [32, 64, 128])
def test_k5_matches_plain(scene, layout, tile_w):
    args = _k2_args(scene, layout, tile_w)
    planes, ex, ck, off = gs._composite_call_ckpt(*args)
    gen = torch.Generator(device=planes.device).manual_seed(0)
    d = torch.randn(planes.shape, generator=gen, device=planes.device)
    bwd = (args[0], args[1], args[2], ex, off, ck, planes, d, *args[3:])
    gk = gs._composite_bwd_call(*bwd)
    gp = gs._composite_bwd_plain(*bwd)
    scale = float(gp.abs().max())
    assert scale > 0 and bool(torch.isfinite(gk).all())
    assert float((gk - gp).abs().max()) <= 1e-4 * scale
    if layout == "crafted":
        # tile 1 ran two chunks beside tile 2 (exec 0); rows of chunks
        # that did not run, and of no tile, get no gradient
        assert ex.tolist() == CRAFTED_EXEC
        begin, _, first, _ = gs._chunk_spans(args[1], args[2],
                                             args[0].shape[0])
        assert gs._executed_chunks(begin, first, ex).tolist() \
            == CRAFTED_CHUNKS
        ran = torch.zeros(args[0].shape[0], dtype=torch.bool,
                          device=gk.device)
        for (b, _), n in zip(CRAFTED_SPANS, CRAFTED_EXEC):
            ran[b:b + n] = True
        assert bool((gk[~ran] == 0).all()) and bool((gk[ran] != 0).any(1)
                                                     .any())


def test_train_step_is_finite_and_counts_launches(scene):
    from ray_eater_tpu_torch.models import gs_training as tr
    from ray_eater_tpu_torch.ops import _cuda
    cloud, view, proj = scene
    params = tr.params_from_cloud(cloud)
    target = torch.full((H, W, 3), 0.2, device=cloud.means.device)
    step = tr.make_train_step_pallas(tr.adam(params, 5e-3), view, proj)
    _cuda.reset_launches()
    loss = step(params, target)
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    assert _cuda.launches["k4_composite_ckpt"] == 1
    assert _cuda.launches["k5_composite_bwd"] == 1
    for t in params.tensors():
        assert bool(torch.isfinite(t).all())


# ---- raster and sampling: K6-K9 ----------------------------------------------

RASTER_MODES = [(True, False, False, False), (True, False, True, False),
                (False, True, False, False), (True, True, False, True)]


def _raster_frame(dev, name="grid", w=W, h=H, t=0.4):
    """A frame's draw setup: the 288-triangle double-sided grid (binned),
    or the multipass quads (dense), with the mip-sampled checkerboard."""
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.core import resources as res
    from ray_eater_tpu_torch.ops import raster
    sc = rs.scene("grid288" if name == "grid" else "multipass", dev, w, h)
    pipe = sc.passes[-1][0]
    fb = res.create_framebuffer(w, h, device=dev)
    return raster._vertex_stage(pipe, sc.mesh, sc.uniforms(t), fb), pipe, fb


def _assert_fold_equal(k, p):
    """K6/K7 outputs against their plain version: every int plane (winner
    ids, K7's winner slots) equal, floats within 1e-6 where finite."""
    assert len(k) == len(p)
    for a, b in zip(k, p):
        if a.dtype == torch.int32:
            assert torch.equal(a, b)
        else:
            fin = torch.isfinite(b)
            assert torch.equal(torch.isfinite(a), fin)
            assert float((a - b)[fin].abs().max()) <= 1e-6


@pytest.mark.parametrize("mode", RASTER_MODES)
def test_k6_matches_plain(mode):
    from ray_eater_tpu_torch.ops import raster
    dev = _cuda()
    ds, _, fb = _raster_frame(dev, "multipass", 1920, 1080)
    dinit = torch.cat([fb.depth, torch.full((8, 1920), float("inf"),
                                            device=dev)])
    bits = raster._mode_bits(*mode)
    n = raster._fold_bound(ds.inv_w.shape[0], ds.setup.shape[1])
    k = raster._raster_dense_k6(ds.setup, dinit, n, 1920.0, 1080.0, bits)
    p = raster._raster_dense_plain(ds.setup, dinit, n, 1920.0, 1080.0, bits)
    assert int((k[1] >= 0).sum()) > 0
    _assert_fold_equal(k, p)


@pytest.mark.parametrize("mode", RASTER_MODES)
def test_k7_k8_match_plain(mode):
    from ray_eater_tpu_torch.ops import raster
    dev = _cuda()
    ds, _, fb = _raster_frame(dev)
    hp = 288
    dinit = torch.cat([fb.depth, torch.full((hp - fb.depth.shape[0],
                                             fb.depth.shape[1]),
                                            float("inf"), device=dev)])
    ft = raster._feature_table(ds.tri_vary, ds.inv_w)
    b = raster._bin_triangles(ds.setup, dinit.shape[1] // 128, hp // 32,
                              feat=ft)
    bits = raster._mode_bits(*mode)
    args = (b.pack, b.row_begin, b.row_end, dinit, float(W), float(H), bits)
    k = raster._raster_binned_k7(*args)
    p = raster._raster_binned_plain(*args)
    vis = raster._tile_mask(b.visited, dinit.shape[1] // 128, hp // 32)
    assert int((p[1][vis] >= 0).sum()) > 0
    _assert_fold_equal([a[vis] for a in k], [a[vis] for a in p])
    fk = raster._shade_fetch_k8(b.fpack, k[4], b.visited)
    fp = raster._shade_fetch_plain(b.fpack, k[4], b.visited)
    assert torch.equal(fk, fp)


def _assert_k6_k7_match_plain(setup, dinit, w, h, mode):
    """K6 over every setup column and K7 over the setup's binned pack,
    each against its plain version (K7 on its visited tiles)."""
    from ray_eater_tpu_torch.ops import raster
    bits = raster._mode_bits(*mode)
    args = (setup, dinit, setup.shape[1], float(w), float(h), bits)
    _assert_fold_equal(raster._raster_dense_k6(*args),
                       raster._raster_dense_plain(*args))
    hp, wp = dinit.shape
    ntx, nty = wp // 128, hp // 32
    b = raster._bin_triangles(setup, ntx, nty)
    args = (b.pack, b.row_begin, b.row_end, dinit, float(w), float(h), bits)
    vis = raster._tile_mask(b.visited, ntx, nty)
    _assert_fold_equal([a[vis] for a in raster._raster_binned_k7(*args)],
                       [a[vis] for a in raster._raster_binned_plain(*args)])


@pytest.mark.parametrize("mode", RASTER_MODES)
def test_k6_k7_match_plain_on_the_cull_probe(mode):
    """A sliver whose float planes cover pixels outside its bbox, a vertex
    on a pixel centre, and +inf rows in the incoming depth."""
    from ray_eater_tpu_torch import raster_scenes as rs
    dev = _cuda()
    w, h = rs.PROBE_EXTENT
    dinit = torch.ones((h, w), device=dev)
    dinit[:, ::3] = 0.5
    dinit[30:45] = float("inf")
    _assert_k6_k7_match_plain(rs.cull_probe(dev), dinit, w, h, mode)


@pytest.mark.parametrize("mode", RASTER_MODES)
def test_k6_k7_match_plain_with_inf_depth_rows(mode):
    from ray_eater_tpu_torch.ops import raster
    dev = _cuda()
    ds, _, fb = _raster_frame(dev)
    dinit = raster._pad_rows(fb.depth).clone()
    dinit[100:140] = float("inf")
    dinit[200, 50:400] = float("inf")
    _assert_k6_k7_match_plain(ds.setup, dinit, W, H, mode)


@pytest.mark.parametrize("mode", RASTER_MODES)
@pytest.mark.parametrize("name", ["basic_planes", "compute_drawing"])
def test_k6_matches_plain_on_sample_draws(name, mode):
    from ray_eater_tpu_torch import compute_drawing
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.core import resources as res
    from ray_eater_tpu_torch.ops import raster
    dev = _cuda()
    if name == "basic_planes":
        sc = rs.scene(name, dev)
        fb, ds = rs.draw_setup(sc, 0.5)
        w, h = sc.width, sc.height
    else:
        d = compute_drawing.setup(dev)
        w, h = d.width, d.height
        fb = res.create_framebuffer(w, h, device=dev)
        ds = raster._vertex_stage(d.pipeline, d.quad, {"time": 0.0}, fb)
    dinit = raster._pad_rows(fb.depth)
    n = raster._fold_bound(ds.inv_w.shape[0], ds.setup.shape[1])
    args = (ds.setup, dinit, n, float(w), float(h), raster._mode_bits(*mode))
    k = raster._raster_dense_k6(*args)
    assert int((k[1] >= 0).sum()) > 0
    _assert_fold_equal(k, raster._raster_dense_plain(*args))


def test_k7_matches_its_culled_twin():
    """K7 against ``_fold_culled`` (the plain fold without the pairs the
    kernel skips, plus its LESS_EQUAL repair) on the card's inputs; the
    kernel reports no skip count, so the twin's count is checked to be a
    real share of the pairs."""
    from ray_eater_tpu_torch.ops import raster
    dev = _cuda()
    ds, _, fb = _raster_frame(dev)
    dinit = raster._pad_rows(fb.depth)
    hp, wp = dinit.shape
    b = raster._bin_triangles(ds.setup, wp // 128, hp // 32)
    vis = raster._tile_mask(b.visited, wp // 128, hp // 32)
    for mode in RASTER_MODES:
        args = (b.pack, b.row_begin, b.row_end, dinit, float(W), float(H),
                raster._mode_bits(*mode))
        twin, skipped, pairs = raster._raster_binned_culled(
            *args, foot=raster._fold_shape(7, args[-1]).foot)
        assert 0 < int(skipped.sum()) < int(pairs.sum())
        for a, c in zip(raster._raster_binned_k7(*args), twin):
            assert torch.equal(a[vis], c[vis])


def test_k6_k7_shape_is_the_cull_twins():
    """The geometry K6 and K7 report (``raster_fold_shape``) is the one
    ``_fold_culled`` assumes on the CPU: the same warp footprint, regions
    that tile a tile, a warp a footprint, at least a CTA an SM."""
    from ray_eater_tpu_torch.ops import raster
    _cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kernel in (6, 7):
        for mode in RASTER_MODES:
            fs = raster._fold_shape(kernel, raster._mode_bits(*mode))
            assert fs.foot == (raster._FOOT_W, raster._FOOT_H)
            (cw, ch), (fw, fh) = fs.region, fs.foot
            assert raster.TILE_W % cw == 0 and raster.TILE_H % ch == 0
            assert cw % fw == 0 and ch % fh == 0
            assert fs.ctas == (raster.TILE_W // cw) * (raster.TILE_H // ch)
            assert fs.threads == 32 * (cw // fw) * (ch // fh)
            assert fs.resident >= sms


def test_k9_matches_plain():
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.ops import raster, sampling
    dev = _cuda()
    ds, pipe, fb = _raster_frame(dev)
    (gd, gt, g0, g1, feats), zt = raster._raster_draw(pipe, ds, fb)
    pv = raster._interpolate(gt, g0, g1, ds.tri_vary, ds.inv_w, zt, feats)
    tex = rs.mip_checker_texture(dev)
    plan = sampling._subtile_plan(tex, pv.vary["uv"], pv.mask)
    args = (plan.w0i, plan.w1i, *plan.planes, tex.win_table)
    k = sampling._subtile_call(*args)
    p = sampling._subtile_plain(*args)
    assert float((k - p).abs().max()) <= 1e-6


def test_k9_bf16_matches_plain():
    """K9's bfloat16-window instantiation against its plain version (x
    weights rounded to bf16, f32 sums in the same order)."""
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.core.resources import Sampler, texture_from_array
    from ray_eater_tpu_torch.ops import raster, sampling
    dev = _cuda()
    ds, pipe, fb = _raster_frame(dev)
    (gd, gt, g0, g1, feats), zt = raster._raster_draw(pipe, ds, fb)
    pv = raster._interpolate(gt, g0, g1, ds.tri_vary, ds.inv_w, zt, feats)
    tex = texture_from_array(rs.mip_checker_u8(),
                             Sampler(mipmap=True, max_anisotropy=4.0),
                             srgb=False, device=dev,
                             window_dtype=torch.bfloat16)
    assert tex.win_table.dtype == torch.bfloat16
    plan = sampling._subtile_plan(tex, pv.vary["uv"], pv.mask)
    args = (plan.w0i, plan.w1i, *plan.planes, tex.win_table)
    k = sampling._subtile_call(*args)
    p = sampling._subtile_plain(*args)
    assert k.dtype == torch.float32
    assert float((k - p).abs().max()) <= 1e-6
    f32 = sampling._subtile_call(*args[:-1], rs.mip_checker_texture(dev)
                                 .win_table)
    assert 0 < float((k - f32).abs().max()) < 2e-2


def test_sharded_one_card_matches_single(scene, tmp_path):
    """The sharded paths on a one-rank NCCL mesh: the band is the frame,
    so each frame is the single-device one within JAX's bounds (LOD mean
    5e-3, exact max 1e-4) and the raster within 2e-5 on all but 0.5% of
    the pixels; every sharded path launches its kernels."""
    import torch.distributed as dist
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.ops import _cuda as kernels
    from ray_eater_tpu_torch.parallel import sharded
    cloud, view, proj = scene
    mesh = sharded.make_device_mesh(1, device="cuda",
                                    init_method=f"file://{tmp_path / 'pg'}",
                                    rank=0)
    try:
        assert dist.get_backend() == "nccl"
        knobs = resolve_knobs("fog", cloud.num_splats, env={})
        kw = render_kwargs(knobs, exact=False, interpret=False)
        single, _ = gs.render_gaussians(cloud, view, proj, W, H, **kw)
        kws = {k: v for k, v in kw.items()
               if k not in ("pairs_cap_factor", "payload_sort")}
        kernels.reset_launches()
        for ex in ("all_gather", "ring"):
            img, st = sharded.render_gaussians_sharded(
                cloud, view, proj, W, H, mesh, splat_exchange=ex, **kws)
            assert float((img - single).abs().mean()) <= 5e-3, ex
        exact = gs.render_gaussians(
            cloud, view, proj, W, H,
            **render_kwargs(knobs, exact=True, interpret=False))
        sliced = sharded.render_gaussians_depth_sliced(
            cloud, view, proj, W, H, mesh, tile_w=knobs["tile_w"])
        assert float((sliced - exact).abs().max()) <= 1e-4
        sc = rs.scene("grid288", "cuda", W, H)
        pipe, res = sc.passes[0]
        want = sc.frame(0.4)
        c, d = sharded.render_mesh_sharded(pipe, sc.mesh, sc.uniforms(0.4),
                                           res, W, H, mesh)
        off = ((c - want.color[:H, :W]).abs().amax(-1) > 2e-5)
        assert float(off.float().mean()) <= 5e-3
        counts = dict(kernels.launches)
        for key in ("k1_project", "k2_composite", "k7_raster_binned",
                    "k8_shade_fetch", "k9_subtile"):
            assert counts[key] > 0, key
    finally:
        dist.destroy_process_group()


def test_raster_frames_count_launches():
    from ray_eater_tpu_torch import basic_planes, multipass
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.ops import _cuda as kernels
    dev = _cuda()
    kernels.reset_launches()
    r = basic_planes.run(basic_planes.parse_args(["--frames", "2",
                                                  "--host-loop"]))
    assert kernels.launches == dict(NO_LAUNCHES, k6_raster=3)
    assert bool(torch.isfinite(r["frame"].color).all())
    kernels.reset_launches()
    multipass.run(multipass.parse_args(["--frames", "2", "--width", "480",
                                        "--height", "270", "--host-loop"]))
    assert kernels.launches == dict(NO_LAUNCHES, k6_raster=6)
    sc = rs.scene("grid288", dev, W, H)
    kernels.reset_launches()
    fb = sc.frame(0.4)
    assert kernels.launches == dict(NO_LAUNCHES, k7_raster_binned=1,
                                  k8_shade_fetch=1, k9_subtile=1)
    assert bool(torch.isfinite(fb.color).all())


# ---- particle splat: K10; SH colours ----------------------------------------

@pytest.mark.parametrize("h,w,n,r", [(64, 128, 200, 10), (600, 900, 1024, 20),
                                     (97, 301, 3000, 3)])
def test_k10_matches_plain(h, w, n, r):
    from ray_eater_tpu_torch.ops import splat
    dev = _cuda()
    rng = np.random.RandomState(n)
    # over [-2r, w + 2r) x [-2r, h + 2r): clamped, off-image and empty boxes
    pos = np.stack([rng.rand(n) * (w + 4 * r) - 2 * r,
                    rng.rand(n) * (h + 4 * r) - 2 * r], -1).astype(np.float32)
    pos[:4] = [[5, -2 * r - 5], [-2 * r - 5, 5], [-r, -r], [w + r, h + r]]
    p = torch.from_numpy(pos).to(dev)
    k = splat._splat_k10(p, h, w, r)
    assert torch.equal(k, splat._splat_plain(p, h, w, r))
    assert torch.equal(k.cpu(), splat._splat_plain(p.cpu(), h, w, r))
    assert 0 < float(k.mean()) < 1


@pytest.mark.parametrize("h,w,n,r,full", [
    (600, 900, 1024, 20, False), (1080, 1920, 65_536, 20, True),
    (2160, 3840, 65_536, 4, False)])
def test_k10_matches_plain_at_the_timed_shapes(h, w, n, r, full):
    """The shapes ``time_splat.py`` times: the compute_drawing sample's
    particles over its 900x600 image and 65,536 drawn the same way over
    1920x1080, radius 20, where the boxes cover the whole image; and the
    65,536 at radius 4 over 3840x2160, where they cover part of it, so
    that equality at that count can fail for a kernel that writes ones."""
    from ray_eater_tpu_torch import compute_drawing
    from ray_eater_tpu_torch.ops import splat
    dev = _cuda()
    p = torch.from_numpy(compute_drawing.particle_positions(0, w, h, n)).to(
        dev)
    k = splat._splat_k10(p, h, w, r)
    assert torch.equal(k, splat._splat_plain(p, h, w, r))
    cover = float(k[:h, :w].mean())
    assert cover == 1 if full else 0 < cover < 1


def test_k10_matches_plain_on_edge_boxes():
    """Boxes on the image's and the CTA regions' edges (columns at
    multiples of 128 +- r, rows at multiples of 8 and 64 +- r), boxes one
    pixel wide and past every side, fractional and negative positions
    (truncation toward zero), no particles, and positions that start at an
    odd float offset."""
    from ray_eater_tpu_torch.ops import splat
    dev = _cuda()
    h, w, r = 200, 300, 6
    xs = [0, 0.5, -0.5, -5.9, 1, r, 127, 128, 128 + r, 128 - r, 256 - r,
          299, 299.9, 300, 300 + r - 1, 300 + r, 305.5, -r + 1, -r]
    ys = [0, 7, 8, 63, 64, 64 + r, 64 - r, 128, 199, 199.5, 200 + r - 1,
          200 + r, -r + 1, -r]
    pos = np.array([[x, y] for x in xs for y in ys], np.float32)
    for n in (0, 1, pos.shape[0]):
        p = torch.from_numpy(pos[:n]).to(dev)
        k = splat._splat_k10(p, h, w, r)
        assert k.shape == (200, 384)
        assert torch.equal(k, splat._splat_plain(p, h, w, r)), n
    for rad in (1, 40):
        p = torch.from_numpy(pos).to(dev)
        assert torch.equal(splat._splat_k10(p, h, w, rad),
                           splat._splat_plain(p, h, w, rad)), rad
    flat = torch.from_numpy(np.concatenate([[7.0], pos.reshape(-1)])
                            .astype(np.float32)).to(dev)
    odd = flat[1:].view(-1, 2)
    assert odd.data_ptr() % 8
    assert torch.equal(splat._splat_k10(odd, h, w, r),
                       splat._splat_plain(odd, h, w, r))


def test_compute_drawing_counts_launches(tmp_path):
    from ray_eater_tpu_torch import compute_drawing
    from ray_eater_tpu_torch.core.swapchain import encode_present
    from ray_eater_tpu_torch.ops import _cuda as kernels
    _cuda()
    kernels.reset_launches()
    r = compute_drawing.run(compute_drawing.parse_args(
        ["--frames", "2", "--host-loop", "--out", str(tmp_path)]))
    assert kernels.launches == dict(NO_LAUNCHES, k10_splat=1, k6_raster=3)
    img = r["drawing"].image
    assert torch.equal(r["u8"], encode_present(img, img.shape[1],
                                               img.shape[0],
                                               srgb=False).cpu())


def test_sh_colors_match_cpu_and_viewer_counts_launches(tmp_path):
    from ray_eater_tpu_torch import gs_viewer
    from ray_eater_tpu_torch.models.gaussians import eval_sh_colors, save_ply
    from ray_eater_tpu_torch.ops import _cuda as kernels
    dev = _cuda()
    cloud = gs_viewer.synthetic_cloud(20_000, 15, dev)
    eye = torch.tensor([2.0, 0.8, 1.0], device=dev)
    cpu = gs_viewer.synthetic_cloud(20_000, 15, "cpu")
    got = eval_sh_colors(cloud, eye)
    # one CPU thread: PyTorch's first multithreaded CPU sqrt of a process
    # can come out approximate (ROADMAP queue 3)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = eval_sh_colors(cpu, eye.cpu())
    finally:
        torch.set_num_threads(threads)
    assert float((got.cpu() - want).abs().max()) <= 1e-6
    ply = str(tmp_path / "sh.ply")
    save_ply(ply, cloud)
    kernels.reset_launches()
    r = gs_viewer.run(gs_viewer.parse_args(
        ["--ply", ply, "--frames", "2", "--width", str(W), "--height",
         str(H), "--host-loop", "--out", str(tmp_path)]))
    assert kernels.launches == dict(NO_LAUNCHES, k1_project=3,
                                    k2_composite=3, sh_colors=3)
    assert bool(torch.isfinite(r["image"]).all())


def _sh_inputs(n, bands, offset, dev):
    """A degree-(1..3) cloud's means, colours and coefficients on ``dev``:
    rows ``offset:`` of larger arrays (a storage offset, as a rank's shard
    has) in the scene's cube, colours in [0, 1), coefficients N(0, 0.3²)."""
    g = torch.Generator().manual_seed(n * 31 + bands)
    rows = n + offset
    means = torch.rand((rows, 3), generator=g) * 2 - 1
    colors = torch.rand((rows, 3), generator=g)
    sh = torch.randn((rows, bands, 3), generator=g) * 0.3
    return [t.to(dev)[offset:] for t in (means, colors, sh)]


@pytest.mark.parametrize("bands", [3, 8, 15])
@pytest.mark.parametrize("n", [1, 127, 20_000, 1_000_003])
def test_sh_color_kernel_matches_plain(bands, n):
    """The SH colour kernel against its plain version on the card within
    1e-6 (the norm's three-term sum may round differently), from eyes
    outside and inside the cloud, on aligned inputs and on views one and
    three rows into larger arrays (the run's 16-byte phase 3 and 1, and a
    ragged last CTA at 127 and 1,000,003 splats); one launch a call."""
    from ray_eater_tpu_torch.models import gaussians
    from ray_eater_tpu_torch.ops import _cuda as kernels
    dev = _cuda()
    for offset in (0, 1, 3):
        means, colors, sh = _sh_inputs(n, bands, offset, dev)
        for eye in ((2.0, 0.8, 1.0), (0.05, -0.1, 0.2)):
            eye = torch.tensor(eye, device=dev)
            kernels.reset_launches()
            got = gaussians._sh_colors_op(means, colors, sh, eye)
            want = gaussians._sh_colors_plain(means, colors, sh, eye)
            assert kernels.launches == dict(NO_LAUNCHES, sh_colors=1)
            assert got.shape == (n, 3) and got.dtype == torch.float32
            err = float((got - want).abs().max())
            assert err <= 1e-6, (offset, eye, err)


def test_sh_color_kernel_refuses_what_it_does_not_take():
    """On CUDA the op raises on a float64 or wrongly shaped ``sh_rest``, a
    wrongly shaped eye, and launches nothing; there is no fallback."""
    from ray_eater_tpu_torch.models import gaussians
    from ray_eater_tpu_torch.ops import _cuda as kernels
    dev = _cuda()
    means, colors, sh = _sh_inputs(300, 15, 0, dev)
    eye = torch.tensor([2.0, 0.8, 1.0], device=dev)
    kernels.reset_launches()
    bad = [(means, colors, sh.double(), eye),
           (means, colors, sh[:, :5].contiguous(), eye),
           (means, colors, sh.reshape(300, 45), eye),
           (means, colors, sh[:299], eye),
           (means, colors, sh, eye[:2])]
    for args in bad:
        with pytest.raises(ValueError):
            gaussians._sh_colors_op(*args)
    cloud = gaussians.GaussianCloud(means, means, means, means[:, 0],
                                    colors, sh.double())
    with pytest.raises(ValueError, match="dtype"):
        gaussians.eval_sh_colors(cloud, eye)
    assert kernels.launches == NO_LAUNCHES


# ---- render_animation: CUDA-graph replay ------------------------------------

def _replay_equals_eager(frame_fn, n, carry=None, srgb=True, keep="all"):
    """Two render_animation calls (capture, then the cached graph) equal
    the eager loop; the launch counters count the warm-up steps and every
    replayed frame, nothing for the capture."""
    from ray_eater_tpu_torch.core import animation
    from ray_eater_tpu_torch.ops import _cuda as kernels
    info = {}
    kernels.reset_launches()
    got = animation.render_animation(frame_fn, n, srgb=srgb, keep=keep,
                                     carry=carry, info=info)
    again = animation.render_animation(frame_fn, n, srgb=srgb, keep=keep,
                                       carry=carry)
    steps = animation.WARMUP_STEPS + 2 * n
    assert kernels.launches == {k: steps * v for k, v in
                                info["launches_per_frame"].items()}
    want_info = {}
    want = animation.render_animation_eager(frame_fn, n, srgb=srgb,
                                            keep=keep, carry=carry,
                                            info=want_info)
    animation.release(frame_fn)
    assert info["path"] == "graph" and info["captured"]
    assert torch.equal(got, want) and torch.equal(again, want)
    return info, want_info


def test_replay_equals_eager_on_a_raster_frame():
    from ray_eater_tpu_torch import raster_scenes as rs
    dev = _cuda()
    for name in ("basic_planes", "grid288"):
        sc = rs.scene(name, dev, 256, 128)
        info, _ = _replay_equals_eager(sc.frame, 4)
        key = "k6_raster" if name == "basic_planes" else "k7_raster_binned"
        assert info["launches_per_frame"][key] == 1


def test_replay_equals_eager_on_a_fog_frame_with_budgets():
    from ray_eater_tpu_torch import gs_viewer
    dev = _cuda()
    args = gs_viewer.parse_args(["--splats", "20000", "--width", str(W),
                                 "--height", str(H), "--max-per-tile", "64",
                                 "--device", "cuda"])
    v = gs_viewer.viewer(args, random_cloud(20_000, seed=1, extent=1.0,
                                            scale_range=(0.004, 0.02),
                                            device=dev))
    info, want = _replay_equals_eager(v.step, 5, carry=v.initial_budget())
    assert torch.equal(info["carry"], want["carry"])
    assert info["launches_per_frame"]["k2_composite"] == 1
    assert info["launches_per_frame"]["sh_colors"] == 0


def test_replay_equals_eager_on_an_sh_frame_with_budgets():
    """gs_viewer's frame step on a degree-3 cloud: the eye computed on the
    card in the captured graph, one SH colour launch a replayed frame."""
    from ray_eater_tpu_torch import gs_viewer
    dev = _cuda()
    args = gs_viewer.parse_args(["--width", str(W), "--height", str(H),
                                 "--max-per-tile", "64", "--device", "cuda"])
    v = gs_viewer.viewer(args, gs_viewer.synthetic_cloud(20_000, 15, dev))
    info, want = _replay_equals_eager(v.step, 5, carry=v.initial_budget())
    assert torch.equal(info["carry"], want["carry"])
    assert info["launches_per_frame"] == dict(
        NO_LAUNCHES, k1_project=1, k2_composite=1, sh_colors=1)


def test_replay_equals_eager_on_compute_drawing():
    from ray_eater_tpu_torch import compute_drawing
    _cuda()
    d = compute_drawing.setup("cuda", 0, 300, 200, 32)
    _replay_equals_eager(d.frame, 3, srgb=False, keep="last")


def test_capture_of_a_host_copy_raises():
    """A frame step that copies a Python scalar to the device each frame
    cannot be captured: render_animation raises, naming the op, and never
    renders the frames eagerly instead."""
    from ray_eater_tpu_torch.core import animation
    dev = _cuda()
    calls = []

    def frame(t):
        calls.append(1)
        scale = torch.tensor(0.5, device=dev)        # the host copy
        return torch.ones((16, 128, 4), device=dev) * scale * t

    with pytest.raises(animation.GraphCaptureError, match="torch.tensor"):
        animation.render_animation(frame, 8, device=dev)
    assert len(calls) == animation.WARMUP_STEPS + 1
    torch.cuda.synchronize()
    assert float(torch.ones(1, device=dev).sum()) == 1.0


# ---- the kernels as custom ops; baked frames ------------------------------

class _OpCalls(TorchDispatchMode):
    """Records the first call of each ``rayeater::`` op."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "rayeater":
            self.calls.setdefault(func, (args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def test_ops_fake_shapes_match_the_kernels(scene):
    """Every op, on CUDA inputs from small frames of each main path,
    passes opcheck's schema and fake-tensor checks: the fake
    implementation's shapes and dtypes are the kernel's real outputs'."""
    from ray_eater_tpu_torch import compute_drawing
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.gs_viewer import synthetic_cloud
    from ray_eater_tpu_torch.models.gaussians import eval_sh_colors
    cloud, view, proj = scene
    dev = cloud.means.device
    with _OpCalls() as rec:
        gs.render_gaussians(cloud, view, proj, W, H, tile_w=32,
                            max_splats_per_tile=64, lod_tail_decim=64)
        params = [p.clone().requires_grad_(True) for p in
                  (cloud.means, cloud.scales, cloud.quats, cloud.opacities,
                   cloud.colors)]
        gs.render_gaussians_diff(*params, view, proj, W, H,
                                 tile_w=32).sum().backward()
        rs.scene("basic_planes", dev, 256, 128).frame(0.5)
        rs.scene("grid10k", dev, 256, 128).frame(0.5)
        compute_drawing.setup(dev, 0, 300, 200, 32)
        eval_sh_colors(synthetic_cloud(300, 15, dev),
                       torch.tensor([2.0, 0.8, 1.0], device=dev))
    names = sorted(f.__name__.split(".")[0] for f in rec.calls)
    assert names == sorted(NO_LAUNCHES), names
    for func, (args, kwargs) in rec.calls.items():
        res = torch.library.opcheck(func, args, kwargs, test_utils=(
            "test_schema", "test_faketensor"))
        assert set(res.values()) == {"SUCCESS"}, (func, res)


def test_cuda_bake_loads_and_reproduces_the_frame(tmp_path, scene):
    """A fog frame (temporal LOD budget carried) and the multipass
    RenderGraph frame baked on CUDA: the loaded programs equal the
    unbaked ones bit for bit, and launch the kernels through the ops."""
    from ray_eater_tpu_torch import multipass
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.graph import render_graph as tgraph
    from ray_eater_tpu_torch.ops import _cuda as kernels
    cloud, _, _ = scene
    dev = cloud.means.device
    ntx, nty = gs.num_tiles(W, H, 32)

    def render(i):
        view, proj = flythrough_camera(i["t"], W, H, device=dev)
        img, st = gs.render_gaussians(cloud, view, proj, W, H, tile_w=32,
                                      max_splats_per_tile=64,
                                      lod_budget=i["budget"],
                                      return_stats=True)
        return {"image": img, "budget": gs.update_lod_budget(
            st["tile_exec"], 64, ntx, nty, st["tile_kept"],
            st["tile_count"])}

    fog = (tgraph.RenderGraph("fog").external("t", "budget")
           .add_pass("render", render, reads=("t", "budget"),
                     writes=("image", "budget"))
           .output("image", "budget").bake())
    b0 = gs.initial_lod_budget(W, H, 32, 64, dev)
    t0 = torch.zeros((), device=dev)
    fog.save_baked(str(tmp_path / "fog.pt2"), t=t0, budget=b0)
    loaded = tgraph.load_baked(str(tmp_path / "fog.pt2"))
    kernels.reset_launches()
    want, got = fog(t=t0 + 0.3, budget=b0), loaded(t=t0 + 0.3, budget=b0)
    assert torch.equal(got["image"], want["image"])
    assert torch.equal(got["budget"], want["budget"])
    assert kernels.launches["k1_project"] == 2
    assert kernels.launches["k2_composite"] == 2
    mp = multipass.frame_graph(rs.scene("multipass", dev, 480, 272))
    mp.save_baked(str(tmp_path / "mp.pt2"), t=t0)
    lmp = tgraph.load_baked(str(tmp_path / "mp.pt2"))
    a, b = mp(t=t0 + 0.5)["fb"], lmp(t=t0 + 0.5)["fb"]
    assert torch.equal(a.color, b.color) and torch.equal(a.depth, b.depth)
