"""Port vs JAX: view-dependent SH colours (``eval_sh_colors``,
``sh_degree``), PLY interchange (``load_ply``, ``save_ply``), the
``cam_pos`` branch of ``render_gaussians`` and the ``gs_viewer`` entry
point.

Tolerances and why:
- ``eval_sh_colors``: within 1e-6 (the same float32 operations in the
  same order; only the three-term sum of the direction's norm may round
  differently).
- ``save_ply`` bytes and ``load_ply`` arrays: equal (the same numpy code).
- ``render_gaussians`` with ``cam_pos``: images within 2e-3 max abs (XLA's
  and PyTorch's CPU exp may put an alpha on either side of the 1/255
  cutoff, as in ``test_torch_render.py``), integer stats equal. The JAX
  side runs its Pallas kernels in interpret mode, two renders per module.
- ``gs_viewer``: equal to direct ``render_gaussians`` calls (the same
  operations on the same device).
"""

import functools

import numpy as np
import pytest
import torch

from ray_eater_tpu import rmath as jrmath
from ray_eater_tpu.models import gaussians as jgauss
from ray_eater_tpu.ops import gs as jgs
from ray_eater_tpu_torch import gs_viewer
from ray_eater_tpu_torch.models import gaussians
from ray_eater_tpu_torch.ops import gs

torch.set_num_threads(1)

FIELDS = ("means", "scales", "quats", "opacities", "colors")
STATS = ("overflow_pairs", "overflow_big_splats", "tile_exec", "tile_kept",
         "tile_count", "lossless")


def _arrays(n, bands, seed=0):
    """numpy fields of a random cloud with ``bands`` higher SH bands
    (``tests/test_sh.py``'s form), no ``sh_rest`` when bands is 0."""
    c = jgauss.random_cloud(n, seed=seed)
    d = {f: np.asarray(getattr(c, f)) for f in FIELDS}
    if bands:
        d["sh_rest"] = (np.random.RandomState(seed).randn(n, bands, 3)
                        .astype(np.float32) * 0.1)
    return d


def _jcloud(d):
    return jgauss.gaussian_cloud(*(d[f] for f in FIELDS),
                                 sh_rest=d.get("sh_rest"))


@pytest.mark.parametrize("bands", [0, 3, 8, 15])
def test_eval_sh_colors_matches_jax(bands):
    d = _arrays(64, bands, seed=2)
    cloud = gaussians.cloud_from_numpy(d, device="cpu")
    for eye in ((0.0, 0.0, -5.0), (4.0, 1.5, 0.5)):
        want = np.asarray(jgauss.eval_sh_colors(_jcloud(d), eye))
        got = gaussians.eval_sh_colors(cloud, torch.tensor(eye))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
        if bands == 0:
            assert got is cloud.colors
        else:
            assert (got >= 0).all() and (got <= 1).all()
    assert cloud.sh_degree == _jcloud(d).sh_degree == {
        0: 0, 3: 1, 8: 2, 15: 3}[bands]


def test_sh_degree1_analytic():
    # only the z band (index 1) of degree 1 set, red channel; the camera on
    # -z looks along +z: red = 0.5 + C1 (tests/test_sh.py)
    sh = np.zeros((1, 3, 3), np.float32)
    sh[0, 1, 0] = 1.0
    c = gaussians.gaussian_cloud([[0, 0, 0]], [[0.1] * 3], [[1, 0, 0, 0]],
                                 [1.0], [[0.5, 0.5, 0.5]], sh, device="cpu")
    out = gaussians.eval_sh_colors(c, (0.0, 0.0, -2.0))[0].numpy()
    np.testing.assert_allclose(out[0], 0.5 + 0.4886025119029199, rtol=1e-6)
    np.testing.assert_allclose(out[1:], 0.5, atol=1e-6)


def _sh_expression(cloud, eye):
    """``eval_sh_colors``'s PyTorch expression as it stood before the SH
    colour kernel, kept here as the op's CPU oracle."""
    C1, C2, C3 = gaussians._SH_C1, gaussians._SH_C2, gaussians._SH_C3
    d = cloud.means - eye
    d = d / torch.sqrt(torch.sum(d * d, -1, keepdim=True)).clamp(min=1e-12)
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    sh = cloud.sh_rest
    deg = cloud.sh_degree
    out = cloud.colors - 0.5
    out = out + C1 * (-y * sh[:, 0] + z * sh[:, 1] - x * sh[:, 2])
    if deg >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out = out + (C2[0] * xy * sh[:, 3] + C2[1] * yz * sh[:, 4]
                     + C2[2] * (2.0 * zz - xx - yy) * sh[:, 5]
                     + C2[3] * xz * sh[:, 6] + C2[4] * (xx - yy) * sh[:, 7])
    if deg >= 3:
        out = out + (C3[0] * y * (3 * xx - yy) * sh[:, 8]
                     + C3[1] * xy * z * sh[:, 9]
                     + C3[2] * y * (4 * zz - xx - yy) * sh[:, 10]
                     + C3[3] * z * (2 * zz - 3 * xx - 3 * yy) * sh[:, 11]
                     + C3[4] * x * (4 * zz - xx - yy) * sh[:, 12]
                     + C3[5] * z * (xx - yy) * sh[:, 13]
                     + C3[6] * x * (xx - 3 * yy) * sh[:, 14])
    return torch.clamp(out + 0.5, 0.0, 1.0)


@pytest.mark.parametrize("bands", [0, 3, 8, 15])
def test_sh_colors_op_on_the_cpu_is_the_plain_expression(bands):
    """``rayeater::sh_colors`` on CPU tensors is the plain expression bit
    for bit and launches nothing; at degree 0 ``eval_sh_colors`` returns
    the cloud's own colours, with no op call."""
    from ray_eater_tpu_torch.ops import _cuda
    cloud = gaussians.cloud_from_numpy(_arrays(97, bands, seed=5),
                                       device="cpu")
    _cuda.reset_launches()
    for eye in ((0.0, 0.0, -5.0), (0.1, -0.2, 0.05)):
        eye = torch.tensor(eye)
        got = gaussians.eval_sh_colors(cloud, eye)
        if bands == 0:
            assert got is cloud.colors
            continue
        assert torch.equal(got, _sh_expression(cloud, eye))
        assert torch.equal(torch.ops.rayeater.sh_colors(
            cloud.means, cloud.colors, cloud.sh_rest, eye), got)
        assert got.untyped_storage().data_ptr() not in {
            t.untyped_storage().data_ptr() for t in (cloud.colors,
                                                     cloud.means)}
    assert set(_cuda.launches.values()) == {0}


@pytest.fixture(scope="module")
def ply_files(tmp_path_factory):
    """A degree-3 cloud written by the JAX package (binary) and the same
    vertices as ascii with a trailing face element."""
    root = tmp_path_factory.mktemp("ply")
    d = _arrays(40, 15, seed=4)
    binary = str(root / "jax.ply")
    jgauss.save_ply(binary, _jcloud(d))
    props, data = gaussians._read_ply_vertices(binary)
    ascii_ = str(root / "ascii.ply")
    with open(ascii_, "w") as f:
        f.write("ply\nformat ascii 1.0\ncomment written by the test\n"
                f"element vertex {len(data)}\n")
        f.writelines(f"property float {p}\n" for p in props)
        f.write("element face 0\nproperty list uchar int vertex_indices\n"
                "end_header\n")
        for row in data:
            f.write(" ".join(repr(float(v)) for v in row) + "\n")
    return d, binary, ascii_


def test_save_ply_bytes_match_jax(ply_files, tmp_path):
    d, binary, _ = ply_files
    port = str(tmp_path / "port.ply")
    gaussians.save_ply(port, gaussians.cloud_from_numpy(d, device="cpu"))
    with open(port, "rb") as a, open(binary, "rb") as b:
        assert a.read() == b.read()


@pytest.mark.parametrize("which", ["binary", "ascii"])
def test_load_ply_matches_jax(ply_files, which):
    d, binary, ascii_ = ply_files
    path = binary if which == "binary" else ascii_
    want = jgauss.load_ply(path)
    got = gaussians.load_ply(path, device="cpu")
    assert got.sh_rest.shape == (40, 15, 3) and got.sh_degree == 3
    # stored channel-major, returned (N, B, 3) contiguous: the SH colour
    # kernel takes it without a copy a frame
    assert all(getattr(got, f).is_contiguous()
               for f in FIELDS + ("sh_rest",))
    for f in FIELDS + ("sh_rest",):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    # f_rest_10.. sort after f_rest_9: the bands come back as written
    np.testing.assert_allclose(got.sh_rest.numpy(), d["sh_rest"], atol=1e-6)


def test_load_ply_missing_properties_raise(tmp_path):
    p = tmp_path / "bad.ply"
    p.write_bytes(b"ply\nformat binary_little_endian 1.0\nelement vertex 1\n"
                  b"property float x\nproperty float y\nproperty float z\n"
                  b"end_header\n" + np.zeros(3, "<f4").tobytes())
    with pytest.raises(ValueError, match="missing"):
        gaussians.load_ply(str(p), device="cpu")
    with pytest.raises(ValueError, match="missing"):
        jgauss.load_ply(str(p))


W, H = 128, 64
EYE = (0.3, -0.4, -3.0)
RENDER = {"exact": dict(tile_w=32), "lod": dict(tile_w=32,
                                                max_splats_per_tile=32)}


@functools.lru_cache(maxsize=None)
def _render_both(mode):
    """(JAX image, stats, port image, stats, port image without cam_pos) of
    a degree-3, 300-splat cloud rendered with SH colours at EYE."""
    jc = jgauss.random_cloud(300, seed=6, extent=0.8,
                             scale_range=(0.02, 0.08))
    d = {f: np.asarray(getattr(jc, f)) for f in FIELDS}
    d["sh_rest"] = (np.random.RandomState(6).randn(300, 15, 3)
                    .astype(np.float32) * 0.3)
    view = jrmath.look_at_zforward(jrmath.vec(*EYE), jrmath.vec(0., 0., 0.))
    proj = jrmath.perspective(jrmath.radians(60.0), W / H, 0.1, 30.0)
    kw = dict(RENDER[mode], return_stats=True)
    jimg, jst = jgs.render_gaussians(_jcloud(d), view, proj, W, H,
                                     cam_pos=EYE, interpret=True, **kw)
    cloud = gaussians.cloud_from_numpy(d, device="cpu")
    timg, tst = gs.render_gaussians(cloud, np.asarray(view), np.asarray(proj),
                                    W, H, cam_pos=torch.tensor(EYE), **kw)
    plain = gs.render_gaussians(cloud, np.asarray(view), np.asarray(proj),
                                W, H, **RENDER[mode])
    return (np.asarray(jimg), {k: np.asarray(jst[k]) for k in STATS},
            timg.numpy(), {k: tst[k].numpy() for k in STATS}, plain.numpy())


@pytest.mark.parametrize("mode", list(RENDER))
def test_render_with_sh_matches_jax(mode):
    jimg, jst, timg, tst, plain = _render_both(mode)
    assert timg.shape == (H, W, 3) and np.isfinite(timg).all()
    assert np.abs(timg - jimg).max() <= 2e-3, np.abs(timg - jimg).max()
    for k in STATS:
        np.testing.assert_array_equal(tst[k], jst[k], err_msg=k)
    # the SH branch ran: the frame differs from the DC-colour frame
    assert np.abs(timg - plain).max() > 1e-2


def test_gs_viewer_matches_direct_render(tmp_path):
    d = _arrays(200, 15, seed=8)
    d["means"] = d["means"] * 0.8
    ply = str(tmp_path / "tiny.ply")
    gaussians.save_ply(ply, gaussians.cloud_from_numpy(d, device="cpu"))
    args = gs_viewer.parse_args(
        ["--ply", ply, "--device", "cpu", "--frames", "2", "--width",
         str(W), "--height", str(H), "--max-per-tile", "32", "--host-loop",
         "--out", str(tmp_path / "out")])
    r = gs_viewer.run(args)
    with open(r["png"], "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"

    # the same frames by hand: a warm-up at t = 0, then t = 0 and 1/60,
    # each frame's budget from the previous frame's stats
    cloud = gaussians.load_ply(ply, device="cpu")
    ntx, nty = gs.num_tiles(W, H, 32)
    budget = gs.initial_lod_budget(W, H, 32, 32, "cpu")
    assert budget.shape == (ntx * nty, 2) and budget.dtype == torch.int32
    assert bool((budget[:, 0] == 32).all() & (budget[:, 1] == 0).all())
    for t in (0.0, 0.0, float(np.float32(1 / 60))):
        ang = torch.tensor(t) * (torch.tensor(30.0) * torch.tensor(
            np.pi / 180, dtype=torch.float32))
        eye = torch.stack([2.5 * torch.cos(ang), torch.tensor(0.8),
                           2.5 * torch.sin(ang)])
        view, proj, eye2 = gs_viewer.orbit_at(ang, 0.8, 2.5, aspect=W / H,
                                              device="cpu")
        torch.testing.assert_close(eye2, eye, rtol=0, atol=0)
        img, st = gs.render_gaussians(cloud, view, proj, W, H, cam_pos=eye,
                                      max_splats_per_tile=32,
                                      pairs_cap_factor=4, tile_w=32,
                                      return_stats=True, lod_budget=budget)
        budget = gs.update_lod_budget(st["tile_exec"], 32, ntx, nty,
                                      st["tile_kept"], st["tile_count"])
    assert float(img.max()) > 0.05
    torch.testing.assert_close(r["image"], img, rtol=0, atol=0)
    assert gs_viewer.parse_args([]).device == "cuda"


@pytest.mark.parametrize("bands", [0, 15])
def test_synthetic_cloud_is_the_samples_cloud(bands):
    # samples/gs_viewer.py's synthetic scene, with SH bands in the form of
    # tests/test_sh.py; the viewer's knobs come from the argument defaults
    c = gs_viewer.synthetic_cloud(300, bands, "cpu")
    jc = jgauss.random_cloud(300, seed=1, extent=1.0,
                             scale_range=(0.004, 0.02))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(c, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
    if bands:
        np.testing.assert_array_equal(
            c.sh_rest.numpy(), np.random.RandomState(1).randn(300, bands, 3)
            .astype(np.float32) * 0.1)
    assert c.sh_degree == (3 if bands else 0)
    v = gs_viewer.viewer(gs_viewer.parse_args(
        ["--splats", "300", "--device", "cpu"]))
    assert torch.equal(v.cloud.means, c.means) and v.cloud.sh_rest is None
    assert (v.max_per_tile, v.cap_factor, v.big_splat_cap, v.tile_w,
            v.width, v.height, v.static_camera) == (192, 4, None, 32, 1920,
                                                    1080, False)
