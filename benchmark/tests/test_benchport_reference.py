"""The plain reference against a float64 composite on a tiny cloud, and the
work counter against counts made by hand on a two-tile scene."""

import math

import numpy as np
import pytest
import torch

from reference import render as ref
from reference import sh, work
from reference.camera import orbit_view
from reference.scenes import fog

CAM = {"radius": 2.5, "height": 0.8, "fov_deg": 60.0, "near": 0.05,
       "far": 50.0}
W, H = 96, 64


def _cloud(n=60, seed=3):
    gen = torch.Generator().manual_seed(seed)
    c = fog.make({"num_splats": n, "extent": 0.6,
                  "scale_range": [0.01, 0.03]}, gen, "cpu")
    return c


def _oracle(planes, cloud, tile_w):
    """Float64 per-pixel front-to-back composite: each splat touches the
    pixels of the tiles of its fan (bbox span tiles whose rectangle the
    circumscribed circle meets), alpha = min(0.99, op exp(power)) where
    >= 1/255, colour sum T alpha c, black background."""
    p = planes.double().numpy()
    op = cloud["opacities"].double().numpy()
    col = cloud["colors"].double().numpy()
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = xs + 0.5, ys + 0.5
    img = np.zeros((H, W, 3))
    T = np.ones((H, W))
    ntx, nty = ref.num_tiles(W, H, tile_w)
    for i in np.argsort(p[5], kind="stable"):
        if not np.isfinite(p[5, i]):
            continue
        mx, my, r, rx, ry = p[0, i], p[1, i], p[6, i], p[7, i], p[8, i]
        tx0 = int(np.clip(np.floor((mx - rx) / tile_w), 0, ntx - 1))
        tx1 = int(np.clip(np.floor((mx + rx) / tile_w), 0, ntx - 1))
        ty0 = int(np.clip(np.floor((my - ry) / 32), 0, nty - 1))
        ty1 = int(np.clip(np.floor((my + ry) / 32), 0, nty - 1))
        box = np.zeros((H, W), bool)
        for ty in range(ty0, min(ty1, ty0 + 1) + 1):
            for tx in range(tx0, min(tx1, tx0 + 1) + 1):
                x0, y0 = tx * tile_w, ty * 32
                ddx = max(x0 - mx, mx - (x0 + tile_w), 0.0)
                ddy = max(y0 - my, my - (y0 + 32), 0.0)
                if ddx * ddx + ddy * ddy <= r * r:
                    box |= ((px >= x0) & (px < x0 + tile_w)
                            & (py >= y0) & (py < y0 + 32))
        dx, dy = px - mx, py - my
        power = -0.5 * (p[2, i] * dx * dx + p[4, i] * dy * dy) \
            - p[3, i] * dx * dy
        a = np.minimum(op[i] * np.exp(power), 0.99)
        a = np.where(box & (a >= 1 / 255), a, 0.0)
        img += (T * a)[..., None] * col[i]
        T *= 1 - a
    return img


@pytest.mark.parametrize("tile_w", [32, 64])
def test_exact_frame_matches_float64_composite(tile_w):
    cloud = _cloud()
    view, proj, _ = orbit_view(torch.tensor(0.7), CAM, W, H)
    knobs = {"tile_w": tile_w}
    planes = ref.project(cloud, view, proj, W, H,
                         float(ref.level1_max_radius(tile_w)))
    assert int(torch.isfinite(planes[5]).sum()) > 40
    b = ref.bin_splats(planes, *ref.num_tiles(W, H, tile_w), knobs, False)
    records = ref.make_records(planes, cloud)
    head, _ = ref.composite(records[b.pack_idx], b.row_begin, b.row_end,
                            None, *ref.num_tiles(W, H, tile_w), tile_w, 1)
    ntx, nty = ref.num_tiles(W, H, tile_w)
    got = ref.finalize(head, b.kept > 0, nty, ntx, tile_w)[:H, :W]
    want = _oracle(planes, cloud, tile_w)
    assert float(want.max()) > 0.3
    np.testing.assert_allclose(got.double().numpy(), want, atol=2e-5)
    fr = ref.render(cloud, view, proj, W, H, knobs, False)
    enc = np.round(np.where(np.clip(want, 0, 1) <= 0.0031308,
                            np.clip(want, 0, 1) * 12.92,
                            1.055 * np.clip(want, 0, 1) ** (1 / 2.4) - 0.055)
                   * 255)
    assert np.abs(fr.image.numpy().astype(int) - enc).max() <= 1


def test_projection_means_match_float64_pinhole():
    cloud = _cloud()
    view, proj, _ = orbit_view(torch.tensor(1.3), CAM, W, H)
    planes = ref.project(cloud, view, proj, W, H, 15.0)
    v = view.double().numpy()
    pr = proj.double().numpy()
    m = np.c_[cloud["means"].double().numpy(), np.ones(60)] @ v.T
    mx = (m[:, 0] / m[:, 2] * pr[0, 0] + 1) * 0.5 * W
    my = (m[:, 1] / m[:, 2] * pr[1, 1] + 1) * 0.5 * H
    ok = np.isfinite(planes[5].numpy())
    np.testing.assert_allclose(planes[0].numpy()[ok], mx[ok], atol=1e-3)
    np.testing.assert_allclose(planes[1].numpy()[ok], my[ok], atol=1e-3)
    np.testing.assert_allclose(planes[5].numpy()[ok], m[ok, 2], rtol=1e-6)


def _planes(rows):
    """(9, N) planes from (mx, my, conic a, depth, radius, opacity)."""
    t = torch.tensor(rows, dtype=torch.float32)
    mx, my, ca, dep, r = t[:, 0], t[:, 1], t[:, 2], t[:, 3], t[:, 4]
    z = torch.zeros_like(mx)
    return torch.stack([mx, my, ca, z, ca, dep, r, r, r]), t[:, 5]


def _frame(rows, width=64, height=32, tile_w=32):
    planes, op = _planes(rows)
    n = planes.shape[1]
    cloud = {"opacities": op, "colors": torch.full((n, 3), 0.5)}
    ntx, nty = ref.num_tiles(width, height, tile_w)
    b = ref.bin_splats(planes, ntx, nty, {"tile_w": tile_w}, False)
    records = ref.make_records(planes, cloud)
    head, exec_h = ref.composite(records[b.pack_idx], b.row_begin,
                                 b.row_end, None, ntx, nty, tile_w, 1)
    img = ref.encode_u8(ref.finalize(head, b.kept > 0, nty, ntx, tile_w))
    return ref.Frame(img, None, b, torch.where(b.kept > 0, exec_h, 0), None)


def test_work_counts_by_hand_on_two_tiles():
    # tile 0 holds three splats, the third also crosses into tile 1
    fr = _frame([[10, 16, 0.25, 1.0, 6, 0.8], [20, 10, 0.25, 2.0, 6, 0.8],
                 [31, 16, 0.25, 3.0, 6, 0.8]])
    assert fr.binned.count.tolist() == [3, 1]
    assert fr.exec_head.tolist() == [3, 1]
    w = work.frame_work(fr, 3, 64, 32, 32, 2)
    assert w["k2"]["evals"] == 4 * 1024
    assert w["k2"]["flops"] == 4 * 1024 * 24
    assert w["k2"]["bytes"] == 4 * 36 + 2 * 8 + 4 * 2 * 1024 * 4 + 2 * 4
    assert "k3" not in w
    assert w["frame"]["flops"] == 4 * 1024 * 24 + 3 * 260
    assert w["frame"]["bytes"] == 3 * 56 + 64 * 32 * 3
    sec, bound = work.least_s(w["k2"]["flops"], w["k2"]["bytes"])
    assert bound == "bytes" and sec == pytest.approx(32936 / 3.35e12)


def test_work_stops_at_tile_saturation():
    # 200 flat, nearly opaque splats over tile 0: it saturates in its first
    # 128-row chunk, so only that chunk's rows count
    rows = [[16, 16, 1e-9, 1.0 + k, 6, 0.9] for k in range(200)]
    rows.append([48, 16, 0.25, 5.0, 6, 0.9])
    fr = _frame(rows)
    assert fr.binned.count.tolist() == [200, 1]
    assert fr.exec_head.tolist() == [128, 1]
    w = work.frame_work(fr, 201, 64, 32, 32, 2)
    assert w["k2"]["evals"] == 129 * 1024
    assert w["k2"]["flops"] == 129 * 1024 * 24
    sec, bound = work.least_s(w["k2"]["flops"], w["k2"]["bytes"])
    assert bound == "f32" and sec == pytest.approx(129 * 1024 * 24 / 67e12)


def test_lod_budget_step_matches_hand_values():
    # one tile row of three tiles: exec 100, 300, 0; the middle ran dry
    exec_ = torch.tensor([100, 300, 0], dtype=torch.int32)
    kept = torch.tensor([128, 300, 0], dtype=torch.int32)
    count = torch.tensor([500, 900, 0], dtype=torch.int32)
    nb = ref.next_budget(exec_, kept, count, 176, 3, 1, "jump")
    # 3x3 max of exec: 300 everywhere -> 300*1.5 + 128 = 578; the dry tile
    # jumps to min(900, 4*176) = 704 and needs its 900
    assert nb[:, 0].tolist() == [578, 704, 578]
    assert nb[:, 1].tolist() == [0, 900, 0]
    assert math.isclose(float(ref.ALPHA_MIN), 1 / 255)


def test_sh_basis_is_orthonormal_on_the_sphere():
    # float64 quadrature over a Fibonacci lattice of the unit sphere
    m = 200_000
    k = np.arange(m) + 0.5
    z = 1 - 2 * k / m
    phi = math.pi * (1 + 5 ** 0.5) * k
    r = np.sqrt(1 - z * z)
    d = torch.from_numpy(np.stack([r * np.cos(phi), r * np.sin(phi), z], 1))
    b = sh.basis(d, 15).numpy()
    gram = b.T @ b * (4 * math.pi / m)
    np.testing.assert_allclose(gram, np.eye(15), atol=1e-3)


def test_sh_colours_match_the_ports_evaluation():
    from ray_eater_tpu_torch.models.gaussians import (GaussianCloud,
                                                      eval_sh_colors)
    gen = torch.Generator().manual_seed(5)
    c = fog.make({"num_splats": 500, "extent": 1.0,
                  "scale_range": [0.01, 0.03], "sh_degree": 3,
                  "sh_rest_std": 0.3}, gen, "cpu")
    assert c["sh_rest"].shape == (500, 15, 3)
    eye = torch.tensor([2.0, 0.8, -1.1])
    got = sh.colors(c, eye)
    want = eval_sh_colors(GaussianCloud(**c), eye)
    assert float((got - c["colors"]).abs().max()) > 0.1
    torch.testing.assert_close(got, want, atol=2e-6, rtol=0)
    assert sh.colors(c, None) is c["colors"]


def test_work_counts_the_sh_colours():
    fr = _frame([[10, 16, 0.25, 1.0, 6, 0.8]])
    w0 = work.frame_work(fr, 1, 64, 32, 32, 2)
    w3 = work.frame_work(fr, 1, 64, 32, 32, 2, sh_bands=15)
    assert w3["frame"]["flops"] - w0["frame"]["flops"] == 153
    assert w3["frame"]["bytes"] - w0["frame"]["bytes"] == 45 * 4
    assert w3["k2"] == w0["k2"]
