"""Port vs JAX: K2's plain version (``_composite_plain``) against the Pallas
``_composite_call`` in interpret mode, on packed records that the JAX
package built — the exact (direct) layout with 8 chunks per grid step and
the aligned LOD layout.

Tolerances: planes of visited tiles within 2e-3 max abs (a running
``cumprod`` against the TPU's doubling scan: reassociation only, so the
measured error is ~1e-6); ``exec`` equal on every tile. The scene puts an
opaque blanket in front of a fog so that some tiles saturate inside their
lists (exec < kept). Also: K2's warp row cull bound (its plain twin)
never skips a sample that reaches alpha 1/255.
"""

import numpy as np
import pytest
import torch

from ray_eater_tpu import rmath as jrmath
from ray_eater_tpu.models import gaussians as jgauss
from ray_eater_tpu.ops import gs as jgs
from ray_eater_tpu_torch.ops import gs

torch.set_num_threads(1)

W, H, TW = 256, 96, 32
FIELDS = ("means", "scales", "quats", "opacities", "colors")


def _scene():
    jc = jgauss.random_cloud(2500, seed=11, extent=0.9,
                             scale_range=(0.01, 0.05))
    d = {f: np.array(getattr(jc, f)) for f in FIELDS}
    # two opaque layers in front of the fog's centre; distinct depths
    # (1e-5 apart, well over one 22-bit depth bucket) so no two pairs of a
    # tile share a sort key
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
    d = {f: np.concatenate([d[f], blanket[f]]).astype(np.float32)
         for f in FIELDS}
    cloud = jgauss.gaussian_cloud(*(d[f] for f in FIELDS))
    view = jrmath.look_at_zforward(jrmath.vec(0.0, 0.0, -3.0),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), W / H, 0.1, 30.0)
    return cloud, view, proj


def _jax_layout(mpt):
    """JAX-built packed records + per-tile row ranges, and the JAX
    composite's planes and exec for them."""
    import jax.numpy as jnp
    cloud, view, proj = _scene()
    ps = jgs.project_gaussians(cloud.means, cloud.scales, cloud.quats,
                               cloud.opacities, cloud.colors, view, proj,
                               W, H)
    records = jgs._make_records(ps)
    ntx, nty = jgs.num_tiles(W, H, TW)
    n = cloud.num_splats
    cap = jgs._pad_to(n * jgs.KX * jgs.KY + ntx * nty * jgs.CHUNK, jgs.CHUNK)
    nseg = 8 if mpt is None else 1
    pack, steps, visited, _, _, _, (kept, count), _ = jgs._bin_splats(
        ps.mean2d[:, 0], ps.mean2d[:, 1], ps.radius, jnp.isfinite(ps.depth),
        ps.depth, ntx, nty, cap, max_per_tile=mpt, tile_w=TW,
        records=records if mpt is None else None, nseg=nseg, ext=ps.ext)
    packed = pack if mpt is None else jgs._pack_records(records, pack)
    r, g, b, t, ex = jgs._composite_call(packed, steps, nty, ntx, True,
                                         tile_w=TW, nseg=nseg)
    kept, count = np.asarray(kept), np.asarray(count)
    if mpt is None:       # direct layout: tiles are contiguous runs
        begin = np.concatenate([[0], np.cumsum(count)[:-1]])
    else:                 # aligned layout: each tile starts on a block
        blocks = (kept + jgs.CHUNK - 1) // jgs.CHUNK
        begin = np.concatenate([[0], np.cumsum(blocks)[:-1]]) * jgs.CHUNK
    nt = ntx * nty
    vis = np.asarray(visited)
    planes = np.stack([np.asarray(p)[:nt, 0] for p in (r, g, b, t)])
    return dict(packed=np.array(packed), begin=begin.astype(np.int32),
                end=(begin + kept).astype(np.int32), kept=kept,
                visited=vis, planes=planes,
                exec=np.where(vis, np.asarray(ex)[:nt, 0, 0], 0),
                ntx=ntx, nty=nty)


@pytest.fixture(scope="module", params=["exact", "aligned"])
def layout(request):
    return _jax_layout(None if request.param == "exact" else 256)


def test_composite_plain_matches_jax(layout):
    L = layout
    planes, ex = gs._composite_call(
        torch.from_numpy(L["packed"]), torch.from_numpy(L["begin"]),
        torch.from_numpy(L["end"]), L["ntx"], L["nty"], TW)
    assert planes.shape == (4, L["ntx"] * L["nty"], 32 * TW)
    vis = L["visited"]
    assert vis.any()
    err = np.abs(planes.numpy()[:, vis] - L["planes"][:, vis])
    assert err.max() <= 2e-3, err.max()
    np.testing.assert_array_equal(np.where(vis, ex.numpy(), 0), L["exec"])
    # unvisited tiles are initialised: no colour, full transmittance
    p = planes.numpy()
    assert (p[:3, ~vis] == 0).all() and (p[3, ~vis] == 1).all()
    assert (ex.numpy()[~vis] == 0).all()


def test_scene_saturates_mid_list(layout):
    # the blanket tiles stop early: exec < kept, at a chunk boundary
    ex, kept = layout["exec"], layout["kept"]
    sat = (ex < kept) & (kept > 0)
    assert sat.any()
    assert (ex[sat] > 0).all()


def test_k2_wrapper_refuses_other_devices():
    with pytest.raises(ValueError):
        gs._composite_call(torch.empty((128, 12), device="meta"),
                           torch.empty(6, dtype=torch.int32, device="meta"),
                           torch.empty(6, dtype=torch.int32, device="meta"),
                           2, 3, 32)


def test_warp_row_cull_is_exact():
    """K2's warp row cull (``_cull_threshold``, the kernel's bound in plain
    PyTorch) skips a (row, sample) only where its alpha stays below 1/255:
    random conics (sigma 0.3-60 px, any angle, the 0.3 px dilation) and
    opacities (uniform, within 1e-2..1e-7 of 1/255, 1e-30, 0), at random
    offsets and at knife edges, offsets scaled onto each row's 1/255
    contour by 1 +- 1e-7..1e-1. Float32, each operation in the kernel's
    order."""
    rng = np.random.RandomState(9)
    n, m = 3000, 48
    sig = rng.uniform(0.3, 60.0, (n, 2)) ** 2
    th = rng.uniform(0.0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    a = c * c * sig[:, 0] + s * s * sig[:, 1] + 0.3
    off = c * s * (sig[:, 0] - sig[:, 1])
    d = s * s * sig[:, 0] + c * c * sig[:, 1] + 0.3
    det = a * d - off * off
    conic = np.stack([d, -off, a], 1) / det[:, None]       # ca, cb, cc
    amin = np.float32(1.0 / 255.0)
    op = rng.uniform(0.0, 1.0, n)
    edge = rng.rand(n) < 0.3
    op[edge] = amin * (1.0 + rng.choice([-1, 1], edge.sum())
                       * 10.0 ** rng.uniform(-7, -2, edge.sum()))
    op[:3] = (1e-30, 0.0, 1.0)
    # offsets: random within 4 sigma, and on the contour q = ln(op/amin)
    # along random directions, scaled by 1 +- 10^-7..10^-1
    u = rng.normal(size=(n, m, 2))
    u /= np.linalg.norm(u, axis=2, keepdims=True)
    quad = (conic[:, None, 0] * u[..., 0] ** 2 + conic[:, None, 2]
            * u[..., 1] ** 2 + 2 * conic[:, None, 1] * u[..., 0] * u[..., 1])
    lq = np.log(np.maximum(op, 1e-38) / amin)[:, None]
    scale = 1.0 + rng.choice([-1, 1], (n, m)) * 10.0 ** rng.uniform(-7, -1,
                                                                      (n, m))
    r = np.sqrt(2.0 * np.abs(lq) * scale / quad)
    r[:, m // 2:] = rng.uniform(0.0, 4.0, (n, m - m // 2)) * np.sqrt(
        sig.max(1))[:, None]
    mean = rng.uniform(0.0, 32.0, (n, 2))
    f = lambda x: torch.from_numpy(np.asarray(x, np.float32))  # noqa: E731
    px = f(mean[:, None, 0] + r * u[..., 0])
    py = f(mean[:, None, 1] + r * u[..., 1])
    mx, my = f(mean[:, 0:1]), f(mean[:, 1:2])
    ca, cb, cc = (f(conic[:, i:i + 1]) for i in range(3))
    opt = f(op[:, None])
    dx, dy = px - mx, py - my
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp(opt * torch.exp(power), max=0.99)
    culled = power < gs._cull_threshold(opt)
    assert not bool((culled & (alpha >= amin)).any())
    # the bound is tight: far samples of visible rows are culled, and the
    # knife edges land on both sides
    assert bool(culled[op > 0.05, m // 2:].any())
    near = torch.from_numpy(np.abs(scale - 1.0) < 1e-3)[:, :m // 2]
    assert bool((alpha[:, :m // 2] >= amin)[near].any())
    assert bool(culled[:, :m // 2][near].any())
    far = torch.from_numpy((scale > 1.05) & (op[:, None] > 0.05))[:, :m // 2]
    assert bool(culled[:, :m // 2][far].all())
    assert bool(torch.isnan(gs._cull_threshold(f([np.nan, -0.5]))).all())
