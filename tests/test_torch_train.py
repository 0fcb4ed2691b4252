"""Port vs JAX: the training slice — K4's and K5's plain versions against the
Pallas checkpoint forward and ``composite_diff``'s backward in interpret
mode, ``render_gaussians_diff`` (image and all six gradients),
``render_diff``, and ``make_train_step_pallas`` against optax Adam.

Inputs are made from seeds with numpy and cross as numpy arrays. The K4/K5
scene is the saturating "blanket" of ``test_torch_composite.py``.

Tolerances, with their reasons:
* K4 planes and the checkpoints of executed chunks within 2e-3 max abs (a
  running ``cumprod`` against the TPU's doubling scan: reassociation only,
  ~1e-6 measured); ``exec`` equal on every tile.
* K5 and every gradient within 1e-4 × the largest |gradient| of the
  reference (reassociated sums; JAX rebuilds T_i as exp of a log prefix).
  K5 rows holding a sample whose α lies within 1e-6 (relative) of the 1/255
  floor or the 0.99 clamp are left out (XLA's and PyTorch's CPU exp may put
  such an α on either side); the test asserts they are rare.
* three training steps' losses within 1e-3 relative (Adam turns rounding
  noise in a near-zero gradient into a step of ~lr, so parameters after
  several steps are not compared).
The JAX references run their Pallas kernels in interpret mode, each
under one ``jax.jit`` (compiling once costs less than eager dispatch).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_eater_tpu import rmath as jrmath
from ray_eater_tpu.models import gaussians as jgauss
from ray_eater_tpu.models import gs_training as jtrain
from ray_eater_tpu.ops import gs as jgs
from ray_eater_tpu_torch.models import gaussians
from ray_eater_tpu_torch.models import gs_training as ttrain
from ray_eater_tpu_torch.ops import gs
from test_torch_composite import TW, _scene

torch.set_num_threads(1)

FIELDS = ("means", "scales", "quats", "opacities", "colors")
PFIELDS = ("means", "log_scales", "quats", "opacity_logits", "colors")
W, H = 256, 96
REL = 1e-4
EDGE = 1e-6


def _ct(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape) \
        .astype(np.float32)


def _jax_layout(mpt):
    """JAX-built packed records, step tables and per-tile row ranges of the
    blanket scene (direct layout with one chunk a step, or aligned), and
    the JAX checkpoint forward on them: one jitted call."""
    cloud, view, proj = _scene()
    ntx, nty = jgs.num_tiles(W, H, TW)

    def build():
        ps = jgs.project_gaussians(cloud.means, cloud.scales, cloud.quats,
                                   cloud.opacities, cloud.colors, view, proj,
                                   W, H)
        records = jgs._make_records(ps)
        cap = jgs._pad_to(cloud.num_splats * jgs.KX * jgs.KY
                          + ntx * nty * jgs.CHUNK, jgs.CHUNK)
        pack, steps, visited, _, _, _, kc, _ = jgs._bin_splats(
            ps.mean2d[:, 0], ps.mean2d[:, 1], ps.radius,
            jnp.isfinite(ps.depth), ps.depth, ntx, nty, cap,
            max_per_tile=mpt, tile_w=TW,
            records=records if mpt is None else None, nseg=1, ext=ps.ext)
        packed = pack if mpt is None else jgs._pack_records(records, pack)
        out = jgs._composite_call_ckpt(packed, steps, nty, ntx, True,
                                       tile_w=TW)
        return packed, steps, visited, kc, out
    packed, steps, visited, (kept, count), out = jax.jit(build)()
    kept, count = np.asarray(kept), np.asarray(count)
    if mpt is None:
        begin = np.concatenate([[0], np.cumsum(count)[:-1]])
    else:
        blocks = (kept + jgs.CHUNK - 1) // jgs.CHUNK
        begin = np.concatenate([[0], np.cumsum(blocks)[:-1]]) * jgs.CHUNK
    nt = ntx * nty
    return dict(packed=packed, steps=steps, ntx=ntx, nty=nty,
                begin=begin.astype(np.int32),
                end=(begin + kept).astype(np.int32), kept=kept,
                visited=np.asarray(visited),
                jplanes=np.stack([np.asarray(x)[:nt, 0] for x in out[:4]]),
                tck=np.asarray(out[4])[:, 0])


def _steps_to_slots(L, ck_off):
    """Per JAX step: (tile, port checkpoint slot, live rows); tile is
    ntiles for the sentinel steps."""
    st = np.asarray(L["steps"][0])
    lo, hi = np.asarray(L["steps"][3]), np.asarray(L["steps"][4])
    nt = L["ntx"] * L["nty"]
    j = np.zeros(len(st), np.int64)
    for si in range(1, len(st)):
        j[si] = j[si - 1] + 1 if st[si] == st[si - 1] else 0
    slot = np.where(st < nt, ck_off[np.minimum(st, nt - 1)] + j, -1)
    return st, slot, hi - lo


@functools.lru_cache(maxsize=None)
def _ckpt_case(layout):
    """The JAX checkpoint forward on one layout and K4's plain version on
    the same packed records."""
    L = _jax_layout(None if layout == "exact" else 256)
    args = (torch.from_numpy(np.array(L["packed"])),
            torch.from_numpy(L["begin"]), torch.from_numpy(L["end"]))
    L["port"] = gs._composite_call_ckpt(*args, L["ntx"], L["nty"], TW)
    L["args"] = args
    return L


@pytest.fixture(params=["exact", "aligned"])
def ckpt_case(request):
    return _ckpt_case(request.param)


def test_k4_plain_matches_jax(ckpt_case):
    L = ckpt_case
    planes, ex, ckpt, ck_off = (x.numpy() for x in L["port"])
    vis = L["visited"]
    assert np.abs(planes[:, vis] - L["jplanes"][:, vis]).max() <= 2e-3
    # JAX ran a step iff its entry T was not saturated (its exec counts
    # the live rows of those steps)
    st, slot, rows = _steps_to_slots(L, ck_off)
    nt = L["ntx"] * L["nty"]
    ran = (st < nt) & (L["tck"].max(1) >= gs._T_EPS)
    jexec = np.bincount(st[ran], weights=rows[ran], minlength=nt + 1)[:nt]
    np.testing.assert_array_equal(ex, jexec.astype(np.int32))
    assert ((ex < L["kept"]) & (L["kept"] > 0)).any()   # some saturate
    # the checkpoints of the chunks that ran, slot for slot
    err = np.abs(ckpt[slot[ran]] - L["tck"][ran]).max()
    assert err <= 2e-3, err
    assert ckpt.shape[0] >= ran.sum()


def _edge_rows(packed, begin, exec_, ntx, tile_w):
    """Rows of executed chunks holding a sample whose float64 α lies
    within EDGE (relative) of the 1/255 floor or the 0.99 clamp."""
    rows = np.zeros(packed.shape[0], bool)
    yy, xx = np.mgrid[0:gs.TILE_H, 0:tile_w]
    for t in np.nonzero(exec_ > 0)[0]:
        lo, hi = begin[t], begin[t] + exec_[t]
        rec = packed[lo:hi].astype(np.float64)
        px = (xx + (t % ntx) * tile_w + 0.5).ravel()[None]
        py = (yy + (t // ntx) * gs.TILE_H + 0.5).ravel()[None]
        dx, dy = px - rec[:, :1], py - rec[:, 1:2]
        power = (-0.5 * (rec[:, 2:3] * dx * dx + rec[:, 4:5] * dy * dy)
                 - rec[:, 3:4] * dx * dy)
        a = rec[:, 5:6] * np.exp(power)
        near = ((np.abs(a - 1 / 255) < EDGE / 255)
                | (np.abs(a - 0.99) < EDGE)).any(1)
        rows[lo:hi] |= near
    return rows


def test_k5_plain_matches_jax_vjp():
    """On the aligned layout, the one training uses."""
    L = _ckpt_case("aligned")
    nt, pix = L["ntx"] * L["nty"], gs.TILE_H * TW
    cts = [_ct((nt, pix), 40 + k) for k in range(4)]
    jcts = tuple(jnp.asarray(np.concatenate([c, np.zeros((1, pix),
                                                          np.float32)])
                             )[:, None] for c in cts)
    jg = np.asarray(jax.jit(lambda p, s: jax.vjp(
        lambda q: jgs.composite_diff(q, s, L["nty"], L["ntx"], True, TW),
        p)[1](jcts)[0])(L["packed"], L["steps"]))
    planes, ex, ckpt, ck_off = L["port"]
    g = gs._composite_bwd_call(*L["args"], ex, ck_off, ckpt, planes,
                               torch.from_numpy(np.stack(cts)), L["ntx"],
                               L["nty"], TW).numpy()
    packed = np.array(L["packed"])
    live = np.zeros(packed.shape[0], bool)
    for b, e in zip(L["begin"], L["end"]):
        live[b:e] = True
    edge = _edge_rows(packed, L["begin"], ex.numpy(), L["ntx"], TW)
    assert edge.sum() <= 0.02 * live.sum(), edge.sum()
    cmp = live & ~edge
    scale = np.abs(jg[cmp]).max()
    assert scale > 0
    assert np.abs(g[cmp] - jg[cmp]).max() <= REL * scale
    assert (g[~live] == 0).all() and (g[:, 9:] == 0).all()


def test_k5_plain_matches_autograd_of_k4_plain(ckpt_case):
    """The independent oracle: autograd through K4's plain version."""
    L = ckpt_case
    nt, pix = L["ntx"] * L["nty"], gs.TILE_H * TW
    d = torch.from_numpy(_ct((4, nt, pix), 7))
    rec = L["args"][0].clone().requires_grad_(True)
    planes = gs._composite_ckpt_plain(rec, *L["args"][1:], L["ntx"],
                                      L["nty"], TW)[0]
    (planes * d).sum().backward()
    planes, ex, ckpt, ck_off = L["port"]
    g = gs._composite_bwd_plain(*L["args"], ex, ck_off, ckpt, planes, d,
                                L["ntx"], L["nty"], TW)
    scale = float(rec.grad.abs().max())
    assert scale > 0
    assert float((g - rec.grad).abs().max()) <= REL * scale


def test_composite_diff_is_k4_then_k5(ckpt_case):
    L = ckpt_case
    rec = L["args"][0].clone().requires_grad_(True)
    planes = gs.composite_diff(rec, *L["args"][1:], L["ntx"], L["nty"], TW)
    torch.testing.assert_close(planes.detach(), L["port"][0], rtol=0,
                               atol=0)
    d = torch.from_numpy(_ct(tuple(planes.shape), 3))
    (planes * d).sum().backward()
    p, ex, ckpt, ck_off = L["port"]
    g = gs._composite_bwd_plain(*L["args"], ex, ck_off, ckpt, p, d,
                                L["ntx"], L["nty"], TW)
    torch.testing.assert_close(rec.grad, g, rtol=0, atol=0)
    with torch.no_grad():   # without autograd: K2 alone
        torch.testing.assert_close(
            gs.composite_diff(rec, *L["args"][1:], L["ntx"], L["nty"], TW),
            L["port"][0], rtol=0, atol=0)


@pytest.mark.parametrize("call", ["ckpt", "bwd"])
def test_k4_k5_wrappers_refuse_other_devices(call):
    m = dict(device="meta")
    rec = torch.empty((128, 12), **m)
    rows = torch.empty(6, dtype=torch.int32, **m)
    with pytest.raises(ValueError):
        if call == "ckpt":
            gs._composite_call_ckpt(rec, rows, rows, 2, 3, 32)
        else:
            gs._composite_bwd_call(rec, rows, rows, rows, rows,
                                   torch.empty((4, 1024), **m),
                                   torch.empty((4, 6, 1024), **m),
                                   torch.empty((4, 6, 1024), **m), 2, 3, 32)


# ---------------------------------------------------------------------------
# render_gaussians_diff, render_diff and the training step
# ---------------------------------------------------------------------------

RW, RH = 128, 64      # W/H = 2: fx = |fy| exactly, so an isotropic splat on
#                       the optical axis projects to a circle (mid² = det)


def _train_cloud(seed=5, n=60):
    jc = jgauss.random_cloud(n, seed=seed, extent=0.7,
                             scale_range=(0.03, 0.09))
    d = {f: np.array(getattr(jc, f)) for f in FIELDS}
    extra = dict(   # on the axis (isotropic), behind the eye, off screen
        means=np.array([[0, 0, 0], [0, 0, -4.0], [40.0, 0, 0]]),
        scales=np.array([[0.06] * 3, [0.05] * 3, [0.05] * 3]),
        quats=np.array([[1.0, 0, 0, 0]] * 3),
        opacities=np.array([0.8, 0.7, 0.7]),
        colors=np.array([[0.9, 0.2, 0.1]] * 3))
    return {f: np.concatenate([d[f], extra[f]]).astype(np.float32)
            for f in FIELDS}


def _jcam():
    view = jrmath.look_at_zforward(jrmath.vec(0.0, 0.0, -3.0),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), RW / RH, 0.1, 30.0)
    return view, proj


@pytest.fixture(scope="module")
def diff_case():
    """JAX render_gaussians_diff (interpret) and its VJP for a random
    cotangent, w.r.t. the five cloud fields and mean2d_offset."""
    d = _train_cloud()
    view, proj = _jcam()
    n = d["means"].shape[0]
    off = np.zeros((n, 2), np.float32)
    ct = _ct((RH, RW, 3), 9)

    def f(*args):
        return jgs.render_gaussians_diff(*args[:5], view, proj, RW, RH,
                                         background=(0.1, 0.2, 0.3),
                                         interpret=True,
                                         mean2d_offset=args[5])
    img, grads = jax.jit(lambda *a: (lambda o: (o[0], o[1](ct)))(
        jax.vjp(f, *a)))(*(d[k] for k in FIELDS), off)
    grads = [np.asarray(x) for x in grads]
    return dict(d=d, off=off, ct=ct, img=np.asarray(img), grads=grads,
                view=np.asarray(view), proj=np.asarray(proj))


def test_render_gaussians_diff_matches_jax(diff_case):
    c = diff_case
    ts = [torch.from_numpy(c["d"][k]).requires_grad_(True) for k in FIELDS]
    off = torch.from_numpy(c["off"]).requires_grad_(True)
    img = gs.render_gaussians_diff(*ts, c["view"], c["proj"], RW, RH,
                                   background=(0.1, 0.2, 0.3),
                                   mean2d_offset=off)
    assert img.shape == (RH, RW, 3)
    assert np.abs(img.detach().numpy() - c["img"]).max() <= 2e-5
    (img * torch.from_numpy(c["ct"])).sum().backward()
    for name, t, jg in zip(FIELDS + ("mean2d_offset",), ts + [off],
                           c["grads"]):
        g = t.grad.numpy()
        assert np.isfinite(g).all(), name
        scale = np.abs(jg).max()
        assert scale > 0, name
        assert np.abs(g - jg).max() <= REL * scale, name
    # the on-axis circle, and the culled splats, get finite gradients; the
    # culled ones none at all
    assert (ts[0].grad[-2:] == 0).all()


def test_radius_chain_takes_no_gradient():
    """A circular footprint (mid² = det): autograd must not meet
    sqrt'(0) through the integer radii."""
    d = _train_cloud()
    view, proj = (torch.from_numpy(np.array(x)) for x in _jcam())
    s = torch.from_numpy(d["scales"][-3:-2]).requires_grad_(True)
    ps = gs.project_gaussians(torch.from_numpy(d["means"][-3:-2]), s,
                              torch.from_numpy(d["quats"][-3:-2]),
                              torch.from_numpy(d["opacities"][-3:-2]),
                              torch.from_numpy(d["colors"][-3:-2]), view,
                              proj, RW, RH)
    a, b, c = ps.conic[0].detach()
    assert float(b) == 0 and float(a) == float(c)
    rec = gs._make_records(ps)
    rec.sum().backward()
    assert torch.isfinite(s.grad).all() and float(s.grad.abs().max()) > 0


def test_make_records_carries_gradients():
    ps = gs.ProjectedSplats(*(torch.rand(sh, requires_grad=True) for sh in
                              ((5, 2), (5, 3), (5,))),
                            radius=torch.ones(5, dtype=torch.int32),
                            color=torch.rand(5, 3, requires_grad=True),
                            opacity=torch.rand(5, requires_grad=True),
                            ext=torch.ones(5, 2, dtype=torch.int32))
    w = torch.rand(5, 12)
    (gs._make_records(ps) * w).sum().backward()
    torch.testing.assert_close(ps.mean2d.grad, w[:, 0:2])
    torch.testing.assert_close(ps.conic.grad, w[:, 2:5])
    torch.testing.assert_close(ps.opacity.grad, w[:, 5])
    torch.testing.assert_close(ps.color.grad, w[:, 6:9])
    assert ps.depth.grad is None or (ps.depth.grad == 0).all()


def test_render_diff_matches_jax():
    d = _train_cloud(seed=3, n=24)
    view, proj = _jcam()
    jp = jtrain.params_from_cloud(jgauss.gaussian_cloud(*(d[k]
                                                          for k in FIELDS)))
    target = _ct((RH, RW, 3), 5) * 0.1 + 0.3

    def loss_and_img(p):
        img = jtrain.render_diff(p, view, proj, RW, RH)
        return jnp.mean((img - target) ** 2), img
    (jl, jimg), jg = jax.jit(jax.value_and_grad(loss_and_img,
                                                has_aux=True))(jp)
    jimg = np.asarray(jimg)
    tp = ttrain.params_from_numpy({k: np.asarray(getattr(jp, k))
                                   for k in PFIELDS}, device="cpu")
    v, p = np.asarray(view), np.asarray(proj)
    img = ttrain.render_diff(tp, v, p, RW, RH)
    assert np.abs(img.detach().numpy() - jimg).max() <= 1e-5
    loss = ttrain.l2_loss(tp, v, p, torch.from_numpy(target))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * float(jl)
    for k in PFIELDS:
        g, ref = getattr(tp, k).grad.numpy(), np.asarray(getattr(jg, k))
        assert np.abs(g - ref).max() <= REL * np.abs(ref).max(), k


def test_render_diff_band_matches_jax():
    """A band of rows (``y_offset``, ``full_height``), as the
    data-parallel step grades it, against JAX's ``render_diff``."""
    d = _train_cloud(seed=3, n=24)
    view, proj = _jcam()
    jp = jtrain.params_from_cloud(jgauss.gaussian_cloud(*(d[k]
                                                          for k in FIELDS)))
    band = RH // 2
    want = np.asarray(jtrain.render_diff(jp, view, proj, RW, band,
                                         y_offset=float(band),
                                         full_height=RH))
    tp = ttrain.params_from_numpy({k: np.asarray(getattr(jp, k))
                                   for k in PFIELDS}, device="cpu")
    v, p = np.asarray(view), np.asarray(proj)
    got = ttrain.render_diff(tp, v, p, RW, band, y_offset=float(band),
                             full_height=RH).detach().numpy()
    assert np.abs(got - want).max() <= 1e-5
    full = ttrain.render_diff(tp, v, p, RW, RH).detach().numpy()
    assert np.abs(got - full[band:]).max() <= 1e-6


def test_train_step_pallas_matches_optax():
    """One step's gradients and three steps' losses against the JAX step
    with optax Adam (lr 5e-3)."""
    view, proj = _jcam()
    jt = jtrain.render_diff(jtrain.params_from_cloud(jgauss.random_cloud(
        48, seed=21, extent=0.5, scale_range=(0.05, 0.1))), view, proj,
        RW, RH)
    jp = jtrain.params_from_cloud(jgauss.random_cloud(
        48, seed=22, extent=0.5, scale_range=(0.05, 0.1)))
    numpy_params = {k: np.asarray(getattr(jp, k)) for k in PFIELDS}
    opt = optax.adam(5e-3)
    step = jtrain.make_train_step_pallas(opt, view, proj, interpret=True)
    state, jlosses = opt.init(jp), []
    for i in range(3):
        jp, state, loss = step(jp, state, jt)
        jlosses.append(float(loss))
        if i == 0:   # Adam's first moment after one step is (1 - 0.9)·g
            jgrad = {k: np.asarray(getattr(state[0].mu, k)) / 0.1
                     for k in PFIELDS}

    tp = ttrain.params_from_numpy(numpy_params, device="cpu")
    tstep = ttrain.make_train_step_pallas(ttrain.adam(tp, 5e-3),
                                          np.asarray(view), np.asarray(proj))
    target = torch.from_numpy(np.array(jt))
    losses = [float(tstep(tp, target))]
    for k in PFIELDS:   # the first step's gradients, still on the tensors
        g, ref = getattr(tp, k).grad.numpy(), jgrad[k]
        assert np.isfinite(g).all(), k
        assert np.abs(g - ref).max() <= REL * np.abs(ref).max(), k
    losses += [float(tstep(tp, target)) for _ in range(2)]
    np.testing.assert_allclose(losses, jlosses, rtol=1e-3)
    assert losses[-1] < losses[0]


def test_first_frame_is_the_first_train_step():
    """``gs_trainer.first_frame`` (the frame chip_smoke.py checks K4/K5 on)
    is the plain run's first step: its loss equals the step's MSE through
    ``render_diff_pallas``, and its cotangent is that loss's gradient
    w.r.t. K4's planes."""
    from ray_eater_tpu_torch import gs_trainer
    n, w, h, dev = 600, 96, 64, torch.device("cpu")
    lay, args, (planes, ex, ck, off), dplanes, loss = gs_trainer.first_frame(
        n, w, h, dev)
    view, proj, target, params = gs_trainer.train_setup(n, w, h, dev)
    with torch.no_grad():
        img = ttrain.render_diff_pallas(params, view, proj, w, h)
    assert loss == pytest.approx(float(torch.mean((img - target) ** 2)),
                                 rel=1e-6)
    assert args[0] is lay.records and int(ex.sum()) > 0
    leaf = planes.clone().requires_grad_(True)
    out = gs.finalize_planes(leaf, lay.binned.visited, lay.nty, lay.ntx,
                             (0.0, 0.0, 0.0), lay.tile_w)[:h, :w]
    (g,) = torch.autograd.grad(torch.mean((out - target) ** 2), leaf)
    assert dplanes.shape == planes.shape and torch.equal(dplanes, g)
