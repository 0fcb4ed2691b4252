"""Port vs JAX: adaptive density control (``models/gs_densify.py``) and the
parameter plumbing of ``models/gs_training.py``.

``densify_and_prune`` gets the very normals JAX draws (``noise``), so every
field, ``live`` and the stats are compared: fields within 1e-6 abs (the
child offsets are 3-term rotation products, summed in another order),
``live`` and the counts equal. The ADC step's view-space gradient
statistics are held to JAX's on both renderers within 1e-4 × their largest
value (reassociated sums). No Pallas call is made on the JAX side except
one ADC step through the kernel path (interpret mode, jitted).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_eater_tpu import rmath as jrmath
from ray_eater_tpu.models import gaussians as jgauss
from ray_eater_tpu.models import gs_densify as jd
from ray_eater_tpu.models import gs_training as jtrain
from ray_eater_tpu_torch.models import gaussians
from ray_eater_tpu_torch.models import gs_densify as td
from ray_eater_tpu_torch.models import gs_training as ttrain

torch.set_num_threads(1)

PFIELDS = ("means", "log_scales", "quats", "opacity_logits", "colors")
W, H = 80, 60


def _np(jp):
    return {k: np.asarray(getattr(jp, k)) for k in PFIELDS}


def _port(jp):
    return ttrain.params_from_numpy(_np(jp), device="cpu")


def _jparams(n=6, cap=16, scale=0.05, seed=3):
    cloud = jgauss.random_cloud(n, seed=seed, extent=0.4,
                                scale_range=(scale, scale))
    return jd.pad_params(jtrain.params_from_cloud(cloud), cap)


def _case(name):
    """(JAX params, JAX DensifyState, kwargs) of one densify scenario."""
    cap = 16
    jp = _jparams(n=6, cap=cap)
    logs = jp.log_scales.at[0].set(jnp.log(0.004)).at[1].set(jnp.log(0.5))
    logits = jp.opacity_logits
    accum = jnp.zeros(cap).at[0].set(10.0).at[1].set(20.0).at[3].set(4.0)
    kw = dict(grad_threshold=1.0, scene_extent=1.0, percent_dense=0.01)
    live_n = 6
    if name == "prune":
        logs = logs.at[4].set(jnp.log(5.0))
        logits = logits.at[2].set(-8.0)
        kw.update(prune_opacity=0.005, prune_scale3d=1.0)
    elif name == "full":      # more candidates than dead slots
        live_n = 14
        accum = accum.at[5].set(30.0).at[12].set(9.0)
        jp = jd.pad_params(jtrain.params_from_cloud(jgauss.random_cloud(
            14, seed=4, extent=0.4, scale_range=(0.004, 0.2))), cap)
        logs, logits = jp.log_scales, jp.opacity_logits
    jp = jtrain.GaussianParams(means=jp.means, log_scales=logs,
                               quats=jp.quats, opacity_logits=logits,
                               colors=jp.colors)
    st = jd.DensifyState(live=jnp.arange(cap) < live_n, grad_accum=accum,
                         grad_count=jnp.ones(cap).at[1].set(2.0))
    return jp, st, kw


@pytest.mark.parametrize("name", ["clone_split", "prune", "full"])
def test_densify_and_prune_matches_jax(name):
    jp, jst, kw = _case(name)
    key = jax.random.PRNGKey(7)
    n = jst.live.shape[0]
    noise = (jax.random.normal(key, (n, 3), jnp.float32),
             jax.random.normal(jax.random.fold_in(key, 1), (n, 3),
                               jnp.float32))
    jp2, jst2, jstats = jd.densify_and_prune(jp, jst, key, **kw)

    tp = _port(jp)
    tst = td.DensifyState(live=torch.from_numpy(np.array(jst.live)),
                          grad_accum=torch.from_numpy(np.array(
                              jst.grad_accum)),
                          grad_count=torch.from_numpy(np.array(
                              jst.grad_count)))
    tp2, tst2, tstats = td.densify_and_prune(
        tp, tst, noise=tuple(torch.from_numpy(np.array(x)) for x in noise),
        **kw)
    assert tp2 is tp                       # in place: the optimizer's tensors
    for k in PFIELDS:
        np.testing.assert_allclose(getattr(tp2, k).detach().numpy(),
                                   np.asarray(getattr(jp2, k)), rtol=0,
                                   atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(tst2.live.numpy(), np.asarray(jst2.live))
    for k in ("grad_accum", "grad_count"):
        assert (getattr(tst2, k) == 0).all()
    for k, v in jstats.items():
        assert int(tstats[k]) == int(v), k
    assert int(tstats["n_clone"]) + int(tstats["n_split"]) > 0


def test_densify_draws_from_generator():
    jp, jst, kw = _case("clone_split")
    tst = td.DensifyState(live=torch.from_numpy(np.array(jst.live)),
                          grad_accum=torch.from_numpy(np.array(
                              jst.grad_accum)),
                          grad_count=torch.ones(16))
    outs = []
    for _ in range(2):
        tp = _port(jp)
        g = torch.Generator().manual_seed(3)
        td.densify_and_prune(tp, tst, g, **kw)
        outs.append(tp.means.detach().clone())
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)
    assert not torch.equal(outs[0], torch.from_numpy(np.array(jp.means)))


def test_pad_params_and_reset_opacity_match_jax():
    cloud = jgauss.random_cloud(5, seed=2, extent=0.4,
                                scale_range=(0.05, 0.1))
    jp = jtrain.params_from_cloud(cloud)
    tp = td.pad_params(_port(jp), 12)
    jpp = jd.pad_params(jp, 12)
    for k in PFIELDS:
        t = getattr(tp, k)
        assert t.requires_grad and t.is_leaf, k
        np.testing.assert_array_equal(t.detach().numpy(),
                                      np.asarray(getattr(jpp, k)), k)
    with pytest.raises(ValueError):
        td.pad_params(tp, 4)
    jst = jd.init_densify_state(12, 5)
    tst = td.init_densify_state(12, 5, device="cpu")
    np.testing.assert_array_equal(tst.live.numpy(), np.asarray(jst.live))
    jr = jd.reset_opacity(jpp, jst, max_opacity=0.01)
    td.reset_opacity(tp, tst, max_opacity=0.01)
    np.testing.assert_array_equal(tp.opacity_logits.detach().numpy(),
                                  np.asarray(jr.opacity_logits))


def test_accumulate_grad_stats_matches_jax():
    g = np.random.RandomState(0).standard_normal((16, 2)).astype(np.float32)
    g[3:7] = 0.0
    jst = jd.accumulate_grad_stats(jd.init_densify_state(16, 10),
                                   jnp.asarray(g))
    tst = td.accumulate_grad_stats(td.init_densify_state(16, 10,
                                                         device="cpu"),
                                   torch.from_numpy(g))
    np.testing.assert_allclose(tst.grad_accum.numpy(),
                               np.asarray(jst.grad_accum), rtol=1e-6)
    np.testing.assert_array_equal(tst.grad_count.numpy(),
                                  np.asarray(jst.grad_count))


def test_reset_new_slots_matches_jax():
    jp = _jparams(n=4, cap=8)
    g = {k: np.random.RandomState(i).standard_normal(
        np.asarray(getattr(jp, k)).shape).astype(np.float32)
        for i, k in enumerate(PFIELDS)}
    opt = optax.adam(1e-2)
    jstate = opt.init(jp)
    _, jstate = opt.update(jtrain.GaussianParams(**g), jstate, jp)
    prev = jnp.arange(8) < 4
    live = jnp.arange(8) < 6          # slots 4 and 5 newly allocated
    jstate = jd.reset_new_slots(jstate, prev, live)

    tp = _port(jp)
    topt = ttrain.adam(tp, 1e-2)
    for k in PFIELDS:
        getattr(tp, k).grad = torch.from_numpy(g[k])
    topt.step()
    td.reset_new_slots(topt, torch.from_numpy(np.array(prev)),
                       torch.from_numpy(np.array(live)))
    for k in PFIELDS:
        st = topt.state[getattr(tp, k)]
        for tk, jk in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            ref = np.asarray(getattr(getattr(jstate[0], jk), k))
            np.testing.assert_allclose(st[tk].numpy(), ref, rtol=1e-6,
                                       atol=1e-12, err_msg=(k, tk))
            assert (st[tk][4:6] == 0).all()


def test_params_from_numpy_and_cloud_roundtrip():
    cloud = jgauss.random_cloud(32, seed=0)
    jp = jtrain.params_from_cloud(cloud)
    tp = ttrain.params_from_numpy(_np(jp), device="cpu")
    for k in PFIELDS:
        t = getattr(tp, k)
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        assert t.is_leaf and t.requires_grad
        np.testing.assert_array_equal(t.detach().numpy(),
                                      np.asarray(getattr(jp, k)))
    # params_from_cloud on the same cloud gives JAX's parameters
    tc = gaussians.cloud_from_numpy({k: np.asarray(getattr(cloud, k)) for k in
                                     ("means", "scales", "quats",
                                      "opacities", "colors")}, device="cpu")
    tp2 = ttrain.params_from_cloud(tc)
    for k in PFIELDS:
        np.testing.assert_allclose(getattr(tp2, k).detach().numpy(),
                                   np.asarray(getattr(jp, k)), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    back = ttrain.cloud_from_params(tp)
    np.testing.assert_allclose(back.scales.detach().numpy(),
                               np.asarray(cloud.scales), rtol=1e-5)
    np.testing.assert_allclose(back.opacities.detach().numpy(),
                               np.asarray(cloud.opacities), atol=1e-5)


def _camera():
    return (jrmath.look_at_zforward(jrmath.vec(0.0, 0.2, -2.2),
                                    jrmath.vec(0.0, 0.0, 0.0)),
            jrmath.perspective(jrmath.radians(60.0), W / H, 0.1, 30.0))


@pytest.mark.parametrize("use_pallas", [False, True])
def test_adc_step_grad_stats_match_jax(use_pallas):
    """One ADC step: the view-space gradient statistics and the loss equal
    JAX's; dead slots accumulate nothing."""
    view, proj = _camera()
    jp = _jparams(n=4, cap=16, scale=0.08)
    target = np.random.RandomState(1).rand(H, W, 3).astype(np.float32) * 0.2
    opt = optax.adam(1e-3)
    jstep = jax.jit(jd.make_train_step_adc(opt, W, H, use_pallas=use_pallas,
                                           interpret=True))
    _, _, jst, jloss = jstep(jp, opt.init(jp), jd.init_densify_state(16, 4),
                             jnp.asarray(target), view, proj)

    tp = _port(jp)
    step = td.make_train_step_adc(ttrain.adam(tp, 1e-3), W, H,
                                  use_pallas=use_pallas)
    tst, loss = step(tp, td.init_densify_state(16, 4, device="cpu"),
                     torch.from_numpy(target), np.asarray(view),
                     np.asarray(proj))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    ref = np.asarray(jst.grad_accum)
    acc = tst.grad_accum.numpy()
    assert (acc[:4] > 0).sum() >= 3 and (acc[4:] == 0).all()
    assert np.abs(acc - ref).max() <= 1e-4 * np.abs(ref).max()
    np.testing.assert_array_equal(tst.grad_count.numpy(),
                                  np.asarray(jst.grad_count))


def test_adc_window_cycles_views():
    view, proj = _camera()
    tp = _port(_jparams(n=4, cap=8, scale=0.08))
    views = torch.stack([torch.from_numpy(np.array(view))] * 2)
    targets = torch.zeros((2, H, W, 3))
    window = td.make_train_window_adc(ttrain.adam(tp, 1e-3), W, H, nsteps=3)
    before = tp.means.detach().clone()
    st, loss = window(tp, td.init_densify_state(8, 4, device="cpu"),
                      targets, views, torch.from_numpy(np.array(proj)), 0)
    assert bool(torch.isfinite(loss)) and float(loss) > 0
    assert not torch.equal(before, tp.means.detach())
    assert (st.grad_count[:4] <= 3).all() and (st.grad_count[4:] == 0).all()


def test_gs_trainer_adc_save_ply(tmp_path):
    """``gs_trainer --adc --save-ply``: the live splats, activated, read
    back by ``load_ply`` within 1e-5 (the PLY stores logits and logs,
    inverted in float32), and the first view's PNGs written to --out."""
    from ray_eater_tpu_torch import gs_trainer
    ply, out = tmp_path / "adc.ply", tmp_path / "out"
    argv = ["--adc", "--device", "cpu", "--splats", "64", "--capacity",
            "128", "--views", "2", "--width", "48", "--height", "32",
            "--densify-every", "2", "--steps", "6", "--save-ply", str(ply),
            "--out", str(out)]
    r = gs_trainer.train_adc(gs_trainer.parse_args(argv))
    live = r["live"]
    want = ttrain.cloud_from_params(r["params"])
    got = gaussians.load_ply(str(ply), device="cpu")
    assert got.num_splats == int(live.sum()) == r["n_live"] > 0
    for k in ("means", "scales", "quats", "opacities", "colors"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   getattr(want, k).detach()[live].numpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=k)
    assert gs_trainer.main(argv) == 0
    assert (out / "fitted.png").exists() and (out / "target.png").exists()
