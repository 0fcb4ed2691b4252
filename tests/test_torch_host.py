"""Port vs JAX: the host runtime — ``graph.render_graph`` (schedules and
validation errors), ``core.swapchain.Swapchain`` (the present ring),
``core.context.Context``, ``utils.profiler``/``utils.validation``/
``utils.logging`` and ``io.obj.load_obj`` — each held to the JAX package
on the same declarations, frames and files, the cases of
``tests/test_graph.py``, ``test_swapchain.py``, ``test_utils.py`` and
``test_obj.py``.

Tolerances: none; schedules, error kinds, presented u8 frames and the
loaded OBJ arrays are equal (the same integer and float32 operations).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_eater_tpu as jre  # noqa: E402
from ray_eater_tpu.graph import render_graph as jgraph  # noqa: E402
from ray_eater_tpu.io.obj import load_obj as jload_obj  # noqa: E402
from ray_eater_tpu.utils import logging as jlogging  # noqa: E402
from ray_eater_tpu.utils import validation as jvalid  # noqa: E402
from ray_eater_tpu_torch import multipass  # noqa: E402
from ray_eater_tpu_torch.core.animation import GraphCaptureError  # noqa: E402
from ray_eater_tpu_torch.core.context import Context, ContextConfig  # noqa: E402
from ray_eater_tpu_torch.core.resources import (Framebuffer,  # noqa: E402
                                                create_framebuffer)
from ray_eater_tpu_torch.core.swapchain import (Swapchain,  # noqa: E402
                                                encode_present)
from ray_eater_tpu_torch.graph import render_graph as tgraph  # noqa: E402
from ray_eater_tpu_torch.io.obj import load_obj  # noqa: E402
from ray_eater_tpu_torch.utils import logging as tlogging  # noqa: E402
from ray_eater_tpu_torch.utils import on_device  # noqa: E402
from ray_eater_tpu_torch.utils import profiler, validation  # noqa: E402

torch.set_num_threads(1)


# ---- render graph ---------------------------------------------------------

def _add(k):
    return lambda i: {"y": i["x"] + k}


def _declare(g, case):
    """The declarations of ``case`` on a RenderGraph of either package;
    passes use only + and *, so they run on jnp and torch scalars."""
    if case == "out_of_order":
        g.external("x")
        g.add_pass("b", lambda i: {"z": i["y"] + 1}, reads=("y",),
                   writes=("z",))
        g.add_pass("a", lambda i: {"y": i["x"] * 2}, reads=("x",),
                   writes=("y",))
        g.output("z")
    elif case == "waw":
        g.external("fb")
        g.add_pass("first", lambda i: {"fb": i["fb"] + 1}, reads=("fb",),
                   writes=("fb",))
        g.add_pass("second", lambda i: {"fb": i["fb"] * 10}, reads=("fb",),
                   writes=("fb",))
        g.output("fb")
    elif case == "war_and_chain":
        g.external("x", "u")
        g.add_pass("read_x", lambda i: {"r": i["x"] * 3}, reads=("x",),
                   writes=("r",))
        g.add_pass("write_x", lambda i: {"x": i["u"] + 5}, reads=("u",),
                   writes=("x",))
        g.add_pass("sum", lambda i: {"s": i["r"] + i["x"] + i["t"]},
                   reads=("r", "x", "t"), writes=("s",))
        g.add_pass("t", lambda i: {"t": i["u"] * 7}, reads=("u",),
                   writes=("t",))
        g.output("s", "r")
    elif case == "default_outputs":
        g.external("x")
        g.add_pass("p", lambda i: {"b": i["x"] + 1, "a": i["x"] * 4},
                   reads=("x",), writes=("b", "a"))
    elif case == "cycle":
        g.add_pass("a", lambda i: {"y": i["z"]}, reads=("z",), writes=("y",))
        g.add_pass("b", lambda i: {"z": i["y"]}, reads=("y",), writes=("z",))
    elif case == "undefined":
        g.add_pass("p", lambda i: {"y": i["ghost"]}, reads=("ghost",),
                   writes=("y",))
    elif case == "ambiguous":
        g.external("x")
        g.add_pass("reader", lambda i: {"z": i["y"]}, reads=("y",),
                   writes=("z",))
        g.add_pass("w1", _add(1), reads=("x",), writes=("y",))
        g.add_pass("w2", _add(2), reads=("x",), writes=("y",))
    elif case == "never_produced":
        g.external("x")
        g.add_pass("p", _add(1), reads=("x",), writes=("y",))
        g.output("q")
    elif case == "no_passes":
        g.external("x")
    return g


GRAPH_CASES = {"out_of_order": None, "waw": None, "war_and_chain": None,
               "default_outputs": None, "cycle": "cycle",
               "undefined": "undefined resource", "ambiguous": "ambiguous",
               "never_produced": "never produced", "no_passes": "no passes"}


@pytest.mark.parametrize("case", list(GRAPH_CASES))
def test_render_graph_schedules_and_errors_match_jax(case):
    err = GRAPH_CASES[case]
    jg = _declare(jgraph.RenderGraph(case), case)
    tg = _declare(tgraph.RenderGraph(case), case)
    if err is not None:
        with pytest.raises(jgraph.GraphValidationError, match=err):
            jg.bake(jit=False)
        with pytest.raises(tgraph.GraphValidationError, match=err):
            tg.bake()
        return
    jp, tp = jg.bake(jit=False), tg.bake()
    assert tp.pass_names == jp.pass_names
    assert tp.outputs == jp.outputs and tp.externals == jp.externals
    env = {e: 1.5 + k for k, e in enumerate(tp.externals)}
    jout = jp(**{k: jnp.float32(v) for k, v in env.items()})
    tout = tp(**{k: torch.tensor(v) for k, v in env.items()})
    assert set(tout) == set(jout)
    for k in tout:
        assert float(tout[k]) == float(jout[k]), k
    # jit changes nothing on the port: capture is render_animation's job
    jitted = _declare(tgraph.RenderGraph(case), case).bake(jit=True)
    assert jitted.pass_names == tp.pass_names
    again = jitted(**{k: torch.tensor(v) for k, v in env.items()})
    assert all(torch.equal(again[k], tout[k]) for k in tout)


@pytest.mark.parametrize("pkg", [jgraph, tgraph])
def test_render_graph_build_and_call_errors(pkg):
    g = pkg.RenderGraph().external("x")
    g.add_pass("p", lambda i: {"y": 0}, reads=("x",), writes=("y",))
    with pytest.raises(pkg.GraphValidationError, match="duplicate"):
        g.add_pass("p", lambda i: {"z": 0}, reads=("x",), writes=("z",))
    with pytest.raises(pkg.GraphValidationError, match="writes nothing"):
        g.add_pass("q", lambda i: {}, reads=("x",))
    bad = (pkg.RenderGraph().external("x")
           .add_pass("p", lambda i: {"wrong": 1}, reads=("x",),
                     writes=("y",)).output("y").bake(jit=False))
    with pytest.raises(pkg.GraphValidationError, match="must return dict"):
        bad(x=1)
    prog = (pkg.RenderGraph().external("x")
            .add_pass("p", lambda i: {"y": i["x"]}, reads=("x",),
                      writes=("y",)).bake(jit=False))
    with pytest.raises(pkg.GraphValidationError, match="missing external"):
        prog()
    g2 = (pkg.RenderGraph("bad").external("x")
          .add_pass("p", lambda i: {"y": i["x"]}, reads=("x",),
                    writes=("y",)))
    with pytest.raises(pkg.GraphValidationError, match="donate"):
        g2.bake(donate=("ghost",))
    assert g2.bake(jit=False, donate=("x",)).donated == ["x"]


def test_baked_frame_serialization_is_queued(tmp_path):
    """Once queued, now ported: the frame bakes, saves and loads
    (tests/test_torch_baked.py holds baked frames to the unbaked ones)."""
    prog = (tgraph.RenderGraph("ser").external("x")
            .add_pass("p", lambda i: {"y": i["x"] * 3.0}, reads=("x",),
                      writes=("y",)).output("y").bake())
    path = str(tmp_path / "frame.bin")
    prog.save_baked(path, x=torch.zeros(8))
    out = tgraph.load_baked(path)(x=torch.full((8,), 2.0))
    assert torch.equal(out["y"], torch.full((8,), 6.0))


def test_multipass_frame_graph_schedule_matches_the_sample():
    """The port's multipass frame is the sample's three-pass graph."""
    from ray_eater_tpu_torch import raster_scenes as rs
    frame = multipass.frame_graph(rs.scene("multipass", "cpu", 64, 32))
    assert frame.pass_names == ["setup", "depth_prepass", "lit"]
    assert frame.externals == ["t"] and frame.outputs == ["fb"]
    fb = frame(t=torch.tensor(0.25))["fb"]
    want = rs.scene("multipass", "cpu", 64, 32).frame(torch.tensor(0.25))
    assert torch.equal(fb.color, want.color)
    assert torch.equal(fb.depth, want.depth)


# ---- swapchain and context ------------------------------------------------

def _fbs(w, h, levels):
    """Framebuffers of both packages cleared to red ``levels``."""
    return ([jre.create_framebuffer(w, h, clear_color=(v, 0, 0, 1))
             for v in levels],
            [create_framebuffer(w, h, clear_color=(v, 0, 0, 1),
                                device="cpu") for v in levels])


def _cpu_ctx():
    return Context(ContextConfig(platform="cpu"))


@pytest.mark.parametrize("count", [1, 2, 3, 5])
def test_ring_warmup_drain_and_fifo_match_jax(count):
    levels = [(k + 1) / 8.0 for k in range(6)]
    jfb, tfb = _fbs(64, 32, levels)
    jsc = jre.Swapchain(jre.Context(), 64, 32, image_count=count)
    tsc = Swapchain(_cpu_ctx(), 64, 32, image_count=count)
    assert tsc.image_count == jsc.image_count == max(2, count)
    jouts = [jsc.present(f) for f in jfb]
    touts = [tsc.present(f) for f in tfb]
    assert [o is None for o in touts] == [o is None for o in jouts]
    assert touts[:tsc.image_count - 1] == [None] * (tsc.image_count - 1)
    jtail, ttail = list(jsc.drain()), list(tsc.drain())
    assert len(ttail) == len(jtail) == tsc.image_count - 1
    got = [o for o in touts if o is not None] + ttail
    want = [o for o in jouts if o is not None] + jtail
    assert len(got) == len(levels)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    reds = [int(img[0, 0, 0]) for img in got]
    assert reds == sorted(reds) and len(set(reds)) == len(levels)   # FIFO
    assert tsc.frames_presented == jsc.frames_presented == len(levels)
    assert tsc.fps > 0


def test_present_encoded_fused_path_matches_jax():
    tsc = Swapchain(_cpu_ctx(), 64, 32, image_count=2)
    jsc = jre.Swapchain(jre.Context(), 64, 32, image_count=2)

    def frame(k, lib):
        if lib is torch:
            return encode_present(torch.full((32, 64, 4), k / 4.0), 64, 32)
        from ray_eater_tpu.core.swapchain import encode_present as jenc
        return jenc(jnp.full((32, 64, 4), k / 4.0, jnp.float32), 64, 32)

    touts = [tsc.present_encoded(frame(k, torch)) for k in range(4)]
    jouts = [jsc.present_encoded(frame(k, jnp)) for k in range(4)]
    assert touts[0] is None and all(o is not None for o in touts[1:])
    for t, j in zip(touts[1:], jouts[1:]):
        np.testing.assert_array_equal(t, j)
    assert len(list(tsc.drain())) == 1 and tsc.frames_presented == 4
    with pytest.raises(ValueError, match="uint8"):
        tsc.present_encoded(torch.zeros((32, 64, 4)))


def test_resize_returns_a_fresh_ring():
    sc = Swapchain(_cpu_ctx(), 64, 32)
    sc.present(create_framebuffer(64, 32, device="cpu"))
    sc2 = sc.resize(128, 64)
    assert (sc2.width, sc2.height) == (128, 64)
    assert list(sc.drain()) == []
    fb = create_framebuffer(128, 64, clear_color=(0, 1, 0, 1), device="cpu")
    out = None
    for _ in range(sc2.image_count):
        out = sc2.present(fb)
    assert out is not None and out.shape == (64, 128, 4)
    np.testing.assert_array_equal(out[0, 0], [0, 255, 0, 255])


def test_context_config_not_mutated():
    cfg = ContextConfig(platform="cpu", compile_cache_dir=None)
    assert cfg.interpret is None
    ctx = Context(cfg)
    assert cfg.interpret is None                # the caller's object
    assert ctx.config.interpret is True         # the resolved copy
    assert ctx.device == torch.device("cpu") and ctx.interpret
    assert Context(ContextConfig(platform="cpu", interpret=False)).interpret \
        is False
    with pytest.raises(ValueError, match="platform"):
        Context(ContextConfig(platform="tpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Context()


@pytest.mark.parametrize("transient", [torch.AcceleratorError, OSError])
def test_context_submit_retries(transient):
    ctx = _cpu_ctx()
    calls = []

    def flaky(x):
        calls.append(1)
        if len(calls) == 1:
            raise transient("transient")
        return x + 1

    assert ctx.submit(flaky, 1) == 2 and len(calls) == 2

    def dead(x):
        raise transient("permanent")

    with pytest.raises(transient):
        ctx.submit(dead, 1)

    # programming errors, RuntimeErrors of the port's own among them, are
    # not retried
    for err in (KeyError, GraphCaptureError, tgraph.GraphValidationError):
        def bug(x):
            calls.append(1)
            raise err("not retried")

        calls.clear()
        with pytest.raises(err):
            ctx.submit(bug, 1)
        assert len(calls) == 1
    assert ctx.compile("k", lambda: flaky) is ctx.compile("k", lambda: dead)
    ctx.wait_idle()


# ---- utils ----------------------------------------------------------------

def test_frame_stats():
    fs = profiler.FrameStats()
    assert profiler.FrameStats().summary() == {"frames": 0, "fps": 0.0}
    for _ in range(5):
        fs.tick()
    s = fs.summary()
    assert s["frames"] == 5 and s["fps"] > 0 and set(s) == {
        "frames", "fps", "p50_ms", "p99_ms"}


def test_stage_timer_report():
    st = profiler.StageTimer()
    with st.stage("a") as out:
        out.append(torch.ones((8, 8)) * 2)
    with st.stage("b", fence={"fb": create_framebuffer(8, 8, device="cpu")}):
        pass
    rep = st.report()
    assert "a" in rep and "b" in rep and "ms/call" in rep
    assert st.counts == {"a": 1, "b": 1}


def test_annotate_and_trace(tmp_path):
    with profiler.trace(str(tmp_path)) as prof:
        with profiler.annotate("test_pass"):
            x = torch.ones(4) + 1
    assert float(x[0]) == 2.0
    assert any(e.name == "test_pass" for e in prof.events())
    assert (tmp_path / "trace.json").stat().st_size > 0


def test_check_finite_raises_on_nan():
    validation.check_finite("ok", torch.ones(3), {"a": [torch.ones(2)]},
                            torch.arange(3))
    for bad in (torch.tensor([1.0, float("nan")]),
                {"fb": create_framebuffer(8, 8, clear_color=(
                    float("inf"), 0, 0, 1), device="cpu")}):
        with pytest.raises(validation.ValidationError, match="NaN"):
            validation.check_finite("bad", bad)
    with pytest.raises(jvalid.ValidationError, match="NaN"):
        jvalid.check_finite("bad", jnp.array([1.0, jnp.nan]))


def test_check_framebuffer_matches_jax():
    fb = create_framebuffer(64, 32, device="cpu")
    jfb = jre.create_framebuffer(64, 32)
    validation.check_framebuffer(fb, width=64, height=32)
    cases = [
        (dict(width=128), "width"), (dict(height=16), "height")]
    for kw, msg in cases:
        for check, f in ((validation.check_framebuffer, fb),
                         (jvalid.check_framebuffer, jfb)):
            with pytest.raises(RuntimeError, match=msg):
                check(f, **kw)
    bad = Framebuffer(color=fb.color, depth=fb.depth[:-1], width=64,
                      height=32)
    jbad = jre.Framebuffer(color=jfb.color, depth=jfb.depth[:-1], width=64,
                           height=32)
    with pytest.raises(validation.ValidationError, match="mismatch"):
        validation.check_framebuffer(bad)
    with pytest.raises(jvalid.ValidationError, match="mismatch"):
        jvalid.check_framebuffer(jbad)
    with pytest.raises(validation.ValidationError, match="float32"):
        validation.check_framebuffer(Framebuffer(
            color=fb.color.double(), depth=fb.depth.double(), width=64,
            height=32))
    with pytest.raises(validation.ValidationError, match=r"\(H, W, 4\)"):
        validation.check_framebuffer(Framebuffer(
            color=fb.color[..., :3], depth=fb.depth, width=64, height=32))


def test_checked_pass_wraps():
    good = validation.checked_pass("p", lambda i: {"y": i["x"] + 1})
    assert float(good({"x": torch.tensor(1.0)})["y"]) == 2.0
    bad = validation.checked_pass("p", lambda i: {"y": i["x"] * float("nan")})
    with pytest.raises(validation.ValidationError):
        bad({"x": torch.tensor(1.0)})


def test_nan_debugging_toggles_anomaly_detection():
    try:
        validation.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        validation.enable_nan_debugging(False)
    assert not torch.is_anomaly_enabled()


def test_scoped_loggers_match_jax():
    for name in ("graph", "swapchain", "io", "animation"):
        assert tlogging.scoped(name).name == jlogging.scoped(name).name
    assert set(jlogging.SCOPES) <= set(tlogging.SCOPES)
    tlogging.configure()
    tlogging.configure("not-a-level")          # a second call is a no-op
    assert len(tlogging.logging.getLogger("rayeater").handlers) >= 1


@pytest.mark.parametrize("values", [0.8, -1.0 / 3.0, [0.0, -1.0, 0.0],
                                    [[0.0, 0.0, 0.0, 1.0]], [7, 1e-30, 3.3]])
def test_on_device_equals_torch_tensor(values):
    got = on_device(values, "cpu")
    want = torch.tensor(values, dtype=torch.float32)
    assert got.dtype == torch.float32 and torch.equal(got, want)


# ---- OBJ ------------------------------------------------------------------

CUBE_OBJ = """# unit quad + tri, mixed face forms
v -1.0 -1.0 0.5
v  1.0 -1.0 0.5
v  1.0  1.0 0.5
v -1.0  1.0 0.5 1.0 0.0 0.0
vt 0.0 0.0
vt 1.0 0.0
vt 1.0 1.0
vt 0.0 1.0
f 1/1 2/2 3/3 4/4
f 1//  3// 2//
f -4/-4 -3/-3 -2/-2
"""


def test_load_obj_matches_jax(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(CUBE_OBJ)
    j, t = jload_obj(str(p)), load_obj(str(p), device="cpu")
    assert t.num_triangles == j.num_triangles == 4
    np.testing.assert_array_equal(t.positions.numpy(),
                                  np.asarray(j.positions))
    np.testing.assert_array_equal(t.indices.numpy(), np.asarray(j.indices))
    assert set(t.attributes) == set(j.attributes) == {"color", "uv"}
    for k in t.attributes:
        np.testing.assert_array_equal(t.attributes[k].numpy(),
                                      np.asarray(j.attributes[k]))
    empty = tmp_path / "empty.obj"
    empty.write_text("v 0 0 0\n")
    for fn in (jload_obj, lambda f: load_obj(f, device="cpu")):
        with pytest.raises(ValueError, match="no faces"):
            fn(str(empty))


def test_multipass_renders_an_obj(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(CUBE_OBJ)
    args = multipass.parse_args(["--obj", str(p), "--frames", "1",
                                 "--width", "64", "--height", "32",
                                 "--device", "cpu", "--out", str(tmp_path)])
    r = multipass.run(args)
    assert r["triangles"] == 4 and r["last"].shape == (32, 64, 4)
