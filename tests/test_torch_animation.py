"""Port vs JAX: ``render_animation`` (``ray_eater_tpu_torch.core.animation``)
on tiny frames of basic_planes, multipass through its ``RenderGraph``,
compute_drawing and the fog cloud with its temporal LOD budget as the
carry, against the JAX package's ``render_animation`` (one jitted scan,
Pallas kernels in interpret mode); the port on the CPU against its own
eager loop; and the entry points' device loop on the CPU.

Each JAX animation is computed once per module. Scenes are built from
numpy data (the port's meshes and textures, handed to both packages).

Tolerances and why:
- Port vs JAX: the u8 frames equal except on at most 0.5% of the pixels,
  and those within 1 code. Inside the jitted scan XLA contracts and fuses
  the float32 arithmetic differently from the eager port (the raster
  setup and planes, ROADMAP queue 3: up to 7.1e-5 on 0.14% of a 120x80
  frame; the splat composite within 6e-6), which can tip a value across a
  rounding boundary of the u8 encode.
- Port on the CPU vs its own eager loop, the frame times against JAX's,
  the final carry against the eager loop's: equal (the same operations).
"""

import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_eater_tpu as jre  # noqa: E402
from ray_eater_tpu import rmath as jrmath  # noqa: E402
from ray_eater_tpu.core import animation as janim  # noqa: E402
from ray_eater_tpu.graph.render_graph import RenderGraph as JGraph  # noqa: E402
from ray_eater_tpu.models import gaussians as jgauss  # noqa: E402
from ray_eater_tpu.ops import gs as jgs  # noqa: E402
from ray_eater_tpu.ops.splat import splat_particles as jsplat  # noqa: E402
from ray_eater_tpu_torch import basic_planes, compute_drawing  # noqa: E402
from ray_eater_tpu_torch import gs_viewer, multipass  # noqa: E402
from ray_eater_tpu_torch import raster_scenes as rs  # noqa: E402
from ray_eater_tpu_torch.core import animation  # noqa: E402
from ray_eater_tpu_torch.core.resources import create_framebuffer  # noqa: E402
from ray_eater_tpu_torch.core.swapchain import encode_present  # noqa: E402
from ray_eater_tpu_torch.models.gaussians import cloud_from_numpy  # noqa: E402

torch.set_num_threads(1)

W, H = 128, 64
FRAMES = 3
DT = 0.25            # a quarter second a frame: the frames differ visibly
OFF_SHARE = 0.005    # pixels allowed to differ, each by one u8 code


def _near(port, jax_frames):
    a = port.numpy().astype(np.int16)
    b = np.asarray(jax_frames).astype(np.int16)
    assert a.shape == b.shape, (a.shape, b.shape)
    d = np.abs(a - b).max(-1)
    assert d.max() <= 1, f"u8 codes differ by {d.max()}"
    assert (d > 0).mean() <= OFF_SHARE, f"{(d > 0).mean():.4%} pixels off"


def _jmesh(m):
    return jre.mesh(m.positions.numpy(), m.indices.numpy(),
                    **{k: v.numpy() for k, v in m.attributes.items()})


def _jtexture():
    return jre.texture_from_array(rs.checker_rgba())


def _juniforms(t, spin):
    return {"model": jrmath.rotate_y(jrmath.identity(),
                                     jrmath.radians(spin) * t),
            "view": jrmath.look_at(jrmath.vec(2.0, 2.0, 2.0),
                                   jrmath.vec(0.0, 0.0, 0.0)),
            "projection": jrmath.perspective(jrmath.radians(45.0), W / H,
                                             0.1, 30.0)}


# ---- the scenes, each as (port frame_fn, carry, srgb, JAX frames) ---------

def _basic_planes():
    sc = rs.scene("basic_planes", "cpu", W, H)
    mesh, tex = _jmesh(sc.mesh), _jtexture()
    pipe = jre.GraphicsPipeline(vertex_fn=jre.shaders.mvp_vertex,
                                fragment_fn=jre.shaders.textured_border_fragment)

    def jframe(t):
        return jre.render_mesh(pipe, mesh, _juniforms(t, 45.0), {"tex": tex},
                               jre.create_framebuffer(W, H), interpret=True)

    return sc.frame, None, True, janim.render_animation(jframe, FRAMES,
                                                        dt=DT)


def _multipass():
    sc = rs.scene("multipass", "cpu", W, H)
    mesh, tex = _jmesh(sc.mesh), _jtexture()
    depth_only = jre.GraphicsPipeline(
        vertex_fn=jre.shaders.mvp_vertex,
        fragment_fn=lambda v, r: jnp.zeros((*v["uv"].shape[:-1], 4),
                                           jnp.float32))
    lit = jre.GraphicsPipeline(
        vertex_fn=jre.shaders.mvp_vertex,
        fragment_fn=jre.shaders.textured_border_fragment,
        state=jre.RasterState(depth_compare=jre.CompareOp.LESS_EQUAL))
    graph = (JGraph("prepass_lit").external("t")
             .add_pass("setup", lambda i: {
                 "fb": jre.create_framebuffer(W, H),
                 "uniforms": _juniforms(i["t"], 30.0)},
                 reads=("t",), writes=("fb", "uniforms"))
             .add_pass("depth_prepass", lambda i: {"fb": jre.render_mesh(
                 depth_only, mesh, i["uniforms"], {}, i["fb"],
                 interpret=True)}, reads=("fb", "uniforms"), writes=("fb",))
             .add_pass("lit", lambda i: {"fb": jre.render_mesh(
                 lit, mesh, i["uniforms"], {"tex": tex}, i["fb"],
                 interpret=True)}, reads=("fb", "uniforms"), writes=("fb",))
             .output("fb").bake())
    frame = multipass.frame_graph(sc)
    want = janim.render_animation(lambda t: graph(t=t)["fb"], FRAMES, dt=DT)
    return (lambda t: frame(t=t)["fb"]), None, True, want


def _compute_drawing():
    d = compute_drawing.setup("cpu", 0, W, H, 12)
    pos = compute_drawing.particle_positions(0, W, H, 12)
    img = jnp.zeros((H, W, 4), jnp.float32).at[..., 3].set(1.0)
    img = jsplat(img, jnp.asarray(pos), compute_drawing.COLOR,
                 compute_drawing.PIXELS_RAD, interpret=True)
    tex = jre.Texture(data=img, sampler=jre.Sampler(
        address_mode=jre.AddressMode.CLAMP_TO_EDGE))
    quad = jre.fullscreen_quad()
    pipe = jre.GraphicsPipeline(
        vertex_fn=jre.shaders.passthrough_vertex,
        fragment_fn=jre.shaders.quad_sample_fragment,
        state=jre.RasterState(depth_test=False, depth_write=False))

    def jframe(t):
        return jre.render_mesh(pipe, quad, {"time": t},
                               {"compute_image": tex},
                               jre.create_framebuffer(W, H), interpret=True)

    return d.frame, None, False, janim.render_animation(
        jframe, FRAMES, dt=DT, srgb=False)


FOG = dict(n=1500, mpt=32, tile_w=32)


def _fog():
    """The fog cloud (``random_cloud``, extent 1, scales 0.004-0.02) along
    gs_viewer's orbit, LOD with the temporal budget as the carry."""
    jc = jgauss.random_cloud(FOG["n"], seed=3, extent=1.0,
                             scale_range=(0.004, 0.02))
    fields = ("means", "scales", "quats", "opacities", "colors")
    cloud = cloud_from_numpy({f: np.asarray(getattr(jc, f)) for f in fields},
                             device="cpu")
    args = gs_viewer.parse_args(
        ["--width", str(W), "--height", str(H), "--max-per-tile",
         str(FOG["mpt"]), "--tile-w", str(FOG["tile_w"]), "--device", "cpu"])
    v = gs_viewer.viewer(args, cloud)
    ntx, nty = jgs.num_tiles(W, H, tile_w=FOG["tile_w"])

    def jframe(t, budget):
        ang = jrmath.radians(30.0) * t
        eye = jnp.stack([jnp.float32(2.5) * jnp.cos(ang), jnp.float32(0.8),
                         jnp.float32(2.5) * jnp.sin(ang)])
        view = jrmath.look_at_zforward(eye, jrmath.vec(0.0, 0.0, 0.0))
        proj = jrmath.perspective(jrmath.radians(60.0), W / H, 0.05, 50.0)
        img, st = jgs.render_gaussians(
            jc, view, proj, W, H, background=(0.0, 0.0, 0.0), cam_pos=eye,
            max_splats_per_tile=FOG["mpt"], pairs_cap_factor=4,
            return_stats=True, lod_budget=budget, tile_w=FOG["tile_w"],
            interpret=True)
        return img, jgs.update_lod_budget(st["tile_exec"], FOG["mpt"], ntx,
                                          nty, st["tile_kept"],
                                          st["tile_count"])

    b0 = jnp.stack([jnp.full((ntx * nty,), FOG["mpt"], jnp.int32),
                    jnp.zeros((ntx * nty,), jnp.int32)], -1)
    want = janim.render_animation(jframe, FRAMES, dt=DT, carry=b0)
    return v.step, v.initial_budget(), True, want


SCENES = {"basic_planes": _basic_planes, "multipass": _multipass,
          "compute_drawing": _compute_drawing, "fog": _fog}


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    return request.param, SCENES[request.param]()


def test_render_animation_matches_jax(scene):
    name, (frame_fn, carry, srgb, want) = scene
    got = animation.render_animation(frame_fn, FRAMES, dt=DT, srgb=srgb,
                                     carry=carry, device="cpu")
    assert got.dtype == torch.uint8
    assert got.shape[:3] == (FRAMES, H, W)
    _near(got, want)
    # the frames move: the animation is not one frame repeated
    if name != "compute_drawing":
        assert not torch.equal(got[0], got[-1])


def test_render_animation_equals_the_eager_loop(scene):
    """On the CPU: bit for bit the frames of a hand-written loop over
    ``frame_fn`` at JAX's frame times, the carry threaded by hand; ``keep``
    ="last" gives the last of them; ``info`` reports the eager path and
    the final carry."""
    name, (frame_fn, carry, srgb, _) = scene
    carry0 = None if carry is None else carry.clone()
    info = {}
    got = animation.render_animation(frame_fn, FRAMES, t0=0.5, dt=DT,
                                     srgb=srgb, carry=carry, device="cpu",
                                     info=info)
    c, frames = carry, []
    for t in animation.frame_times(FRAMES, 0.5, DT):
        t = torch.tensor(t)
        out = frame_fn(t) if c is None else frame_fn(t, c)
        if c is not None:
            out, c = out
        frames.append(animation.encode_frame(out, srgb))
    assert torch.equal(got, torch.stack(frames))
    last = animation.render_animation(frame_fn, FRAMES, t0=0.5, dt=DT,
                                      srgb=srgb, carry=carry, keep="last",
                                      device="cpu")
    assert torch.equal(last, frames[-1])
    assert info["path"] == "eager" and info["launches_per_frame"] is None
    if carry is not None:
        assert torch.equal(info["carry"], c)
        assert not torch.equal(c, carry)    # the budget moved
        assert torch.equal(carry, carry0)   # the caller's carry is kept


def test_frame_times_match_jax_scan():
    for n, t0, dt in ((60, 0.0, 1 / 60), (7, 0.5, 0.25), (3, -1.0, 0.1)):
        ts = janim.render_animation(lambda t: jnp.full((8, 8, 4), t), n,
                                    t0=t0, dt=dt, srgb=False)
        want = np.round(np.clip(np.asarray(animation.frame_times(n, t0, dt)),
                                0.0, 1.0) * 255.0)
        np.testing.assert_array_equal(np.asarray(ts)[:, 0, 0, 0], want)
        np.testing.assert_array_equal(
            animation.frame_times(n, t0, dt),
            t0 + np.arange(n, dtype=np.float32) * np.float32(dt))


def test_animation_argument_errors():
    def frame(t):
        return torch.zeros((8, 8, 4)) + t

    with pytest.raises(ValueError, match="keep"):
        animation.render_animation(frame, 2, keep="some", device="cpu")
    with pytest.raises(ValueError, match="n_frames"):
        animation.render_animation(frame, 0, device="cpu")

    def grows(t, c):
        return frame(t), torch.cat([c, c])

    with pytest.raises(ValueError, match="carry leaf changed"):
        animation.render_animation(grows, 2, carry=torch.zeros(3),
                                   device="cpu")
    with pytest.raises(TypeError, match="carry leaves"):
        animation.render_animation(lambda t, c: (frame(t), c), 2,
                                   carry=[1.0], device="cpu")


def test_carry_may_be_a_structure():
    """A dict/tuple carry is threaded leaf by leaf; a Framebuffer frame is
    cropped to its logical extent."""
    def frame(t, c):
        fb = create_framebuffer(20, 10, clear_color=(0.25, 0.5, 0.75, 1.0),
                                device="cpu")
        return fb, {"n": c["n"] + 1, "s": (c["s"][0] * 2.0,)}

    info = {}
    got = animation.render_animation(
        frame, 4, carry={"n": torch.zeros((), dtype=torch.int32),
                         "s": (torch.ones(2),)}, device="cpu", info=info)
    assert got.shape == (4, 10, 20, 4)
    want = encode_present(create_framebuffer(
        20, 10, clear_color=(0.25, 0.5, 0.75, 1.0), device="cpu").color,
        20, 10)
    assert torch.equal(got[2], want)
    assert int(info["carry"]["n"]) == 4
    assert torch.equal(info["carry"]["s"][0], torch.full((2,), 16.0))


@pytest.mark.parametrize("mod", ["basic_planes", "multipass",
                                 "compute_drawing", "gs_viewer"])
def test_entry_points_default_to_the_device_loop(mod, tmp_path):
    """Each entry point's default path is render_animation (the eager
    steps on the CPU): its last frame is the animation's last frame, and
    its run() says which path it took."""
    m = {"basic_planes": basic_planes, "multipass": multipass,
         "compute_drawing": compute_drawing, "gs_viewer": gs_viewer}[mod]
    argv = ["--frames", "2", "--device", "cpu", "--out", str(tmp_path)]
    if mod != "compute_drawing":
        argv += ["--width", str(W), "--height", str(H)]
    if mod == "gs_viewer":
        argv += ["--splats", "400", "--max-per-tile", "32"]
    args = m.parse_args(argv)
    assert not args.host_loop
    r = m.run(args)
    assert r["path"].startswith("device-loop") and r["frames"] == 2
    if mod == "basic_planes":
        sc = rs.scene("basic_planes", "cpu", W, H)
        want = animation.render_animation(sc.frame, 2, device="cpu")[-1]
    elif mod == "multipass":
        frame = multipass.frame_graph(rs.scene("multipass", "cpu", W, H))
        want = animation.render_animation(lambda t: frame(t=t)["fb"], 2,
                                          device="cpu")[-1]
    elif mod == "compute_drawing":
        d = compute_drawing.setup("cpu", 0)
        want = animation.render_animation(d.frame, 2, srgb=False,
                                          keep="last", device="cpu")
        assert torch.equal(r["u8"], want)
        assert torch.equal(want, encode_present(
            d.image, d.width, d.height, srgb=False))
        return
    else:
        v = gs_viewer.viewer(args)
        want = animation.render_animation(v.step, 2, carry=v.initial_budget(),
                                          device="cpu")[-1]
    np.testing.assert_array_equal(r["last"], want.numpy())
