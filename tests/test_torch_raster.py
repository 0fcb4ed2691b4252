"""Port vs JAX: the triangle raster path (``ray_eater_tpu_torch.ops.raster``
with the plain versions of K6, K7 and K8, ``core.pipeline``,
``core.shaders``, ``models.mesh``) and ``render_mesh`` end to end.

The JAX side runs its Pallas kernels in interpret mode, as
``tests/test_raster.py`` does; every JAX result is computed once per
module. Scenes are built from numpy data and handed to both packages.

Tolerances and why:
- ``_clip_near``/``_triangle_setup``: the same float32 operations in the
  same order, compared at rtol 1e-6 (plane coefficients: atol 1e-4 on
  values up to ~1e3, the rounding of their differences).
- The fold (K6/K7 plain against the Pallas calls on the JAX setup): XLA
  contracts ``a*px + b*py`` into an FMA inside the interpreted kernel
  (``fma(a, px, b*py) + c``, checked on this machine), the port rounds
  each operation as the CUDA kernel does. Winner ids must be equal except
  at knife-edge pixels — where a λ or z of either winner is within 1e-5 of
  its test or the two winners' depths are within 1e-5 — and those must be
  under 0.5% of the pixels; λ0, λ1 and depth within 1e-5 where ids agree.
- Binning: sort keys, packed rows, visited tiles, row ranges and
  ``overflow_big`` equal. K8's fetched features equal where ids agree.
- The deferred shade on the JAX G-buffer: colour within 2e-5 (the sRGB
  decode's ``pow`` may differ by an ulp), depth equal.
- ``render_mesh``: ids equal outside knife-edge pixels (< 0.5%); depth
  within 1e-5 where ids agree; colour within 2e-5 there except on at
  most 0.5% of the frame's pixels, and within 5e-4 on all: the FMA above
  moves λ, and with it uv, by up to ~5e-7, which a checker edge (one
  texel of the 256-texel texture spans the whole colour step) scales by
  up to ~256 (measured: 1.7% of the covered pixels of basic_planes, max
  7.1e-5).
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_eater_tpu as jre  # noqa: E402
from ray_eater_tpu import rmath as jrmath  # noqa: E402
from ray_eater_tpu.core import pipeline as jpipe  # noqa: E402
from ray_eater_tpu.core import resources as jres  # noqa: E402
from ray_eater_tpu.core import shaders as jshaders  # noqa: E402
from ray_eater_tpu.ops import raster as jras  # noqa: E402
from ray_eater_tpu_torch import raster_scenes  # noqa: E402
from ray_eater_tpu_torch.core import pipeline as tpipe  # noqa: E402
from ray_eater_tpu_torch.core import resources as tres  # noqa: E402
from ray_eater_tpu_torch.core import shaders as tshaders  # noqa: E402
from ray_eater_tpu_torch.models import mesh as tmesh  # noqa: E402
from ray_eater_tpu_torch.ops import raster  # noqa: E402

torch.set_num_threads(1)

W, H = 120, 80
EDGE = 1e-5           # knife-edge distance of a λ or z from its test
EDGE_SHARE = 0.005    # knife-edge pixels allowed, as a share of the frame


def T(a):
    return torch.from_numpy(np.array(a))


def N(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ---- scenes, as numpy arrays for both packages ---------------------------

def _arrays(m: tmesh.Mesh) -> dict:
    return dict(pos=m.positions.numpy(), idx=m.indices.numpy(),
                **{k: v.numpy() for k, v in m.attributes.items()})


def _scene_arrays(name: str) -> dict:
    if name == "two_planes":
        return _arrays(tmesh.two_planes(device="cpu"))
    if name == "multipass":
        return _arrays(raster_scenes.quad_grid_mesh(4, device="cpu"))
    return _arrays(raster_scenes.grid_mesh(12, 9, 0.9, 0.1, device="cpu"))


def _jmesh(a: dict):
    return jre.mesh(a["pos"], a["idx"], color=a["color"], uv=a["uv"])


def _tmesh(a: dict):
    return tmesh.mesh(a["pos"], a["idx"], device="cpu", color=a["color"],
                      uv=a["uv"])


def _juniforms(t, w=W, h=H):
    return {"model": jrmath.rotate_y(jrmath.identity(),
                                     jrmath.radians(45.0) * t),
            "view": jrmath.look_at(jrmath.vec(2., 2., 2.),
                                   jrmath.vec(0., 0., 0.)),
            "projection": jrmath.perspective(jrmath.radians(45.0), w / h,
                                             0.1, 30.0)}


def _jstate(cull="back", **kw):
    cm = {"back": jpipe.CullMode.BACK, "none": jpipe.CullMode.NONE,
          "front": jpipe.CullMode.FRONT}[cull]
    return jpipe.RasterState(cull_mode=cm, **kw)


def _tstate(cull="back", **kw):
    cm = {"back": tpipe.CullMode.BACK, "none": tpipe.CullMode.NONE,
          "front": tpipe.CullMode.FRONT}[cull]
    return tpipe.RasterState(cull_mode=cm, **kw)


# The fold and binning references run jitted (one compile each instead of
# one per eager op; any setup serves, both sides get the same). The vertex
# stage and render_mesh run eagerly, as the JAX package's own tests run
# them: XLA's fusion under jit rounds the setup differently (~2e-5
# relative), while eager JAX and the port round it identically.
_j_bin = jax.jit(jras._bin_triangles, static_argnums=(1, 2))
_j_raster = jax.jit(jras._raster_call, static_argnums=(2, 3, 4, 5, 6),
                    static_argnames=("less_equal", "static_test", "n_tris"))
_j_raster_binned = jax.jit(jras._raster_call_binned,
                           static_argnums=(2, 3, 4, 5, 6))
_j_vertex = jax.jit(jshaders.mvp_vertex)
_j_setup = jax.jit(jras._triangle_setup, static_argnums=(2, 3, 4))


def _jsetup(name, cull, w=W, h=H, t=0.3, jit=True):
    """The JAX package's setup of a scene (numpy arrays)."""
    m = _jmesh(_scene_arrays(name))
    vertex = _j_vertex if jit else jshaders.mvp_vertex
    setup = _j_setup if jit else jras._triangle_setup
    clip, vary = vertex(m.positions, m.attributes, _juniforms(t, w, h))
    s, inv_w, z, bm = setup(clip, m.indices, _jstate(cull), w, h)
    return m, vary, np.asarray(s), np.asarray(inv_w), np.asarray(z), bm


# ---- knife edges ----------------------------------------------------------

def _planes_at(setup, col, px, py):
    """float64 (λ0, λ1, z) of setup columns ``col`` at pixel centres."""
    s = np.asarray(setup, np.float64)[:, col]
    lam0 = s[0] * px + s[1] * py + s[2]
    lam1 = s[3] * px + s[4] * py + s[5]
    z = s[6] * px + s[7] * py + s[8]
    return lam0, lam1, z


def _knife(setup, ids_a, ids_b):
    """Pixels whose winner ids (setup columns) differ, and whether each is
    a knife edge: a λ0, λ1, λ2, z or 1 - z of either winner within EDGE of
    zero, or the two winners' depths within EDGE."""
    diff = ids_a != ids_b
    ys, xs = np.nonzero(diff)
    px, py = xs + 0.5, ys + 0.5
    near = np.zeros(len(ys), bool)
    zs = []
    for ids in (ids_a, ids_b):
        c = ids[ys, xs]
        ok = c >= 0
        l0, l1, z = _planes_at(setup, np.maximum(c, 0), px, py)
        m = np.min(np.abs([l0, l1, 1 - l0 - l1, z, 1 - z]), 0) < EDGE
        near |= ok & m
        zs.append(np.where(ok, z, np.inf))
    near |= np.abs(zs[0] - zs[1]) < EDGE
    return diff, near


def _assert_ids(setup, ids_jax, ids_port):
    diff, near = _knife(setup, ids_jax, ids_port)
    assert near.all(), (
        f"{int((~near).sum())} pixels change winner away from any edge")
    assert diff.mean() < EDGE_SHARE, f"{diff.mean():.4%} knife-edge pixels"
    return ~diff


# ---- vertex stage ---------------------------------------------------------

def _straddling_clip(seed=4, n=48):
    """Clip-space triangles, many straddling the near plane z = 0 (the
    one-inside and two-inside cases), some behind it entirely."""
    rng = np.random.RandomState(seed)
    w = rng.uniform(0.05, 3.0, (n, 3))
    xy = rng.uniform(-1.5, 1.5, (n, 3, 2)) * w[..., None]
    z = rng.uniform(-1.0, 2.0, (n, 3))
    return np.concatenate([xy, z[..., None], w[..., None]], -1).astype(
        np.float32)


def test_clip_near_matches_jax():
    tc = _straddling_clip()
    jt, jb, jv = jras._clip_near(jnp.asarray(tc))
    tt, tb, tv = raster._clip_near(T(tc))
    counts = (tc[..., 2] >= 0).sum(-1)
    assert {1, 2, 3} <= set(counts.tolist())
    np.testing.assert_array_equal(N(tv), np.asarray(jv))
    np.testing.assert_allclose(N(tt), np.asarray(jt), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(N(tb), np.asarray(jb), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("cull,front", [("back", "cw"), ("front", "cw"),
                                        ("none", "cw"), ("back", "ccw")])
def test_triangle_setup_matches_jax(cull, front):
    tc = _straddling_clip(seed=5).reshape(-1, 4)
    idx = np.arange(tc.shape[0]).reshape(-1, 3)
    ff = {"cw": "CLOCKWISE", "ccw": "COUNTER_CLOCKWISE"}[front]
    js = _jstate(cull, front_face=getattr(jpipe.FrontFace, ff))
    ts = _tstate(cull, front_face=getattr(tpipe.FrontFace, ff))
    jo = jras._triangle_setup(jnp.asarray(tc), jnp.asarray(idx), js, W, H)
    to = raster._triangle_setup(T(tc), T(idx).long(), ts, W, H)
    js_, ts_ = np.asarray(jo[0]), N(to[0])
    valid = js_[raster._VALID] > 0.5
    assert 0 < valid.sum() < tc.shape[0] // 3 * 2
    np.testing.assert_array_equal(ts_[:, valid], js_[:, valid])
    np.testing.assert_array_equal(ts_[raster._VALID], js_[raster._VALID])
    for a, b in zip(to[1:], jo[1:]):
        np.testing.assert_array_equal(N(a), np.asarray(b))


def test_vertex_stage_matches_jax():
    """mvp_vertex + setup + the clipped-corner varyings of a frame."""
    a = _scene_arrays("two_planes")
    jm, jvary, js, jiw, jz, jbm = _jsetup("two_planes", "back", jit=False)
    pipe = tpipe.GraphicsPipeline(vertex_fn=tshaders.mvp_vertex,
                                  fragment_fn=tshaders.textured_border_fragment)
    fb = tres.create_framebuffer(W, H, device="cpu")
    ds = raster._vertex_stage(pipe, _tmesh(a),
                              raster_scenes.frame_uniforms(
                                  0.3, W / H, device="cpu"), fb)
    valid = js[raster._VALID] > 0.5
    np.testing.assert_allclose(N(ds.setup)[:, valid], js[:, valid],
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(N(ds.inv_w), jiw, rtol=1e-6)
    np.testing.assert_allclose(N(ds.z_tri), jz, rtol=1e-6, atol=1e-7)
    idx = np.asarray(jm.indices)
    for name, tv in ds.tri_vary.items():
        v = np.asarray(jvary[name])[idx]
        v2 = np.concatenate([v, v], 0)
        want = np.einsum("tij,tjk->tik", np.asarray(jbm), v2)
        np.testing.assert_allclose(N(tv), want, rtol=1e-5, atol=1e-6)


# ---- binning --------------------------------------------------------------

def _jax_row_ranges(steps, ntiles):
    """Per-tile [begin, end) packed rows from the JAX step tuple."""
    st, _, blk, lo, hi = (np.asarray(s) for s in steps)
    begin = np.full(ntiles, -1)
    end = np.full(ntiles, -1)
    count = np.zeros(ntiles, int)
    for t, b, l, h in zip(st, blk, lo, hi):
        if t >= ntiles or h <= l:
            continue
        r0, r1 = b * raster.CHUNK + l, b * raster.CHUNK + h
        begin[t] = r0 if begin[t] < 0 else min(begin[t], r0)
        end[t] = max(end[t], r1)
        count[t] += h - l
    return begin, end, count


@pytest.mark.parametrize("case", ["grid12", "multipass_big_overflow"])
def test_bin_triangles_matches_jax(case, monkeypatch):
    """The grid at 120x80 (all 2x2-fan triangles), and the multipass quads
    at 1920x1080 with the big-triangle budget cut to 8 on both sides so
    that the all-tiles fan overflows."""
    if case == "grid12":
        name, w, h, cull = "grid12", W, H, "none"
    else:
        name, w, h, cull = "multipass", 1920, 1080, "back"
        monkeypatch.setattr(jras, "_BIG_TRI_CAP", 8)
        monkeypatch.setattr(raster, "_BIG_TRI_CAP", 8)
    s = _jsetup(name, cull, w, h)[2]
    ntx, nty = -(-w // raster.TILE_W), -(-h // raster.TILE_H)
    feat = np.random.RandomState(2).rand(s.shape[1] // 2, 7).astype(
        np.float32)
    jp, jf, jsteps, jvis, jov = _j_bin(jnp.asarray(s), ntx, nty,
                                       feat=jnp.asarray(feat))
    b = raster._bin_triangles(T(s), ntx, nty, feat=T(feat))
    np.testing.assert_array_equal(N(b.pack), np.asarray(jp))
    np.testing.assert_array_equal(N(b.fpack), np.asarray(jf))
    np.testing.assert_array_equal(N(b.visited), np.asarray(jvis))
    assert int(b.overflow_big) == int(jov)
    if case != "grid12":
        assert int(jov) > 0
    begin, end, count = _jax_row_ranges(jsteps, ntx * nty)
    vis = N(b.visited)
    np.testing.assert_array_equal(N(b.row_begin)[vis], begin[vis])
    np.testing.assert_array_equal(N(b.row_end)[vis], end[vis])
    np.testing.assert_array_equal(end[vis] - begin[vis], count[vis])
    # sorted keys: tile in the high bits, setup column (= GID) in the low
    idb = max(s.shape[1] - 1, 1).bit_length()
    keys = N(b.sorted_key)
    live = keys < (ntx * nty) << idb
    np.testing.assert_array_equal(keys[live] & ((1 << idb) - 1),
                                  np.asarray(jp)[live, raster._GID])
    assert (np.diff(keys) > 0)[live[1:]].all()


# ---- the fold: K6 and K7/K8 plain versions against the Pallas calls -------

MODES = {   # depth_test, last_wins, less_equal, static_test
    "less": (True, False, False, False),
    "less_equal": (True, False, True, False),
    "last_wins": (False, True, False, False),
    "static": (True, True, False, True),
}


def _depth_init(seed=3):
    """An incoming depth plane: cleared to 1 with a random block nearer."""
    d = np.ones((H, 128), np.float32)
    rng = np.random.RandomState(seed)
    d[20:50, 30:90] = rng.uniform(0.9, 1.0, (30, 60))
    return d


@pytest.fixture(scope="module")
def dense_runs():
    """Per scene, the JAX setup and both sides' fold outputs in every mode
    (LESS_EQUAL starts from each side's own LESS depth: a depth prepass)."""
    out = {}
    for name in ("two_planes", "multipass"):
        _, _, s, inv_w, _, _ = _jsetup(name, "back")
        n_tris = inv_w.shape[0]
        runs = {}
        for mode, (dt, lw, le, st) in MODES.items():
            init = _depth_init()
            if mode == "less_equal":
                jinit = np.asarray(runs["less"][0][0])
                tinit = N(runs["less"][1][0])
            else:
                jinit = tinit = init
            j = _j_raster(jnp.asarray(s), jnp.asarray(jinit), W, H, dt, lw,
                          True, less_equal=le, static_test=st,
                          n_tris=n_tris)
            t = raster._raster_call(T(s), T(tinit), W, H, dt, lw,
                                    less_equal=le, static_test=st,
                                    n_tris=n_tris)
            runs[mode] = ([np.asarray(a) for a in j[:4]], t[:4])
        out[name] = (s, runs)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("scene", ["two_planes", "multipass"])
def test_k6_plain_matches_dense_call(dense_runs, scene, mode):
    s, runs = dense_runs[scene]
    (jd, jt, jl0, jl1), (td, tt, tl0, tl1) = runs[mode]
    assert (jt >= 0).mean() > 0.02, "the scene should cover pixels"
    same = _assert_ids(s, jt, N(tt))
    np.testing.assert_allclose(N(tl0)[same], jl0[same], atol=1e-5)
    np.testing.assert_allclose(N(tl1)[same], jl1[same], atol=1e-5)
    fin = same & np.isfinite(jd)
    np.testing.assert_allclose(N(td)[fin], jd[fin], atol=1e-5)
    np.testing.assert_array_equal(np.isfinite(N(td))[same],
                                  np.isfinite(jd)[same])


# ---- one frame through both packages ---------------------------------------

def _textures(kind):
    if kind == "packed":
        u8 = raster_scenes.checker_rgba()
        return (jres.texture_from_array(u8),
                tres.texture_from_array(u8, device="cpu"))
    jt = jres.texture_from_array(
        raster_scenes.mip_checker_u8(),
        jres.Sampler(mipmap=True, max_anisotropy=4.0), srgb=False)
    return jt, raster_scenes.mip_checker_texture("cpu")


FRAMES = {"basic_planes": ("two_planes", "back", "packed"),
          "grid_mip": ("grid12", "none", "mip")}


@functools.lru_cache(maxsize=None)
def _frame(label):
    """One frame (t = 0.55) of a scene through both packages, eagerly as
    the JAX tests run it: each side's render_mesh, the JAX G-buffer (the
    ``_raster_call`` inside render_mesh: K6, or K7 + K8 for the binned
    grid) with the setup, feature table and clipped-corner varyings it
    came from, and the port's own winner ids."""
    name, cull, kind = FRAMES[label]
    a = _scene_arrays(name)
    jtex, ttex = _textures(kind)
    jp = jpipe.GraphicsPipeline(vertex_fn=jshaders.mvp_vertex,
                                fragment_fn=jshaders.textured_border_fragment,
                                state=_jstate(cull))
    tp = tpipe.GraphicsPipeline(vertex_fn=tshaders.mvp_vertex,
                                fragment_fn=tshaders.textured_border_fragment,
                                state=_tstate(cull))
    jfb = jras.render_mesh(jp, _jmesh(a), _juniforms(0.55), {"tex": jtex},
                           jre.create_framebuffer(W, H), interpret=True)
    tfb = raster.render_mesh(tp, _tmesh(a), raster_scenes.frame_uniforms(
        0.55, W / H, device="cpu"), {"tex": ttex},
        tres.create_framebuffer(W, H, device="cpu"))
    m, vary, js, jiw, _, bm = _jsetup(name, cull, t=0.55, jit=False)
    idx = m.indices
    tri_vary = {}
    for k, v in vary.items():
        tv = v[idx]
        tv2 = jnp.concatenate([tv, tv], 0)
        tri_vary[k] = (bm[..., 0, None] * tv2[:, 0:1]
                       + bm[..., 1, None] * tv2[:, 1:2]
                       + bm[..., 2, None] * tv2[:, 2:3])
    n_tris = jiw.shape[0]
    ft = (jras._feature_table(tri_vary, jnp.asarray(jiw))
          if n_tris > jras._BIN_MIN_TRIS else None)
    jg = jras._raster_call(jnp.asarray(js), jre.create_framebuffer(W, H).depth,
                           W, H, True, False, True, n_tris=n_tris,
                           feat_table=ft)
    ds = raster._vertex_stage(tp, _tmesh(a), raster_scenes.frame_uniforms(
        0.55, W / H, device="cpu"), tfb)
    (_, tid, _, _, _), _ = raster._raster_draw(
        tp, ds, tres.create_framebuffer(W, H, device="cpu"))
    return dict(js=js, jiw=jiw, ft=None if ft is None else np.asarray(ft),
                tri_vary={k: np.asarray(v) for k, v in tri_vary.items()},
                jg=[None if g is None else np.asarray(g) for g in jg],
                tid=N(tid), jfb=jfb, tfb=tfb, tp=tp, ttex=ttex)


def test_k7_k8_plain_match_binned_call():
    """K7 + K8 plain (the port's binned raster call) on the JAX setup and
    feature table of the grid frame, against the JAX binned call."""
    f = _frame("grid_mip")
    s, ft = f["js"], f["ft"]
    assert s.shape[1] > raster._BIN_MIN_TRIS and ft.shape[1] == 18
    jd, jt, jl0, jl1, jf = f["jg"]
    td, tt, tl0, tl1, tf = raster._raster_call(
        T(s), tres.create_framebuffer(W, H, device="cpu").depth, W, H, True,
        False, n_tris=f["jiw"].shape[0], feat_table=T(ft))
    assert (jt >= 0).mean() > 0.1
    same = _assert_ids(s, jt, N(tt))
    np.testing.assert_allclose(N(tl0)[same], jl0[same], atol=1e-5)
    np.testing.assert_allclose(N(tl1)[same], jl1[same], atol=1e-5)
    np.testing.assert_allclose(N(td)[same], jd[same], atol=1e-5)
    np.testing.assert_array_equal(N(tf)[same], jf[same])


def test_k7_winner_slot_holds_the_winner():
    """K7's slot plane points at the pack row of each pixel's winner, and
    K8 (plain) fetches exactly that row."""
    f = _frame("grid_mip")
    s, ft = T(f["js"]), T(f["ft"])
    d0 = torch.ones((96, 128))
    d0[H:] = float("inf")
    b = raster._bin_triangles(s, 1, 3, feat=ft)
    _, tri, _, _, slot = raster._raster_binned_plain(
        b.pack, b.row_begin, b.row_end, d0, float(W), float(H), 1)
    tri, slot = N(tri), N(slot)
    won = tri >= 0
    assert won.mean() > 0.1
    np.testing.assert_array_equal(N(b.pack)[slot[won], raster._GID],
                                  tri[won])
    feats = N(raster._shade_fetch_plain(b.fpack, T(slot), b.visited))
    np.testing.assert_array_equal(feats[won], N(ft)[tri[won]])
    assert not feats[~won].any()


@pytest.mark.parametrize("label", list(FRAMES))
def test_shade_matches_jax_on_its_gbuffer(label):
    """The port's deferred shade (varyings, the fragment function, the
    texture sampler, depth write) on the JAX G-buffer reproduces the JAX
    frame."""
    f = _frame(label)
    jd, jt, jl0, jl1, jf = f["jg"]
    fb = tres.create_framebuffer(W, H, device="cpu")
    out = raster._shade(f["tp"], fb, T(jd), T(jt), T(jl0), T(jl1),
                        {k: T(v) for k, v in f["tri_vary"].items()},
                        T(f["jiw"]), {"tex": f["ttex"]},
                        feats=None if jf is None else T(jf))
    np.testing.assert_allclose(N(out.color), np.asarray(f["jfb"].color),
                               atol=2e-5, rtol=0)
    np.testing.assert_array_equal(N(out.depth), np.asarray(f["jfb"].depth))


@pytest.mark.parametrize("label", list(FRAMES))
def test_render_mesh_matches_jax(label):
    f = _frame(label)
    jid, tid = f["jg"][1][:H, :W], f["tid"][:H, :W]
    assert (jid >= 0).mean() > 0.05
    same = _assert_ids(f["js"], jid, tid) & (jid >= 0)
    jc = np.asarray(f["jfb"].color)[:H, :W]
    tc = N(f["tfb"].color)[:H, :W]
    jd = np.asarray(f["jfb"].depth)[:H, :W]
    td = N(f["tfb"].depth)[:H, :W]
    assert np.isfinite(tc).all()
    err = np.where(same, np.abs(jc - tc).max(-1), 0.0)
    assert err.max() <= 5e-4, err.max()
    assert (err > 2e-5).mean() <= EDGE_SHARE, (err > 2e-5).mean()
    np.testing.assert_allclose(td[same], jd[same], atol=1e-5)
    bg = (jid < 0) & (tid < 0)
    np.testing.assert_array_equal(tc[bg], jc[bg])
