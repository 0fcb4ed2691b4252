"""The JAX package's ``RAYEATER_*`` environment knobs as the port's
explicit arguments.

| JAX knob | port |
|---|---|
| ``SHADE_FETCH`` | ``render_mesh(..., shade_fetch=False)`` |
| ``WIN_BF16`` | ``texture_from_array(..., window_dtype=torch.bfloat16)`` |
| ``SUBTILE``, ``SUBTILE_FB`` | ``Sampler.subtile``, ``Sampler.subtile_fallback`` |
| ``TAIL_D`` | ``render_gaussians(..., lod_tail_d=d)`` |
| ``PROJ_BR`` | none: the Pallas grid's block rows, no counterpart in K1 |

JAX reads ``WIN_BF16`` when a texture is built and ``SUBTILE``/
``SUBTILE_FB`` when it samples, so ``monkeypatch.setenv`` sets them; it
reads ``TAIL_D`` and ``PROJ_BR`` at import into ``ops.gs._TAIL_D`` and
``_PROJ_BR``, which ``monkeypatch.setattr`` sets as the variables would.

Tolerances and why:
- bf16 windows: the tables bit-equal (both round float32 to nearest
  even); the subtile sampler within 2e-6, as the float32 path
  (``tests/test_torch_sampling.py``): the JAX kernel contracts bf16
  weights against the bf16 window with float32 accumulation, whose
  products are exact, and the port sums the same terms.
- ``SUBTILE=0`` (the per-pixel gather) and ``SUBTILE_FB``: within 2e-6
  (``tests/test_torch_sampling.py``'s bounds for those paths).
- ``TAIL_D``: within 1.03e-5 (the inria tail slice's bound, PR 3).
- ``PROJ_BR``: the projection's rtol 1e-5 of ``tests/test_torch_project.py``
  (the block rows only tile the grid).
"""

import ast
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ray_eater_tpu import rmath as jrmath  # noqa: E402
from ray_eater_tpu.core import resources as jres  # noqa: E402
from ray_eater_tpu.models import gaussians as jgauss  # noqa: E402
from ray_eater_tpu.ops import gs as jgs  # noqa: E402
from ray_eater_tpu.ops import sampling as jsp  # noqa: E402
from ray_eater_tpu_torch import raster_scenes  # noqa: E402
from ray_eater_tpu_torch.core import resources as tres  # noqa: E402
from ray_eater_tpu_torch.models import gaussians  # noqa: E402
from ray_eater_tpu_torch.ops import gs, raster  # noqa: E402
from ray_eater_tpu_torch.ops import sampling as sp  # noqa: E402

torch.set_num_threads(1)

PKG = Path(__file__).resolve().parent.parent / "ray_eater_tpu_torch"


def T(a):
    return torch.from_numpy(np.array(a))


def _noise(h, w, seed):
    return (np.random.RandomState(seed).rand(h, w, 4) * 255).astype(np.uint8)


def _uv_perspective(H=64, W=96):
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    depth = 0.25 + 2.5 * (ys / H)
    u = (xs / W - 0.5) * depth + 0.5
    v = (ys / H - 0.5) * depth + 0.5
    return np.stack([u, v], -1).astype(np.float32)


def _textures(u8, window_dtype=torch.float32, **kw):
    jt = jres.texture_from_array(
        u8, jres.Sampler(address_mode=jres.AddressMode.REPEAT, mipmap=True,
                         **kw), srgb=True)
    tt = tres.texture_from_array(
        u8, tres.Sampler(address_mode=tres.AddressMode.REPEAT, mipmap=True,
                         **kw), srgb=True, device="cpu",
        window_dtype=window_dtype)
    return jt, tt


# ---- SHADE_FETCH -------------------------------------------------------------

def test_shade_fetch_off_gives_the_same_frame():
    """The 288-triangle grid (binned: K7, K8's fetch; textured: K9) with
    the per-pixel gather instead of K8."""
    sc = raster_scenes.scene("grid288", "cpu")
    pipe, res = sc.passes[0]
    frames = []
    for fetch in (True, False):
        fb = tres.create_framebuffer(sc.width, sc.height, device="cpu")
        frames.append(raster.render_mesh(pipe, sc.mesh, sc.uniforms(0.4),
                                         res, fb, shade_fetch=fetch))
    assert 2 * sc.mesh.num_triangles > raster._BIN_MIN_TRIS
    assert (frames[0].depth < 1.0).float().mean() > 0.1
    assert torch.equal(frames[0].color, frames[1].color)
    assert torch.equal(frames[0].depth, frames[1].depth)


# ---- WIN_BF16 ------------------------------------------------------------------

def test_bf16_windows_match_jax(monkeypatch):
    monkeypatch.setenv("RAYEATER_WIN_BF16", "1")
    jt, tt = _textures(_noise(64, 64, 5), torch.bfloat16,
                       subtile_fallback=0.0)
    assert tt.win_table.dtype == torch.bfloat16
    assert jt.win_table.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        tt.win_table.view(torch.int16).numpy(),
        np.asarray(jt.win_table).view(np.int16))
    uv = _uv_perspective()
    want = np.asarray(jsp._sample_subtile(jt, jnp.asarray(uv)))
    got = sp._sample_subtile(tt, T(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    # the bf16 frame is not the f32 one: the knob took effect
    _, t32 = _textures(_noise(64, 64, 5), subtile_fallback=0.0)
    f32 = sp._sample_subtile(t32, T(uv)).numpy()
    assert 0 < np.abs(got - f32).max() < 2e-2


def test_bf16_k9_plain_rounds_the_x_weights():
    """K9's plain version on bf16 windows against a float64 filter of the
    same texels with the x weights rounded to bf16."""
    _, tt = _textures(_noise(64, 64, 5), torch.bfloat16)
    plan = sp._subtile_plan(tt, T(_uv_perspective()))
    ty0, fy0, tx0, fx0, ty1, fy1, tx1, fx1, frac = plan.planes
    win = tt.win_table.to(torch.float64).reshape(-1, 4, 32, 32).numpy()

    def bf(x):
        return x.to(torch.bfloat16).to(torch.float64).numpy()

    def tap(wid, ty, fy, tx, fx):
        w = win[wid.numpy()]                             # (ns, 4, 32, 32)
        s = np.arange(w.shape[0])[:, None, None]
        c = np.arange(4)[None, :, None]
        ty, tx = ty.numpy()[:, None], tx.numpy()[:, None]
        gx, wx = bf(1.0 - fx)[:, None], bf(fx)[:, None]
        fy = fy.numpy().astype(np.float64)[:, None]

        def row(dy):
            return (w[s, c, ty + dy, tx] * gx + w[s, c, ty + dy, tx + 1] * wx)
        return row(0) * (1 - fy) + row(1) * fy

    fr = frac.numpy().astype(np.float64)[:, None]
    want = (tap(plan.w0i, ty0, fy0, tx0, fx0) * (1 - fr)
            + tap(plan.w1i, ty1, fy1, tx1, fx1) * fr)
    got = sp._subtile_plain(plan.w0i, plan.w1i, *plan.planes,
                            tt.win_table).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_window_dtype_refuses_others():
    with pytest.raises(ValueError, match="window_dtype"):
        tres.texture_from_array(_noise(16, 16, 1), device="cpu",
                                window_dtype=torch.float16)


# ---- SUBTILE, SUBTILE_FB -------------------------------------------------------

def test_subtile_off_matches_jax_env(monkeypatch):
    """``Sampler(subtile=False)`` against JAX's default sampler under
    ``RAYEATER_SUBTILE=0``: both take the per-pixel gather."""
    monkeypatch.setenv("RAYEATER_SUBTILE", "0")
    u8, uv = _noise(64, 64, 3), _uv_perspective()
    jt, _ = _textures(u8)
    _, tt = _textures(u8, subtile=False)
    want = np.asarray(jsp.sample(jt, jnp.asarray(uv)))
    got = sp.sample(tt, T(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    np.testing.assert_allclose(got, sp._sample_mip(tt, T(uv)).numpy(),
                               atol=0, rtol=0)


@pytest.mark.parametrize("frac", ["0", "0.5"])
def test_subtile_fallback_matches_jax_env(monkeypatch, frac):
    """``Sampler(subtile_fallback=f)`` against JAX's default sampler (1/8)
    under ``RAYEATER_SUBTILE_FB=f``: off, and a larger budget."""
    monkeypatch.setenv("RAYEATER_SUBTILE_FB", frac)
    u8, uv = _noise(64, 64, 9), _uv_perspective()
    jt, _ = _textures(u8)
    _, tt = _textures(u8, subtile_fallback=float(frac))
    want = np.asarray(jsp._sample_subtile(jt, jnp.asarray(uv)))
    got = sp._sample_subtile(tt, T(uv)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    if frac == "0":     # this frame has binding subtiles: the knob matters
        _, t8 = _textures(u8)
        assert not np.array_equal(got,
                                  sp._sample_subtile(t8, T(uv)).numpy())


# ---- TAIL_D, PROJ_BR --------------------------------------------------------------

def test_tail_d_matches_jax_module_constant(monkeypatch):
    """``lod_tail_d=4`` against JAX's default under ``_TAIL_D = 4`` (what
    ``RAYEATER_TAIL_D=4`` sets at import), on a small inria-style frame
    with the decimated tail."""
    monkeypatch.setattr(jgs, "_TAIL_D", 4)
    w, h = 128, 64
    jc = jgauss.random_cloud(256, seed=5, extent=0.7,
                             scale_range=(0.02, 0.2))
    view = jrmath.look_at_zforward(jrmath.vec(0.0, 0.6, -2.5),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), w / h, 0.1, 30.0)
    kw = dict(max_splats_per_tile=16, lod_tail_decim=32, tile_w=32,
              big_splat_cap=64)
    want = np.asarray(jax.jit(lambda c, v, p: jgs.render_gaussians(
        c, v, p, w, h, interpret=True, **kw))(jc, view, proj))
    c = gaussians.cloud_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in
         ("means", "scales", "quats", "opacities", "colors")}, device="cpu")
    got = gs.render_gaussians(c, T(view), T(proj), w, h, lod_tail_d=4,
                              **kw).numpy()
    d2 = gs.render_gaussians(c, T(view), T(proj), w, h, lod_tail_d=2,
                             **kw).numpy()
    assert np.abs(got - want).max() <= 1.03e-5
    assert np.abs(d2 - want).max() > 1e-3      # the decimation matters here


def test_proj_br_changes_nothing(monkeypatch):
    """JAX's projection at another Pallas block-row count equals the
    port's K1 path (which has no such knob)."""
    monkeypatch.setattr(jgs, "_PROJ_BR", 8)
    w, h = 256, 96
    jc = jgauss.random_cloud(3000, seed=7, extent=1.6,
                             scale_range=(0.004, 0.08))
    view = jrmath.look_at_zforward(jrmath.vec(0.4, -0.3, -2.2),
                                   jrmath.vec(0.0, 0.0, 0.0))
    proj = jrmath.perspective(jrmath.radians(60.0), w / h, 0.1, 30.0)
    ref = jgs._project_fast(jc.means, jc.scales, jc.quats, jc.opacities,
                            jc.colors, view, proj, w, h, interpret=True)
    c = gaussians.cloud_from_numpy(
        {f: np.asarray(getattr(jc, f)) for f in
         ("means", "scales", "quats", "opacities", "colors")}, device="cpu")
    got = gs._project_fast(c.means, c.scales, c.quats, c.opacities,
                           c.colors, T(view), T(proj), w, h)
    both = np.isfinite(np.asarray(ref.depth)) & np.isfinite(got.depth.numpy())
    assert both.sum() > 1000
    for name in ("mean2d", "conic", "depth"):
        np.testing.assert_allclose(getattr(got, name).numpy()[both],
                                   np.asarray(getattr(ref, name))[both],
                                   rtol=1e-5, atol=1e-5, err_msg=name)


# ---- no module of the port reads a RAYEATER_* variable -----------------------------

def _env_names(path: Path) -> set:
    """Every string constant (or f-string head) of the module that is a
    whole ``RAYEATER_*`` name: what an environment read needs."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.JoinedStr) and node.values:
            node = node.values[0]
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and node.value.startswith("RAYEATER_")
                and node.value.replace("_", "").isalnum()):
            names.add(node.value)
    return names


def test_port_reads_no_rayeater_variable():
    allowed = {"bench_knobs.py": None,       # the RAYEATER_BENCH_* knobs
               "basic_planes.py": {"RAYEATER_TEXTURE"}}
    found = {}
    for path in sorted(PKG.rglob("*.py")):
        names = _env_names(path)
        rule = allowed.get(path.name, set())
        if rule is not None and names - rule:
            found[str(path.relative_to(PKG))] = sorted(names - rule)
    assert not found, found
    assert _env_names(PKG / "basic_planes.py") == {"RAYEATER_TEXTURE"}
    assert any(n.startswith("RAYEATER_BENCH_")
               for n in _env_names(PKG / "bench_knobs.py"))
