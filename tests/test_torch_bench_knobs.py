"""The port's knob resolver equals ``bench.py``'s, its kwargs are accepted
by the port's ``render_gaussians``, and the port package stands alone:
importing it loads neither JAX nor ``ray_eater_tpu``."""

import inspect
import os
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import bench  # noqa: E402
from ray_eater_tpu_torch import bench_knobs  # noqa: E402
from ray_eater_tpu_torch.ops import gs  # noqa: E402

SCENES = ("fog", "shell", "inria", "trained")
ENVS = ({}, {"RAYEATER_BENCH_MPT": "0"}, {"RAYEATER_BENCH_CERTIFIED": "1"},
        {"RAYEATER_BENCH_TEMPORAL": "0", "RAYEATER_BENCH_TILEW": "128"},
        {"RAYEATER_BENCH_BIGCAP": "0", "RAYEATER_BENCH_CAP_FACTOR": "0",
         "RAYEATER_BENCH_DRYFLOOR": "static", "RAYEATER_BENCH_LODSEG": "4",
         "RAYEATER_BENCH_PAYLOAD": "0", "RAYEATER_BENCH_TAIL": "0"})


@pytest.mark.parametrize("env", ENVS, ids=lambda e: ",".join(e) or "default")
@pytest.mark.parametrize("scene", SCENES)
def test_resolve_knobs_equals_bench(scene, env):
    n = 1_000_000
    assert (bench_knobs.resolve_knobs(scene, n, env=env)
            == bench.resolve_knobs(scene, n, env=env))
    knobs = bench.resolve_knobs(scene, n, env=env)
    for exact in (False, True):
        assert (bench_knobs.render_kwargs(knobs, exact, interpret=False)
                == bench.render_kwargs(knobs, exact, interpret=False))
    assert bench_knobs.LOD_ONLY_KNOBS == bench.LOD_ONLY_KNOBS


def test_render_kwargs_are_port_render_params():
    params = set(inspect.signature(gs.render_gaussians).parameters)
    for scene in SCENES:
        knobs = bench_knobs.resolve_knobs(scene, 1_000_000, env={})
        for exact in (False, True):
            kw = bench_knobs.render_kwargs(knobs, exact, interpret=False)
            assert not set(kw) - params, (scene, exact)


def test_import_loads_neither_jax_nor_reference():
    code = ("import sys\n"
            "import ray_eater_tpu_torch, ray_eater_tpu_torch.rmath\n"
            "import ray_eater_tpu_torch.bench_knobs\n"
            "import ray_eater_tpu_torch.models.gaussians\n"
            "import ray_eater_tpu_torch.ops.gs, ray_eater_tpu_torch.ops._cuda\n"
            "import ray_eater_tpu_torch.models.gs_training\n"
            "import ray_eater_tpu_torch.models.gs_densify\n"
            "import ray_eater_tpu_torch.gs_trainer, "
            "ray_eater_tpu_torch.profile_gs\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'ray_eater_tpu', 'bench')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_port_sources_do_not_import_jax_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|ray_eater_tpu|bench)"
                     r"\b(?!_)", re.M)
    files = list((ROOT / "ray_eater_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 5
    for f in files:
        assert not pat.search(f.read_text()), f


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("scene", ("fog", "inria"))
def test_layout_kwargs_are_render_gaussians_layout(scene, exact):
    """``layout_kwargs`` hands ``_frame_layout`` every render kwarg that
    ``render_gaussians`` hands it, plus the first temporal budget where
    the scene's LOD frame uses one."""
    import torch
    knobs = bench_knobs.resolve_knobs(scene, 1_000_000, env={})
    kw = bench_knobs.render_kwargs(knobs, exact, interpret=False)
    lk = bench_knobs.layout_kwargs(knobs, exact, 480, 270, "cpu")
    params = set(inspect.signature(gs._frame_layout).parameters)
    assert set(lk) <= params
    budget = lk.pop("lod_budget", None)
    assert lk == {k: v for k, v in kw.items() if k in params}
    if knobs["temporal"] and not exact:
        assert torch.equal(budget, gs.initial_lod_budget(
            480, 270, knobs["tile_w"], knobs["max_splats_per_tile"], "cpu"))
    else:
        assert budget is None


def test_bench_cloud_is_the_flythrough_cloud():
    from ray_eater_tpu_torch.models import gaussians
    for scene, ref in (
            ("fog", gaussians.random_cloud(500, seed=1, extent=1.0,
                                           scale_range=(0.004, 0.02),
                                           device="cpu")),
            ("inria", gaussians.inria_cloud(500, seed=1, device="cpu"))):
        got = bench_knobs.bench_cloud(scene, 500, "cpu")
        for f in ("means", "scales", "quats", "opacities", "colors"):
            assert bool((getattr(got, f) == getattr(ref, f)).all()), (scene, f)
    with pytest.raises(ValueError):
        bench_knobs.bench_cloud("shell", 500, "cpu")
