"""Port vs JAX: the package's surface. ``import ray_eater_tpu_torch as re``
exports every name of ``ray_eater_tpu.__all__`` from the port's own
modules, and importing it builds nothing and imports neither JAX, the JAX
package nor ``parallel``. The parity audit: every public top-level
function, class and upper-case constant of each module of
``ray_eater_tpu/`` has its counterpart at the same module path in the
port, and every parameter of a JAX function, class or public method is a
parameter of its counterpart, but for the differences of idiom in
``ALLOWED``, each with its reason; the audit fails on a new difference and
on an entry of ``ALLOWED`` that no longer applies. Then the fan ceilings
``level_mid_max_radius``/``level_midlo_max_radius`` against JAX's, and the
sample entry points of the reference that the port now has: ``hello``,
``basic_planes --save-every`` and ``compute_drawing --device-loop``, on
the CPU at 64x64 to 96x64.

Tolerances: none; names resolve to the same objects, ceilings are equal
integers, the hello pixel is within 1e-6 and saved frames equal their
eager frames u8 for u8.
"""

import ast
import importlib
import inspect
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import ray_eater_tpu as jre  # noqa: E402
from ray_eater_tpu.ops import gs as jgs  # noqa: E402
import ray_eater_tpu_torch as tre  # noqa: E402
from ray_eater_tpu_torch import basic_planes, compute_drawing, hello  # noqa: E402
from ray_eater_tpu_torch.core.animation import render_animation_eager  # noqa: E402
from ray_eater_tpu_torch.core.swapchain import encode_present  # noqa: E402
from ray_eater_tpu_torch.io.image import decode_png  # noqa: E402
from ray_eater_tpu_torch.ops import gs  # noqa: E402
from ray_eater_tpu_torch.raster_scenes import scene  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(ROOT, "ray_eater_tpu")

_INTERPRET = ("Pallas interpret mode: the port's kernel wrappers take their "
              "plain PyTorch version for CPU tensors and launch the kernel "
              "for CUDA tensors, so there is no mode to pass")

#: (module under the package, name, parameter or None for the name itself)
#: -> (the port's parameter that stands for it, or None; the reason)
ALLOWED = {
    ("core.resources", "pytree_dataclass", None):
        (None, "registers a dataclass as a JAX pytree; PyTorch needs no "
               "registration of the port's dataclasses"),
    ("ops.splat", "CHUNK", None):
        (None, "the TPU kernel's block of particles; K10 has no such block "
               "(csrc/splat.cu gathers the particles of each tile)"),
    ("models.gs_densify", "densify_and_prune", "key"):
        ("generator", "a JAX PRNG key becomes a torch.Generator"),
    ("models.gs_densify", "reset_new_slots", "opt_state"):
        ("optimizer", "an optax state becomes the torch optimizer, whose "
                      "state is reset in place"),
    ("ops.gs", "finalize_planes", "r"):
        ("planes", "the four (r, g, b, T) planes come as one tensor"),
    ("ops.gs", "finalize_planes", "g"): ("planes", "as for r"),
    ("ops.gs", "finalize_planes", "b"): ("planes", "as for r"),
    ("ops.gs", "finalize_planes", "t"): ("planes", "as for r"),
    ("ops.gs", "composite_diff", "steps"):
        ("row_begin", "the Pallas grid's scalar-prefetch step table becomes "
                      "each tile's row range (row_begin, row_end)"),
    ("ops.gs", "composite_diff", "interpret"): (None, _INTERPRET),
    ("ops.raster", "render_mesh", "interpret"): (None, _INTERPRET),
    ("ops.splat", "splat_mask", "interpret"): (None, _INTERPRET),
    ("ops.splat", "splat_particles", "interpret"): (None, _INTERPRET),
    ("models.gs_training", "render_diff_pallas", "interpret"):
        (None, _INTERPRET),
    ("models.gs_training", "make_train_step_pallas", "interpret"):
        (None, _INTERPRET),
    ("models.gs_densify", "make_train_step_adc", "interpret"):
        (None, _INTERPRET),
    ("models.gs_densify", "make_train_window_adc", "interpret"):
        (None, _INTERPRET),
}


def jax_modules():
    """Every module of the JAX package, as a dotted path under it ("" for
    the package itself)."""
    out = []
    for dirpath, _, files in os.walk(JAX_PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), JAX_PKG)
                parts = rel[:-3].split(os.sep)
                if parts[-1] == "__init__":
                    parts = parts[:-1]
                out.append(".".join(parts))
    return sorted(out)


def module_file(sub: str) -> str:
    path = os.path.join(JAX_PKG, *sub.split(".")) if sub else JAX_PKG
    return (os.path.join(path, "__init__.py") if os.path.isdir(path)
            else path + ".py")


def public_names(path: str):
    """(name, kind) of the top-level ``def``s, ``class``es and upper-case
    constants of a source file whose names do not start with ``_``."""
    out = []
    for node in ast.parse(open(path, encoding="utf-8").read()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            if not node.name.startswith("_"):
                out.append((node.name, "def"))
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if (isinstance(t, ast.Name) and t.id.isupper()
                        and not t.id.startswith("_")):
                    out.append((t.id, "const"))
    return out


def missing_params(jfn, tfn):
    """The parameters of ``jfn`` that ``tfn`` lacks: by name, but a
    ``*args`` or ``**kwargs`` of one matches that of the other, and names
    starting with ``_`` (private dataclass fields) are skipped."""
    try:
        js, ts = inspect.signature(jfn), inspect.signature(tfn)
    except (TypeError, ValueError):
        return []
    var = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
    t_kinds = {p.kind for p in ts.parameters.values()}
    out = []
    for name, p in js.parameters.items():
        if name == "self" or name.startswith("_"):
            continue
        if p.kind in var:
            if p.kind not in t_kinds:
                out.append(name)
        elif name not in ts.parameters:
            out.append(name)
    return out


def differences(sub: str):
    """The set of (sub, name, parameter or None) where the port's module
    differs from the JAX module ``sub``."""
    jmod = importlib.import_module("ray_eater_tpu" + (f".{sub}" if sub else ""))
    tmod = importlib.import_module("ray_eater_tpu_torch"
                                   + (f".{sub}" if sub else ""))
    found = set()
    for name, kind in public_names(module_file(sub)):
        if not hasattr(tmod, name):
            found.add((sub, name, None))
            continue
        if kind != "def":
            continue
        jobj, tobj = getattr(jmod, name), getattr(tmod, name)
        found |= {(sub, name, p) for p in missing_params(jobj, tobj)}
        if not inspect.isclass(jobj):
            continue
        for attr, val in vars(jobj).items():
            if attr.startswith("_"):
                continue
            fn = val.__func__ if isinstance(val, (staticmethod,
                                                  classmethod)) else val
            if not inspect.isfunction(fn):
                continue
            if not hasattr(tobj, attr):
                found.add((sub, f"{name}.{attr}", None))
                continue
            found |= {(sub, f"{name}.{attr}", p)
                      for p in missing_params(fn, getattr(tobj, attr))}
    return found


# ---- (a) the public API ---------------------------------------------------

@pytest.mark.parametrize("name", jre.__all__)
def test_api_name_is_the_submodules_object(name):
    assert name in tre.__all__
    jobj = getattr(jre, name)
    if inspect.ismodule(jobj):
        sub = jobj.__name__
    else:
        sub = jobj.__module__
    assert sub.startswith("ray_eater_tpu.")
    port_mod = importlib.import_module("ray_eater_tpu_torch"
                                       + sub[len("ray_eater_tpu"):])
    if inspect.ismodule(jobj):
        assert getattr(tre, name) is port_mod
    else:
        assert getattr(tre, name) is getattr(port_mod, name)


# ---- (b) what importing the package does ----------------------------------

_IMPORT_PROBE = r"""
import json, os, sys
import torch
import torch.distributed as dist

PKG = os.path.join(os.getcwd(), "ray_eater_tpu_torch")
BUILD = os.path.join(PKG, "_build")
seen = []


def hook(event, args):
    path = args[0] if args else None
    if not isinstance(path, (str, bytes, os.PathLike)):
        path = None
    if event in ("open", "os.listdir", "os.scandir", "os.mkdir",
                 "os.rename", "os.remove", "shutil.rmtree"):
        if path is not None and os.path.abspath(
                os.fsdecode(path)).startswith(BUILD):
            seen.append([event, os.fsdecode(path)])
    elif event == "ctypes.dlopen":
        if path is None or os.path.abspath(
                os.fsdecode(path)).startswith(PKG):
            seen.append([event, str(path)])
    elif event == "subprocess.Popen":
        seen.append([event, str(args[1])])


sys.addaudithook(hook)
import ray_eater_tpu_torch as re
from ray_eater_tpu_torch.ops import _cuda
from ray_eater_tpu_torch.native import loader
print(json.dumps({
    "jax": sorted(m for m in sys.modules
                  if m == "jax" or m.startswith("jax.")),
    "jax_package": sorted(m for m in sys.modules
                          if m == "ray_eater_tpu"
                          or m.startswith("ray_eater_tpu.")),
    "parallel": sorted(m for m in sys.modules
                       if m.startswith("ray_eater_tpu_torch.parallel")),
    "process_group": dist.is_available() and dist.is_initialized(),
    "kernel_lib": _cuda._lib is not None,
    "native_lib": loader._lib is not None,
    "seen": seen,
    "names": len(re.__all__),
}))
"""


def test_import_builds_nothing_and_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"jax": [], "jax_package": [], "parallel": [],
                   "process_group": False, "kernel_lib": False,
                   "native_lib": False, "seen": [],
                   "names": len(jre.__all__)}, got


# ---- (c) the parity audit --------------------------------------------------

@pytest.mark.parametrize("sub", jax_modules())
def test_module_parity(sub):
    found = differences(sub)
    allowed = {k for k in ALLOWED if k[0] == sub}
    assert found - allowed == set(), "new differences from the JAX package"
    assert allowed - found == set(), "allow-list entries that no longer apply"
    tmod = importlib.import_module("ray_eater_tpu_torch"
                                   + (f".{sub}" if sub else ""))
    for (where, name, _), (instead, reason) in ALLOWED.items():
        assert reason
        if where == sub and instead is not None:
            fn = tmod
            for part in name.split("."):
                fn = getattr(fn, part)
            assert instead in inspect.signature(fn).parameters, (name,
                                                                 instead)


def test_allow_list_names_real_modules():
    assert {k[0] for k in ALLOWED} <= set(jax_modules())


# ---- (d) the fan ceilings --------------------------------------------------

@pytest.mark.parametrize("tile_w", [16, 32, 64, 128])
def test_mid_fan_ceilings_match_jax(tile_w):
    assert gs.level_mid_max_radius(tile_w) == \
        jgs.level_mid_max_radius(tile_w)
    assert gs.level_midlo_max_radius(tile_w) == \
        jgs.level_midlo_max_radius(tile_w)
    assert gs.level_mid_max_radius() == jgs.level_mid_max_radius()
    assert gs.level_midlo_max_radius() == jgs.level_midlo_max_radius()


# ---- (e)-(g) the sample entry points ----------------------------------------

def test_hello_on_cpu(capsys):
    assert hello.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("Hello from ray_eater_tpu_torch on cpu (cpu, "
                          "interpret=True)")


def test_hello_on_cuda_or_refused():
    # with no card the default device raises as Context does, and never
    # goes on on the CPU
    if torch.cuda.is_available():
        assert hello.main(["--device", "cuda"]) == 0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hello.main([])


@pytest.mark.parametrize("loop", [[], ["--host-loop"]])
def test_basic_planes_save_every(tmp_path, loop):
    w, h, frames = 96, 64, 3
    r = basic_planes.run(basic_planes.parse_args(
        ["--device", "cpu", "--frames", str(frames), "--save-every", "2",
         "--width", str(w), "--height", str(h), "--out", str(tmp_path),
         *loop]))
    assert sorted(os.listdir(tmp_path)) == ["frame_0000.png",
                                           "frame_0002.png",
                                           "frame_last.png"]
    want = render_animation_eager(scene("basic_planes", "cpu", w, h).frame,
                                  frames, device="cpu").numpy()
    for i in (0, 2):
        got = decode_png(open(tmp_path / f"frame_{i:04d}.png", "rb").read())
        np.testing.assert_array_equal(got, want[i], err_msg=str(i))
    np.testing.assert_array_equal(r["last"], want[-1])
    with pytest.raises(SystemExit):
        basic_planes.parse_args(["--save-every", "-1"])


def test_compute_drawing_device_loop(tmp_path):
    args = compute_drawing.parse_args(["--device-loop", "--device", "cpu",
                                       "--frames", "1", "--out",
                                       str(tmp_path)])
    assert args.device_loop and not args.host_loop
    r = compute_drawing.run(args)
    assert r["path"].startswith("device-loop")
    want = encode_present(r["drawing"].image, compute_drawing.WIDTH,
                          compute_drawing.HEIGHT, srgb=False)
    assert torch.equal(r["u8"], want)
    with pytest.raises(SystemExit):
        compute_drawing.parse_args(["--device-loop", "--host-loop"])
