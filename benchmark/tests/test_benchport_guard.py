"""The import guard and the reference's independence from the program."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from harness.guard import forbidden_modules

BENCH = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("mods,bad", [
    (["torch", "ray_eater_tpu_torch", "ray_eater_tpu_torch.ops.gs"], []),
    (["ray_eater_tpu_torchx", "jaxtyping", "flaxen.x"], []),
    (["jax"], ["jax"]),
    (["jax.numpy", "jaxlib.xla_client"], ["jax", "jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["ray_eater_tpu.ops.gs", "ray_eater_tpu_torch"], ["ray_eater_tpu"]),
])
def test_guard_compares_whole_top_level_names(mods, bad):
    assert forbidden_modules(mods) == bad


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top in ("torch", "numpy", "math", "typing",
                           "__future__"), (f, mod)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """The harness's modules and the port's, imported as a run imports
    them, leave no forbidden module behind."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "import run\n"
            "from harness import cell, check, program, trace, window\n"
            "from ray_eater_tpu_torch.ops import gs\n"
            "from ray_eater_tpu_torch.core import animation\n"
            "from harness.guard import forbidden_modules\n"
            "print(forbidden_modules())\n") % (str(BENCH), str(BENCH.parent))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "[]"
