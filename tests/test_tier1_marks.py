"""The root conftest.py's slow marks: they name tests that exist, each has a
jitted twin that runs in tier-1, and they reach only the named tests.

tests/test_parallel.py is read with ast, never imported."""

import ast
import importlib.util
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def root_conftest():
    spec = importlib.util.spec_from_file_location("root_conftest",
                                                  ROOT / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def defined_tests(path):
    tree = ast.parse(Path(path).read_text())
    return {n.name for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name.startswith("test_")}


def test_each_slow_test_has_a_jit_twin():
    twins = defined_tests(ROOT / "tests" / "test_parallel_jit.py")
    for name in root_conftest().SLOW_TESTS:
        assert f"{name}_jit" in twins, name


def test_slow_marks_only_the_named_tests():
    conf = root_conftest()
    missing = conf.SLOW_TESTS - defined_tests(conf.SLOW_FILE)
    assert not missing, f"not tests of {conf.SLOW_FILE}: {sorted(missing)}"
    out = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-m",
         "slow", "-p", "no:cacheprovider", "tests/test_parallel.py",
         "tests/test_parallel_jit.py"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    marked = {line for line in out.stdout.splitlines() if "::" in line}
    assert marked == {f"tests/test_parallel.py::{name}"
                      for name in conf.SLOW_TESTS}, out.stdout
