"""Build and bind the port's CUDA kernels (``csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, bound with ``ctypes``. The build runs at first use, into
``ray_eater_tpu_torch/_build/`` (git-ignored), under a file name keyed by
the hash of the sources and flags, so an edited source never loads a stale
library. Nothing here runs at import time: the CPU tests import every
module on machines with no ``nvcc``.

Flags: ``sm_90a`` (Hopper). No ``--use_fast_math``: the kernels keep IEEE
``sqrtf``/``logf``/``expf`` and division so their integer radii match the
plain PyTorch versions. ``--fmad=false`` keeps every multiply and add
rounded separately, as PyTorch's one-op-at-a-time plain versions round
them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
_SOURCES = (_PKG / "csrc" / "gs_project.cu", _PKG / "csrc" / "gs_composite.cu")
_BUILD = _PKG / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None

#: kernel launches per wrapper, counted where the wrapper launches
launches = {"k1_project": 0, "k2_composite": 0, "k3_composite_tail": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernel library if it is not built yet; return its path."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    out = _BUILD / f"libgs_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        so = ctypes.CDLL(str(build()))
        p, i = ctypes.c_void_p, ctypes.c_int
        so.gs_project.argtypes = [p, p, p, p, p, p, i, p]
        so.gs_project.restype = i
        so.gs_composite.argtypes = [p, i, p, p, p, p, i, i, i, p]
        so.gs_composite.restype = i
        so.gs_composite_tail.argtypes = [p, i, p, p, p, p, p, i, i, i, i, p]
        so.gs_composite_tail.restype = i
        _lib = so
    return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
