"""Build and bind the port's CUDA kernels (``csrc/*.cu``), and register
each kernel as a ``torch.library`` custom op (:func:`kernel_op`).

The sources compile with ``nvcc`` (one process per source, in parallel)
and link into one shared library with a plain C interface, bound with
``ctypes``. The build runs at first use, into
``ray_eater_tpu_torch/_build/`` (git-ignored), under a file name keyed by
the hash of the sources and flags, so an edited source never loads a stale
library. Nothing here runs at import time: the CPU tests import every
module on machines with no ``nvcc``.

Each of the eleven kernels is an op ``rayeater::<name>``: its CUDA
implementation checks the arguments, launches the kernel on the current
stream and counts the launch; its CPU implementation is the kernel's plain
PyTorch version; its fake implementation gives the outputs' shapes and
dtypes from the inputs' shapes alone, so ``torch.export`` traces a frame
through the op without running it (``FrameProgram.save_baked``). Every op
allocates and returns its outputs and writes no input.

Flags: ``sm_90a`` (Hopper). No ``--use_fast_math``: the kernels keep IEEE
``sqrtf``/``logf``/``expf`` and division so their integer radii match the
plain PyTorch versions. ``--fmad=false`` keeps every multiply and add
rounded separately, as PyTorch's one-op-at-a-time plain versions round
them (the raster planes' coverage tests at λ = 0 depend on it).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_SOURCES = ("gs_project.cu", "gs_composite.cu", "gs_composite_bwd.cu",
            "raster.cu", "sampling.cu", "splat.cu", "gs_sh.cu")
_BUILD = _PKG / "_build"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_FLAGS = (*_ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler", "-fPIC")

_lib = None

#: kernel launches per wrapper, counted where the wrapper launches; a
#: captured CUDA graph's launches are counted where ``render_animation``
#: replays it (capture launches nothing, and its counts are taken off)
launches = {"k1_project": 0, "k2_composite": 0, "k3_composite_tail": 0,
            "k4_composite_ckpt": 0, "k5_composite_bwd": 0, "k6_raster": 0,
            "k7_raster_binned": 0, "k8_shade_fetch": 0, "k9_subtile": 0,
            "k10_splat": 0, "sh_colors": 0}


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


def _run(procs) -> None:
    """Wait for every (cmd, Popen); raise on the first that failed."""
    failed = []
    for cmd, proc in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{out}{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))


def build(csrc: Path = _CSRC) -> Path:
    """Compile the kernel library from the sources in ``csrc`` (this
    package's by default) if it is not built yet; return its path. Each
    source compiles in its own ``nvcc`` process, all started together,
    then one link makes the shared library."""
    sources = [Path(csrc) / f for f in _SOURCES]
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sources:
        h.update(src.read_bytes())
    out = _BUILD / f"libport_kernels_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{h.hexdigest()[:16]}.{os.getpid()}"
    objs = [_BUILD / f"{src.stem}.{tag}.o" for src in sources]
    compiles = []
    for src, obj in zip(sources, objs):
        cmd = [nvcc, *_FLAGS, "-c", "-o", str(obj), str(src)]
        compiles.append((cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    _run(compiles)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *_ARCH, "-shared", "-o", str(tmp), *map(str, objs)]
    _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True))])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    if _lib is None:
        load()
    return _lib


def load(csrc: Path = _CSRC) -> None:
    """Build the library from the sources in ``csrc`` and bind it; every
    wrapper launches its kernels from then on. Another checkout's ``csrc``
    (same file names and C entry points) times that version of the
    kernels under this package's wrappers (``time_composite.py``)."""
    global _lib
    so = ctypes.CDLL(str(build(csrc)))
    p, i = ctypes.c_void_p, ctypes.c_int
    so.gs_project.argtypes = [p, p, p, p, p, p, i, p]
    so.gs_project.restype = i
    so.gs_composite.argtypes = [p, i, p, p, p, p, i, i, i, p]
    so.gs_composite.restype = i
    so.gs_composite_tail.argtypes = [p, i, p, p, p, p, p, i, i, i, i, p, p]
    so.gs_composite_tail.restype = i
    so.gs_composite_ckpt.argtypes = [p, i, p, p, p, p, p, p, i, i, i, p]
    so.gs_composite_ckpt.restype = i
    so.gs_composite_bwd.argtypes = [p, i, p, p, p, p, p, p, p, p, i, i, i,
                                    p]
    so.gs_composite_bwd.restype = i
    f = ctypes.c_float
    so.raster_dense.argtypes = [p, i, i, p, i, i, f, f, i, p, p, p, p, p]
    so.raster_dense.restype = i
    so.raster_binned.argtypes = [p, p, p, i, i, p, i, i, f, f, i, p, p, p,
                                 p, p, p]
    so.raster_binned.restype = i
    so.shade_fetch.argtypes = [p, p, p, i, i, i, i, p, p]
    so.shade_fetch.restype = i
    so.subtile_sample.argtypes = [p] * 13 + [i, p]
    so.subtile_sample.restype = i
    so.subtile_sample_bf16.argtypes = [p] * 13 + [i, p]
    so.subtile_sample_bf16.restype = i
    so.splat_mask.argtypes = [p, i, i, i, i, i, i, p, p]
    so.splat_mask.restype = i
    so.sh_colors.argtypes = [p, p, p, p, i, i, p, p]
    so.sh_colors.restype = i
    _lib = so


def check_arg(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device`` (what a kernel takes)."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def check(err: int, name: str) -> None:
    """Raise if a launch returned a nonzero ``cudaGetLastError()``."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def fresh(out, inputs):
    """``out`` (a tensor or a tuple of them) with each tensor that shares
    storage with one of ``inputs`` or with an earlier output cloned: a
    custom op's outputs alias nothing."""
    seen = {t.untyped_storage().data_ptr() for t in inputs
            if isinstance(t, torch.Tensor)}

    def own(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr in seen:
            t = t.clone()
            ptr = t.untyped_storage().data_ptr()
        seen.add(ptr)
        return t
    if isinstance(out, torch.Tensor):
        return own(out)
    return tuple(own(t) for t in out)


def kernel_op(name: str, plain, fake):
    """Register the decorated launch function (annotated with the op's
    argument and return types) as the custom op ``rayeater::<name>``: its
    implementation for CUDA tensors (and, raising, for any device but the
    CPU), ``plain`` for CPU tensors, ``fake`` for tracing. Returns the op,
    called like the function."""
    def register(launch):
        op = torch.library.custom_op(f"rayeater::{name}", launch,
                                     mutates_args=())
        op.register_kernel("cpu", lambda *args: fresh(plain(*args), args))
        op.register_fake(fake)
        return op
    return register


def cuda_device(t: torch.Tensor, name: str) -> torch.device:
    """``t``'s device, which must be a CUDA device (an op's CUDA path)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device


def op_device(t: torch.Tensor, name: str) -> torch.device:
    """``t``'s device, which must be the CPU or a CUDA device: a wrapper
    refuses any other before it calls its op (whose fake implementation
    would answer a meta tensor)."""
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    return t.device
