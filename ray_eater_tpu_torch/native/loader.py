"""ctypes loader of the native tier (counterpart of
``ray_eater_tpu/native/loader.py``): a binary PLY vertex reader and a PNG
encoder and decoder in C++ (``src/rayeater_native.cpp``, a copy of the
JAX package's source).

The library is built at first use with ``g++ -O3 -shared -fPIC`` (linked
with zlib) into ``ray_eater_tpu_torch/_build/`` (git-ignored), under a
file name keyed by the hash of the source and flags, so an edited source
never loads a stale library. Concurrent first uses (test workers, a sample
beside a benchmark) build under one file lock, and a finished library is
moved into place with ``os.replace``, so no reader sees a partial file.
Nothing is built at import time. The tier is an accelerator: when the
build or the load fails, :func:`available` is False and callers take their
Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from ..utils.logging import scoped

_log = scoped("native")
_SRC = Path(__file__).resolve().parent / "src" / "rayeater_native.cpp"
_BUILD = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared")
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source and flags is built."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD / f"librayeater_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library unless it exists; return its path. Builds are
    serialised by an exclusive lock on ``_build/native.lock``."""
    import fcntl
    out = library_path()
    if out.exists():
        return out
    _BUILD.mkdir(parents=True, exist_ok=True)
    with open(_BUILD / "native.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if out.exists():          # another process built it meanwhile
                return out
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC),
                            "-lz"], check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, out)
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return out


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    c_i32, c_i64 = ctypes.c_int32, ctypes.c_int64
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_i32, p_i64 = ctypes.POINTER(c_i32), ctypes.POINTER(c_i64)
    lib.re_ply_probe.restype = ctypes.c_int
    lib.re_ply_probe.argtypes = [ctypes.c_char_p, p_i64, p_i32,
                                 ctypes.c_char_p, c_i32, p_i64, p_i32]
    lib.re_ply_read.restype = ctypes.c_int
    lib.re_ply_read.argtypes = [ctypes.c_char_p, c_i64, c_i32, c_i64, c_i32,
                                ctypes.POINTER(ctypes.c_float)]
    lib.re_png_encode.restype = c_i64
    lib.re_png_encode.argtypes = [p_u8, c_i32, c_i32, c_i32, p_u8, c_i64]
    lib.re_png_probe.restype = ctypes.c_int
    lib.re_png_probe.argtypes = [p_u8, c_i64, p_i32, p_i32, p_i32]
    lib.re_png_decode.restype = ctypes.c_int
    lib.re_png_decode.argtypes = [p_u8, c_i64, c_i32, c_i32, c_i32, p_u8]
    return lib


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = build()
    except (OSError, subprocess.SubprocessError) as e:
        _log.warning("native build failed (%s); using the Python paths", e)
        return None
    try:
        _lib = _bind(ctypes.CDLL(str(so)))
    except OSError as e:
        _log.warning("native load failed (%s)", e)
        return None
    _log.info("native tier loaded: %s", so)
    return _lib


def available() -> bool:
    """Whether the library is built and loaded (builds it on first call)."""
    return _load() is not None


def _need():
    lib = _load()
    if lib is None:
        raise ImportError("native tier unavailable")
    return lib


def read_ply(path: str):
    """Binary or ascii PLY vertices: (property names, (n, p) float32)."""
    lib = _need()
    n, p = ctypes.c_int64(), ctypes.c_int32()
    off, ascii_ = ctypes.c_int64(), ctypes.c_int32()
    names = ctypes.create_string_buffer(16384)
    rc = lib.re_ply_probe(str(path).encode(), ctypes.byref(n),
                          ctypes.byref(p), names, len(names),
                          ctypes.byref(off), ctypes.byref(ascii_))
    if rc != 0:
        raise ValueError(f"native PLY probe failed ({rc}) for {path}")
    props = names.value.decode().split("\n")
    out = np.empty((n.value, p.value), np.float32)
    rc = lib.re_ply_read(str(path).encode(), off.value, ascii_.value,
                         n.value, p.value,
                         out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if rc != 0:
        raise ValueError(f"native PLY read failed ({rc}) for {path}")
    return props, out


def png_encode(pixels: np.ndarray) -> bytes:
    """(h, w, 3|4) uint8 to PNG bytes."""
    lib = _need()
    pixels = np.ascontiguousarray(pixels, np.uint8)
    h, w, c = pixels.shape
    u8 = ctypes.POINTER(ctypes.c_uint8)
    pp = pixels.ctypes.data_as(u8)
    need = lib.re_png_encode(pp, h, w, c, None, 0)
    if need < 0:
        raise ValueError(f"native PNG size probe failed ({need})")
    out = np.empty(need, np.uint8)
    size = lib.re_png_encode(pp, h, w, c, out.ctypes.data_as(u8), need)
    if size < 0:
        raise ValueError(f"native PNG encode failed ({size})")
    return out[:size].tobytes()


def png_decode(data: bytes) -> np.ndarray:
    """PNG bytes to (h, w, c) uint8: 8-bit, non-interlaced, colour types
    0, 2, 4 and 6 (no palette)."""
    lib = _need()
    buf = np.frombuffer(data, np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    bp = buf.ctypes.data_as(u8)
    h, w, c = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.re_png_probe(bp, len(buf), ctypes.byref(h), ctypes.byref(w),
                          ctypes.byref(c))
    if rc != 0:
        raise ValueError(f"native PNG probe failed ({rc})")
    out = np.empty((h.value, w.value, c.value), np.uint8)
    rc = lib.re_png_decode(bp, len(buf), h.value, w.value, c.value,
                           out.ctypes.data_as(u8))
    if rc != 0:
        raise ValueError(f"native PNG decode failed ({rc})")
    return out
