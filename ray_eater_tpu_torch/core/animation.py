"""Multi-frame rendering as one captured frame step (counterpart of
``ray_eater_tpu/core/animation.py``).

The JAX package moves the frame loop into one ``lax.scan`` so a whole
flythrough costs one dispatch. The port's frames are eager PyTorch ops and
hand-written kernels, hundreds of launches a frame, and the host that
issues them leaves the card idle most of the time. On a CUDA device
:func:`render_animation` therefore captures one frame step as a CUDA graph
(``torch.cuda.CUDAGraph``) on static buffers and replays it once a frame:
the frame's launches go to the card as one graph launch.

The step reads the frame time from a 0-d float32 buffer, set inside the
step to ``t0 + i * dt`` from a frame counter that the step advances: the
times of JAX's scan (``t0 + arange(n, float32) * float32(dt)``) rounded the
same way, where a running ``t += dt`` would drift from them. A carry is
read from static buffers and the new carry is copied back into them inside
the step; the frame's u8 encode is written into a static output.

On the CPU the same step runs as a plain eager loop.
"""

from __future__ import annotations

import time
import traceback
from typing import Callable

import numpy as np
import torch

from ..ops import _cuda
from ..utils.logging import scoped
from .resources import Framebuffer
from .swapchain import encode_present

_log = scoped("animation")

#: eager frame steps run on a side stream before capture: the first builds
#: the kernel library and sets kernel attributes, and both settle the
#: caching allocator's pools for the captured step
WARMUP_STEPS = 2


class GraphCaptureError(RuntimeError):
    """A frame step could not be captured as a CUDA graph; names the op."""


def frame_times(n_frames: int, t0: float = 0.0,
                dt: float = 1.0 / 60.0) -> np.ndarray:
    """The (n,) float32 frame times of an animation, as JAX's scan computes
    them and as :func:`render_animation`'s step reproduces them."""
    return t0 + np.arange(n_frames, dtype=np.float32) * np.float32(dt)


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a carry (a tensor, or tuples, lists and
    dicts of them), zipped with trees of the same structure."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        if any(set(r) != set(tree) for r in rest):
            raise ValueError("carry keys changed across frames")
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        if any(len(r) != len(tree) for r in rest):
            raise ValueError("carry length changed across frames")
        return type(tree)(_tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    raise TypeError(f"carry leaves must be tensors, got {type(tree)}")


def _signature(carry):
    if carry is None:
        return None
    out = []
    _tree_map(lambda x: out.append((tuple(x.shape), x.dtype, x.device)),
              carry)
    return tuple(out)


def _assign(buf, new):
    if tuple(new.shape) != tuple(buf.shape) or new.dtype != buf.dtype:
        raise ValueError(f"carry leaf changed from {tuple(buf.shape)} "
                         f"{buf.dtype} to {tuple(new.shape)} {new.dtype}")
    buf.copy_(new)


def encode_frame(out, srgb: bool = True) -> torch.Tensor:
    """The u8 encode of a frame: a ``Framebuffer`` cropped to its logical
    extent, or an (H, W, 3|4) image (``encode_present``)."""
    if isinstance(out, Framebuffer):
        # crop the padded framebuffer to its logical extent
        return encode_present(out.color, out.width, out.height, srgb)
    return encode_present(out, out.shape[1], out.shape[0], srgb)


class _Step:
    """One frame on static buffers: the time from the counter, the frame,
    the new carry copied into the carry buffers, the u8 encode into
    ``out``, the counter advanced."""

    def __init__(self, frame_fn, srgb: bool, carry, device):
        f32 = dict(dtype=torch.float32, device=device)
        self.frame_fn, self.srgb = frame_fn, srgb
        self.t0 = torch.zeros((), **f32)
        self.dt = torch.zeros((), **f32)
        self.i = torch.zeros((), **f32)
        self.t = torch.zeros((), **f32)
        self.carry = (None if carry is None
                      else _tree_map(lambda x: x.clone(), carry))
        self.out = None

    def start(self, t0: float, dt: float, carry) -> None:
        """Rewind to frame 0 of an animation at ``t0``, ``dt``."""
        self.t0.fill_(float(np.float32(t0)))
        self.dt.fill_(float(np.float32(dt)))
        self.i.zero_()
        if carry is not None:
            _tree_map(_assign, self.carry, carry)

    def __call__(self) -> None:
        torch.add(self.t0, self.i * self.dt, out=self.t)
        if self.carry is None:
            frame = self.frame_fn(self.t)
        else:
            frame, new = self.frame_fn(self.t, self.carry)
            _tree_map(_assign, self.carry, new)
        img = encode_frame(frame, self.srgb)
        if self.out is None:
            self.out = torch.empty_like(img)
        self.out.copy_(img)
        self.i.add_(1.0)


class _Graph:
    """A captured step: the graph, its step (static buffers) and the kernel
    launches of one replayed frame (what the wrappers counted while the
    step was captured)."""

    def __init__(self, step: _Step, graph, launches: dict, capture_s: float):
        self.step, self.graph = step, graph
        self.launches, self.capture_s = launches, capture_s


_graphs: dict = {}


def release(frame_fn=None) -> None:
    """Drop the captured graphs of ``frame_fn`` (all when None) and their
    memory pools."""
    for key in [k for k in _graphs if frame_fn is None or k[0] == frame_fn]:
        del _graphs[key]


def _failing_op(err: BaseException) -> str:
    """'file:line: code' of the innermost frame outside torch in the
    traceback of ``err`` or of the error it was raised from or during."""
    seen = set()
    while err is not None and id(err) not in seen:
        seen.add(id(err))
        frames = [f for f in traceback.extract_tb(err.__traceback__)
                  if "/torch/" not in f.filename.replace("\\", "/")
                  and not f.filename.endswith("animation.py")]
        if frames:
            f = frames[-1]
            return f"{f.filename}:{f.lineno}: {f.line}"
        err = err.__cause__ or err.__context__
    return "an op of the frame step"


def _capture(frame_fn, srgb: bool, carry, device) -> _Graph:
    step = _Step(frame_fn, srgb, carry, device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step.start(0.0, 0.0, carry)
        for _ in range(WARMUP_STEPS):
            step()
    torch.cuda.current_stream(device).wait_stream(side)
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    before = dict(_cuda.launches)
    t = time.perf_counter()
    try:
        with torch.cuda.graph(graph):
            step()
    except Exception as e:   # report every capture failure, then re-raise
        raise GraphCaptureError(
            f"render_animation: the frame step of {frame_fn!r} cannot be "
            f"captured as a CUDA graph ({type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''}); failing op: "
            f"{_failing_op(e)}. A captured step may make no host sync and "
            "no host-to-device copy: build constants on the device "
            "(torch.full, fill_) or once before the animation.") from e
    torch.cuda.synchronize(device)
    capture_s = time.perf_counter() - t
    # capture records the kernels and launches none: take its counts off,
    # and count them where the replays launch them
    launches = {k: v - before[k] for k, v in _cuda.launches.items()}
    _cuda.launches.update(before)
    _log.info("captured the frame step of %r in %.3f s; launches a frame %s",
              frame_fn, capture_s, launches)
    return _Graph(step, graph, launches, capture_s)


def _eager(frame_fn, n_frames, t0, dt, srgb, keep, carry, device, info):
    step = _Step(frame_fn, srgb, carry, device)
    step.start(t0, dt, carry)
    frames = []
    for _ in range(n_frames):
        step()
        if keep == "all":
            frames.append(step.out.clone())
    if info is not None:
        info.update(path="eager", captured=False, capture_s=0.0,
                    launches_per_frame=None, carry=step.carry)
    return torch.stack(frames) if keep == "all" else step.out


def _replay(frame_fn, n_frames, t0, dt, srgb, keep, carry, device, info):
    key = (frame_fn, srgb, keep, carry is not None, _signature(carry),
           device)
    g = _graphs.get(key)
    captured = g is None
    if captured:
        g = _graphs[key] = _capture(frame_fn, srgb, carry, device)
    step = g.step
    step.start(t0, dt, carry)
    frames = (torch.empty((n_frames, *step.out.shape), dtype=step.out.dtype,
                          device=device) if keep == "all" else None)
    for k in range(n_frames):
        g.graph.replay()
        if frames is not None:
            frames[k].copy_(step.out)
    for k, v in g.launches.items():
        _cuda.launches[k] += n_frames * v
    if info is not None:
        info.update(path="graph", captured=captured,
                    capture_s=g.capture_s if captured else 0.0,
                    launches_per_frame=dict(g.launches),
                    carry=_tree_map(lambda x: x.clone(), step.carry)
                    if step.carry is not None else None)
    return frames if keep == "all" else step.out.clone()


def _check(n_frames: int, keep: str) -> None:
    if keep not in ("all", "last"):
        raise ValueError(f"keep must be 'all' or 'last', got {keep!r}")
    if n_frames < 1:
        raise ValueError(f"n_frames must be at least 1, got {n_frames}")


def render_animation(frame_fn: Callable, n_frames: int, t0: float = 0.0,
                     dt: float = 1.0 / 60.0, srgb: bool = True,
                     keep: str = "all", carry=None, device="cuda",
                     info: dict | None = None):
    """Render ``n_frames`` frames of ``frame_fn`` at the times of
    :func:`frame_times` and return their u8 encode (``encode_present``):
    ``keep="all"`` → (n, H, W, C), ``keep="last"`` → the last frame's
    (H, W, C), on ``device``.

    ``frame_fn(t)`` takes a 0-d float32 tensor on ``device`` and returns a
    ``Framebuffer`` (cropped to its logical extent) or an (H, W, 3|4)
    image. With ``carry`` (a tensor, or tuples, lists and dicts of them),
    ``frame_fn(t, carry) -> (frame, new_carry)`` threads state from frame
    to frame, such as the temporal LOD budget; the new carry must keep the
    carry's shapes and dtypes.

    On a CUDA device the frame step is captured once as a CUDA graph and
    replayed ``n_frames`` times; the graph is cached by (``frame_fn``,
    ``srgb``, ``keep``, whether there is a carry, the carry's shapes,
    dtypes and devices, ``device``), so a later call with the same
    function replays it at once (:func:`release` drops it). Before capture
    the step runs :data:`WARMUP_STEPS` times eagerly on a side stream; the
    carry passed in is restored after them. If the step cannot be captured
    (a host sync or a host-to-device copy in ``frame_fn``) it raises
    :class:`GraphCaptureError` naming the op; it never runs the frames
    eagerly instead. Kernel launch counters (``ops._cuda.launches``)
    count the warm-up steps and, for every replayed frame, the launches
    of one captured step; capture itself launches nothing and counts
    nothing. On the CPU the step runs as a plain loop.

    ``info``, when given, is filled with ``path`` ("graph" or "eager"),
    ``captured`` (whether this call captured the step), ``capture_s``
    (seconds of this call's capture, 0 when the graph was cached),
    ``launches_per_frame`` (the kernel launches of one replayed frame) and ``carry`` (the carry after the last frame)."""
    _check(n_frames, keep)
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return _replay(frame_fn, n_frames, t0, dt, srgb, keep, carry, dev,
                       info)
    return _eager(frame_fn, n_frames, t0, dt, srgb, keep, carry, dev, info)


def render_animation_eager(frame_fn: Callable, n_frames: int,
                           t0: float = 0.0, dt: float = 1.0 / 60.0,
                           srgb: bool = True, keep: str = "all", carry=None,
                           device="cuda", info: dict | None = None):
    """:func:`render_animation`'s frames by the plain eager loop over the
    same step on any device: the reference that a replayed animation is
    held to, and the CPU path."""
    _check(n_frames, keep)
    return _eager(frame_fn, n_frames, t0, dt, srgb, keep, carry,
                  torch.device(device), info)
