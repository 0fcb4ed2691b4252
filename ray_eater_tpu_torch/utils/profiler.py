"""Frame profiling (counterpart of ``ray_eater_tpu/utils/profiler.py``):

* :class:`FrameStats`: rolling frame-time/FPS aggregation;
* :func:`annotate`: a named span (``torch.profiler.record_function``) that
  shows in ``torch.profiler`` traces;
* :func:`trace`: a ``torch.profiler`` capture of the host and, where there
  is one, the CUDA device, written as a Chrome trace;
* :class:`StageTimer`: wall-clock per-stage breakdown, fenced with
  ``torch.cuda.synchronize`` when a stage's results lie on a CUDA device;
* :func:`count_frame`, :func:`read_counters`, :func:`reset_counters`: the
  frame counters (:data:`COUNTERS`), one int64 buffer a device that each
  LOD frame of ``render_gaussians`` adds to on the device, inside a
  captured frame step too, and that is read with one host copy.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque

import torch
from torch._subclasses.fake_tensor import is_fake

#: the frame counters, in the order of each device's buffer: LOD frames,
#: splats valid after the projection (K1), pairs emitted, pairs dropped
#: (behind the head, or behind the decimated tail where there is one) and
#: splats the side channels dropped whole
COUNTERS = ("frames", "valid_splats", "pairs_emitted", "pairs_dropped",
            "side_dropped_splats")

#: device -> (totals (len(COUNTERS),) int64, the int32 one a frame adds);
#: buffers are zeroed in place and never dropped, since a captured frame
#: step adds to the memory it captured
_counters: dict = {}


def _tracing(x: torch.Tensor) -> bool:
    """Whether ``x`` is a traced stand-in (``torch.export``, ``torch.compile``
    or a meta tensor) rather than a value on a device."""
    return (x.device.type == "meta" or torch.compiler.is_compiling()
            or is_fake(x))


def count_frame(valid: torch.Tensor, emitted: torch.Tensor,
                dropped: torch.Tensor, side_dropped: torch.Tensor) -> None:
    """Add one frame to the counters of the device its 0-d int32 counts
    lie on: one stack and one ``add_`` there, no host sync. The buffer is
    made by the first eager call on a device; a frame captured in a CUDA
    graph before any eager frame on its device counts nothing (the buffer
    is never made in a graph's memory pool), and traced frames count
    nothing."""
    if _tracing(valid):
        return
    dev = valid.device
    state = _counters.get(dev)
    if state is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            return
        state = _counters[dev] = (
            torch.zeros(len(COUNTERS), dtype=torch.int64, device=dev),
            torch.ones((), dtype=torch.int32, device=dev))
    totals, one = state
    totals.add_(torch.stack([one, valid, emitted, dropped, side_dropped]))


def read_counters(device=None) -> dict | None:
    """The counters of ``device`` (every device's summed when None) as
    ``{name: int}``, one host copy a device; None where no frame was
    counted."""
    bufs = [t for d, (t, _) in _counters.items()
            if device is None or d == torch.device(device)]
    if not bufs:
        return None
    tot = sum(b.cpu() for b in bufs).tolist()
    if tot[0] == 0:
        return None
    return dict(zip(COUNTERS, tot))


def reset_counters() -> None:
    """Zero every device's counters in place."""
    for totals, _ in _counters.values():
        totals.zero_()


@contextlib.contextmanager
def annotate(name: str):
    """Named trace span visible in ``torch.profiler`` captures."""
    with torch.profiler.record_function(name):
        yield


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (CPU, and CUDA when available) and write its
    Chrome trace to ``log_dir/trace.json``; yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class FrameStats:
    """Rolling frame statistics (count, FPS, p50/p99 frame time)."""

    def __init__(self, window: int = 240):
        self.times: deque[float] = deque(maxlen=window)
        self._last: float | None = None
        self.frames = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now
        self.frames += 1

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def summary(self) -> dict:
        ts = sorted(self.times)
        if not ts:
            return {"frames": self.frames, "fps": 0.0}
        p = lambda q: ts[min(len(ts) - 1, int(q * len(ts)))] * 1000
        return {"frames": self.frames, "fps": round(self.fps, 2),
                "p50_ms": round(p(0.50), 2), "p99_ms": round(p(0.99), 2)}


def _fence(x) -> None:
    """Wait for the device that holds ``x`` (tensors in lists, tuples and
    dict values too); a no-op for CPU values."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _fence(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _fence(v)
    elif hasattr(x, "color"):          # a Framebuffer
        _fence(x.color)


class StageTimer:
    """Fenced wall-clock stage timing::

        st = StageTimer()
        with st.stage("project") as out:
            out.append(project(...))       # fenced on exit
        print(st.report())
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, fence=None):
        t0 = time.perf_counter()
        result = []
        try:
            yield result
        finally:
            _fence(result)
            if fence is not None:
                _fence(fence)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        total = sum(self.totals.values()) or 1.0
        return "\n".join(
            f"{name:>16}: {ms * 1000 / max(self.counts[name], 1):8.2f} ms/call "
            f"x{self.counts[name]:<4} ({ms / total:5.1%})"
            for name, ms in rows)
