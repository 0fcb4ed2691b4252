"""Frame profiling (counterpart of ``ray_eater_tpu/utils/profiler.py``):

* :class:`FrameStats`: rolling frame-time/FPS aggregation;
* :func:`annotate`: a named span (``torch.profiler.record_function``) that
  shows in ``torch.profiler`` traces;
* :func:`trace`: a ``torch.profiler`` capture of the host and, where there
  is one, the CUDA device, written as a Chrome trace;
* :class:`StageTimer`: wall-clock per-stage breakdown, fenced with
  ``torch.cuda.synchronize`` when a stage's results lie on a CUDA device.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict, deque

import torch


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
