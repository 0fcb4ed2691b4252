"""The measured window: frames one after another, each sent once the one
before is done (a closed loop of one viewer), for a fixed time.

A frame's time runs from its call to its u8 image being done on the card:
CUDA events recorded before the call and after it, on the stream the frame
runs on, read once the window has closed (the card's timestamps, exact to
the microsecond, so a 3 ms frame needs no host clock). The window's own
length is the host clock's, over many frames, and so is its steady
milliseconds a frame: those of its last seconds, which the first seconds
of a process, slower on the card, do not reach.

Frames the check may compare are kept with their inputs and outputs: the
first ``start_frames``, and one frame in every ``stride`` at an offset the
seed draws. A kept frame's image is copied to the host once the frame is
done, outside its timed span, so that the kept frames do not add to the
card's memory peak.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Kept:
    index: int
    image: torch.Tensor
    budget_in: torch.Tensor | None
    budget_out: torch.Tensor | None


@dataclass
class Window:
    frames: int = 0
    seconds: float = 0.0
    frame_ms: list = field(default_factory=list)
    kept: list = field(default_factory=list)
    next_index: int = 0
    budget: torch.Tensor | None = None
    starts: list = field(default_factory=list)   # host clock, each frame
    end: float = 0.0                             # host clock, the close

    def steady_ms(self, tail_s: float) -> float:
        """Host-clock milliseconds a frame over the frames that started in
        the window's last ``tail_s`` seconds (all of them in a shorter
        window)."""
        k = next(j for j, t in enumerate(self.starts)
                 if t >= self.end - tail_s)
        return (self.end - self.starts[k]) * 1e3 / (len(self.starts) - k)


def keep_set(seed: int, start: int, stride: int):
    """The predicate of the frames to keep: the first ``start``, then one a
    ``stride`` at an offset from the seed."""
    off = int(np.random.default_rng([seed % (1 << 64), 0x6B]).integers(
        stride))
    return lambda i: i < start or (i - start) % stride == off


def run(program, sched, seconds: float | None, keep, dev,
        budget=None, first: int = 0, frames: int | None = None,
        on_frame=None, images: bool = True) -> Window:
    """Frames ``first``, ``first + 1``, ... of ``sched`` through
    ``program`` from ``budget``, until ``seconds`` have passed (or for
    ``frames`` frames). ``on_frame(i)``, when given, returns a context
    that wraps frame ``i`` (the traced slice's annotations); without
    ``images`` the kept frames keep their budgets only."""
    cuda = dev.type == "cuda"
    w = Window(budget=budget)
    events = []
    host_ms = []
    if cuda:
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    deadline = None if seconds is None else t0 + seconds
    i = first
    while True:
        w.starts.append(time.perf_counter())
        b_in = w.budget
        if cuda:
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
        else:
            h0 = time.perf_counter()
        with (on_frame(i) if on_frame else contextlib.nullcontext()):
            img, b_out = program.frame(sched.view(i), b_in)
            if cuda:
                e1.record()
                e1.synchronize()
                events.append((e0, e1))
            else:
                host_ms.append((time.perf_counter() - h0) * 1e3)
        if keep(i):
            w.kept.append(Kept(i, img.cpu() if images else None, b_in,
                               b_out))
        w.budget = b_out
        i += 1
        n = i - first
        if frames is not None and n >= frames:
            break
        if deadline is not None and time.perf_counter() >= deadline:
            break
    w.end = time.perf_counter()
    w.seconds = w.end - t0
    w.frames = i - first
    w.next_index = i
    w.frame_ms = ([a.elapsed_time(b) for a, b in events] if cuda
                  else host_ms)
    return w
