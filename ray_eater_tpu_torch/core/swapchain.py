"""Present (counterpart of ``ray_eater_tpu/core/swapchain.py``): the
device-side u8 encode :func:`encode_present` (the r8g8b8a8 surface-format
conversion of swapchain.zig:44-49) and the :class:`Swapchain` ring that
reads presented frames back to the host.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np
import torch

from ..io.image import linear_to_srgb
from ..utils.logging import scoped

_log = scoped("swapchain")


def encode_present(color: torch.Tensor, width: int, height: int,
                   srgb: bool = True) -> torch.Tensor:
    """Crop ``color`` (Hp, Wp, 4) to its logical extent, encode linear to
    sRGB when ``srgb`` (alpha clipped to [0, 1]) or else clip all four
    channels, and round to uint8 RGBA on the tensor's device."""
    img = color[:height, :width, :]
    if srgb:
        rgb = linear_to_srgb(img[..., :3])
        img = torch.cat([rgb, img[..., 3:].clamp(0.0, 1.0)], -1)
    else:
        img = img.clamp(0.0, 1.0)
    return torch.round(img * 255.0).to(torch.uint8)


class Swapchain:
    """Present ring + FPS counter.

    ``present`` encodes a frame on its device, starts a ``non_blocking``
    copy into a pinned host slot of an ``image_count``-deep ring (at least
    2) and records a CUDA event after it; once the ring is full it returns
    the oldest frame, waiting only for that frame's event, so the frame
    just submitted never blocks the caller (the first acquires of
    swapchain.zig:253-263 have the same warm-up). On the CPU the copy is
    plain. Typical loop (basic_planes.zig:316-350)::

        sc = Swapchain(ctx, 900, 600)
        for t in times:
            img = sc.present(frame(t))         # None while the ring fills
            if img is not None: ...
        for img in sc.drain(): ...             # the frames still in flight
    """

    def __init__(self, ctx, width: int, height: int, image_count: int = 3,
                 srgb: bool = True):
        self.ctx = ctx
        self.width, self.height = width, height
        self.image_count = max(2, image_count)
        self.srgb = srgb
        self._slots: list[torch.Tensor] = []
        self._next = 0
        # (host slot, CUDA event or None, device frame kept until copied)
        self._inflight: deque = deque()
        self._frame_times: deque[float] = deque(maxlen=240)
        self._t_last: float | None = None
        self.frames_presented = 0
        _log.info("swapchain %dx%d ring=%d srgb=%s", width, height,
                  self.image_count, srgb)

    def present(self, fb) -> np.ndarray | None:
        """Encode ``fb`` (a Framebuffer) on its device and present it."""
        return self.present_encoded(
            encode_present(fb.color, self.width, self.height, self.srgb))

    def present_encoded(self, encoded: torch.Tensor) -> np.ndarray | None:
        """:meth:`present` for a frame already encoded to u8 (H, W, C) on
        its device. Returns the oldest frame as a host array once the ring
        is full, else None."""
        if encoded.dtype != torch.uint8 or encoded.shape[:2] != (
                self.height, self.width):
            raise ValueError(f"present_encoded: expected uint8 "
                             f"({self.height}, {self.width}, C), got "
                             f"{encoded.dtype} {tuple(encoded.shape)}")
        cuda = encoded.is_cuda
        if not self._slots or self._slots[0].shape != encoded.shape:
            self._slots = [torch.empty(encoded.shape, dtype=torch.uint8,
                                       pin_memory=cuda)
                           for _ in range(self.image_count)]
        slot = self._slots[self._next]
        self._next = (self._next + 1) % self.image_count
        slot.copy_(encoded, non_blocking=cuda)
        event = None
        if cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(encoded.device))
        self._inflight.append((slot, event, encoded))

        now = time.perf_counter()
        if self._t_last is not None:
            self._frame_times.append(now - self._t_last)
        self._t_last = now
        self.frames_presented += 1

        if len(self._inflight) >= self.image_count:
            return self._pop()
        return None

    def _pop(self) -> np.ndarray:
        slot, event, _ = self._inflight.popleft()
        if event is not None:
            event.synchronize()
        return slot.numpy().copy()

    def resize(self, width: int, height: int) -> "Swapchain":
        """Swapchain recreation (deferred by the reference,
        swapchain.zig:229-230): drains the frames in flight and returns a
        new ring for the new extent."""
        for _ in self.drain():
            pass
        return Swapchain(self.ctx, width, height, self.image_count,
                         self.srgb)

    def drain(self):
        """Wait for and yield every frame still in flight, oldest first."""
        while self._inflight:
            yield self._pop()

    @property
    def fps(self) -> float:
        """Rolling FPS over the recent presents."""
        if not self._frame_times:
            return 0.0
        return len(self._frame_times) / sum(self._frame_times)
