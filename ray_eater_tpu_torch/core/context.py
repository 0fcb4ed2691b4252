"""Context — the application's one handle to the engine (counterpart of
``ray_eater_tpu/core/context.py``; the reference's context.zig:101-219).

The device is a ``torch.device``: the first CUDA device by default, the
CPU when the config asks for it. ``submit`` runs a frame program (a plain
callable, or a CUDA graph's replay) and retries a transient failure;
``wait_idle`` synchronizes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..utils.logging import scoped

_log_device = scoped("device")

#: failures ``submit`` retries: CUDA runtime errors (``AcceleratorError``,
#: where this PyTorch has it) and I/O errors (a lost device or a dropped
#: transport), not programming errors
_TRANSIENT = ((torch.AcceleratorError, OSError)
              if hasattr(torch, "AcceleratorError") else (OSError,))


@dataclasses.dataclass
class ContextConfig:
    """Engine-level settings (analog of Context.Config, context.zig:92-97)."""

    #: "cuda" (the default when None) or "cpu".
    platform: str | None = None
    #: Accepted for the reference's signature and changes nothing: every
    #: ``RenderGraph.bake`` validates the graph (context.zig:145-147, the
    #: validation layer, done statically).
    validation: bool = True
    #: True when the kernels' plain PyTorch versions run (the CPU); None
    #: resolves from the device. The JAX package's Pallas interpret mode
    #: has no counterpart: a kernel wrapper takes its plain version for
    #: CPU tensors and launches its kernel for CUDA tensors.
    interpret: bool | None = None
    #: Accepted for the reference's signature and changes nothing: the
    #: kernel library builds once into ``ray_eater_tpu_torch/_build/``,
    #: named by the hash of its sources and flags, and is reused from
    #: there by every later process.
    compile_cache_dir: str | None = "auto"


class Context:
    """Device handle, config and program cache. ``submit`` is the analog
    of ``Context.submitCommands`` (context.zig:192-210); ordering between
    programs is the stream order of the current CUDA stream."""

    def __init__(self, config: ContextConfig | None = None):
        # a copy: resolving ``interpret`` must not change the caller's
        # config, which may be reused for another Context
        self.config = (dataclasses.replace(config) if config
                       else ContextConfig())
        platform = self.config.platform or "cuda"
        if platform == "cpu":
            self.devices = [torch.device("cpu")]
        elif platform == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device available (pass "
                                   "ContextConfig(platform='cpu') for the "
                                   "CPU)")
            self.devices = [torch.device("cuda", i)
                            for i in range(torch.cuda.device_count())]
        else:
            raise ValueError(f"unknown platform {platform!r} (cuda or cpu)")
        self.device = self.devices[0]
        _log_device.info("selected device: %s (of %d)", self.device,
                         len(self.devices))
        if self.config.interpret is None:
            self.config.interpret = self.device.type == "cpu"
        self._programs: dict[Any, Callable] = {}

    @property
    def interpret(self) -> bool:
        return bool(self.config.interpret)

    def compile(self, key: Any, build: Callable[[], Callable]) -> Callable:
        """Memoize the program ``build()`` returns under ``key``."""
        prog = self._programs.get(key)
        if prog is None:
            prog = build()
            self._programs[key] = prog
        return prog

    def submit(self, program: Callable, *args, retries: int = 1, **kwargs):
        """Run a frame program. Work is queued on the current stream and
        the call returns before the device finishes; :meth:`wait_idle`
        fences. A CUDA runtime or I/O error is retried ``retries`` times
        with a log line; other errors, and the last failure, propagate."""
        for attempt in range(retries + 1):
            try:
                return program(*args, **kwargs)
            except _TRANSIENT as e:
                if attempt >= retries:
                    raise
                _log_device.warning(
                    "submit failed (%s: %s) — retrying (%d/%d)",
                    type(e).__name__, str(e)[:200], attempt + 1, retries)

    def wait_idle(self, *tensors) -> None:
        """Wait until the device has finished all queued work
        (DeviceHandler.waitIdle, base.zig:644); ``tensors`` are accepted
        for the reference's signature."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
