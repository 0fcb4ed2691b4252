"""Runtime validation (counterpart of ``ray_eater_tpu/utils/validation.py``,
the validation-layer analog): static checks run when a render graph is
baked (``graph/render_graph.py``); the opt-in runtime checks here wrap
passes (:func:`checked_pass`) or check frame boundaries
(:func:`check_finite`, :func:`check_framebuffer`). A runtime check reads
its result on the host, so on a CUDA device it waits for the device:
a tool for debug sessions, and not capturable in a CUDA graph.
"""

from __future__ import annotations

import torch

from .logging import scoped

_log = scoped("validation")


class ValidationError(RuntimeError):
    pass


def enable_nan_debugging(enabled: bool = True) -> None:
    """Anomaly detection in autograd (``torch.autograd.set_detect_anomaly``):
    a backward that produces NaN raises, naming the forward op (slow;
    debug only)."""
    torch.autograd.set_detect_anomaly(enabled)
    _log.info("autograd anomaly detection %s",
              "enabled" if enabled else "disabled")


def _leaves(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _leaves(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _leaves(v)
    elif hasattr(x, "color") and hasattr(x, "depth"):   # a Framebuffer
        yield x.color
        yield x.depth


def check_finite(name: str, *arrays) -> None:
    """Raise :class:`ValidationError` if a floating tensor among
    ``arrays`` (tensors, framebuffers, or dicts/lists/tuples of them)
    holds NaN or Inf."""
    for i, a in enumerate(arrays):
        for leaf in _leaves(a):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                raise ValidationError(
                    f"pass {name!r} output #{i} contains NaN/Inf")


def check_framebuffer(fb, width: int | None = None,
                      height: int | None = None) -> None:
    """Shape and dtype checks of a framebuffer resource."""
    if fb.color.ndim != 3 or fb.color.shape[-1] != 4:
        raise ValidationError(f"framebuffer color must be (H, W, 4), got "
                              f"{tuple(fb.color.shape)}")
    if tuple(fb.depth.shape) != tuple(fb.color.shape[:2]):
        raise ValidationError(
            f"depth {tuple(fb.depth.shape)} mismatches color "
            f"{tuple(fb.color.shape[:2])}")
    if fb.color.dtype != torch.float32 or fb.depth.dtype != torch.float32:
        raise ValidationError("framebuffer must be float32")
    if width is not None and fb.width != width:
        raise ValidationError(f"fb width {fb.width} != expected {width}")
    if height is not None and fb.height != height:
        raise ValidationError(f"fb height {fb.height} != expected {height}")


def checked_pass(name: str, fn):
    """Wrap a render-graph pass with a finiteness check of its outputs."""
    def wrapper(inputs):
        outs = fn(inputs)
        check_finite(name, outs)
        return outs
    return wrapper
