"""Small shared helpers (counterpart of ``ray_eater_tpu/utils/``):
:func:`pad_to` and :func:`on_device` here; scoped loggers in
:mod:`.logging`, frame timing and trace spans in :mod:`.profiler`, runtime
checks in :mod:`.validation`."""

import numpy as np
import torch


def pad_to(x: int, m: int) -> int:
    """Round ``x`` up to a multiple of ``m`` (tile/chunk alignment)."""
    return ((x + m - 1) // m) * m


def on_device(values, device, dtype=None):
    """A tensor of the Python numbers ``values`` (a number or a nested
    sequence; float32 unless ``dtype`` says otherwise) equal to
    ``torch.tensor(values, dtype=dtype, device=device)``, built on a CUDA
    device by fill kernels: no host-to-device copy, which would synchronize
    the stream, so a CUDA graph can capture it."""
    dtype = torch.float32 if dtype is None else dtype
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.tensor(values, dtype=dtype)
    vals = np.asarray(values, dtype=np.float64)
    out = torch.empty(vals.shape, dtype=dtype, device=dev)
    flat, items = out.view(-1), vals.reshape(-1).tolist()
    if len(set(items)) == 1:
        return out.fill_(items[0])
    for k, v in enumerate(items):
        flat[k].fill_(v)
    return out
