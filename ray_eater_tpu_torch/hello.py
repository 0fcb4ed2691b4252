"""hello — the port's hello-world (counterpart of ``samples/test_sample.py``;
the reference's samples/test_sample.zig:4-6).

Boots a ``Context``, clears a 64x64 framebuffer on its device, waits for
the device, checks the cleared pixel and reports the device: the minimal
"does the engine come up" check. On a machine without a CUDA device
``--device cuda`` raises as ``Context`` does; it never goes on on the CPU.

    python -m ray_eater_tpu_torch.hello [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .core.context import Context, ContextConfig
from .core.resources import create_framebuffer

CLEAR = (0.2, 0.4, 0.6, 1.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    ctx = Context(ContextConfig(platform=args.device))
    fb = create_framebuffer(64, 64, clear_color=CLEAR, device=ctx.device)
    ctx.wait_idle(fb.color)
    px = fb.color[0, 0].cpu().numpy()
    if not np.allclose(px, CLEAR, atol=1e-6):
        raise RuntimeError(f"cleared pixel {px}, expected {CLEAR}")
    name = (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "cpu")
    print(f"Hello from ray_eater_tpu_torch on {ctx.device} ({name}, "
          f"interpret={ctx.interpret})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
