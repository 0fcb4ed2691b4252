"""Time the particle splat K10 at two shapes.

    python3 -m ray_eater_tpu_torch.time_splat [--tree DIR] [--ptxas]

Shapes: the compute_drawing sample's pass (1024 particles from
``compute_drawing.particle_positions(0)``, 900x600, radius 20) and 65,536
particles drawn the same way over 1920x1080 (``RandomState(0)``, radius
20). For each: K10's mask against its plain version (must be equal);
per repeat, the wrapper's ms by CUDA events over ``REPS`` back-to-back
calls; then the device ms a call under ``torch.profiler``, of the splat
kernel alone and of all the call's device work (a memset included, where
the kernel sources make one); the bytes bound; and the device ms of one
empty kernel (the launch floor, when the sources have
``splat_launch_floor``). Then one JSON line. ``--ptxas`` first compiles
``splat.cu`` with ``-Xptxas -v`` and prints each kernel's registers, spill
bytes and shared memory.

``--tree`` takes the kernel sources from another checkout's
``ray_eater_tpu_torch/csrc`` (same C entry points) and times them under
this package's wrapper, so that two versions are compared on the same
inputs. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .time_composite import REPEAT, REPS, device_ms, ptxas_lines

HBM_BPS = 3.35e12
RADIUS = 20


def splat_kernel(name: str) -> bool:
    return name.startswith("splat_")


def shapes(torch, compute_drawing, dev):
    """label -> (positions on ``dev``, height, width, radius)."""
    out = {}
    for label, (w, h, n) in (("sample 1024 @ 900x600", (900, 600, 1024)),
                             ("65536 @ 1920x1080", (1920, 1080, 65_536))):
        pos = compute_drawing.particle_positions(0, w, h, n)
        out[label] = (torch.from_numpy(pos).to(dev), h, w, RADIUS)
    return out


def bound_ms(splat, pos, h: int, w: int) -> float:
    """The bytes bound: the padded mask written once, 8 B a particle read
    once, over the HBM rate."""
    hp, wp = splat.pad_to(h, splat.TILE_H), splat.pad_to(w, splat.TILE_W)
    return (hp * wp * 4 + pos.shape[0] * 8) / HBM_BPS * 1e3


def floor_ms(torch, splat):
    """Device ms of one empty kernel launch under ``torch.profiler``, or
    None when the loaded sources have no ``splat_launch_floor``."""
    from .ops import _cuda
    if not hasattr(_cuda.lib(), "splat_launch_floor"):
        return None
    return device_ms(torch, splat.launch_floor, (),
                     lambda n: n == "empty_kernel")[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="checkout whose kernel sources to time")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_splat: no CUDA device", file=sys.stderr)
        return 2
    from . import compute_drawing
    from .ops import _cuda as cuda
    from .ops import splat

    csrc = (Path(args.tree).resolve() / "ray_eater_tpu_torch" / "csrc"
            if args.tree else cuda._CSRC)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; kernel sources {csrc}", flush=True)
    ptx = ptxas_lines(cuda, csrc, ("splat.cu",)) if args.ptxas else []
    for p in ptx:
        print(f"ptxas {p['source']}: {p['kernel']}: {p.get('registers')} "
              f"registers, {p.get('spill_stores')} bytes spill stores, "
              f"{p.get('spill_loads')} bytes spill loads, {p.get('smem')} "
              "bytes smem", flush=True)
    cuda.load(csrc)
    dev = torch.device("cuda")
    calls = shapes(torch, compute_drawing, dev)
    equal = {}
    for label, a in calls.items():
        k = splat._splat_k10(*a)
        equal[label] = bool(torch.equal(k, splat._splat_plain(*a)))
        print(f"{label}: K10 equals its plain version: {equal[label]}; "
              f"{float(k.mean()) * 100:.2f}% of the padded mask covered; "
              f"bytes bound {bound_ms(splat, a[0], a[1], a[2]):.5f} ms",
              flush=True)
    times = {k: [] for k in calls}
    torch.cuda.synchronize()
    for r in range(REPEAT):
        for label, a in calls.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                splat._splat_k10(*a)
            e1.record()
            e1.synchronize()
            times[label].append(e0.elapsed_time(e1) / REPS)
        print(f"repeat {r}: " + ", ".join(
            f"{k} {v[-1]:.4f} ms" for k, v in times.items()), flush=True)
    device = {k: [] for k in calls}
    floors = []
    for r in range(REPEAT):
        for label, a in calls.items():
            kern, other, _ = device_ms(torch, splat._splat_k10, a,
                                       splat_kernel)
            device[label].append((kern, kern + other))
        floors.append(floor_ms(torch, splat))
        print(f"device repeat {r} (splat kernel; all device work of the "
              "call): " + ", ".join(f"{k} {v[-1][0]:.5f} ({v[-1][1]:.5f})"
                                    for k, v in device.items())
              + f"; empty kernel {floors[-1]}", flush=True)
    print(json.dumps({
        "csrc": str(csrc), "card": card, "equal": equal, "ms": times,
        "device_ms": {k: [d[0] for d in v] for k, v in device.items()},
        "device_ms_all": {k: [d[1] for d in v] for k, v in device.items()},
        "floor_ms": floors,
        "bound_ms": {k: bound_ms(splat, a[0], a[1], a[2])
                     for k, a in calls.items()},
        "ptxas": ptx}))
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
