"""Time the host cost of a kernel wrapper call on a CUDA device.

    python3 ray_eater_tpu_torch/time_dispatch.py [--tree DIR] [--calls 200]
        [--repeat 3]

Builds the inputs ``chip_smoke.py`` checks K2 and K6 on: the fog LOD
frame's layout (1M splats, 1920x1080, t = 0) for K2 (``gs._composite_call``)
and the multipass depth prepass at 1920x1080 (t = 0.5) for K6
(``raster._raster_dense_k6``). For each wrapper and repeat, ``--calls``
back-to-back calls are issued without a synchronisation: the host clock
over them, divided by the count, is the host's cost of a call (the
wrapper's Python, the dispatcher and the launch; the device is still busy
with earlier calls, so this is no device time), and CUDA events over the
same calls give the device ms a call. Then one JSON line.

``--tree`` imports ``ray_eater_tpu_torch`` from another checkout's root
(its wrappers and its kernels), so that two versions of the wrappers are
timed by the same script: run it as a file, not with ``-m``. Needs a CUDA
device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def timed(torch, fn, calls: int):
    """(host us a call, device ms a call) over ``calls`` unsynchronised
    calls of ``fn`` after two warm calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host = time.perf_counter() - t0
    b.record()
    b.synchronize()
    return host * 1e6 / calls, a.elapsed_time(b) / calls


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import torch
    if not torch.cuda.is_available():
        print("time_dispatch: no CUDA device", file=sys.stderr)
        return 2
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.bench_knobs import (bench_cloud,
                                                 flythrough_camera,
                                                 layout_kwargs, resolve_knobs)
    from ray_eater_tpu_torch.ops import gs, raster

    import ray_eater_tpu_torch
    dev = torch.device("cuda")
    w, h, n = 1920, 1080, 1_000_000
    knobs = resolve_knobs("fog", n, env={})
    cloud = bench_cloud("fog", n, dev)
    view, proj = flythrough_camera(0.0, w, h, device=dev)
    lay = gs._frame_layout(cloud, view, proj, w, h, **layout_kwargs(
        knobs, False, w, h, dev))
    b = lay.binned
    k2 = (lay.records, b.pack_idx, b.row_begin, b.row_end, lay.ntx, lay.nty,
          lay.tile_w)
    sc = rs.scene("multipass", dev)
    fb, ds = rs.draw_setup(sc, 0.5)
    k6 = (ds.setup, raster._pad_rows(fb.depth),
          raster._fold_bound(ds.inv_w.shape[0], ds.setup.shape[1]),
          float(sc.width), float(sc.height),
          raster._mode_bits(True, False, False, False))
    calls = {"K2": lambda: gs._composite_call(*k2),
             "K6": lambda: raster._raster_dense_k6(*k6)}
    tree = os.path.dirname(os.path.dirname(os.path.abspath(
        ray_eater_tpu_torch.__file__)))
    out = {"tree": tree, "device": torch.cuda.get_device_name(0),
           "torch": torch.__version__, "calls": args.calls}
    for name, fn in calls.items():
        host, dev_ms = [], []
        for _ in range(args.repeat):
            hu, dm = timed(torch, fn, args.calls)
            host.append(hu)
            dev_ms.append(dm)
        print(f"{name} [{tree}]: host {' '.join(f'{x:.1f}' for x in host)} "
              f"us a call; device {' '.join(f'{x:.4f}' for x in dev_ms)} "
              f"ms a call (CUDA events)", flush=True)
        out[name] = {"host_us": host, "event_ms": dev_ms}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
