"""Time the LOD flythrough window of a bench scene on a CUDA device.

    python3 ray_eater_tpu_torch/time_window.py [--scene fog] [--repeat 3]
        [--tree DIR]

Renders the scene's cloud (1M splats, 1920x1080) through the port's
``render_gaussians`` with the scene's knobs, as ``chip_smoke.py``'s main
path does: ``--frames`` flythrough frames from a cold budget, with temporal
LOD budgets where the scene uses them, after two warm frames. Prints, per
repeat, the CUDA-event and host-clock ms/frame, then one JSON line.

``--tree`` imports ``ray_eater_tpu_torch`` from another checkout's root (its
kernels are built there), so that two versions of the port are timed by
the same script: run it as a file, not with ``-m``. Needs a CUDA device;
exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scene", choices=("fog", "inria"), default="fog")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--repeat", type=int, default=3)
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_window: no CUDA device", file=sys.stderr)
        return 2
    from ray_eater_tpu_torch.bench_knobs import (flythrough_camera,
                                                 render_kwargs, resolve_knobs)
    from ray_eater_tpu_torch.models import gaussians
    from ray_eater_tpu_torch.ops import gs

    W, H, n = 1920, 1080, 1_000_000
    dev = torch.device("cuda")
    knobs = resolve_knobs(args.scene, n, env={})
    kw = render_kwargs(knobs, exact=False, interpret=False)
    mpt, temporal = knobs["max_splats_per_tile"], knobs["temporal"]
    ntx, nty = gs.num_tiles(W, H, knobs["tile_w"])
    if args.scene == "inria":
        cloud = gaussians.inria_cloud(n, seed=1, device=dev)
    else:
        cloud = gaussians.random_cloud(n, seed=1, extent=1.0,
                                       scale_range=(0.004, 0.02), device=dev)
    budget0 = gs.initial_lod_budget(W, H, knobs["tile_w"], mpt, dev)

    def window(frames: int):
        budget = budget0
        for i in range(frames):
            t = float(np.float32(i) / np.float32(60.0))
            view, proj = flythrough_camera(t, W, H, device=dev)
            _, st = gs.render_gaussians(
                cloud, view, proj, W, H,
                lod_budget=budget if temporal else None, **kw)
            if temporal:
                budget = gs.update_lod_budget(
                    st["tile_exec"], mpt, ntx, nty, st["tile_kept"],
                    st["tile_count"], dry_floor=knobs["dry_floor"])

    window(2)
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(args.repeat):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        window(args.frames)
        b.record()
        b.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3 / args.frames)
        dev_ms.append(a.elapsed_time(b) / args.frames)
        print(f"{args.scene} LOD window, {args.frames} frames: "
              f"{dev_ms[-1]:.4f} ms/frame (CUDA events), {host_ms[-1]:.4f} "
              f"ms/frame (host clock)", flush=True)
    print(json.dumps({"scene": args.scene, "tree": args.tree,
                      "ms_per_frame": dev_ms, "host_ms_per_frame": host_ms}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
