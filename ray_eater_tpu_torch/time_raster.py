"""Time the raster folds K6 and K7 at the sizes of the main paths.

    python3 -m ray_eater_tpu_torch.time_raster [--tree DIR] [--ptxas]

Builds the frames that ``chip_smoke.py`` checks, through
``raster_scenes.scene`` and ``raster_scenes.draw_setup`` at t = 0.5: the
multipass depth prepass (LESS) and its LESS_EQUAL lit pass over the
prepass's depth at 1920x1080 and the basic_planes frame at 900x600 (K6,
dense), and the grid10k frame at 1920x1080 (binned, K7). Prints, per
repeat, each wrapper's ms by CUDA events over ``REPS`` back-to-back
calls; then, per repeat, the device ms a call of the fold kernels alone
(and of the wrapper's other kernels) under ``torch.profiler``; the share
of (live row, warp footprint) pairs the kernels skip, counted by their
plain twin ``raster._fold_culled`` on the same inputs, and the pairs each
CTA keeps (its work), against their mean over the card's SMs, with the
footprint and CTA regions the loaded kernels report (``raster_fold_shape``;
sources without it get no counts); then one JSON line.
``--ptxas`` first compiles ``raster.cu`` with ``-Xptxas -v`` (the port's
flags) and prints each kernel's registers, spill bytes and shared memory.

``--tree`` takes the kernel sources from another checkout's
``ray_eater_tpu_torch/csrc`` (same C entry points) and times them under
this package's wrappers and frames, so that two versions of the kernels
are compared on the same inputs. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from .time_composite import REPEAT, REPS, device_ms, ptxas_lines


def fold_kernel(name: str) -> bool:
    return name.startswith("raster_")


def per_cta(counts, fs, tile_w: int, tile_h: int):
    """(ntiles, footprints) per-footprint counts (row-major in the tile)
    to (ntiles, ``fs.ctas``), one per CTA region, for the fold shape
    ``fs`` (``raster.FoldShape``)."""
    (fw, fh), (cw, ch) = fs.foot, fs.region
    ny, nx, ry, rx = tile_h // ch, tile_w // cw, ch // fh, cw // fw
    return counts.reshape(-1, ny, ry, nx, rx).sum((2, 4)).reshape(-1, fs.ctas)


def frames(raster, rs, dev):
    """label -> (K6 or K7 wrapper, its args, its culled twin, 6 or 7) of
    the four frames; and the grid10k frame's row counts a tile."""
    less = raster._mode_bits(True, False, False, False)
    calls = {}
    sc = rs.scene("multipass", dev)
    fb, ds = rs.draw_setup(sc, 0.5)      # both passes share the vertex stage
    n = raster._fold_bound(ds.inv_w.shape[0], ds.setup.shape[1])
    pre = (ds.setup, raster._pad_rows(fb.depth), n, float(sc.width),
           float(sc.height), less)
    calls["K6 multipass prepass"] = pre
    depth = raster._raster_dense_k6(*pre)[0][:sc.height].contiguous()
    calls["K6 multipass lit pass"] = (
        ds.setup, raster._pad_rows(depth), n, float(sc.width),
        float(sc.height), raster._mode_bits(True, False, True, False))
    sc = rs.scene("basic_planes", dev)
    fb, ds = rs.draw_setup(sc, 0.5)
    calls["K6 basic_planes"] = (
        ds.setup, raster._pad_rows(fb.depth),
        raster._fold_bound(ds.inv_w.shape[0], ds.setup.shape[1]),
        float(sc.width), float(sc.height), less)
    out = {k: (raster._raster_dense_k6, a, raster._raster_dense_culled, 6)
           for k, a in calls.items()}
    sc = rs.scene("grid10k", dev)
    fb, ds = rs.draw_setup(sc, 0.5)
    dinit = raster._pad_rows(fb.depth)
    hp, wp = dinit.shape
    b = raster._bin_triangles(ds.setup, wp // raster.TILE_W,
                              hp // raster.TILE_H)
    out["K7 grid10k"] = (raster._raster_binned_k7, (
        b.pack, b.row_begin, b.row_end, dinit, float(sc.width),
        float(sc.height), less), raster._raster_binned_culled, 7)
    count = (b.row_end - b.row_begin)[b.visited]
    rows = dict(tiles=int(b.visited.numel()), visited=int(b.visited.sum()),
                pairs=int(count.sum()), longest=int(count.max()),
                mean=float(count.float().mean()))
    return out, rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="checkout whose kernel sources to time")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_raster: no CUDA device", file=sys.stderr)
        return 2
    from . import raster_scenes as rs
    from .ops import _cuda as cuda
    from .ops import raster

    csrc = (Path(args.tree).resolve() / "ray_eater_tpu_torch" / "csrc"
            if args.tree else cuda._CSRC)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; kernel sources {csrc}", flush=True)
    ptx = ptxas_lines(cuda, csrc, ("raster.cu",)) if args.ptxas else []
    for p in ptx:
        print(f"ptxas {p['source']}: {p['kernel']}: {p.get('registers')} "
              f"registers, {p.get('spill_stores')} bytes spill stores, "
              f"{p.get('spill_loads')} bytes spill loads, {p.get('smem')} "
              "bytes smem", flush=True)
    cuda.load(csrc)
    dev = torch.device("cuda")
    calls, rows = frames(raster, rs, dev)
    print(f"grid10k t=0.5 binned rows: {rows}", flush=True)

    times = {k: [] for k in calls}
    for fn, a, *_ in calls.values():     # warm-up
        fn(*a)
    torch.cuda.synchronize()
    for r in range(REPEAT):
        for label, (fn, a, *_) in calls.items():
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            for _ in range(REPS):
                fn(*a)
            e1.record()
            e1.synchronize()
            times[label].append(e0.elapsed_time(e1) / REPS)
        print(f"repeat {r}: " + ", ".join(
            f"{k} {v[-1]:.4f} ms" for k, v in times.items()), flush=True)
    device = {k: [] for k in calls}
    for r in range(REPEAT):
        for label, (fn, a, *_) in calls.items():
            device[label].append(device_ms(torch, fn, a, fold_kernel))
        print(f"device repeat {r} (fold kernels; the wrapper's other "
              "kernels): " + ", ".join(f"{k} {v[-1][0]:.4f} ({v[-1][1]:.4f})"
                                       for k, v in device.items()),
              flush=True)
    culled = {}
    if hasattr(cuda.lib(), "raster_fold_shape"):
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        for label, (fn, a, twin, kernel) in calls.items():
            fs = raster._fold_shape(kernel, a[-1])
            _, skipped, pairs = twin(*a, foot=fs.foot)
            kept = per_cta(pairs - skipped, fs, raster.TILE_W, raster.TILE_H)
            c = culled[label] = dict(
                shape=fs._asdict(), skipped=int(skipped.sum()),
                pairs=int(pairs.sum()),
                share=float(skipped.sum() / pairs.sum()),
                cta_max=int(kept.max()),
                cta_mean=float(kept[kept > 0].float().mean()),
                sm_mean=float(kept.sum() / sms))
            print(f"{label}: {c['skipped']} of {c['pairs']} (live row, "
                  f"{fs.foot[0]}x{fs.foot[1]} footprint) pairs skipped "
                  f"({c['share']:.4f}); kept pairs a CTA ({fs.ctas} a tile, "
                  f"{fs.region[0]}x{fs.region[1]} px, {fs.resident} "
                  f"resident): max {c['cta_max']}, mean over CTAs with any "
                  f"{c['cta_mean']:.1f}, all over {sms} SMs "
                  f"{c['sm_mean']:.1f} an SM", flush=True)
            torch.cuda.empty_cache()
    else:
        print("these kernel sources report no fold shape "
              "(raster_fold_shape): culled pairs not counted", flush=True)
    print(json.dumps({"csrc": str(csrc), "card": card, "ms": times,
                      "device_ms": {k: [d[0] for d in v]
                                    for k, v in device.items()},
                      "culled": culled, "grid10k_rows": rows,
                      "ptxas": ptx}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
