"""Time the composite kernels K2, K3, K4 and K5 at the sizes of the main
paths.

    python3 -m ray_eater_tpu_torch.time_composite [--tree DIR] [--ptxas]

Builds the frames that ``chip_smoke.py`` checks, at 1M splats and
1920x1080: the fog LOD and exact frames at t=0 (K2 at tile_w 32), the
inria LOD head at t=0 (K2 at tile_w 64) and its decimated tail (K3 at
tile_w 64, decim 4, entered at the head's T decimated by
``gs._tail_entry``), all from ``bench_knobs.layout_kwargs``, and the
trainer's first frame (``gs_trainer.first_frame``, tile_w 128, mpt 256:
K2 without gradients, K4, and K5 on K4's outputs with the MSE
cotangent). Prints, per repeat, each kernel's ms by CUDA events over
``REPS`` back-to-back calls of its wrapper; then, per repeat, the device
time a call of the composite kernels alone (and of the wrapper's other
kernels) under ``torch.profiler``; then one JSON line.
``--ptxas`` first compiles the composite sources with ``-Xptxas -v`` (the
port's flags) and prints each kernel's registers, spill bytes and shared
memory.

``--tree`` takes the kernel sources from another checkout's
``ray_eater_tpu_torch/csrc`` (same C entry points) and times them under
this package's wrappers and frames, so that two versions of the kernels
are compared on the same inputs. Needs a CUDA device; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

REPEAT = 3     # timed repeats of every kernel
REPS = 20      # back-to-back calls a repeat


def ptxas_lines(cuda, csrc: Path,
                sources=("gs_composite.cu", "gs_composite_bwd.cu")
                ) -> list[dict]:
    """Registers, spill stores/loads and shared bytes of every kernel in
    ``sources`` of ``csrc``."""
    cuda._BUILD.mkdir(parents=True, exist_ok=True)
    obj = cuda._BUILD / f"ptxas.{os.getpid()}.o"
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    rows = []
    for name in sources:
        cmd = [cuda._nvcc(), *cuda._FLAGS, "-Xptxas", "-v", "-c", "-o",
               str(obj), str(csrc / name)]
        r = subprocess.run(cmd, capture_output=True, text=True, check=True)
        obj.unlink(missing_ok=True)
        for line in r.stderr.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
                if filt:
                    fn = subprocess.run([filt, fn], capture_output=True,
                                        text=True).stdout.strip() or fn
                rows.append(dict(source=name, kernel=fn))
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m and rows:
                rows[-1].update(spill_stores=int(m.group(1)),
                                spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?",
                          line)
            if m and rows:
                rows[-1].update(registers=int(m.group(1)),
                                smem=int(m.group(2) or 0))
    return rows


def composite_kernel(name: str) -> bool:
    return "composite" in name or "tail_" in name


def device_ms(torch, fn, a, timed=composite_kernel):
    """Device ms a call of ``fn(*a)`` under ``torch.profiler`` over
    ``REPS`` calls: (the timed kernels', the wrapper's other kernels',
    {kernel name: ms} of the timed kernels); ``timed`` picks them by name
    (the composite kernels by default). The wrapper's host work (its small
    PyTorch ops and the launch) is left out; the event times include it
    where the host is slower than the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):      # a trace can come back without the kernels
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                fn(*a)
            torch.cuda.synchronize()
        other, kern = 0.0, {}
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.is_user_annotation:
                continue
            ms = e.self_device_time_total / 1e3 / REPS
            name = re.search(r"(\w+_kernel)\b", e.key)
            if name and timed(name[1]):
                kern[name[1]] = kern.get(name[1], 0.0) + ms
            else:
                other += ms
        if kern:
            break
    else:
        raise RuntimeError("the profiler saw none of the timed kernels")
    return sum(kern.values()), other, kern


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--tree", default=None,
                    help="checkout whose kernel sources to time")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_composite: no CUDA device", file=sys.stderr)
        return 2
    from . import gs_trainer
    from .bench_knobs import (bench_cloud, flythrough_camera, layout_kwargs,
                              resolve_knobs)
    from .ops import _cuda as cuda
    from .ops import gs

    csrc = (Path(args.tree).resolve() / "ray_eater_tpu_torch" / "csrc"
            if args.tree else cuda._CSRC)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(f"card: {card}; kernel sources {csrc}", flush=True)
    ptx = ptxas_lines(cuda, csrc) if args.ptxas else []
    for p in ptx:
        print(f"ptxas {p['source']}: {p['kernel']}: {p.get('registers')} "
              f"registers, {p.get('spill_stores')} bytes spill stores, "
              f"{p.get('spill_loads')} bytes spill loads, {p.get('smem')} "
              "bytes smem", flush=True)
    cuda.load(csrc)
    W, H, n = 1920, 1080, 1_000_000
    dev = torch.device("cuda")
    view, proj = flythrough_camera(0.0, W, H, device=dev)
    calls = {}     # label -> (wrapper, args)
    for scene, frames in (("fog", (("LOD", False), ("exact", True))),
                          ("inria", (("LOD head", False),))):
        knobs = resolve_knobs(scene, n, env={})
        cloud = bench_cloud(scene, n, dev)
        for label, exact in frames:
            lay = gs._frame_layout(cloud, view, proj, W, H, **layout_kwargs(
                knobs, exact, W, H, dev))
            b = lay.binned
            head = (lay.records, b.pack_idx, b.row_begin, b.row_end,
                    lay.ntx, lay.nty, lay.tile_w)
            calls[f"K2 {scene} {label}"] = (gs._composite_call, head)
            if scene == "inria":      # chip_smoke.py's check_k3
                decim = knobs["lod_tail_d"]
                td = gs._tail_entry(gs._composite_call(*head)[0][3],
                                    b.visited, lay.tile_w, decim)
                calls[f"K3 {scene} tail"] = (gs._composite_tail_call, (
                    lay.records, b.pack_idx_tl, b.row_begin_tl,
                    b.row_end_tl, td, lay.ntx, lay.nty, lay.tile_w, decim))
        del cloud, lay, b, head
    torch.cuda.empty_cache()

    _, targs, (planes, ex, ck, off), dplanes, _ = gs_trainer.first_frame(
        n, W, H, dev)
    # K2 on the training frame's packed rows: an identity layout
    rows = torch.arange(targs[0].shape[0], dtype=torch.int32, device=dev)
    calls["K2 training frame"] = (gs._composite_call, (targs[0], rows,
                                                       *targs[1:]))
    calls["K4 training frame"] = (gs._composite_call_ckpt, targs)
    calls["K5 training frame"] = (gs._composite_bwd_call, (
        *targs[:3], ex, off, ck, planes, dplanes, *targs[3:]))

    times = {k: [] for k in calls}
    for fn, a in calls.values():      # warm-up
        fn(*a)
    torch.cuda.synchronize()
    for r in range(REPEAT):
        for label, (fn, a) in calls.items():
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
        for label, (fn, a) in calls.items():
            device[label].append(device_ms(torch, fn, a))
        print(f"device repeat {r} (composite kernels; the wrapper's other "
              "kernels): " + ", ".join(f"{k} {v[-1][0]:.4f} ({v[-1][1]:.4f})"
                                       for k, v in device.items()),
              flush=True)
    for k, v in device.items():
        if len(v[-1][2]) > 1:
            print(f"device repeat {REPEAT - 1}, {k}: " + ", ".join(
                f"{n} {ms:.4f}" for n, ms in v[-1][2].items()), flush=True)
    print(json.dumps({"csrc": str(csrc), "card": card, "ms": times,
                      "device_ms": {k: [d[0] for d in v]
                                    for k, v in device.items()},
                      "ptxas": ptx}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
