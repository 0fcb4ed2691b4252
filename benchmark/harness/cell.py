"""One run of one cell: set-up, the measured window, the traced slice,
the check and the metrics, device-agnostic below :func:`run.main` (the
tests drive it on the CPU at a small size)."""

from __future__ import annotations

import time

import numpy as np
import torch

from reference import work

from . import check, scene, spec, trace, traffic, window
from .program import PortFrames

#: replayed frames after the capture, in set-up, before the window
WARM_FRAMES = 3
#: frames of the traced slice
TRACE_FRAMES = 16
#: the window's last seconds, whose host-clock ms a frame the traced
#: slice's device times are held against (both after the slow start)
STEADY_S = 5.0


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             dev: torch.device, t_start: float, program_cls=PortFrames,
             frames: int | None = None, root=None) -> dict:
    """Set-up, window, optional traced slice, check. Returns the run's
    record: ``attempted``, ``window``, ``setup_s`` and its phases,
    ``memory_peak_bytes``, ``capture`` (``render_animation``'s record of
    the capture), ``check`` and, traced, ``trace`` (per-layer metrics,
    busy and window seconds, breakdown). ``frames`` bounds the window by
    frame count instead of ``seconds``."""
    # the reference's colour sums are matrix products: no TF32 there
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    cfg, traf = cell.config, cell.traffic
    phases = {"start": time.perf_counter() - t_start}

    def mark(name):
        if cuda:
            torch.cuda.synchronize(dev)
        phases[name] = time.perf_counter() - t_start
    if cuda:
        torch.zeros((), device=dev)      # the CUDA context
    mark("context")
    cloud = scene.make_cloud(cfg, seed, dev)
    sched = traffic.schedule(traf, seed, dev)
    mark("scene")
    prog = program_cls(cloud, cfg, sched, dev)
    b0 = prog.initial_budget()
    prog.frame(sched.view(0), b0)        # builds or loads, captures
    mark("capture")
    for _ in range(WARM_FRAMES):
        prog.frame(sched.view(0), b0)
    mark("warm")
    setup_s = phases["warm"]

    chk = sched.check
    keep = window.keep_set(seed, chk["start_frames"], chk["stride"])
    w = window.run(prog, sched, None if frames else seconds, keep, dev,
                   budget=b0, frames=frames)

    slice_ = None
    if traced:
        slice_ = _traced_slice(prog, sched, w, dev)
    out = {"attempted": w.frames, "window": w, "setup_s": setup_s,
           "setup_phases": phases}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                if cuda else 0)
    out["capture"] = dict(prog.info)
    prog.release()
    del prog
    if cuda:
        torch.cuda.empty_cache()

    checked = []          # the checked frames' work and times, for mfu.frame

    def on_reference(index, fr):
        if slice_ is not None:
            checked.append((_work(fr, cloud, cfg, sched),
                            w.frame_ms[index]))
    res = check.compare(w.kept, cloud, cfg, sched, seed, cell.limits,
                        check.reference_budget(cfg, sched, dev), on_reference)
    out["check"] = res
    w.kept = []
    if slice_ is not None:
        out["trace"] = _trace_metrics(cell, cloud, cfg, sched, slice_, out,
                                      checked, root)
    return out


def _work(fr, cloud, cfg, sched) -> dict:
    knobs = cfg["knobs"]
    rest = cloud.get("sh_rest")
    return work.frame_work(fr, cloud["means"].shape[0], sched.width,
                           sched.height, knobs["tile_w"],
                           knobs.get("lod_tail_d", 2),
                           0 if rest is None else rest.shape[1])


def _traced_slice(prog, sched, w, dev):
    """``TRACE_FRAMES`` more frames under ``torch.profiler``, each in a
    ``frame`` annotation: the device and host operations, the slice's
    window (first frame's start to last frame's end), each frame's time
    and each frame's (index, budget in)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    def annotate(i):
        return record_function("frame")
    with profile(activities=acts) as prof:
        s = window.run(prog, sched, None, lambda i: True, dev,
                       budget=w.budget, first=w.next_index,
                       frames=TRACE_FRAMES, on_frame=annotate, images=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    dev_ops, host_ops = trace.collect(prof)
    spans = [(a, b) for n, a, b in host_ops if n == "frame"]
    win = (min(a for a, _ in spans), max(b for _, b in spans))
    kept = [(k.index, k.budget_in) for k in s.kept]
    s.kept = []
    return dict(dev_ops=dev_ops, host_ops=host_ops, window=win,
                frame_ms=s.frame_ms, kept=kept)


def _trace_metrics(cell, cloud, cfg, sched, sl, out, checked, root):
    """The per-layer metrics of the traced slice, from each metric's own
    reader; a reader that finds nothing to read returns None and the
    metric is left out."""
    works = []
    for idx, b_in in sl["kept"]:
        fr = check.reference_frame(cloud, cfg, sched, idx, b_in)
        works.append(_work(fr, cloud, cfg, sched))
        del fr
    w = out["window"]
    ctx = trace.TraceContext(device_ops=sl["dev_ops"],
                             host_ops=sl["host_ops"],
                             window_us=sl["window"], frame_ms=sl["frame_ms"],
                             work=works, info=out["capture"],
                             steady_frame_ms=w.steady_ms(STEADY_S),
                             checked=checked)
    metrics = {}
    for m in cell.per_layer:
        v = spec.reader(m["name"], root)(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    busy = trace.busy_us(ctx) / 1e6
    win = (ctx.window_us[1] - ctx.window_us[0]) / 1e6
    return {"metrics": metrics, "busy_s": busy, "window_s": win,
            "breakdown": {"device_ops": trace.device_ops_top(ctx),
                          "idle_gaps": trace.idle_gaps(ctx)}}


def end_to_end(cell: spec.Cell, out: dict) -> dict:
    """The cell's end-to-end metrics among ``frame_ms`` (the window's
    host-clock length over its frames), ``frame_ms_p95`` (the 95th
    percentile of the frames' times) and ``setup_s``."""
    w = out["window"]
    values = {"frame_ms": w.seconds * 1e3 / w.frames,
              "frame_ms_p95": float(np.percentile(w.frame_ms, 95)),
              "setup_s": out["setup_s"]}
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end}
