#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_eater_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ray_eater_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version, and drives the port's two main
paths through ``render_gaussians``, each checked against exact-mode frames
with the PSNR gate of ``bench.py``:

* the fog flythrough (1M splats, 1920x1080, temporal LOD budgets): K1, K2;
* the inria flythrough (1M splats, 1920x1080, side channels, corner fan,
  decimated tail, no temporal budgets): K1, K2 and K3.

Launch counts are zeroed just before each main path and read just after
it; the ``launches`` of the kernels record are their sum over both paths.
Any failed check exits nonzero. The last lines are a ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

W, H = 1920, 1080
N_SPLATS = 1_000_000
FRAMES = 60            # the bench window
GATE_SAMPLES = 6       # sampled times of the PSNR gate
GATE_WARMUP = 8        # temporal lead-in frames before each sampled frame
SMALL = dict(n=40_000, w=480, h=270)   # GPU path vs CPU path check

# tolerances (reasons beside each)
K1_FLOAT_RTOL = 1e-5   # same f32 operands/order both sides (--fmad=false)
K1_INT_SHARE = 1e-4    # radius/rx/ry/valid mismatches allowed, per splat,
K1_INT_MAXDIFF = 1     # ... each off by at most one pixel (ceil edges)
# K2 and K3 vs their plain versions: running product vs cumprod,
# reassociation only
COMP_MAX_ABS = 2e-3
COMP_MEAN_ABS = 1e-5
COMP_EXEC_SHARE = 0.999  # tiles whose exec count must agree exactly
# CUDA render vs CPU render of the same small frame: expf on the card and
# PyTorch's CPU exp may put an alpha on either side of the 1/255 cutoff,
# which moves a pixel by up to ~1/255; such pixels must stay rare
SMALL_EDGE = 2e-3
SMALL_EDGE_SHARE = 1e-4
SMALL_MEAN_ABS = 1e-5
MIN_PSNR = 30.0        # LOD frame vs exact frame, worst sampled frame

# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, f32 FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
K1_OPS_PER_SPLAT = 280   # f32 ops of _cov3d_math + _project_math (source)
K2_OPS_PER_PAIR_PIXEL = 13   # ~12 flops + one expf per executed pair-pixel
REC_BYTES = 9 * 4        # used record columns read per executed row


def log(*a):
    print(*a, flush=True)


class SmokeFailure(Exception):
    pass


def require(cond, what: str):
    if not cond:
        raise SmokeFailure(what)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int, warm: int = 2) -> float:
    """Mean ms per call by CUDA events over ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def f32(x) -> float:
    return float(np.float32(x))


def check_k1(torch, gs, cloud, view, proj, label: str, max_radius: int):
    """K1 vs its plain version on the full cloud at the bench camera."""
    scal = gs._project_scalars(view, proj, W, H, 0.05, float(max_radius))
    args = (cloud.means, cloud.scales, cloud.quats, cloud.opacities, scal)
    k = gs._project_k1(*args)
    p = gs._project_plain(*args)
    torch.cuda.synchronize()
    n = cloud.num_splats
    vk, vp = torch.isfinite(k[5]), torch.isfinite(p[5])
    both = vk & vp
    fk, fp = k[:6][:, both], p[:6][:, both]
    err = (fk - fp).abs()
    rel = float((err / fp.abs().clamp(min=1e-6)).max()) if both.any() else 0.0
    max_abs = float(err.max()) if both.any() else 0.0
    idiff = (k[6:9] - p[6:9]).abs()
    mism = int(((idiff > 0).any(0) | (vk != vp)).sum())
    imax = float(idiff.max())
    clamped = int((k[6] >= max_radius).sum())
    log(f"K1 vs plain [{label}, max_radius {max_radius}]: {n} splats, "
        f"{int(vk.sum())} valid, {clamped} at the radius clamp; float max rel "
        f"{rel:.3e} max abs {max_abs:.3e}; integer/valid mismatches {mism} "
        f"(max diff {imax:g})")
    require(rel <= K1_FLOAT_RTOL, f"K1 float rel err {rel} > {K1_FLOAT_RTOL}")
    require(mism <= K1_INT_SHARE * n and imax <= K1_INT_MAXDIFF,
            f"K1 integer mismatches {mism} (max diff {imax})")
    ms = time_ms(torch, lambda: gs._project_k1(*args), 50)
    plain_ms = time_ms(torch, lambda: gs._project_plain(*args), 10)
    nbytes = n * (12 + 12 + 16 + 4 + 9 * 4) + 24 * 4
    ops = n * K1_OPS_PER_SPLAT
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
    log(f"K1 [{label}] time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B, {ops} ops)")
    return dict(name="K1 project", route="cuda",
                source="ray_eater_tpu_torch/csrc/gs_project.cu",
                replaces="ray_eater_tpu/ops/gs.py:370",
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def check_composite(torch, name: str, replaces: str, call, plain, args,
                    tiles, entry_planes: int, label: str, reps: int):
    """A composite kernel (K2 or K3) vs its plain version on one frame's
    packed records and row ranges (``args``): planes compared on the
    ``tiles`` mask, exec counts on every tile, then both timed.
    ``entry_planes`` counts the (ntiles, pix) planes the kernel reads
    besides the records (K3's entry T) for the bound."""
    pk, ek = call(*args)
    pp, ep = plain(*args)
    torch.cuda.synchronize()
    err = (pk - pp).abs()[:, tiles]
    max_abs = float(err.max()) if err.numel() else 0.0
    mean_abs = float(err.mean()) if err.numel() else 0.0
    _, ntiles, pix = pk.shape
    same = float((ek == ep).float().mean())
    executed = int(ek.sum())
    with_rows = args[2] > args[1]
    skipped = int((with_rows & (ek == 0)).sum())
    log(f"{name} vs plain [{label}]: {ntiles} tiles x {pix} samples, "
        f"{int(with_rows.sum())} with rows ({skipped} skipped at entry), "
        f"{int(tiles.sum())} compared, "
        f"{args[0].shape[0]} packed rows, {executed} executed (longest tile "
        f"{int(ek.max())}); planes max abs {max_abs:.3e} mean abs "
        f"{mean_abs:.3e}; exec equal on {same * 100:.3f}% of tiles")
    require(max_abs <= COMP_MAX_ABS and mean_abs <= COMP_MEAN_ABS,
            f"{name} [{label}] planes differ: max {max_abs} mean {mean_abs}")
    require(same >= COMP_EXEC_SHARE, f"{name} [{label}] exec equal on {same}")
    ms = time_ms(torch, lambda: call(*args), reps)
    plain_ms = time_ms(torch, lambda: plain(*args), 2, warm=1)
    # rows read once, row ranges read, entry planes read, 4 planes written
    nbytes = (executed * REC_BYTES + ntiles * (2 * 4 + 4)
              + (4 + entry_planes) * ntiles * pix * 4)
    ops = executed * pix * K2_OPS_PER_PAIR_PIXEL
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, ops / F32_FLOPS * 1e3
    log(f"{name} [{label}] time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{max(t_bytes, t_ops):.4f} ms ({nbytes} B, {ops} ops)")
    return dict(name=name, route="cuda",
                source="ray_eater_tpu_torch/csrc/gs_composite.cu",
                replaces=replaces, max_abs_err=max_abs, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def check_k2(torch, gs, lay, label: str, reps: int):
    """K2 vs its plain version on one frame's head layout."""
    b = lay.binned
    log(f"K2 [{label}]: {int(b.visited.sum())} visited tiles, "
        f"{int(b.kept.sum())} pairs kept")
    return check_composite(
        torch, "K2 composite", "ray_eater_tpu/ops/gs.py:1239",
        gs._composite_call, gs._composite_plain,
        (lay.records, b.row_begin, b.row_end, lay.ntx, lay.nty, lay.tile_w),
        b.visited, 0, label, reps)


def check_k3(torch, gs, lay, decim: int, label: str, reps: int):
    """K3 vs its plain version on one frame's packed tail records, tail row
    ranges and the head's decimated entry T (K2 on the head layout)."""
    b = lay.binned
    head, _ = gs._composite_call(lay.records, b.row_begin, b.row_end,
                                 lay.ntx, lay.nty, lay.tile_w)
    td = gs._tail_entry(head[3], b.visited, lay.tile_w, decim)
    log(f"K3 [{label}]: decim {decim}, {int(b.kept_tl.sum())} tail pairs "
        f"granted")
    return check_composite(
        torch, "K3 tail composite", "ray_eater_tpu/ops/gs.py:1416",
        gs._composite_tail_call, gs._composite_tail_plain,
        (lay.records_tl, b.row_begin_tl, b.row_end_tl, td, lay.ntx, lay.nty,
         lay.tile_w, decim),
        torch.ones_like(b.visited), 1, label, reps)


def check_small(torch, gs, scene: str, make_cloud, flythrough_camera,
                kw_meas, kw_exact):
    """The whole slice on CUDA vs on the CPU (plain versions) at a small
    size, LOD and exact."""
    n, w, h = SMALL["n"], SMALL["w"], SMALL["h"]
    for label, kw in ((f"{scene} lod", kw_meas), (f"{scene} exact", kw_exact)):
        outs = []
        for dev in ("cuda", "cpu"):
            cloud = make_cloud(n, dev)
            view, proj = flythrough_camera(0.5, w, h, device=dev)
            kw2 = dict(kw, return_stats=True)
            img, st = gs.render_gaussians(cloud, view, proj, w, h, **kw2)
            outs.append((img.cpu(), {k: v.cpu() for k, v in st.items()}))
        (ig, sg), (ic, sc) = outs
        diff = (ig - ic).abs()
        err = float(diff.max())
        mean = float(diff.mean())
        edge = float((diff > SMALL_EDGE).float().mean())
        same = float((sg["tile_exec"] == sc["tile_exec"]).float().mean())
        log(f"small {label} frame {w}x{h}, {n} splats: CUDA vs CPU max abs "
            f"{err:.3e}, mean abs {mean:.3e}, share of pixels off by more "
            f"than {SMALL_EDGE:g}: {edge:.2e}; tile_exec equal on {same * 100:.2f}% of tiles; "
            f"overflow {int(sg['overflow_pairs'])} vs "
            f"{int(sc['overflow_pairs'])}, big-splat overflow "
            f"{int(sg['overflow_big_splats'])} vs "
            f"{int(sc['overflow_big_splats'])}")
        require(ig.shape == (h, w, 3) and bool(torch.isfinite(ig).all()),
                f"small {label} image shape/finite")
        require(mean <= SMALL_MEAN_ABS and edge <= SMALL_EDGE_SHARE,
                f"small {label}: mean abs {mean}, share off {edge}")


def main_path(torch, gs, cuda, scene: str, cloud, knobs, kw_meas, kw_exact,
              flythrough_camera):
    """One flythrough: a 60-frame LOD window (temporal budgets if the
    scene's knobs say so), then the PSNR gate (6 sampled times, each LOD
    frame — warmed by an 8-frame lead-in when temporal — against exact
    mode). Launch counts are zeroed just before and read just after.
    Returns the launch counts and the frame numbers."""
    mpt, dry_floor = knobs["max_splats_per_tile"], knobs["dry_floor"]
    temporal = knobs["temporal"]
    warmup = GATE_WARMUP if temporal else 0
    tile_w = knobs["tile_w"]
    ntx, nty = gs.num_tiles(W, H, tile_w)
    dev = cloud.means.device
    budget0 = torch.stack([torch.full((ntx * nty,), mpt, dtype=torch.int32,
                                      device=dev),
                           torch.zeros(ntx * nty, dtype=torch.int32,
                                       device=dev)], -1)

    def frame(t, budget):
        view, proj = flythrough_camera(t, W, H, device=dev)
        return gs.render_gaussians(cloud, view, proj, W, H,
                                   lod_budget=budget if temporal else None,
                                   **kw_meas)

    def next_budget(st, budget):
        if not temporal:
            return budget
        return gs.update_lod_budget(st["tile_exec"], mpt, ntx, nty,
                                    st["tile_kept"], st["tile_count"],
                                    dry_floor=dry_floor)

    # warm-up frames, LOD and exact (allocator growth, first launches),
    # outside the counted run
    img, st = frame(0.0, budget0)
    view, proj = flythrough_camera(0.0, W, H, device=dev)
    gs.render_gaussians(cloud, view, proj, W, H, **kw_exact)
    torch.cuda.synchronize()

    cuda.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    budget = budget0
    t_host = time.perf_counter()
    e0.record()
    for i in range(FRAMES):
        img, st = frame(f32(np.float32(i) / np.float32(60.0)), budget)
        finite &= torch.isfinite(img).all()
        budget = next_budget(st, budget)
    e1.record()
    e1.synchronize()
    host_ms = (time.perf_counter() - t_host) * 1e3 / FRAMES
    lod_ms = e0.elapsed_time(e1) / FRAMES
    window_peak = torch.cuda.max_memory_allocated()
    log(f"{scene} LOD window: {FRAMES} frames, {lod_ms:.3f} ms/frame (CUDA "
        f"events), {host_ms:.3f} ms/frame (host clock); last frame "
        f"overflow_pairs {int(st['overflow_pairs'])}, overflow_big_splats "
        f"{int(st['overflow_big_splats'])}, lossless "
        f"{bool(st['lossless'])}; peak memory {window_peak / 2**30:.2f} GiB")
    require(img.shape == (H, W, 3), f"{scene} image shape {tuple(img.shape)}")
    require(bool(finite), f"non-finite pixels in the {scene} LOD window")

    psnrs, drops, bigdrops, certs, exact_ms = [], [], [], [], []
    for k in range(GATE_SAMPLES):
        ts = np.float32((FRAMES - 1) * k / (GATE_SAMPLES - 1) / 60.0)
        b = budget0
        for i in range(warmup):
            t = np.float32(ts - np.float32(warmup - i) / np.float32(60.0))
            _, st = frame(f32(t), b)
            b = next_budget(st, b)
        a, st = frame(f32(ts), b)
        view, proj = flythrough_camera(f32(ts), W, H, device=dev)
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        ref = gs.render_gaussians(cloud, view, proj, W, H, **kw_exact)
        s1.record()
        s1.synchronize()
        exact_ms.append(s0.elapsed_time(s1))
        require(bool(torch.isfinite(a).all() & torch.isfinite(ref).all()),
                f"non-finite {scene} gate frame at t={ts}")
        mse = float(torch.mean((a - ref) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-12)))
        drops.append(int(st["overflow_pairs"]))
        bigdrops.append(int(st["overflow_big_splats"]))
        certs.append(bool(st["lossless"]))
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    log(f"{scene} LOD quality vs exact: min %.2f dB over %d sampled frames "
        "[%s]" % (min(psnrs), GATE_SAMPLES,
                  " ".join(f"{p:.2f}" for p in psnrs)))
    log(f"{scene} LOD pairs dropped per sampled frame: {drops}")
    log(f"{scene} big/mid/corner-splat budget overflow per sampled frame "
        f"(printed, not gated): {bigdrops}")
    log(f"{scene} saturation-certified lossless frames: {certs}")
    log(f"{scene} exact frame ms (CUDA events, per sampled frame): "
        + " ".join(f"{m:.3f}" for m in exact_ms))
    log(f"{scene} launches over the main path ({FRAMES} window frames + "
        f"{GATE_SAMPLES} x ({warmup} + 1) gate LOD frames + "
        f"{GATE_SAMPLES} exact frames): {launches}")
    log(f"{scene} peak memory over the main path: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(min(psnrs) >= MIN_PSNR,
            f"{scene} min PSNR {min(psnrs)} < {MIN_PSNR}")
    return launches


def run() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    from ray_eater_tpu_torch.bench_knobs import (flythrough_camera,
                                                 render_kwargs,
                                                 resolve_knobs)
    from ray_eater_tpu_torch.models.gaussians import inria_cloud, random_cloud
    from ray_eater_tpu_torch.ops import _cuda as cuda
    from ray_eater_tpu_torch.ops import gs

    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = cuda.build()
    cuda.lib()
    log(f"kernel build + load: {time.perf_counter() - t0:.2f} s ({so.name})")

    # ---- fog: K1, K2 -------------------------------------------------------
    dev = torch.device("cuda")
    knobs = resolve_knobs("fog", N_SPLATS, env={})
    kw_meas = render_kwargs(knobs, exact=False, interpret=False)
    kw_exact = render_kwargs(knobs, exact=True, interpret=False)
    log("fog knobs: " + " ".join(f"{k}={v}" for k, v in knobs.items()))
    t0 = time.perf_counter()
    cloud = random_cloud(N_SPLATS, seed=1, extent=1.0,
                         scale_range=(0.004, 0.02), device=dev)
    log(f"fog cloud: {N_SPLATS} splats in {time.perf_counter() - t0:.2f} s")

    view, proj = flythrough_camera(0.0, W, H, device=dev)
    k1 = check_k1(torch, gs, cloud, view, proj, "fog, t=0",
                  gs.level1_max_radius(gs.KY))

    ntx, nty = gs.num_tiles(W, H, knobs["tile_w"])
    budget0 = torch.stack([
        torch.full((ntx * nty,), knobs["max_splats_per_tile"],
                   dtype=torch.int32, device=dev),
        torch.zeros(ntx * nty, dtype=torch.int32, device=dev)], -1)
    lay_lod = gs._frame_layout(
        cloud, view, proj, W, H,
        pairs_cap_factor=kw_meas["pairs_cap_factor"],
        max_splats_per_tile=kw_meas["max_splats_per_tile"],
        lod_budget=budget0, tile_w=knobs["tile_w"])
    k2 = check_k2(torch, gs, lay_lod, "fog LOD frame, t=0", reps=20)
    del lay_lod
    lay_exact = gs._frame_layout(cloud, view, proj, W, H,
                                 pairs_cap_factor=None,
                                 tile_w=knobs["tile_w"])
    k2_exact = check_k2(torch, gs, lay_exact, "fog exact frame, t=0", reps=5)
    del lay_exact
    torch.cuda.empty_cache()

    check_small(torch, gs, "fog",
                lambda n, d: random_cloud(n, seed=2, extent=1.0,
                                          scale_range=(0.004, 0.02),
                                          device=d),
                flythrough_camera, kw_meas, kw_exact)

    fog_launches = main_path(torch, gs, cuda, "fog", cloud, knobs, kw_meas,
                             kw_exact, flythrough_camera)
    for key, name in (("k1_project", "K1"), ("k2_composite", "K2")):
        require(fog_launches[key] > 0, f"{name} was not launched on the fog "
                "main path")
    log(f"K2 fog exact frame: {k2_exact['ms']:.4f} ms, plain "
        f"{k2_exact['plain_ms']:.4f} ms, bound {k2_exact['bound_ms']:.4f} "
        f"ms ({k2_exact['bound_by']})")
    del cloud
    torch.cuda.empty_cache()

    # ---- inria: K1 at the coarse fan's radius ceiling, K2, K3 --------------
    knobs = resolve_knobs("inria", N_SPLATS, env={})
    kw_meas = render_kwargs(knobs, exact=False, interpret=False)
    kw_exact = render_kwargs(knobs, exact=True, interpret=False)
    log("inria knobs: " + " ".join(f"{k}={v}" for k, v in knobs.items()))
    tile_w, decim = knobs["tile_w"], knobs["lod_tail_d"]
    t0 = time.perf_counter()
    cloud = inria_cloud(N_SPLATS, seed=1, device=dev)
    log(f"inria cloud: {N_SPLATS} splats in {time.perf_counter() - t0:.2f} s")
    view, proj = flythrough_camera(0.0, W, H, device=dev)
    k1_inria = check_k1(torch, gs, cloud, view, proj, "inria, t=0",
                        gs.level2_max_radius(tile_w))
    lay = gs._frame_layout(
        cloud, view, proj, W, H, **{k: kw_meas[k] for k in (
            "pairs_cap_factor", "max_splats_per_tile", "big_splat_cap",
            "mid_splat_cap", "mid_lo_splat_cap", "corner_cap", "tile_w",
            "lod_tail_decim")})
    log(f"inria LOD layout, t=0: overflow_pairs {int(lay.binned.overflow)}, "
        f"overflow_big_splats {int(lay.binned.overflow_big)}, head pairs "
        f"kept {int(lay.binned.kept.sum())}, tail pairs kept "
        f"{int(lay.binned.kept_tl.sum())} of {int(lay.binned.count.sum())}")
    k2_inria = check_k2(torch, gs, lay, "inria LOD head, t=0", reps=20)
    k3 = check_k3(torch, gs, lay, decim, "inria LOD tail, t=0", reps=20)
    del lay
    torch.cuda.empty_cache()

    check_small(torch, gs, "inria",
                lambda n, d: inria_cloud(n, seed=1, device=d),
                flythrough_camera,
                render_kwargs(resolve_knobs("inria", SMALL["n"], env={}),
                              exact=False, interpret=False),
                render_kwargs(resolve_knobs("inria", SMALL["n"], env={}),
                              exact=True, interpret=False))

    inria_launches = main_path(torch, gs, cuda, "inria", cloud, knobs,
                               kw_meas, kw_exact, flythrough_camera)
    for key, name in (("k1_project", "K1"), ("k2_composite", "K2"),
                      ("k3_composite_tail", "K3")):
        require(inria_launches[key] > 0, f"{name} was not launched on the "
                "inria main path")
    for d in (k1_inria, k2_inria):
        log(f"{d['name']} [inria, t=0]: {d['ms']:.4f} ms, plain "
            f"{d['plain_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms "
            f"({d['bound_by']}), max abs err {d['max_abs_err']:.3e}")

    k1["launches"] = fog_launches["k1_project"] + inria_launches["k1_project"]
    k2["launches"] = (fog_launches["k2_composite"]
                      + inria_launches["k2_composite"])
    k3["launches"] = (fog_launches["k3_composite_tail"]
                      + inria_launches["k3_composite_tail"])
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"card: {card}")
    print(json.dumps({"kernels": [{k: d[k] for k in keys}
                                  for d in (k1, k2, k3)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(run())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
