#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``ray_eater_tpu_torch``).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``ray_eater_tpu_torch/csrc/``, holds each
kernel against its plain PyTorch version, and drives the port's main paths:

* the fog flythrough (1M splats, 1920x1080, temporal LOD budgets) through
  ``render_gaussians``, checked against exact-mode frames with the PSNR gate
  of ``bench.py``: K1, K2 (K2 is also checked on the training frame's
  layout at tile_w 128);
* the inria flythrough (1M splats, 1920x1080, side channels, corner fan,
  decimated tail, no temporal budgets), gated the same way: K1, K2 and K3;
* training: ``gs_trainer.train`` (``make_train_step_pallas``, 1M splats at
  1920x1080, one warm-up and 20 timed steps, the loss must fall): K4, K5;
* adaptive density control: ``gs_trainer.train_adc`` (960x540, a
  16,384-splat hidden scene, capacity 65,536, 8 views, 300 steps with one
  densify event; the live count must grow): K4, K5;
* triangle raster and texture sampling: ``python -m
  ray_eater_tpu_torch.basic_planes`` (900x600, 60 frames): K6;
  ``python -m ray_eater_tpu_torch.multipass`` (1920x1080, depth prepass +
  LESS_EQUAL lit pass, 60 frames): K6 twice a frame; and the
  10,082-triangle measurement grid of ``tools/profile_raster.py`` at
  1920x1080 through ``render_mesh`` with a trilinear anisotropic sampler
  (60 frames; the subtile sampler's frame gated at >= 30 dB PSNR against
  the per-pixel gather sampler): K7, K8, K9. The last frames of
  basic_planes, multipass and the grid are written to ``chiprun_out/raster/``;
* the compute_drawing sample: ``python -m
  ray_eater_tpu_torch.compute_drawing`` (1024 particles splatted once into
  a 900x600 image, then 60 frames drawing it on a fullscreen quad; the
  presented frame must be the splatted image): K10, K6. Its last frame goes
  to ``chiprun_out/compute_drawing/``. K10 is also checked on 65,536
  particles at 1920x1080 (with off-image boxes, and the sample's draw at
  that size), with its device ms under ``torch.profiler`` beside the
  device ms of one empty kernel (the launch floor);
* SH colours from a PLY: a 1M-splat degree-3 cloud written by ``save_ply``
  and read back by ``load_ply`` (the file is deleted afterwards), then the
  frames of ``python -m ray_eater_tpu_torch.gs_viewer`` at its defaults
  (1920x1080, LOD with temporal budgets, colours evaluated at the eye),
  gated like the fog flythrough: K1, K2.

* the animation phase: ``render_animation(keep="all")`` over 60 frames,
  replayed as a captured CUDA graph, against the eager loop over the same
  frame step on the card (``render_animation_eager``), u8 for u8, for fog,
  inria, SH (gs_viewer), basic_planes, multipass (through its
  ``RenderGraph``), grid10k and compute_drawing at their full sizes; the
  final LOD budget (the carry) of fog and SH equal too; ms/frame of
  replay and of the eager loop, and the capture's seconds;
* the Swapchain phase: ``basic_planes --host-loop`` presents all 60
  frames through the ring in FIFO order;
* the native tier: its g++ build's seconds, and its ``read_ply`` of the
  248 MB degree-3 PLY equal to the numpy reader, with each one's seconds
  (``load_ply`` then reads through it);
* textured basic_planes: the checkerboard written with ``encode_png``,
  found through ``$RAYEATER_TEXTURE`` and read back by
  ``texture_from_file``; 60 replayed frames u8-equal to the array
  texture's, and the entry point's last frame too;
* the viewer: ``gs_viewer --serve``'s frame builder (``ServeFrames``) on
  the SH cloud at 1920x1080, each replayed frame (and its next budget)
  equal to the eager frame at the same camera and budget over orbit,
  zoom and budget steps; ms a served frame; the capture's seconds at each
  extent of a resize round trip (1080p, 720p, 1080p), the graph cache no
  larger after it; and ``--serve`` without PIL exits 2 with its message;
* baked frames: the fog frame (1M / 1080p, the budget carried) and the
  multipass RenderGraph frame (1080p) through ``save_baked`` and
  ``load_baked``: seconds to save and to load, file size, loaded output
  bit-equal to the unbaked frame, and an 8-frame ``render_animation`` of
  the loaded fog program u8-equal to the unbaked one's;
* ``lod_tail`` fog: the PSNR gate's samples with the slab proxy, beside
  the same figure without it (printed, not gated);
* K9's bfloat16-window instantiation (``texture_from_array``'s
  ``window_dtype``) against its plain version on the grid10k frame,
  timed beside the float32 windows (logged, not in the kernels line);
* the API phase: ``import ray_eater_tpu_torch as re`` resolves the 38
  names of the JAX package's API; ``hello`` on the card; one fog frame (1M
  splats, 1920x1080, the fog knobs) through ``re.render_gaussians`` on
  ``re.random_cloud``, bit-equal to the fog cell's ``ops.gs`` frame (K1,
  K2); ``basic_planes --save-every 20`` over 60 frames, frames 0, 20 and
  40 u8-equal to a ``render_animation(keep="all")`` of the same step (K6);
  ``compute_drawing --device-loop`` presenting the default run's frame
  (K10, K6); ``psnr_report`` against its float64 oracles, each of its
  three lines at least 40 dB and the figures on a ``{"psnr": {...}}``
  line; the phase's seconds. Its launches go into the kernels line;
* the multi-device phase: D = ``torch.cuda.device_count()`` ranks spawned
  with NCCL, one card each (``make_device_mesh``). Each rank renders fog
  (1M splats, 1920x1080, its temporal budget carried over 8 frames)
  through ``render_gaussians_sharded`` with the all_gather and the ring
  exchange, inria (K3 in the band) and fog's exact sort-last frame
  (``render_gaussians_depth_sliced``), grid10k through
  ``render_mesh_sharded`` (K7, K8, K9) and five ``make_train_step_dp``
  steps at ``gs_trainer``'s defaults, each held to the single-device
  frames or steps of the same inputs within JAX's own bounds (LOD mean
  5e-3, exact max 1e-4; raster 2e-5 on all but 0.5% of the pixels, at
  D > 1 the textured colour by the 30 dB subtile gate; loss rtol 1e-5,
  means 1e-6); at D = 1 one sharded fog frame step also goes
  through the animation phase (captured, replay u8-equal to eager). Each
  rank's launches of K1, K2, K3, K7, K8 and K9 over the sharded paths
  must be above zero and go into the kernels line.

Every kernel is called through its ``torch.library`` custom op
(``rayeater::k1_project`` .. ``k10_splat``, ``sh_colors``), whose CUDA
implementation launches it and counts the launch. The SH colour kernel
is checked against its plain version and timed on the SH path's 1M-splat
cloud, its record last in the kernels line, and counts one launch for
every frame of an SH cloud and none elsewhere.

The entry points (basic_planes, multipass, compute_drawing) run their
default device loop, ``render_animation``: two eager warm-up steps, then
their frames replay a captured CUDA graph. A wrapper's launch counter
advances where the wrapper launches its kernel (the eager frames and
warm-up steps), and ``render_animation`` adds the launches of one
captured step for every replayed frame; the capture itself launches
nothing and counts nothing. Launch counts are zeroed just before each
main path and read just after it; the ``launches`` of the kernels record
are their sum over the paths. The launches of one replayed frame are
logged with each path, and a device-loop path must count exactly its
warm-up steps and replayed frames.
Any failed check exits nonzero. The last lines are a ``{"kernels": [...]}``
record and ``{"ok": true, "device": {...}}``. Without a CUDA device it
exits 2 and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
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
# K5 vs its plain version, relative to the plain version's largest
# |gradient|: reassociated sums, global atomics in no fixed order
K5_REL = 1e-4
# GPU vs CPU gradients of one small render_gaussians_diff, relative to
# the largest |gradient| of the CPU run: the plain projection's radii and
# the 1/255 cutoff could land on either side of an edge on the two devices
TRAIN_SMALL_REL = 1e-3
TRAIN = dict(n=N_SPLATS, w=1920, h=1080, steps=21)   # 1 warm-up + 20 timed
ADC_ARGS = ["--adc", "--splats", "16384", "--capacity", "65536", "--views",
            "8", "--width", "960", "--height", "540", "--densify-every",
            "100", "--steps", "300"]

# H100 SXM peaks (NVIDIA data sheet, at 700 W): HBM bytes/s, f32 FLOP/s
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# expf per second: its MUFU.EX2 runs 16 a clock per SM on Hopper (NVIDIA's
# CUDA C++ documentation, arithmetic instruction throughput, compute
# capability 9.0), 132 SMs at the H100 SXM's 1.98 GHz boost clock. The
# composites' SFU term counts one expf per executed pair-sample whose
# alpha can reach 1/255 (power not below the cull threshold, pair_counts):
# the others contribute nothing, so the function needs no expf for them
SFU_EXP_PER_S = 132 * 16 * 1.98e9
K1_OPS_PER_SPLAT = 280   # f32 ops of _cov3d_math + _project_math (source)
K2_OPS_PER_PAIR_PIXEL = 13   # ~12 flops + one expf per executed pair-pixel
# K5's operations per executed pair-sample, counted from gs_composite_bwd.cu
# (expf as one): every pair finds its alpha; a pair at or above the 1/255
# floor adds the colour terms; one below the 0.99 clamp adds dL/dalpha
K5_OPS_ALPHA, K5_OPS_LIVE, K5_OPS_UNCLAMPED = 15, 17, 30
REC_BYTES = 9 * 4        # used record columns read per executed row
GRAD_BYTES = 12 * 4      # K5's gradient row written per executed row

# particle splat (K10), compute_drawing and the SH path
DRAWING_OUT = "chiprun_out/compute_drawing"
DRAWING_SMALL = (300, 200)
K10_WIDE = dict(w=1920, h=1080, n=65_536, margin=40, r=20)
SH_PLY = "chiprun_out/sh_1m.ply"   # written, read back and deleted
SH_SMALL = 20_000
SH_EYE = (2.0, 0.8, 1.0)
# CUDA vs CPU SH colours: the direction's norm and the band products may
# round differently (sqrt, division)
SH_TOL = 1e-6
SH_OPS_PER_SPLAT = 153   # degree-3 SH colour's float32 operations a splat
# PLY round trip of the activated fields: logit/sigmoid, log/exp and the
# DC decode in float32
SH_PLY_TOL = 1e-5

# raster and sampling (K6-K9)
RASTER_FRAMES = 60
BUSY_FRAMES = 10         # replayed frames traced for the device-busy share
RASTER_OUT = "chiprun_out/raster"
# K6/K7 vs plain: winner ids equal, λ0/λ1/depth where they agree, and K9:
# the same float32 operations in the same order (--fmad=false)
RASTER_TOL = 1e-6
SUBTILE_MIN_PSNR = 30.0  # subtile sampler frame vs per-pixel gather frame
# CUDA render vs CPU render of the small grid frame: the same operations,
# but CUDA's and the CPU's pow/log2/sqrt may differ by an ulp, which can
# move a knife-edge pixel's winner or a subtile's LOD fraction
SMALL_RASTER_COLOR = 2e-5
SMALL_RASTER_SHARE = 1e-3
FOLD_OPS = 14            # f32 operations per evaluated (row, pixel) pair
SETUP_ROW_BYTES = 16 * 4  # one setup/pack row
SUBTILE_PIXEL_BYTES = 52  # K9: 9 coordinate planes read, 4 channels written

# ---- this slice's phases ------------------------------------------------------
#: the checkerboard as a PNG file, read back through texture_from_file
TEXTURE_PNG = "chiprun_out/raster/checker.png"
#: the serve loop's camera states (azimuth, height, radius): orbit steps,
#: a height change and zooms in and out, each frame under the budget the
#: frame before left
VIEWER_STEPS = ((0.0, 0.8, 2.5), (0.05, 0.8, 2.5), (0.5, 1.1, 2.5),
                (0.5, 1.1, 1.6), (0.9, 0.4, 1.6), (1.3, 0.4, 3.2))
VIEWER_SERVED = 30       # timed served frames at 1080p
VIEWER_RESIZE = ((1280, 720), (1920, 1080))   # the resize round trip
BAKED_FRAMES = 8         # frames of a baked program held to the unbaked

# ---- the multi-device phase -------------------------------------------------
#: the JAX package's public API (``ray_eater_tpu.__all__``), which the
#: port's top level exports under the same names
API_NAMES = (
    "rmath", "Context", "ContextConfig", "Framebuffer", "Texture", "Sampler",
    "Filter", "AddressMode", "Swapchain", "render_animation",
    "GraphicsPipeline", "ComputePipeline", "RasterState", "CullMode",
    "FrontFace", "CompareOp", "BlendMode", "shaders", "render_mesh", "Mesh",
    "mesh", "two_planes", "fullscreen_quad", "clear", "create_framebuffer",
    "texture_from_array", "texture_from_file", "render_gaussians",
    "GaussianCloud", "gaussian_cloud", "random_cloud", "load_ply",
    "save_ply", "eval_sh_colors", "load_obj", "RenderGraph", "FrameProgram",
    "load_baked")
API_OUT = "chiprun_out/api"
API_SAVE_EVERY = 20      # basic_planes --save-every over RASTER_FRAMES frames
API_MIN_PSNR = 40.0      # each line of psnr_report against its oracle
MD_FRAMES = 8            # fog frames, the temporal budget carried
MD_INRIA_FRAMES = 2
MD_TRAIN_STEPS = 5       # make_train_step_dp steps at gs_trainer's defaults
# a sharded frame against the single-device frame: JAX's own bounds
# (tests/test_parallel.py:44, :72): exact mode max, LOD mode mean (each
# band grants its own pool; at D = 1 the band is the frame)
MD_EXACT_MAX = 1e-4
MD_LOD_MEAN = 5e-3
# the sharded raster: within 2e-5 but on 0.5% of the pixels (knife edges:
# the c + b*y0 shift rounds once more than the frame's planes); at D > 1
# the textured colour by SUBTILE_MIN_PSNR (per-band subtile plans)
MD_RASTER_TOL = 2e-5
MD_RASTER_SHARE = 5e-3
# make_train_step_dp against make_train_step (tests/test_gs_training.py:
# 194-196): the band losses' mean reassociates
MD_LOSS_RTOL = 1e-5
MD_MEANS_ATOL = 1e-6


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


def kernel_record(torch, name: str, source: str, replaces: str, call, plain,
                  args, max_abs: float, nbytes: int, ops: int, label: str,
                  reps: int, plain_reps: int = 2, exps: int = 0):
    """Times the kernel's wrapper ``call`` and its plain version on
    ``args`` by CUDA events and returns its record of the kernels line; the
    bound is the largest of ``nbytes`` over the HBM rate, ``ops`` over the
    f32 rate and ``exps`` (the expf calls the function needs) over the
    SFU's rate. ``bound_by``
    names bytes or operations; the log line says whether the operations
    term was the f32 or the SFU one."""
    ms = time_ms(torch, lambda: call(*args), reps)
    plain_ms = time_ms(torch, lambda: plain(*args), plain_reps, warm=1)
    terms = {"bytes": nbytes / HBM_BPS * 1e3, "f32": ops / F32_FLOPS * 1e3,
             "sfu": exps / SFU_EXP_PER_S * 1e3}
    by = max(terms, key=terms.get)
    log(f"{name} [{label}] time {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{terms[by]:.4f} ms by {by} ({nbytes} B: {terms['bytes']:.4f} ms; "
        f"{ops} f32 ops: {terms['f32']:.4f} ms; {exps} expf: "
        f"{terms['sfu']:.4f} ms)")
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=terms[by],
                bound_by="bytes" if by == "bytes" else "operations",
                library_ms=None)


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
    return kernel_record(
        torch, "K1 project", "ray_eater_tpu_torch/csrc/gs_project.cu",
        "ray_eater_tpu/ops/gs.py:370", gs._project_k1, gs._project_plain,
        args, max_abs, n * (12 + 12 + 16 + 4 + 9 * 4) + 24 * 4,
        n * K1_OPS_PER_SPLAT, label, reps=50, plain_reps=10)


def pair_counts(torch, gs, records, row_begin, exec_, geom, foot=None):
    """Counts over a composite's executed pair-samples: every executed row
    of a tile against each of its samples, ``geom`` = (ntx, nty, tile_w,
    decim). ``pairs``; ``reach``, those whose power is not below
    ``gs._cull_threshold`` of the row's opacity, the only ones whose alpha
    can reach the 1/255 floor, so the only expf the function needs;
    ``live``, those whose alpha reaches it (``lost`` counts live pairs
    outside ``reach``: 0 where the cull is exact); ``unclamped``, the live
    ones below the 0.99 clamp. With ``foot`` (columns, rows of K2's warp
    footprint): ``warp_rows``, the (warp, executed row) pairs, and
    ``culled``, those where no sample of the warp reaches, which K2's warp
    row cull skips."""
    ntx, nty, tile_w, decim = geom
    px, py = gs._tile_samples(ntx, nty, tile_w, decim, records.device)
    begin, ex = row_begin.long(), exec_.long()
    pairs = warp_rows = 0
    counts = torch.zeros(5, dtype=torch.int64, device=records.device)
    for r in range(int(ex.max())):        # the r-th executed row of each tile
        t = torch.nonzero(ex > r).flatten()
        rec = records[begin[t] + r]
        dx, dy = px[t] - rec[:, 0:1], py[t] - rec[:, 1:2]
        power = (-0.5 * (rec[:, 2:3] * dx * dx + rec[:, 4:5] * dy * dy)
                 - rec[:, 3:4] * dx * dy)
        reach = ~(power < gs._cull_threshold(rec[:, 5:6]))
        araw = rec[:, 5:6] * torch.exp(power)
        live = araw >= gs._ALPHA_MIN
        culled = torch.zeros((), dtype=torch.int64, device=records.device)
        if foot is not None:
            fw, fh = foot
            warp = reach.reshape(-1, 32 // fh, fh, tile_w // fw, fw)
            warp = warp.any(4).any(2)
            culled, warp_rows = (~warp).sum(), warp_rows + warp.numel()
        pairs += power.numel()
        counts += torch.stack([reach.sum(), live.sum(), (live & ~reach).sum(),
                               (live & (araw < gs._ALPHA_MAX)).sum(), culled])
    c = dict(zip(("reach", "live", "lost", "unclamped", "culled"),
                 map(int, counts)))
    return dict(c, pairs=pairs, warp_rows=warp_rows)


def check_composite(torch, gs, name: str, replaces: str, call, plain, args,
                    geom, tiles, entry_planes: int, label: str, reps: int,
                    foot=None):
    """A composite kernel (K2 or K3) vs its plain version on one frame's
    packed records and row ranges (``args``, sample grid ``geom`` as in
    :func:`pair_counts`): planes compared on the ``tiles`` mask, exec
    counts on every tile, then both timed. ``entry_planes`` counts the
    (ntiles, pix) planes the kernel reads besides the records (K3's entry
    T) for the bound; with K2's ``foot``, the share of (warp, row) pairs
    its warp row cull skips is logged."""
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
    cnt = pair_counts(torch, gs, args[0], args[1], ek, geom, foot)
    log(f"{name} vs plain [{label}]: {ntiles} tiles x {pix} samples, "
        f"{int(with_rows.sum())} with rows ({skipped} skipped at entry), "
        f"{int(tiles.sum())} compared, "
        f"{args[0].shape[0]} packed rows, {executed} executed (longest tile "
        f"{int(ek.max())}); planes max abs {max_abs:.3e} mean abs "
        f"{mean_abs:.3e}; exec equal on {same * 100:.3f}% of tiles; "
        f"{cnt['reach']} of {cnt['pairs']} executed pair-samples can reach "
        f"the alpha floor ({cnt['live']} do, {cnt['lost']} beyond the cull "
        f"threshold)")
    if foot is not None:
        log(f"{name} [{label}]: the warp row cull skips "
            f"{cnt['culled'] / max(cnt['warp_rows'], 1) * 100:.2f}% of the "
            f"(warp, executed row) pairs (footprint {foot[0]} columns x "
            f"{foot[1]} rows)")
    require(max_abs <= COMP_MAX_ABS and mean_abs <= COMP_MEAN_ABS,
            f"{name} [{label}] planes differ: max {max_abs} mean {mean_abs}")
    require(same >= COMP_EXEC_SHARE, f"{name} [{label}] exec equal on {same}")
    require(cnt["lost"] == 0, f"{name} [{label}] {cnt['lost']} pair-samples "
            "reach the alpha floor below the cull threshold")
    # rows read once, row ranges read, entry planes read, 4 planes written
    return kernel_record(
        torch, name, "ray_eater_tpu_torch/csrc/gs_composite.cu", replaces,
        call, plain, args, max_abs,
        executed * REC_BYTES + ntiles * (2 * 4 + 4)
        + (4 + entry_planes) * ntiles * pix * 4,
        executed * pix * K2_OPS_PER_PAIR_PIXEL, label, reps,
        exps=cnt["reach"])


def check_k2(torch, gs, lay, label: str, reps: int):
    """K2 vs its plain version on one frame's head layout, and the share of
    (warp, row) pairs its warp row cull skipped."""
    b = lay.binned
    log(f"K2 [{label}]: {int(b.visited.sum())} visited tiles, "
        f"{int(b.kept.sum())} pairs kept")
    return check_composite(
        torch, gs, "K2 composite", "ray_eater_tpu/ops/gs.py:1239",
        gs._composite_call, gs._composite_plain,
        (lay.records, b.row_begin, b.row_end, lay.ntx, lay.nty, lay.tile_w),
        (lay.ntx, lay.nty, lay.tile_w, 1), b.visited, 0, label, reps,
        foot=gs._composite_footprint(lay.tile_w))


def check_k3(torch, gs, lay, decim: int, label: str, reps: int):
    """K3 vs its plain version on one frame's packed tail records, tail row
    ranges and the head's decimated entry T (K2 on the head layout)."""
    b = lay.binned
    head, _ = gs._composite_call(lay.records, b.row_begin, b.row_end,
                                 lay.ntx, lay.nty, lay.tile_w)
    td = gs._tail_entry(head[3], b.visited, lay.tile_w, decim)
    args = (lay.records_tl, b.row_begin_tl, b.row_end_tl, td, lay.ntx,
            lay.nty, lay.tile_w, decim)
    # the kernel's first pass composites every chunk of a tile that is not
    # skipped at entry, `ctas` CTAs a tile; its merge stops at the vote
    ctas, threads, resident = gs._composite_shape(3, lay.tile_w, decim)
    _, ek = gs._composite_tail_call(*args)
    begin, _, first, nch = gs._chunk_spans(args[1], args[2],
                                           args[0].shape[0])
    ran = gs._executed_chunks(begin, first, ek)
    past = int(torch.where(ran > 0, nch - ran, 0).sum())
    log(f"K3 [{label}]: decim {decim}, {int(b.kept_tl.sum())} tail pairs "
        f"granted; first pass {ctas} CTAs a tile x {threads} threads "
        f"({resident} CTAs resident), {int(ran.sum())} chunks merged of "
        f"{int(nch.sum())} held (longest tail {int(nch.max())} chunks), "
        f"{past} composited past the stop "
        f"({past / max(int(ran.sum()), 1) * 100:.2f}% of those merged)")
    return check_composite(
        torch, gs, "K3 tail composite", "ray_eater_tpu/ops/gs.py:1416",
        gs._composite_tail_call, gs._composite_tail_plain, args,
        (lay.ntx, lay.nty, lay.tile_w, decim), torch.ones_like(b.visited), 1,
        label, reps)


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


class BenchFrames:
    """The frames of a bench flythrough (fog, inria) for :func:`main_path`:
    ``render_gaussians`` on ``flythrough_camera`` under the scene's knobs.
    ``frame(t, budget)`` is the measured LOD frame with its stats,
    ``exact(t)`` the PSNR gate's reference."""

    def __init__(self, gs, cloud, knobs, kw_meas, kw_exact,
                 flythrough_camera):
        self.gs, self.cloud, self.knobs = gs, cloud, knobs
        self.kw_meas, self.kw_exact = kw_meas, kw_exact
        self.camera = flythrough_camera
        self.temporal = knobs["temporal"]

    def frame(self, t, budget):
        view, proj = self.camera(t, W, H, device=self.cloud.means.device)
        return self.gs.render_gaussians(
            self.cloud, view, proj, W, H,
            lod_budget=budget if self.temporal else None, **self.kw_meas)

    def exact(self, t):
        view, proj = self.camera(t, W, H, device=self.cloud.means.device)
        return self.gs.render_gaussians(self.cloud, view, proj, W, H,
                                        **self.kw_exact)

    def initial_budget(self):
        return self.gs.initial_lod_budget(
            W, H, self.knobs["tile_w"], self.knobs["max_splats_per_tile"],
            self.cloud.means.device)

    def step(self, t, budget):
        """The animation's frame step: (image, the next budget)."""
        img, st = self.frame(t, budget)
        return img, self.next_budget(st, budget)

    def next_budget(self, st, budget):
        if not self.temporal:
            return budget
        ntx, nty = self.gs.num_tiles(W, H, self.knobs["tile_w"])
        return self.gs.update_lod_budget(
            st["tile_exec"], self.knobs["max_splats_per_tile"], ntx, nty,
            st["tile_kept"], st["tile_count"],
            dry_floor=self.knobs["dry_floor"])


def gate(torch, scene: str, frames):
    """The PSNR gate's samples: at each of ``GATE_SAMPLES`` times, the LOD
    frame of ``frames`` (warmed by a ``GATE_WARMUP``-frame lead-in of
    budgets when temporal) against its exact frame. Returns the lists
    (PSNR dB, pairs dropped, side-channel splats dropped, lossless
    certificate, exact-frame ms)."""
    warmup = GATE_WARMUP if frames.temporal else 0
    frame, next_budget = frames.frame, frames.next_budget
    budget0 = frames.initial_budget()
    psnrs, drops, bigdrops, certs, exact_ms = [], [], [], [], []
    for k in range(GATE_SAMPLES):
        ts = np.float32((FRAMES - 1) * k / (GATE_SAMPLES - 1) / 60.0)
        b = budget0
        for i in range(warmup):
            t = np.float32(ts - np.float32(warmup - i) / np.float32(60.0))
            _, st = frame(f32(t), b)
            b = next_budget(st, b)
        a, st = frame(f32(ts), b)
        s0 = torch.cuda.Event(enable_timing=True)
        s1 = torch.cuda.Event(enable_timing=True)
        s0.record()
        ref = frames.exact(f32(ts))
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
    return psnrs, drops, bigdrops, certs, exact_ms


def main_path(torch, cuda, scene: str, frames):
    """One flythrough through ``frames`` (a :class:`BenchFrames` or a
    ``gs_viewer.Viewer``): a 60-frame LOD window (temporal budgets if
    ``frames.temporal``), then the PSNR gate (6 sampled times, each LOD
    frame — warmed by an 8-frame lead-in when temporal — against the exact
    frame). Launch counts are zeroed just before and read just after.
    Returns the launch counts."""
    warmup = GATE_WARMUP if frames.temporal else 0
    frame, next_budget = frames.frame, frames.next_budget
    dev = frames.cloud.means.device
    budget0 = frames.initial_budget()

    # warm-up frames, LOD and exact (allocator growth, first launches),
    # outside the counted run
    img, st = frame(0.0, budget0)
    frames.exact(0.0)
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

    psnrs, drops, bigdrops, certs, exact_ms = gate(torch, scene, frames)
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
    # every frame of an SH cloud evaluates its colours once
    sh_frames = (FRAMES + GATE_SAMPLES * (warmup + 2)
                 if frames.cloud.sh_rest is not None else 0)
    require(launches["sh_colors"] == sh_frames,
            f"{scene}: {launches['sh_colors']} SH colour launches over "
            f"{sh_frames} SH frames")
    return launches


def check_k4(torch, gs, lay, args, k4, label: str, reps: int):
    """K4 vs its plain version on the training frame: planes, exec, and
    the checkpoint rows of the chunks both ran; then both timed."""
    pk, ek, ck, off = k4
    pp, ep, cp, offp = gs._composite_ckpt_plain(*args)
    torch.cuda.synchronize()
    vis = lay.binned.visited
    err = (pk - pp).abs()[:, vis]
    max_abs, mean_abs = float(err.max()), float(err.mean())
    same = float((ek == ep).float().mean())
    begin, _, first, nch = gs._chunk_spans(args[1], args[2],
                                           args[0].shape[0])
    nex_k = gs._executed_chunks(begin, first, ek)
    nex = torch.minimum(nex_k, gs._executed_chunks(begin, first, ep))
    j = torch.arange(int(nex.max()), device=nex.device)
    slots = (off.long()[:, None] + j[None])[j[None] < nex[:, None]]
    ck_err = float((ck[slots] - cp[slots]).abs().max())
    ntiles, pix = pk.shape[1], pk.shape[2]
    executed = int(ek.sum())
    chunks = int(nex_k.sum())
    kept = lay.binned.kept
    saturated = int(((ek < kept) & (kept > 0)).sum())
    cnt = pair_counts(torch, gs, args[0], args[1], ek,
                      (*args[3:], 1))
    cl, threads, resident = gs._composite_shape(4, args[-1])
    log(f"K4 vs plain [{label}]: {ntiles} tiles x {pix} samples, "
        f"{args[0].shape[0]} packed rows, {executed} executed in {chunks} "
        f"chunks ({int(nch.sum())} held) by {int((ek > 0).sum())} tiles "
        f"(longest tile {int(ek.max())}) in clusters of {cl} CTAs x "
        f"{threads} threads ({resident} CTAs resident; "
        f"{int((ek > 0).sum()) * cl} CTAs with work), {saturated} tiles "
        f"saturated "
        f"inside their lists; planes max abs {max_abs:.3e} "
        f"mean abs {mean_abs:.3e}; checkpoints max abs {ck_err:.3e} over "
        f"{slots.numel()} rows; exec equal on {same * 100:.3f}% of tiles; "
        f"ck_off equal {bool(torch.equal(off, offp))}; {cnt['reach']} of "
        f"{cnt['pairs']} executed pair-samples can reach the alpha floor")
    require(max_abs <= COMP_MAX_ABS and mean_abs <= COMP_MEAN_ABS
            and ck_err <= COMP_MAX_ABS,
            f"K4 [{label}] differs: planes {max_abs}/{mean_abs}, "
            f"checkpoints {ck_err}")
    require(same >= COMP_EXEC_SHARE, f"K4 [{label}] exec equal on {same}")
    require(bool(torch.equal(off, offp)), f"K4 [{label}] ck_off differs")
    # rows read once, row ranges and offsets read, 4 planes and one
    # checkpoint row per executed chunk written
    return kernel_record(
        torch, "K4 composite ckpt", "ray_eater_tpu_torch/csrc/gs_composite.cu",
        "ray_eater_tpu/ops/gs.py:1528", gs._composite_call_ckpt,
        gs._composite_ckpt_plain, args, max(max_abs, ck_err),
        executed * REC_BYTES + ntiles * (3 * 4 + 4)
        + (4 * ntiles + chunks) * pix * 4,
        executed * pix * K2_OPS_PER_PAIR_PIXEL, label, reps,
        exps=cnt["reach"])


def check_k5(torch, gs, args, k4, dplanes, label: str, reps: int):
    """K5 vs its plain version on K4's outputs and the MSE cotangent."""
    planes, ex, ck, off = k4
    bwd = (args[0], args[1], args[2], ex, off, ck, planes, dplanes,
           *args[3:])
    gk = gs._composite_bwd_call(*bwd)
    gp = gs._composite_bwd_plain(*bwd)
    torch.cuda.synchronize()
    err = (gk - gp).abs()
    scale = float(gp.abs().max())
    max_abs, mean_abs = float(err.max()), float(err.mean())
    rel = max_abs / max(scale, 1e-30)
    begin, _, first, _ = gs._chunk_spans(args[1], args[2], args[0].shape[0])
    chunks = int(gs._executed_chunks(begin, first, ex).sum())
    executed = int(ex.sum())
    ntiles, pix = planes.shape[1], planes.shape[2]
    cnt = pair_counts(torch, gs, args[0], args[1], ex, (*args[3:], 1))
    log(f"K5 vs plain [{label}]: {executed} executed rows in {chunks} "
        f"chunks of {int((ex > 0).sum())} tiles (longest tile "
        f"{int(ex.max())}; {int((ex > 0).sum()) * pix // 256} CTAs of 256 "
        f"samples with work), {cnt['pairs']} pair-samples, {cnt['reach']} "
        f"that can reach the alpha floor, {cnt['live']} at or above it, "
        f"{cnt['unclamped']} of them below the clamp; max |grad| "
        f"{scale:.3e}, max "
        f"abs err {max_abs:.3e} ({rel:.3e} of it), mean abs err "
        f"{mean_abs:.3e}; finite "
        f"{bool(torch.isfinite(gk).all())}; rows with a gradient "
        f"{int((gk != 0).any(1).sum())}")
    require(bool(torch.isfinite(gk).all()) and scale > 0,
            f"K5 [{label}] non-finite or zero gradients")
    require(rel <= K5_REL, f"K5 [{label}] differs: {rel} of max |grad|")
    # rows read and gradient rows written once, row ranges/exec/offsets,
    # one checkpoint row per executed chunk, K4's 4 planes and the 4
    # cotangent planes
    return kernel_record(
        torch, "K5 composite bwd",
        "ray_eater_tpu_torch/csrc/gs_composite_bwd.cu",
        "ray_eater_tpu/ops/gs.py:1593", gs._composite_bwd_call,
        gs._composite_bwd_plain, bwd, max_abs,
        executed * (REC_BYTES + GRAD_BYTES) + ntiles * 4 * 4
        + (chunks + 8 * ntiles) * pix * 4,
        cnt["pairs"] * K5_OPS_ALPHA + cnt["live"] * K5_OPS_LIVE
        + cnt["unclamped"] * K5_OPS_UNCLAMPED, label, reps,
        exps=cnt["reach"])


def check_train_small(torch, gs, tr, gs_trainer, devs=("cuda", "cpu")):
    """Gradients of one render_gaussians_diff (MSE against a target) on
    CUDA vs on the CPU (plain versions) at a small size, w.r.t. the five
    cloud fields and mean2d_offset."""
    n, w, h = SMALL["n"], SMALL["w"], SMALL["h"]
    names = ("means", "scales", "quats", "opacities", "colors")
    out = []
    for dev in devs:
        view, proj, target, params = gs_trainer.train_setup(n, w, h, dev)
        c = tr.cloud_from_params(params)
        leaves = [getattr(c, k).detach().requires_grad_(True) for k in names]
        off = torch.zeros((n, 2), device=dev, requires_grad=True)
        img = gs.render_gaussians_diff(*leaves, view, proj, w, h,
                                       mean2d_offset=off)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        out.append((loss.item(), [x.grad.cpu() for x in leaves + [off]]))
    (lg, gg), (lc, gc) = out
    log(f"small training frame {w}x{h}, {n} splats: loss CUDA {lg:.6e} CPU "
        f"{lc:.6e}")
    for name, a, b in zip(names + ("mean2d_offset",), gg, gc):
        scale = float(b.abs().max())
        diff = (a - b).abs().reshape(n, -1)
        rel = float(diff.max()) / max(scale, 1e-30)
        log(f"  d loss / d {name}: CUDA vs CPU max abs {float(diff.max()):.3e} "
            f"({rel:.3e} of max |grad| {scale:.3e})")
        require(bool(torch.isfinite(a).all()) and scale > 0,
                f"small training gradient {name} non-finite or zero")
        require(rel <= TRAIN_SMALL_REL,
                f"small training gradient {name}: rel {rel}")
    require(abs(lg - lc) <= 1e-4 * lc, f"small training loss {lg} vs {lc}")


def train_path(torch, cuda, gs_trainer):
    """The training main path: gs_trainer.train at 1M splats, 1920x1080
    (make_train_step_pallas, Adam lr 5e-3)."""
    n, w, h, steps = TRAIN["n"], TRAIN["w"], TRAIN["h"], TRAIN["steps"]
    args = gs_trainer.parse_args(["--splats", str(n), "--width", str(w),
                                  "--height", str(h), "--steps", str(steps),
                                  "--path", "pallas"])
    cuda.reset_launches()
    r = gs_trainer.train(args)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    losses = r["losses"]
    log(f"train {n} splats {w}x{h}: {steps} steps (1 warm-up), "
        f"{r['ms_per_step']:.3f} ms/step over {steps - 1} timed steps (CUDA "
        f"events); loss first {losses[0]:.6e} last {losses[-1]:.6e}; peak "
        f"memory {r['peak_bytes'] / 2**30:.3f} GiB; launches {launches}")
    log("train losses: " + " ".join(f"{x:.6e}" for x in losses))
    require(all(np.isfinite(losses)), "non-finite training loss")
    require(losses[-1] < losses[0], f"training loss did not fall: {losses}")
    for key in ("k4_composite_ckpt", "k5_composite_bwd"):
        require(launches[key] == steps,
                f"{key}: {launches[key]} launches over {steps} steps")
    for t in r["params"].tensors():
        require(bool(torch.isfinite(t).all()), "non-finite parameters")
    return launches, r


def adc_path(torch, cuda, gs_trainer):
    """The ADC main path: gs_trainer.train_adc at the BENCHLOG 2026-08-21
    configuration."""
    args = gs_trainer.parse_args(ADC_ARGS)
    cuda.reset_launches()
    r = gs_trainer.train_adc(args)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    log(f"adc {' '.join(ADC_ARGS)}: {r['n0']} -> {r['n_live']} live splats "
        f"(cap {r['capacity']}), {r['steps_per_s']:.3f} steps/s after the "
        f"first window; window losses "
        + " ".join(f"{x:.6e}" for x in r["losses"])
        + f"; train PSNR mean {np.mean(r['psnr']):.3f} dB, held-out "
        f"{' '.join(f'{x:.3f}' for x in r['heldout_psnr'])} dB; densify "
        f"events {r['events']}; launches {launches}")
    require(all(np.isfinite(r["losses"])), "non-finite ADC loss")
    require(len(r["events"]) >= 1, "no densify event in the ADC run")
    require(r["n_live"] > r["n0"], f"ADC live count did not grow: {r}")
    require(all(np.isfinite(r["heldout_psnr"])), "non-finite held-out PSNR")
    steps = int(ADC_ARGS[ADC_ARGS.index("--steps") + 1])
    for key in ("k4_composite_ckpt", "k5_composite_bwd"):
        require(launches[key] == steps,
                f"{key}: {launches[key]} launches over {steps} ADC steps")
    return launches, r


# ---- raster and sampling: K6-K9 ---------------------------------------------

def fold_compare(torch, k, p, mask, label):
    """K6/K7 outputs against their plain version on ``mask``: winner ids
    (and K7's slots) equal, floats within RASTER_TOL where ids agree.
    Returns the largest float difference."""
    require(bool(torch.equal(k[1][mask], p[1][mask])),
            f"{label}: winner ids differ on "
            f"{int((k[1] != p[1])[mask].sum())} pixels")
    if len(k) > 4:
        require(bool(torch.equal(k[4][mask], p[4][mask])),
                f"{label}: winner slots differ")
    err = 0.0
    for a, b in (k[0], p[0]), (k[2], p[2]), (k[3], p[3]):
        fin = torch.isfinite(b) & mask
        require(bool(torch.equal(torch.isfinite(a)[mask], fin[mask])),
                f"{label}: infinite keys differ")
        if bool(fin.any()):
            err = max(err, float((a - b)[fin].abs().max()))
    require(err <= RASTER_TOL, f"{label}: planes differ by {err}")
    return err


def raster_record(torch, name, source, replaces, call, plain, args,
                  max_abs, nbytes, ops, label, reps, plain_reps=2,
                  library=None):
    d = kernel_record(torch, name, source, replaces, call, plain, args,
                      max_abs, nbytes, ops, label, reps, plain_reps)
    if library is not None:
        d["library_ms"] = time_ms(torch, library, reps)
        log(f"{name} [{label}] library call {d['library_ms']:.4f} ms")
    return d


def cull_log(torch, name, label, fs, twin, plain, dense_pairs):
    """Hold a culled twin (``raster._fold_culled`` on the card's inputs
    with the kernel's footprint, ``fs.foot``: the fold without the (row,
    warp footprint) pairs the kernel skips) to the plain fold's outputs;
    log the kernel's shape ``fs`` and the twin's skip share against the
    dense fold's ``dense_pairs`` (row, pixel) evaluations. Returns the
    share."""
    outs, skipped, pairs = twin[0], int(twin[1].sum()), int(twin[2].sum())
    require(all(bool(torch.equal(a, b)) for a, b in zip(outs, plain)),
            f"{name} [{label}]: the culled twin differs from the plain fold")
    ops = dense_pairs * FOLD_OPS
    (fw, fh), (cw, ch) = fs.foot, fs.region
    log(f"{name} cull [{label}]: {skipped} of {pairs} (live row, {fw}x{fh} "
        f"warp footprint) pairs skipped ({skipped / max(pairs, 1):.4f}); "
        f"dense-fold work {ops} f32 ops ({ops / F32_FLOPS * 1e3:.4f} ms at "
        f"the f32 rate), culled fold "
        f"{(pairs - skipped) * fw * fh * FOLD_OPS} f32 ops; {name} runs "
        f"{fs.ctas} CTAs of {fs.threads} threads a tile ({cw}x{ch} px "
        f"each), {fs.resident} resident on the card")
    return skipped / max(pairs, 1)


def check_k6(torch, raster, ds, depth, w, h, mode, label, reps):
    """K6 vs its plain version on one draw: every valid setup column
    folded into every tile; its culled twin's skip share. Returns
    (outputs, record)."""
    dinit = raster._pad_rows(depth)
    n = raster._fold_bound(ds.inv_w.shape[0], ds.setup.shape[1])
    args = (ds.setup, dinit, n, float(w), float(h), mode)
    k = raster._raster_dense_k6(*args)
    p = raster._raster_dense_plain(*args)
    torch.cuda.synchronize()
    err = fold_compare(torch, k, p, torch.ones_like(k[1], dtype=torch.bool),
                       f"K6 [{label}]")
    valid = int((ds.setup[raster._VALID, :n] > 0.5).sum())
    hp, wp = dinit.shape
    log(f"K6 vs plain [{label}]: {valid} valid of {n} columns over "
        f"{hp}x{wp} px, {int((k[1] >= 0).sum())} px won; max abs {err:.3e}")
    fs = raster._fold_shape(6, mode)
    cull_log(torch, "K6", label, fs,
             raster._raster_dense_culled(*args, foot=fs.foot), p,
             valid * hp * wp)
    # bound: the setup columns read once, the incoming depth read and
    # four planes written once
    return k, raster_record(
        torch, "K6 raster", "ray_eater_tpu_torch/csrc/raster.cu",
        "ray_eater_tpu/ops/raster.py:250", raster._raster_dense_k6,
        raster._raster_dense_plain, args, err,
        n * SETUP_ROW_BYTES + hp * wp * 5 * 4, 0, label, reps)


def check_grid_kernels(torch, raster, sampling, sc, t, reps):
    """K7 and K8 vs their plain versions, K7 vs K6 (binned vs dense) and
    K9 vs its plain version on one frame of the grid10k scene ``sc``;
    prints the frame's binning and fallback numbers. Returns the K7, K8,
    K9 records."""
    from ray_eater_tpu_torch import raster_scenes as rs
    m, (pipe, res), w, h = sc.mesh, sc.passes[0], sc.width, sc.height
    fb, ds = rs.draw_setup(sc, t)
    dinit = raster._pad_rows(fb.depth)
    hp, wp = dinit.shape
    ntx, nty = wp // raster.TILE_W, hp // raster.TILE_H
    ft = raster._feature_table(ds.tri_vary, ds.inv_w)
    b = raster._bin_triangles(ds.setup, ntx, nty, feat=ft)
    rows = int((b.row_end - b.row_begin).sum())
    log(f"grid10k frame t={t}: {m.num_triangles} triangles, "
        f"{ds.inv_w.shape[0]} clipped slots, "
        f"{int((ds.setup[raster._VALID] > 0.5).sum())} valid, "
        f"{ntx * nty} tiles ({int(b.visited.sum())} visited), {rows} pairs "
        f"in a pack of {b.pack.shape[0]} rows, longest tile "
        f"{int((b.row_end - b.row_begin).max())}, overflow_big "
        f"{int(b.overflow_big)}")
    less = raster._mode_bits(True, False, False, False)
    args = (b.pack, b.row_begin, b.row_end, dinit, float(w), float(h), less)
    k = raster._raster_binned_k7(*args)
    p = raster._raster_binned_plain(*args)
    torch.cuda.synchronize()
    vis = raster._tile_mask(b.visited, ntx, nty)
    err7 = fold_compare(torch, k, p, vis, "K7 grid10k")
    k6 = raster._raster_dense_k6(ds.setup, dinit, ds.setup.shape[1],
                                 float(w), float(h), less)
    ids7 = torch.where(vis, k[1], -1)
    same = bool(torch.equal(ids7, k6[1]))
    log(f"K7 vs K6 (binned vs dense, all {ds.setup.shape[1]} columns) on "
        f"the grid10k frame: winner ids equal {same}; K7 vs plain max abs "
        f"{err7:.3e} on {int(vis.sum())} visited px")
    require(same, "K7 and K6 winner ids differ on the grid10k frame")
    fs = raster._fold_shape(7, less)
    outs, skipped, pairs = raster._raster_binned_culled(*args, foot=fs.foot)
    pix = raster.TILE_H * raster.TILE_W
    cull_log(torch, "K7", "grid10k frame", fs,
             ([a[vis] for a in outs], skipped, pairs), [a[vis] for a in p],
             rows * pix)
    # bound: the tiles' rows and ranges read once; on the visited tiles
    # (the kernel writes no other), the incoming depth read and five
    # planes written once
    r7 = raster_record(
        torch, "K7 raster binned", "ray_eater_tpu_torch/csrc/raster.cu",
        "ray_eater_tpu/ops/raster.py:434", raster._raster_binned_k7,
        raster._raster_binned_plain, args, err7,
        rows * SETUP_ROW_BYTES + ntx * nty * 8
        + int(b.visited.sum()) * pix * 6 * 4, 0, "grid10k frame", reps)

    slot = k[4]
    fk = raster._shade_fetch_k8(b.fpack, slot, b.visited)
    fp = raster._shade_fetch_plain(b.fpack, slot, b.visited)
    torch.cuda.synchronize()
    require(bool(torch.equal(fk, fp)), "K8 differs from its plain version")
    nfeat = b.fpack.shape[1]
    # the library call gathers the same rows (slot 0 where K8 writes zeros)
    slot_flat = torch.where(vis & (slot >= 0), slot, 0).reshape(-1).long()
    live = int(torch.unique(slot[vis & (slot >= 0)]).numel())
    log(f"K8 vs plain [grid10k frame]: ({hp}, {wp}, {nfeat}) equal; "
        f"{live} live pack rows of {b.fpack.shape[0]}")
    r8 = raster_record(
        torch, "K8 shade fetch", "ray_eater_tpu_torch/csrc/raster.cu",
        "ray_eater_tpu/ops/raster.py:511", raster._shade_fetch_k8,
        raster._shade_fetch_plain, (b.fpack, slot, b.visited), 0.0,
        # live pack rows read once, the slot plane read, the plane written
        (live + hp * wp) * nfeat * 4 + hp * wp * 4 + ntx * nty, 0,
        "grid10k frame", reps,
        library=lambda: b.fpack.index_select(0, slot_flat))

    tex = res["tex"]
    (_, gt, g0, g1, feats), zt = raster._raster_draw(pipe, ds, fb)
    pv = raster._interpolate(gt, g0, g1, ds.tri_vary, ds.inv_w, zt, feats)
    plan = sampling._subtile_plan(tex, pv.vary["uv"], pv.mask)
    ns = plan.cus.shape[0]
    nb = sampling._fallback_budget(ns, tex.sampler.subtile_fallback)
    _, bind = sampling._binding(plan)
    log(f"grid10k subtile sampler: {ns} subtiles, binding "
        f"{int(bind.sum())} against the fallback budget of {nb}; levels "
        f"{torch.bincount(plan.lsub.long()).tolist()}")
    args9 = (plan.w0i, plan.w1i, *plan.planes, tex.win_table)
    k9 = sampling._subtile_call(*args9)
    p9 = sampling._subtile_plain(*args9)
    torch.cuda.synchronize()
    err9 = float((k9 - p9).abs().max())
    log(f"K9 vs plain [grid10k frame]: max abs {err9:.3e}")
    require(err9 <= RASTER_TOL, f"K9 differs by {err9}")
    r9 = raster_record(
        torch, "K9 subtile sampler", "ray_eater_tpu_torch/csrc/sampling.cu",
        "ray_eater_tpu/ops/sampling.py:190", sampling._subtile_call,
        sampling._subtile_plain, args9, err9,
        ns * sampling._SPIX * SUBTILE_PIXEL_BYTES, 0, "grid10k frame", reps)
    return r7, r8, r9


def check_k9_bf16(torch, raster, sampling, rs, dev, t, reps):
    """K9's bfloat16-window instantiation against its plain version on the
    grid10k frame at time ``t``, with the scene's texture uploaded with
    bf16 windows (``window_dtype``); timed beside the float32 windows'
    launch on the same plan. Logged, not in the kernels line (the main
    paths sample float32 windows)."""
    from ray_eater_tpu_torch.core.resources import Sampler, texture_from_array
    sc = rs.scene("grid10k", dev)
    pipe = sc.passes[0][0]
    tex = texture_from_array(rs.mip_checker_u8(),
                             Sampler(mipmap=True, max_anisotropy=4.0),
                             srgb=False, device=dev,
                             window_dtype=torch.bfloat16)
    fb, ds = rs.draw_setup(sc, t)
    (_, gt, g0, g1, feats), zt = raster._raster_draw(pipe, ds, fb)
    pv = raster._interpolate(gt, g0, g1, ds.tri_vary, ds.inv_w, zt, feats)
    plan = sampling._subtile_plan(tex, pv.vary["uv"], pv.mask)
    args = (plan.w0i, plan.w1i, *plan.planes, tex.win_table)
    k = sampling._subtile_call(*args)
    p = sampling._subtile_plain(*args)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    ns = plan.cus.shape[0]
    rec = raster_record(
        torch, "K9 subtile sampler (bf16 windows)",
        "ray_eater_tpu_torch/csrc/sampling.cu",
        "ray_eater_tpu/ops/sampling.py:190", sampling._subtile_call,
        sampling._subtile_plain, args, err,
        ns * sampling._SPIX * SUBTILE_PIXEL_BYTES, 0, "grid10k frame", reps)
    f32 = rs.mip_checker_texture(dev).win_table
    ms32 = time_ms(torch, lambda: sampling._subtile_call(*args[:-1], f32),
                   reps)
    log(f"K9 bf16 windows vs plain [grid10k frame]: max abs {err:.3e}; "
        f"{rec['ms']:.4f} ms (f32 windows on the same plan {ms32:.4f} ms), "
        f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.4f} ms; "
        f"window table {tex.win_table.numel() * 2} B vs "
        f"{f32.numel() * 4} B")
    require(err <= RASTER_TOL, f"K9 bf16 differs by {err}")
    return rec


def check_raster_small(torch, rs, devs=("cuda", "cpu")):
    """The small grid (288 triangles, binned, mip-sampled) through
    render_mesh on CUDA and on the CPU (plain versions)."""
    from ray_eater_tpu_torch.ops import raster
    w, h = rs.EXTENTS["grid288"]
    out = []
    for dev in devs:
        sc = rs.scene("grid288", dev)
        f = sc.frame(0.4)
        fb, ds = rs.draw_setup(sc, 0.4)
        (_, tid, _, _, _), _ = raster._raster_draw(sc.passes[0][0], ds, fb)
        out.append((f.color[:h, :w].cpu(), tid[:h, :w].cpu()))
    (cg, ig), (cc, ic) = out
    diff = (cg - cc).abs().amax(-1)
    off = float((diff > SMALL_RASTER_COLOR).float().mean())
    ids = float((ig != ic).float().mean())
    log(f"small raster frame {w}x{h} (288-triangle grid, mip sampler): "
        f"CUDA vs CPU max abs {float(diff.max()):.3e}, share of pixels off "
        f"by more than {SMALL_RASTER_COLOR:g}: {off:.2e}, winner ids differ "
        f"on {ids:.2e} of pixels, covered {float((ig >= 0).float().mean()):.3f}")
    require(bool(torch.isfinite(cg).all()), "small raster frame not finite")
    require(off <= SMALL_RASTER_SHARE and ids <= SMALL_RASTER_SHARE,
            f"small raster frame: {off} off, {ids} ids differ")


def raster_paths(torch, cuda, dev):
    """The raster main paths (basic_planes, multipass, grid10k), each with
    its launches counted from zero; the subtile-vs-gather PSNR gate.
    Returns the launch counts of each path."""
    import dataclasses
    from ray_eater_tpu_torch import basic_planes, multipass
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.io.image import save_png, to_srgb_u8
    os.makedirs(RASTER_OUT, exist_ok=True)
    paths = {}
    frames = str(RASTER_FRAMES)

    cuda.reset_launches()
    a = basic_planes.parse_args(
        ["--frames", frames, "--out", f"{RASTER_OUT}/basic_planes"])
    r = basic_planes.run(a)
    torch.cuda.synchronize()
    paths["basic_planes"] = dict(cuda.launches)
    log(f"basic_planes {a.width}x{a.height} [{r['path']}]: {RASTER_FRAMES} "
        f"frames, {r['ms_per_frame']:.3f} ms/frame (CUDA events), "
        f"{r['host_ms_per_frame']:.3f} (host clock), capture "
        f"{r['capture_s']:.3f} s; launches {paths['basic_planes']}, a "
        f"replayed frame {r['launches_per_frame']}; PNG {r['png']}")
    require(r["last"].shape == (a.height, a.width, 4)
            and r["last"].any(), "basic_planes frame")
    require_replayed("basic_planes", paths["basic_planes"], r)

    cuda.reset_launches()
    a = multipass.parse_args(
        ["--frames", frames, "--out", f"{RASTER_OUT}/multipass"])
    r = multipass.run(a)
    torch.cuda.synchronize()
    paths["multipass"] = dict(cuda.launches)
    log(f"multipass {a.width}x{a.height} ({r['triangles']} tris x 2 passes, "
        f"graph {' -> '.join(r['passes'])}) [{r['path']}]: {RASTER_FRAMES} "
        f"frames, {r['ms_per_frame']:.3f} ms/frame (CUDA events), "
        f"{r['host_ms_per_frame']:.3f} (host clock), capture "
        f"{r['capture_s']:.3f} s; launches {paths['multipass']}, a replayed "
        f"frame {r['launches_per_frame']}; PNG {r['png']}")
    require(r["last"].shape == (a.height, a.width, 4)
            and r["last"].any(), "multipass frame")
    require(r["passes"] == ["setup", "depth_prepass", "lit"],
            f"multipass schedule {r['passes']}")
    require_replayed("multipass", paths["multipass"], r)

    sc = rs.scene("grid10k", dev)
    m, (pipe, res), w, h = sc.mesh, sc.passes[0], sc.width, sc.height
    finite = torch.ones((), dtype=torch.bool, device=dev)

    def frame(t, scene=sc):
        nonlocal finite
        fb = scene.frame(t)
        finite = finite & torch.isfinite(fb.color).all()
        return fb

    cuda.reset_launches()
    r = rs.host_loop(frame, RASTER_FRAMES, dev, w, h, present=False)
    torch.cuda.synchronize()
    ms, fb, host_ms = r["ms_per_frame"], r["frame"], r["host_ms_per_frame"]
    paths["grid10k"] = dict(cuda.launches)
    per = {k: v / (RASTER_FRAMES + 1) for k, v in paths["grid10k"].items()
           if v}
    save_png(f"{RASTER_OUT}/grid10k_frame_last.png",
             to_srgb_u8(fb.color[:h, :w]))
    log(f"grid10k {w}x{h} ({m.num_triangles} triangles, mip + 4x aniso): "
        f"{RASTER_FRAMES} eager frames [{r['path']}, presenting the "
        f"last], {ms:.3f} ms/frame (CUDA events), "
        f"{host_ms:.3f} ms/frame (host clock); launches "
        f"{paths['grid10k']} ({per} a frame); PNG "
        f"{RASTER_OUT}/grid10k_frame_last.png")
    require(bool(finite), "non-finite pixels in the grid10k window")

    tex = res["tex"]
    tex = dataclasses.replace(
        tex, sampler=dataclasses.replace(tex.sampler, subtile=False))
    gather = dataclasses.replace(sc, passes=[(pipe, {"tex": tex})])
    psnrs = []
    for t in (0.0, 0.5, 59 / 60):
        a = frame(t).color[:h, :w, :3]
        b = frame(t, gather).color[:h, :w, :3]
        mse = float(torch.mean((a - b) ** 2))
        psnrs.append(10 * np.log10(1.0 / max(mse, 1e-12)))
    log("grid10k subtile sampler vs per-pixel gather: "
        + " ".join(f"{p:.2f}" for p in psnrs) + " dB at t = 0, 0.5, 59/60")
    require(min(psnrs) >= SUBTILE_MIN_PSNR,
            f"subtile vs gather PSNR {min(psnrs)} < {SUBTILE_MIN_PSNR}")
    for name, key in (("basic_planes", "k6_raster"),
                      ("multipass", "k6_raster"),
                      ("grid10k", "k7_raster_binned"),
                      ("grid10k", "k8_shade_fetch"),
                      ("grid10k", "k9_subtile")):
        require(paths[name][key] > 0, f"{key} was not launched on {name}")
    return paths


# ---- particle splat: K10; compute_drawing -----------------------------------

def splat_library(torch, pos, h: int, w: int, r: int):
    """The K10 yardstick: the box union by two PyTorch calls, an
    ``index_put_`` of the truncated positions into a point image padded by
    r on each side (positions past the padding add 0 at a clamped index)
    and ``F.max_pool2d`` with a 2r window, cropped to the (h, w) image."""
    import torch.nn.functional as F
    xi = pos[:, 0].to(torch.int32).long() + r
    yi = pos[:, 1].to(torch.int32).long() + r
    ok = (xi >= 0) & (xi < w + 2 * r) & (yi >= 0) & (yi < h + 2 * r)
    pts = torch.zeros((h + 2 * r, w + 2 * r), dtype=torch.float32,
                      device=pos.device)
    pts.index_put_((yi.clamp(0, h + 2 * r - 1), xi.clamp(0, w + 2 * r - 1)),
                   ok.to(torch.float32), accumulate=True)
    pooled = F.max_pool2d(pts[None, None], kernel_size=2 * r, stride=1)
    return (pooled[0, 0, 1:h + 1, 1:w + 1] > 0).to(torch.float32)


def check_k10(torch, splat, pos, h: int, w: int, r: int, label: str,
              reps: int):
    """K10 vs its plain version (and the library yardstick) on one
    particle set: masks equal; returns the kernels-line record."""
    k = splat._splat_k10(pos, h, w, r)
    p = splat._splat_plain(pos, h, w, r)
    lib = splat_library(torch, pos, h, w, r)
    torch.cuda.synchronize()
    err = float((k - p).abs().max())
    lib_err = float((k[:h, :w] - lib).abs().max())
    hp, wp = k.shape
    log(f"K10 vs plain [{label}]: {pos.shape[0]} particles, r {r}, mask "
        f"{hp}x{wp}, {float(k[:h, :w].mean()) * 100:.2f}% covered; max abs "
        f"{err:g}; library yardstick max abs {lib_err:g}")
    require(err == 0.0, f"K10 [{label}] differs from its plain version")
    require(lib_err == 0.0, f"K10 [{label}] differs from the library call")
    rec = kernel_record(
        torch, "K10 splat mask", "ray_eater_tpu_torch/csrc/splat.cu",
        "ray_eater_tpu/ops/splat.py:42", splat._splat_k10, splat._splat_plain,
        (pos, h, w, r), err, hp * wp * 4 + pos.shape[0] * 8, 0, label, reps)
    rec["library_ms"] = time_ms(torch, lambda: splat_library(torch, pos, h, w,
                                                             r), reps)
    log(f"K10 [{label}] library yardstick (index_put_ + max_pool2d, two "
        f"calls) {rec['library_ms']:.4f} ms")
    from ray_eater_tpu_torch.time_composite import device_ms
    from ray_eater_tpu_torch.time_splat import floor_ms, splat_kernel
    kern, other, _ = device_ms(torch, splat._splat_k10, (pos, h, w, r),
                               splat_kernel)
    rec["device_ms"], rec["floor_ms"] = kern, floor_ms(torch, splat)
    log(f"K10 [{label}] device ms under torch.profiler: splat kernel "
        f"{kern:.5f}, all device work of the call {kern + other:.5f}; one "
        f"empty kernel (the launch floor) {rec['floor_ms']:.5f}; bound "
        f"{rec['bound_ms']:.5f} ms")
    require(other == 0.0, f"K10 [{label}] made device work besides its "
            f"kernel ({other:.5f} ms)")
    return rec


def require_replayed(name, launches, r):
    """A device-loop entry point's ``launches`` (zeroed just before its
    run) hold, for each kernel of its frame step, the two eager warm-up
    steps, the one-frame capture call and the ``RASTER_FRAMES`` timed
    replays: ``WARMUP_STEPS + 1 + RASTER_FRAMES`` times a replayed
    frame's launches."""
    from ray_eater_tpu_torch.core.animation import WARMUP_STEPS
    steps = WARMUP_STEPS + 1 + RASTER_FRAMES
    want = {k: steps * v for k, v in r["launches_per_frame"].items() if v}
    got = {k: launches[k] for k in want}
    require(r["path"].startswith("device-loop") and want and got == want,
            f"{name} [{r['path']}]: launches {got}, expected {want} "
            f"({steps} frame steps)")


def compute_drawing_path(torch, cuda):
    """The compute_drawing main path: the entry point's run() (900x600,
    1024 particles, 60 frames of its device loop) with its launches counted
    from zero; the presented frame must be the splatted image, K10 must
    launch once and K6 once in every frame step."""
    from ray_eater_tpu_torch import compute_drawing as cd
    from ray_eater_tpu_torch.core.swapchain import encode_present
    args = cd.parse_args(["--frames", str(RASTER_FRAMES), "--out",
                          DRAWING_OUT])
    cuda.reset_launches()
    r = cd.run(args)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    img = r["drawing"].image
    want = encode_present(img, cd.WIDTH, cd.HEIGHT, srgb=False)
    differ = int((r["u8"] != want).any(-1).sum())
    log(f"compute_drawing {cd.WIDTH}x{cd.HEIGHT} ({cd.PARTICLE_COUNT} "
        f"particles, r {cd.PIXELS_RAD}): {RASTER_FRAMES} frames, "
        f"{r['ms_per_frame']:.3f} ms/frame (CUDA events), "
        f"{r['host_ms_per_frame']:.3f} ms/frame (host clock); launches "
        f"{launches}; presented pixels differing from the splatted image: "
        f"{differ}; PNG {r['png']}")
    log(f"compute_drawing path: {r['path']}, capture {r['capture_s']:.3f} "
        f"s, launches a replayed frame {r['launches_per_frame']}")
    require(launches["k10_splat"] == 1, "K10 launched "
            f"{launches['k10_splat']} times by compute_drawing")
    require(r["launches_per_frame"]["k6_raster"] >= 1,
            f"K6 not in compute_drawing's captured frame: "
            f"{r['launches_per_frame']}")
    require_replayed("compute_drawing", launches, r)
    require(differ == 0, f"compute_drawing: {differ} presented pixels differ "
            "from the splatted image")
    return launches


# ---- the animation phase: render_animation replay vs the eager loop --------

def animation_phase(torch, cuda, scene: str, frame_fn, carry=None,
                    srgb: bool = True, finite=None, dev="cuda"):
    """``render_animation(keep="all")`` over ``FRAMES`` frames of
    ``frame_fn`` (a CUDA graph's replay) against the eager loop over the
    same step on the card (``render_animation_eager``): the u8 frames must
    be equal, and the final carry too. ``finite(out)`` of an eager frame
    returns a device bool that the frame is finite. The first
    render_animation call captures the step; a second, timed one replays
    the cached graph; both are held to the eager frames. Returns the
    record (ms/frame of each, capture seconds, launches)."""
    from ray_eater_tpu_torch.core import animation
    ok = torch.ones((), dtype=torch.bool, device=dev)

    def checked(*a):
        nonlocal ok
        out = frame_fn(*a)
        if finite is not None:
            ok = ok & finite(out[0] if carry is not None else out)
        return out

    cuda.reset_launches()
    kw = dict(srgb=srgb, keep="all", carry=carry, device=dev)

    def timed(fn, info):
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        out = fn(FRAMES, info=info, **kw)
        e1.record()
        e1.synchronize()
        return (out, e0.elapsed_time(e1) / FRAMES,
                (time.perf_counter() - t0) * 1e3 / FRAMES)

    eager_info, first, second = {}, {}, {}
    want, eager_ms, eager_host = timed(
        lambda n, **k: animation.render_animation_eager(checked, n, **k),
        eager_info)
    eager_launches = dict(cuda.launches)
    got1, _, first_host = timed(
        lambda n, **k: animation.render_animation(frame_fn, n, **k), first)
    got2, replay_ms, replay_host = timed(
        lambda n, **k: animation.render_animation(frame_fn, n, **k), second)
    torch.cuda.synchronize()
    launches = dict(cuda.launches)
    # the eager loop, the warm-up steps and both calls' replayed frames
    lpf = first["launches_per_frame"]
    steps = FRAMES + animation.WARMUP_STEPS + 2 * FRAMES
    counts_match = launches == {k: steps * v for k, v in lpf.items()}
    busy_ms = replay_busy_ms(torch, animation, frame_fn, kw)
    animation.release(frame_fn)
    differ = [int((g != want).any(-1).sum()) for g in (got1, got2)]
    carry_equal = None
    if carry is not None:
        carry_equal = all(bool(torch.equal(x, y)) for x, y in (
            (first["carry"], eager_info["carry"]),
            (second["carry"], eager_info["carry"])))
    rec = dict(scene=scene, frames=FRAMES, replay_ms=replay_ms,
               replay_host_ms=replay_host, eager_ms=eager_ms,
               eager_host_ms=eager_host, capture_s=first["capture_s"],
               first_call_host_ms=first_host,
               launches_per_frame=first["launches_per_frame"],
               replay_busy_ms=busy_ms,
               eager_launches=eager_launches, launches=launches,
               differing_pixels=differ, carry_equal=carry_equal,
               shape=tuple(want.shape))
    log(f"animation [{scene}]: {FRAMES} frames {tuple(want.shape)} u8, "
        f"replay {replay_ms:.3f} ms/frame (CUDA events; host clock "
        f"{replay_host:.3f}), eager loop {eager_ms:.3f} ms/frame (host "
        f"clock {eager_host:.3f}); device busy a replayed frame "
        f"{busy_ms if busy_ms is None else f'{busy_ms:.3f}'} ms "
        f"(torch.profiler); capture {first['capture_s']:.3f} s "
        f"(first call, warm-up + capture + replay: {first_host:.3f} ms a "
        f"frame); pixels differing from the eager frames (capture call, "
        f"replay call) {differ}; final carry equal {carry_equal}; launches "
        f"a replayed frame {lpf}; counts: eager loop {eager_launches}, "
        f"eager loop + {animation.WARMUP_STEPS} warm-up steps + "
        f"{2 * FRAMES} replayed frames {launches} ({steps} frame steps "
        f"times a frame's: {counts_match})")
    require(second["path"] == "graph" and not second["captured"],
            f"animation [{scene}]: the second call did not replay the "
            f"cached graph ({second})")
    require(differ == [0, 0], f"animation [{scene}]: replayed frames differ "
            f"from the eager loop's in {differ} pixels")
    require(carry_equal in (None, True),
            f"animation [{scene}]: final carry differs from the eager loop's")
    require(bool(ok), f"animation [{scene}]: non-finite eager frame")
    require(sum(lpf.values()) > 0,
            f"animation [{scene}]: no port kernel in the captured frame")
    require(counts_match, f"animation [{scene}]: launches {launches} are "
            f"not {steps} frame steps of {lpf}")
    del want, got1, got2
    torch.cuda.empty_cache()
    return rec


def replay_busy_ms(torch, animation, frame_fn, kw):
    """Device ms a replayed frame: the summed self device time of every
    kernel, copy and fill that ``torch.profiler`` records over
    ``BUSY_FRAMES`` replayed frames (the cached graph), a frame's share;
    None when the trace holds no device work (CUPTI saw no graph nodes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        animation.render_animation(frame_fn, BUSY_FRAMES, **kw)
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / BUSY_FRAMES if us > 0 else None


def fb_finite(torch):
    return lambda fb: torch.isfinite(fb.color).all()


def img_finite(torch):
    return lambda img: torch.isfinite(img).all()


def swapchain_phase(torch, cuda):
    """``basic_planes --host-loop``: every one of ``FRAMES`` eager frames
    presented through the Swapchain ring arrives, in FIFO order: presented
    frame i is nearest (mean abs difference) to frame i of the eager
    animation of the same scene."""
    from ray_eater_tpu_torch import basic_planes
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.core import animation
    eager_frames = animation.render_animation_eager(
        rs.scene("basic_planes", "cuda").frame, FRAMES, device="cuda")
    got = []
    a = basic_planes.parse_args(["--frames", str(FRAMES), "--host-loop",
                                 "--out", f"{RASTER_OUT}/basic_planes_host"])
    cuda.reset_launches()
    r = basic_planes.run(a, on_image=got.append)
    launches = dict(cuda.launches)
    want = eager_frames.to(torch.int16)
    nearest, equal = [], 0
    for i, img in enumerate(got):
        d = (want - torch.from_numpy(img).to(want.device, torch.int16)
             ).abs().flatten(1).float().mean(1)
        nearest.append(int(d.argmin()))
        equal += int(d[i] == 0) if i < len(want) else 0
    log(f"swapchain [basic_planes --host-loop]: {r['presented']} of "
        f"{FRAMES} frames presented, {r['ms_per_frame']:.3f} ms/frame (CUDA "
        f"events), {r['host_ms_per_frame']:.3f} (host clock); FIFO order "
        f"{nearest == list(range(FRAMES))}; equal to the animation's frame "
        f"{equal} of {len(got)}; launches {launches}")
    require(r["path"] == "host-loop" and r["presented"] == FRAMES
            and len(got) == FRAMES, f"swapchain: {len(got)} frames presented")
    require(nearest == list(range(FRAMES)),
            f"swapchain: frames out of FIFO order: {nearest}")
    require(launches["k6_raster"] == FRAMES + 1,
            f"swapchain: K6 launched {launches['k6_raster']} times")
    return r


def check_drawing_small(torch, devs=("cuda", "cpu")):
    """A 300x200 compute_drawing frame (32 particles) on CUDA vs on the
    CPU (plain versions)."""
    from ray_eater_tpu_torch import compute_drawing as cd
    from ray_eater_tpu_torch.core.swapchain import encode_present
    w, h = DRAWING_SMALL
    out = []
    for dev in devs:
        d = cd.setup(dev, 0, w, h, 32)
        c = d.frame(0.25).color
        out.append((d.image.cpu(), c.cpu(),
                    encode_present(c, w, h, srgb=False).cpu()))
    (ig, cg, ug), (ic, cc, uc) = out
    err = float((cg - cc).abs().max())
    log(f"small compute_drawing frame {w}x{h}: CUDA vs CPU image equal "
        f"{bool(torch.equal(ig, ic))}, frame max abs {err:.3e}, presented "
        f"frames equal {bool(torch.equal(ug, uc))}")
    require(torch.equal(ig, ic) and torch.equal(ug, uc) and err <= RASTER_TOL,
            f"small compute_drawing frame: CUDA vs CPU max abs {err}")


# ---- SH colours from a PLY through gs_viewer: K1, K2 ------------------------

def check_sh_small(torch, devs=("cuda", "cpu")):
    """eval_sh_colors of a small degree-3 cloud (gs_viewer's synthetic
    cloud with 15 SH bands) on CUDA vs on the CPU."""
    from ray_eater_tpu_torch.gs_viewer import synthetic_cloud
    from ray_eater_tpu_torch.models.gaussians import eval_sh_colors
    # one CPU thread: PyTorch's first multithreaded CPU sqrt of a process
    # has come out approximate (errors ~1e-3 on one thread's share of
    # the elements, torch 2.13 on an AVX-512 host)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        outs = [eval_sh_colors(synthetic_cloud(SH_SMALL, 15, dev),
                               torch.tensor(SH_EYE, device=dev)).cpu()
                for dev in devs]
    finally:
        torch.set_num_threads(threads)
    err = float((outs[0] - outs[1]).abs().max())
    log(f"small SH colours ({SH_SMALL} splats, degree 3): CUDA vs CPU max "
        f"abs {err:.3e}")
    require(err <= SH_TOL, f"SH colours CUDA vs CPU differ by {err}")


def sh_path(torch, gs, cuda, dev):
    """The SH main path: gs_viewer's 1M-splat synthetic cloud with 15 SH
    bands (degree 3) written by save_ply and read back by load_ply, then
    gs_viewer's frames at its defaults (LOD with temporal budgets, SH
    colours at the eye) through main_path, then its animation phase; the
    SH colour kernel against its plain version and timed on the cloud.
    Returns the launch counts, the animation record and the kernel's
    record of the kernels line."""
    from ray_eater_tpu_torch import gs_viewer
    from ray_eater_tpu_torch.models import gaussians
    from ray_eater_tpu_torch.models.gaussians import (eval_sh_colors,
                                                      load_ply, save_ply)
    src = gs_viewer.synthetic_cloud(N_SPLATS, 15, dev)
    os.makedirs(os.path.dirname(SH_PLY), exist_ok=True)
    try:
        t0 = time.perf_counter()
        save_ply(SH_PLY, src)
        size = os.path.getsize(SH_PLY)
        native_read_ply(SH_PLY, size)
        t1 = time.perf_counter()
        cloud = load_ply(SH_PLY, device=dev)
        t2 = time.perf_counter()
    finally:
        if os.path.exists(SH_PLY):
            os.remove(SH_PLY)
    errs = {k: float((getattr(cloud, k) - getattr(src, k)).abs().max())
            for k in ("means", "scales", "quats", "opacities", "colors",
                      "sh_rest")}
    log(f"SH PLY {N_SPLATS} splats, degree {cloud.sh_degree}: {size} B, "
        f"save_ply + the two readers {t1 - t0:.2f} s, load_ply (native "
        f"reader) {t2 - t1:.2f} s; round trip "
        f"max abs " + " ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    require(cloud.sh_degree == 3 and errs["means"] == 0.0
            and errs["sh_rest"] == 0.0, "PLY round trip: means/sh_rest")
    require(max(errs.values()) <= SH_PLY_TOL, f"PLY round trip: {errs}")
    del src

    v = gs_viewer.viewer(gs_viewer.parse_args([]), cloud)
    log(f"gs_viewer defaults: mpt {v.max_per_tile}, cap_factor "
        f"{v.cap_factor}, tile_w {v.tile_w}, big_splat_cap "
        f"{v.big_splat_cap}, {v.width}x{v.height}")
    view, proj, eye = v.camera(0.0)
    cuda.reset_launches()
    colors = eval_sh_colors(cloud, eye)
    sh_launches = dict(cuda.launches)
    args = (cloud.means, cloud.colors, cloud.sh_rest, eye)
    err = float((colors - gaussians._sh_colors_plain(*args)).abs().max())
    log(f"eval_sh_colors at {N_SPLATS} splats: launches {sh_launches}; SH "
        f"colour kernel vs plain max abs {err:.3e}")
    require(sh_launches == dict.fromkeys(sh_launches, 0) | {"sh_colors": 1},
            f"eval_sh_colors launched {sh_launches}, not the one SH colour "
            "kernel")
    require(err <= SH_TOL, f"SH colour kernel vs plain: max abs {err}")
    ksh = kernel_record(
        torch, "SH colour", "ray_eater_tpu_torch/csrc/gs_sh.cu",
        "none (the JAX package evaluates SH in jnp)", gaussians._sh_colors_op,
        gaussians._sh_colors_plain, args, err,
        N_SPLATS * (12 + 12 + 3 * 4 * cloud.sh_rest.shape[1] + 12) + 12,
        N_SPLATS * SH_OPS_PER_SPLAT, f"{N_SPLATS} splats, degree 3",
        reps=50, plain_reps=10)
    dc = gs.render_gaussians(cloud, view, proj, v.width, v.height,
                             tile_w=v.tile_w)
    sh = v.exact(0.0)
    diff = float((sh - dc).abs().max())
    log(f"SH frame vs cam_pos=None frame (exact, t=0): max abs {diff:.3e}; "
        f"colours in [{float(colors.min()):.3f}, {float(colors.max()):.3f}]")
    require(diff > 1e-2, "the SH frame equals the DC-colour frame")
    del dc, sh, colors
    launches = main_path(torch, cuda, "sh", v)
    for key, name in (("k1_project", "K1"), ("k2_composite", "K2")):
        require(launches[key] > 0, f"{name} was not launched on the SH path")
    anim = animation_phase(torch, cuda, "SH (gs_viewer)", v.step,
                           carry=v.initial_budget(),
                           finite=img_finite(torch))
    viewer_phase(torch, cuda, cloud)
    return launches, anim, ksh


# ---- this slice: native tier, textured basic_planes, viewer, baked frames,
# lod_tail ---------------------------------------------------------------------

def native_build():
    """Builds the native tier (g++) from the checkout's copy of its
    source; returns the build's seconds."""
    from ray_eater_tpu_torch.native import loader as native
    so = native.library_path()
    prebuilt = so.exists()
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    require(native.available(), "the native tier did not load")
    log(f"native tier: g++ build {build_s:.2f} s ({so.name}"
        f"{', found built' if prebuilt else ''})")
    return build_s


def native_read_ply(path: str, size: int):
    """The native PLY reader on ``path`` equal to the numpy reader;
    returns (native s, numpy s)."""
    from ray_eater_tpu_torch.models.gaussians import _read_ply_numpy
    from ray_eater_tpu_torch.native import loader as native
    t0 = time.perf_counter()
    props, data = native.read_ply(path)
    t1 = time.perf_counter()
    want_props, want = _read_ply_numpy(path)
    t2 = time.perf_counter()
    equal = props == want_props and np.array_equal(data, want)
    log(f"native read_ply of the {size} B PLY ({data.shape[0]} x "
        f"{data.shape[1]} f32): {t1 - t0:.2f} s; numpy reader "
        f"{t2 - t1:.2f} s; equal {equal}")
    require(equal, "native read_ply differs from the numpy reader")
    return t1 - t0, t2 - t1


def textured_planes_phase(torch, dev):
    """basic_planes textured from a file: the checkerboard written by
    encode_png, found through $RAYEATER_TEXTURE and read back by
    texture_from_file; its texel tables, ``FRAMES`` replayed frames and
    the entry point's last frame equal the array texture's, u8 for u8."""
    from ray_eater_tpu_torch import basic_planes
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.core import animation
    from ray_eater_tpu_torch.core.resources import texture_from_array
    from ray_eater_tpu_torch.io.image import encode_png
    os.makedirs(os.path.dirname(TEXTURE_PNG), exist_ok=True)
    with open(TEXTURE_PNG, "wb") as f:
        f.write(encode_png(rs.checker_rgba()))
    os.environ["RAYEATER_TEXTURE"] = TEXTURE_PNG
    try:
        t0 = time.perf_counter()
        tex = basic_planes.load_texture(dev)
        load_s = time.perf_counter() - t0
        ref = texture_from_array(rs.checker_rgba(), device=dev)
        tables = all(torch.equal(getattr(tex, k), getattr(ref, k))
                     for k in ("data", "packed"))
        by_file = rs.scene("basic_planes", dev, texture=tex).frame
        by_array = rs.scene("basic_planes", dev).frame
        got = animation.render_animation(by_file, FRAMES, device=dev)
        want = animation.render_animation(by_array, FRAMES, device=dev)
        animation.release(by_file)
        animation.release(by_array)
        differ = int((got != want).any(-1).sum())
        r = basic_planes.run(basic_planes.parse_args(
            ["--frames", str(FRAMES), "--device", str(dev), "--out",
             f"{RASTER_OUT}/basic_planes_textured"]))
    finally:
        del os.environ["RAYEATER_TEXTURE"]
    last = np.array_equal(r["last"], want[-1].cpu().numpy())
    log(f"textured basic_planes ({TEXTURE_PNG}, {os.path.getsize(TEXTURE_PNG)}"
        f" B): texture_from_file {load_s:.3f} s, tables equal {tables}; "
        f"{FRAMES} replayed frames differing from the array texture's in "
        f"{differ} pixels; entry point [{r['path']}] last frame equal "
        f"{last}, {r['ms_per_frame']:.3f} ms/frame")
    require(tables and differ == 0 and last,
            "textured basic_planes differs from the array texture's frames")


def viewer_phase(torch, cuda, cloud):
    """gs_viewer --serve's frame builder (``ServeFrames``) at its defaults
    (1920x1080, LOD with budgets, SH colours at the eye) on ``cloud``:
    at each of ``VIEWER_STEPS`` the replayed frame and its next budget
    equal the eager frame's at the same camera and budget; then
    ``VIEWER_SERVED`` timed frames; then the resize round trip (1080p,
    720p, 1080p), each extent captured anew and its old graph released,
    the graph cache no larger after it. Returns the record."""
    from ray_eater_tpu_torch import gs_viewer
    from ray_eater_tpu_torch.core import animation
    dev = cloud.means.device
    args = gs_viewer.parse_args(["--serve", "0"])
    cuda.reset_launches()

    def checked(fr, az, hgt, rad):
        info = {}
        want = animation.render_animation_eager(
            fr.step, 1, keep="last", carry=fr.carry(az, hgt, rad),
            device=dev, info=info)
        got = fr(az, hgt, rad)
        return (bool(torch.equal(got, want)
                     and torch.equal(fr.budget, info["carry"][3])),
                bool(torch.isfinite(got.float()).all()))

    fr = gs_viewer.ServeFrames(cloud, args, args.width, args.height)
    results = [checked(fr, *c) for c in VIEWER_STEPS]
    capture_s = [replayed_capture(fr)]
    az, hgt, rad = VIEWER_STEPS[-1]
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    e0.record()
    for i in range(VIEWER_SERVED):
        host = fr(az + 0.01 * i, hgt, rad).cpu().numpy()
    e1.record()
    e1.synchronize()
    served_ms = (time.perf_counter() - t0) * 1e3 / VIEWER_SERVED
    served_dev_ms = e0.elapsed_time(e1) / VIEWER_SERVED
    lpf = fr.info["launches_per_frame"]
    graphs = len(animation._graphs)
    for w, h in VIEWER_RESIZE:
        fr.release()
        fr = gs_viewer.ServeFrames(cloud, args, w, h)
        results.append(checked(fr, az, hgt, rad))
        capture_s.append(replayed_capture(fr))
    graphs_after = len(animation._graphs)
    fr.release()
    launches = dict(cuda.launches)
    log(f"viewer frame builder ({cloud.num_splats} splats, SH at the eye, "
        f"mpt {args.max_per_tile}, tile_w {args.tile_w}): replayed frames "
        f"equal to eager (frame, next budget) {[r[0] for r in results]}, "
        f"finite {all(r[1] for r in results)}; {VIEWER_SERVED} served "
        f"frames {served_ms:.3f} ms/frame (host clock, replay + copy of "
        f"the u8 frame to the host, {host.shape}), {served_dev_ms:.3f} "
        f"ms/frame (CUDA events); capture s at 1920x1080, then the resize "
        f"to {VIEWER_RESIZE[0]} and back: {capture_s}; graph cache "
        f"{graphs} before the resize round trip, {graphs_after} after; "
        f"launches a replayed frame {lpf}; launches over the phase "
        f"{launches}")
    require(all(r[0] for r in results),
            "viewer: a replayed frame differs from the eager frame")
    require(all(r[1] for r in results), "viewer: non-finite frame")
    require(graphs_after == graphs, f"viewer: the graph cache grew across "
            f"the resize round trip ({graphs} -> {graphs_after})")
    require(lpf["k1_project"] == 1 and lpf["k2_composite"] == 1
            and lpf["sh_colors"] == 1,
            f"viewer: launches a replayed frame {lpf}")
    return dict(served_ms=served_ms, served_dev_ms=served_dev_ms,
                capture_s=capture_s)


def replayed_capture(fr):
    """The capture seconds of ``fr`` (a ServeFrames), whose frames must
    replay a graph."""
    require(fr.info.get("path") == "graph",
            f"viewer: frames ran by {fr.info.get('path')}, not a graph")
    return round(fr.capture_s, 3)


def serve_without_pil():
    """``gs_viewer --serve`` where PIL cannot be imported exits at once,
    non-zero, with a message that names PIL, before it binds a port."""
    code = ("import sys; sys.modules['PIL'] = None; "
            "sys.modules['PIL.Image'] = None; "
            "from ray_eater_tpu_torch import gs_viewer; "
            "sys.exit(gs_viewer.main(['--serve', '0']))")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    el = time.perf_counter() - t0
    log(f"gs_viewer --serve without PIL: exit {r.returncode} in {el:.1f} s, "
        f"stderr {r.stderr.strip()!r}")
    require(r.returncode == 2 and "PIL (pillow) is not installed"
            in r.stderr, "gs_viewer --serve without PIL did not exit with "
            "its message")


def bake_phase(torch, name: str, prog, env, frames, equal):
    """``prog`` (a FrameProgram) baked on the example ``env``, saved,
    loaded; ``frames`` (a list of envs) through both, ``equal(a, b)`` of
    their outputs must hold. Returns (loaded, save s, bytes, load s)."""
    from ray_eater_tpu_torch.graph import render_graph as tg
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{name}.pt2")
        t0 = time.perf_counter()
        prog.save_baked(path, **env)
        t1 = time.perf_counter()
        size = os.path.getsize(path)
        loaded = tg.load_baked(path)
        t2 = time.perf_counter()
    ok = [equal(prog(**e), loaded(**e)) for e in frames]
    log(f"baked {name}: save_baked {t1 - t0:.2f} s, {size} B, load_baked "
        f"{t2 - t1:.2f} s; loaded output bit-equal to the unbaked frame "
        f"{ok}")
    require(all(ok), f"baked {name}: loaded output differs from unbaked")
    return loaded, t1 - t0, size, t2 - t1


def baked_fog_phase(torch, fog):
    """The fog frame (``fog``: the 1M-splat BenchFrames) as a one-pass
    RenderGraph (externals t, budget; outputs image, budget), baked and
    loaded: ``BAKED_FRAMES`` eager frames with the budget carried, then a
    ``BAKED_FRAMES``-frame render_animation of the loaded program,
    u8-equal to the unbaked program's."""
    from ray_eater_tpu_torch.core import animation
    from ray_eater_tpu_torch.graph.render_graph import RenderGraph
    dev = fog.cloud.means.device

    def render(i):
        img, st = fog.frame(i["t"], i["budget"])
        return {"image": img, "budget": fog.next_budget(st, i["budget"])}

    prog = (RenderGraph("fog").external("t", "budget")
            .add_pass("render", render, reads=("t", "budget"),
                      writes=("image", "budget"))
            .output("image", "budget").bake())
    b0 = fog.initial_budget()
    frames, b = [], b0
    for i in range(BAKED_FRAMES):
        t = torch.full((), f32(np.float32(i) / np.float32(60.0)),
                       device=dev)
        frames.append(dict(t=t, budget=b))
        b = prog(t=t, budget=b)["budget"]
    loaded, *times = bake_phase(
        torch, "fog", prog, frames[0], frames,
        lambda a, c: bool(torch.equal(a["image"], c["image"])
                          and torch.equal(a["budget"], c["budget"])))

    def step_of(p):
        def step(t, budget):
            out = p(t=t, budget=budget)
            return out["image"], out["budget"]
        return step

    unbaked, baked = step_of(prog), step_of(loaded)
    want = animation.render_animation(unbaked, BAKED_FRAMES, carry=b0,
                                      device=dev)
    info = {}
    got = animation.render_animation(baked, BAKED_FRAMES, carry=b0,
                                     device=dev, info=info)
    animation.release(unbaked)
    animation.release(baked)
    differ = int((got != want).any(-1).sum())
    log(f"baked fog: {BAKED_FRAMES}-frame render_animation of the loaded "
        f"program [{info['path']}] differs from the unbaked one's in "
        f"{differ} pixels; launches a replayed frame "
        f"{info['launches_per_frame']}")
    require(differ == 0, "baked fog: animation differs from the unbaked")
    return times


def baked_multipass_phase(torch, dev):
    """The multipass RenderGraph frame at 1920x1080 baked and loaded; its
    framebuffer at three times bit-equal to the unbaked frame's."""
    from ray_eater_tpu_torch import multipass
    from ray_eater_tpu_torch import raster_scenes as rs
    prog = multipass.frame_graph(rs.scene("multipass", dev))
    frames = [dict(t=torch.full((), t, device=dev)) for t in (0.0, 0.5,
                                                              0.9)]
    _, *times = bake_phase(
        torch, "multipass", prog, frames[0], frames,
        lambda a, c: bool(torch.equal(a["fb"].color, c["fb"].color)
                          and torch.equal(a["fb"].depth, c["fb"].depth)))
    return times


def lod_tail_phase(torch, gs, fog):
    """The fog flythrough with the ``lod_tail`` slab proxy: the PSNR gate's
    samples against exact, printed beside the same gate without the
    tail (neither gated here)."""
    tail = BenchFrames(gs, fog.cloud, fog.knobs,
                       dict(fog.kw_meas, lod_tail=True), fog.kw_exact,
                       fog.camera)
    base = gate(torch, "fog", fog)[0]
    with_tail = gate(torch, "fog lod_tail", tail)[0]
    b = tail.initial_budget()
    ms = time_ms(torch, lambda: tail.frame(0.5, b), 10)
    ms_no = time_ms(torch, lambda: fog.frame(0.5, b), 10)
    log(f"fog lod_tail: min PSNR vs exact {min(with_tail):.2f} dB over "
        f"{GATE_SAMPLES} sampled frames [" + " ".join(
            f"{p:.2f}" for p in with_tail) + f"]; without the tail "
        f"{min(base):.2f} dB [" + " ".join(f"{p:.2f}" for p in base)
        + f"]; frame at t=0.5 {ms:.3f} ms with the tail, {ms_no:.3f} ms "
        f"without (CUDA events, eager)")
    require(all(np.isfinite(with_tail)), "fog lod_tail: non-finite PSNR")
    return min(with_tail), min(base)


# ---- the API phase: the package's top level and the sample entry points ----

def counted(torch, cuda, total: dict, fn):
    """Run ``fn()`` with the launch counts zeroed just before it; add its
    launches to ``total``. Returns (result, its launches)."""
    cuda.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    got = dict(cuda.launches)
    for k, v in got.items():
        total[k] = total.get(k, 0) + v
    return out, got


def api_phase(torch, cuda, dev="cuda"):
    """The package as a user imports it: the 38 names of the JAX package's
    API on ``import ray_eater_tpu_torch as re``; ``hello``; one fog frame
    (1M splats, 1920x1080, the fog cell's knobs and first budget) through
    ``re.render_gaussians`` on ``re.random_cloud``, bit-equal to the fog
    cell's frame through ``ops.gs.render_gaussians`` (K1, K2);
    ``basic_planes --save-every 20`` over 60 frames, its PNGs u8-equal to
    the frames of a ``render_animation(keep="all")`` of the same step
    (K6); ``compute_drawing --device-loop`` presenting the default run's
    frame (K10, K6); and ``psnr_report`` against its float64 oracles
    (K6, K1, K2), each line at least ``API_MIN_PSNR`` dB. Launches are
    counted around the user's calls only; the frames they are compared
    with are rendered outside the counts. Returns (the launches, the
    PSNR figures)."""
    import contextlib
    import io
    t_phase = time.perf_counter()
    import ray_eater_tpu_torch as re
    from ray_eater_tpu_torch import basic_planes, hello, psnr_report
    from ray_eater_tpu_torch import compute_drawing as cd
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.bench_knobs import (bench_cloud,
                                                 flythrough_camera,
                                                 render_kwargs,
                                                 resolve_knobs)
    from ray_eater_tpu_torch.core import animation
    from ray_eater_tpu_torch.io.image import decode_png
    from ray_eater_tpu_torch.models.gaussians import random_cloud
    from ray_eater_tpu_torch.ops import gs
    total: dict = {}
    dev = torch.device(dev)
    on = ["--device", dev.type]

    missing = [n for n in API_NAMES
               if n not in re.__all__ or not hasattr(re, n)]
    log(f"API: import ray_eater_tpu_torch as re: {len(API_NAMES)} names, "
        f"missing {missing}")
    require(not missing, f"API names missing: {missing}")
    require(re.render_gaussians is gs.render_gaussians
            and re.random_cloud is random_cloud,
            "re.render_gaussians / re.random_cloud are not the submodules'")
    require(hello.main(on) == 0, "hello returned nonzero")

    # fog frame: the cell's frame first (not counted), then the user's
    knobs = resolve_knobs("fog", N_SPLATS, env={})
    kw = render_kwargs(knobs, exact=False, interpret=False)
    view, proj = flythrough_camera(0.0, W, H, device=dev)
    budget = (gs.initial_lod_budget(W, H, knobs["tile_w"],
                                    knobs["max_splats_per_tile"], dev)
              if knobs["temporal"] else None)
    cloud = bench_cloud("fog", N_SPLATS, dev)
    want, _ = gs.render_gaussians(cloud, view, proj, W, H,
                                  lod_budget=budget, **kw)
    del cloud
    cloud = re.random_cloud(N_SPLATS, seed=1, extent=1.0,
                            scale_range=(0.004, 0.02), device=dev)
    (got, _), fog = counted(torch, cuda, total, lambda: re.render_gaussians(
        cloud, view, proj, W, H, lod_budget=budget, **kw))
    equal = torch.equal(got, want)
    log(f"API fog frame {N_SPLATS} splats {W}x{H} through re.render_gaussians"
        f": bit-equal to ops.gs.render_gaussians's {equal}, finite "
        f"{bool(torch.isfinite(got).all())}; launches {fog}")
    require(equal, "re.render_gaussians frame differs from the fog cell's")
    require(fog["k1_project"] > 0 and fog["k2_composite"] > 0,
            f"API fog frame launched {fog}")
    del cloud, got, want
    torch.cuda.empty_cache()

    # basic_planes --save-every
    a = basic_planes.parse_args(
        ["--frames", str(RASTER_FRAMES), "--save-every", str(API_SAVE_EVERY),
         "--out", f"{API_OUT}/basic_planes", *on])
    r, bp = counted(torch, cuda, total, lambda: basic_planes.run(a))
    require_replayed("basic_planes --save-every", bp, r)
    frame = rs.scene("basic_planes", dev, a.width, a.height,
                     texture=basic_planes.load_texture(dev)).frame
    frames = animation.render_animation(frame, RASTER_FRAMES, keep="all",
                                        device=dev).cpu().numpy()
    animation.release(frame)
    want_saved = list(range(0, RASTER_FRAMES, API_SAVE_EVERY))
    differ = {}
    for i, path in r["saved"].items():
        with open(path, "rb") as f:
            differ[i] = int((decode_png(f.read()) != frames[i]).any(-1).sum())
    log(f"API basic_planes --save-every {API_SAVE_EVERY} [{r['path']}]: "
        f"saved frames {sorted(r['saved'])}, pixels differing from "
        f"render_animation's frames {differ}; launches {bp}")
    require(sorted(r["saved"]) == want_saved and not any(differ.values()),
            f"basic_planes --save-every: saved {sorted(r['saved'])}, "
            f"differing pixels {differ}")

    # compute_drawing --device-loop against the default run (not counted)
    default = cd.run(cd.parse_args(["--frames", str(RASTER_FRAMES), "--out",
                                    f"{API_OUT}/compute_drawing_default",
                                    *on]))
    a = cd.parse_args(["--device-loop", "--frames", str(RASTER_FRAMES),
                       "--out", f"{API_OUT}/compute_drawing", *on])
    r, drawing = counted(torch, cuda, total, lambda: cd.run(a))
    equal = torch.equal(r["u8"], default["u8"])
    log(f"API compute_drawing --device-loop [{r['path']}]: presented frame "
        f"equal to the default run's {equal}; launches {drawing}")
    require(equal, "compute_drawing --device-loop differs from the default")
    require(drawing["k10_splat"] == 1, f"compute_drawing --device-loop "
            f"launched K10 {drawing['k10_splat']} times")
    require_replayed("compute_drawing --device-loop", drawing, r)
    del default, r

    # psnr_report against the float64 oracles
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, psnr = counted(torch, cuda, total,
                           lambda: psnr_report.main(on))
    lines = buf.getvalue().strip().splitlines()
    for line in lines[:-1]:
        log(f"API {line}")
    figures = json.loads(lines[-1])["psnr"]
    log(f"API psnr_report launches {psnr}")
    print(json.dumps({"psnr": figures}), flush=True)
    require(rc == 0 and len(figures) == 3, "psnr_report failed")
    require(all(x >= API_MIN_PSNR for x in figures.values()),
            f"psnr_report under {API_MIN_PSNR} dB: {figures}")
    require(all(psnr[k] > 0 for k in ("k1_project", "k2_composite",
                                      "k6_raster")),
            f"psnr_report launched {psnr}")
    log(f"API phase: {time.perf_counter() - t_phase:.1f} s; launches "
        f"{total}")
    return total, figures


def sharded_kwargs(kw: dict) -> dict:
    """The ``render_kwargs`` that ``render_gaussians_sharded`` takes (the
    JAX function's keywords: no ``pairs_cap_factor``, no
    ``payload_sort``)."""
    return {k: v for k, v in kw.items()
            if k not in ("pairs_cap_factor", "payload_sort")}


class ShardedFrames(BenchFrames):
    """:class:`BenchFrames` through ``render_gaussians_sharded`` on
    ``mesh``: the budgets are full-grid over the banded tile grid (its
    rows padded to a multiple of D)."""

    def __init__(self, gs, cloud, knobs, kw_meas, camera, mesh, sharded,
                 exchange: str):
        super().__init__(gs, cloud, knobs, sharded_kwargs(kw_meas), None,
                         camera)
        self.mesh, self.sharded, self.exchange = mesh, sharded, exchange
        ntx, nty = gs.num_tiles(W, H, knobs["tile_w"])
        d = mesh.size()
        self.ntx, self.nty = ntx, -(-nty // d) * d

    def frame(self, t, budget):
        view, proj = self.camera(t, W, H, device=self.cloud.means.device)
        return self.sharded.render_gaussians_sharded(
            self.cloud, view, proj, W, H, self.mesh,
            lod_budget=budget if self.temporal else None,
            splat_exchange=self.exchange, **self.kw_meas)

    def initial_budget(self):
        return self.gs.initial_lod_budget(
            W, self.nty * self.gs.TILE_H, self.knobs["tile_w"],
            self.knobs["max_splats_per_tile"], self.cloud.means.device)

    def next_budget(self, st, budget):
        if not self.temporal:
            return budget
        return self.gs.update_lod_budget(
            st["tile_exec"], self.knobs["max_splats_per_tile"], self.ntx,
            self.nty, st["tile_kept"], st["tile_count"],
            dry_floor=self.knobs["dry_floor"])


def md_window(torch, frames, n: int):
    """``n`` frames of ``frames`` from t = 0 (the budget carried when
    temporal): (the images, ms/frame by CUDA events)."""
    budget = frames.initial_budget() if frames.temporal else None
    frames.frame(0.0, budget)          # warm-up (allocator, first launches)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    imgs = []
    e0.record()
    for i in range(n):
        img, st = frames.frame(f32(np.float32(i) / np.float32(60.0)), budget)
        imgs.append(img)
        budget = frames.next_budget(st, budget)
    e1.record()
    e1.synchronize()
    return imgs, e0.elapsed_time(e1) / n


def md_compare(torch, label, got, want, ms, ms_single, rec, max_abs=None,
               mean_abs=None):
    """A sharded window against the single-device one: each frame's max and
    mean abs (gated by the limits given) and the share of its pixels off
    by more than ``MD_EXACT_MAX``."""
    err = [(g - w).abs() for g, w in zip(got, want)]
    mx = [float(e.max()) for e in err]
    mean = [float(e.mean()) for e in err]
    off = [float((e.amax(-1) > MD_EXACT_MAX).float().mean()) for e in err]
    rec[label] = dict(max=mx, mean=mean, share=off, ms=ms,
                      single_ms=ms_single)
    rec["log"].append(
        f"{label}: {len(got)} frames, max abs {max(mx):.3e}, mean abs "
        f"{max(mean):.3e}, share of pixels off by more than "
        f"{MD_EXACT_MAX:g} {max(off):.2e} (worst frame); {ms:.3f} ms/frame "
        f"sharded, {ms_single:.3f} single-device (CUDA events, eager)")
    ok = ((max_abs is None or max(mx) <= max_abs)
          and (mean_abs is None or max(mean) <= mean_abs)
          and all(bool(torch.isfinite(g).all()) for g in got))
    if not ok:
        rec["failures"].append(f"{label}: max {mx} mean {mean} share {off}")


def md_rank(rank: int, d: int, port: int, out_dir: str) -> None:
    """One rank of the multi-device phase (``d`` ranks, one card each,
    NCCL): the sharded fog (all_gather and ring), inria and sort-last
    frames at 1M splats / 1080p and grid10k through render_mesh_sharded,
    each against the single-device frames of the same inputs, and
    ``MD_TRAIN_STEPS`` data-parallel training steps against the
    single-device steps; launch counts over the sharded paths; at D = 1 a
    captured sharded fog frame (``animation_phase``). Writes
    ``rank<r>.json`` into ``out_dir``."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    from ray_eater_tpu_torch import gs_trainer
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.bench_knobs import (bench_cloud,
                                                 flythrough_camera,
                                                 render_kwargs,
                                                 resolve_knobs)
    from ray_eater_tpu_torch.core.resources import create_framebuffer
    from ray_eater_tpu_torch.models import gs_training as tr
    from ray_eater_tpu_torch.ops import _cuda as cuda
    from ray_eater_tpu_torch.ops import gs, raster
    from ray_eater_tpu_torch.parallel import sharded

    mesh = sharded.make_device_mesh(d, device="cuda",
                                    init_method=f"tcp://localhost:{port}",
                                    rank=rank)
    dev = torch.device("cuda", torch.cuda.current_device())
    cuda.lib()
    rec = {"rank": rank, "d": d, "device": str(dev), "log": [],
           "failures": []}
    launches = {k: 0 for k in cuda.launches}

    def count(fn):
        """``fn()`` with the launch counts zeroed just before and read just
        after, added to ``launches``."""
        torch.cuda.synchronize()
        cuda.reset_launches()
        out = fn()
        torch.cuda.synchronize()
        for k, v in cuda.launches.items():
            launches[k] += v
        return out

    # fog: the temporal budget over MD_FRAMES frames, all_gather and ring
    knobs = resolve_knobs("fog", N_SPLATS, env={})
    kw = render_kwargs(knobs, exact=False, interpret=False)
    cloud = bench_cloud("fog", N_SPLATS, dev)
    single = BenchFrames(gs, cloud, knobs, kw, None, flythrough_camera)
    want, ms1 = md_window(torch, single, MD_FRAMES)
    for ex in ("all_gather", "ring"):
        fr = ShardedFrames(gs, cloud, knobs, kw, flythrough_camera, mesh,
                           sharded, ex)
        got, ms = count(lambda: md_window(torch, fr, MD_FRAMES))
        md_compare(torch, f"fog LOD sharded ({ex})", got, want, ms, ms1,
                   rec, mean_abs=MD_LOD_MEAN)
        del got
    del want

    # sort-last, exact, against the exact single-device frame
    kw_exact = render_kwargs(knobs, exact=True, interpret=False)
    view, proj = flythrough_camera(0.0, W, H, device=dev)
    ref = gs.render_gaussians(cloud, view, proj, W, H, **kw_exact)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    ref = gs.render_gaussians(cloud, view, proj, W, H, **kw_exact)
    e1.record()
    e1.synchronize()
    ms1 = e0.elapsed_time(e1)

    def sliced():
        sharded.render_gaussians_depth_sliced(
            cloud, view, proj, W, H, mesh, tile_w=knobs["tile_w"])
        torch.cuda.synchronize()
        e0.record()
        out = sharded.render_gaussians_depth_sliced(
            cloud, view, proj, W, H, mesh, tile_w=knobs["tile_w"],
            return_stats=True)
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    (img, st), ms = count(sliced)
    rec["log"].append(f"fog exact depth-sliced stats: overflow_pairs "
                      f"{int(st['overflow_pairs'])}, overflow_big_splats "
                      f"{int(st['overflow_big_splats'])}, lossless "
                      f"{bool(st['lossless'])}")
    md_compare(torch, "fog exact depth-sliced", [img], [ref], ms, ms1, rec,
               max_abs=MD_EXACT_MAX)

    # the captured sharded fog frame (D = 1): replay u8-equal to eager
    if d == 1:
        fr = ShardedFrames(gs, cloud, knobs, kw, flythrough_camera, mesh,
                           sharded, "all_gather")
        anim = animation_phase(torch, cuda, "fog sharded (D = 1)", fr.step,
                               carry=fr.initial_budget(),
                               finite=img_finite(torch), dev=dev)
        rec["animation"] = {k: anim[k] for k in (
            "scene", "frames", "replay_ms", "replay_host_ms",
            "replay_busy_ms", "eager_ms", "eager_host_ms", "capture_s",
            "launches_per_frame", "differing_pixels", "carry_equal")}
    del cloud, ref, img
    torch.cuda.empty_cache()

    # inria: K3 in the band
    knobs = resolve_knobs("inria", N_SPLATS, env={})
    kw = render_kwargs(knobs, exact=False, interpret=False)
    cloud = bench_cloud("inria", N_SPLATS, dev)
    want, ms1 = md_window(torch, BenchFrames(gs, cloud, knobs, kw, None,
                                             flythrough_camera),
                          MD_INRIA_FRAMES)
    fr = ShardedFrames(gs, cloud, knobs, kw, flythrough_camera, mesh,
                       sharded, "all_gather")
    got, ms = count(lambda: md_window(torch, fr, MD_INRIA_FRAMES))
    md_compare(torch, "inria LOD sharded (all_gather)", got, want, ms, ms1,
               rec, mean_abs=MD_LOD_MEAN)
    del cloud, want, got
    torch.cuda.empty_cache()

    # grid10k (binned: K7, K8, K9) through render_mesh_sharded
    sc = rs.scene("grid10k", dev)
    pipe, res = sc.passes[0]
    uni = sc.uniforms(0.5)
    want = raster.render_mesh(pipe, sc.mesh, uni, res,
                              create_framebuffer(W, H, device=dev))
    wc, wd = want.color[:H, :W], want.depth[:H, :W]

    def grid():
        sharded.render_mesh_sharded(pipe, sc.mesh, uni, res, W, H, mesh)
        torch.cuda.synchronize()
        e0.record()
        out = sharded.render_mesh_sharded(pipe, sc.mesh, uni, res, W, H,
                                          mesh)
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)
    (gc, gd), ms = count(grid)
    share = float(((gc - wc).abs().amax(-1) > MD_RASTER_TOL).float().mean())
    dshare = float(((gd - wd).abs() > MD_RASTER_TOL).float().mean())
    mse = float(torch.mean((gc[..., :3] - wc[..., :3]) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    rec["grid10k"] = dict(max=float((gc - wc).abs().max()), share=share,
                          depth_share=dshare, psnr=psnr, ms=ms)
    rec["log"].append(
        f"grid10k sharded raster: colour max abs "
        f"{float((gc - wc).abs().max()):.3e}, share of pixels off by more "
        f"than {MD_RASTER_TOL:g} {share:.2e} (depth {dshare:.2e}), PSNR "
        f"{psnr:.2f} dB; {ms:.3f} ms/frame sharded (CUDA events, eager)")
    # at D > 1 each band plans its own subtiles and fallback budget and
    # differences its uv at its own edge, so the textured colour is held
    # by the subtile sampler's PSNR gate; the fold (depth) by the share
    ok = (share <= MD_RASTER_SHARE if d == 1 else psnr >= SUBTILE_MIN_PSNR)
    if not ok or dshare > MD_RASTER_SHARE:
        rec["failures"].append(f"grid10k sharded raster: share {share}, "
                               f"depth {dshare}, PSNR {psnr}")

    # data-parallel training at gs_trainer's defaults
    args = gs_trainer.parse_args([])
    losses = {}
    for name in ("single", "dp"):
        view, proj, target, params = gs_trainer.train_setup(
            args.splats, args.width, args.height, dev, "jnp")
        opt = tr.adam(params, args.lr)
        step = (tr.make_train_step_dp(opt, view, proj, mesh) if name == "dp"
                else tr.make_train_step(opt, view, proj))
        run_steps = (lambda: [float(step(params, target))
                              for _ in range(MD_TRAIN_STEPS)])
        losses[name] = count(run_steps) if name == "dp" else run_steps()
        losses[name + "_means"] = params.means.detach()
    dl = np.abs(np.array(losses["dp"]) - np.array(losses["single"]))
    dm = float((losses["dp_means"] - losses["single_means"]).abs().max())
    rec["train"] = dict(single=losses["single"], dp=losses["dp"],
                        means_max=dm)
    rec["log"].append(
        f"make_train_step_dp ({args.splats} splats {args.width}x"
        f"{args.height}, {MD_TRAIN_STEPS} steps): losses {losses['dp']} vs "
        f"single-device {losses['single']}; means max abs {dm:.3e}")
    if (dl > MD_LOSS_RTOL * np.abs(np.array(losses["single"]))).any() or \
            dm > MD_MEANS_ATOL:
        rec["failures"].append(f"dp training: losses {losses}, means {dm}")
    rec["launches"] = launches
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def multidevice_phase(torch):
    """The multi-device phase at D = ``torch.cuda.device_count()`` ranks,
    spawned, one card each, NCCL (:func:`md_rank`). Returns (the launch
    counts summed over the ranks, the animation record or None, rank 0's
    record)."""
    import socket

    import torch.multiprocessing as mp
    d = torch.cuda.device_count()
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        try:
            mp.spawn(md_rank, args=(d, port, out_dir), nprocs=d)
        except Exception as e:
            raise SmokeFailure(f"multi-device phase: a rank failed: {e}")
        recs = []
        for r in range(d):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                recs.append(json.load(f))
    log(f"multi-device phase: {d} rank(s), NCCL, "
        f"{time.perf_counter() - t0:.1f} s (spawn included)")
    for line in recs[0]["log"]:
        log(f"  [rank 0] {line}")
    total = {}
    for rec in recs:
        require(not rec["failures"], f"multi-device rank {rec['rank']}: "
                f"{rec['failures']}")
        for key in ("k1_project", "k2_composite", "k3_composite_tail",
                    "k7_raster_binned", "k8_shade_fetch", "k9_subtile"):
            require(rec["launches"][key] > 0, f"multi-device rank "
                    f"{rec['rank']}: {key} was not launched")
        for k, v in rec["launches"].items():
            total[k] = total.get(k, 0) + v
    log(f"multi-device launches, summed over the ranks: {total}")
    return total, recs[0].get("animation"), recs[0]


def run() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        return 2
    from ray_eater_tpu_torch import gs_trainer
    from ray_eater_tpu_torch.bench_knobs import (bench_cloud,
                                                 flythrough_camera,
                                                 layout_kwargs,
                                                 render_kwargs,
                                                 resolve_knobs)
    from ray_eater_tpu_torch.models import gs_training as tr
    from ray_eater_tpu_torch.models.gaussians import random_cloud
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
    native_build()
    serve_without_pil()

    # ---- fog: K1, K2 -------------------------------------------------------
    dev = torch.device("cuda")
    knobs = resolve_knobs("fog", N_SPLATS, env={})
    kw_meas = render_kwargs(knobs, exact=False, interpret=False)
    kw_exact = render_kwargs(knobs, exact=True, interpret=False)
    log("fog knobs: " + " ".join(f"{k}={v}" for k, v in knobs.items()))
    t0 = time.perf_counter()
    cloud = bench_cloud("fog", N_SPLATS, dev)
    log(f"fog cloud: {N_SPLATS} splats in {time.perf_counter() - t0:.2f} s")

    view, proj = flythrough_camera(0.0, W, H, device=dev)
    k1 = check_k1(torch, gs, cloud, view, proj, "fog, t=0",
                  gs.level1_max_radius(gs.KY))

    lay_lod = gs._frame_layout(cloud, view, proj, W, H, **layout_kwargs(
        knobs, False, W, H, dev))
    k2 = check_k2(torch, gs, lay_lod, "fog LOD frame, t=0", reps=20)
    del lay_lod
    lay_exact = gs._frame_layout(cloud, view, proj, W, H, **layout_kwargs(
        knobs, True, W, H, dev))
    k2_exact = check_k2(torch, gs, lay_exact, "fog exact frame, t=0", reps=5)
    del lay_exact
    torch.cuda.empty_cache()

    check_small(torch, gs, "fog",
                lambda n, d: random_cloud(n, seed=2, extent=1.0,
                                          scale_range=(0.004, 0.02),
                                          device=d),
                flythrough_camera, kw_meas, kw_exact)

    fog = BenchFrames(gs, cloud, knobs, kw_meas, kw_exact, flythrough_camera)
    fog_launches = main_path(torch, cuda, "fog", fog)
    anims = [animation_phase(torch, cuda, "fog", fog.step,
                             carry=fog.initial_budget(),
                             finite=img_finite(torch))]
    baked_fog_phase(torch, fog)
    lod_tail_phase(torch, gs, fog)
    del fog
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
    cloud = bench_cloud("inria", N_SPLATS, dev)
    log(f"inria cloud: {N_SPLATS} splats in {time.perf_counter() - t0:.2f} s")
    view, proj = flythrough_camera(0.0, W, H, device=dev)
    k1_inria = check_k1(torch, gs, cloud, view, proj, "inria, t=0",
                        gs.level2_max_radius(tile_w))
    lay = gs._frame_layout(cloud, view, proj, W, H, **layout_kwargs(
        knobs, False, W, H, dev))
    log(f"inria LOD layout, t=0: overflow_pairs {int(lay.binned.overflow)}, "
        f"overflow_big_splats {int(lay.binned.overflow_big)}, head pairs "
        f"kept {int(lay.binned.kept.sum())}, tail pairs kept "
        f"{int(lay.binned.kept_tl.sum())} of {int(lay.binned.count.sum())}")
    k2_inria = check_k2(torch, gs, lay, "inria LOD head, t=0", reps=20)
    k3 = check_k3(torch, gs, lay, decim, "inria LOD tail, t=0", reps=20)
    del lay
    torch.cuda.empty_cache()

    check_small(torch, gs, "inria",
                lambda n, d: bench_cloud("inria", n, d),
                flythrough_camera,
                render_kwargs(resolve_knobs("inria", SMALL["n"], env={}),
                              exact=False, interpret=False),
                render_kwargs(resolve_knobs("inria", SMALL["n"], env={}),
                              exact=True, interpret=False))

    inria = BenchFrames(gs, cloud, knobs, kw_meas, kw_exact,
                        flythrough_camera)
    inria_launches = main_path(torch, cuda, "inria", inria)
    anims.append(animation_phase(torch, cuda, "inria",
                                 lambda t: inria.frame(t, None)[0],
                                 finite=img_finite(torch)))
    del inria
    for key, name in (("k1_project", "K1"), ("k2_composite", "K2"),
                      ("k3_composite_tail", "K3")):
        require(inria_launches[key] > 0, f"{name} was not launched on the "
                "inria main path")
    for d in (k1_inria, k2_inria):
        log(f"{d['name']} [inria, t=0]: {d['ms']:.4f} ms, plain "
            f"{d['plain_ms']:.4f} ms, bound {d['bound_ms']:.4f} ms "
            f"({d['bound_by']}), max abs err {d['max_abs_err']:.3e}")

    del cloud
    torch.cuda.empty_cache()

    # ---- training: K4, K5 --------------------------------------------------
    n, w, h = TRAIN["n"], TRAIN["w"], TRAIN["h"]
    t0 = time.perf_counter()
    lay, args, k4_out, dplanes, loss0 = gs_trainer.first_frame(n, w, h,
                                                               dev)
    log(f"training frame {n} splats {w}x{h} (tile_w {lay.tile_w}, mpt 256): "
        f"{lay.ntx * lay.nty} tiles, {int(lay.binned.kept.sum())} pairs "
        f"kept of {int(lay.binned.count.sum())}, MSE {loss0:.6e}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    k2_train = check_k2(torch, gs, lay, "training frame, tile_w 128",
                        reps=20)
    k4 = check_k4(torch, gs, lay, args, k4_out, "training frame", reps=20)
    k5 = check_k5(torch, gs, args, k4_out, dplanes, "training frame",
                  reps=20)
    log(f"K2 training frame (tile_w 128, no gradients): "
        f"{k2_train['ms']:.4f} ms, plain {k2_train['plain_ms']:.4f} ms, "
        f"bound {k2_train['bound_ms']:.4f} ms ({k2_train['bound_by']})")
    del lay, args, k4_out, dplanes
    torch.cuda.empty_cache()
    check_train_small(torch, gs, tr, gs_trainer)
    train_launches, _ = train_path(torch, cuda, gs_trainer)
    torch.cuda.empty_cache()
    adc_launches, _ = adc_path(torch, cuda, gs_trainer)

    torch.cuda.empty_cache()

    # ---- raster and sampling: K6, K7, K8, K9 -------------------------------
    from ray_eater_tpu_torch import raster_scenes as rs
    from ray_eater_tpu_torch.ops import raster, sampling
    less = raster._mode_bits(True, False, False, False)
    sc = rs.scene("basic_planes", dev)
    fb, ds = rs.draw_setup(sc, 0.5)
    check_k6(torch, raster, ds, fb.depth, sc.width, sc.height, less,
             "basic_planes frame t=0.5", reps=5)
    sc = rs.scene("multipass", dev)
    fb, ds = rs.draw_setup(sc, 0.5)   # both passes share the vertex stage
    pre, _ = check_k6(torch, raster, ds, fb.depth, sc.width, sc.height, less,
                      "multipass prepass t=0.5", reps=20)
    _, k6 = check_k6(torch, raster, ds, pre[0][:sc.height], sc.width,
                     sc.height, raster._mode_bits(True, False, True, False),
                     "multipass lit pass t=0.5", reps=20)
    k7, k8, k9 = check_grid_kernels(torch, raster, sampling,
                                    rs.scene("grid10k", dev), 0.5, reps=20)
    check_k9_bf16(torch, raster, sampling, rs, dev, 0.5, reps=20)
    torch.cuda.empty_cache()
    check_raster_small(torch, rs)
    raster_launches = raster_paths(torch, cuda, dev)
    torch.cuda.empty_cache()
    from ray_eater_tpu_torch import multipass
    anims.append(animation_phase(torch, cuda, "basic_planes",
                                 rs.scene("basic_planes", dev).frame,
                                 finite=fb_finite(torch)))
    frame = multipass.frame_graph(rs.scene("multipass", dev))
    anims.append(animation_phase(torch, cuda, "multipass (RenderGraph)",
                                 lambda t: frame(t=t)["fb"],
                                 finite=fb_finite(torch)))
    anims.append(animation_phase(torch, cuda, "grid10k",
                                 rs.scene("grid10k", dev).frame,
                                 finite=fb_finite(torch)))
    swapchain_phase(torch, cuda)
    textured_planes_phase(torch, dev)
    baked_multipass_phase(torch, dev)
    torch.cuda.empty_cache()

    # ---- particle splat: K10 on the sample's pass and a wide check;
    # compute_drawing ----------------------------------------------------
    from ray_eater_tpu_torch import compute_drawing as cd
    from ray_eater_tpu_torch.ops import splat
    pos = torch.from_numpy(cd.particle_positions(0)).to(dev)
    k10 = check_k10(torch, splat, pos, cd.HEIGHT, cd.WIDTH, cd.PIXELS_RAD,
                    "compute_drawing pass 900x600", reps=50)
    wd = K10_WIDE
    rng = np.random.RandomState(2)
    span = np.array([wd["w"], wd["h"]], np.float32) + 2 * wd["margin"]
    pos = torch.from_numpy((rng.rand(wd["n"], 2) * span - wd["margin"])
                           .astype(np.float32)).to(dev)
    wide = check_k10(torch, splat, pos, wd["h"], wd["w"], wd["r"],
                     f"wide check {wd['w']}x{wd['h']}", reps=20)
    log(f"K10 wide check: {wide['ms']:.4f} ms, plain {wide['plain_ms']:.4f} "
        f"ms, bound {wide['bound_ms']:.4f} ms, library "
        f"{wide['library_ms']:.4f} ms")
    pos = torch.from_numpy(cd.particle_positions(0, wd["w"], wd["h"],
                                                 wd["n"])).to(dev)
    hd = check_k10(torch, splat, pos, wd["h"], wd["w"], cd.PIXELS_RAD,
                   f"sample's draw, {wd['n']} @ {wd['w']}x{wd['h']}",
                   reps=20)
    log(f"K10 at {wd['n']} particles, {wd['w']}x{wd['h']} (RandomState(0)): "
        f"{hd['ms']:.4f} ms (events), device {hd['device_ms']:.5f} ms, "
        f"launch floor {hd['floor_ms']:.5f} ms, bound {hd['bound_ms']:.5f} "
        f"ms, library {hd['library_ms']:.4f} ms")
    check_drawing_small(torch)
    drawing_launches = compute_drawing_path(torch, cuda)
    anims.append(animation_phase(torch, cuda, "compute_drawing",
                                 cd.setup(dev).frame, srgb=False,
                                 finite=fb_finite(torch)))
    torch.cuda.empty_cache()

    # ---- SH colours from a PLY through gs_viewer: SH colour, K1, K2 ------
    check_sh_small(torch)
    sh_launches, anim, ksh = sh_path(torch, gs, cuda, dev)
    anims.append(anim)
    torch.cuda.empty_cache()

    # ---- the API phase: the package's top level and entry points --------
    api_launches, _ = api_phase(torch, cuda)
    torch.cuda.empty_cache()

    # ---- multi-device: sharded K1, K2, K3, K7, K8, K9 on each rank -------
    md_launches, anim, _ = multidevice_phase(torch)
    if anim is not None:
        anims.append(anim)
    log("animation phase, ms/frame (replay by CUDA events; eager loop by "
        "CUDA events), capture s: " + "; ".join(
            f"{a['scene']} {a['replay_ms']:.3f} / {a['eager_ms']:.3f}, "
            f"{a['capture_s']:.3f}" for a in anims))
    print(json.dumps({"animation": [
        {k: a[k] for k in ("scene", "frames", "replay_ms", "replay_host_ms",
                           "replay_busy_ms", "eager_ms", "eager_host_ms",
                           "capture_s",
                           "launches_per_frame", "differing_pixels",
                           "carry_equal")} for a in anims]}))

    paths = (fog_launches, inria_launches, train_launches, adc_launches,
             *raster_launches.values(), drawing_launches, sh_launches,
             api_launches, md_launches)
    for d, key in ((k1, "k1_project"), (k2, "k2_composite"),
                   (k3, "k3_composite_tail"), (k4, "k4_composite_ckpt"),
                   (k5, "k5_composite_bwd"), (k6, "k6_raster"),
                   (k7, "k7_raster_binned"), (k8, "k8_shade_fetch"),
                   (k9, "k9_subtile"), (k10, "k10_splat"),
                   (ksh, "sh_colors")):
        d["launches"] = sum(p[key] for p in paths)
    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    log(f"chip_smoke ran {time.perf_counter() - t_start:.1f} s")
    log(f"card: {card}")
    print(json.dumps({"kernels": [{k: d[k] for k in keys}
                                  for d in (k1, k2, k3, k4, k5, k6, k7, k8,
                                            k9, k10, ksh)]}))
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
