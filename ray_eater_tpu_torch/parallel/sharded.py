"""Multi-device rendering on ``torch.distributed`` (counterpart of
``ray_eater_tpu/parallel/sharded.py``).

One process drives one device (SPMD, the PyTorch idiom): every rank calls
the same function with the same full inputs, and its rank in the mesh
(JAX's ``axis_index``) picks its share of the work.

* **Splat-parallel projection**: rank r projects the splats
  ``[r·N/D, (r+1)·N/D)`` (kernel K1) and the projected records reach the
  ranks that need them by one ``all_gather`` (or a ring of
  ``batch_isend_irecv`` hops with per-hop compaction, :func:`_ring_compact`).
* **Tile-parallel composite and raster**: the frame is cut into row bands,
  one a rank; each rank bins and composites (K2, and K3 for the decimated
  tail) or rasters and shades (K6, or K7 + K8, and K9) only its band. The
  bands and the per-tile stats are gathered at the end, so every rank
  returns the whole image.
* **Sort-last** (:func:`render_gaussians_depth_sliced`): each rank
  composites the full frame over one depth slice of the splats, and the
  slices fold front to back.

The collectives map one to one: a tiled ``all_gather`` is
``all_gather_into_tensor``, the ``ppermute`` ring is ``batch_isend_irecv``
to ``(r+1) % D`` from ``(r-1) % D``, ``psum``/``pmax`` are ``all_reduce``
with ``SUM``/``MAX``. Every collective runs on ``mesh.get_group()``. A
render makes no host sync and no host-to-device copy, so a frame step that
calls it can be captured as a CUDA graph (``core.animation``).

:func:`make_device_mesh` builds the 1-D mesh: NCCL on CUDA (rank r on
``cuda:<local rank>``), gloo only when the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core.resources import Framebuffer
from ..models.gaussians import eval_sh_colors
from ..ops import gs as gs_ops
from ..ops import raster as raster_ops
from ..utils import on_device
from ..utils import pad_to as _pad_to

_F32 = torch.float32
_I32 = torch.int32

# the packet's columns past the (12,) record: radius, depth (+inf where
# culled), valid, and the two per-axis extents
_RAD, _DEPTH, _VALID, _EXT = (gs_ops._ROWS + k for k in range(4))

# ``all_gather_into_tensor`` is named ``all_gather_single`` in newer torch
_all_gather = (getattr(dist, "all_gather_single", None)
               or dist.all_gather_into_tensor)


def make_device_mesh(n_devices: int | None = None, axis: str = "d",
                     device="cuda", init_method: str | None = None,
                     rank: int | None = None) -> DeviceMesh:
    """The 1-D device mesh over the default process group's ranks, one
    process a device.

    Without a default group it is initialised here: from the launcher's
    environment (``torchrun``: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
    ``MASTER_PORT``) when ``init_method`` is None, else from
    ``init_method`` (``tcp://host:port`` or ``file://path``) with this
    process's ``rank`` and ``n_devices`` ranks. The backend follows
    ``device``: NCCL for ``"cuda"``, with this process on
    ``cuda:<LOCAL_RANK>`` (the rank modulo the visible devices when the
    launcher sets none); gloo for ``"cpu"``. Raises if ``n_devices``
    differs from the world size, or if an existing group's backend does
    not serve ``device``."""
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"make_device_mesh: unsupported device {device!r}")
    backend = "nccl" if kind == "cuda" else "gloo"
    if not dist.is_initialized():
        if init_method is None:
            rank = int(os.environ["RANK"])
            world = int(os.environ["WORLD_SIZE"])
            init_method = "env://"
        else:
            if rank is None or n_devices is None:
                raise ValueError("make_device_mesh: init_method needs rank "
                                 "and n_devices")
            world = n_devices
        if kind == "cuda":
            local = int(os.environ.get("LOCAL_RANK",
                                       rank % torch.cuda.device_count()))
            torch.cuda.set_device(local)
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world)
    if dist.get_backend() != backend:
        raise ValueError(f"make_device_mesh: the process group's backend "
                         f"is {dist.get_backend()}, {device!r} needs "
                         f"{backend}")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"make_device_mesh: {n_devices} devices asked, the "
                         f"process group has {world} ranks")
    return DeviceMesh(kind, torch.arange(world), mesh_dim_names=(axis,))


def _axis(mesh: DeviceMesh):
    """(process group, size D, this rank's index) of the 1-D ``mesh``."""
    return mesh.get_group(), mesh.size(), mesh.get_local_rank()


def _gather(x: torch.Tensor, group, d: int) -> torch.Tensor:
    """Tiled all_gather: the ranks' ``x`` concatenated along dim 0."""
    out = x.new_empty((d * x.shape[0], *x.shape[1:]))
    _all_gather(out, x.contiguous(), group=group)
    return out


def _ring_hop(pkt: torch.Tensor, group, d: int, r: int) -> torch.Tensor:
    """One ring hop: send ``pkt`` to rank (r+1) % d, return the packet of
    rank (r-1) % d."""
    recv = torch.empty_like(pkt)
    ops = [dist.P2POp(dist.isend, pkt, dist.get_global_rank(
               group, (r + 1) % d), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(
               group, (r - 1) % d), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _ring_compact(packet, keep_fn, budget: int, group, d: int, r: int):
    """Ring exchange with budgeted compaction (shared by the row-band and
    depth-sliced renders): the (n/d, C) shard packets circulate the ring
    d-1 hops; at each visit this rank appends the rows ``keep_fn(pkt)``
    selects to a fixed ``budget``-row buffer by one key-only sort of
    ``where(keep, iota, n/d)`` (the keys are unique apart from the
    sentinel, so any sort gives one order) and one row gather. The d-th
    shard is the one in hand after the last hop, so no trailing hop is
    paid. Rows past the budget are dropped whole and counted.

    The hops append the shards in ring order (r, r-1, ...); the kept rows
    are then put back in shard order by one stable sort of their shard
    ids, so they come in the frame's splat order: a depth key tied with
    another breaks as on one device (JAX keeps the ring order). Returns
    (buffer, count, overflow); the buffer's dead slots are zero rows, last."""
    nd, dev = packet.shape[0], packet.device
    slot = torch.arange(budget, dtype=_I32, device=dev)
    iota = torch.arange(nd, dtype=_I32, device=dev)

    def compact(pkt, shard, buf, seg, cnt, ov):
        ok = keep_fn(pkt)
        skey = torch.sort(torch.where(ok, iota, nd)).values
        k = ok.sum(dtype=_I32)
        head = torch.clamp(skey, max=nd - 1)
        head = (head[:budget] if budget <= nd else torch.cat(
            [head, torch.full((budget - nd,), nd - 1, dtype=_I32,
                              device=dev)]))
        # slot s >= cnt takes kept row s - cnt: JAX's roll of the compacted
        # ids by cnt, as a gather at (s - cnt) mod budget (the wrapped
        # slots < cnt are masked off by ``put``)
        src = head[torch.remainder(slot - cnt, budget).long()]
        rows = pkt[src.long()]
        put = (slot >= cnt) & (slot < cnt + k)
        buf = torch.where(put[:, None], rows, buf)
        seg = torch.where(put, shard, seg)
        ov = ov + torch.clamp(cnt + k - budget, min=0)
        cnt = torch.clamp(cnt + k, max=budget)
        return buf, seg, cnt, ov

    z = torch.zeros((), dtype=_I32, device=dev)
    buf = packet.new_zeros((budget, packet.shape[1]))
    seg = torch.full((budget,), d, dtype=_I32, device=dev)
    pkt, cnt, ov = packet, z, z
    for hop in range(d - 1):
        buf, seg, cnt, ov = compact(pkt, (r - hop) % d, buf, seg, cnt, ov)
        pkt = _ring_hop(pkt, group, d, r)
    buf, seg, cnt, ov = compact(pkt, (r + 1) % d, buf, seg, cnt, ov)
    if d > 1:
        buf = buf[torch.sort(seg, stable=True).indices]
    return buf, cnt, ov


def _local_packet(cloud, view, proj, width: int, height: int, cam_pos,
                  ky: int, max_radius, d: int, r: int):
    """This rank's splats ``[r·N/d, (r+1)·N/d)`` (views of the cloud)
    projected by K1 into (N/d, 17) packets: the (12,) record, radius,
    depth (+inf where culled), valid and the two per-axis extents."""
    nd = cloud.num_splats // d
    part = slice(r * nd, (r + 1) * nd)
    local = dataclasses.replace(
        cloud, **{f.name: (None if getattr(cloud, f.name) is None
                           else getattr(cloud, f.name)[part])
                  for f in dataclasses.fields(cloud)})
    colors = local.colors
    if cam_pos is not None and local.sh_rest is not None:
        colors = eval_sh_colors(local, cam_pos)
    dev = cloud.means.device
    view = gs_ops._on(view, dev, "view").to(_F32)
    proj = gs_ops._on(proj, dev, "proj").to(_F32)
    ps = gs_ops._project_fast(local.means, local.scales, local.quats,
                              local.opacities, colors, view, proj, width,
                              height, ky=ky, max_radius=max_radius)
    finite = torch.isfinite(ps.depth)
    aux = torch.stack([ps.radius.to(_F32),
                       torch.where(finite, ps.depth, math.inf),
                       finite.to(_F32), ps.ext[:, 0].to(_F32),
                       ps.ext[:, 1].to(_F32)], -1)
    return torch.cat([gs_ops._make_records(ps), aux], -1)


def _check_split(n: int, d: int) -> None:
    if n % d:
        raise ValueError(f"splat count {n} not divisible by mesh size {d}")


def render_gaussians_sharded(cloud, view, proj, width: int, height: int,
                             mesh: DeviceMesh, background=(0.0, 0.0, 0.0),
                             cam_pos=None, ky: int | None = None,
                             max_splats_per_tile: int | None = None,
                             big_splat_cap: int | None = None,
                             mid_splat_cap: int | None = None,
                             mid_lo_splat_cap: int | None = None,
                             corner_cap: int | None = None,
                             lod_budget=None,
                             lod_tail: bool = False,
                             lod_tail_decim: int | None = None,
                             lod_tail_d: int | None = None,
                             return_stats: bool = False,
                             interpret: bool = False,
                             tile_w: int | None = None,
                             splat_exchange: str = "all_gather",
                             ring_budget: int | None = None,
                             exact_seg: int = 4,
                             lod_seg: int = 1):
    """Row-band-sharded ``GaussianCloud`` render → (height, width, 3) on
    every rank, with the keywords of ``ops.gs.render_gaussians`` (see
    there) and of the JAX ``render_gaussians_sharded``.

    Every rank passes the same full cloud. The padded tile rows are cut
    into D bands (the grid's rows padded to a multiple of D); rank r
    projects its N/D splats, gets every rank's records, keeps those whose
    vertical extent meets its band, shifts them into band coordinates and
    bins and composites its band. Two things differ from the
    single-device frame by design, as in the JAX package: each band grants
    its own LOD pool, and the ``lod_tail`` slab splits a splat's energy
    among its pairs within the band.

    ``splat_exchange``: ``"all_gather"`` (one all_gather of the (N, 17)
    packets; every rank holds all N) or ``"ring"`` (the N/D-row shards
    circulate D-1 hops and each rank compacts the splats that meet its
    band into ``ring_budget`` rows, default 2·N/D; splats past it are
    dropped whole and counted in ``overflow_big_splats``).

    ``lod_budget`` is the full-grid (ntiles,) or (ntiles, 2) budget of
    ``update_lod_budget`` (padded with zero rows to the banded grid); with
    ``return_stats`` the stats are full-grid too (``tile_exec``,
    ``tile_kept``, ``tile_count`` over the banded grid's
    ``nty_padded * ntx`` tiles), and ``lossless`` is the AND of the bands'
    certificates. ``interpret`` and ``lod_seg`` do not change the output;
    ``exact_seg`` rounds the exact-mode pair cap. Splats must be divisible
    by the mesh size."""
    if ky is None:
        ky = gs_ops.KY
    if tile_w is None:
        tile_w = gs_ops.TILE_W
    group, d, r = _axis(mesh)
    nty_total = _pad_to(_pad_to(height, gs_ops.TILE_H) // gs_ops.TILE_H, d)
    nty_local = nty_total // d
    band_px = nty_local * gs_ops.TILE_H
    ntx = _pad_to(width, tile_w) // tile_w
    n = cloud.num_splats
    _check_split(n, d)
    if splat_exchange not in ("all_gather", "ring"):
        raise ValueError(f"unknown splat_exchange {splat_exchange!r}")
    gs_ops._check_channels(max_splats_per_tile, big_splat_cap,
                           mid_splat_cap, mid_lo_splat_cap, lod_tail_decim)
    ring = splat_exchange == "ring"
    if ring:
        ring_budget = ring_budget or 2 * (n // d)
    # emission sees N gathered rows (all_gather) or ring_budget compacted
    # rows (ring) over the band's tiles; the cap only binds in exact mode
    cap_pairs = gs_ops._exact_pair_cap(
        ring_budget if ring else n, nty_local * ntx, ky, tile_w, corner_cap,
        big_splat_cap, mid_splat_cap, mid_lo_splat_cap)
    nseg = exact_seg if max_splats_per_tile is None else max(lod_seg, 1)
    cap_pairs = _pad_to(cap_pairs, gs_ops.CHUNK * nseg)
    max_radius = (float(gs_ops.level2_max_radius(tile_w))
                  if big_splat_cap is not None else None)
    tail_d = gs_ops._TAIL_D if lod_tail_d is None else lod_tail_d

    packet = _local_packet(cloud, view, proj, width, height, cam_pos, ky,
                           max_radius, d, r)
    dev = packet.device
    y0 = float(r * band_px)
    ov_ring = torch.zeros((), dtype=_I32, device=dev)
    if ring:
        def keep_band(pkt):
            my, ry = pkt[:, gs_ops._MY], pkt[:, _EXT + 1]
            return ((pkt[:, _VALID] > 0.5) & (my + ry > y0)
                    & (my - ry < y0 + band_px))
        packet, _, ov_ring = _ring_compact(packet, keep_band, ring_budget,
                                           group, d, r)
    else:
        packet = _gather(packet, group, d)
    records = packet[:, :gs_ops._ROWS].clone()
    rad, depth = packet[:, _RAD], packet[:, _DEPTH]
    valid = packet[:, _VALID] > 0.5
    ext = packet[:, _EXT:_EXT + 2]

    # this rank's row band: the splats whose vertical extent meets it, in
    # band coordinates
    my, ry = records[:, gs_ops._MY], ext[:, 1]
    in_band = (my + ry > y0) & (my - ry < y0 + band_px)
    records[:, gs_ops._MY] = my - y0

    tail_in = None
    if max_splats_per_tile is not None and lod_tail:
        # each splat's alpha integral from the gathered records (culled
        # splats carry opacity 0), as render_gaussians computes it
        detc = torch.clamp(records[:, gs_ops._CA] * records[:, gs_ops._CC]
                           - records[:, gs_ops._CB] * records[:, gs_ops._CB],
                           min=1e-12)
        a_full = (records[:, gs_ops._OP] * (2.0 * math.pi)
                  * torch.rsqrt(detc))
        tail_in = (a_full, records[:, gs_ops._CR:gs_ops._CB2 + 1])

    budget_local = None
    if max_splats_per_tile is not None and lod_budget is not None:
        budget = gs_ops._on(lod_budget, dev, "lod_budget").to(_I32)
        full = nty_total * ntx
        if budget.shape[0] < full:
            budget = torch.cat([budget, budget.new_zeros(
                (full - budget.shape[0], *budget.shape[1:]))])
        nl = nty_local * ntx
        budget_local = budget[r * nl:(r + 1) * nl]

    b = gs_ops._bin_splats(
        records[:, gs_ops._MX], records[:, gs_ops._MY], rad, valid & in_band,
        depth, ntx, nty_local, cap_pairs, ky=ky,
        max_per_tile=max_splats_per_tile, budget=budget_local,
        tile_w=tile_w, nseg=nseg, ext=ext, big_cap=big_splat_cap,
        mid_cap=mid_splat_cap, mid_lo_cap=mid_lo_splat_cap,
        corner_cap=corner_cap,
        tail_decim=(lod_tail_decim if max_splats_per_tile is not None
                    else None), tail=tail_in)
    planes, texec = gs_ops._composite_call(
        gs_ops._pack_records(records, b.pack_idx), b.row_begin, b.row_end,
        ntx, nty_local, tile_w)
    tail_planes = None
    if b.pack_idx_tl is not None:
        td = gs_ops._tail_entry(planes[3], b.visited, tile_w, tail_d)
        planes_tl, _ = gs_ops._composite_tail_call(
            gs_ops._pack_records(records, b.pack_idx_tl), b.row_begin_tl,
            b.row_end_tl, td, ntx, nty_local, tile_w, tail_d)
        tail_planes = (planes_tl, td, b.kept_tl > 0)
    band = gs_ops.finalize_planes(planes, b.visited, nty_local, ntx,
                                  background, tile_w, tail_planes, tail_d,
                                  b.tail_slab)      # (band_px, Wp, 3)
    img = _gather(band, group, d)[:height, :width]
    if not return_stats:
        return img

    tile_exec = torch.where(b.visited, texec, 0)
    ovb = b.overflow_big + ov_ring
    if max_splats_per_tile is not None:
        dry = (b.kept < b.count) & (tile_exec >= b.kept) & (b.count > 0)
        cert = (~torch.any(dry)) & (ovb == 0)
    else:
        cert = (b.overflow == 0) & (ovb == 0)
    # per-band scalars and tile stats, one gather each
    scal = _gather(torch.stack([b.overflow.to(_I32), ovb.to(_I32),
                                cert.to(_I32)])[None], group, d)   # (d, 3)
    tiles = _gather(torch.stack([tile_exec.to(_I32), b.kept.to(_I32),
                                 b.count.to(_I32)], -1), group, d)
    return img, {"overflow_pairs": scal[:, 0].sum(dtype=_I32),
                 "overflow_big_splats": scal[:, 1].sum(dtype=_I32),
                 "lossless": torch.all(scal[:, 2] > 0),
                 "tile_exec": tiles[:, 0].contiguous(),
                 "tile_kept": tiles[:, 1].contiguous(),
                 "tile_count": tiles[:, 2].contiguous()}


def render_gaussians_depth_sliced(cloud, view, proj, width: int,
                                  height: int, mesh: DeviceMesh,
                                  background=(0.0, 0.0, 0.0),
                                  cam_pos=None, ky: int | None = None,
                                  tile_w: int | None = None,
                                  slice_budget: int | None = None,
                                  big_splat_cap: int | None = None,
                                  return_stats: bool = False,
                                  interpret: bool = False):
    """Sort-last render → (height, width, 3) on every rank: each rank owns
    a depth slice of the splats and composites the full frame over it.

    Alpha compositing over depth-disjoint splat sets is associative,
    ``(C_a, T_a) (+) (C_b, T_b) = (C_a + T_a·C_b, T_a·T_b)``. The slices
    are quantiles of one all-reduced 256-bin histogram of the valid
    depths over their global range (whole bins map to one rank by their
    cumulative start fraction, so the slices are depth-disjoint). Records
    reach their slice's owner over the ring with per-hop compaction into
    ``slice_budget`` rows (default 2·N/D; drops counted in
    ``overflow_big_splats``). Each rank composites its slice in exact mode
    into background-free planes, and the gathered planes fold front to
    back from rank 0; the background is blended last. ``interpret`` does
    not change the output.

    Unlike the JAX function, each slice quantises its depth keys over the
    frame's depth range (the all-reduced one), not its own, and gets its
    records in the frame's splat order (:func:`_ring_compact`): a pair
    tied with another in the frame's 22-bit keys then composites in the
    single-device frame's order. With each slice's own range and the
    ring's order, 0.24% of the pixels of a 1M-splat fog frame at D = 4
    were off the single-device frame by more than 1e-4 (max 3.4e-2)."""
    if ky is None:
        ky = gs_ops.KY
    if tile_w is None:
        tile_w = gs_ops.TILE_W
    group, d, r = _axis(mesh)
    nty = _pad_to(height, gs_ops.TILE_H) // gs_ops.TILE_H
    ntx = _pad_to(width, tile_w) // tile_w
    n = cloud.num_splats
    _check_split(n, d)
    budget = slice_budget or 2 * (n // d)
    cap_pairs = _pad_to(gs_ops._exact_pair_cap(
        budget, nty * ntx, ky, tile_w, None, big_splat_cap or None, None,
        None), gs_ops.CHUNK)
    max_radius = (float(gs_ops.level2_max_radius(tile_w))
                  if big_splat_cap is not None else None)
    nbins = 256

    packet = _local_packet(cloud, view, proj, width, height, cam_pos, ky,
                           max_radius, d, r)
    dev = packet.device

    # global depth range (one MAX all_reduce) and a SUM-reduced histogram
    dpth, vmask = packet[:, _DEPTH], packet[:, _VALID] > 0.5
    big = 3.4e38
    ext = torch.stack([torch.where(vmask, -dpth, -big).max(),
                       torch.where(vmask, dpth, -big).max()])
    dist.all_reduce(ext, op=dist.ReduceOp.MAX, group=group)
    dmin, dmax = -ext[0], ext[1]
    span = torch.clamp(dmax - dmin, min=1e-9)

    def bin_of(dp):
        return torch.clamp(((dp - dmin) / span * nbins).to(_I32), 0,
                           nbins - 1)

    hist = torch.zeros(nbins, dtype=_F32, device=dev).index_add_(
        0, bin_of(dpth), vmask.to(_F32))
    dist.all_reduce(hist, op=dist.ReduceOp.SUM, group=group)
    ce = torch.cat([hist.new_zeros(1), torch.cumsum(hist, 0)])  # exclusive
    total = torch.clamp(ce[-1], min=1.0)
    bin_dev = torch.clamp((ce[:-1] * d / total).to(_I32), max=d - 1)

    def mine(pkt):
        ok = pkt[:, _VALID] > 0.5
        return torch.where(ok, bin_dev[bin_of(pkt[:, _DEPTH]).long()],
                           -1) == r

    sl, _, ov_ring = _ring_compact(packet, mine, budget, group, d, r)

    # this slice's full-frame exact composite, background-free planes
    records = sl[:, :gs_ops._ROWS]
    # the depth keys over the frame's range, not the slice's: every pair
    # gets the single-device frame's key, so tied keys keep its order
    b = gs_ops._bin_splats(records[:, gs_ops._MX], records[:, gs_ops._MY],
                           sl[:, _RAD], sl[:, _VALID] > 0.5, sl[:, _DEPTH],
                           ntx, nty, cap_pairs, ky=ky, tile_w=tile_w,
                           big_cap=big_splat_cap, ext=sl[:, _EXT:_EXT + 2],
                           depth_range=(dmin, dmax))
    planes, _ = gs_ops._composite_call(
        gs_ops._pack_records(records, b.pack_idx), b.row_begin, b.row_end,
        ntx, nty, tile_w)
    vis = b.visited[:, None]
    cpl = torch.stack([gs_ops._untile(torch.where(vis, planes[k], fill), nty,
                                      ntx, tile_w)
                       for k, fill in ((0, 0.0), (1, 0.0), (2, 0.0),
                                       (3, 1.0))], -1)   # (Hp, Wp, 4)

    # sort-last combine: the slices fold front to back
    hp = cpl.shape[0]
    cs = _gather(cpl, group, d).reshape(d, hp, *cpl.shape[1:])
    c = torch.zeros_like(cpl[..., :3])
    t = torch.ones_like(cpl[..., 3])
    for i in range(d):
        c = c + t[..., None] * cs[i, ..., :3]
        t = t * cs[i, ..., 3]
    bg = (background.to(dev, _F32) if isinstance(background, torch.Tensor)
          else on_device(background, dev))
    img = (c + t[..., None] * bg)[:height, :width]
    if not return_stats:
        return img
    ov = _gather(torch.stack([b.overflow.to(_I32),
                              (b.overflow_big + ov_ring).to(_I32)])[None],
                 group, d).sum(0, dtype=_I32)
    return img, {"overflow_pairs": ov[0], "overflow_big_splats": ov[1],
                 "lossless": (ov[0] == 0) & (ov[1] == 0)}


def render_mesh_sharded(pipe, geo, uniforms, resources, width: int,
                        height: int, mesh: DeviceMesh,
                        clear_color=(0.0, 0.0, 0.0, 1.0),
                        clear_depth: float = 1.0, interpret: bool = False,
                        shade_fetch: bool = True):
    """Row-band-sharded triangle raster: geometry and uniforms replicated,
    each rank rasters and shades its band of rows of a cleared
    framebuffer. Returns (colour (height, width, 4), depth (height,
    width)) on every rank.

    The bands are ``pad_to(height, 8·D) / D`` rows. Each rank runs the
    vertex stage and the triangle setup in frame coordinates, then moves
    the setup into its band: the plane constants by ``c += b·y0`` and the
    bbox rows YMIN/YMAX by ``-y0``, so that the binned path
    (``n_tris > 512``: K7, K8) bins in band coordinates. (The JAX
    reference moves only the plane constants, so its binned bands below
    the first bin by frame rows.) The raster and shade are
    ``render_mesh``'s (the depth modes of ``ops.raster._depth_modes``).
    ``shade_fetch=False`` fetches the winners' features by a per-pixel
    row gather instead of K8; the output is the same. ``interpret`` is
    accepted for signature parity and ignored."""
    group, d, r = _axis(mesh)
    hp = _pad_to(height, 8 * d)
    band_px = hp // d
    wp = _pad_to(width, raster_ops.TILE_W)
    dev = geo.positions.device
    y0 = float(r * band_px)
    fb = Framebuffer(
        color=on_device(clear_color, dev).expand(band_px, wp, 4).contiguous(),
        depth=torch.full((band_px, wp), clear_depth, dtype=_F32, device=dev),
        width=width, height=height)
    ds = raster_ops._vertex_stage(pipe, geo, uniforms, fb)
    # λ(px, py_frame) = a·px + b·(py_band + y0) + c  →  c += b·y0
    s = ds.setup.clone()
    for b_row, c_row in ((raster_ops._B0, raster_ops._C0),
                         (raster_ops._B1, raster_ops._C1),
                         (raster_ops._BZ, raster_ops._CZ)):
        s[c_row] = s[c_row] + s[b_row] * y0
    s[raster_ops._YMIN] = s[raster_ops._YMIN] - y0
    s[raster_ops._YMAX] = s[raster_ops._YMAX] - y0
    # rows past the frame's height exist only in the last band and are
    # cropped after the gather, so the band's scissor is its own height
    fb = dataclasses.replace(fb, height=band_px)
    (gdepth, gtri, gl0, gl1, feats), zt = raster_ops._raster_draw(
        pipe, ds._replace(setup=s), fb, shade_fetch=shade_fetch)
    out = raster_ops._shade(pipe, fb, gdepth, gtri, gl0, gl1, ds.tri_vary,
                            ds.inv_w, resources, z_tri=zt, feats=feats)
    both = _gather(torch.cat([out.color, out.depth[..., None]], -1), group,
                   d)
    return (both[:height, :width, :4].contiguous(),
            both[:height, :width, 4].contiguous())
