"""The cases of ``tests/test_torch_parallel.py``, run on every rank of one
spawned gloo group (each rank one process on one thread). Rank 0 writes
its outputs to an ``.npz`` file; the tests read it. Imports no JAX: the
ranks run the port alone.

Every render runs under :class:`NoHostSync`, the CPU stand-in for the
capture rule (a frame makes no host sync): it raises on ``.item()``,
``bool``/``int``/``float`` of a tensor, ``.tolist()``, ``nonzero`` and
boolean-mask indexing in the port's own code (the kernels' plain
versions run inside their ops and are not seen).
"""

from __future__ import annotations

import os
import sys
import traceback

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

W, H = 256, 128
D = 4
#: the flagship LOD config of ``tests/test_parallel.py:56-57``
FLAGSHIP = dict(max_splats_per_tile=128, big_splat_cap=128, lod_tail=True,
                tile_w=32)
#: the mid-fan certified config of ``tests/test_parallel.py:217-218``
CAPS = dict(big_splat_cap=256, mid_splat_cap=1024, mid_lo_splat_cap=1024,
            corner_cap=512, tile_w=32)
#: the binned raster case: a 17 x 17 quad grid, 578 triangles (1,156
#: clipped slots, past the 512 of the binned path)
GRID = dict(g=17, seed=9, extent=0.9, zscale=0.1)
#: make_train_step_dp at ``tests/test_gs_training.py``'s sizes
TRAIN_W, TRAIN_H = 128, 64
#: gs_trainer --dp at a small size
TRAINER_ARGS = ["--splats", "24", "--steps", "3", "--width", "64",
                "--height", "32", "--lr", "1e-3", "--device", "cpu"]

_SYNC = {"item", "__bool__", "__int__", "__float__", "__index__", "tolist",
         "nonzero", "numpy"}


class HostSync(RuntimeError):
    pass


class NoHostSync(TorchFunctionMode):
    """Raise on the ops that would synchronise a CUDA stream with the
    host."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in _SYNC:
            raise HostSync(f"host sync: {name}")
        if name == "__getitem__" and len(args) > 1:
            idx = args[1] if isinstance(args[1], tuple) else (args[1],)
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool
                   for i in idx):
                raise HostSync("host sync: boolean-mask indexing")
        return func(*args, **(kwargs or {}))


def camera():
    """``tests/test_parallel.py``'s camera at 256x128."""
    from ray_eater_tpu_torch import rmath
    view = rmath.look_at_zforward(rmath.vec(0.0, 0.6, -2.5, device="cpu"),
                                  rmath.vec(0.0, 0.0, 0.0, device="cpu"))
    proj = rmath.perspective(rmath.radians(60.0, device="cpu"), W / H, 0.1,
                             30.0, device="cpu")
    return view, proj


def clouds() -> dict:
    """The clouds of ``tests/test_parallel.py`` (``random_cloud`` is
    bit-identical to JAX's)."""
    from ray_eater_tpu_torch.models.gaussians import random_cloud
    return {"c512": random_cloud(512, seed=11, extent=0.8,
                                 scale_range=(0.02, 0.06), device="cpu"),
            "c1024": random_cloud(1024, seed=7, extent=0.8,
                                  scale_range=(0.02, 0.06), device="cpu"),
            "wide": random_cloud(1024, seed=5, extent=0.7,
                                 scale_range=(0.02, 0.28), device="cpu"),
            "big": random_cloud(256, seed=3, extent=0.6,
                                scale_range=(0.05, 0.35), device="cpu"),
            "c513": random_cloud(513, seed=1, device="cpu")}


def tied_cloud():
    """``c512`` with splat 300 (shard 2 of 4) made a copy of splat 10
    (shard 0) in another colour: two splats of one depth key over the
    same pixels in band 2 (rows 64-95), where the ring hands a rank the
    shards in the order 2, 1, 0, 3. One device composites splat 10 first
    (ties break by splat order); so must every exchange."""
    from ray_eater_tpu_torch.models.gaussians import GaussianCloud
    c = clouds()["c512"]
    f = {k: getattr(c, k).clone() for k in ("means", "scales", "quats",
                                            "opacities", "colors")}
    for k in ("means", "scales", "quats", "opacities"):
        f[k][300] = f[k][10]
    f["colors"][10] = torch.tensor([1.0, 0.0, 0.0])
    f["colors"][300] = torch.tensor([0.0, 0.0, 1.0])
    f["opacities"][10] = f["opacities"][300] = 0.9
    return GaussianCloud(**f)


def tied_splat_row() -> float:
    """The projected screen row of ``tied_cloud``'s splat 10."""
    from ray_eater_tpu_torch.ops import gs
    c = tied_cloud()
    view, proj = camera()
    ps = gs.project_gaussians(c.means, c.scales, c.quats, c.opacities,
                              c.colors, view, proj, W, H)
    return float(ps.mean2d[10, 1])


def mesh_pipeline(double_sided: bool = False):
    """Vertex colours, opaque: the sharded raster cases' pipeline (the
    default raster state, or no culling for the double-sided grid)."""
    from ray_eater_tpu_torch.core import shaders
    from ray_eater_tpu_torch.core.pipeline import (CullMode,
                                                   GraphicsPipeline,
                                                   RasterState)

    def frag(v, r):
        c = v["color"]
        return torch.cat([c, torch.ones((*c.shape[:-1], 1))], -1)
    state = (RasterState(cull_mode=CullMode.NONE) if double_sided
             else RasterState())
    return GraphicsPipeline(vertex_fn=shaders.mvp_vertex, fragment_fn=frag,
                            state=state)


def mesh_uniforms(w=W, h=H):
    """``tests/test_parallel.py:160-165``'s uniforms."""
    from ray_eater_tpu_torch import rmath
    return {"model": rmath.rotate_y(rmath.identity("cpu"), 0.4),
            "view": rmath.look_at(rmath.vec(2., 2., 2., device="cpu"),
                                  rmath.vec(0., 0., 0., device="cpu")),
            "projection": rmath.perspective(
                rmath.radians(45.0, device="cpu"), w / h, 0.1, 30.0,
                device="cpu")}


def grid_mesh():
    from ray_eater_tpu_torch.raster_scenes import grid_mesh as gm
    return gm(GRID["g"], GRID["seed"], GRID["extent"], GRID["zscale"],
              device="cpu")


def train_problem():
    """``tests/test_gs_training.py:20-28, 176-181``'s problem: (view, proj, the
    init cloud, the target)."""
    from ray_eater_tpu_torch import rmath
    from ray_eater_tpu_torch.models.gaussians import random_cloud
    from ray_eater_tpu_torch.models.gs_training import (params_from_cloud,
                                                        render_diff)
    view = rmath.look_at_zforward(rmath.vec(0.0, 0.0, -3.0, device="cpu"),
                                  rmath.vec(0.0, 0.0, 0.0, device="cpu"))
    proj = rmath.perspective(rmath.radians(60.0, device="cpu"),
                             TRAIN_W / TRAIN_H, 0.1, 30.0, device="cpu")
    kw = dict(extent=0.5, scale_range=(0.05, 0.1), device="cpu")
    with torch.no_grad():
        target = render_diff(params_from_cloud(random_cloud(24, seed=6, **kw)),
                             view, proj, TRAIN_W, TRAIN_H)
    return view, proj, random_cloud(24, seed=5, **kw), target


def _stats(out: dict, key: str, st: dict) -> None:
    for k, v in st.items():
        out[f"{key}.{k}"] = v


def run_cases(rank: int, out_dir: str) -> dict:
    """Every case on this rank; returns the outputs (numpy arrays)."""
    from ray_eater_tpu_torch import gs_trainer
    from ray_eater_tpu_torch.models import gs_training as tr
    from ray_eater_tpu_torch.models.mesh import two_planes
    from ray_eater_tpu_torch.ops import gs
    from ray_eater_tpu_torch.parallel import sharded as sh
    from torch.distributed.device_mesh import DeviceMesh

    mesh = sh.make_device_mesh(D, device="cpu")
    view, proj = camera()
    cl = clouds()
    out = {}
    g = NoHostSync()

    # all_gather, exact; the ring against it; the starved ring
    with g:
        out["ag_exact"] = sh.render_gaussians_sharded(
            cl["c512"], view, proj, W, H, mesh, (0.1, 0.1, 0.1))
        img, st = sh.render_gaussians_sharded(
            cl["c512"], view, proj, W, H, mesh, (0.1, 0.1, 0.1),
            splat_exchange="ring", ring_budget=512, return_stats=True)
        out["ring"] = img
        _stats(out, "ring", st)
        _, st = sh.render_gaussians_sharded(
            cl["c512"], view, proj, W, H, mesh, (0.1, 0.1, 0.1),
            splat_exchange="ring", ring_budget=16, return_stats=True)
        _stats(out, "ring16", st)

        # the flagship LOD config, then its temporal budget round trip
        img, st = sh.render_gaussians_sharded(cl["c1024"], view, proj, W, H,
                                              mesh, return_stats=True,
                                              **FLAGSHIP)
        out["flagship"] = img
        _stats(out, "flagship", st)
        ntx, nty = gs.num_tiles(W, H, tile_w=32)
        nty = -(-nty // D) * D
        budget = gs.update_lod_budget(st["tile_exec"], 128, ntx, nty,
                                      st["tile_kept"], st["tile_count"])
        out["flagship_budget"] = budget
        out["flagship2"] = sh.render_gaussians_sharded(
            cl["c1024"], view, proj, W, H, mesh, lod_budget=budget,
            **FLAGSHIP)

        # mid fan, certified exact and LOD with its budget round trip
        img, st = sh.render_gaussians_sharded(cl["wide"], view, proj, W, H,
                                              mesh, return_stats=True,
                                              **CAPS)
        out["mid_exact"] = img
        _stats(out, "mid_exact", st)
        img, st = sh.render_gaussians_sharded(
            cl["wide"], view, proj, W, H, mesh, return_stats=True,
            max_splats_per_tile=128, **CAPS)
        out["mid_lod"] = img
        budget = gs.update_lod_budget(st["tile_exec"], 128, ntx, nty,
                                      st["tile_kept"], st["tile_count"])
        out["mid_lod2"] = sh.render_gaussians_sharded(
            cl["wide"], view, proj, W, H, mesh, lod_budget=budget,
            max_splats_per_tile=128, **CAPS)
        for td in (2, 4):
            img, st = sh.render_gaussians_sharded(
                cl["wide"], view, proj, W, H, mesh, return_stats=True,
                max_splats_per_tile=64, lod_tail_decim=128, lod_tail_d=td,
                **CAPS)
            out[f"tail{td}"] = img
            _stats(out, f"tail{td}", st)

        # sort-last
        img, st = sh.render_gaussians_depth_sliced(
            cl["c512"], view, proj, W, H, mesh, (0.1, 0.2, 0.3),
            slice_budget=512, return_stats=True)
        out["sliced"] = img
        _stats(out, "sliced", st)
        _, st = sh.render_gaussians_depth_sliced(
            cl["c512"], view, proj, W, H, mesh, (0.1, 0.2, 0.3),
            slice_budget=16, return_stats=True)
        _stats(out, "sliced16", st)
        tied = tied_cloud()
        out["tied_ring"] = sh.render_gaussians_sharded(
            tied, view, proj, W, H, mesh, splat_exchange="ring",
            ring_budget=512)
        out["tied_sliced"] = sh.render_gaussians_depth_sliced(
            tied, view, proj, W, H, mesh, slice_budget=512)
        out["sliced_big"] = sh.render_gaussians_depth_sliced(
            cl["big"], view, proj, W, H, mesh, (0, 0, 0), big_splat_cap=256,
            slice_budget=256)

        # raster: the dense two planes, the binned grid (K8 and its
        # per-pixel gather)
        uni = mesh_uniforms()
        for key, geo, pipe in (
                ("planes", two_planes(device="cpu"), mesh_pipeline()),
                ("grid", grid_mesh(), mesh_pipeline(double_sided=True))):
            c, dpt = sh.render_mesh_sharded(pipe, geo, uni, {}, W, H, mesh)
            out[f"{key}.color"], out[f"{key}.depth"] = c, dpt
        c, dpt = sh.render_mesh_sharded(pipe, grid_mesh(), uni, {}, W, H,
                                        mesh, shade_fetch=False)
        out["grid_gather.color"] = c
        out["grid_gather.depth"] = dpt

    # 513 splats: the split is refused
    try:
        sh.render_gaussians_sharded(cl["c513"], view, proj, W, H, mesh)
        out["reject"] = np.array("")
    except ValueError as e:
        out["reject"] = np.array(str(e))

    # D = 2 (a one-hop ring): ranks {0, 1} and {2, 3} as two 1-D meshes
    pairs = DeviceMesh("cpu", torch.arange(D).reshape(2, D // 2),
                       mesh_dim_names=("pair", "d"))["d"]
    with g:
        img, st = sh.render_gaussians_sharded(
            cl["c512"], view, proj, W, H, pairs, (0.1, 0.1, 0.1),
            splat_exchange="ring", return_stats=True)
        out["d2_ring"] = img
        _stats(out, "d2_ring", st)
        out["d2_sliced"] = sh.render_gaussians_depth_sliced(
            cl["c512"], view, proj, W, H, pairs, (0.1, 0.2, 0.3))

    # data-parallel training: one make_train_step_dp step, then the
    # gs_trainer entry point with --dp
    tview, tproj, init, target = train_problem()
    params = tr.params_from_cloud(init)
    step = tr.make_train_step_dp(tr.adam(params, 1e-3), tview, tproj, mesh)
    out["dp.loss"] = step(params, target)
    out["dp.means"] = params.means
    r = gs_trainer.train(gs_trainer.parse_args(["--dp", *TRAINER_ARGS]))
    out["trainer_dp.losses"] = np.array(r["losses"])
    gs_trainer.main(["--dp", *TRAINER_ARGS, "--out",
                     os.path.join(out_dir, f"trainer_rank{rank}")])
    return {k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
            for k, v in out.items()}


def worker(rank: int, rdzv: str, out_dir: str) -> None:
    """One rank: join the gloo group through ``rdzv`` (a ``file://``
    init method), run the cases, and write rank 0's outputs (or any rank's
    traceback) to ``out_dir``."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    from ray_eater_tpu_torch.parallel import make_device_mesh
    try:
        make_device_mesh(D, device="cpu", init_method=rdzv, rank=rank)
        out = run_cases(rank, out_dir)
        if rank == 0:
            np.savez(os.path.join(out_dir, "rank0.npz"), **out)
    except BaseException:
        with open(os.path.join(out_dir, f"error{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
