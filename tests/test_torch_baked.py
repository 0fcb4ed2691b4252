"""The kernels as ``torch.library`` custom ops, and baked frame programs
(``FrameProgram.save_baked`` / ``graph.render_graph.load_baked``).

- Every op a tiny frame of each main path calls (K1-K3 on an LOD frame with
  the decimated tail, K4/K5 on a training step, K6 on multipass, K7-K9 on
  the binned grid, K10 on compute_drawing, the SH colour kernel on a
  degree-3 cloud) passes ``torch.library.opcheck``'s
  schema and fake-tensor checks on its CPU inputs: the fake implementation
  gives the plain version's shapes and dtypes.
- JAX's ``test_baked_frame_serialization`` case; a tiny fog frame (two
  frames, the LOD budget carried) and the two-pass multipass
  ``RenderGraph`` frame, baked, saved, loaded and bit-equal to the unbaked
  program; missing slots rejected.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_eater_tpu_torch import compute_drawing, gs_viewer, multipass
from ray_eater_tpu_torch import raster_scenes as rs
from ray_eater_tpu_torch.bench_knobs import flythrough_camera
from ray_eater_tpu_torch.graph import render_graph as tgraph
from ray_eater_tpu_torch.models.gaussians import eval_sh_colors, random_cloud
from ray_eater_tpu_torch.ops import gs

torch.set_num_threads(1)

W, H, TW, MPT = 128, 64, 32, 64


class _Calls(TorchDispatchMode):
    """Records the first call of each ``rayeater::`` op."""

    def __init__(self):
        super().__init__()
        self.calls = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "rayeater":
            self.calls.setdefault(func, (args, kwargs or {}))
        return func(*args, **(kwargs or {}))


def _cloud(n=400, device="cpu"):
    return random_cloud(n, seed=2, extent=1.0, scale_range=(0.004, 0.02),
                        device=device)


def _main_path_calls():
    cloud = _cloud()
    view, proj = flythrough_camera(0.3, W, H, device="cpu")
    with _Calls() as rec:
        gs.render_gaussians(cloud, view, proj, W, H, tile_w=TW,
                            max_splats_per_tile=MPT, lod_tail_decim=MPT)
        params = [p.clone().requires_grad_(True) for p in
                  (cloud.means, cloud.scales, cloud.quats, cloud.opacities,
                   cloud.colors)]
        gs.render_gaussians_diff(*params, view, proj, W, H,
                                 tile_w=TW).sum().backward()
        multipass.frame_graph(rs.scene("multipass", "cpu", W, H))(
            t=torch.tensor(0.5))
        rs.scene("grid10k", "cpu", W, H).frame(0.5)
        compute_drawing.setup("cpu", width=W, height=H, particles=64)
        eval_sh_colors(gs_viewer.synthetic_cloud(64, 15, "cpu"),
                       torch.tensor([2.0, 0.8, 1.0]))
    return rec.calls


def test_kernel_ops_fake_matches_plain():
    calls = _main_path_calls()
    names = sorted(f.__name__.split(".")[0] for f in calls)
    assert names == sorted(gs._cuda.launches), names
    for func, (args, kwargs) in calls.items():
        res = torch.library.opcheck(func, args, kwargs, test_utils=(
            "test_schema", "test_faketensor"))
        assert set(res.values()) == {"SUCCESS"}, (func, res)


def test_baked_frame_serialization(tmp_path):
    """JAX's case (tests/test_graph.py)."""
    prog = (tgraph.RenderGraph("ser").external("x")
            .add_pass("p", lambda i: {"y": i["x"] * 3.0}, reads=("x",),
                      writes=("y",)).output("y").bake())
    path = str(tmp_path / "frame.bin")
    prog.save_baked(path, x=torch.zeros(8))
    loaded = tgraph.load_baked(path)
    out = loaded(x=torch.full((8,), 2.0))
    assert float(out["y"][0]) == 6.0


def fog_program(cloud, width, height, tile_w, mpt):
    """The temporal-LOD fog frame as a one-pass graph: externals ``t`` and
    ``budget``, outputs ``image`` and the next ``budget``."""
    ntx, nty = gs.num_tiles(width, height, tile_w)

    def render(i):
        view, proj = flythrough_camera(i["t"], width, height,
                                       device=cloud.means.device)
        img, st = gs.render_gaussians(
            cloud, view, proj, width, height, tile_w=tile_w,
            max_splats_per_tile=mpt, lod_budget=i["budget"],
            return_stats=True)
        return {"image": img, "budget": gs.update_lod_budget(
            st["tile_exec"], mpt, ntx, nty, st["tile_kept"],
            st["tile_count"])}

    return (tgraph.RenderGraph("fog").external("t", "budget")
            .add_pass("render", render, reads=("t", "budget"),
                      writes=("image", "budget"))
            .output("image", "budget").bake())


def test_baked_fog_frame_is_bit_equal(tmp_path):
    prog = fog_program(_cloud(), W, H, TW, MPT)
    b0 = gs.initial_lod_budget(W, H, TW, MPT, "cpu")
    path = str(tmp_path / "fog.pt2")
    prog.save_baked(path, t=torch.tensor(0.0), budget=b0)
    loaded = tgraph.load_baked(path)
    want_b = got_b = b0
    for t in (0.2, 0.6):
        want = prog(t=torch.tensor(t), budget=want_b)
        got = loaded(t=torch.tensor(t), budget=got_b)
        assert set(got) == {"image", "budget"}
        assert torch.equal(got["image"], want["image"])
        assert torch.equal(got["budget"], want["budget"])
        want_b, got_b = want["budget"], got["budget"]
    assert not torch.equal(want_b, b0)      # the budget moved


def test_baked_multipass_graph_is_bit_equal(tmp_path):
    """The two-pass frame (depth prepass, LESS_EQUAL lit pass) with its
    texture and mesh closed over; the Framebuffer output is rebuilt."""
    prog = multipass.frame_graph(rs.scene("multipass", "cpu", W, H))
    path = str(tmp_path / "mp.pt2")
    prog.save_baked(path, t=torch.tensor(0.0))
    loaded = tgraph.load_baked(path)
    for t in (0.0, 0.5):
        want = prog(t=torch.tensor(t))["fb"]
        got = loaded(t=torch.tensor(t))["fb"]
        assert type(got) is type(want)
        assert (got.width, got.height) == (want.width, want.height)
        assert torch.equal(got.color, want.color)
        assert torch.equal(got.depth, want.depth)
    assert float(want.color[..., :3].max()) > 0.0


def test_baked_missing_slots_rejected(tmp_path):
    prog = (tgraph.RenderGraph("two").external("x", "y")
            .add_pass("p", lambda i: {"z": i["x"] + i["y"]},
                      reads=("x", "y"), writes=("z",)).output("z").bake())
    path = str(tmp_path / "two.pt2")
    with pytest.raises(tgraph.GraphValidationError, match="missing"):
        prog.save_baked(path, x=torch.zeros(3))
    with pytest.raises(tgraph.GraphValidationError, match="tensors"):
        prog.save_baked(path, x=torch.zeros(3), y=np.zeros(3))
    prog.save_baked(path, x=torch.zeros(3), y=torch.zeros(3))
    loaded = tgraph.load_baked(path)
    with pytest.raises(tgraph.GraphValidationError, match="missing"):
        loaded(x=torch.zeros(3))
    assert torch.equal(loaded(x=torch.ones(3), y=torch.ones(3))["z"],
                       torch.full((3,), 2.0))
