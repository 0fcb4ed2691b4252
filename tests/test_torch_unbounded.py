"""The port's LOD frame of the ``unbounded-6m`` configuration (the
benchmark's Mip-NeRF 360-scale scene, camera inside it, trained-scene
knobs) against the benchmark's plain reference, and the frame counters of
``utils.profiler`` against ``render_gaussians``' own stats.

The scene is drawn at 20,000 splats with the side channels' budgets scaled
with the splat count (as ``benchmark/tests/conftest.py`` ``shrink`` scales
them) and rendered at 256x144. Tolerances are those of
``benchmark/tests/test_benchport_reference.py``: u8 frames within 1 code
(float32 sums in another order), the binning's integers equal.

The benchmark's folder is put on the import path as its tests' conftest
puts it; nothing here imports JAX.
"""

import copy
import sys
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parent.parent / "benchmark"
for _p in (str(BENCH.parent), str(BENCH)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import scene, spec  # noqa: E402
from harness.program import LOD_KEYS  # noqa: E402
from reference import render as ref  # noqa: E402
from reference.camera import orbit_view  # noqa: E402

from ray_eater_tpu_torch.core import animation  # noqa: E402
from ray_eater_tpu_torch.core.animation import encode_frame  # noqa: E402
from ray_eater_tpu_torch.models.gaussians import GaussianCloud  # noqa: E402
from ray_eater_tpu_torch.ops import gs  # noqa: E402
from ray_eater_tpu_torch.utils import profiler  # noqa: E402

CELL = "unbounded-6m.flythrough"
N, W, H = 20_000, 256, 144
SEED = 2**31 + 1818
CAPS = ("big_splat_cap", "mid_splat_cap", "mid_lo_splat_cap", "corner_cap")
#: azimuths of the checked frames; at 2.1 floaters lie behind and beside
#: the eye (asserted in the test)
AZIMUTHS = (0.0, 2.1, 4.4)


def _config(cap_div: int = 1, tail: int | None = None) -> dict:
    """The configuration at ``N`` splats, the side channels' budgets scaled
    with the count (and divided by ``cap_div``), ``tail`` tail pairs a
    tile where given."""
    cfg = copy.deepcopy(spec.load_cell(CELL).config)
    n0 = cfg["scene_params"]["num_splats"]
    cfg["scene_params"]["num_splats"] = N
    for k in CAPS:
        cfg["knobs"][k] = max(1, cfg["knobs"][k] * N // n0 // cap_div)
    if tail is not None:
        cfg["knobs"]["lod_tail_decim"] = tail
    return cfg


@pytest.fixture(scope="module")
def cloud():
    with torch.random.fork_rng():
        return scene.make_cloud(_config(), SEED, torch.device("cpu"))


@pytest.fixture(scope="module")
def camera():
    return spec.load_cell(CELL).traffic["camera"]


def _port(cloud, cfg, camera, az):
    view, proj, eye = orbit_view(torch.tensor(az), camera, W, H)
    kw = {k: cfg["knobs"][k] for k in LOD_KEYS}
    img, st = gs.render_gaussians(GaussianCloud(**cloud), view, proj, W, H,
                                  cam_pos=eye, return_stats=True, **kw)
    return encode_frame(img), st


def _reference(cloud, cfg, camera, az):
    """The reference's frame, its valid splats and its binning's dropped
    pairs and side-channel drops (each channel's members past its budget,
    the masks of ``reference.render.bin_splats``)."""
    view, proj, eye = orbit_view(torch.tensor(az), camera, W, H)
    knobs = cfg["knobs"]
    fr = ref.render(cloud, view, proj, W, H, knobs, True, None,
                    torch.float32, eye)
    tw = knobs["tile_w"]
    planes = ref.project(cloud, view, proj, W, H,
                         float(ref.level2_max_radius(tw)))
    valid = torch.isfinite(planes[5])
    mx, my, rx, ry = planes[0], planes[1], planes[7], planes[8]

    def fits(ky):
        lx, ly = ref.fan_limits(ref.fan_kx(ky, tw) if ky > ref.KY
                                else ref.KX, ky, tw)
        return (rx <= lx) & (ry <= ly)
    small = valid & fits(ref.KY)
    tx0, tx1, ty0, ty1 = ref.tile_span(mx, my, rx, ry,
                                       *ref.num_tiles(W, H, tw), tw)
    over1 = valid & ~small
    lo = over1 & fits(ref.KY_ML)
    mid = over1 & ~lo & fits(ref.KY_M)
    channels = [(small & (tx1 > tx0) & (ty1 > ty0), knobs["corner_cap"]),
                (lo, knobs["mid_lo_splat_cap"]),
                (mid, knobs["mid_splat_cap"]),
                (over1 & ~fits(ref.KY_M), knobs["big_splat_cap"])]
    b = fr.binned
    return fr, {"valid": int(valid.sum()),
                "emitted": int(b.count.sum()),
                "dropped": int((b.count - b.kept - b.kept_tl).sum()),
                "side_dropped": sum(max(int(m.sum()) - cap, 0)
                                    for m, cap in channels),
                "view": view, "eye": eye, "planes": planes}


@pytest.mark.parametrize("az", AZIMUTHS)
def test_lod_frame_and_stats_match_the_reference(cloud, camera, az):
    cfg = _config()
    img, st = _port(cloud, cfg, camera, az)
    fr, want = _reference(cloud, cfg, camera, az)
    gap = (img.to(torch.int16) - fr.image.to(torch.int16)).abs()
    assert int(gap.max()) <= 1
    assert float(fr.image.float().mean()) > 5.0     # something is drawn
    assert torch.equal(st["tile_count"], fr.binned.count)
    assert torch.equal(st["tile_kept"], fr.binned.kept)
    assert int(st["overflow_pairs"]) == want["dropped"]
    assert int(st["overflow_big_splats"]) == want["side_dropped"]
    assert want["valid"] < N          # the eye stands inside the scene
    if az == 2.1:
        # floaters behind the eye and beside the frustum, within 1.5 units
        n_fl = N - sum(int(N * cfg["scene_params"][k]) for k in
                       ("object_share", "ground_share", "background_share"))
        m = cloud["means"][-n_fl:]
        z = m @ want["view"][2, :3] + want["view"][2, 3]
        near = (m - want["eye"]).norm(dim=1) < 1.5
        culled = ~torch.isfinite(want["planes"][5, -n_fl:])
        assert int((near & (z < 0)).sum()) > 0
        assert int((near & (z > camera["near"]) & culled).sum()) > 0


def test_full_side_channels_drop_as_the_reference_does(cloud, camera):
    """Budgets cut 50-fold and a 256-pair tail: the side channels and the
    pools overflow, and the port drops what the reference drops."""
    cfg = _config(cap_div=50, tail=256)
    img, st = _port(cloud, cfg, camera, 1.0)
    fr, want = _reference(cloud, cfg, camera, 1.0)
    assert want["side_dropped"] > 0 and want["dropped"] > 0
    assert int(st["overflow_big_splats"]) == want["side_dropped"]
    assert int(st["overflow_pairs"]) == want["dropped"]
    gap = (img.to(torch.int16) - fr.image.to(torch.int16)).abs()
    assert int(gap.max()) <= 1


def _stat_sums(stats, valid):
    return {"frames": len(stats), "valid_splats": sum(valid),
            "pairs_emitted": sum(int(s["tile_count"].sum()) for s in stats),
            "pairs_dropped": sum(int(s["overflow_pairs"]) for s in stats),
            "side_dropped_splats": sum(int(s["overflow_big_splats"])
                                       for s in stats)}


def test_counters_sum_the_frames_stats(cloud, camera):
    cfg = _config(cap_div=50, tail=256)
    profiler.reset_counters()
    assert profiler.read_counters("cpu") is None
    stats, valid = [], []
    for az in AZIMUTHS:
        _, st = _port(cloud, cfg, camera, az)
        stats.append(st)
        valid.append(_reference(cloud, cfg, camera, az)[1]["valid"])
    got = profiler.read_counters("cpu")
    assert got == _stat_sums(stats, valid)
    assert got["side_dropped_splats"] > 0 and got["pairs_dropped"] > 0
    # exact frames count nothing
    view, proj, eye = orbit_view(torch.tensor(0.0), camera, W, H)
    gs.render_gaussians(GaussianCloud(**cloud), view, proj, W, H,
                        cam_pos=eye, tile_w=64)
    assert profiler.read_counters("cpu") == got
    profiler.reset_counters()
    assert profiler.read_counters() is None


def test_an_exported_frame_leaves_the_counters_counting(cloud, camera,
                                                        tmp_path):
    """``torch.export`` traces the LOD frame with stand-in tensors: they
    count nothing and leave no stand-in buffer behind, so the next eager
    frame counts as one."""
    from ray_eater_tpu_torch.graph import render_graph as tgraph
    small = GaussianCloud(**{k: v[::50].contiguous()
                             for k, v in cloud.items()})
    kw = {k: _config()["knobs"][k] for k in LOD_KEYS}

    def render(i):
        view, proj, eye = orbit_view(i["az"], camera, W, H)
        return {"image": gs.render_gaussians(small, view, proj, W, H,
                                             cam_pos=eye, **kw)}
    prog = (tgraph.RenderGraph("lod").external("az")
            .add_pass("render", render, reads=("az",), writes=("image",))
            .output("image").bake())
    profiler.reset_counters()
    prog.save_baked(str(tmp_path / "lod.pt2"), az=torch.tensor(0.5))
    assert profiler.read_counters("cpu") is None
    prog(az=torch.tensor(0.5))
    assert profiler.read_counters("cpu")["frames"] == 1
    profiler.reset_counters()


def test_binning_spans_show_in_an_eager_trace(cloud, camera):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _port(cloud, _config(), camera, 0.0)
    names = [e.name for e in prof.events()]
    assert names.count("gs.bin.channels") == 1
    assert names.count("gs.bin.tail") == 1
    profiler.reset_counters()


def _animate(cloud, cfg, camera, dev, frames):
    """``frames`` frames of the benchmark's frame step (the orbit's
    azimuth in the carry, advanced a frame) through ``render_animation``
    on ``dev``, and the same frames eagerly: the counters of each."""
    gc = GaussianCloud(**{k: v.to(dev) for k, v in cloud.items()})
    kw = {k: cfg["knobs"][k] for k in LOD_KEYS}

    def step(t, carry):
        view, proj, eye = orbit_view(carry["az"], camera, W, H)
        img = gs.render_gaussians(gc, view, proj, W, H, cam_pos=eye, **kw)
        return img, {"az": carry["az"] + 0.7}

    az0 = torch.full((), 0.3, device=dev)
    profiler.reset_counters()
    for i in range(frames):
        step(None, {"az": az0 + 0.7 * i})
    eager = profiler.read_counters(dev)
    profiler.reset_counters()
    animation.render_animation(step, frames, keep="last",
                               carry={"az": az0}, device=dev)
    replayed = profiler.read_counters(dev)
    animation.release(step)
    profiler.reset_counters()
    return eager, replayed


def test_render_animation_counts_its_frames(cloud, camera):
    eager, replayed = _animate(cloud, _config(cap_div=50, tail=256), camera,
                               torch.device("cpu"), 3)
    assert eager["frames"] == 3 and replayed == eager


@pytest.mark.gpu
def test_a_captured_replay_counts_as_the_eager_frames(cloud, camera):
    """On the card the eager warm-up steps render the animation's first
    frames before the capture, then each replay of the captured step adds
    one frame: the counts of the eager frames 0..3 plus those of the
    warm-up's frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda", 0)
    cfg = _config(cap_div=50, tail=256)
    eager, replayed = _animate(cloud, cfg, camera, dev, 4)
    warm, _ = _animate(cloud, cfg, camera, dev, animation.WARMUP_STEPS)
    assert replayed == {k: eager[k] + warm[k] for k in profiler.COUNTERS}
