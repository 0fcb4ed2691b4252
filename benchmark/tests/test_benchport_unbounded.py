"""The cells ``unbounded-6m.flythrough`` and ``fog-1m.jumpcut`` on the CPU
at a small size, the readers of the port's frame counters, and the
``unbounded`` scene's generator."""

import functools
import time

import pytest
import torch

from conftest import shrink
from harness import cell as cellrun
from harness import scene, spec
from harness.program import PortFrames, ReferenceFrames
from test_benchport_faults import AlteredFrame

from ray_eater_tpu_torch.utils import profiler

CELLS = ["unbounded-6m.flythrough", "fog-1m.jumpcut"]
CPU = torch.device("cpu")
COUNTER_METRICS = ("side_dropped_splats", "lod_kept_pct")


def _run(name, program_cls=PortFrames, traced=False, seed=2**33 + 18):
    cell = shrink(spec.load_cell(name), 6000, 192, 128)
    torch.set_num_threads(2)
    profiler.reset_counters()
    with torch.no_grad():
        out = cellrun.run_cell(cell, seed, 0.0, traced, CPU,
                               time.perf_counter(), program_cls=program_cls,
                               frames=10)
    return out


@pytest.mark.parametrize("name", CELLS)
def test_new_cell_runs_traced_and_is_correct(name):
    out = _run(name, traced=True)
    res = out["check"]
    assert res["correct"] and res["failed"] == 0, res
    metrics = out["trace"]["metrics"]
    reported = [m for m in COUNTER_METRICS if m in metrics]
    if name.startswith("unbounded"):
        assert reported == list(COUNTER_METRICS)
        assert metrics["side_dropped_splats"]["value"] >= 0.0
        assert 0.0 < metrics["lod_kept_pct"]["value"] <= 100.0
        assert "budget_off" not in res["numbers"]
    else:
        assert reported == []           # the metrics list only unbounded
        assert "budget_off" in res["numbers"]
    profiler.reset_counters()


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("program", [
    AlteredFrame, functools.partial(ReferenceFrames, blend=torch.bfloat16)],
    ids=["altered-frame", "bf16-control"])
def test_new_cell_refuses_a_wrong_frame(name, program):
    res = _run(name, program)["check"]
    assert not res["correct"], res
    profiler.reset_counters()


def _counters(monkeypatch, totals):
    monkeypatch.setattr(profiler, "read_counters", lambda device=None: totals)


def test_counter_readers_read_the_totals(monkeypatch):
    side = spec.reader("side_dropped_splats")
    kept = spec.reader("lod_kept_pct")
    _counters(monkeypatch, {"frames": 4, "valid_splats": 4000,
                            "pairs_emitted": 10000, "pairs_dropped": 2500,
                            "side_dropped_splats": 60})
    assert side(None) == pytest.approx(15.0)
    assert kept(None) == pytest.approx(75.0)
    _counters(monkeypatch, {"frames": 2, "valid_splats": 0,
                            "pairs_emitted": 0, "pairs_dropped": 0,
                            "side_dropped_splats": 0})
    assert side(None) == 0.0
    assert kept(None) is None                 # nothing emitted


def test_counter_readers_without_counters(monkeypatch):
    side = spec.reader("side_dropped_splats")
    kept = spec.reader("lod_kept_pct")
    profiler.reset_counters()
    assert side(None) is None and kept(None) is None   # no frame counted
    monkeypatch.delattr(profiler, "read_counters")     # a port without them
    assert side(None) is None and kept(None) is None


def test_counter_readers_on_counted_frames():
    _run("unbounded-6m.flythrough")
    c = profiler.read_counters("cpu")
    assert c["frames"] >= 10 and c["pairs_emitted"] > 0
    kept = spec.reader("lod_kept_pct")(None)
    assert kept == pytest.approx(
        100.0 * (1 - c["pairs_dropped"] / c["pairs_emitted"]))
    assert spec.reader("side_dropped_splats")(None) == pytest.approx(
        c["side_dropped_splats"] / c["frames"])
    profiler.reset_counters()


def test_unbounded_scene_follows_the_seed():
    cfg = spec.load_cell("unbounded-6m.flythrough").config
    cfg = dict(cfg, scene_params=dict(cfg["scene_params"], num_splats=5000))
    with torch.random.fork_rng():
        a = scene.make_cloud(cfg, 2**40 + 5, CPU)
        b = scene.make_cloud(cfg, 2**40 + 5, CPU)
        c = scene.make_cloud(cfg, 2**40 + 6, CPU)
    assert a.keys() == c.keys()
    for k in a:
        assert a[k].shape[0] == 5000
        assert torch.equal(a[k], b[k]), k
        assert not torch.equal(a[k], c[k]), k
    # the parts and where they lie: object, ground, background, floaters
    p = cfg["scene_params"]
    n_obj, n_gnd = int(5000 * p["object_share"]), int(5000 * p["ground_share"])
    n_bg = int(5000 * p["background_share"])
    r = a["means"].norm(dim=1)
    assert float(r[:n_obj].max()) < 1.0
    gy = a["means"][n_obj:n_obj + n_gnd, 1]
    assert torch.all(gy == p["ground_y"])
    bg = r[n_obj + n_gnd:n_obj + n_gnd + n_bg]
    assert float(bg.min()) >= 15.0 - 1e-3 and float(bg.max()) <= 40.0 + 1e-3
    fl = a["means"][n_obj + n_gnd + n_bg:]
    lo, hi = (torch.tensor(v) for v in p["floater_box"])
    assert torch.all((fl >= lo) & (fl <= hi))
    assert float(a["opacities"][-len(fl):].mean()) < 0.4   # faint
