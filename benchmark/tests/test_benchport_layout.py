"""The harness is driven by data: a configuration, a traffic mix, a cell,
its limits and a per-layer metric added as new files plus new entries in
``BENCHMARK.json`` are found by name, with no edit to an existing file."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
ROOT = BENCH.parent

DRIVE = r"""
import json, sys, time
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import torch
torch.set_num_threads(2)
from harness import cell, spec
c = spec.load_cell("fog-small.quarter-turn")
with torch.no_grad():
    out = cell.run_cell(c, 7, 0.0, True, torch.device("cpu"),
                        time.perf_counter(), frames=6, root=sys.argv[3])
print(json.dumps({"correct": out["check"]["correct"],
                  "metrics": out["trace"]["metrics"],
                  "size": [c.traffic["width"], c.traffic["height"]],
                  "splats": c.config["scene_params"]["num_splats"]}))
"""


def _copy_tree(dst: Path) -> tuple[Path, dict]:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / BENCH.name,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (dst / BENCH.name).rglob("*")
              if p.is_file()}
    return dst / BENCH.name, before


def test_new_cell_traffic_config_and_metric_are_picked_up(tmp_path):
    bench, before = _copy_tree(tmp_path)
    cfg = json.loads((bench / "configs" / "fog-1m.json").read_text())
    cfg.update(name="fog-small")
    cfg["scene_params"]["num_splats"] = 2000
    (bench / "configs" / "fog-small.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "flythrough.json").read_text())
    traffic.update(width=128, height=64,
                   views={"kind": "orbit", "deg_per_s": 90.0, "fps": 4})
    traffic["check"] = dict(traffic["check"], stride=2)
    (bench / "traffic" / "quarter-turn.json").write_text(json.dumps(traffic))
    (bench / "limits" / "fog-small.quarter-turn.json").write_text(
        (bench / "limits" / "fog-1m.flythrough.json").read_text())
    (bench / "metrics" / "frames_traced.py").write_text(
        '"""Frames of the traced slice."""\n\n\n'
        "def read(ctx):\n    return float(ctx.frames)\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "fog-small", "source": "a test",
                            "file": "benchmark/configs/fog-small.json",
                            "reduced": ["scene_params"], "why": "a test"})
    spec["workloads"].append({"name": "fog-small.quarter-turn",
                              "config": "fog-small",
                              "traffic": "quarter-turn", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source": "program_counter",
                              "layer": "a test", "moves": "frame_ms",
                              "workloads": ["fog-small.quarter-turn"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    r = subprocess.run([sys.executable, "-c", DRIVE, str(bench), str(ROOT),
                        str(tmp_path)], capture_output=True, text=True,
                       timeout=600, cwd=tmp_path)
    assert r.returncode == 0, r.stderr[-3000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert got["size"] == [128, 64] and got["splats"] == 2000
    assert got["metrics"]["frames_traced"]["value"] == 16.0
    # the existing files are untouched
    for p, data in before.items():
        assert p.read_bytes() == data, p
