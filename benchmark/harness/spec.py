"""What a run reads by name: the cell in ``BENCHMARK.json``, its
configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), its limits (``limits/<cell>.json``) and its
per-layer readers (``metrics/<name>.py``). A cell, a configuration, a
traffic mix or a metric is added as new files and entries; nothing here
names one."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

#: the benchmark's folder; the checkout's root is its parent
HERE = Path(__file__).resolve().parent.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files
    (``root``: the checkout, by default this file's)."""
    bench_dir = HERE if root is None else Path(root) / HERE.name
    spec = _json(bench_dir.parent / "BENCHMARK.json")
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(bench_dir.parent / configs[w["config"]]["file"])
    traffic = _json(bench_dir / "traffic" / f"{w['traffic']}.json")
    limits = _json(bench_dir / "limits" / f"{name}.json")
    return Cell(name=name, chips=w["chips"], config=config, traffic=traffic,
                limits=limits,
                end_to_end=[m for m in spec["end_to_end"]
                            if _reports(m, name)],
                per_layer=[m for m in spec["per_layer"]
                           if _reports(m, name)])


def reader(metric: str, root: Path | None = None):
    """The ``read(ctx)`` function of ``metrics/<metric>.py`` (its folder
    on the import path, for the readers' shared modules)."""
    bench_dir = HERE if root is None else Path(root) / HERE.name
    path = bench_dir / "metrics" / f"{metric}.py"
    if str(path.parent) not in sys.path:
        sys.path.insert(0, str(path.parent))
    mod_name = "benchmark_metric_" + metric.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metric_data(metric_file: str) -> dict:
    """The data file beside a reader: ``metrics/<stem>.json`` for the
    reader at ``metric_file``."""
    return _json(Path(metric_file).with_suffix(".json"))
