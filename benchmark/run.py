"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cell's CUDA cards.
Set-up builds or loads the port's kernels (under
``ray_eater_tpu_torch/_build/``), makes the cell's scene from the seed and
captures its frame step; the window then renders frames for ``--seconds``;
the check holds a sample of them to the plain reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device`` and, with ``--trace 1``,
``breakdown``; ``checks`` comes last, each number compared with its
limit, and the same numbers end standard error. Exits 2 without the cards,
3 if JAX or the JAX package was loaded, 1 if the run raised.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(ROOT))


def _power_limit() -> str | None:
    """The card's power limit as ``nvidia-smi`` reads it, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def _by_second(frame_ms: list) -> list:
    """The mean frame time of each second of the window, in order."""
    out, acc, n = [], 0.0, 0
    for ms in frame_ms:
        acc += ms
        n += 1
        if acc >= 1000.0:
            out.append(acc / n)
            acc, n = 0.0, 0
    if n:
        out.append(acc / n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    t_torch = time.perf_counter() - T_START

    from harness import cell as cellrun
    from harness import guard, spec

    c = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"run.py: {args.workload} needs {c.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    with torch.no_grad():
        out = cellrun.run_cell(c, args.seed, args.seconds, bool(args.trace),
                               dev, T_START)
    bad = guard.forbidden_modules()
    if bad:
        print(f"run.py: the run loaded {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 3
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": c.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"]),
              "power_limit": _power_limit()}
    res = out["check"]
    line = {"correct": res["correct"], "attempted": out["attempted"],
            "failed": res["failed"]}
    if args.trace:
        tr = out["trace"]
        line["metrics"] = tr["metrics"]
        device.update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        line["device"] = device
        line["breakdown"] = tr["breakdown"]
    else:
        line["metrics"] = cellrun.end_to_end(c, out)
        line["device"] = device
    line["setup_phases"] = {"torch": t_torch, **out["setup_phases"]}
    line["frame_ms_by_s"] = _by_second(out["window"].frame_ms)
    line["launches_per_frame"] = out["capture"].get("launches_per_frame")
    line["checked_frames"] = res["frames"]
    line["check_info"] = res["info"]
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res["numbers"].items()}
    print(json.dumps(line), flush=True)
    for k, (v, lim) in res["numbers"].items():
        print(f"check {k} = {v!r} (limit {lim!r}): "
              f"{'ok' if v <= lim else 'OVER'}", file=sys.stderr)
    print(f"correct: {res['correct']}", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
