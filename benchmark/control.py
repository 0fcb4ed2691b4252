"""The check's control: the reference put in the program's place, with its
composite's blend in bfloat16 (the step below the float32 the
configurations state), run through a short window at the cell's own size
and held to the same check as a run. It has to come out not correct.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 \
        [--frames 40]

One JSON line a seed: the seed, ``correct`` and each number with its
limit. The benchmark's own runs do not run this; it reads the control's
numbers for the limits (``limits/<cell>.json``).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import functools  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))


def run(cell, seed: int, frames: int, blend, dev) -> dict:
    """One control run of ``cell``: ``frames`` frames of the reference in
    ``blend``, every frame kept, the check's usual sample of them."""
    import torch

    from harness import cell as cellrun
    from harness.program import ReferenceFrames
    cell.traffic = dict(cell.traffic, check=dict(cell.traffic["check"],
                                                 stride=1))
    with torch.no_grad():
        out = cellrun.run_cell(
            cell, seed, 0.0, False, dev, time.perf_counter(),
            program_cls=functools.partial(ReferenceFrames, blend=blend),
            frames=frames)
    res = out["check"]
    return {"seed": seed, "correct": res["correct"],
            "numbers": {k: {"value": v, "limit": lim}
                        for k, (v, lim) in res["numbers"].items()},
            "info": res["info"],
            "frames": res["frames"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)
    import torch

    from harness import spec
    for seed in args.seeds:
        cell = spec.load_cell(args.workload)
        print(json.dumps({"workload": args.workload, "blend": "bfloat16",
                          **run(cell, seed, args.frames, torch.bfloat16,
                                torch.device("cuda"))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
