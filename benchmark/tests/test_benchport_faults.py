"""A run on the CPU at a small size, the harness's look for a card
skipped: sound, it comes out correct; with the timed path broken
underneath, or with the control in the program's place, it does not."""

import functools
import time

import pytest
import torch

from conftest import shrink
from harness import cell as cellrun
from harness import spec
from harness.program import PortFrames, ReferenceFrames

CELLS = ["fog-1m.flythrough", "inria-1m.flythrough", "fog-1m.exact-views"]
CPU = torch.device("cpu")


def _run(name, program_cls=PortFrames, seed=2**31 + 12345):
    cell = shrink(spec.load_cell(name), 3000, 192, 128)
    torch.set_num_threads(2)
    with torch.no_grad():
        out = cellrun.run_cell(cell, seed, 0.0, False, CPU,
                               time.perf_counter(), program_cls=program_cls,
                               frames=12)
    return out["check"]


class StaleBudget(PortFrames):
    """A frame step that hands its budget back unchanged."""

    def frame(self, az, budget):
        img, _ = super().frame(az, budget)
        return img, budget


class AlteredFrame(PortFrames):
    """A frame whose upper-left 64 x 64 block is off by 16 codes."""

    def frame(self, az, budget):
        img, nb = super().frame(az, budget)
        img = img.clone()
        img[:64, :64] = (img[:64, :64].to(torch.int16) + 16).clamp(
            0, 255).to(torch.uint8)
        return img, nb


class HalfTheSplats(PortFrames):
    """The frame of half the scene: the other half left out."""

    def __init__(self, cloud, *a, **k):
        half = {key: v[: v.shape[0] // 2] for key, v in cloud.items()}
        super().__init__(half, *a, **k)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(name)
    assert res["correct"], res
    assert res["failed"] == 0


@pytest.mark.parametrize("name,fault", [
    ("fog-1m.flythrough", StaleBudget),
    *[(n, AlteredFrame) for n in CELLS],
    *[(n, HalfTheSplats) for n in CELLS],
])
def test_a_broken_timed_path_is_not_correct(name, fault):
    res = _run(name, fault)
    assert not res["correct"], res
    assert res["failed"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    res = _run(name, functools.partial(ReferenceFrames,
                                       blend=torch.bfloat16))
    assert not res["correct"], res


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    """The control on the card over three seeds, at a size a test run
    holds (its readings at the cells' own size come from
    ``benchmark/control.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import control
    for seed in (11, 12, 13):
        cell = shrink(spec.load_cell(name), 200_000, 960, 544)
        r = control.run(cell, seed, 24, torch.bfloat16, torch.device("cuda"))
        assert not r["correct"], r
