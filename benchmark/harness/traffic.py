"""The one generator of the benchmark's traffic: a mix is a data file,
``traffic/<name>.json``, whose parameters this reads.

A mix gives the frame extent (``width``, ``height``), the render ``mode``
(``"lod"``: the configuration's LOD knobs, its temporal budget carried
from frame to frame where the knobs say ``temporal``; ``"exact"``: the
API's default exact frame, no carry), the orbit ``camera`` and the
``views``, one azimuth a frame, cycled through a period:

* ``{"kind": "orbit", "deg_per_s": d, "fps": f}``: frame i at t = i / f
  seconds on an orbit turning d degrees a second (a flythrough; the
  period is one turn);
* ``{"kind": "seeded_azimuths", "count": k}``: k views, one drawn
  uniformly inside each of k equal arcs of the orbit, shuffled; both the
  draws and the order follow the run's seed, so every seed renders the
  same spread of views in another order.

``check`` sets how many frames the check compares (``start_frames`` from
the first on, ``sampled_frames`` drawn from one kept frame a ``stride``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Schedule:
    width: int
    height: int
    lod: bool
    camera: dict
    az: torch.Tensor          # (period,) float32 radians, on the device
    check: dict

    @property
    def period(self) -> int:
        return self.az.shape[0]

    def view(self, i: int) -> torch.Tensor:
        """The 0-d azimuth of frame ``i``."""
        return self.az[i % self.period]


def schedule(traffic: dict, seed: int, dev: torch.device) -> Schedule:
    v = traffic["views"]
    if v["kind"] == "orbit":
        period = round(360.0 / v["deg_per_s"] * v["fps"])
        t = np.arange(period, dtype=np.float64) / v["fps"]
        az = (np.float32(math.radians(v["deg_per_s"]))
              * t.astype(np.float32)).astype(np.float32)
    elif v["kind"] == "seeded_azimuths":
        k = v["count"]
        rng = np.random.default_rng([seed % (1 << 64), 0x7A])
        az = (2 * math.pi * (np.arange(k) + rng.random(k)) / k)
        az = az[rng.permutation(k)].astype(np.float32)
    else:
        raise ValueError(f"unknown views kind {v['kind']!r}")
    return Schedule(width=traffic["width"], height=traffic["height"],
                    lod=traffic["mode"] == "lod", camera=traffic["camera"],
                    az=torch.from_numpy(az).to(dev), check=traffic["check"])
