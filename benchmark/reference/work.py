"""The work of one frame, counted from the reference's binning and its
composites' executed rows, never from what the program's layout reports:
a program change that fuses or removes a kernel leaves these counts where
they were.

Bytes: each input read once and each output written once. Operations:
float32 operations, an ``exp`` counted as one, of the (pixel, row)
evaluations that the frame's semantics execute up to tile saturation (the
rows of every 128-row chunk a tile runs, over every sample of the tile),
and of every splat's SH colour and projection.

The least time of a piece of work is the larger of its operations over the
card's float32 peak and its bytes over its memory bandwidth
(:data:`PEAKS`, published figures of the NVIDIA H100 SXM at its 700 W
limit, no derived rate).
"""

from __future__ import annotations

from . import sh
from .render import TILE_H, Frame

#: published peaks of one NVIDIA H100 SXM (data sheet, dense float32
#: outside the tensor cores; HBM3 bandwidth), at its 700 W power limit
PEAKS = {"f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12}

#: float32 operations of one (pixel, row) evaluation of the composite:
#: dx, dy (2); the quadratic form -0.5 (a dx dx + c dy dy) - b dx dy (9);
#: exp (1); times opacity (1); clamp at 0.99 (1); the 1/255 test (1); the
#: weight alpha T (1); T (1 - alpha) (2); three colour multiply-adds (6)
FLOPS_PER_EVAL = 24
#: float32 operations of one splat's EWA projection (the quaternion and
#: covariance, the view transform, the Jacobian, the 2D covariance and its
#: inverse, the radii and the cull), counted from ``render.project``
FLOPS_PER_SPLAT = 260
#: bytes of one composited row the composites need: mean (2), conic (3),
#: opacity (1), colour (3), float32
ROW_BYTES = 9 * 4
#: bytes of one splat the frame reads: mean 3, scale 3, rotation 4,
#: opacity 1, colour 3, float32; and 3 a higher SH band
SPLAT_BYTES = 14 * 4
SH_BAND_BYTES = 3 * 4


def least_s(flops: float, nbytes: float) -> tuple[float, str]:
    """(seconds, which bound) of work at the published peaks."""
    tf = flops / PEAKS["f32_flops"]
    tb = nbytes / PEAKS["hbm_bytes_per_s"]
    return (tf, "f32") if tf >= tb else (tb, "bytes")


def composite_work(exec_rows, ntiles: int, tile_w: int, decim: int,
                   entry: bool) -> dict:
    """Operations and bytes of one composite (the head, or the decimated
    tail with ``entry``, which reads its entry transmittance): ``exec_rows``
    (ntiles,) rows each tile ran."""
    pix = (TILE_H // decim) * (tile_w // decim)
    rows = int(exec_rows.sum())
    nbytes = (rows * ROW_BYTES + ntiles * 8          # rows, row ranges
              + 4 * ntiles * pix * 4 + ntiles * 4)   # planes, exec
    if entry:
        nbytes += ntiles * pix * 4
    return {"flops": float(rows) * pix * FLOPS_PER_EVAL,
            "bytes": float(nbytes), "evals": rows * pix}


def frame_work(fr: Frame, num_splats: int, width: int, height: int,
               tile_w: int, decim: int, sh_bands: int = 0) -> dict:
    """The frame's work: ``k2`` (head composite), ``k3`` (decimated tail,
    absent without one) and ``frame`` (the SH colours of splats with
    ``sh_bands`` higher bands, the projection and both composites'
    operations; the cloud read once and the u8 image written once)."""
    ntiles = fr.exec_head.shape[0]
    out = {"k2": composite_work(fr.exec_head, ntiles, tile_w, 1, False)}
    flops = out["k2"]["flops"]
    if fr.exec_tail is not None:
        out["k3"] = composite_work(fr.exec_tail, ntiles, tile_w, decim, True)
        flops += out["k3"]["flops"]
    flops += float(num_splats) * (FLOPS_PER_SPLAT
                                  + sh.FLOPS_PER_SPLAT[sh_bands])
    out["frame"] = {"flops": flops,
                    "bytes": float(num_splats * (SPLAT_BYTES + sh_bands
                                                 * SH_BAND_BYTES)
                                   + width * height * 3)}
    return out
