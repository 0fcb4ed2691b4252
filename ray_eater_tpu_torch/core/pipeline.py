"""Pipelines: programmable stages plus fixed-function raster state
(counterpart of ``ray_eater_tpu/core/pipeline.py``; the reference's
GraphicsPipeline/FixedFunctionState, graphics_pipeline.zig:17-330).

Stage signatures, on tensors:

* ``vertex_fn(positions (N,3), attrs {name: (N,K)}, uniforms)
  -> (clip (N,4), varyings {name: (N,K)})``
* ``fragment_fn(varyings {name: (H,W,K)}, resources) -> rgba (H,W,4)``
* compute: any function of tensors (``fn(resources...) -> outputs``)
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable

import torch


class CullMode(enum.Enum):
    NONE = "none"
    BACK = "back"     # reference default (graphics_pipeline.zig:137-139)
    FRONT = "front"


class FrontFace(enum.Enum):
    CLOCKWISE = "cw"          # reference default (graphics_pipeline.zig:140)
    COUNTER_CLOCKWISE = "ccw"


class CompareOp(enum.Enum):
    LESS = "less"             # reference default (graphics_pipeline.zig:262)
    LESS_EQUAL = "less_equal"
    ALWAYS = "always"


class BlendMode(enum.Enum):
    NONE = "none"             # reference default: blending off
    ALPHA = "alpha"           # src_alpha / one_minus_src_alpha


@dataclasses.dataclass(frozen=True)
class RasterState:
    """Fixed-function state. Defaults mirror the reference: cull back,
    clockwise front face, no blending, depth test and write on with LESS."""
    cull_mode: CullMode = CullMode.BACK
    front_face: FrontFace = FrontFace.CLOCKWISE
    depth_test: bool = True
    depth_write: bool = True
    depth_compare: CompareOp = CompareOp.LESS
    blend: BlendMode = BlendMode.NONE


@dataclasses.dataclass(frozen=True)
class GraphicsPipeline:
    """Two shading functions plus raster state (GraphicsPipeline.init,
    graphics_pipeline.zig:235-307)."""
    vertex_fn: Callable
    fragment_fn: Callable
    state: RasterState = RasterState()
    name: str = "graphics"


@dataclasses.dataclass(frozen=True)
class ComputePipeline:
    """One compute function (compute.zig:28-89); grids live inside the
    kernels it launches."""
    fn: Callable
    name: str = "compute"


def blend_color(mode: BlendMode, src: torch.Tensor,
                dst: torch.Tensor) -> torch.Tensor:
    """Framebuffer blend (graphics_pipeline.zig:166-201)."""
    if mode is BlendMode.NONE:
        return src
    a = src[..., 3:4]
    rgb = src[..., :3] * a + dst[..., :3] * (1.0 - a)
    out_a = a + dst[..., 3:] * (1.0 - a)
    return torch.cat([rgb, out_a], -1)
