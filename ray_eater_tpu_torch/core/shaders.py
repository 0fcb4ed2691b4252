"""Built-in shading functions with the reference shaders' semantics
(counterpart of ``ray_eater_tpu/core/shaders.py``):

* :func:`mvp_vertex` — shaders/shader.vert
* :func:`textured_border_fragment` — shaders/shader.frag
* :func:`passthrough_vertex` — render_quad.zig's embedded vertex shader
* :func:`quad_sample_fragment` — samples/compute_drawing/shaders/frag.glsl
"""

from __future__ import annotations

import torch

from .. import rmath
from ..ops.sampling import sample


def mvp_vertex(positions, attrs, uniforms):
    """``gl_Position = proj * view * model * vec4(pos, 1)``; colour and uv
    pass through (shader.vert:16-19). ``uniforms`` is the UBO of
    basic_planes.zig:66-70: {model, view, projection}, row-major (4, 4)."""
    mvp = rmath.mul(rmath.mul(uniforms["projection"], uniforms["view"]),
                    uniforms["model"])
    clip = rmath.transform_points(mvp, positions)
    return clip, {"color": attrs["color"], "uv": attrs["uv"]}


def textured_border_fragment(varyings, resources):
    """shader.frag:10-21: white where uv is within LINE_WIDTH/2 of an edge,
    else ``texture(tex, uv) * vec4(color, 1)``."""
    uv = varyings["uv"]
    color = varyings["color"]
    tex = resources["tex"]
    lw = 0.1 * 0.5
    upper = 1.0 - lw
    u, v = uv[..., 0], uv[..., 1]
    border = (u <= lw) | (u > upper) | (v <= lw) | (v > upper)
    texel = sample(tex, uv, valid=varyings.get("_coverage"))
    shaded = texel * torch.cat([color, torch.ones_like(color[..., :1])], -1)
    return torch.where(border[..., None], 1.0, shaded)


def passthrough_vertex(positions, attrs, uniforms):
    """NDC passthrough for fullscreen quads (render_quad.zig:28-52):
    positions already in clip space, z = 0.5, w = 1."""
    ones = torch.ones((positions.shape[0], 1), dtype=torch.float32,
                      device=positions.device)
    clip = torch.cat([positions[:, :2], torch.zeros_like(ones) + 0.5, ones],
                     -1)
    return clip, {"uv": attrs["uv"]}


def quad_sample_fragment(varyings, resources):
    """compute_drawing frag.glsl:19: sample the compute-written image."""
    return sample(resources["compute_image"], varyings["uv"],
                  valid=varyings.get("_coverage"))
