"""PyTorch/CUDA port of ``ray_eater_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package reproduces its 3D
Gaussian Splatting render path (``ops.gs.render_gaussians``), its
single-device training path (``ops.gs.render_gaussians_diff``,
``models.gs_training``, the adaptive density control of
``models.gs_densify``, the ``gs_trainer`` entry point) and its triangle
raster and texture sampling path (``ops.raster.render_mesh``,
``ops.sampling``, the ``basic_planes`` and ``multipass`` entry points),
its particle splat (``ops.splat``, the ``compute_drawing`` entry point),
its view-dependent SH colours and PLY interchange (``models.gaussians``,
the ``gs_viewer`` entry point) and its host runtime (``core.animation``:
``render_animation`` as the replay of a captured CUDA graph;
``core.swapchain.Swapchain``, ``core.context.Context``,
``graph.render_graph``, ``utils``, ``io.obj``) with plain PyTorch
for the tensor glue and eleven kernels written by hand in CUDA C++
(``csrc/``): K1, the EWA projection; K2, the tile composite; K3, the
composite of the decimated tail; K4, K2 plus the entry-T checkpoints that
training saves; K5, the composite's backward; K6 and K7, the dense and
binned raster folds; K8, the winner-feature fetch; K9, the subtile
sampler's window taps; K10, the particle splat's coverage mask; and the
SH colour kernel, the view-dependent colours of degree-1 to -3 splats.

Nothing here imports JAX or ``ray_eater_tpu``. Entry points run on
``"cuda"`` unless the caller passes CPU tensors or ``device="cpu"``; on the
CPU each kernel wrapper runs its plain PyTorch version, on a CUDA tensor it
launches the kernel or raises.

The top level exports the JAX package's API under the same names
(``__all__``), so ``import ray_eater_tpu_torch as re`` reads as the
reference's samples do: ``re.Context``, ``re.create_framebuffer``,
``re.render_mesh``, ``re.render_gaussians``, ``re.two_planes``,
``re.random_cloud``, ``re.render_animation``, ``re.RenderGraph``,
``re.load_baked`` and the rest. Importing it builds and loads no kernel
(the library builds at a kernel's first launch, ``ops._cuda``) and
imports no ``parallel``: multi-device work imports
``ray_eater_tpu_torch.parallel`` itself, as in the JAX package.
"""

from . import rmath
from .core.context import Context, ContextConfig
from .core.resources import (AddressMode, Filter, Framebuffer, Sampler,
                             Texture, clear, create_framebuffer,
                             texture_from_array, texture_from_file)
from .core.swapchain import Swapchain
from .core.animation import render_animation
from .core.pipeline import (BlendMode, CompareOp, ComputePipeline, CullMode,
                            FrontFace, GraphicsPipeline, RasterState)
from .core import shaders
from .ops.raster import render_mesh
from .ops.gs import render_gaussians
from .models.mesh import Mesh, fullscreen_quad, mesh, two_planes
from .models.gaussians import (GaussianCloud, eval_sh_colors, gaussian_cloud,
                               load_ply, random_cloud, save_ply)
from .io.obj import load_obj
from .graph.render_graph import FrameProgram, RenderGraph, load_baked

__version__ = "0.1.0"

__all__ = [
    "rmath", "Context", "ContextConfig", "Framebuffer", "Texture", "Sampler",
    "Filter", "AddressMode", "Swapchain", "render_animation",
    "GraphicsPipeline",
    "ComputePipeline", "RasterState", "CullMode", "FrontFace", "CompareOp",
    "BlendMode", "shaders", "render_mesh", "Mesh", "mesh", "two_planes",
    "fullscreen_quad", "clear", "create_framebuffer", "texture_from_array",
    "texture_from_file", "render_gaussians", "GaussianCloud",
    "gaussian_cloud", "random_cloud", "load_ply", "save_ply",
    "eval_sh_colors", "load_obj", "RenderGraph", "FrameProgram",
    "load_baked",
]
