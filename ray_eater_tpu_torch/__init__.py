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
for the tensor glue and ten kernels written by hand in CUDA C++
(``csrc/``): K1, the EWA projection; K2, the tile composite; K3, the
composite of the decimated tail; K4, K2 plus the entry-T checkpoints that
training saves; K5, the composite's backward; K6 and K7, the dense and
binned raster folds; K8, the winner-feature fetch; K9, the subtile
sampler's window taps; and K10, the particle splat's coverage mask.

Nothing here imports JAX or ``ray_eater_tpu``. Entry points run on
``"cuda"`` unless the caller passes CPU tensors or ``device="cpu"``; on the
CPU each kernel wrapper runs its plain PyTorch version, on a CUDA tensor it
launches the kernel or raises.
"""

__version__ = "0.1.0"
