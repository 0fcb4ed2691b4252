"""Multi-device rendering on ``torch.distributed`` (counterpart of
``ray_eater_tpu/parallel/``): :mod:`.sharded`."""

from .sharded import (make_device_mesh, render_gaussians_depth_sliced,
                      render_gaussians_sharded, render_mesh_sharded)

__all__ = ["make_device_mesh", "render_gaussians_sharded",
           "render_gaussians_depth_sliced", "render_mesh_sharded"]
