"""Differentiable 3DGS rendering and training steps (counterpart of
``ray_eater_tpu/models/gs_training.py``).

Parameters live in activation space (log-scale, opacity logit, raw quat,
colour logit), as in the original 3DGS optimizer, so optimization is
unconstrained. Two differentiable renderers:

* :func:`render_diff` — plain tensors, autograd end to end. It materializes
  (row_chunk × W × N) alpha tensors: small clouds only, but an independent
  derivation that validates the kernel path.
* :func:`render_diff_pallas` — the render pipeline with the composite's
  hand-written backward (``ops.gs.render_gaussians_diff``: K4 forward, K5
  backward on CUDA). The LOD layout bounds the checkpoint memory, so this
  path trains 1M-splat scenes at full resolution. The name keeps the JAX
  function's, so a reader finds its counterpart.

optax's ``adam(lr)`` is :func:`adam`: ``torch.optim.Adam`` with the same
betas and epsilon (the same update rule). A step updates the parameters in
place through the optimizer, which holds them. :func:`make_train_step_dp`
is the data-parallel step over a ``torch.distributed`` device mesh
(``parallel.make_device_mesh``): each rank grades its band of the target's
rows, and the loss and gradients are averaged over the mesh.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from ..ops.gs import _on, project_gaussians, render_gaussians_diff
from .gaussians import GaussianCloud

_F32 = torch.float32


@dataclass
class GaussianParams:
    """Trainable activation-space parameters: leaf f32 tensors that
    require grad, one device."""
    means: torch.Tensor           # (N, 3)
    log_scales: torch.Tensor      # (N, 3)
    quats: torch.Tensor           # (N, 4) unnormalized
    opacity_logits: torch.Tensor  # (N,)
    colors: torch.Tensor          # (N, 3) raw (sigmoid-activated)

    def tensors(self) -> list[torch.Tensor]:
        """The five tensors, in field order (what the optimizer holds)."""
        return [getattr(self, f.name) for f in fields(self)]


def _leaves(**arrays) -> GaussianParams:
    return GaussianParams(**{k: v.detach().to(_F32).contiguous()
                             .requires_grad_(True)
                             for k, v in arrays.items()})


def params_from_cloud(cloud: GaussianCloud) -> GaussianParams:
    eps = 1e-6
    op = torch.clamp(cloud.opacities, eps, 1 - eps)
    col = torch.clamp(cloud.colors, eps, 1 - eps)
    return _leaves(means=cloud.means,
                   log_scales=torch.log(torch.clamp(cloud.scales, min=1e-12)),
                   quats=cloud.quats,
                   opacity_logits=torch.log(op / (1 - op)),
                   colors=torch.log(col / (1 - col)))


def params_from_numpy(d: Mapping[str, np.ndarray],
                      device="cuda") -> GaussianParams:
    """Parameters from a mapping of numpy arrays keyed by the
    ``GaussianParams`` field names — the way a JAX ``GaussianParams``
    crosses into the port."""
    return _leaves(**{f.name: torch.from_numpy(
        np.array(d[f.name], np.float32)).to(device)
        for f in fields(GaussianParams)})


def cloud_from_params(p: GaussianParams) -> GaussianCloud:
    norm = torch.linalg.norm(p.quats, dim=-1, keepdim=True)
    return GaussianCloud(means=p.means, scales=torch.exp(p.log_scales),
                         quats=p.quats / norm.clamp(min=1e-12),
                         opacities=torch.sigmoid(p.opacity_logits),
                         colors=torch.sigmoid(p.colors))


def adam(params: GaussianParams, lr: float) -> torch.optim.Adam:
    """optax ``adam(lr)``: β = (0.9, 0.999), ε = 1e-8."""
    return torch.optim.Adam(params.tensors(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def render_diff(params: GaussianParams, view, proj, width: int, height: int,
                background=(0.0, 0.0, 0.0), row_chunk: int = 16,
                y_offset: float = 0.0, full_height: int | None = None,
                mean2d_offset=None) -> torch.Tensor:
    """Differentiable render → (height, width, 3), plain tensors.

    ``y_offset`` shifts the pixel grid and ``full_height`` is the whole
    image's height: the rows [y_offset, y_offset + height) of a
    ``full_height`` image (the data-parallel step's band). Splats are
    depth-ordered with a straight-through sort (the order takes no
    gradient; values flow through a gather). The 1/255 alpha floor is a
    straight-through mask, as in the compositor. ``mean2d_offset`` (N, 2)
    as in :func:`ops.gs.render_gaussians_diff`."""
    cloud = cloud_from_params(params)
    dev = cloud.means.device
    ps = project_gaussians(cloud.means, cloud.scales, cloud.quats,
                           cloud.opacities, cloud.colors,
                           _on(view, dev, "view").to(_F32),
                           _on(proj, dev, "proj").to(_F32),
                           width, full_height or height)
    if mean2d_offset is not None:
        ps = ps._replace(mean2d=ps.mean2d + mean2d_offset)
    order = torch.argsort(ps.depth.detach(), stable=True)
    mx, my = ps.mean2d[order, 0], ps.mean2d[order, 1]
    ca, cb, cc = ps.conic[order, 0], ps.conic[order, 1], ps.conic[order, 2]
    live = torch.isfinite(ps.depth[order]).to(_F32)
    op = ps.opacity[order] * live
    col = ps.color[order]                                  # (N, 3)
    bg = torch.as_tensor(background, dtype=_F32).to(dev)
    xs = torch.arange(width, dtype=_F32, device=dev) + 0.5

    bands = []
    for y0 in range(0, height, row_chunk):
        ys = (float(y0) + torch.arange(row_chunk, dtype=_F32, device=dev)
              + 0.5 + y_offset)
        dx = xs[None, :, None] - mx[None, None, :]         # (1, W, N)
        dy = ys[:, None, None] - my[None, None, :]         # (R, 1, N)
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        alpha = torch.clamp(op * torch.exp(power), max=0.99)  # (R, W, N)
        keep = (alpha >= 1.0 / 255.0).to(alpha.dtype).detach()
        alpha = alpha * keep
        log_t = torch.cumsum(torch.log1p(-alpha), dim=-1)
        t_prev = torch.exp(log_t - torch.log1p(-alpha))    # exclusive prefix
        w = alpha * t_prev
        rgb = torch.einsum("rwn,nc->rwc", w, col)
        t_final = torch.exp(log_t[..., -1:])
        bands.append(rgb + t_final * bg)
    return torch.cat(bands)[:height]


def render_diff_pallas(params: GaussianParams, view, proj, width: int,
                       height: int, background=(0.0, 0.0, 0.0),
                       max_splats_per_tile: int = 256,
                       mean2d_offset=None) -> torch.Tensor:
    """Differentiable render through the kernel pipeline (K4 forward, K5
    backward on CUDA), the 1M-splat training path."""
    cloud = cloud_from_params(params)
    return render_gaussians_diff(
        cloud.means, cloud.scales, cloud.quats, cloud.opacities,
        cloud.colors, view, proj, width, height, background=background,
        max_splats_per_tile=max_splats_per_tile,
        mean2d_offset=mean2d_offset)


def l2_loss(params, view, proj, target, background=(0.0, 0.0, 0.0),
            y_offset: float = 0.0, full_height: int | None = None):
    h, w = target.shape[0], target.shape[1]
    img = render_diff(params, view, proj, w, h, background,
                      y_offset=y_offset, full_height=full_height)
    return torch.mean((img - target) ** 2)


def _step(optimizer, loss_fn):
    def step(params: GaussianParams, target) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(params, target)
        loss.backward()
        optimizer.step()
        return loss.detach()
    return step


def make_train_step(optimizer, view, proj, background=(0.0, 0.0, 0.0)):
    """Single-device training step through :func:`render_diff`:
    ``step(params, target) -> loss`` (the loss before the update; the
    optimizer, built over ``params.tensors()``, updates them in place)."""
    return _step(optimizer, lambda p, t: l2_loss(p, view, proj, t,
                                                 background))


def make_train_step_pallas(optimizer, view, proj,
                           background=(0.0, 0.0, 0.0),
                           max_splats_per_tile: int = 256):
    """Single-device training step through the kernels (scales to 1M
    splats): ``step(params, target) -> loss``, as :func:`make_train_step`."""
    def loss_fn(params, target):
        img = render_diff_pallas(params, view, proj, target.shape[1],
                                 target.shape[0], background,
                                 max_splats_per_tile)
        return torch.mean((img - target) ** 2)
    return _step(optimizer, loss_fn)


def make_train_step_dp(optimizer, view, proj, mesh,
                       background=(0.0, 0.0, 0.0)):
    """Data-parallel training step over the 1-D device ``mesh``
    (``parallel.make_device_mesh``): ``step(params, target) -> loss``, as
    :func:`make_train_step`. Every rank passes the same parameters and the
    whole (replicated) target; rank r grades rows [r·H/D, (r+1)·H/D) with
    :func:`render_diff`, the band's loss and gradients are averaged over
    the mesh (``all_reduce`` SUM, then a division by D as a tensor), and
    every rank's optimizer takes the same step. Raises if the target's
    height is not divisible by D."""
    group, d, r = mesh.get_group(), mesh.size(), mesh.get_local_rank()

    def step(params: GaussianParams, target) -> torch.Tensor:
        h = target.shape[0]
        if h % d:
            raise ValueError(f"target height {h} not divisible by mesh {d}")
        band = h // d
        optimizer.zero_grad(set_to_none=True)
        loss = l2_loss(params, view, proj, target[r * band:(r + 1) * band],
                       background, y_offset=float(r * band),
                       full_height=h)
        loss.backward()
        # one all_reduce of the loss and every gradient, flattened
        ts = params.tensors()
        flat = torch.cat([loss.detach().reshape(1)]
                         + [t.grad.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / torch.full((), float(d), dtype=_F32,
                                 device=flat.device)
        off = 1
        for t in ts:
            t.grad.copy_(flat[off:off + t.numel()].view_as(t.grad))
            off += t.numel()
        optimizer.step()
        return flat[0]
    return step
