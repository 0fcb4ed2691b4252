"""Adaptive density control (ADC) for 3DGS training, the INRIA schedule
(counterpart of ``ray_eater_tpu/models/gs_densify.py``).

Splats whose view-space positional gradients stay large are cloned (if
small) or split (if large); near-transparent splats are pruned; opacities
are reset now and then so pruning can reclaim stale splats.

Shapes stay fixed, as in the JAX package: the parameters are allocated at
a ``capacity`` with a ``live`` mask, and dead slots carry near-zero opacity
and tiny scale, so they render to nothing. Densification ranks candidates
by their mean view-space gradient and enumerates dead slots with a second
stable argsort; the j-th best candidate's child goes to the j-th dead slot.

The optimizer holds the parameter tensors, so :func:`densify_and_prune`
and :func:`reset_opacity` write them in place, and :func:`reset_new_slots`
zeroes the Adam moments of newly allocated slots.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..ops.gs import quat_to_rotmat
from .gs_training import (GaussianParams, _leaves, render_diff,
                          render_diff_pallas)

_F32 = torch.float32
#: opacity logit of a dead slot: sigmoid(-12) ~ 6e-6, far below the
#: compositor's 1/255 alpha floor
_DEAD_LOGIT = -12.0
#: log-scale of a dead slot: exp(-14) ~ 8e-7 world units -> 0-px radius
_DEAD_LOG_SCALE = -14.0
#: INRIA split factor: children shrink by 1.6
_SPLIT_SHRINK = 1.6


@dataclass
class DensifyState:
    """Per-slot ADC bookkeeping, all (capacity,): ``live`` marks allocated
    slots, ``grad_accum`` sums view-space positional gradient norms since
    the last densify, ``grad_count`` counts the steps a splat received
    gradient."""
    live: torch.Tensor        # bool
    grad_accum: torch.Tensor  # f32
    grad_count: torch.Tensor  # f32


def init_densify_state(capacity: int, n_live: int,
                       device="cuda") -> DensifyState:
    return DensifyState(
        live=torch.arange(capacity, device=device) < n_live,
        grad_accum=torch.zeros(capacity, dtype=_F32, device=device),
        grad_count=torch.zeros(capacity, dtype=_F32, device=device))


def pad_params(params: GaussianParams, capacity: int) -> GaussianParams:
    """New parameters grown to ``capacity`` rows; the new rows are dead
    (near-zero opacity, tiny scale) and render to nothing."""
    n = params.means.shape[0]
    if n > capacity:
        raise ValueError(f"{n} splats exceed capacity {capacity}")
    pad = capacity - n

    def padded(a, fill):
        a = a.detach()
        return torch.cat([a, torch.full((pad, *a.shape[1:]), fill,
                                        dtype=a.dtype, device=a.device)])

    quats = padded(params.quats, 0.0)
    quats[n:, 0] = 1.0
    return _leaves(means=padded(params.means, 0.0),
                   log_scales=padded(params.log_scales, _DEAD_LOG_SCALE),
                   quats=quats,
                   opacity_logits=padded(params.opacity_logits, _DEAD_LOGIT),
                   colors=padded(params.colors, 0.0))


def accumulate_grad_stats(state: DensifyState,
                          mean2d_grad: torch.Tensor) -> DensifyState:
    """Fold one step's view-space positional gradient (N, 2) into the
    running statistics (INRIA sums the norm over steps where the splat was
    visible)."""
    norm = torch.linalg.norm(mean2d_grad, dim=-1)
    return DensifyState(live=state.live,
                        grad_accum=state.grad_accum + norm,
                        grad_count=state.grad_count + (norm > 0.0).to(_F32))


def _f32_log(x: float, dev) -> torch.Tensor:
    """log in float32 of float32 ``x`` (the JAX package's ``jnp.log`` of a
    Python float)."""
    return torch.log(torch.tensor(x, dtype=_F32, device=dev))


def _assign(params: GaussianParams, **new) -> None:
    with torch.no_grad():
        for k, v in new.items():
            getattr(params, k).copy_(v)


@torch.no_grad()
def densify_and_prune(params: GaussianParams, state: DensifyState,
                      generator: torch.Generator | None = None, *,
                      grad_threshold: float, scene_extent: float,
                      percent_dense: float = 0.01,
                      prune_opacity: float = 0.005,
                      prune_scale3d: float | None = None, noise=None):
    """One INRIA ADC pass, in place on ``params``.

    Splats whose mean accumulated view-space gradient exceeds
    ``grad_threshold`` spawn one child each, best-ranked first, while dead
    slots last: a clone (small splats: child at a ~0.3-sigma jitter, same
    size) or a split (large splats: parent and child both shrink by 1.6
    and move to independent samples of the parent Gaussian). Then splats
    below ``prune_opacity`` (and, with ``prune_scale3d``, world-size
    outliers above it) are killed, and the statistics reset.

    The normals come from ``generator`` (two (N, 3) draws), or from
    ``noise``, a pair of (N, 3) tensors given in their place (the tests
    hand the JAX draws over). Returns (params, state, stats) with device
    scalars ``n_clone``, ``n_split``, ``n_prune``, ``n_live``."""
    live0 = state.live
    n = live0.shape[0]
    dev = live0.device
    if noise is None:
        noise = tuple(torch.randn((n, 3), generator=generator, dtype=_F32,
                                  device=dev) for _ in range(2))
    eps, eps2 = noise
    avg = state.grad_accum / torch.clamp(state.grad_count, min=1.0)
    scales = torch.exp(params.log_scales)
    smax = torch.max(scales, dim=-1).values
    candidate = live0 & (avg > grad_threshold)
    is_small = smax <= percent_dense * scene_extent
    split_cand = candidate & ~is_small

    # rank candidates by gradient pressure; enumerate dead slots (stable,
    # as jnp.argsort)
    order = torch.argsort(torch.where(candidate, -avg, math.inf), stable=True)
    slot = torch.argsort(live0.to(torch.int8), stable=True)    # dead first
    n_dead = torch.sum(~live0)
    parent = order
    valid = (torch.arange(n, device=dev) < n_dead) & candidate[parent]
    split_p = split_cand[parent]

    # child position: a sample of the parent Gaussian (split) or a close
    # 0.3-sigma jitter (clone)
    rot = quat_to_rotmat(params.quats[parent])                 # (N, 3, 3)
    sigma_step = torch.einsum("nij,nj->ni", rot, scales[parent] * eps)
    child_off = torch.where(split_p[:, None], sigma_step, 0.3 * sigma_step)
    log_shrink = _f32_log(_SPLIT_SHRINK, dev)
    shrink = torch.where(split_p[:, None], log_shrink, 0.0)

    def scatter(arr, child_vals):
        v = torch.where(valid.reshape((n,) + (1,) * (arr.ndim - 1)),
                        child_vals, arr[slot])
        out = arr.clone()
        out[slot] = v
        return out

    new_means = scatter(params.means, params.means[parent] + child_off)
    new_logs = scatter(params.log_scales, params.log_scales[parent] - shrink)
    new_quats = scatter(params.quats, params.quats[parent])
    new_logits = scatter(params.opacity_logits,
                         params.opacity_logits[parent])
    new_colors = scatter(params.colors, params.colors[parent])
    live = live0.clone()
    live[slot] = valid | live0[slot]

    # split parents that got a child shrink and resample too
    parent_split = torch.zeros(n, dtype=torch.bool, device=dev)
    parent_split[parent] = valid & split_p
    rot_own = quat_to_rotmat(params.quats)
    own_step = torch.einsum("nij,nj->ni", rot_own,
                            torch.exp(params.log_scales) * eps2)
    new_means = torch.where(parent_split[:, None], new_means + own_step,
                            new_means)
    new_logs = torch.where(parent_split[:, None], new_logs - log_shrink,
                           new_logs)

    n_clone = torch.sum(valid & ~split_p)
    n_split = torch.sum(valid & split_p)

    # prune: transparent, and (optionally) world-size outliers
    dead = live & (torch.sigmoid(new_logits) < prune_opacity)
    if prune_scale3d is not None:
        dead = dead | (live & (torch.max(torch.exp(new_logs), -1).values
                               > prune_scale3d))
    live = live & ~dead
    new_logits = torch.where(live, new_logits, _DEAD_LOGIT)
    new_logs = torch.where(live[:, None], new_logs, _DEAD_LOG_SCALE)

    _assign(params, means=new_means, log_scales=new_logs, quats=new_quats,
            opacity_logits=new_logits, colors=new_colors)
    state = DensifyState(live=live,
                         grad_accum=torch.zeros(n, dtype=_F32, device=dev),
                         grad_count=torch.zeros(n, dtype=_F32, device=dev))
    stats = {"n_clone": n_clone, "n_split": n_split,
             "n_prune": torch.sum(dead), "n_live": torch.sum(live)}
    return params, state, stats


def reset_opacity(params: GaussianParams, state: DensifyState,
                  max_opacity: float = 0.01) -> GaussianParams:
    """INRIA opacity reset, in place: clamp every live splat's opacity to
    at most ``max_opacity``."""
    cap = _f32_log(max_opacity / (1.0 - max_opacity),
                   params.opacity_logits.device)
    _assign(params, opacity_logits=torch.where(
        state.live, torch.minimum(params.opacity_logits, cap),
        params.opacity_logits))
    return params


@torch.no_grad()
def reset_new_slots(optimizer: torch.optim.Optimizer,
                    prev_live: torch.Tensor, live: torch.Tensor) -> None:
    """Zero the Adam moments (``exp_avg``, ``exp_avg_sq``) of newly
    allocated slots, so a fresh splat does not inherit a dead slot's stale
    moments. Every state tensor whose leading dimension is the capacity is
    masked."""
    keep = ~(live & ~prev_live)
    n = keep.shape[0]
    for state in optimizer.state.values():
        for key in ("exp_avg", "exp_avg_sq"):
            m = state.get(key)
            if m is not None and m.ndim >= 1 and m.shape[0] == n:
                m.mul_(keep.reshape((n,) + (1,) * (m.ndim - 1)).to(m.dtype))


def make_train_step_adc(optimizer, width: int, height: int,
                        background=(0.0, 0.0, 0.0),
                        use_pallas: bool = False,
                        max_splats_per_tile: int = 256):
    """Training step that also accumulates the ADC statistics: the loss is
    differentiated w.r.t. the parameters and a zeros ``mean2d_offset``,
    whose gradient is the view-space positional gradient the densifier
    thresholds on. ``view``/``proj``/``target`` are step arguments.

    Returns ``step(params, dstate, target, view, proj) -> (dstate,
    loss)``; ``optimizer`` (over ``params.tensors()``) updates the
    parameters in place."""

    def step(params, dstate, target, view, proj):
        off = torch.zeros_like(params.means[:, :2]).requires_grad_(True)
        optimizer.zero_grad(set_to_none=True)
        if use_pallas:
            img = render_diff_pallas(params, view, proj, width, height,
                                     background, max_splats_per_tile,
                                     mean2d_offset=off)
        else:
            img = render_diff(params, view, proj, width, height, background,
                              mean2d_offset=off)
        loss = torch.mean((img - target) ** 2)
        loss.backward()
        goff = off.grad if off.grad is not None else torch.zeros_like(off)
        dstate = accumulate_grad_stats(dstate, goff)
        optimizer.step()
        return dstate, loss.detach()

    return step


def make_train_window_adc(optimizer, width: int, height: int,
                          background=(0.0, 0.0, 0.0),
                          use_pallas: bool = False,
                          max_splats_per_tile: int = 256,
                          nsteps: int = 100):
    """An ADC training window: ``nsteps`` consecutive steps of
    :func:`make_train_step_adc`, cycling the stacked training views, as a
    plain host loop (the JAX package runs it as one device loop; CUDA-graph
    capture is later work).

    Returns ``window(params, dstate, targets (V, H, W, 3), views (V, 4,
    4), proj, i0) -> (dstate, loss)``; step i uses view (i0 + i) % V and
    ``loss`` is the last step's."""
    inner = make_train_step_adc(optimizer, width, height, background,
                                use_pallas, max_splats_per_tile)

    def window(params, dstate, targets, views, proj, i0: int):
        loss = torch.zeros((), dtype=_F32, device=targets.device)
        nviews = targets.shape[0]
        for i in range(nsteps):
            k = (i0 + i) % nviews
            dstate, loss = inner(params, dstate, targets[k], views[k], proj)
        return dstate, loss

    return window
