"""Volume rendering: compositing weights, accumulation, depths and the
near/far collider. Sample tensors are (R, S)."""

from __future__ import annotations

import dataclasses

import torch


def render_weights(density: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """w_i = T_i (1 - exp(-sigma_i delta_i)), T_i = exp(-sum_{j<i} sigma_j
    delta_j) (the exclusive cumulative sum)."""
    tau = density * deltas
    alpha = 1.0 - torch.exp(-tau)
    accum = torch.cumsum(tau, dim=-1)
    trans = torch.exp(-(accum - tau))
    return alpha * trans


def render_accumulation(weights: torch.Tensor) -> torch.Tensor:
    return torch.sum(weights, dim=-1, keepdim=True)


def render_expected_depth(weights: torch.Tensor, ray_samples) -> torch.Tensor:
    """Weighted mean of the sample midpoints, normalised by accumulation and
    clipped into the sampled range."""
    steps = ray_samples.midpoints
    acc = torch.sum(weights, dim=-1, keepdim=True)
    depth = torch.sum(weights * steps, dim=-1, keepdim=True) / (acc + 1e-10)
    return torch.clamp(depth, steps[..., :1], steps[..., -1:])


def render_median_depth(weights: torch.Tensor, ray_samples) -> torch.Tensor:
    """Midpoint where the cumulative weight first reaches 0.5 (the smallest
    midpoint among those past the crossing); rays that never cross take the
    last midpoint."""
    steps = ray_samples.midpoints
    cum = torch.cumsum(weights, dim=-1)
    masked = torch.where(cum >= 0.5, steps, steps[..., -1:])
    return torch.amin(masked, dim=-1, keepdim=True)


def near_far_collider(rays, near: float, far: float):
    """Constant near and far planes for every ray."""
    shape = rays.origins.shape[:-1] + (1,)
    dev = rays.origins.device
    return dataclasses.replace(
        rays,
        nears=torch.full(shape, near, dtype=torch.float32, device=dev),
        fars=torch.full(shape, far, dtype=torch.float32, device=dev),
    )
