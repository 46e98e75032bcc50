"""Volume rendering: compositing weights, the renderer heads (rgb with its
background models, accumulation, depths, semantics, normals, uncertainty) and
the colliders (near/far planes, the ray-box intersection). Sample tensors are
(R, S), per-sample values (R, S, C)."""

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


def accumulate(weights: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """sum_i w_i v_i over the sample axis: weights (R, S), values (R, S, C)."""
    return torch.sum(weights[..., None] * values, dim=-2)


def render_rgb(weights: torch.Tensor, rgb: torch.Tensor, background: str = "last_sample",
               bg_color: torch.Tensor | None = None) -> torch.Tensor:
    """Composite rgb (R, S, 3) over a background: 'last_sample' (the last
    sample's colour), 'white', 'black' or 'color' (``bg_color``, broadcast)."""
    comp = accumulate(weights, rgb)
    acc = torch.sum(weights, dim=-1, keepdim=True)
    if background == "last_sample":
        bg = rgb[..., -1, :]
    elif background == "white":
        bg = torch.ones_like(comp)
    elif background == "black":
        bg = torch.zeros_like(comp)
    elif background == "color":
        bg = torch.as_tensor(bg_color, dtype=comp.dtype, device=comp.device).expand_as(comp)
    else:
        raise ValueError(f"unknown background_color {background!r}")
    return comp + bg * (1.0 - acc)


def render_semantics(weights: torch.Tensor, sem_logits: torch.Tensor,
                     pass_gradients: bool = False) -> torch.Tensor:
    """Composite per-sample logits (R, S, K) -> (R, K), with the weights
    detached unless ``pass_gradients``."""
    return accumulate(weights if pass_gradients else weights.detach(), sem_logits)


def render_uncertainty(weights: torch.Tensor, betas: torch.Tensor) -> torch.Tensor:
    """Composite per-sample uncertainty (R, S) -> (R, 1), weights detached."""
    return torch.sum(weights.detach() * betas, dim=-1, keepdim=True)


def render_normals(weights: torch.Tensor, normals: torch.Tensor) -> torch.Tensor:
    """Composite normals (R, S, 3) -> (R, 3), scaled to unit length."""
    n = accumulate(weights, normals)
    return n / (torch.linalg.vector_norm(n, dim=-1, keepdim=True) + 1e-10)


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


def aabb_box_collider(rays, aabb: torch.Tensor, near_plane: float = 0.0):
    """Near and far from each ray's intersection with the box ``aabb`` (2, 3):
    a direction component under 1e-10 in magnitude counts as +1e-10, the
    near side is at least ``near_plane``, and a ray that misses gets near =
    ``near_plane`` and far = ``near_plane + 1e-4``."""
    d = rays.directions
    inv_d = 1.0 / torch.where(d.abs() < 1e-10, torch.full_like(d, 1e-10), d)
    t0 = (aabb[0] - rays.origins) * inv_d
    t1 = (aabb[1] - rays.origins) * inv_d
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1, keepdim=True)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1, keepdim=True)
    tmin = torch.clamp_min(tmin, near_plane)
    hit = tmax > tmin
    return dataclasses.replace(
        rays,
        nears=torch.where(hit, tmin, torch.full_like(tmin, near_plane)),
        fars=torch.where(hit, tmax, torch.full_like(tmax, near_plane + 1e-4)),
    )
