"""Ray samplers at eval: the initial stratified sampler, inverse-CDF
resampling and the proposal chain (forward only).

Sampling works in a normalised spacing domain s in [0, 1] with a fixed warp
to euclidean distance t ('uniform', 'lindisp', or 'piecewise': linear over
[near, near + 1] for s < 0.5, then linear in 1/t out to far).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from nerf_kbs_tpu_torch.ops.rendering import render_weights


@dataclasses.dataclass
class RaySamples:
    """Per-ray sample intervals, each (R, S): bin edges in the spacing domain
    and the matching euclidean distances along the ray."""

    spacing_starts: torch.Tensor
    spacing_ends: torch.Tensor
    starts: torch.Tensor
    ends: torch.Tensor

    @property
    def deltas(self) -> torch.Tensor:
        return self.ends - self.starts

    @property
    def midpoints(self) -> torch.Tensor:
        return 0.5 * (self.starts + self.ends)

    def positions_t(self, rays) -> torch.Tensor:
        """(3, R, S) coordinate-major sample positions at interval midpoints,
        the layout the fused fields take."""
        return (
            rays.origins.T[:, :, None]
            + rays.directions.T[:, :, None] * self.midpoints[None, :, :]
        )


def spacing_to_euclidean(s, nears, fars, kind: str):
    """Map spacing s in [0, 1] (broadcast over rays) to euclidean t."""
    if kind == "uniform":
        return nears + s * (fars - nears)
    if kind == "lindisp":
        return 1.0 / (1.0 / nears * (1.0 - s) + 1.0 / fars * s)
    if kind == "piecewise":
        mid = nears + 1.0
        lin = nears + s * 2.0
        inv = 1.0 / (1.0 / mid * (2.0 - 2.0 * s) + 1.0 / fars * (2.0 * s - 1.0))
        return torch.where(s < 0.5, lin, inv)
    raise ValueError(kind)


def _samples(rays, s_edges: torch.Tensor, spacing: str) -> RaySamples:
    s_starts, s_ends = s_edges[..., :-1], s_edges[..., 1:]
    return RaySamples(
        spacing_starts=s_starts,
        spacing_ends=s_ends,
        starts=spacing_to_euclidean(s_starts, rays.nears, rays.fars, spacing),
        ends=spacing_to_euclidean(s_ends, rays.nears, rays.fars, spacing),
    )


def uniform_sampler(rays, num_samples: int, spacing: str = "piecewise") -> RaySamples:
    """num_samples intervals with edges evenly spaced in the spacing domain
    (the eval sampler: no jitter). Rays need nears/fars from a collider."""
    R = rays.origins.shape[0]
    edges = torch.linspace(0.0, 1.0, num_samples + 1, device=rays.origins.device)
    return _samples(rays, edges.expand(R, num_samples + 1), spacing)


def _bracket_values(cdf: torch.Tensor, edges: torch.Tensor, u: torch.Tensor):
    """With b(q) = max{s : cdf_s <= u_q}, returns (cdf_b, cdf_{b+1}, edge_b,
    edge_{b+1}), each (R, Q). Needs 0 = cdf_0 <= u < cdf_last = 1 and sorted
    rows, which pdf_sampler guarantees."""
    b = torch.searchsorted(cdf, u, right=True) - 1
    b1 = b + 1
    return (
        torch.gather(cdf, 1, b), torch.gather(cdf, 1, b1),
        torch.gather(edges, 1, b), torch.gather(edges, 1, b1),
    )


def pdf_sampler(
    rays,
    ray_samples: RaySamples,
    weights: torch.Tensor,
    num_samples: int,
    spacing: str,
    histogram_padding: float = 0.01,
) -> RaySamples:
    """Inverse-CDF resampling of ``num_samples`` intervals from per-bin
    ``weights`` (R, S_old), in the spacing domain, at the eval's evenly
    spaced quantiles."""
    R = weights.shape[0]
    dev = weights.device
    weights = weights + histogram_padding  # per bin
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cat([torch.zeros(R, 1, device=dev), torch.cumsum(pdf, dim=-1)], dim=-1)
    cdf = torch.clamp_max(cdf, 1.0)
    cdf[:, -1] = 1.0

    num_bins = num_samples + 1
    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, device=dev) + 0.5 / num_bins
    u = u.expand(R, num_bins).contiguous()
    edges = torch.cat([ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], -1)
    cdf_lo, cdf_hi, edge_lo, edge_hi = _bracket_values(cdf, edges, u)
    denom = torch.clamp_min(cdf_hi - cdf_lo, 1e-10)
    frac = torch.clamp((u - cdf_lo) / denom, 0.0, 1.0)
    new_edges = edge_lo + frac * (edge_hi - edge_lo)
    # monotone up to float rounding; the running max removes the wiggle
    new_edges = torch.cummax(new_edges, dim=1).values
    return _samples(rays, new_edges, spacing)


def anneal_weights(weights: torch.Tensor, anneal: float) -> torch.Tensor:
    """weights ** anneal, with weights clamped at 1e-10 first (also at
    anneal = 1)."""
    return torch.pow(torch.clamp_min(weights, 1e-10), anneal)


def proposal_sample(
    rays,
    density_fns: list[Callable[[torch.Tensor], torch.Tensor]],
    num_proposal_samples: tuple,
    num_nerf_samples: int,
    spacing: str = "piecewise",
    anneal: float = 1.0,
):
    """The proposal chain at eval: uniform samples -> per round, density
    from ``density_fns[i]`` on (3, R, S) positions -> annealed PDF resample.
    Returns (final RaySamples, [(RaySamples, weights) per round])."""
    samples = uniform_sampler(rays, num_proposal_samples[0], spacing=spacing)
    history = []
    rounds = len(num_proposal_samples)
    for i in range(rounds):
        density = density_fns[i](samples.positions_t(rays))
        weights = render_weights(density, samples.deltas)
        history.append((samples, weights))
        n_next = num_proposal_samples[i + 1] if i + 1 < rounds else num_nerf_samples
        samples = pdf_sampler(rays, samples, anneal_weights(weights, anneal), n_next, spacing)
    return samples, history
