"""Ray samplers: the initial stratified sampler, inverse-CDF resampling and
the proposal chain, at eval (evenly spaced, no jitter) and in training
(jittered, optionally detached).

Jitter comes from an explicit ``torch.Generator`` (drawn on the generator's
device and moved) or is handed in as tensors, so that two implementations can
be fed the same numbers.

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

    def positions(self, rays) -> torch.Tensor:
        """(R, S, 3) point-major sample positions at interval midpoints."""
        return rays.origins[..., None, :] + rays.directions[..., None, :] * self.midpoints[..., None]

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


def _uniform(shape, generator: torch.Generator, device) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device).to(device)


def uniform_sampler(rays, num_samples: int, spacing: str = "piecewise", generator=None,
                    single_jitter: bool = True, jitter=None) -> RaySamples:
    """num_samples intervals with edges evenly spaced in the spacing domain.
    With a ``generator`` or a ``jitter`` tensor in [0, 1) ((R, 1) under
    ``single_jitter``, else (R, num_samples + 1)) each edge moves within half
    a bin on either side, so edges stay sorted; with neither, no jitter (the
    eval sampler). Rays need nears/fars from a collider."""
    R = rays.origins.shape[0]
    dev = rays.origins.device
    edges = torch.linspace(0.0, 1.0, num_samples + 1, device=dev).expand(R, num_samples + 1)
    if jitter is None and generator is not None:
        jitter = _uniform((R, 1) if single_jitter else (R, num_samples + 1), generator, dev)
    if jitter is not None:
        centers = (edges[..., :-1] + edges[..., 1:]) / 2.0
        lower = torch.cat([edges[..., :1], centers], dim=-1)
        upper = torch.cat([centers, edges[..., -1:]], dim=-1)
        edges = lower + (upper - lower) * jitter
    return _samples(rays, edges, spacing)


def _bracket_values(cdf: torch.Tensor, edges: torch.Tensor, u: torch.Tensor):
    """With b(q) = max{s : cdf_s <= u_q}, returns (cdf_b, cdf_{b+1}, edge_b,
    edge_{b+1}), each (R, Q). Needs 0 = cdf_0 <= u <= cdf_last = 1 and sorted
    rows, which pdf_sampler guarantees. The index search carries no
    gradient; the gathers scatter the cotangents back to cdf and edges at b
    and b + 1."""
    # a jittered quantile can round up to 1.0 = cdf_last: it then belongs to
    # the last bin, as the masked reductions of the JAX package place it
    b = torch.clamp_max(torch.searchsorted(cdf.detach(), u, right=True) - 1, cdf.shape[1] - 2)
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
    generator=None,
    single_jitter: bool = True,
    rand=None,
    stop_grad: bool = False,
    include_original: bool = False,
) -> RaySamples:
    """Inverse-CDF resampling of ``num_samples`` intervals from per-bin
    ``weights`` (R, S_old), in the spacing domain: at evenly spaced quantiles
    (eval), or offset by ``rand`` / a draw from ``generator`` in [0, 1)
    ((R, 1) under ``single_jitter``, else (R, num_samples + 1)), scaled to one
    bin. ``stop_grad`` detaches weights and samples first: the proposal nets
    then learn only through the interlevel loss and every later position is
    a constant. ``include_original`` merges the old bin edges into the new
    ones, sorted (vanilla NeRF's fine samples: coarse + importance)."""
    if stop_grad:
        weights = weights.detach()
        ray_samples = RaySamples(**{f.name: getattr(ray_samples, f.name).detach()
                                    for f in dataclasses.fields(ray_samples)})
    R = weights.shape[0]
    dev = weights.device
    weights = weights + histogram_padding  # per bin
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.clamp_max(torch.cumsum(pdf, dim=-1), 1.0)
    # first entry 0, last entry exactly 1: constants, so the last bin's
    # cumulative sum gets no gradient
    cdf = torch.cat([torch.zeros(R, 1, device=dev), cdf[:, :-1], torch.ones(R, 1, device=dev)],
                    dim=-1)

    num_bins = num_samples + 1
    u = torch.linspace(0.0, 1.0 - 1.0 / num_bins, num_bins, device=dev)
    if rand is None and generator is not None:
        rand = _uniform((R, 1) if single_jitter else (R, num_bins), generator, dev)
    if rand is not None:
        u = u[None, :] + rand / num_bins
    else:
        u = u + 0.5 / num_bins
    u = u.expand(R, num_bins).contiguous()
    edges = torch.cat([ray_samples.spacing_starts, ray_samples.spacing_ends[..., -1:]], -1)
    cdf_lo, cdf_hi, edge_lo, edge_hi = _bracket_values(cdf, edges, u)
    denom = torch.clamp_min(cdf_hi - cdf_lo, 1e-10)
    frac = torch.clamp((u - cdf_lo) / denom, 0.0, 1.0)
    new_edges = edge_lo + frac * (edge_hi - edge_lo)
    # monotone up to float rounding; the running max removes the wiggle
    new_edges = torch.cummax(new_edges, dim=1).values
    if include_original:
        new_edges = torch.sort(torch.cat([edges, new_edges], dim=-1), dim=-1).values
    return _samples(rays, new_edges, spacing)


def anneal_weights(weights: torch.Tensor, anneal: float) -> torch.Tensor:
    """weights ** anneal, with weights clamped at 1e-10 first (also at
    anneal = 1)."""
    return torch.pow(torch.clamp_min(weights, 1e-10), anneal)


def anneal_schedule(step: float, max_iters: int = 1000, slope: float = 10.0) -> float:
    """Proposal-weight anneal exponent: ramps 0 -> 1 over ``max_iters`` steps
    with bias ``slope``."""
    train_frac = min(max(float(step) / max_iters, 0.0), 1.0)
    return (slope * train_frac) / ((slope - 1.0) * train_frac + 1.0)


def proposal_sample(
    rays,
    density_fns: list[Callable[[torch.Tensor], torch.Tensor]],
    num_proposal_samples: tuple,
    num_nerf_samples: int,
    spacing: str = "piecewise",
    anneal: float = 1.0,
    generator=None,
    single_jitter: bool = True,
    jitters=None,
    stop_grad: bool = False,
    positions_of: Callable | None = None,
):
    """The proposal chain: uniform samples -> per round, density from
    ``density_fns[i]`` on the round's positions -> annealed PDF resample. The
    positions are point-major (R, S, 3) unless ``positions_of`` (samples ->
    positions) gives another layout: the fused fields take
    ``lambda s: s.positions_t(rays)``, (3, R, S).
    Jitter (training) comes from ``generator`` or from ``jitters``, a list of
    rounds + 1 tensors in [0, 1): the first for the uniform sampler, then one
    per resample. ``stop_grad`` detaches every resample; the history keeps
    the weights from before the detach, so the interlevel loss still trains
    the proposal networks. Returns (final RaySamples, [(RaySamples, weights)
    per round])."""
    if positions_of is None:
        positions_of = lambda s: s.positions(rays)  # noqa: E731
    rounds = len(num_proposal_samples)
    if jitters is None:
        jitters = [None] * (rounds + 1)
    samples = uniform_sampler(rays, num_proposal_samples[0], spacing=spacing,
                              generator=generator, single_jitter=single_jitter,
                              jitter=jitters[0])
    history = []
    for i in range(rounds):
        density = density_fns[i](positions_of(samples))
        weights = render_weights(density, samples.deltas)
        history.append((samples, weights))
        n_next = num_proposal_samples[i + 1] if i + 1 < rounds else num_nerf_samples
        samples = pdf_sampler(rays, samples, anneal_weights(weights, anneal), n_next, spacing,
                              generator=generator, single_jitter=single_jitter,
                              rand=jitters[i + 1], stop_grad=stop_grad)
    return samples, history
