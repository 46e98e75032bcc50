"""MLP parameter layout and the density activation.

Parameters are plain dicts ``{"w": [W_0, ...], "b": [b_0, ...]}`` with
``W_i`` of shape (in, out), the JAX package's layout, which is also the
layout the fused kernels read.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class MLPConfig:
    in_dim: int
    num_layers: int
    layer_width: int
    out_dim: int
    compute_dtype: str = "float32"

    @property
    def dims(self) -> tuple:
        return (
            (self.in_dim,)
            + (self.layer_width,) * (self.num_layers - 1)
            + (self.out_dim,)
        )


def mlp_init(config: MLPConfig, generator: torch.Generator, device) -> dict:
    """He-uniform weights, zero biases; layer ``i`` maps dims[i] -> dims[i+1].
    Drawn on the CPU from ``generator`` and moved to ``device``."""
    dims = config.dims
    params = {"w": [], "b": []}
    for i in range(len(dims) - 1):
        bound = (6.0 / dims[i]) ** 0.5
        w = torch.empty(dims[i], dims[i + 1]).uniform_(-bound, bound, generator=generator)
        params["w"].append(w.to(device))
        params["b"].append(torch.zeros(dims[i + 1], device=device))
    return params


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp_max(x, 11.0))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    """The nerfacto density activation: exp with its input clamped at 11 in
    the forward (density ~6e4 is opaque at any delta that matters, and a bare
    exp can overflow early in training); the backward is g * exp(clip(x, -15,
    15)), the usual trunc_exp gradient."""
    return _TruncExp.apply(x)
