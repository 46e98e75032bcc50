"""MLP parameter layout, the plain MLPs and the density activation.

Parameters are plain dicts ``{"w": [W_0, ...], "b": [b_0, ...]}`` with
``W_i`` of shape (in, out), the JAX package's layout, which is also the
layout the fused kernels read.

``mlp_apply_t`` and ``mlp_apply`` are the MLPs that run outside the fused
kernels (the split field's heads, the non-fused fields, vanilla NeRF), with
the JAX package's rounding points: the input and every hidden activation are cast to
the compute dtype, the weights too, products accumulate in f32 and the bias
is added in f32. A product of two bf16 values is exact in f32, so an f32
matrix product of rounded operands is that computation.
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
    out_activation: str | None = None  # None or 'sigmoid'
    # layers whose input is [h, x]: the MLP's input concatenated again
    skip_connections: tuple = ()

    @property
    def dims(self) -> tuple:
        return (
            (self.in_dim,)
            + (self.layer_width,) * (self.num_layers - 1)
            + (self.out_dim,)
        )


def mlp_init(config: MLPConfig, generator: torch.Generator, device) -> dict:
    """He-uniform weights, zero biases; layer ``i`` maps dims[i] -> dims[i+1],
    a skip layer dims[i] + in_dim -> dims[i+1]. Drawn on the CPU from
    ``generator`` and moved to ``device``."""
    dims = config.dims
    params = {"w": [], "b": []}
    for i in range(len(dims) - 1):
        fan_in = dims[i] + (config.in_dim if i in config.skip_connections else 0)
        bound = (6.0 / fan_in) ** 0.5
        w = torch.empty(fan_in, dims[i + 1]).uniform_(-bound, bound, generator=generator)
        params["w"].append(w.to(device))
        params["b"].append(torch.zeros(dims[i + 1], device=device))
    return params


def _cast(t: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    """Round to the compute dtype and go on in f32."""
    return t.to(torch.bfloat16).float() if compute_dtype == "bfloat16" else t


def _out_act(h: torch.Tensor, config: MLPConfig) -> torch.Tensor:
    if config.out_activation is None:
        return h
    if config.out_activation == "sigmoid":
        return torch.sigmoid(h)
    raise ValueError(f"unknown out_activation {config.out_activation!r}")


def mlp_apply_t(params: dict, x_t: torch.Tensor, config: MLPConfig) -> torch.Tensor:
    """Feature-major relu MLP: x_t (in_dim, N) -> (out_dim, N) f32."""
    x_t = _cast(x_t, config.compute_dtype)
    h = x_t
    n = len(params["w"])
    for i in range(n):
        if i in config.skip_connections:
            h = torch.cat([h, x_t], dim=0)
        h = _cast(params["w"][i], config.compute_dtype).T @ h + params["b"][i][:, None]
        if i < n - 1:
            h = _cast(torch.relu(h), config.compute_dtype)
    return _out_act(h, config)


def mlp_apply(params: dict, x: torch.Tensor, config: MLPConfig) -> torch.Tensor:
    """Point-major relu MLP: x (..., in_dim) -> (..., out_dim) f32."""
    x = _cast(x, config.compute_dtype)
    h = x
    n = len(params["w"])
    for i in range(n):
        if i in config.skip_connections:
            h = torch.cat([h, x], dim=-1)
        h = h @ _cast(params["w"][i], config.compute_dtype) + params["b"][i]
        if i < n - 1:
            h = _cast(torch.relu(h), config.compute_dtype)
    return _out_act(h, config)


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
