"""Field input encodings: multiscale Fourier features (frequency matrix and
coarse-to-fine window) and the spherical-harmonics view-direction encoding."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FourierEncodingConfig:
    num_levels: int = 8
    features_per_level: int = 32  # sin+cos pairs per level (must be even)
    base_resolution: int = 16
    max_resolution: int = 2048
    # 'sincos' (B scaled by 2*pi at use) or 'tri' (triangle-wave pair, B in cycles)
    basis: str = "sincos"

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def resolutions(self) -> tuple:
        if self.num_levels == 1:
            return (float(self.base_resolution),)
        g = float(
            np.exp(
                (np.log(self.max_resolution) - np.log(self.base_resolution))
                / (self.num_levels - 1)
            )
        )
        return tuple(self.base_resolution * g**l for l in range(self.num_levels))


def fourier_encoding_init(
    config: FourierEncodingConfig, generator: torch.Generator, device
) -> torch.Tensor:
    """Frequency matrix B (3, output_dim / 2): per level, random unit
    directions scaled by the level resolution (cycles across the unit cube).
    Drawn on the CPU from ``generator`` and moved to ``device``."""
    if config.features_per_level % 2:
        raise ValueError(
            f"fourier features_per_level must be even (quadrature pairs), got "
            f"{config.features_per_level}"
        )
    half = config.features_per_level // 2
    dirs = torch.randn(3, config.num_levels * half, generator=generator)
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=0, keepdim=True)
    scales = torch.tensor(config.resolutions, dtype=torch.float32).repeat_interleave(half)
    return (dirs * scales[None, :]).to(device)


def fourier_window(config: FourierEncodingConfig, progress: float, device) -> torch.Tensor:
    """Coarse-to-fine frequency window: per-frequency weights in [0, 1];
    progress in [0, 1] opens the levels coarse to fine with a cosine ease."""
    L = config.num_levels
    half = config.features_per_level // 2
    lvl = torch.arange(L, dtype=torch.float32, device=device).repeat_interleave(half)
    x = torch.clamp(float(progress) * L - lvl, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * x))


def sh_encoding(dirs: torch.Tensor, levels: int = 4) -> torch.Tensor:
    """Real spherical harmonics of unit directions (..., 3) up to degree
    ``levels - 1``: (..., levels**2)."""
    if not 1 <= levels <= 4:
        raise ValueError("sh_encoding supports 1..4 levels")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    comps = [torch.full_like(x, 0.28209479177387814)]
    if levels > 1:
        comps += [
            -0.48860251190291987 * y,
            0.48860251190291987 * z,
            -0.48860251190291987 * x,
        ]
    if levels > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.94617469575755997 * zz - 0.31539156525251999,
            -1.0925484305920792 * xz,
            0.54627421529603959 * (xx - yy),
        ]
    if levels > 3:
        comps += [
            0.59004358992664352 * y * (-3.0 * xx + yy),
            2.8906114426405538 * xy * z,
            0.45704579946446572 * y * (1.0 - 5.0 * zz),
            0.3731763325901154 * z * (5.0 * zz - 3.0),
            0.45704579946446572 * x * (1.0 - 5.0 * zz),
            1.4453057213202769 * z * (xx - yy),
            0.59004358992664352 * x * (-xx + 3.0 * yy),
        ]
    return torch.stack(comps, dim=-1)
