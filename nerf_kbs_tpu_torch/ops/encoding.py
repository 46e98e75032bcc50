"""Field input encodings: the NeRF frequency encoding, multiscale Fourier
features (frequency matrix, coarse-to-fine window and the point-major
encoding of the non-fused path), the multiresolution hash grid, the
CP-decomposed line grid, and the spherical-harmonics view-direction encoding.

The hash grid keeps the JAX package's parameter layout: one flat 1-D table,
feature-major, entry (f, level, slot) at ``f * L * T + level * T + slot``, so
a JAX ``hash_table`` converts leaf for leaf. Its evaluation is a gather of the
8 corners of each level and a sum over the corners, one level at a time; the
table's gradient is the gather's, a scatter-add.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from nerf_kbs_tpu_torch.ops.fused_field import tri_c, tri_s


def _clip01(x: torch.Tensor) -> torch.Tensor:
    """x clamped into [0, 1] as ``jnp.clip`` clamps: a point exactly on a
    face gets half the gradient (maximum and minimum split it at a tie), where
    ``torch.clamp`` would pass all of it."""
    return torch.minimum(torch.maximum(x, x.new_zeros(())), x.new_ones(()))


def positional_encoding(x: torch.Tensor, num_frequencies: int, min_freq_exp: float = 0.0,
                        max_freq_exp: float | None = None,
                        include_input: bool = True) -> torch.Tensor:
    """NeRF frequency encoding [sin(2^k pi x), cos(2^k pi x)]_k of x (..., D):
    (..., D * num_frequencies * 2), with x in front when ``include_input``."""
    if max_freq_exp is None:
        max_freq_exp = float(num_frequencies - 1)
    # f32 exponents as jnp.linspace gives them, then 2 ** in f32
    exps = torch.linspace(min_freq_exp, max_freq_exp, num_frequencies, dtype=torch.float32,
                          device=x.device)
    freqs = 2.0 ** exps
    xb = x[..., None, :] * freqs[:, None] * math.pi  # (..., F, D)
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1).reshape(*x.shape[:-1], -1)
    return torch.cat([x, enc], dim=-1) if include_input else enc


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


def fourier_encoding_apply(B: torch.Tensor, positions: torch.Tensor,
                           config: FourierEncodingConfig,
                           window: torch.Tensor | None = None) -> torch.Tensor:
    """The non-fused path's Fourier features: positions (..., 3) in [0, 1]^3
    -> (..., output_dim), [sin | cos] of positions @ B (times 2 pi after the
    product for sincos; in cycles for tri), each times ``window`` when given.
    B is frozen (detached)."""
    B = B.detach()
    if config.basis == "tri":
        proj = torch.matmul(positions, B)
        sin, cos = tri_s(proj), tri_c(proj)
    else:
        proj = (2.0 * math.pi) * torch.matmul(positions, B)
        sin, cos = torch.sin(proj), torch.cos(proj)
    if window is not None:
        sin = sin * window
        cos = cos * window
    return torch.cat([sin, cos], dim=-1)


# ---------------------------------------------------------------------------
# multiresolution hash grid
# ---------------------------------------------------------------------------

_PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class HashEncodingConfig:
    """Grid hyperparameters (nerfacto's field: 16 levels of 2 features, a
    2^19 table, resolutions 16 to 2048; its proposal fields 5 levels, 2^17,
    16 to 128 or 256)."""

    num_levels: int = 16
    features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    max_resolution: int = 2048

    @property
    def table_size(self) -> int:
        return 1 << self.log2_hashmap_size

    @property
    def growth_factor(self) -> float:
        if self.num_levels == 1:
            return 1.0
        return float(
            np.exp(
                (np.log(self.max_resolution) - np.log(self.base_resolution))
                / (self.num_levels - 1)
            )
        )

    @property
    def resolutions(self) -> tuple:
        g = self.growth_factor
        return tuple(
            int(np.floor(self.base_resolution * g**lvl)) for lvl in range(self.num_levels)
        )

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level


def hash_encoding_init(config: HashEncodingConfig, generator: torch.Generator,
                       device) -> torch.Tensor:
    """The flat feature-major table (F * L * T,), uniform in [-1e-4, 1e-4],
    drawn on the CPU from ``generator`` and moved to ``device``."""
    n = config.features_per_level * config.num_levels * config.table_size
    return torch.empty(n).uniform_(-1e-4, 1e-4, generator=generator).to(device)


def _level_corners(p: torch.Tensor, res: int, table_size: int):
    """Corner indices (B, 8) int64 within one level's T slots and the
    trilinear weights (B, 8) f32 of points p (B, 3) in [0, 1]; corner c sits
    at offset (c & 1, (c >> 1) & 1, (c >> 2) & 1) from the cell's origin. A
    level whose dense grid fits the table ((res + 1)^3 <= T) is indexed
    directly, cx + r1 (cy + r1 cz); a finer one by the spatial hash
    (cx * 1) ^ (cy * 2654435761) ^ (cz * 805459861) masked by T - 1, in int64:
    its low 32 bits are the uint32 product's, and the mask keeps no others.
    The corners are an outer product of the two choices along each axis, so
    no (B, 8, 3) tensor is formed."""
    ps = p * res
    fl = torch.floor(ps)
    frac = ps - fl
    base = fl.to(torch.int64)
    # per axis d, the two choices (offset 0, offset 1) on axis 1 + (2 - d) of
    # a (B, 2, 2, 2) grid indexed [z, y, x], so that flat index = corner c
    def axis(t, d):
        shape = [t.shape[0], 1, 1, 1]
        shape[3 - d] = 2
        return t.reshape(shape)

    c = [axis(torch.stack([base[:, d], base[:, d] + 1], dim=-1), d) for d in range(3)]
    w = [axis(torch.stack([1.0 - frac[:, d], frac[:, d]], dim=-1), d) for d in range(3)]
    weights = (w[0] * w[1] * w[2]).reshape(-1, 8)
    if (res + 1) ** 3 <= table_size:
        r1 = res + 1
        idx = c[0] + r1 * (c[1] + r1 * c[2])
    else:
        idx = (c[0] * _PRIMES[0]) ^ (c[1] * _PRIMES[1]) ^ (c[2] * _PRIMES[2])
        idx = idx & (table_size - 1)
    return idx.reshape(-1, 8), weights


def hash_encoding_apply(table: torch.Tensor, positions: torch.Tensor,
                        config: HashEncodingConfig) -> torch.Tensor:
    """Encode positions (..., 3) -> (..., num_levels * features_per_level),
    level-major (level l's F features at columns l*F .. l*F + F - 1).

    Positions are clamped into [0, 1] first: an outside point reads its edge
    cell (a caller that wants zero density outside multiplies a selector on
    the density, as ``models.fields`` does). Each level gathers its 8 corners'
    features from the table and sums them with the trilinear weights; one
    level at a time, so no intermediate grows with the number of levels."""
    L, F, T = config.num_levels, config.features_per_level, config.table_size
    batch_shape = positions.shape[:-1]
    p = _clip01(positions.reshape(-1, 3).float())
    n = p.shape[0]
    rows = table.view(F, L * T)  # row f: feature f of every level's slots
    feats = []
    for lvl, res in enumerate(config.resolutions):
        idx, w = _level_corners(p, res, T)
        r1 = res + 1
        if r1**3 <= T and lvl * T + r1 * (1 + r1 + r1 * r1) > L * T - 1:
            # a point on the far face reaches corner res + 1 (weight 0); keep
            # its index inside the table
            idx = idx.clamp_max(L * T - 1 - lvl * T)
        g = rows.index_select(1, (idx + lvl * T).reshape(-1)).view(F, n, 8)
        feats.append(torch.sum(g * w[None], dim=-1).T)  # (B, F)
    return torch.cat(feats, dim=-1).reshape(*batch_shape, config.output_dim)


# ---------------------------------------------------------------------------
# CP-decomposed line grid
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CPEncodingConfig:
    num_levels: int = 8
    features_per_level: int = 16
    base_resolution: int = 16
    max_resolution: int = 512

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def resolutions(self) -> tuple:
        if self.num_levels == 1:
            return (self.base_resolution,)
        g = float(
            np.exp(
                (np.log(self.max_resolution) - np.log(self.base_resolution))
                / (self.num_levels - 1)
            )
        )
        return tuple(int(np.floor(self.base_resolution * g**l)) for l in range(self.num_levels))


def cp_encoding_init(config: CPEncodingConfig, generator: torch.Generator, device) -> list:
    """Per level a (3, res + 1, F) table of per-axis line features, 1 + 0.1 N(0, 1),
    drawn on the CPU from ``generator`` and moved to ``device``."""
    return [
        (1.0 + 0.1 * torch.randn(3, res + 1, config.features_per_level,
                                 generator=generator)).to(device)
        for res in config.resolutions
    ]


def _hat_weights(x: torch.Tensor, res: int) -> torch.Tensor:
    """(B,) coordinates in [0, 1] -> (B, res + 1) linear interpolation
    weights, max(0, 1 - |x res - i|): two adjacent nonzeros a row. The
    gradient at the kinks is JAX's: |.| has slope 1 at 0 and the maximum
    splits its gradient at a tie (``torch.abs`` would give slope 0)."""
    g = x[:, None] * res
    idx = torch.arange(res + 1, dtype=torch.float32, device=x.device)[None, :]
    d = g - idx
    return torch.maximum(x.new_zeros(()), 1.0 - torch.where(d >= 0, d, -d))


def cp_encoding_apply(tables: list, positions: torch.Tensor,
                      config: CPEncodingConfig) -> torch.Tensor:
    """positions (..., 3), clamped into [0, 1] -> (..., num_levels * F): per
    level the product over the axes of hat(x_axis) @ line table."""
    batch_shape = positions.shape[:-1]
    p = _clip01(positions.reshape(-1, 3).float())
    outs = []
    for table, res in zip(tables, config.resolutions):
        feat = None
        for d in range(3):
            v = _hat_weights(p[:, d], res) @ table[d]  # (B, F)
            feat = v if feat is None else feat * v
        outs.append(feat)
    return torch.cat(outs, dim=-1).reshape(*batch_shape, config.output_dim)


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
