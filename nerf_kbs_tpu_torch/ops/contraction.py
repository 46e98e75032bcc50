"""Scene contraction and spatial normalisation.

nerfacto evaluates its fields under a scene contraction with the L-inf order:
points inside the unit ball keep their place, points outside map to radius
2 - 1/r, so all of space lands in [-2, 2]^3, which the affine map
(x + 2) / 4 squeezes into [0, 1]^3. A field with the contraction disabled
maps its box (the scene box, [-1, 1]^3) affinely onto [0, 1]^3 instead
(``normalize_aabb``).
"""

from __future__ import annotations

import torch


def _contract(x: torch.Tensor, mag: torch.Tensor) -> torch.Tensor:
    mag = mag.clamp_min(1e-9)
    return torch.where(mag <= 1.0, x, (2.0 - 1.0 / mag) * (x / mag))


def scene_contraction(x: torch.Tensor, order: float | None = None) -> torch.Tensor:
    """Contract R^3 into the ball of radius 2, on the last axis of x (..., 3):
    order None or 2 measures the L2 norm, ``float("inf")`` the L-inf norm."""
    if order is None:
        order = 2
    if order == float("inf"):
        mag = x.abs().amax(dim=-1, keepdim=True)
    else:
        mag = torch.linalg.vector_norm(x, ord=order, dim=-1, keepdim=True)
    return _contract(x, mag)


def contract_to_unit_cube(x: torch.Tensor, order: float | None = float("inf")) -> torch.Tensor:
    """Point-major positions (..., 3): the contraction, then [-2, 2] -> [0, 1]."""
    return (scene_contraction(x, order) + 2.0) / 4.0


def contract_to_unit_cube_t(x_t: torch.Tensor) -> torch.Tensor:
    """x_t has the coordinate axis first, (3, ...): the L-inf contraction,
    then [-2, 2] -> [0, 1]."""
    return (_contract(x_t, x_t.abs().amax(dim=0, keepdim=True)) + 2.0) / 4.0


def normalize_aabb(x: torch.Tensor, aabb: torch.Tensor) -> torch.Tensor:
    """Map points of the axis-aligned box aabb (2, 3) [min; max] onto
    [0, 1]^3; points outside land outside."""
    return (x - aabb[0]) / (aabb[1] - aabb[0])
