"""Scene contraction into the unit cube (nerfacto's SceneContraction with the
L-inf order, then the affine map [-2, 2]^3 -> [0, 1]^3)."""

from __future__ import annotations

import torch


def contract_to_unit_cube_t(x_t: torch.Tensor) -> torch.Tensor:
    """x_t has the coordinate axis first, (3, ...). Points inside the L-inf
    unit ball keep their place; points outside map to radius 2 - 1/r; the
    result is squeezed from [-2, 2] into [0, 1]."""
    mag = x_t.abs().amax(dim=0, keepdim=True).clamp_min(1e-9)
    contracted = torch.where(mag <= 1.0, x_t, (2.0 - 1.0 / mag) * (x_t / mag))
    return (contracted + 2.0) / 4.0
