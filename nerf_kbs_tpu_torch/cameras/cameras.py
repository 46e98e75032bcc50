"""Cameras, ray bundles and ray generation.

Pinhole cameras with OpenGL camera-to-world matrices (the camera looks down
-z) and optional OpenCV radial/tangential distortion. ``generate_rays`` turns
``(camera, row, col)`` pixel indices into rays on the indices' device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class Cameras:
    """Batched pinhole cameras; every tensor has leading dim N (cameras).

    fx, fy, cx, cy: (N,) f32 intrinsics in pixels.
    c2w:            (N, 3, 4) f32 camera-to-world, OpenGL convention.
    width, height:  (N,) int32.
    distortion:     (N, 6) f32 (k1, k2, k3, k4, p1, p2) or None.
    times:          (N,) f32 normalised capture times or None.
    """

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    c2w: torch.Tensor
    width: torch.Tensor
    height: torch.Tensor
    distortion: Optional[torch.Tensor] = None
    times: Optional[torch.Tensor] = None

    def __len__(self) -> int:
        return self.fx.shape[0]

    def to(self, device) -> "Cameras":
        return Cameras(**{
            f.name: None if getattr(self, f.name) is None else getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass
class RayBundle:
    """A batch of rays; leading dims are the batch shape.

    origins, directions: (..., 3), directions of unit length.
    pixel_area:          (..., 1) pixel footprint at unit distance.
    camera_indices:      (..., 1) int.
    directions_norm:     (..., 1) norm before normalisation (z-depth to
                         along-ray distance).
    nears, fars:         (..., 1) or None, set by a collider.
    times:               (..., 1) the camera's time, or None.
    """

    origins: torch.Tensor
    directions: torch.Tensor
    pixel_area: torch.Tensor
    camera_indices: torch.Tensor
    directions_norm: torch.Tensor
    nears: Optional[torch.Tensor] = None
    fars: Optional[torch.Tensor] = None
    times: Optional[torch.Tensor] = None


def _undistort_iterative_rows(x, y, d_rows, iters: int = 3):
    """Invert the OpenCV radial (k1..k4) / tangential (p1, p2) model by three
    fixed-point iterations; d_rows holds 6 broadcastable coefficient rows."""
    k1, k2, k3, k4, p1, p2 = d_rows
    xd, yd = x, y
    for _ in range(iters):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * (k3 + r2 * k4)))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial
    return x, y


def generate_rays(cameras: Cameras, ray_indices: torch.Tensor,
                  c2w_delta: Optional[torch.Tensor] = None) -> RayBundle:
    """Pixel indices (..., 3) int (camera, row, col) -> RayBundle.

    Rays pass through pixel centres (+0.5); camera-space directions are
    [x, -y, -1] (OpenGL). The pixel area is the product of the distances
    between the unit direction and those of the +x and +y neighbours.
    ``c2w_delta`` (N, 3, 4), a per-camera pose adjustment (the camera
    optimizer's), is composed as c2w' = delta . c2w: R' = Rd Rc,
    t' = Rd tc + td; the rays' origins and directions carry its gradient."""
    batch_shape = ray_indices.shape[:-1]
    flat = ray_indices.reshape(-1, 3)
    idx = flat[:, 0].long()
    px = flat[:, 2].float() + 0.5
    py = flat[:, 1].float() + 0.5
    fx, fy = cameras.fx[idx], cameras.fy[idx]
    cx, cy = cameras.cx[idx], cameras.cy[idx]
    c2w = cameras.c2w[idx]  # (B, 3, 4)
    M = [[c2w[:, i, j] for j in range(4)] for i in range(3)]
    if c2w_delta is not None:
        d = c2w_delta[idx]
        D = [[d[:, i, j] for j in range(4)] for i in range(3)]
        M = [[sum(D[i][k] * M[k][j] for k in range(3)) + (D[i][3] if j == 3 else 0.0)
              for j in range(4)] for i in range(3)]

    # pixel centre, +x neighbour, +y neighbour as rows of (3, B)
    PX = torch.stack([px, px + 1.0, px])
    PY = torch.stack([py, py, py + 1.0])
    X = (PX - cx) / fx
    Y = (PY - cy) / fy
    if cameras.distortion is not None:
        d = cameras.distortion[idx]
        X, Y = _undistort_iterative_rows(X, Y, [d[:, i] for i in range(6)])
    D = [M[i][0] * X - M[i][1] * Y - M[i][2] for i in range(3)]
    NORM = torch.sqrt(D[0] * D[0] + D[1] * D[1] + D[2] * D[2])
    U = [d / NORM for d in D]
    deltas = torch.sqrt(sum((u[1:3] - u[0:1]) ** 2 for u in U))  # (2, B)
    pixel_area = (deltas[0] * deltas[1]).reshape(batch_shape)[..., None]

    origins = torch.stack([M[0][3], M[1][3], M[2][3]], dim=-1).reshape(batch_shape + (3,))
    directions = torch.stack([u[0] for u in U], dim=-1).reshape(batch_shape + (3,))
    return RayBundle(
        origins=origins,
        directions=directions,
        pixel_area=pixel_area,
        camera_indices=ray_indices[..., 0:1],
        directions_norm=NORM[0].reshape(batch_shape)[..., None],
        times=None if cameras.times is None else cameras.times[idx].reshape(batch_shape)[..., None],
    )
