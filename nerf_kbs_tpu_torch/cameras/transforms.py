"""Differentiable rigid-transform parameterisations, batched over leading
dims (the JAX package's ``cameras/transforms.py``).

Used by the camera optimizer (the SE(3) exponential map of per-camera
tangents, ``models.nerfacto.camera_deltas``) and by pose-vector decoding
(6-DoF vector -> matrix with euler, quaternion or axis-angle rotations).
"""

from __future__ import annotations

import torch


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """(..., 3) euler angles (rx, ry, rz) -> (..., 3, 3) rotation
    R = Rx Ry Rz."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    o = torch.zeros_like(x)
    i = torch.ones_like(x)
    shape = angle.shape[:-1] + (3, 3)
    Rx = torch.stack([i, o, o, o, cx, -sx, o, sx, cx], dim=-1).reshape(shape)
    Ry = torch.stack([cy, o, sy, o, i, o, -sy, o, cy], dim=-1).reshape(shape)
    Rz = torch.stack([cz, -sz, o, sz, cz, o, o, o, i], dim=-1).reshape(shape)
    return Rx @ Ry @ Rz


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion (w, x, y, z), not necessarily normalised ->
    (..., 3, 3) rotation."""
    q = quat / torch.linalg.norm(quat, dim=-1, keepdim=True).clamp_min(1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ]
    return torch.stack(rows, dim=-1).reshape(quat.shape[:-1] + (3, 3))


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """6/7-DoF pose vector -> (..., 3, 4) transform: vec[..., :3] is the
    translation, the tail euler angles ('euler'), a quaternion ('quat': three
    coefficients with w = 1 implied, or all four) or an axis-angle vector
    ('axisangle', Rodrigues)."""
    t = vec[..., :3, None]
    rot = vec[..., 3:]
    if rotation_mode == "axisangle":
        if rot.shape[-1] != 3:
            raise ValueError(f"axisangle mode needs 3 coeffs, got {tuple(rot.shape)}")
        R = exp_map_so3(rot)
    elif rotation_mode == "euler":
        if rot.shape[-1] != 3:
            raise ValueError(f"euler mode needs 3 rotation coeffs, got {tuple(rot.shape)}")
        R = euler2mat(rot)
    elif rotation_mode == "quat":
        if rot.shape[-1] == 3:
            rot = torch.cat([torch.ones_like(rot[..., :1]), rot], dim=-1)
        elif rot.shape[-1] != 4:
            raise ValueError(f"quat mode needs 3 or 4 rotation coeffs, got {tuple(rot.shape)}")
        R = quat2mat(rot)
    else:
        raise ValueError(f"unknown rotation_mode {rotation_mode!r}")
    return torch.cat([R, t], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    o = torch.zeros_like(v[..., 0])
    rows = [o, -v[..., 2], v[..., 1], v[..., 2], o, -v[..., 0], -v[..., 1], v[..., 0], o]
    return torch.stack(rows, dim=-1).reshape(v.shape[:-1] + (3, 3))


def _so3_coefficients(w: torch.Tensor):
    """(A, B, C), each (..., 1, 1), with R = I + A K + B K^2 and
    V = I + B K + C K^2 for K = skew(w) (unnormalised). Near theta = 0 the
    Taylor forms take over, and the other branch is evaluated at a safe
    value: autograd differentiates both branches of a ``where``, so both
    must be finite at w = 0, where the camera optimizer starts (a
    norm-then-divide there gives NaN gradients)."""
    theta_sq = torch.sum(w * w, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp_min(theta_sq, 1e-24))
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    safe_sq = torch.where(small, one, theta_sq)
    safe = torch.where(small, one, theta)
    A = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe) / safe)
    B = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe)) / safe_sq)
    C = torch.where(small, 1.0 / 6.0 - theta_sq / 120.0,
                    (safe - torch.sin(safe)) / (safe_sq * safe))
    return A[..., None], B[..., None], C[..., None]


def exp_map_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' SO(3) exponential: (..., 3) axis-angle -> (..., 3, 3),
    differentiable everywhere, w = 0 included."""
    A, B, _ = _so3_coefficients(w)
    K = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A * K + B * (K @ K)


def exp_map_se3(tangent: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential: (..., 6) [v, w] -> (..., 3, 4) rigid transform
    [R | V v], differentiable at the identity (see ``_so3_coefficients``)."""
    v, w = tangent[..., :3], tangent[..., 3:6]
    A, B, C = _so3_coefficients(w)
    K = skew(w)
    eye = torch.eye(3, dtype=tangent.dtype, device=tangent.device).expand(K.shape)
    KK = K @ K
    R = eye + A * K + B * KK
    V = eye + B * K + C * KK
    return torch.cat([R, V @ v[..., None]], dim=-1)


def compose_se3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two (..., 3, 4) rigid transforms: a . b."""
    Ra, ta = a[..., :3, :3], a[..., :3, 3:4]
    Rb, tb = b[..., :3, :3], b[..., :3, 3:4]
    return torch.cat([Ra @ Rb, Ra @ tb + ta], dim=-1)
