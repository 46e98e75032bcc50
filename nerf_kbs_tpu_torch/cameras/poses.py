"""Host-side pose utilities (NumPy): KITTI calib and pose files, the OpenCV ->
OpenGL camera flip, and orienting, centring and scaling a cloud of poses.

The JAX package's ``cameras/poses.py`` function for function; everything here
runs once when a dataset is parsed, in float64.
"""

from __future__ import annotations

import numpy as np


def read_kitti_calib(calib_path: str) -> dict[str, np.ndarray]:
    """A KITTI ``calib.txt`` as named (3, 4) float64 projection matrices.
    Lines read ``P2: fx 0 cx tx 0 fy cy ty 0 0 1 tz``; lines of another
    length are skipped."""
    out: dict[str, np.ndarray] = {}
    with open(calib_path, "r", encoding="utf-8") as f:
        for line in f:
            key, _, vals = line.strip().partition(":")
            arr = np.array(vals.split(), dtype=np.float64)
            if arr.size == 12:
                out[key.strip()] = arr.reshape(3, 4)
    return out


def intrinsics_from_projection(P: np.ndarray) -> tuple[float, float, float, float, np.ndarray]:
    """(fx, fy, cx, cy, t) of a projection ``P = K [I | t]``: t = K^-1 P[:, 3]
    is the camera's stereo-baseline shift relative to cam0."""
    K = P[:3, :3]
    t = np.linalg.solve(K, P[:, 3])
    return float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), t


def read_kitti_poses(pose_path: str) -> np.ndarray:
    """A KITTI odometry pose file (one row-major 3x4 matrix a line) as (N, 4,
    4) cam0-to-world matrices."""
    rows = np.atleast_2d(np.loadtxt(pose_path, dtype=np.float64))
    n = rows.shape[0]
    poses = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    poses[:, :3, :4] = rows.reshape(n, 3, 4)
    return poses


def opencv_to_world(c2w: np.ndarray) -> np.ndarray:
    """OpenCV camera axes (+y down, +z forward) -> OpenGL (+y up, +z back):
    negates rotation columns 1 and 2. (..., 3, 4) or (..., 4, 4)."""
    out = np.array(c2w, dtype=np.float64, copy=True)
    out[..., :3, 1:3] *= -1.0
    return out


def invert_se3(T: np.ndarray) -> np.ndarray:
    """Invert (..., 4, 4) rigid transforms: [R^T, -R^T t]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3:4]
    Rt = np.swapaxes(R, -1, -2)
    out = np.tile(np.eye(4, dtype=T.dtype), T.shape[:-2] + (1, 1))
    out[..., :3, :3] = Rt
    out[..., :3, 3:4] = -Rt @ t
    return out


def to_homogeneous(c2w: np.ndarray) -> np.ndarray:
    """(..., 3, 4) -> (..., 4, 4) with a [0, 0, 0, 1] bottom row."""
    if c2w.shape[-2] == 4:
        return c2w
    bottom = np.zeros(c2w.shape[:-2] + (1, 4), dtype=c2w.dtype)
    bottom[..., 0, 3] = 1.0
    return np.concatenate([c2w, bottom], axis=-2)


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def rotation_matrix_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Smallest rotation taking direction ``a`` to direction ``b``
    (Rodrigues); antiparallel directions turn by pi about an axis orthogonal
    to ``a``."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(np.dot(a, b))
    s = np.linalg.norm(v)
    if s < 1e-10:
        if c > 0:
            return np.eye(3)
        axis = np.cross(a, np.array([1.0, 0.0, 0.0]))
        if np.linalg.norm(axis) < 1e-6:
            axis = np.cross(a, np.array([0.0, 1.0, 0.0]))
        K = _skew(axis / np.linalg.norm(axis))
        return np.eye(3) + 2.0 * (K @ K)
    K = _skew(v)
    return np.eye(3) + K + K @ K * ((1.0 - c) / (s**2))


def focus_of_attention(poses: np.ndarray, initial_focus: np.ndarray) -> np.ndarray:
    """The point nearest (in summed squared distance) to the optical axes of
    the cameras that look towards it, iterated from ``initial_focus``.
    ``poses`` (N, 4, 4) OpenGL c2w."""
    dirs = -poses[:, :3, 2]
    origins = poses[:, :3, 3]
    focus = initial_focus
    active = np.einsum("nj,nj->n", dirs, focus - origins) > 0
    for _ in range(10):
        if not active.any():
            break
        d, o = dirs[active], origins[active]
        M = np.eye(3)[None] - d[:, :, None] * d[:, None, :]
        focus = np.linalg.lstsq(M.sum(axis=0), np.einsum("nij,nj->i", M, o), rcond=None)[0]
        new_active = np.einsum("nj,nj->n", dirs, focus - origins) > 0
        if (new_active == active).all():
            break
        active = new_active
    return focus


def auto_orient_and_center_poses(poses: np.ndarray, method: str = "up",
                                 center_method: str = "poses") -> tuple[np.ndarray, np.ndarray]:
    """Orient and centre a cloud of poses: returns (new (N, 3, 4) poses, the
    (3, 4) transform with new = transform @ poses). method: 'pca' | 'up' |
    'vertical' | 'none'; center_method: 'poses' | 'focus' | 'none'."""
    poses = to_homogeneous(np.asarray(poses, dtype=np.float64))
    origins = poses[:, :3, 3]
    mean_origin = origins.mean(axis=0)

    if center_method == "poses":
        translation = mean_origin
    elif center_method == "focus":
        translation = focus_of_attention(poses, mean_origin)
    elif center_method == "none":
        translation = np.zeros(3)
    else:
        raise ValueError(f"unknown center_method {center_method!r}")

    if method == "pca":
        centered = origins - mean_origin
        _, eigvec = np.linalg.eigh(centered.T @ centered)
        eigvec = eigvec[:, ::-1]
        if np.linalg.det(eigvec) < 0:
            eigvec[:, 2] *= -1
        rotation = eigvec.T
        if (rotation @ poses[:, :3, 1].mean(axis=0))[2] < 0:
            rotation = np.diag([1.0, -1.0, -1.0]) @ rotation
    elif method in ("up", "vertical"):
        up = poses[:, :3, 1].mean(axis=0)
        up = up / np.linalg.norm(up)
        if method == "vertical":
            # the direction the cameras' x axes (horizontal) project least on
            vert = np.linalg.svd(poses[:, :3, 0], full_matrices=True)[2][2, :]
            up = -vert if np.dot(vert, up) < 0 else vert
        rotation = rotation_matrix_between(up, np.array([0.0, 0.0, 1.0]))
    elif method == "none":
        rotation = np.eye(3)
    else:
        raise ValueError(f"unknown orient method {method!r}")

    transform = np.concatenate([rotation, rotation @ -translation[:, None]], axis=1)
    new_poses = np.einsum("ij,njk->nik", to_homogeneous(transform[None])[0], poses)[:, :3, :4]
    return new_poses, transform


def auto_scale_poses(poses: np.ndarray, target: float = 1.0) -> tuple[np.ndarray, float]:
    """Scale translations so that the farthest camera lies at ``target``
    from the origin. Returns (scaled (N, 3, 4) poses, factor)."""
    poses = np.asarray(poses, dtype=np.float64)
    scale = target / max(float(np.max(np.linalg.norm(poses[:, :3, 3], axis=-1))), 1e-12)
    out = poses.copy()
    out[:, :3, 3] *= scale
    return out[:, :3, :4], scale
