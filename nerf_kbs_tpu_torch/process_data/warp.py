"""Warping geometry on tensors: pixel <-> camera lifting, rigid flow from
depth and pose, bilinear sampling, flow warping, inverse warping, and the
Middlebury flow colour coding (NumPy) (the JAX package's
``process_data/warp.py``).

Convention: OpenCV camera (x right, y down, z forward), pixel coordinates
(u, v) with u along the width. depth (B, H, W); intrinsics K (B, 3, 3);
pose (B, 3, 4) maps source-camera points to target-camera points.
"""

from __future__ import annotations

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.transforms import pose_vec2mat
from nerf_kbs_tpu_torch.ops.segment_sum import gather_columns


def _pixel_grid(h: int, w: int, device) -> torch.Tensor:
    """(3, H, W) homogeneous pixel coordinates (u, v, 1)."""
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                          torch.arange(w, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([u, v, torch.ones_like(u)])


def pixel2cam(depth: torch.Tensor, K_inv: torch.Tensor) -> torch.Tensor:
    """Lift pixels to camera-space points. depth (B, H, W), K_inv (B, 3, 3)
    -> (B, 3, H, W)."""
    b, h, w = depth.shape
    grid = _pixel_grid(h, w, depth.device).reshape(3, -1)
    rays = torch.einsum("bij,jn->bin", K_inv, grid)
    return (rays * depth.reshape(b, 1, -1)).reshape(b, 3, h, w)


def cam2pixel(points: torch.Tensor, K: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """Project camera points through a rigid transform into pixel
    coordinates. points (B, 3, H, W), K (B, 3, 3), pose (B, 3, 4) -> (B, 2,
    H, W); depths below 1e-3 are clamped."""
    b, _, h, w = points.shape
    p = points.reshape(b, 3, -1)
    cam = torch.einsum("bij,bjn->bin", pose[:, :, :3], p) + pose[:, :, 3:4]
    pix = torch.einsum("bij,bjn->bin", K, cam)
    z = pix[:, 2:3].clamp(min=1e-3)
    return (pix[:, :2] / z).reshape(b, 2, h, w)


def pose2flow(depth: torch.Tensor, pose: torch.Tensor, K: torch.Tensor, K_inv: torch.Tensor,
              rotation_mode: str = "euler") -> torch.Tensor:
    """Rigid flow induced by depth and ego-motion: project(transform(lift(
    depth))) - pixel grid. pose: a (B, 6) vector (``rotation_mode`` 'euler',
    'axisangle' or 'quat') or a (B, 3, 4) matrix. -> (B, 2, H, W)."""
    if pose.ndim == 2:
        pose = pose_vec2mat(pose, rotation_mode)
    _, h, w = depth.shape
    pix = cam2pixel(pixel2cam(depth, K_inv), K, pose)
    return pix - _pixel_grid(h, w, depth.device)[:2][None]


def grid_sample_bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling with zeros outside. img (B, C, H, W), coords (B, 2,
    Ho, Wo) pixel coordinates (u, v) -> (B, C, Ho, Wo). Each of the four taps
    is gathered from the clamped index and counts only where it lies inside
    [0, W - 1] x [0, H - 1]: a point just past the border keeps its inside
    taps' share."""
    b, c, h, w = img.shape
    ho, wo = coords.shape[2], coords.shape[3]
    u, v = coords[:, 0], coords[:, 1]
    u0, v0 = torch.floor(u), torch.floor(v)
    du, dv = u - u0, v - v0
    # the batch's pixels as the columns of one (C, B H W) table: the taps'
    # gradient then sums into each pixel in a fixed order (gather_columns)
    columns = img.reshape(b, c, h * w).transpose(0, 1).reshape(c, b * h * w)
    first = (torch.arange(b, device=img.device) * (h * w)).reshape(b, 1, 1)

    def tap(ui, vi, wgt):
        inb = (ui >= 0) & (ui <= w - 1) & (vi >= 0) & (vi <= h - 1)
        uc = ui.clamp(0, w - 1).long()
        vc = vi.clamp(0, h - 1).long()
        g = gather_columns(columns, (first + vc * w + uc).reshape(-1))
        return g.reshape(c, b, ho, wo).transpose(0, 1) * (wgt * inb)[:, None]

    return (tap(u0, v0, (1 - du) * (1 - dv)) + tap(u0 + 1, v0, du * (1 - dv))
            + tap(u0, v0 + 1, (1 - du) * dv) + tap(u0 + 1, v0 + 1, du * dv))


def flow_warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """out(p) = img(p + flow(p)). img (B, C, H, W), flow (B, 2, H, W)."""
    _, _, h, w = img.shape
    return grid_sample_bilinear(img, _pixel_grid(h, w, img.device)[:2][None] + flow)


def _out_of_bounds(pix: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return (pix[:, 0] < 0) | (pix[:, 0] > w - 1) | (pix[:, 1] < 0) | (pix[:, 1] > h - 1)


def flow2oob(flow: torch.Tensor) -> torch.Tensor:
    """True where the flow points out of the image. (B, 2, H, W) -> (B, H,
    W) bool."""
    _, _, h, w = flow.shape
    return _out_of_bounds(_pixel_grid(h, w, flow.device)[:2][None] + flow, h, w)


def inverse_warp(img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor, K: torch.Tensor,
                 rotation_mode: str = "euler") -> tuple[torch.Tensor, torch.Tensor]:
    """Warp a source image to the target frame from the target's depth and
    the target -> source pose. -> (warped (B, C, H, W), valid (B, H, W))."""
    if pose.ndim == 2:
        pose = pose_vec2mat(pose, rotation_mode)
    pix = cam2pixel(pixel2cam(depth, torch.linalg.inv(K)), K, pose)
    _, _, h, w = img.shape
    return grid_sample_bilinear(img, pix), ~_out_of_bounds(pix, h, w)


# ---------------------------------------------------------------------------
# Middlebury flow colour coding
# ---------------------------------------------------------------------------


def _make_colorwheel() -> np.ndarray:
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    cols = np.zeros((RY + YG + GC + CB + BM + MR, 3))
    col = 0
    cols[:RY, 0] = 255
    cols[:RY, 1] = np.floor(255 * np.arange(RY) / RY)
    col += RY
    cols[col:col + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    cols[col:col + YG, 1] = 255
    col += YG
    cols[col:col + GC, 1] = 255
    cols[col:col + GC, 2] = np.floor(255 * np.arange(GC) / GC)
    col += GC
    cols[col:col + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    cols[col:col + CB, 2] = 255
    col += CB
    cols[col:col + BM, 2] = 255
    cols[col:col + BM, 0] = np.floor(255 * np.arange(BM) / BM)
    col += BM
    cols[col:col + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    cols[col:col + MR, 0] = 255
    return cols / 255.0


_COLORWHEEL = _make_colorwheel()


def flow_to_image(flow: np.ndarray, max_flow: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> (H, W, 3) uint8 Middlebury colour coding."""
    u, v = flow[..., 0], flow[..., 1]
    rad = np.sqrt(u**2 + v**2)
    maxrad = max_flow if max_flow else max(rad.max(), 1e-6)
    u, v = u / maxrad, v / maxrad
    rad = np.sqrt(u**2 + v**2)
    a = np.arctan2(-v, -u) / np.pi
    ncols = len(_COLORWHEEL)
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int) % ncols
    k1 = (k0 + 1) % ncols
    f = fk - np.floor(fk)
    img = np.zeros(flow.shape[:2] + (3,))
    for c in range(3):
        col = (1 - f) * _COLORWHEEL[k0, c] + f * _COLORWHEEL[k1, c]
        idx = rad <= 1
        col[idx] = 1 - rad[idx] * (1 - col[idx])
        col[~idx] *= 0.75
        img[..., c] = col
    return (img * 255).astype(np.uint8)
