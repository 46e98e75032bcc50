"""Novel-view rendering: the chunked full-image renderer and camera paths.

``Renderer.render_camera`` is the serving path: every pixel of one camera,
in ``eval_num_rays_per_chunk`` chunks, through ray generation and the eval
forward of a model module (nerfacto unless given).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.cameras import Cameras, generate_rays
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.models import nerfacto
from nerf_kbs_tpu_torch.utils import images

_KEEP = ("rgb", "depth", "expected_depth", "accumulation", "directions_norm", "semantics")


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


class Renderer:
    """Holds a trained (or seeded) model: its module (``model``, nerfacto
    unless given), params, config, cameras (the eval set, which
    ``render_camera`` indexes), the training ``step`` (the coarse-to-fine
    window renders as trained) and the chunk size. Params and cameras are
    moved to ``device`` (CUDA unless ``device="cpu"``)."""

    def __init__(self, params: dict, config: nerfacto.NerfactoConfig, cameras: Cameras,
                 step: float = 0, eval_num_rays_per_chunk: int = 1 << 15, device=None,
                 model=nerfacto):
        self.model = model
        self.device = resolve_device(device)
        self.params = _to_device(params, self.device)
        self.config = config
        self.cameras = cameras.to(self.device)
        self.step = step
        self.eval_num_rays_per_chunk = eval_num_rays_per_chunk

    @torch.no_grad()
    def render_camera(self, camera_idx: int, cameras: Cameras | None = None) -> dict:
        """Full image of one camera: {name: (H, W, C) float32 numpy} for rgb,
        depth, accumulation and, where the model gives them, expected_depth,
        directions_norm and semantics (logits). The last chunk is padded by
        repeating the last pixel index."""
        cameras = self.cameras if cameras is None else cameras.to(self.device)
        h = int(cameras.height[camera_idx])
        w = int(cameras.width[camera_idx])
        dev = self.device
        rows = torch.arange(h, dtype=torch.int32, device=dev)
        cols = torch.arange(w, dtype=torch.int32, device=dev)
        rr, cc = torch.meshgrid(rows, cols, indexing="ij")
        idx = torch.stack([torch.full_like(rr, camera_idx), rr, cc], dim=-1).reshape(-1, 3)
        total = idx.shape[0]
        chunk = self.eval_num_rays_per_chunk
        pad = (-total) % chunk
        if pad:
            idx = torch.cat([idx, idx[-1:].expand(pad, 3)], dim=0)
        outs: dict[str, list] = {}
        for i in range(0, idx.shape[0], chunk):
            rays = generate_rays(cameras, idx[i:i + chunk])
            res = self.model.forward(self.params, self.config, rays, step=self.step,
                                     train=False)
            for k in _KEEP:
                if k in res:
                    outs.setdefault(k, []).append(res[k])
        return {
            k: torch.cat(v, dim=0)[:total].reshape(h, w, -1).cpu().numpy()
            for k, v in outs.items()
        }

    @property
    def eval_cameras(self) -> Cameras:
        return self.cameras


# ---------------------------------------------------------------------------
# camera paths (host-side NumPy)
# ---------------------------------------------------------------------------


def _skew(v: np.ndarray) -> np.ndarray:
    return np.array([[0.0, -v[2], v[1]], [v[2], 0.0, -v[0]], [-v[1], v[0], 0.0]])


def _slerp_rotations(Ra: np.ndarray, Rb: np.ndarray, t: float) -> np.ndarray:
    """Geodesic interpolation between two rotation matrices."""
    M = Ra.T @ Rb
    cos = np.clip((np.trace(M) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos)
    if theta < 1e-8:
        return Ra
    if theta > np.pi - 1e-3:
        # near pi the off-diagonal differences vanish: take the axis from the
        # diagonal of M and its signs from the off-diagonal sums
        w = np.sqrt(np.clip((np.diag(M) + 1.0) / 2.0, 0.0, None))
        i = int(np.argmax(w))
        for j in range(3):
            if j != i and (M[i, j] + M[j, i]) < 0:
                w[j] = -w[j]
        w = w / max(np.linalg.norm(w), 1e-12)
    else:
        w = (
            np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
            / (2 * np.sin(theta))
        )
    K = _skew(w)
    Rt = np.eye(3) + np.sin(t * theta) * K + (1 - np.cos(t * theta)) * (K @ K)
    return Ra @ Rt


def interpolate_camera_path(c2ws: np.ndarray, frames_per_segment: int = 8) -> np.ndarray:
    """(N, 3, 4) keyframe poses -> (M, 3, 4) path: slerp of rotations, lerp
    of translations between consecutive cameras."""
    out = []
    for i in range(len(c2ws) - 1):
        Ra, Rb = c2ws[i, :3, :3], c2ws[i + 1, :3, :3]
        ta, tb = c2ws[i, :3, 3], c2ws[i + 1, :3, 3]
        for k in range(frames_per_segment):
            t = k / frames_per_segment
            R = _slerp_rotations(Ra, Rb, t)
            out.append(np.concatenate([R, ((1 - t) * ta + t * tb)[:, None]], axis=1))
    out.append(c2ws[-1])
    return np.stack(out)


def ring_view_path(c2ws: np.ndarray, n: int = 60, radius_scale: float = 1.0,
                   height_offset: float = 0.0) -> np.ndarray:
    """Circular orbit around the centre of the camera positions, each pose
    facing the centre. Returns (n, 3, 4)."""
    center = c2ws[:, :3, 3].mean(axis=0)
    radius = float(np.linalg.norm(c2ws[:, :3, 3] - center, axis=1).mean())
    radius = max(radius, 1e-3) * radius_scale
    up = np.array([0.0, 0.0, 1.0])
    out = []
    for k in range(n):
        th = 2 * np.pi * k / n
        eye = center + radius * np.array([np.cos(th), np.sin(th), 0.0])
        eye[2] += height_offset
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, up)
        right = right / max(np.linalg.norm(right), 1e-9)
        down = np.cross(fwd, right)
        # OpenGL camera: -z forward, +x right, +y up
        R = np.stack([right, -down, -fwd], axis=1)
        out.append(np.concatenate([R, eye[:, None]], axis=1))
    return np.stack(out)


def apply_camera_overrides(cams: Cameras, focal_mult: float | None = None,
                           pos_shift: tuple | None = None,
                           frame_range: tuple | None = None) -> Cameras:
    """The eval-camera overrides of the reference's eval loader: the focal
    lengths times ``focal_mult``, every camera centre (``c2w[:, :3, 3]``)
    moved by the world offset ``pos_shift``, and the inclusive camera range
    ``frame_range`` = (lo, hi), which slices every per-camera field together
    (distortion and times too). Returns new Cameras on the input's device."""
    sl = slice(None) if frame_range is None else slice(int(frame_range[0]),
                                                        int(frame_range[1]) + 1)

    def cut(v):
        return None if v is None else v[sl].clone()

    out = Cameras(**{f.name: cut(getattr(cams, f.name)) for f in dataclasses.fields(cams)})
    if focal_mult is not None:
        out.fx = out.fx * focal_mult
        out.fy = out.fy * focal_mult
    if pos_shift is not None:
        out.c2w[:, :3, 3] += torch.as_tensor(pos_shift, dtype=out.c2w.dtype,
                                             device=out.c2w.device)
    return out


def render_trajectory(source, output_dir: str, frames_per_segment: int = 8,
                      camera_source: str = "eval", downscale: int = 1,
                      focal_mult: float | None = None, pos_shift: tuple | None = None,
                      frame_range: tuple | None = None, ring_view: bool = False,
                      ring_frames: int = 60) -> list[str]:
    """Render a path through the ``camera_source`` ("eval" or "train")
    cameras of ``source`` (a ``Renderer`` or a ``Trainer``: anything with
    ``eval_cameras`` and ``render_camera``; "train" needs a ``Trainer``'s
    ``train_cameras``), after ``apply_camera_overrides``: interpolated
    between them, or a ring around them, with the intrinsics and the time of
    the first; writes rgb_%05d.png and depth_%05d.png and returns the rgb
    paths."""
    if camera_source not in ("eval", "train"):
        raise ValueError(f"camera_source {camera_source!r}: 'eval' or 'train'")
    if camera_source == "train" and not hasattr(source, "train_cameras"):
        raise ValueError(f"camera_source 'train' needs a Trainer; {type(source).__name__} "
                         "holds only the eval cameras")
    cams = source.train_cameras if camera_source == "train" else source.eval_cameras
    cams = apply_camera_overrides(cams, focal_mult, pos_shift, frame_range)
    c2ws = cams.c2w.cpu().numpy()
    path = ring_view_path(c2ws, n=ring_frames) if ring_view else interpolate_camera_path(
        c2ws, frames_per_segment)
    n = len(path)

    def tiled(v):
        return v[:1].expand((n,) + tuple(v.shape[1:])).clone()

    traj = Cameras(
        fx=tiled(cams.fx) / downscale, fy=tiled(cams.fy) / downscale,
        cx=tiled(cams.cx) / downscale, cy=tiled(cams.cy) / downscale,
        c2w=torch.as_tensor(path, dtype=torch.float32, device=cams.c2w.device),
        width=torch.div(tiled(cams.width), downscale, rounding_mode="floor"),
        height=torch.div(tiled(cams.height), downscale, rounding_mode="floor"),
        times=None if cams.times is None else tiled(cams.times),
    )
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    written = []
    for i in range(n):
        res = source.render_camera(i, cameras=traj)
        p = out / f"rgb_{i:05d}.png"
        p.write_bytes(images.encode_png(res["rgb"]))
        depth = images.apply_depth_colormap(res["depth"], res["accumulation"])
        (out / f"depth_{i:05d}.png").write_bytes(images.encode_png(depth))
        written.append(str(p))
    return written
