"""SUDS metadata.json generation (a NumPy copy of the JAX package's
``process_data/metadata.py``): the validation-frame schedule, flow
neighbours that skip validation frames, scene bounds from depth, pose and
timestamp normalisation, and the writer of the metadata.json that
``data.dataparsers.suds_metadata`` reads. ``build_kitti_metadata`` makes it
from a COLMAP model and the preprocessing outputs under the asset templates
motion/<seq>/{flow_bwd, flow_fwd, depth_npy, motion_mask} and
fill_img/<seq>; depth at a working resolution is resized to the frame's
with OpenCV's INTER_NEAREST rule (``utils.images.resize_nearest_cv``)."""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional, Set

import numpy as np

from nerf_kbs_tpu_torch.data.image_metadata import ImageMetadata
from nerf_kbs_tpu_torch.process_data.colmap_io import colmap_pose_to_c2w, read_model
from nerf_kbs_tpu_torch.utils.images import resize_nearest_cv


def get_val_frames(num_frames: int, test_every: Optional[int] = None,
                   train_every: Optional[int] = None) -> Set[int]:
    """Validation-frame schedule: exactly one of test_every / train_every
    must be given."""
    assert (test_every is None) != (train_every is None)
    if train_every is None:
        return set(np.arange(test_every, num_frames, test_every).tolist())
    train = set(np.arange(0, num_frames, train_every).tolist())
    return (set(range(num_frames)) - train) if train_every > 1 else train


def get_neighbor(
    image_index: int, val_frames: Set[int], direction: int,
    interleaved: bool = True,
) -> int:
    """Nearest temporal neighbour skipping val frames. ``interleaved``: an
    item list of two interleaved cameras, where // 2 maps an item index to
    its frame id; a mono list (build_kitti_metadata) tests the index
    directly."""
    diff = direction
    frame = (lambda i: i // 2) if interleaved else (lambda i: i)
    while frame(image_index + diff) in val_frames:
        diff += direction
    return image_index + diff


def unproject_depth_points(
    c2w: np.ndarray, intrinsics: np.ndarray, depth: np.ndarray
) -> np.ndarray:
    """World-space points from a depth map over a GL-convention camera.
    c2w (3, 4); intrinsics (fx, fy, cx, cy); depth (H, W) with 0 = invalid.
    Depth is along the camera's z; converted to along the ray with the
    direction's norm."""
    h, w = depth.shape
    fx, fy, cx, cy = intrinsics
    v, u = np.meshgrid(np.arange(h) + 0.5, np.arange(w) + 0.5, indexing="ij")
    d_cam = np.stack([(u - cx) / fx, -(v - cy) / fy, -np.ones_like(u)], -1)
    d_world = d_cam @ c2w[:3, :3].T
    norm = np.linalg.norm(d_world, axis=-1, keepdims=True)
    valid = depth > 0
    pts = c2w[:3, 3] + (d_world / norm) * (depth[..., None] * norm)
    return pts[valid]


def get_bounds_from_depth(
    item: ImageMetadata,
    depth: np.ndarray,
    cur_min: Optional[np.ndarray],
    cur_max: Optional[np.ndarray],
):
    pts = unproject_depth_points(item.c2w, item.intrinsics, depth)
    stack = [item.c2w[:3, 3][None], pts]
    if cur_min is not None:
        stack += [cur_min[None], cur_max[None]]
    allpts = np.concatenate(stack, 0)
    return allpts.min(0), allpts.max(0)


def scale_bounds(items: list[ImageMetadata], min_bounds: np.ndarray, max_bounds: np.ndarray):
    """Normalize poses into the +-1 cube around the bounds' centre. Mutates
    item.c2w translations; returns (origin, pose_scale_factor,
    scene_bounds)."""
    origin = (max_bounds + min_bounds) * 0.5
    psf = float(np.linalg.norm((max_bounds - min_bounds) * 0.5))
    for it in items:
        it.c2w = np.array(it.c2w, np.float64)
        it.c2w[:3, 3] = (it.c2w[:3, 3] - origin) / psf
        assert np.all((it.c2w >= -1 - 1e-6) & (it.c2w <= 1 + 1e-6)), it.c2w
        it.c2w = it.c2w.astype(np.float32)
        it.pose_scale_factor = psf
    scene_bounds = (np.stack([min_bounds, max_bounds]) - origin) / psf
    return origin, psf, scene_bounds


def normalize_timestamp(item: ImageMetadata, min_frame: int, max_frame: int) -> None:
    divisor = 0.5 * (max_frame - min_frame)
    assert divisor > 0
    item.time = (item.time - min_frame) / divisor - 1.0
    assert -1 <= item.time <= 1


def write_metadata(
    output_path: str,
    items: list[ImageMetadata],
    origin: np.ndarray,
    pose_scale_factor: float,
    scene_bounds: np.ndarray,
    static_masks: Optional[list[str]] = None,
) -> None:
    """Write the metadata.json that SudsMetadataConfig reads."""
    if static_masks:
        assert len(static_masks) == len(items)
    frames = []
    for i, it in enumerate(items):
        fr = {
            "image_index": it.image_index,
            "rgb_path": it.image_path,
            "depth_path": it.depth_path,
            "feature_path": it.feature_path,
            "backward_flow_path": it.backward_flow_path,
            "forward_flow_path": it.forward_flow_path,
            "backward_neighbor_index": it.backward_neighbor_index,
            "forward_neighbor_index": it.forward_neighbor_index,
            "c2w": np.asarray(it.c2w)[:3, :4].tolist(),
            "W": it.W,
            "H": it.H,
            "intrinsics": np.asarray(it.intrinsics).tolist(),
            "time": it.time,
            "video_id": it.video_id,
            "is_val": it.is_val,
        }
        if static_masks:
            fr["static_mask_path"] = static_masks[i]
        if it.mask_path is not None:
            fr["mask_path"] = it.mask_path
        if it.sky_mask_path is not None:
            fr["sky_mask_path"] = it.sky_mask_path
        frames.append(fr)
    Path(output_path).parent.mkdir(parents=True, exist_ok=True)
    with open(output_path, "w", encoding="utf-8") as f:
        json.dump(
            {
                "origin": np.asarray(origin).tolist(),
                "scene_bounds": np.asarray(scene_bounds).tolist(),
                "pose_scale_factor": pose_scale_factor,
                "frames": frames,
            },
            f,
            indent=2,
        )


@dataclasses.dataclass
class KittiMetadataConfig:
    """The settings of ``build_kitti_metadata`` (the ``metadata`` tool's flags)."""

    colmap_sparse_dir: str = "colmap/0"
    image_dir: str = "fill_img"
    motion_dir: str = "motion"
    sequence: str = "0003"
    output_path: str = "metadata.json"
    test_every: Optional[int] = 10
    train_every: Optional[int] = None
    video_id: int = 0
    use_masks: bool = True


def build_kitti_metadata(cfg: KittiMetadataConfig) -> list[ImageMetadata]:
    """COLMAP model + preprocessing outputs -> ImageMetadata list with
    neighbours, normalized poses and times, and metadata.json on disk."""
    cams, imgs = read_model(cfg.colmap_sparse_dir)
    image_ids = sorted(imgs, key=lambda i: imgs[i].name)
    n = len(image_ids)
    val_frames = get_val_frames(n, cfg.test_every, cfg.train_every)

    motion = Path(cfg.motion_dir) / cfg.sequence
    items: list[ImageMetadata] = []
    for idx, iid in enumerate(image_ids):
        im = imgs[iid]
        cam = cams[im.camera_id]
        c2w = colmap_pose_to_c2w(im)[:3, :4]
        p = cam.params
        if cam.model in ("PINHOLE", "OPENCV"):
            intr = np.array([p[0], p[1], p[2], p[3]], np.float32)
        else:
            intr = np.array([p[0], p[0], p[1], p[2]], np.float32)
        stem = Path(im.name).stem
        is_val = idx in val_frames
        items.append(
            ImageMetadata(
                image_path=str(Path(cfg.image_dir) / cfg.sequence / im.name),
                c2w=c2w.astype(np.float32),
                W=cam.width,
                H=cam.height,
                intrinsics=intr,
                image_index=idx,
                time=float(idx),
                video_id=cfg.video_id,
                depth_path=str(motion / "depth_npy" / f"{stem}.npy"),
                mask_path=(
                    str(motion / "motion_mask" / f"{stem}.png") if cfg.use_masks else None
                ),
                backward_flow_path=str(motion / "flow_bwd" / f"{stem}.npy"),
                forward_flow_path=str(motion / "flow_fwd" / f"{stem}.npy"),
                backward_neighbor_index=(
                    get_neighbor(idx, val_frames, -1, interleaved=False)
                    if idx > 0 else 0
                ),
                forward_neighbor_index=(
                    get_neighbor(idx, val_frames, 1, interleaved=False)
                    if idx < n - 1 else idx
                ),
                is_val=is_val,
            )
        )

    # null out-of-range neighbours: a val frame at the sequence boundary makes
    # the skip walk past the end
    for it in items:
        if it.backward_neighbor_index is not None and it.backward_neighbor_index < 0:
            it.backward_neighbor_index = None
            it.backward_flow_path = None
        if it.forward_neighbor_index is not None and it.forward_neighbor_index >= n:
            it.forward_neighbor_index = None
            it.forward_flow_path = None

    # bounds from depth when available, else from camera origins
    mn = mx = None
    for it in items:
        if it.depth_path and Path(it.depth_path).exists():
            depth = np.load(it.depth_path)
            if depth.shape != (it.H, it.W):
                # pipeline depth is often at a working resolution (640x192):
                # unprojected against the native intrinsics it would skew
                # every point sideways
                depth = resize_nearest_cv(depth, it.W, it.H)
            mn, mx = get_bounds_from_depth(it, depth, mn, mx)
    if mn is None:
        origins = np.stack([it.c2w[:3, 3] for it in items])
        mn, mx = origins.min(0) - 1.0, origins.max(0) + 1.0

    origin, psf, scene_bounds = scale_bounds(items, mn, mx)
    for it in items:
        normalize_timestamp(it, 0, n - 1)
    write_metadata(cfg.output_path, items, origin, psf, scene_bounds)
    return items
