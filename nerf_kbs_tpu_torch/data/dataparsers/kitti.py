"""KITTI odometry dataparser (NumPy), the JAX package's
``data/dataparsers/kitti.py``.

Frame window [first_frame, last_frame), P2 intrinsics from calib.txt, the
stereo-baseline shift of cam2, the KITTI-camera -> z-up world rotation, the
OpenCV -> OpenGL flip, auto orient / centre / scale into the +-1 box, the
evenly spaced train / eval split, semantics from semantics_list.txt, per-frame
depth .npy paths with depth_unit_scale_factor, and fixed-size perspective
cameras.
"""

from __future__ import annotations

import csv
import dataclasses
import math
from pathlib import Path
from typing import Optional

import numpy as np

from nerf_kbs_tpu_torch.cameras import poses as P
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs, Semantics

# KITTI cam0 axes (x right, y down, z forward) -> a z-up world frame
_KITTI_TO_WORLD = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
# the world-axis relabel after the OpenCV -> OpenGL flip: rows [1, 0, 2], z
# negated
_WORLD_RELABEL = np.array([[0.0, 1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, -1.0]])


@dataclasses.dataclass
class KittiDataParserConfig:
    data_dir: str = "data/kitti"
    sequence: str = "00"
    first_frame: int = 0
    last_frame: int = 50
    mask_dir: Optional[str] = None
    semantics_dir: Optional[str] = None
    use_depth: bool = False
    depth_unit_scale_factor: float = 1e-3
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    scale_factor: float = 1.0
    mask_classes: tuple[str, ...] = ()
    image_height: int = 376
    image_width: int = 1241

    def parse(self, split: str = "train") -> DataparserOutputs:
        return _parse_kitti(self, split)


def evenly_spaced_split(n: int, train_fraction: float, split: str) -> np.ndarray:
    """ceil(n * fraction) evenly spaced train indices, the first and the last
    among them; eval ('val', 'test' or 'eval') is the rest."""
    i_train = np.linspace(0, n - 1, math.ceil(n * train_fraction), dtype=int)
    if split == "train":
        return i_train
    if split in ("val", "test", "eval"):
        return np.setdiff1d(np.arange(n), i_train)
    raise ValueError(f"unknown split {split!r}")


def _parse_kitti(cfg: KittiDataParserConfig, split: str) -> DataparserOutputs:
    data_dir = Path(cfg.data_dir)
    calib = P.read_kitti_calib(str(data_dir / "calib.txt"))
    fx, fy, cx, cy, _ = P.intrinsics_from_projection(calib["P2"])
    T2 = np.eye(4)
    T2[0, 3] = calib["P2"][0, 3] / calib["P2"][0, 0]  # the x baseline shift only

    all_poses = P.read_kitti_poses(str(data_dir / f"{cfg.sequence}.txt"))
    frames = list(range(cfg.first_frame, cfg.last_frame))
    if not frames:
        raise ValueError(f"empty frame window [{cfg.first_frame}, {cfg.last_frame})")
    if max(frames) >= len(all_poses):
        raise ValueError(f"frame window [{cfg.first_frame}, {cfg.last_frame}) exceeds pose "
                         f"count {len(all_poses)}")

    c2ws, image_filenames, depth_filenames, mask_filenames, sem_filenames = [], [], [], [], []
    for i in frames:
        pose = all_poses[i] @ T2  # cam2 (left colour) in the cam0 frame
        pose = P.to_homogeneous(_KITTI_TO_WORLD @ pose[:3])
        pose = P.opencv_to_world(pose)
        pose[:3] = _WORLD_RELABEL @ pose[:3]
        c2ws.append(pose)
        image_filenames.append(str(data_dir / cfg.sequence / f"{i:06}.png"))
        depth_filenames.append(str(data_dir / "depth" / f"{i:06}.npy"))
        if cfg.mask_dir is not None:
            mask_filenames.append(str(Path(cfg.mask_dir) / f"{i:06}.png"))
        if cfg.semantics_dir is not None:
            sem_filenames.append(str(Path(cfg.semantics_dir) / f"{i:06}.png"))

    poses, transform = P.auto_orient_and_center_poses(
        np.stack(c2ws), method=cfg.orientation_method, center_method=cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-12)
    scale *= cfg.scale_factor
    poses[:, :3, 3] *= scale

    indices = evenly_spaced_split(len(frames), cfg.train_split_fraction, split)
    semantics = None
    if cfg.semantics_dir is not None:
        semantics = _read_semantics_csv(str(data_dir / "semantics_list.txt"),
                                        list(cfg.mask_classes))
        semantics.filenames = [sem_filenames[i] for i in indices]

    n = len(indices)
    cameras_np = {
        "fx": np.full(n, fx, np.float32),
        "fy": np.full(n, fy, np.float32),
        "cx": np.full(n, cx, np.float32),
        "cy": np.full(n, cy, np.float32),
        "c2w": poses[indices, :3, :4].astype(np.float32),
        "width": np.full(n, cfg.image_width, np.int32),
        "height": np.full(n, cfg.image_height, np.int32),
    }
    return DataparserOutputs(
        image_filenames=[image_filenames[i] for i in indices],
        cameras_np=cameras_np,
        scene_box=np.array([[-1.0] * 3, [1.0] * 3]),
        mask_filenames=[mask_filenames[i] for i in indices] if cfg.mask_dir is not None else None,
        depth_filenames=[depth_filenames[i] for i in indices] if cfg.use_depth else None,
        depth_unit_scale_factor=cfg.depth_unit_scale_factor,
        semantics=semantics,
        dataparser_transform=transform,
        dataparser_scale=scale,
    )


def _read_semantics_csv(path: str, mask_classes: list[str]) -> Semantics:
    """semantics_list.txt: a CSV with a header, then Category,R,G,B rows."""
    classes: list[str] = []
    colors: list[list[float]] = []
    with open(path, newline="", encoding="utf-8") as f:
        reader = csv.reader(f)
        next(reader)
        for row in reader:
            if row:
                classes.append(row[0].strip())
                colors.append([float(v) / 255.0 for v in row[1:4]])
    return Semantics(classes=classes, colors=np.array(colors, np.float64),
                     mask_classes=mask_classes)
