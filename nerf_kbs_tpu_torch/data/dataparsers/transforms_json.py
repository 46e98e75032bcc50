"""transforms.json dataparser (NumPy), the nerfstudio / instant-ngp format:
the JAX package's ``data/dataparsers/transforms_json.py``, for the
test-nerfacto method.

Per-frame or global intrinsics (``fl_x``, ``fl_y``, ``cx``, ``cy``, ``w``,
``h``) and OpenCV distortion (``k1``..``k4``, ``p1``, ``p2``); OpenGL
camera-to-world matrices, oriented, centred and scaled into the +-1 box
(times ``scale_factor``); the ``train_filenames`` / ``val_filenames`` /
``test_filenames`` override or the evenly spaced split; the downscale
factor, given or the smallest power of two that brings the frame under
``max_dim``, read from ``images_{d}/`` (and ``depths_{d}/``, ``masks_{d}/``)
folders, full resolution when the image folder is absent; depth and mask
paths for every frame of a split or none, with ``depth_unit_scale_factor``;
``applied_transform`` / ``applied_scale`` composed into the returned
transform and scale.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Optional

import numpy as np

from nerf_kbs_tpu_torch.cameras import poses as P
from nerf_kbs_tpu_torch.data.dataparsers.kitti import evenly_spaced_split
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
from nerf_kbs_tpu_torch.utils.images import image_size

_INTRINSIC_KEYS = ("fl_x", "fl_y", "cx", "cy", "w", "h")
_DISTORTION_KEYS = ("k1", "k2", "k3", "k4", "p1", "p2")


@dataclasses.dataclass
class TransformsJsonConfig:
    data: str = "data/scene"
    scale_factor: float = 1.0
    downscale_factor: Optional[int] = None  # None: the smallest that fits max_dim
    max_dim: int = 1600
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9
    depth_unit_scale_factor: float = 1e-3

    def parse(self, split: str = "train") -> DataparserOutputs:
        return _parse(self, split)


def _frame_intrinsics(frame: dict, meta: dict) -> dict:
    out = {}
    for k in _INTRINSIC_KEYS + _DISTORTION_KEYS:
        v = frame.get(k, meta.get(k))
        out[k] = float(v) if v is not None else None
    if out["fl_x"] is None or out["fl_y"] is None:
        raise ValueError("missing focal length (fl_x/fl_y) in transforms.json")
    return out


def _choose_downscale(h: int, w: int, max_dim: int) -> int:
    d = 1
    while max(h, w) / d > max_dim:
        d *= 2
    return d


def _downscaled_path(data_dir: Path, rel: str, d: int) -> Path:
    """images/f.png -> images_{d}/f.png (the path itself at d = 1)."""
    if d == 1:
        return data_dir / rel
    parts = Path(rel).parts
    return data_dir / f"{parts[0]}_{d}" / Path(*parts[1:])


def _parse(cfg: TransformsJsonConfig, split: str) -> DataparserOutputs:
    data_dir = Path(cfg.data)
    meta_path = data_dir / "transforms.json" if data_dir.is_dir() else data_dir
    data_dir = meta_path.parent
    with open(meta_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    frames = sorted(meta["frames"], key=lambda fr: fr["file_path"])

    c2ws, intr, image_rel, depth_rel, mask_rel = [], [], [], [], []
    for fr in frames:
        c2ws.append(np.array(fr["transform_matrix"], np.float64))
        intr.append(_frame_intrinsics(fr, meta))
        image_rel.append(fr["file_path"])
        depth_rel.append(fr.get("depth_file_path"))
        mask_rel.append(fr.get("mask_path"))
    applied_transform = np.array(
        meta.get("applied_transform", np.concatenate([np.eye(3), np.zeros((3, 1))], 1).tolist()),
        np.float64)
    applied_scale = float(meta.get("applied_scale", 1.0))

    poses, transform = P.auto_orient_and_center_poses(
        np.stack(c2ws), method=cfg.orientation_method, center_method=cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-12)
    scale *= cfg.scale_factor
    poses[:, :3, 3] *= scale

    split_key = {"train": "train_filenames", "val": "val_filenames",
                 "eval": "val_filenames", "test": "test_filenames"}[split]
    if meta.get(split_key):
        wanted = set(meta[split_key])
        idx = np.array([i for i, r in enumerate(image_rel) if r in wanted], int)
        if len(idx) == 0:
            raise ValueError(f"{split_key} given but matched no frames")
    else:
        idx = evenly_spaced_split(len(frames), cfg.train_split_fraction, split)

    first = intr[0]
    h0 = int(first["h"]) if first["h"] else None
    w0 = int(first["w"]) if first["w"] else None
    if h0 is None or w0 is None:
        w0, h0 = image_size(data_dir / image_rel[0])
    d = cfg.downscale_factor or _choose_downscale(h0, w0, cfg.max_dim)
    if d > 1 and not _downscaled_path(data_dir, image_rel[0], d).exists():
        d = 1  # no downscaled folder: full resolution

    # each frame's own size where the file gives one, frame 0's otherwise
    hs = np.array([int(intr[i]["h"]) if intr[i]["h"] else h0 for i in idx])
    ws = np.array([int(intr[i]["w"]) if intr[i]["w"] else w0 for i in idx])
    cxs = np.array([intr[i]["cx"] if intr[i]["cx"] is not None else w / 2
                    for i, w in zip(idx, ws)])
    cys = np.array([intr[i]["cy"] if intr[i]["cy"] is not None else h / 2
                    for i, h in zip(idx, hs)])
    dist = np.array([[intr[i][k] or 0.0 for k in _DISTORTION_KEYS] for i in idx], np.float32)
    cameras_np = {
        "fx": (np.array([intr[i]["fl_x"] for i in idx]) / d).astype(np.float32),
        "fy": (np.array([intr[i]["fl_y"] for i in idx]) / d).astype(np.float32),
        "cx": (cxs / d).astype(np.float32),
        "cy": (cys / d).astype(np.float32),
        "c2w": poses[idx, :3, :4].astype(np.float32),
        "width": (ws // d).astype(np.int32),
        "height": (hs // d).astype(np.int32),
    }
    if np.abs(dist).sum() > 0:
        cameras_np["distortion"] = dist

    def aux_paths(rels: list, kind: str):
        """Depth or mask paths through the downscale folders, for every frame
        of the split or none; a missing downscaled file raises (full-size
        masks with downscaled cameras would be misaligned)."""
        present = [rels[i] is not None for i in idx]
        if not any(present) or not len(idx):
            return None
        if not all(present):
            raise ValueError(f"{kind} specified for {sum(present)}/{len(idx)} frames of "
                             f"the {split} split: must be every frame or none")
        paths = [_downscaled_path(data_dir, rels[i], d) for i in idx]
        if d > 1 and not paths[0].exists():
            raise ValueError(f"downscale {d} active but {paths[0]} is missing: write the "
                             f"downscaled {kind} folder or set downscale_factor=1")
        return [str(p) for p in paths]

    T2 = np.concatenate([transform, [[0, 0, 0, 1.0]]], 0)
    T1 = np.concatenate([applied_transform, [[0, 0, 0, 1.0]]], 0)
    return DataparserOutputs(
        image_filenames=[str(_downscaled_path(data_dir, image_rel[i], d)) for i in idx],
        cameras_np=cameras_np,
        scene_box=np.array([[-1.0] * 3, [1.0] * 3]),
        depth_filenames=aux_paths(depth_rel, "depth_file_path"),
        mask_filenames=aux_paths(mask_rel, "mask_path"),
        depth_unit_scale_factor=cfg.depth_unit_scale_factor,
        dataparser_transform=(T2 @ T1)[:3],
        dataparser_scale=scale * applied_scale,
    )
