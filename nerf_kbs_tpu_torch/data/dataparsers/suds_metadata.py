"""SUDS-style metadata.json dataparser for dynamic scenes (the JAX package's
``data/dataparsers/suds_metadata.py``).

The file is {origin, scene_bounds, pose_scale_factor, frames}; each frame
has rgb_path, c2w, W, H, intrinsics (fx, fy, cx, cy), image_index, time,
video_id and optional depth / mask / sky-mask / feature / flow paths,
backward and forward neighbour indices and is_val. ``load_items`` makes one
``ImageMetadata`` per frame of a split (train: the frames without is_val,
their neighbour indices remapped onto the kept list; val: those with it),
the input of ``data.stream.ChunkedStreamDataManager``; ``parse`` gives the
split's DataparserOutputs with per-frame times and video ids.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import numpy as np

from nerf_kbs_tpu_torch.data.image_metadata import ImageMetadata, cameras_np
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs


@dataclasses.dataclass
class SudsMetadataConfig:
    metadata_path: str = "metadata.json"
    train_with_val_images: bool = False
    local_cache: Optional[str] = None
    scale_poses: float = 1.0

    def parse(self, split: str = "train") -> DataparserOutputs:
        return _parse(self, split)

    def load_items(self, split: str = "train"):
        """(items of the split, the parsed metadata.json)."""
        return _load_items(self, split)


def _item_from_frame(fr: dict, pose_scale_factor: float, local_cache) -> ImageMetadata:
    return ImageMetadata(
        image_path=fr["rgb_path"],
        c2w=np.array(fr["c2w"], np.float32),
        W=int(fr["W"]),
        H=int(fr["H"]),
        intrinsics=np.array(fr["intrinsics"], np.float32),
        image_index=int(fr["image_index"]),
        time=float(fr["time"]),
        video_id=int(fr["video_id"]),
        depth_path=fr.get("depth_path"),
        mask_path=fr.get("mask_path"),
        sky_mask_path=fr.get("sky_mask_path"),
        feature_path=fr.get("feature_path"),
        backward_flow_path=fr.get("backward_flow_path"),
        forward_flow_path=fr.get("forward_flow_path"),
        backward_neighbor_index=fr.get("backward_neighbor_index"),
        forward_neighbor_index=fr.get("forward_neighbor_index"),
        is_val=bool(fr.get("is_val", False)),
        pose_scale_factor=pose_scale_factor,
        local_cache=local_cache,
    )


def _load_items(cfg: SudsMetadataConfig, split: str):
    with open(cfg.metadata_path, "r", encoding="utf-8") as f:
        meta = json.load(f)
    psf = float(meta["pose_scale_factor"])
    items = [_item_from_frame(fr, psf, cfg.local_cache) for fr in meta["frames"]]
    if split == "train":
        if not cfg.train_with_val_images:
            # neighbour indices point into the whole frame list: remap them
            # onto the kept frames, or drop them (and their flow) when the
            # neighbour is a val frame
            keep = [i for i, it in enumerate(items) if not it.is_val]
            remap = {old: new for new, old in enumerate(keep)}
            items = [items[i] for i in keep]
            for it in items:
                b = None if it.backward_neighbor_index is None else remap.get(
                    it.backward_neighbor_index)
                f = None if it.forward_neighbor_index is None else remap.get(
                    it.forward_neighbor_index)
                it.backward_neighbor_index, it.forward_neighbor_index = b, f
                if b is None:
                    it.backward_flow_path = None
                if f is None:
                    it.forward_flow_path = None
    elif split in ("val", "test", "eval"):
        items = [it for it in items if it.is_val]
    else:
        raise ValueError(f"unknown split {split!r}")
    if not items:
        raise ValueError(f"no frames for split {split!r} in {cfg.metadata_path}")
    return items, meta


def _parse(cfg: SudsMetadataConfig, split: str) -> DataparserOutputs:
    items, meta = _load_items(cfg, split)
    all_items, _ = _load_items(dataclasses.replace(cfg, train_with_val_images=True), "train")
    return DataparserOutputs(
        image_filenames=[it.image_path for it in items],
        cameras_np=cameras_np(items),
        scene_box=np.array(meta["scene_bounds"], np.float64),
        mask_filenames=([it.mask_path for it in items]
                        if all(it.mask_path for it in items) else None),
        depth_filenames=([it.depth_path for it in items]
                         if all(it.depth_path for it in items) else None),
        times=np.array([it.time for it in items], np.float32),
        video_ids=np.array([it.video_id for it in items], np.int32),
        metadata={
            "items": items,
            "all_items": all_items,
            "origin": np.array(meta["origin"], np.float64),
            "pose_scale_factor": float(meta["pose_scale_factor"]),
        },
        dataparser_scale=1.0 / float(meta["pose_scale_factor"]),
    )
