"""DataparserOutputs: what a dataparser hands a datamanager. Host-side NumPy
camera arrays, the scene box, per-frame asset paths and times, and the
semantic class table; the cameras are turned into torch Cameras on a device once."""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.cameras import Cameras
from nerf_kbs_tpu_torch.device import resolve_device


@dataclasses.dataclass
class Semantics:
    """Semantic class table (from semantics_list.txt): class names, colours
    in [0, 1], the classes to mask out of the rgb loss and the per-frame
    label images."""

    classes: list[str]
    colors: np.ndarray  # (K, 3) in [0, 1]
    mask_classes: list[str] = dataclasses.field(default_factory=list)
    filenames: list[str] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class DataparserOutputs:
    image_filenames: list
    cameras_np: dict  # fx, fy, cx, cy (N,), c2w (N, 3, 4), width, height (N,), distortion?
    scene_box: np.ndarray  # (2, 3) aabb
    mask_filenames: Optional[list] = None
    depth_filenames: Optional[list] = None
    depth_unit_scale_factor: float = 1.0
    semantics: Optional[Semantics] = None
    times: Optional[np.ndarray] = None  # (N,) normalised capture times
    video_ids: Optional[np.ndarray] = None  # (N,) int, the sequence of each frame
    metadata: dict = dataclasses.field(default_factory=dict)  # parser-specific extras
    # the world transform and scale the parser applied to the poses
    dataparser_transform: np.ndarray = dataclasses.field(
        default_factory=lambda: np.concatenate([np.eye(3), np.zeros((3, 1))], axis=1)
    )
    dataparser_scale: float = 1.0

    def cameras(self, device=None) -> Cameras:
        """Cameras on ``device`` (CUDA unless ``device="cpu"``)."""
        dev = resolve_device(device)
        c = self.cameras_np

        def f32(v):
            return torch.as_tensor(np.asarray(v, np.float32), device=dev)

        def i32(v):
            return torch.as_tensor(np.asarray(v, np.int32), device=dev)

        return Cameras(
            fx=f32(c["fx"]), fy=f32(c["fy"]), cx=f32(c["cx"]), cy=f32(c["cy"]),
            c2w=f32(c["c2w"]),
            width=i32(c["width"]), height=i32(c["height"]),
            distortion=f32(c["distortion"]) if "distortion" in c else None,
            times=None if self.times is None else f32(self.times),
        )
