"""DataparserOutputs: host-side NumPy camera arrays and scene box, turned
into torch Cameras on a device once."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.cameras import Cameras
from nerf_kbs_tpu_torch.device import resolve_device


@dataclasses.dataclass
class DataparserOutputs:
    image_filenames: list
    cameras_np: dict  # fx, fy, cx, cy (N,), c2w (N, 3, 4), width, height (N,), distortion?
    scene_box: np.ndarray  # (2, 3) aabb

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
        )
