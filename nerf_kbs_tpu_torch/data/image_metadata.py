"""ImageMetadata: one frame of a dynamic-scene dataset, its paths and
camera, and lazy loaders of its assets (the JAX package's
``data/image_metadata.py``).

Each loader resizes to the frame's (W, H) on read, as the JAX package's
does with PIL and OpenCV, here with the NumPy resizers of ``utils.images``:
the rgb frame with PIL's LANCZOS, masks with PIL's NEAREST, depth with
OpenCV's INTER_NEAREST, flow with OpenCV's INTER_LINEAR (its displacements
rescaled to the new grid) and its validity with INTER_NEAREST. Frames and
masks are PNG or JPEG (``utils.images.read_image``); depth is ``.npy`` or a
one-channel PNG (16-bit in the dataset's units); features and flow are
``.npy``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from nerf_kbs_tpu_torch.data.datamanager import load_depth
from nerf_kbs_tpu_torch.utils.images import (
    read_image,
    resize_lanczos,
    resize_linear_cv,
    resize_nearest,
    resize_nearest_cv,
)


@dataclasses.dataclass
class ImageMetadata:
    image_path: str
    c2w: np.ndarray  # (3, 4) OpenGL convention
    W: int
    H: int
    intrinsics: np.ndarray  # (4,) fx, fy, cx, cy
    image_index: int
    time: float
    video_id: int
    depth_path: Optional[str] = None
    mask_path: Optional[str] = None
    sky_mask_path: Optional[str] = None
    feature_path: Optional[str] = None
    backward_flow_path: Optional[str] = None
    forward_flow_path: Optional[str] = None
    backward_neighbor_index: Optional[int] = None
    forward_neighbor_index: Optional[int] = None
    is_val: bool = False
    pose_scale_factor: float = 1.0
    local_cache: Optional[str] = None

    def _cached(self, path: str) -> str:
        """``path``, or its copy in ``local_cache`` (made on first use, keyed
        by the path's hash)."""
        if self.local_cache is None:
            return path
        key = hashlib.sha1(path.encode()).hexdigest()
        cached = Path(self.local_cache) / key[:2] / (key + Path(path).suffix)
        if not cached.exists():
            cached.parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(path, cached)
        return str(cached)

    def _resized(self, px: np.ndarray, resize) -> np.ndarray:
        return px if px.shape[:2] == (self.H, self.W) else resize(px, self.W, self.H)

    def load_image(self) -> np.ndarray:
        """(H, W, 3) uint8, LANCZOS-resized to (W, H) if needed."""
        return self._resized(read_image(self._cached(self.image_path), "RGB"), resize_lanczos)

    def _load_binary_mask(self, path: str) -> np.ndarray:
        return self._resized(read_image(self._cached(path), "L"), resize_nearest) > 0

    def load_mask(self) -> np.ndarray:
        """(H, W) bool; True = a static pixel, supervised."""
        if self.mask_path is None:
            return np.ones((self.H, self.W), bool)
        return self._load_binary_mask(self.mask_path)

    def load_sky_mask(self) -> Optional[np.ndarray]:
        if self.sky_mask_path is None:
            return None
        return self._load_binary_mask(self.sky_mask_path)

    def load_depth(self) -> Optional[np.ndarray]:
        """(H, W) float32 metric depth over ``pose_scale_factor`` (the
        normalised scene's units); 0 = invalid."""
        if self.depth_path is None:
            return None
        d = load_depth(self._cached(self.depth_path), 1.0)
        return self._resized(d, resize_nearest_cv) / self.pose_scale_factor

    def load_features(self) -> Optional[np.ndarray]:
        if self.feature_path is None:
            return None
        return np.load(self._cached(self.feature_path)).astype(np.float32)

    def _load_flow(self, path: Optional[str]):
        """Flow stored as .npy (H, W, 2), or (H, W, 3) with a validity
        channel: (flow (H, W, 2) float32, valid (H, W) bool), or (None, None).
        Flow of another size (computed at a working resolution) is resized
        and its displacements scaled to this frame's pixels."""
        if path is None:
            return None, None
        arr = np.load(self._cached(path)).astype(np.float32)
        if arr.shape[-1] == 3:
            flow, valid = arr[..., :2], arr[..., 2] > 0
        else:
            flow, valid = arr, np.ones(arr.shape[:2], bool)
        if flow.shape[:2] != (self.H, self.W):
            sy = self.H / flow.shape[0]
            sx = self.W / flow.shape[1]
            flow = resize_linear_cv(flow, self.W, self.H) * np.array([sx, sy], np.float32)
            valid = resize_nearest_cv(valid.astype(np.uint8), self.W, self.H).astype(bool)
        return flow, valid

    def load_backward_flow(self):
        return self._load_flow(self.backward_flow_path)

    def load_forward_flow(self):
        return self._load_flow(self.forward_flow_path)


def cameras_np(items: list[ImageMetadata]) -> dict:
    """The camera arrays of ``items`` as DataparserOutputs holds them: fx,
    fy, cx, cy (N,) f32, c2w (N, 3, 4) f32, width, height (N,) int32."""
    return {
        "fx": np.array([it.intrinsics[0] for it in items], np.float32),
        "fy": np.array([it.intrinsics[1] for it in items], np.float32),
        "cx": np.array([it.intrinsics[2] for it in items], np.float32),
        "cy": np.array([it.intrinsics[3] for it in items], np.float32),
        "c2w": np.stack([np.asarray(it.c2w)[:3, :4] for it in items]).astype(np.float32),
        "width": np.array([it.W for it in items], np.int32),
        "height": np.array([it.H for it in items], np.int32),
    }
