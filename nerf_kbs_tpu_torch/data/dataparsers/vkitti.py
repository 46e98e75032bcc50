"""Virtual KITTI 2 dataparser (NumPy), the JAX package's
``data/dataparsers/vkitti.py``, for the vanilla-nerf method. The layout:

    <data_dir>/intrinsic.txt   frame cameraID K[0,0] K[1,1] K[0,2] K[1,2]
    <data_dir>/extrinsic.txt   frame cameraID and the 4x4 world -> camera matrix, row-major
    <data_dir>/frames/rgb/Camera_<id>/rgb_<frame:05d>.jpg
    <data_dir>/frames/depth/Camera_<id>/depth_<frame:05d>.png   (16-bit, centimetres)

Each camera's pose is the inverse of its extrinsic matrix (OpenCV axes),
flipped to OpenGL axes, then oriented, centred and scaled into the +-1 box.
The image size is read from the first frame's header (1242x375 when that file
is absent); the frames' times are normalised to [-1, 1].
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from nerf_kbs_tpu_torch.cameras import poses as P
from nerf_kbs_tpu_torch.data.dataparsers.kitti import evenly_spaced_split
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
from nerf_kbs_tpu_torch.utils.images import image_size


@dataclasses.dataclass
class VKittiDataParserConfig:
    data_dir: str = "data/vkitti/Scene01/clone"
    camera_id: int = 0
    first_frame: int = 0
    last_frame: int = -1  # -1: every frame
    use_depth: bool = False
    depth_unit_scale_factor: float = 1e-2  # the depth PNGs hold centimetres
    orientation_method: str = "up"
    center_method: str = "poses"
    auto_scale_poses: bool = True
    train_split_fraction: float = 0.9

    def parse(self, split: str = "train") -> DataparserOutputs:
        return _parse(self, split)


def _read_table(path: Path) -> dict:
    """{(frame, camera): values} of a vKITTI table (one header line)."""
    out = {}
    with open(path, "r", encoding="utf-8") as f:
        f.readline()
        for line in f:
            vals = line.split()
            if len(vals) < 3:
                continue
            out[(int(vals[0]), int(vals[1]))] = np.array([float(v) for v in vals[2:]])
    return out


def _parse(cfg: VKittiDataParserConfig, split: str) -> DataparserOutputs:
    root = Path(cfg.data_dir)
    intr = _read_table(root / "intrinsic.txt")
    extr = _read_table(root / "extrinsic.txt")
    cam = cfg.camera_id
    frames = sorted(f for (f, c) in extr if c == cam)
    if cfg.last_frame >= 0:
        frames = [f for f in frames if cfg.first_frame <= f < cfg.last_frame]
    else:
        frames = [f for f in frames if f >= cfg.first_frame]
    if not frames:
        raise ValueError(f"no frames for camera {cam} under {root}")

    c2ws, fx, fy, cx, cy = [], [], [], [], []
    image_filenames, depth_filenames = [], []
    for f in frames:
        k = intr[(f, cam)]
        fx.append(k[0])
        fy.append(k[1])
        cx.append(k[2])
        cy.append(k[3])
        c2w = P.invert_se3(extr[(f, cam)].reshape(4, 4)[None])[0]
        c2ws.append(P.opencv_to_world(c2w))
        image_filenames.append(str(root / "frames" / "rgb" / f"Camera_{cam}" / f"rgb_{f:05d}.jpg"))
        depth_filenames.append(
            str(root / "frames" / "depth" / f"Camera_{cam}" / f"depth_{f:05d}.png"))

    poses, transform = P.auto_orient_and_center_poses(
        np.stack(c2ws), method=cfg.orientation_method, center_method=cfg.center_method)
    scale = 1.0
    if cfg.auto_scale_poses:
        scale = 1.0 / max(float(np.max(np.abs(poses[:, :3, 3]))), 1e-12)
    poses[:, :3, 3] *= scale

    try:
        w0, h0 = image_size(image_filenames[0])
    except FileNotFoundError:
        w0, h0 = 1242, 375  # vKITTI 2's frame size

    indices = evenly_spaced_split(len(frames), cfg.train_split_fraction, split)
    n = len(indices)
    times = (np.array(frames, np.float32) - frames[0]) / max(frames[-1] - frames[0], 1)
    times = times * 2.0 - 1.0
    cameras_np = {
        "fx": np.array(fx, np.float32)[indices],
        "fy": np.array(fy, np.float32)[indices],
        "cx": np.array(cx, np.float32)[indices],
        "cy": np.array(cy, np.float32)[indices],
        "c2w": poses[indices, :3, :4].astype(np.float32),
        "width": np.full(n, w0, np.int32),
        "height": np.full(n, h0, np.int32),
    }
    return DataparserOutputs(
        image_filenames=[image_filenames[i] for i in indices],
        cameras_np=cameras_np,
        scene_box=np.array([[-1.0] * 3, [1.0] * 3]),
        depth_filenames=[depth_filenames[i] for i in indices] if cfg.use_depth else None,
        depth_unit_scale_factor=cfg.depth_unit_scale_factor,
        times=times[indices],
        dataparser_transform=transform,
        dataparser_scale=scale,
    )
