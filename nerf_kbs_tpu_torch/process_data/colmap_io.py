"""COLMAP model reader (text and binary, cameras, images and points3D) and
the transforms.json writer (a NumPy copy of the JAX package's
``process_data/colmap_io.py``): the transforms.json that
``data.dataparsers.transforms_json`` parses, with the OpenCV -> OpenGL
conversion and the applied_transform record. Written from the public
COLMAP model-format specification."""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from nerf_kbs_tpu_torch.cameras import poses as P

# COLMAP camera model ids -> (name, num_params)
_CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
}
_MODEL_IDS = {name: i for i, (name, _) in _CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    camera_id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    image_id: int
    qvec: np.ndarray  # (4,) w x y z
    tvec: np.ndarray  # (3,)
    camera_id: int
    name: str


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


# ---------------------------------------------------------------- text model


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    for line in open(path, encoding="utf-8"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cams[int(parts[0])] = ColmapCamera(
            int(parts[0]), parts[1], int(parts[2]), int(parts[3]),
            np.array([float(v) for v in parts[4:]]),
        )
    return cams


def read_images_text(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    lines = [l.strip() for l in open(path, encoding="utf-8")]
    lines = [l for l in lines if not l.startswith("#")]
    # images.txt alternates metadata lines with (possibly empty) 2D-point
    # lines; drop leading blank lines but keep the alternation intact
    while lines and not lines[0]:
        lines.pop(0)
    for meta_line in lines[0::2]:
        if not meta_line:
            continue
        p = meta_line.split()
        imgs[int(p[0])] = ColmapImage(
            int(p[0]),
            np.array([float(v) for v in p[1:5]]),
            np.array([float(v) for v in p[5:8]]),
            int(p[8]),
            p[9],
        )
    return imgs


# -------------------------------------------------------------- binary model


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            cid, model_id, w, h = struct.unpack("<iiQQ", f.read(24))
            name, np_params = _CAMERA_MODELS[model_id]
            params = struct.unpack("<" + "d" * np_params, f.read(8 * np_params))
            cams[cid] = ColmapCamera(cid, name, w, h, np.array(params))
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            iid = struct.unpack("<i", f.read(4))[0]
            q = struct.unpack("<dddd", f.read(32))
            t = struct.unpack("<ddd", f.read(24))
            cam_id = struct.unpack("<i", f.read(4))[0]
            name = b""
            while True:
                ch = f.read(1)
                if ch == b"\x00":
                    break
                name += ch
            (npts,) = struct.unpack("<Q", f.read(8))
            f.read(24 * npts)  # skip 2D points (x, y, point3D_id)
            imgs[iid] = ColmapImage(iid, np.array(q), np.array(t), cam_id, name.decode())
    return imgs


@dataclass
class ColmapPoint3D:
    point_id: int
    xyz: np.ndarray  # (3,)
    rgb: np.ndarray  # (3,) uint8
    error: float
    image_ids: np.ndarray  # (track_len,) int32


def read_points3d_text(path: str) -> dict[int, ColmapPoint3D]:
    pts = {}
    for line in open(path, encoding="utf-8"):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        p = line.split()
        pts[int(p[0])] = ColmapPoint3D(
            int(p[0]),
            np.array([float(v) for v in p[1:4]]),
            np.array([int(v) for v in p[4:7]], np.uint8),
            float(p[7]),
            np.array([int(v) for v in p[8::2]], np.int32),
        )
    return pts


def read_points3d_binary(path: str) -> dict[int, ColmapPoint3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        for _ in range(n):
            pid = struct.unpack("<Q", f.read(8))[0]
            xyz = struct.unpack("<ddd", f.read(24))
            rgb = struct.unpack("<BBB", f.read(3))
            (err,) = struct.unpack("<d", f.read(8))
            (track_len,) = struct.unpack("<Q", f.read(8))
            track = struct.unpack("<" + "ii" * track_len, f.read(8 * track_len))
            pts[pid] = ColmapPoint3D(
                pid, np.array(xyz), np.array(rgb, np.uint8), err,
                np.array(track[0::2], np.int32),
            )
    return pts


def read_points3d(sparse_dir: str) -> dict[int, ColmapPoint3D]:
    d = Path(sparse_dir)
    if (d / "points3D.bin").exists():
        return read_points3d_binary(str(d / "points3D.bin"))
    if (d / "points3D.txt").exists():
        return read_points3d_text(str(d / "points3D.txt"))
    return {}


def read_model(sparse_dir: str):
    """Read (cameras, images) from a COLMAP sparse dir (binary preferred)."""
    d = Path(sparse_dir)
    if (d / "cameras.bin").exists():
        return read_cameras_binary(str(d / "cameras.bin")), read_images_binary(
            str(d / "images.bin")
        )
    return read_cameras_text(str(d / "cameras.txt")), read_images_text(
        str(d / "images.txt")
    )


def colmap_pose_to_c2w(img: ColmapImage) -> np.ndarray:
    """COLMAP stores world->camera (qvec, tvec) in OpenCV convention; return
    (4, 4) camera->world in OpenGL convention."""
    w2c = np.eye(4)
    w2c[:3, :3] = qvec2rotmat(img.qvec)
    w2c[:3, 3] = img.tvec
    c2w = P.invert_se3(w2c[None])[0]
    return P.opencv_to_world(c2w)


def _camera_intrinsics(cam: ColmapCamera) -> dict:
    m, p = cam.model, cam.params
    out = {"w": cam.width, "h": cam.height,
           "k1": 0.0, "k2": 0.0, "k3": 0.0, "k4": 0.0, "p1": 0.0, "p2": 0.0}
    if m == "SIMPLE_PINHOLE":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2])
    elif m == "PINHOLE":
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3])
    elif m == "SIMPLE_RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3])
    elif m == "RADIAL":
        out.update(fl_x=p[0], fl_y=p[0], cx=p[1], cy=p[2], k1=p[3], k2=p[4])
    elif m in ("OPENCV", "OPENCV_FISHEYE"):
        out.update(fl_x=p[0], fl_y=p[1], cx=p[2], cy=p[3],
                   k1=p[4], k2=p[5])
        if m == "OPENCV":
            out.update(p1=p[6], p2=p[7])
        else:
            out.update(k3=p[6], k4=p[7])
    else:
        raise ValueError(f"unsupported COLMAP camera model {m}")
    return {k: (float(v) if not isinstance(v, int) else v) for k, v in out.items()}


def colmap_to_json(
    sparse_dir: str,
    output_dir: str,
    image_rel_dir: str = "images",
    masks_rel_dir: str | None = None,
    depths_rel_dir: str | None = None,
) -> int:
    """COLMAP sparse model -> transforms.json, optionally with each frame's
    mask_path and depth_file_path. Returns the number of frames written."""
    cams, imgs = read_model(sparse_dir)
    if len(cams) == 0:
        raise ValueError(f"no cameras in {sparse_dir}")
    frames = []
    # the world rotation applied to every pose (rows permuted [1, 0, 2], the
    # new z row negated), recorded as applied_transform
    applied = np.array([[0, 1.0, 0], [1.0, 0, 0], [0, 0, -1.0]])
    for iid in sorted(imgs):
        im = imgs[iid]
        c2w = colmap_pose_to_c2w(im)
        c2w[:3] = applied @ c2w[:3]
        stem = Path(im.name).stem
        frame = {
            "file_path": f"{image_rel_dir}/{im.name}",
            "transform_matrix": c2w.tolist(),
            "colmap_im_id": iid,
            **_camera_intrinsics(cams[im.camera_id]),
        }
        if masks_rel_dir:
            frame["mask_path"] = f"{masks_rel_dir}/{stem}.png"
        if depths_rel_dir:
            frame["depth_file_path"] = f"{depths_rel_dir}/{stem}.npy"
        frames.append(frame)
    out = {
        "camera_model": "OPENCV",
        "frames": frames,
        "applied_transform": np.concatenate([applied, np.zeros((3, 1))], 1).tolist(),
    }
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    with open(Path(output_dir) / "transforms.json", "w", encoding="utf-8") as f:
        json.dump(out, f, indent=2)
    return len(frames)
