"""Dataset creation: images (and an optional COLMAP run) -> transforms.json
(the JAX package's ``process_data/create_transform.py``). Copies the images
into images/ and downscales them into images_{2,4,8}/ (PIL's LANCZOS,
``utils.images.resize_lanczos``), optionally runs the external ``colmap``
binary (it stays external), exports each frame's sparse SfM depth, and
writes transforms.json with ``colmap_to_json``. With ``use_existing_model``
(the variant mode) it skips the copy and reads an existing sparse model."""

from __future__ import annotations

import dataclasses
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from nerf_kbs_tpu_torch.process_data.colmap_io import (
    _camera_intrinsics,
    colmap_to_json,
    qvec2rotmat,
    read_model,
    read_points3d,
)
from nerf_kbs_tpu_torch.utils.images import encode_png_u8, read_image, resize_lanczos
from nerf_kbs_tpu_torch.utils.jpeg import encode_jpeg


@dataclasses.dataclass
class ProcessImagesConfig:
    data: str = "images"
    output_dir: str = "processed"
    num_downscales: int = 3  # write images_2, images_4, images_8
    skip_colmap: bool = True  # external binary; run only when requested
    colmap_binary: str = "colmap"
    camera_model: str = "OPENCV"
    export_sfm_depth: bool = False
    use_existing_model: Optional[str] = None  # 'variant' mode: colmap/0 dir


def _downscale(img: np.ndarray, factor: int) -> np.ndarray:
    h, w = img.shape[:2]
    return resize_lanczos(img, max(w // factor, 1), max(h // factor, 1))


def _encode(img: np.ndarray, suffix: str) -> bytes:
    # PIL's save by suffix: PNG, or JPEG at its default quality 75
    return encode_png_u8(img) if suffix == ".png" else encode_jpeg(img, quality=75)


def copy_and_downscale(cfg: ProcessImagesConfig) -> list[str]:
    """images -> output_dir/images + images_{2^k}; returns the new names
    (frame_%05d with the original extension)."""
    src = sorted(
        p for p in Path(cfg.data).iterdir()
        if p.suffix.lower() in (".png", ".jpg", ".jpeg")
    )
    if not src:
        raise ValueError(f"no images under {cfg.data}")
    out = Path(cfg.output_dir)
    names = []
    for k in range(cfg.num_downscales + 1):
        (out / ("images" if k == 0 else f"images_{2**k}")).mkdir(parents=True, exist_ok=True)
    for i, p in enumerate(src):
        name = f"frame_{i:05d}{p.suffix.lower()}"
        names.append(name)
        shutil.copyfile(p, out / "images" / name)
        im = read_image(p, "RGB")
        for k in range(1, cfg.num_downscales + 1):
            (out / f"images_{2**k}" / name).write_bytes(_encode(_downscale(im, 2**k),
                                                               p.suffix.lower()))
    return names


def run_colmap(cfg: ProcessImagesConfig) -> Path:
    """Run the external COLMAP binary (feature_extractor -> matcher ->
    mapper). Returns the sparse model dir."""
    out = Path(cfg.output_dir)
    db = out / "colmap" / "database.db"
    sparse = out / "colmap" / "sparse"
    sparse.mkdir(parents=True, exist_ok=True)
    runs = [
        [cfg.colmap_binary, "feature_extractor", "--database_path", str(db),
         "--image_path", str(out / "images"),
         "--ImageReader.camera_model", cfg.camera_model,
         "--ImageReader.single_camera", "1"],
        [cfg.colmap_binary, "exhaustive_matcher", "--database_path", str(db)],
        [cfg.colmap_binary, "mapper", "--database_path", str(db),
         "--image_path", str(out / "images"), "--output_path", str(sparse)],
    ]
    for cmd in runs:
        subprocess.run(cmd, check=True, capture_output=True)
    return sparse / "0"


def export_sfm_depth(
    sparse_dir: str, output_dir: str, max_repro_error: float = 4.0
) -> int:
    """Project COLMAP 3D points into each frame -> a sparse depth .npy per
    image: each point's z-depth splatted at its projected pixel in every
    image of its track; nearer points win where splats collide; points of
    high reprojection error are dropped. 0 = no depth. Returns frames
    written."""
    cams, imgs = read_model(sparse_dir)
    points = read_points3d(sparse_dir)
    per_image: dict[int, list] = {iid: [] for iid in imgs}
    for p in points.values():
        if p.error > max_repro_error:
            continue
        for iid in set(int(i) for i in p.image_ids):
            if iid in per_image:
                per_image[iid].append(p.xyz)

    d = Path(output_dir) / "depth"
    d.mkdir(parents=True, exist_ok=True)
    n = 0
    for iid, im in imgs.items():
        cam = cams[im.camera_id]
        intr = _camera_intrinsics(cam)
        h, w = int(intr["h"]), int(intr["w"])
        depth = np.full((h, w), np.inf, np.float32)
        pts = per_image[iid]
        if pts:
            X = np.asarray(pts)
            R = qvec2rotmat(im.qvec)
            Xc = X @ R.T + im.tvec  # world -> camera (OpenCV, +z forward)
            z = Xc[:, 2]
            valid = z > 1e-6
            u = np.round(intr["fl_x"] * Xc[:, 0] / np.maximum(z, 1e-6) + intr["cx"]).astype(int)
            v = np.round(intr["fl_y"] * Xc[:, 1] / np.maximum(z, 1e-6) + intr["cy"]).astype(int)
            valid &= (u >= 0) & (u < w) & (v >= 0) & (v < h)
            # nearest-point-wins splat: sort far -> near so near overwrites
            order = np.argsort(-z[valid])
            uu, vv, zz = u[valid][order], v[valid][order], z[valid][order]
            depth[vv, uu] = zz
        depth[~np.isfinite(depth)] = 0.0
        np.save(d / f"{Path(im.name).stem}.npy", depth)
        n += 1
    return n


def main(cfg: ProcessImagesConfig) -> str:
    """Full pipeline -> path of the written transforms.json."""
    if cfg.use_existing_model:
        sparse = Path(cfg.use_existing_model)
    else:
        copy_and_downscale(cfg)
        if cfg.skip_colmap:
            sparse = Path(cfg.output_dir) / "colmap" / "sparse" / "0"
            if not sparse.exists():
                raise FileNotFoundError(
                    f"no COLMAP model at {sparse}; run with skip_colmap=False "
                    "or provide use_existing_model"
                )
        else:
            sparse = run_colmap(cfg)
    if cfg.export_sfm_depth:
        export_sfm_depth(str(sparse), cfg.output_dir)
    colmap_to_json(
        str(sparse), cfg.output_dir,
        depths_rel_dir="depth" if cfg.export_sfm_depth else None,
    )
    return str(Path(cfg.output_dir) / "transforms.json")


def split_frame_window(
    filenames: list[str], first_frame: int, last_frame: int
) -> list[str]:
    """The file names of frames first_frame <= i < last_frame, sorted."""
    return [f for i, f in enumerate(sorted(filenames)) if first_frame <= i < last_frame]
