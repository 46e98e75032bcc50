"""The motion-mask driver: the per-frame-pair pipeline over an image
directory (the JAX package's ``process_data/motion_mask_driver.py``).

For each pair (i, i + 1), at the working size (``width`` x ``height``):
  depth      = monodepth2 disparity of frame i with the flip
               post-processing -> disp_to_depth -> metric scale and clamp
  ego pose   = monodepth2's pose net on the stacked pair (axis-angle)
  rigid flow = pose2flow(depth, pose, K)
  optical    = RAFT(frame i, frame i + 1), ``raft_iters`` iterations
  moving p.  = min-max-normalised |optical| - |rigid|
  hard mask  = p > th_r
  combined   = fused with instances (precomputed masks, panoptic
               annotations, the segmenter, or connected components) at m_th
Outputs: moving_prob/, hard_mask/, combined_mask/, rendered/, cam_flow/ and
depth_show/ PNGs per frame and poses.npy, (N, 4, 4).

Frames are read as PIL's ``Image.open(p).convert("RGB").resize((w, h))``
gives them (BICUBIC, ``utils.images.resize_bicubic``). The networks run on
the CUDA card unless ``device="cpu"``; without a checkpoint they have seeded
weights (``networks.init_weights``)."""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.poses import (
    intrinsics_from_projection,
    read_kitti_calib,
    to_homogeneous,
)
from nerf_kbs_tpu_torch.cameras.transforms import pose_vec2mat
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.process_data import motion_mask as MM
from nerf_kbs_tpu_torch.process_data import warp as W
from nerf_kbs_tpu_torch.utils.images import decode_png, encode_png_u8, image_size, read_image, \
    resize_bicubic

CAMERA_PRESETS = {
    # fx, fy, cx, cy
    "self_collected_I": (1569.6758515689437 / 2, 1569.6758515689437 / 2, 480.0, 270.0),
    "vkitti": (725.0087, 725.0087, 620.5, 187.0),
}


@dataclasses.dataclass
class MotionMaskConfig:
    image_path: str = "images"
    output_path: str = "motion"
    camera: str = "kitti_odom"  # preset name | 'kitti_odom' (calib) | 'custom'
    calib_path: Optional[str] = None  # for kitti_odom: calib.txt with P2
    fx: float = 0.0
    fy: float = 0.0
    cx: float = 0.0
    cy: float = 0.0
    th_r: float = 0.3
    m_th: float = 0.6
    raft_iters: int = 20
    # precomputed instance masks, 0 = object and 255 = static background
    instance_mask_dir: Optional[str] = None
    # KITTI-STEP panoptic annotations (converted to dynamic-class masks)
    panoptic_dir: Optional[str] = None
    # the instance segmenter's .npz checkpoint
    segmenter_ckpt: Optional[str] = None
    # with none of the three above, connected components of the hard mask
    # are the instances
    instances_from_motion: bool = True
    min_instance_area: int = 64
    monodepth_dir: Optional[str] = None  # monodepth2 checkpoint dir (else seeded)
    raft_ckpt: Optional[str] = None
    width: int = 640
    height: int = 192
    depth_camera: str = "kitti"  # metric scale preset
    seed: int = 0


def resolve_intrinsics(cfg: MotionMaskConfig) -> np.ndarray:
    if cfg.camera in CAMERA_PRESETS:
        fx, fy, cx, cy = CAMERA_PRESETS[cfg.camera]
    elif cfg.camera == "kitti_odom":
        if cfg.calib_path is None:
            raise ValueError("camera='kitti_odom' requires calib_path")
        fx, fy, cx, cy, _ = intrinsics_from_projection(read_kitti_calib(cfg.calib_path)["P2"])
    elif cfg.camera == "custom":
        fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    else:
        raise ValueError(f"unknown camera preset {cfg.camera!r}")
    return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]], np.float32)


def pad_to_multiple(img: np.ndarray, mult: int = 8) -> tuple[np.ndarray, tuple]:
    """Replicate-pad H and W up to a multiple -> (padded, (H, W))."""
    h, w = img.shape[:2]
    out = np.pad(img, ((0, (-h) % mult), (0, (-w) % mult)) + ((0, 0),) * (img.ndim - 2),
                 mode="edge")
    return out, (h, w)


def _to_nchw(img: np.ndarray, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(img), device=dev).permute(2, 0, 1)[None]


def _predict_depth(disp_fn, img: np.ndarray, camera: str, dev) -> torch.Tensor:
    """Flip post-processed metric depth (H, W) of an (H, W, 3) frame. The
    frame is replicate-padded to a multiple of 32, the encoder's stride (at
    other sizes the decoder's output is not the input's size), and the
    flipped arm is flipped back over the PADDED width before both arms are
    cropped: the pad lies left of the flipped frame."""
    h0, w0 = img.shape[:2]
    x = _to_nchw(pad_to_multiple(img, 32)[0], dev)
    disp = disp_fn(torch.cat([x, x.flip(-1)]))
    fused = MM.post_process_disparity(disp[:1, :h0, :w0], disp[1:].flip(-1)[:, :h0, :w0])
    _, depth = MM.disp_to_depth(fused[0])
    return MM.metric_depth(depth, camera)


def list_frames(d: str) -> list[Path]:
    return sorted(p for p in Path(d).iterdir() if p.suffix.lower() in (".png", ".jpg", ".jpeg"))


def load_frame(path, width: int, height: int) -> np.ndarray:
    """(H, W, 3) float32 in [0, 1], resized with PIL's BICUBIC."""
    return resize_bicubic(read_image(path, "RGB"), width, height).astype(np.float32) / 255.0


def build_networks(cfg: MotionMaskConfig, dev):
    """(Monodepth2, RAFT, segmenter or None) on ``dev``, in eval mode: the
    configured checkpoints, else seeded weights (seed, seed + 1)."""
    from nerf_kbs_tpu_torch.process_data.networks import init_weights
    from nerf_kbs_tpu_torch.process_data.networks.monodepth2 import (
        Monodepth2,
        load_monodepth2_weights,
    )
    from nerf_kbs_tpu_torch.process_data.networks.raft_port import make_raft
    from nerf_kbs_tpu_torch.process_data.networks.segmenter import load_segmenter

    m2 = Monodepth2()
    if cfg.monodepth_dir:
        m2.load_state_dict(load_monodepth2_weights(cfg.monodepth_dir))
    else:
        init_weights(m2, torch.Generator().manual_seed(cfg.seed))
    raft = make_raft(cfg.raft_iters, cfg.raft_ckpt, cfg.seed + 1)
    seg = load_segmenter(cfg.segmenter_ckpt, device=dev) if cfg.segmenter_ckpt else None
    return m2.to(dev).eval(), raft.to(dev).eval(), seg


def _write_png(path: Path, pixels: np.ndarray) -> None:
    path.write_bytes(encode_png_u8(pixels))


@torch.no_grad()
def run(cfg: MotionMaskConfig, max_frames: Optional[int] = None, device=None) -> dict:
    """Run the pipeline over ``cfg.image_path`` -> {"frames", "dynamic_pixels",
    "output"}."""
    from nerf_kbs_tpu_torch.process_data.networks.segmenter import (
        extract_instances,
        make_inputs,
        predict,
    )

    dev = resolve_device(device)
    frame_paths = list_frames(cfg.image_path)
    if max_frames:
        frame_paths = frame_paths[:max_frames]
    if len(frame_paths) < 2:
        raise ValueError(f"need >= 2 frames under {cfg.image_path}")

    K = resolve_intrinsics(cfg)
    w0, h0 = image_size(frame_paths[0])
    K = K * np.array([[cfg.width / w0], [cfg.height / h0], [1.0]], np.float32)
    K_t = torch.as_tensor(K, device=dev)[None]
    K_inv_t = torch.as_tensor(np.linalg.inv(K), device=dev)[None]
    m2, raft, segmenter = build_networks(cfg, dev)

    out_root = Path(cfg.output_path)
    subdirs = {name: out_root / name for name in ("moving_prob", "hard_mask", "combined_mask",
                                                  "rendered", "cam_flow", "depth_show")}
    for d in subdirs.values():
        d.mkdir(parents=True, exist_ok=True)

    poses = []
    n_dynamic = 0
    img_b = load_frame(frame_paths[0], cfg.width, cfg.height)
    for i in range(len(frame_paths) - 1):
        img_a, img_b = img_b, load_frame(frame_paths[i + 1], cfg.width, cfg.height)
        depth = _predict_depth(m2.predict_disparity, img_a, cfg.depth_camera, dev)
        pose_vec = m2.predict_pose(_to_nchw(img_a, dev), _to_nchw(img_b, dev))[0]
        # RAFT's 1/8 grid and 8x upsampling need multiples of 8: replicate-pad
        # and crop the flow back
        pa, (h, w) = pad_to_multiple(img_a, 8)
        pb, _ = pad_to_multiple(img_b, 8)
        optical = raft.compute_flow(_to_nchw(pa, dev), _to_nchw(pb, dev))[0, :, :h, :w]
        # axis-angle: the pose net's rotation
        rigid = W.pose2flow(depth[None], pose_vec[None], K_t, K_inv_t,
                            rotation_mode="axisangle")[0]
        prob_t = MM.moving_probability(optical, rigid)
        hard = MM.hard_motion_mask(prob_t, cfg.th_r).cpu().numpy()
        prob, rigid, depth = prob_t.cpu().numpy(), rigid.cpu().numpy(), depth.cpu().numpy()
        poses.append(pose_vec.cpu().numpy())

        combined = hard
        if cfg.instance_mask_dir:
            ip = Path(cfg.instance_mask_dir) / frame_paths[i].name
            if ip.exists():
                ins = read_image(ip, "L").astype(np.float32) / 255.0
                # 1 = background, the fusion's own convention
                combined, _ = MM.fuse_instance_motion_mask(ins, hard, cfg.m_th)
        elif cfg.panoptic_dir:
            pp = Path(cfg.panoptic_dir) / frame_paths[i].name
            if pp.exists():
                dyn = MM.panoptic_to_dynamic_mask(decode_png(pp.read_bytes()))
                combined, _ = MM.fuse_instance_motion_mask(1.0 - dyn, hard, cfg.m_th)
        elif segmenter is not None:
            fg, off = predict(segmenter, make_inputs(img_a, prob, optical.cpu().numpy()))
            inst = extract_instances(fg, off, min_area=cfg.min_instance_area)
            if inst.max() > 0:
                combined = 1 - MM.per_object_fusion(inst, hard, cfg.m_th)
        elif cfg.instances_from_motion:
            inst = MM.instances_from_components(hard, cfg.min_instance_area)
            if inst.max() > 0:
                combined = 1 - MM.per_object_fusion(inst, hard, cfg.m_th)
        n_dynamic += int(combined.sum())

        stem = frame_paths[i].stem
        _write_png(subdirs["moving_prob"] / f"{stem}.png", (prob * 255).astype(np.uint8))
        _write_png(subdirs["hard_mask"] / f"{stem}.png", (hard * 255).astype(np.uint8))
        _write_png(subdirs["combined_mask"] / f"{stem}.png", (combined * 255).astype(np.uint8))
        _write_png(subdirs["rendered"] / f"{stem}.png",
                   MM.render_mask_on_image((img_a * 255).astype(np.uint8), combined))
        _write_png(subdirs["cam_flow"] / f"{stem}.png", W.flow_to_image(rigid.transpose(1, 2, 0)))
        _write_png(subdirs["depth_show"] / f"{stem}.png",
                   (np.clip(depth / 80.0, 0, 1) * 255).astype(np.uint8))

    # (N, 4, 4) transformation matrices from the axis-angle pose vectors
    mats = pose_vec2mat(torch.as_tensor(np.stack(poses)), "axisangle").numpy()
    np.save(out_root / "poses.npy", to_homogeneous(mats))
    return {"frames": len(frame_paths) - 1, "dynamic_pixels": n_dynamic, "output": str(out_root)}
