"""The motion-mask chain on a dynamic scene with exact ground truth.

The port's dynamic street scene (two moving cars, ``data.synthetic_kitti``)
gives exact depth, ego-motion, optical flow and the true moving masks, so
the pipeline's chain can be scored (IoU against the true dynamic mask):

  exact depth + ego pose --pose2flow--> rigid flow
  exact dynamic flow     --------------> optical flow (the flow net's stand-in)
  moving_probability -> hard_motion_mask -> instances_from_components
  -> per_object_fusion -> combined dynamic mask  ==IoU==>  true dynamic mask

It also checks the geometry: the rigid flow must match the optical flow on
static pixels (median < 1 px). tools/demo_motion_pipeline_torch.py and
chip_smoke.py run it.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from nerf_kbs_tpu_torch.data.synthetic_kitti import (
    CX, CY, FX, FY, make_movers, make_poses, make_scene, render_dynamic_flow,
    render_dynamic_frame,
)
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.process_data.motion_mask import (
    hard_motion_mask, instances_from_components, moving_probability, per_object_fusion,
)
from nerf_kbs_tpu_torch.process_data.warp import pose2flow


def overlay(rgb: np.ndarray, dyn_pred: np.ndarray, dyn_gt: np.ndarray) -> np.ndarray:
    """rgb with the predicted dynamic pixels tinted red and the missed true
    ones green."""
    out = rgb.copy()
    out[dyn_pred] = 0.65 * out[dyn_pred] + 0.35 * np.array([1.0, 0, 0])
    miss = dyn_gt & ~dyn_pred
    out[miss] = 0.65 * out[miss] + 0.35 * np.array([0, 1.0, 0])
    return out


def exact_motion_chain(n_frames: int, h: int, w: int, th: float, device=None) -> dict:
    """The chain over the frame pairs of an ``n_frames`` clip at h x w: per
    pair, exact depth and pose -> pose2flow -> moving_probability ->
    hard_motion_mask (times the flow's validity) ->
    instances_from_components(min_area=32) -> per_object_fusion, scored by
    IoU against the true dynamic mask; the flows and probabilities on
    ``device`` (CUDA unless "cpu"). -> {"mean_iou", "per_frame_iou" (rounded
    to 4 places), "median_static_flow_err_px" and
    "mean_of_median_static_flow_err_px" (of the per-pair medians, rounded to
    4 places), "masks" (uint8 0/1), "overlays" (float rgb, see ``overlay``),
    "seconds_ops" (the device ops' host seconds)}."""
    dev = resolve_device(device)
    sx, sy = w / 1242.0, h / 375.0
    cam = (FX * sx, FY * sy, CX * sx, CY * sy)
    K = np.array([[cam[0], 0, cam[2]], [0, cam[1], cam[3]], [0, 0, 1.0]], np.float32)
    K_t = torch.as_tensor(K, device=dev)[None]
    K_inv_t = torch.as_tensor(np.linalg.inv(K).astype(np.float32), device=dev)[None]
    static = make_scene(0, n_frames * 0.8 + 90.0)
    movers = make_movers()
    poses = make_poses(n_frames)
    ious, static_errs, masks, overlays, ops_s = [], [], [], [], 0.0
    for i in range(n_frames - 1):
        rgb, depth, _, dyn_gt = render_dynamic_frame(poses[i], static, movers, i, h, w, *cam)
        optical, valid, _ = render_dynamic_flow(poses[i], poses[i + 1], static, movers, i, i + 1,
                                                h, w, *cam)
        # ego-motion a -> b in the cam0 convention: T = inv(P_b) @ P_a
        Pa, Pb = np.eye(4), np.eye(4)
        Pa[:3], Pb[:3] = poses[i], poses[i + 1]
        rel = (np.linalg.inv(Pb) @ Pa)[:3].astype(np.float32)
        t0 = time.perf_counter()
        rigid = pose2flow(torch.as_tensor(depth, device=dev)[None],
                          torch.as_tensor(rel, device=dev)[None], K_t, K_inv_t)[0]
        valid_t = torch.as_tensor(valid, device=dev)
        # invalid pixels (sky, behind the camera) carry the rigid flow, as a
        # real flow net gives flow everywhere
        opt_t = torch.where(valid_t[None], torch.as_tensor(np.moveaxis(optical, -1, 0),
                                                           device=dev), rigid)
        prob = moving_probability(opt_t, rigid)
        hard = (hard_motion_mask(prob, th) * valid_t.to(torch.uint8)).cpu().numpy()
        diff = torch.linalg.vector_norm(opt_t - rigid, dim=0).cpu().numpy()
        ops_s += time.perf_counter() - t0
        static_errs.append(float(np.median(diff[valid & ~dyn_gt])))
        inst = instances_from_components(hard, min_area=32)
        dyn_pred = (1 - per_object_fusion(inst, hard)).astype(bool)
        union = float((dyn_pred | dyn_gt).sum())
        ious.append(float((dyn_pred & dyn_gt).sum()) / max(union, 1.0))
        masks.append(dyn_pred.astype(np.uint8))
        overlays.append(overlay(rgb, dyn_pred, dyn_gt))
    return {"mean_iou": float(np.mean(ious)), "per_frame_iou": [round(v, 4) for v in ious],
            "median_static_flow_err_px": round(float(np.median(static_errs)), 4),
            "mean_of_median_static_flow_err_px": round(float(np.mean(static_errs)), 4),
            "masks": masks, "overlays": overlays, "seconds_ops": ops_s}
