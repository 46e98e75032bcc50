"""Train and evaluate the learned instance segmenter on generator scenes, on
the PyTorch port (the counterpart of tools/train_segmenter.py).

The segmenter (process_data/networks/segmenter.py: a U-Net with
centroid-offset voting) trains on the synthetic generator's free instance
labels and is scored against the weight-free connected-component
substitute on held-out scenes that contain touching or overlapping movers,
the case components cannot separate.

The whole training set lives on the device and each step gathers its
minibatch there from an index vector drawn on the host, as the JAX tool
does. The network starts from seeded weights (networks.init_weights, seed
0). Runs on the CUDA card unless --platform cpu; without CUDA it raises.

Outputs (under --out):
  segmenter.npz     the trained checkpoint, in the JAX package's .npz layout
                    (loadable by either package's load_segmenter)
  result.json       train metrics and held-out instance and mask metrics,
                    with the JAX tool's keys

Usage: python tools/train_segmenter_torch.py --scenes 20 --steps 2000
"""

from __future__ import annotations

import sys
from pathlib import Path

# repo-root import shim: `python tools/x.py` puts tools/ (not the repo
# root) on sys.path, so nerf_kbs_tpu_torch would not resolve without this
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import argparse
import json
import time

import numpy as np
import torch

from nerf_kbs_tpu_torch.data.synthetic_kitti import (
    CAM_HEIGHT, CX, CY, FX, FY, Box, Mover, make_poses, make_scene, render_dynamic_flow,
    render_dynamic_frame,
)
from nerf_kbs_tpu_torch.process_data import motion_mask as MM
from nerf_kbs_tpu_torch.process_data.networks import init_weights
from nerf_kbs_tpu_torch.process_data.networks.segmenter import (
    InstanceSegmenter, SegmenterConfig, boundary_weight, extract_instances, load_segmenter,
    make_inputs, make_segmenter_train_step, make_targets, predict, save_segmenter,
)
from study_field_torch import platform_device

# ---------------------------------------------------------------------------
# scene + sample generation
# ---------------------------------------------------------------------------


def random_movers(rng: np.random.Generator, touching: bool):
    """2-4 moving cars; with ``touching``, two of them are adjacent (gap <
    0.3 m) with different velocities: the failure case for connected
    components."""
    movers = []

    def car(x0, z0, wx, wz, vel, col):
        lo = np.array([x0, CAM_HEIGHT - rng.uniform(1.3, 1.7), z0])
        hi = np.array([x0 + wx, CAM_HEIGHT, z0 + wz])
        return Mover(Box(lo, hi, "car", np.asarray(col)), np.asarray(vel))

    n = int(rng.integers(2, 5))
    cols = rng.uniform(0.1, 0.9, (n + 2, 3))
    if touching:
        # adjacent pair near the road center, crossing at different speeds
        x0 = rng.uniform(-5.5, -2.0)
        z0 = rng.uniform(16.0, 30.0)
        w1, w2 = rng.uniform(2.0, 3.5, 2)
        gap = rng.uniform(0.05, 0.3)
        movers.append(car(x0, z0, w1, rng.uniform(1.6, 2.4),
                          [rng.uniform(0.5, 0.9), 0, 0], cols[0]))
        movers.append(car(x0 + w1 + gap, z0 + rng.uniform(-0.5, 0.5), w2,
                          rng.uniform(1.6, 2.4),
                          [rng.uniform(0.15, 0.4), 0, 0], cols[1]))
        n = max(n - 2, 0)
    for i in range(n):
        kind = rng.integers(0, 3)
        x0 = rng.uniform(-6.5, 2.5)
        z0 = rng.uniform(14.0, 55.0)
        if kind == 0:  # crossing
            vel = [rng.uniform(0.4, 1.1) * (1 if rng.random() < 0.5 else -1), 0, 0]
            wx, wz = rng.uniform(2.5, 4.2), rng.uniform(1.6, 2.2)
        elif kind == 1:  # oncoming
            vel = [0, 0, -rng.uniform(1.0, 2.0)]
            wx, wz = rng.uniform(1.6, 2.2), rng.uniform(3.0, 4.6)
        else:  # same direction, slower than ego
            vel = [0, 0, rng.uniform(0.2, 0.6)]
            wx, wz = rng.uniform(1.6, 2.2), rng.uniform(3.0, 4.6)
        movers.append(car(x0, z0, wx, wz, vel, cols[2 + i]))
    return movers


def static_reprojection_flow(pose_a, pose_b, zdepth, fx, fy, cx, cy):
    """Rigid (ego-motion-only) flow from frame-a depth: every hit point is
    reprojected into frame b without the movers' displacement, as the
    pipeline's pose2flow(depth, ego_pose) input is."""
    h, w = zdepth.shape
    # sky renders zdepth 0; the real pipeline's monodepth is dense and
    # clamped to 80 m (disp_to_depth): sky behaves as distant static geometry
    zdepth = np.where(zdepth > 0, zdepth, 80.0)
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    d_cam = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)], -1)
    pts = (d_cam * zdepth[..., None]) @ pose_a[:3, :3].T + pose_a[:3, 3]
    rel = (pts - pose_b[:3, 3]) @ pose_b[:3, :3]
    z = np.maximum(rel[..., 2], 1e-6)
    u1 = fx * rel[..., 0] / z + cx
    v1 = fy * rel[..., 1] / z + cy
    return np.stack([u1 - xs, v1 - ys], axis=0).astype(np.float32)  # (2, H, W)


def moving_probability_np(optical: np.ndarray, rigid: np.ndarray) -> np.ndarray:
    """NumPy mirror of motion_mask.moving_probability, for the host-side
    data generation."""
    o = optical / max(float(np.abs(optical).max()), 1e-12)
    r = rigid / max(float(np.abs(rigid).max()), 1e-12)
    d = np.linalg.norm(o, axis=0) - np.linalg.norm(r, axis=0)
    return (d - d.min()) / max(float(d.max() - d.min()), 1e-12)


def make_samples(seed: int, n_frames: int, h: int, w: int, touching: bool):
    """Render one scene -> list of (x (H,W,6), fg, off, valid, inst)."""
    rng = np.random.default_rng(seed)
    static = make_scene(seed=seed)
    movers = random_movers(rng, touching)
    fx, fy = FX * w / 1242.0, FY * h / 375.0
    cx, cy = CX * w / 1242.0, CY * h / 375.0
    poses = make_poses(n_frames + 1, step=0.8)
    out = []
    for f in range(n_frames):
        rgb, zdepth, _, _, inst = render_dynamic_frame(
            poses[f], static, movers, f, h, w, fx, fy, cx, cy,
            return_instances=True,
        )
        flow, valid, _ = render_dynamic_flow(
            poses[f], poses[f + 1], static, movers, f, f + 1,
            h, w, fx, fy, cx, cy,
        )
        optical = flow.transpose(2, 0, 1)
        rigid = static_reprojection_flow(poses[f], poses[f + 1], zdepth,
                                         fx, fy, cx, cy)
        # invalid pixels (sky, behind the camera) carry flow 0 while the
        # rigid flow is not 0 there; a real flow net gives flow everywhere,
        # so they take the rigid flow, as the motion pipeline demo does
        optical = np.where(valid[None], optical, rigid)
        prob = moving_probability_np(optical, rigid)
        x = make_inputs(rgb, prob, optical)
        fg, off, valid_t = make_targets(inst)
        out.append((x.astype(np.float32), fg, off, valid_t, inst))
    return out


# ---------------------------------------------------------------------------
# instance metrics
# ---------------------------------------------------------------------------


def instance_quality(pred_labels: np.ndarray, gt_labels: np.ndarray) -> float:
    """Mean over GT instances of the best IoU against any predicted
    instance (0 when nothing predicted). Touching objects merged by the
    predictor score ~0.5 here; separated ones ~1."""
    scores = []
    for g in np.unique(gt_labels):
        if g <= 0:
            continue
        gm = gt_labels == g
        best = 0.0
        for p in np.unique(pred_labels):
            if p <= 0:
                continue
            pm = pred_labels == p
            inter = float(np.logical_and(gm, pm).sum())
            union = float(np.logical_or(gm, pm).sum())
            best = max(best, inter / max(union, 1.0))
        scores.append(best)
    return float(np.mean(scores)) if scores else 1.0


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    inter = float(np.logical_and(a > 0, b > 0).sum())
    union = float(np.logical_or(a > 0, b > 0).sum())
    return inter / max(union, 1.0)


def fused_mask(inst: np.ndarray, hard: np.ndarray) -> np.ndarray:
    """The final dynamic mask (1 = dynamic) after per-object fusion."""
    return 1 - MM.per_object_fusion(inst, hard) if inst.max() > 0 else hard


def device_dataset(train: list, device, gain: float = 0.0) -> dict:
    """The training samples stacked as NCHW tensors on ``device``: x (N, 6,
    H, W), fg (N, H, W), off (N, 2, H, W), valid (N, H, W) and, with a
    boundary gain, the per-pixel weight w (N, H, W)."""
    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    data = {"x": put(np.stack([t[0] for t in train]).transpose(0, 3, 1, 2)),
            "fg": put(np.stack([t[1] for t in train])),
            "off": put(np.stack([t[2] for t in train]).transpose(0, 3, 1, 2)),
            "valid": put(np.stack([t[3] for t in train]))}
    if gain > 0:
        data["w"] = put(np.stack([boundary_weight(t[4], gain=gain) for t in train]))
    return data


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenes", type=int, default=20)
    ap.add_argument("--eval-scenes", type=int, default=5)
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--h", type=int, default=96)
    ap.add_argument("--w", type=int, default=320)
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--out", default="outputs/segmenter")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    ap.add_argument(
        "--boundary-gain", type=float, default=0.0,
        help="boundary-aware loss: up-weight pixels within 2px of an "
        "instance boundary by (1 + gain); 0 = off")
    ap.add_argument(
        "--eval-ckpt", default=None,
        help="skip training: load this segmenter.npz and evaluate it on the "
        "(seed-deterministic) held-out scene set")
    args = ap.parse_args(argv)
    dev = platform_device(args.platform)

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    print(f"generating {args.scenes} train + {args.eval_scenes} eval scenes...",
          flush=True)
    t0 = time.time()
    train = []
    if args.eval_ckpt is None:
        for s in range(args.scenes):
            train += make_samples(s, args.frames, args.h, args.w,
                                  touching=(s % 2 == 0))
    # the held-out scenes all contain a touching pair (the hard case)
    evals = []
    for s in range(args.eval_scenes):
        evals += make_samples(1000 + s, args.frames, args.h, args.w,
                              touching=True)
    print(f"  {len(train)} train / {len(evals)} eval frames "
          f"({time.time() - t0:.0f}s)", flush=True)

    if args.eval_ckpt is not None:
        model = load_segmenter(args.eval_ckpt, device=dev)
        last = {}
        train_time = 0.0
    else:
        model = init_weights(InstanceSegmenter(SegmenterConfig()),
                             torch.Generator().manual_seed(0)).to(dev)
        data = device_dataset(train, dev, args.boundary_gain)
        step = make_segmenter_train_step(model, lr=args.lr)
        rng = np.random.default_rng(0)
        t0 = time.time()
        last = {}
        for it in range(args.steps):
            sel = torch.as_tensor(rng.integers(0, len(train), args.batch), device=dev)
            loss, metrics = step({k: v[sel] for k, v in data.items()})
            if (it + 1) % 200 == 0 or it == 0:
                last = {k: float(v) for k, v in metrics.items()}
                print(f"step {it + 1}: loss {float(loss):.4f} {last}", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        train_time = time.time() - t0
        model.eval()

    # ---------------- held-out eval: segmenter vs connected components
    seg_inst_q, cc_inst_q, seg_mask_iou, cc_mask_iou = [], [], [], []
    for x, fg_t, off_t, v_t, inst_gt in evals:
        prob = x[..., 3]
        hard = (prob > 0.3).astype(np.uint8)  # motion_mask.hard_motion_mask, on the host
        gt_mask = (inst_gt > 0).astype(np.uint8)

        fg, off = predict(model, x)
        inst_seg = extract_instances(fg, off)
        inst_cc = MM.instances_from_components(hard)

        seg_inst_q.append(instance_quality(inst_seg, inst_gt))
        cc_inst_q.append(instance_quality(inst_cc, inst_gt))
        seg_mask_iou.append(mask_iou(fused_mask(inst_seg, hard), gt_mask))
        cc_mask_iou.append(mask_iou(fused_mask(inst_cc, hard), gt_mask))

    result = {
        "train_frames": len(train),
        "eval_frames": len(evals),
        "steps": 0 if args.eval_ckpt else args.steps,
        "eval_ckpt": args.eval_ckpt,
        "boundary_gain": args.boundary_gain,
        "train_seconds": round(train_time, 1),
        "final_train_metrics": last,
        "heldout_touching": {
            "segmenter_instance_quality": round(float(np.mean(seg_inst_q)), 4),
            "components_instance_quality": round(float(np.mean(cc_inst_q)), 4),
            "segmenter_fused_mask_iou": round(float(np.mean(seg_mask_iou)), 4),
            "components_fused_mask_iou": round(float(np.mean(cc_mask_iou)), 4),
        },
    }
    if args.eval_ckpt is None:
        save_segmenter(str(out_dir / "segmenter.npz"), model)
    (out_dir / "result.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))


if __name__ == "__main__":
    main()
