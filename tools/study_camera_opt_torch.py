"""Camera-optimizer recovery study on the PyTorch port (the counterpart of
tools/study_camera_opt.py): functional evidence for SO3xR3.

Perturb every training pose by a known random rigid transform, train, and
show that
  (a) the optimizer recovers train/eval PSNR toward the clean-pose control,
  (b) the learned deltas cancel the injected perturbation (pose error after
      a global SE(3) gauge alignment drops well below the injected noise).

Arms: clean (control) / off (perturbed, optimizer off) / opt (perturbed +
SO3xR3) / frozen (field pretrained on clean poses, then only the SO3xR3
tangents trained on the perturbed cameras) / probe (the photometric loss
along the true correction line through a frozen clean-pose field). The
frozen arm freezes the fields through their Adam groups (learning rate 0),
as the JAX tool does: the fields keep requires_grad, so the fused backward
runs as in every camera-optimizer step (C and D on their dx branch, D's
dfeats too).

Methodology matches tools/study_field_torch.py (steps dispatched one by
one, the loss read once per --scan-steps steps, eval through
Renderer.render_camera); a '# launches' line a phase gives its kernel
launches. Runs on the CUDA card unless --platform cpu; without CUDA it
raises.

Usage:
  python tools/study_camera_opt_torch.py --steps 2000 --rot-deg 1.0 --trans 0.03
"""

from __future__ import annotations

import sys
from pathlib import Path

# repo-root import shim: `python tools/x.py` puts tools/ (not the repo
# root) on sys.path, so nerf_kbs_tpu_torch would not resolve without this
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import argparse
import dataclasses
import json

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.cameras import generate_rays
from nerf_kbs_tpu_torch.cameras.transforms import compose_se3, exp_map_se3
from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager
from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig, build_optimizer
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import nerfacto
from study_field_torch import (
    LaunchCounter,
    build_kernels,
    compute_dtype,
    config_values,
    device_batch,
    eval_chunks,
    eval_psnr,
    flagship_study_overrides,
    make_train_step,
    parse_overrides,
    platform_device,
    run_round,
)


def kabsch_se3(src: np.ndarray, dst: np.ndarray):
    """Best-fit rigid transform (R, t) aligning src -> dst (N, 3 each)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    H = (src - mu_s).T @ (dst - mu_d)
    U, _, Vt = np.linalg.svd(H)
    S = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ S @ U.T
    t = mu_d - R @ mu_s
    return R, t


def pose_errors(c2w_hat: np.ndarray, c2w_true: np.ndarray):
    """(mean rotation geodesic deg, mean center error) after removing the
    global SE(3) gauge (Kabsch on camera centers)."""
    C_hat, C_true = c2w_hat[:, :, 3], c2w_true[:, :, 3]
    R_g, t_g = kabsch_se3(C_hat, C_true)
    C_al = C_hat @ R_g.T + t_g
    center_err = float(np.linalg.norm(C_al - C_true, axis=1).mean())
    R_al = R_g[None] @ c2w_hat[:, :, :3]
    R_rel = np.einsum("nij,nkj->nik", R_al, c2w_true[:, :, :3])
    cos = np.clip((np.trace(R_rel, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    rot_err = float(np.degrees(np.arccos(cos)).mean())
    return rot_err, center_err


def reproj_px_err(c2w_hat: np.ndarray, c2w_true: np.ndarray, cams_np: dict, img: int) -> float:
    """Mean pixel displacement of scene-volume points projected through the
    hat vs the true cameras: the photometrically visible pose error (the
    tangent and geodesic norms of pose_errors overweight components the
    images cannot see, such as translation along the ray)."""
    rng_p = np.random.default_rng(7)
    P = rng_p.uniform(-1.0, 1.0, (512, 3))
    fx = float(np.asarray(cams_np["fx"])[0])
    fy = float(np.asarray(cams_np["fy"])[0])
    cx = float(np.asarray(cams_np["cx"])[0])
    cy = float(np.asarray(cams_np["cy"])[0])

    def project(c2w):
        R, C = c2w[:, :, :3], c2w[:, :, 3]
        v = np.einsum("nji,npj->npi", R, P[None] - C[:, None])  # R^T (P-C)
        z = -v[..., 2]
        with np.errstate(divide="ignore", invalid="ignore"):
            px = cx + fx * v[..., 0] / z
            py = cy - fy * v[..., 1] / z
        return px, py, z

    px_h, py_h, z_h = project(c2w_hat)
    px_t, py_t, z_t = project(np.asarray(c2w_true))
    valid = (
        (z_t > 0.1) & (z_h > 0.1)
        & (px_t >= 0) & (px_t < img)
        & (py_t >= 0) & (py_t < img)
    )
    if not valid.any():
        return float("nan")
    d = np.sqrt((px_h - px_t) ** 2 + (py_h - py_t) ** 2)
    return float(d[valid].mean())


def injected_tangent(seed: int, cams: int, rot_deg: float, trans: float) -> np.ndarray:
    """The known per-camera SE(3) tangent noise [v, w] (cams, 6) f32."""
    rng = np.random.default_rng(seed)
    rot_sigma = np.radians(rot_deg)
    return np.concatenate(
        [
            rng.normal(0.0, trans, (cams, 3)),
            rng.normal(0.0, rot_sigma, (cams, 3)),
        ],
        axis=1,
    ).astype(np.float32)


def field_groups(lr: float) -> dict:
    return {
        "proposal_networks": OptimizerConfig(lr=lr, eps=1e-15, max_norm=1.0),
        "fields": OptimizerConfig(lr=lr, eps=1e-15, max_norm=1.0),
    }


def frozen_groups(cam_opt: OptimizerConfig) -> dict:
    """The frozen arm's camera-only phase: learning rate 0 on the field
    groups (they keep their gradients), ``cam_opt`` on the tangents."""
    return {
        "proposal_networks": OptimizerConfig(lr=0.0),
        "fields": OptimizerConfig(lr=0.0),
        "camera_opt": cam_opt,
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--cam-lr", type=float, default=6e-4)
    ap.add_argument("--cam-lr-final", type=float, default=6e-6)
    ap.add_argument("--cam-warmup", type=int, default=0)
    ap.add_argument("--rot-deg", type=float, default=1.0)
    ap.add_argument("--trans", type=float, default=0.03)
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--cams", type=int, default=28)
    ap.add_argument("--eval-cams", type=int, default=4)
    ap.add_argument("--scan-steps", type=int, default=50,
                    help="steps between two reads of the loss from the device")
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument(
        "--frozen-steps", type=int, default=0,
        help="camera-only phase length for the 'frozen' arm (0 = --steps)",
    )
    ap.add_argument(
        "--frozen-reanneal", type=int, default=0,
        help="BARF-style coarse-to-fine for the frozen arm's camera-only "
        "phase: restart it at step 0 with this fourier_anneal_steps",
    )
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument(
        "--arms", default="clean,off,opt",
        help="comma list of clean/off/opt/frozen/probe ('probe' sweeps the "
        "photometric loss along the TRUE correction line exp(-s*tangent), "
        "s in [0, 1.25], through a frozen clean-pose field)",
    )
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    ap.add_argument("--out", default=None, help="write result JSON here")
    ap.add_argument("overrides", nargs="*", help="NerfactoConfig key=value")
    args = ap.parse_args(argv)
    dev = platform_device(args.platform)

    dm = SyntheticDataManager(
        num_cameras=args.cams,
        num_eval_cameras=args.eval_cams,
        h=args.img,
        w=args.img,
        rays_per_batch=args.batch,
    )
    cams_np = dm.train_outputs.cameras_np
    clean_cams = dm.train_outputs.cameras(dev)
    c2w_true = np.asarray(cams_np["c2w"])

    tangent = injected_tangent(args.seed, args.cams, args.rot_deg, args.trans)
    pert = exp_map_se3(torch.as_tensor(tangent, device=dev))  # (N, 3, 4)
    c2w_pert_t = compose_se3(pert, clean_cams.c2w)
    pert_cams = dataclasses.replace(clean_cams, c2w=c2w_pert_t)
    c2w_pert = c2w_pert_t.cpu().numpy()
    inj_rot, inj_center = pose_errors(c2w_pert, c2w_true)

    def make_cfg(camera_optimizer: str):
        flagship = flagship_study_overrides(args.img)
        over = config_values(parse_overrides(args.overrides))
        flagship["compute_dtype"] = compute_dtype(dev)
        # one dict, later keys winning: the flagship point carries
        # appearance_embedding_dim itself (0), which the JAX tool also
        # passes as a keyword and so raises TypeError on
        return nerfacto.NerfactoConfig(**{
            "num_images": args.cams,
            "near_plane": 0.05,
            "far_plane": 8.0,
            "appearance_embedding_dim": 0,
            "camera_optimizer": camera_optimizer,
            **flagship,
            **over,
        })

    def cam_opt_config(max_steps: int) -> OptimizerConfig:
        return OptimizerConfig(
            lr=args.cam_lr,
            eps=1e-8,
            max_norm=1.0,
            lr_final=args.cam_lr_final,
            max_steps=max_steps,
            warmup_steps=args.cam_warmup,
        )

    def reproj(c2w_hat: np.ndarray) -> float:
        return reproj_px_err(c2w_hat, c2w_true, cams_np, args.img)

    phase_counter = [0]

    def run_phase(name, cfg, params, groups, train_cams, steps, step0=0):
        """Train ``params`` in place for ``steps`` steps from schedule step
        ``step0`` with the optimizer of ``groups``; returns the trajectory."""
        K = args.scan_steps
        # next_train is seeded by its step: distinct per-phase streams keep
        # the frozen arm's camera-only phase from replaying its pretrain
        # batches
        stream = 1_000_000 * phase_counter[0]
        phase_counter[0] += 1
        optimizer = build_optimizer(groups, nerfacto.param_groups(params), device=dev)
        train_step = make_train_step(cfg, params, optimizer, train_cams)
        launches = LaunchCounter()

        def evaluate(at: int) -> float:
            return launches.track(lambda: eval_psnr(dm, cfg, params, at, dev), "eval",
                                  eval_chunks(dm))

        step, traj, tr_psnr = 0, [], float("nan")
        while step < steps:
            batches = [device_batch(dm.next_train(stream + step + i), dev) for i in range(K)]
            _, tr_psnr = launches.track(
                lambda: run_round(train_step, batches, step0 + step), "train", K)
            step += K
            if step % args.eval_every < K:
                ep = evaluate(step0 + step)
                traj.append((step0 + step, round(tr_psnr, 2), round(ep, 2)))
                print(f"[{name}] step {step0 + step}: train={tr_psnr:.2f} eval={ep:.2f}",
                      flush=True)
        if not traj or traj[-1][0] != step0 + step:
            # a phase shorter than --eval-every (or not a multiple of it)
            # must still record its endpoint: every arm reads traj[-1]
            ep = evaluate(step0 + step)
            traj.append((step0 + step, round(tr_psnr, 2), round(ep, 2)))
            print(f"[{name}] step {step0 + step}: train={tr_psnr:.2f} eval={ep:.2f} (final)",
                  flush=True)
        print("# launches " + json.dumps(launches.summary(name)), flush=True)
        return traj

    def new_params(cfg) -> dict:
        params = nerfacto.init(cfg, seed=0, device=dev)
        mark_trainable(params)
        build_kernels(cfg, dev)
        return params

    @torch.no_grad()
    def opt_pose_errors(params) -> tuple:
        eff = compose_se3(nerfacto.camera_deltas(params), c2w_pert_t).cpu().numpy()
        rot, cen = pose_errors(eff, c2w_true)
        return rot, cen, reproj(eff)

    def run_arm(name: str) -> dict:
        if name == "frozen":
            return run_frozen_arm()
        if name == "probe":
            return run_probe_arm()
        perturbed = name != "clean"
        use_opt = name == "opt"
        cfg = make_cfg("SO3xR3" if use_opt else "off")
        params = new_params(cfg)
        groups = field_groups(args.lr)
        if use_opt:
            groups["camera_opt"] = cam_opt_config(args.steps)
        traj = run_phase(name, cfg, params, groups, pert_cams if perturbed else clean_cams,
                         args.steps)
        res = {
            "arm": name,
            "final_train_psnr": traj[-1][1],
            "final_eval_psnr": traj[-1][2],
            "trajectory": traj,
        }
        if perturbed:
            if use_opt:
                rot, cen, rp = opt_pose_errors(params)
            else:
                rot, cen = pose_errors(c2w_pert, c2w_true)
                rp = reproj(c2w_pert)
            res["pose_rot_err_deg"] = round(rot, 4)
            res["pose_center_err"] = round(cen, 5)
            res["reproj_px_err"] = round(rp, 4)
        return res

    def pretrain(name: str):
        cfg_off = make_cfg("off")
        params = new_params(cfg_off)
        traj1 = run_phase(f"{name}/pretrain", cfg_off, params, field_groups(args.lr),
                          clean_cams, args.steps)
        return cfg_off, params, traj1

    def run_frozen_arm() -> dict:
        """Two phases: (1) train the field on the clean poses, (2) freeze it
        (learning rate 0 on its groups), swap in the perturbed cameras and
        train only the SO3xR3 tangents against the same images."""
        _, params, traj1 = pretrain("frozen")
        cfg_opt = make_cfg("SO3xR3")
        frozen_steps = args.frozen_steps or args.steps
        step0 = args.steps
        if args.frozen_reanneal:
            cfg_opt = dataclasses.replace(cfg_opt, fourier_anneal_steps=args.frozen_reanneal)
            step0 = 0  # the window re-opens over the camera-only phase
        # fresh tangents, zeros as nerfacto.init gives them
        params = {**params, "camera_opt": torch.zeros(cfg_opt.num_images, 6, device=dev,
                                                      requires_grad=True)}
        traj2 = run_phase("frozen/camera-only", cfg_opt, params,
                          frozen_groups(cam_opt_config(frozen_steps)), pert_cams,
                          frozen_steps, step0=step0)
        rot, cen, rp = opt_pose_errors(params)
        return {
            "arm": "frozen",
            "reanneal": args.frozen_reanneal,
            "reproj_px_err": round(rp, 4),
            "injected_reproj_px_err": round(reproj(c2w_pert), 4),
            "pretrain_final_train_psnr": traj1[-1][1],
            "final_train_psnr": traj2[-1][1],
            "final_eval_psnr": traj2[-1][2],
            "pretrain_trajectory": traj1,
            "trajectory": traj2,
            "pose_rot_err_deg": round(rot, 4),
            "pose_center_err": round(cen, 5),
        }

    def run_probe_arm() -> dict:
        """Line probe of the photometric landscape along the true
        correction: the training PSNR of a frozen clean-pose field on a fixed
        ray batch with camera deltas exp(-s * tangent), s in [0, 1.25] (s = 1
        composes to the clean poses), and the cosine between the analytic
        descent direction -dL/dtangent at s = 0 and the ideal step -tangent,
        per camera."""
        cfg_off, params, traj1 = pretrain("probe")
        cfg_opt = make_cfg("SO3xR3")
        bs = [dm.next_train(i) for i in range(8)]
        batch = device_batch({k: np.concatenate([b[k] for b in bs]) for k in bs[0]}, dev)
        tan = torch.as_tensor(tangent, device=dev)
        step = float(args.steps)

        def mse_at(cameras, cfg, delta):
            rays = generate_rays(cameras, batch["ray_indices"], c2w_delta=delta)
            out = nerfacto.forward(params, cfg, rays, step=step, train=False)
            return torch.mean((out["rgb"] - batch["image"]) ** 2)

        with torch.no_grad():
            curve = [
                [s, round(float(-10.0 * torch.log10(
                    mse_at(pert_cams, cfg_opt, exp_map_se3(-s * tan)))), 3)]
                for s in [0.0, 0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0, 1.125, 1.25]
            ]
            clean = float(-10.0 * torch.log10(mse_at(clean_cams, cfg_off, None)))
        t6 = torch.zeros_like(tan, requires_grad=True)
        (g,) = torch.autograd.grad(mse_at(pert_cams, cfg_opt, exp_map_se3(t6)), t6)
        g = g.cpu().numpy().astype(np.float64)
        ideal = -tangent.astype(np.float64)
        num = np.sum(-g * ideal, axis=1)
        den = np.linalg.norm(g, axis=1) * np.linalg.norm(ideal, axis=1) + 1e-30
        per_cam_cos = num / den
        return {
            "arm": "probe",
            "pretrain_final_train_psnr": traj1[-1][1],
            "pretrain_final_eval_psnr": traj1[-1][2],
            "clean_pose_probe_psnr": round(clean, 3),
            "injected_reproj_px_err": round(reproj(c2w_pert), 4),
            "line_probe": curve,
            "grad_cos_mean": round(float(per_cam_cos.mean()), 4),
            "grad_cos_per_cam": [round(float(c), 3) for c in per_cam_cos],
        }

    results = {
        "injected": {
            "rot_deg": args.rot_deg,
            "trans": args.trans,
            "gauge_aligned_rot_deg": round(inj_rot, 4),
            "gauge_aligned_center": round(inj_center, 5),
        },
        "arms": [run_arm(a) for a in args.arms.split(",")],
    }
    line = json.dumps(results)
    print(line, flush=True)
    if args.out:
        out = Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")


if __name__ == "__main__":
    main()
