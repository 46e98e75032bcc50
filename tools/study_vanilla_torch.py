"""Vanilla NeRF on the dense-coverage 128x128 orbit scene, on the PyTorch
port (the counterpart of tools/study_vanilla.py): the field studies'
protocol (28 train / 4 interleaved eval cameras, SyntheticDataManager
sphere scene) applied to models/vanilla_nerf, with RAdam at 5e-4 and a
global-norm clip of 1 (methods.vanilla_nerf_method's fields group).

On an orbit scene whose eval views interleave the training orbit, a correct
implementation shows held-out PSNR within a few dB of train PSNR. Writes the
trajectory and then one JSON line with the JAX tool's keys; eval renders
every held-out camera through Renderer.render_camera in 8,192-ray chunks.
The MLPs run in bf16 on the card and in f32 on the CPU; the path launches
no hand-written kernel. Runs on the CUDA card unless --platform cpu; without
CUDA it raises.

  python tools/study_vanilla_torch.py --steps 3000 | tee vanilla_orbit.log
"""

from __future__ import annotations

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import argparse
import json
import time

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.cameras import generate_rays
from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager
from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig, build_optimizer
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import vanilla_nerf
from study_field_torch import (
    compute_dtype,
    config_values,
    count_params,
    device_batch,
    eval_psnr,
    parse_overrides,
    platform_device,
    step_generator,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=30000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--eval-every", type=int, default=3000)
    ap.add_argument("--scan-steps", type=int, default=25,
                    help="steps between two reads of the PSNR from the device")
    ap.add_argument("--img", type=int, default=128)
    ap.add_argument("--cams", type=int, default=28)
    ap.add_argument("--eval-cams", type=int, default=4)
    ap.add_argument("--name", default="vanilla_orbit")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
    ap.add_argument("overrides", nargs="*", help="VanillaNerfConfig key=value")
    args = ap.parse_args(argv)
    dev = platform_device(args.platform)

    dm = SyntheticDataManager(
        num_cameras=args.cams,
        num_eval_cameras=args.eval_cams,
        h=args.img,
        w=args.img,
        rays_per_batch=args.batch,
    )
    cfg = vanilla_nerf.VanillaNerfConfig(
        near_plane=0.05,
        far_plane=8.0,
        compute_dtype=compute_dtype(dev),
        **config_values(parse_overrides(args.overrides)),
    )
    params = vanilla_nerf.init(cfg, seed=0, device=dev)
    mark_trainable(params)
    n_params = count_params(params)
    # the reference optimizer point (methods.vanilla_nerf_method): RAdam + clip
    optimizer = build_optimizer(
        {"fields": OptimizerConfig(optimizer="radam", lr=5e-4, eps=1e-8, max_norm=1.0)},
        vanilla_nerf.param_groups(params), device=dev)
    train_cams = dm.train_outputs.cameras(dev)
    K = args.scan_steps

    def train_step(batch: dict, step: int):
        rays = generate_rays(train_cams, batch["ray_indices"])
        out = vanilla_nerf.forward(params, cfg, rays, step=float(step), train=True,
                                   generator=step_generator(1, step))
        total, metrics = vanilla_nerf.loss(cfg, out, batch, train=True)
        optimizer.zero_grad()
        total.backward()
        optimizer.step()
        return metrics["psnr"].detach()

    traj = []
    t0 = time.perf_counter()
    rays_done = 0
    step = 0
    while step < args.steps:
        kk = min(K, args.steps - step)
        for i in range(kk):
            tr_psnr = train_step(device_batch(dm.next_train(step + i), dev), step + i)
        rays_done += args.batch * kk
        step += kk
        if step % args.eval_every == 0 or step >= args.steps:
            last_train_psnr = float(tr_psnr)
            ev = eval_psnr(dm, cfg, params, step, dev, model=vanilla_nerf, chunk=8192)
            rate = rays_done / (time.perf_counter() - t0)
            traj.append([step, round(last_train_psnr, 2), round(ev, 2)])
            print(f"[{args.name}] step {step}: train_psnr={last_train_psnr:.2f} "
                  f"eval_psnr={ev:.2f} rays/s={rate:,.0f}", flush=True)
    print(json.dumps({
        "name": args.name, "model": "vanilla-nerf", "params": n_params,
        "batch": args.batch, "img": args.img, "cams": args.cams,
        "eval_cams": args.eval_cams,
        "overrides": parse_overrides(args.overrides),
        "rays_per_sec": round(rays_done / (time.perf_counter() - t0), 1),
        "trajectory": traj,
    }), flush=True)


if __name__ == "__main__":
    main()
