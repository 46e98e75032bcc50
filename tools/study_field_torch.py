"""Field quality x speed study on the analytic sphere scene, on the PyTorch
port (the counterpart of tools/study_field.py).

Trains a nerfacto variant (any field_type + dotted overrides) on the sphere
scene and reports the held-out PSNR trajectory together with sustained train
throughput, with the JAX tool's printed lines and result JSON keys, so that
the two read side by side.

- Each step is dispatched on its own (the JAX tool's lax.scan rounds have no
  counterpart); the loss and PSNR are read from the device once per
  --scan-steps steps, as the JAX tool reads them once a round, and rays/s is
  timed over those reads;
- batches come from SyntheticDataManager.next_train(step) (per-step seeded),
  the samplers' jitter from a CPU torch.Generator seeded by the step;
- eval renders every held-out camera through Renderer.render_camera (the
  serving path) in 16,384-ray chunks at the step's coarse-to-fine window;
- the fields run in bf16 on the card and in f32 on the CPU; with the fourier
  field on the card, a step launches the fused kernels A 2 / B 1 / C 2 / D 1
  times and an eval chunk A 2 / B 1 times: a '# launches' line before the
  JSON gives the counts this run made.

Runs on the CUDA card unless --platform cpu; without CUDA it raises.

Usage:
  python tools/study_field_torch.py --field fourier --steps 2000 \\
      --name f64 max_res=64 hidden_dim=128
"""

from __future__ import annotations

import sys
from pathlib import Path

# repo-root import shim: `python tools/x.py` puts tools/ (not the repo
# root) on sys.path, so nerf_kbs_tpu_torch would not resolve without this
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import argparse
import json
import time

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.cameras import generate_rays
from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig, build_optimizer, tree_leaves
from nerf_kbs_tpu_torch.engine.render import Renderer
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import nerfacto
from nerf_kbs_tpu_torch.ops import _kernels
from nerf_kbs_tpu_torch.ops import fused_field as ff

EVAL_CHUNK = 16384


def parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs:
        k, v = p.split("=", 1)
        try:
            out[k] = json.loads(v)
        except json.JSONDecodeError:
            out[k] = v
    return out


def flagship_study_overrides(img: int = 128) -> dict:
    """The shipped flagship operating point (methods.nerfacto_tpu_method),
    re-capped for study-scale scenes: derived from the method registry, so
    that a flagship change reaches every study tool. Only max_res is
    study-local: Fourier frequencies above the pixel sampling density
    memorize, so the KITTI-scale cap is replaced by one matched to the
    study image size."""
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method

    m = nerfacto_tpu_method().model
    return dict(
        field_type=m.field_type,
        fourier_basis=m.fourier_basis,
        base_res=4,
        max_res=img // 2,
        hidden_dim=m.hidden_dim,
        num_layers=m.num_layers,
        num_proposal_samples_per_ray=m.num_proposal_samples_per_ray,
        stop_grad_sampling=m.stop_grad_sampling,
        interlevel_ray_fraction=m.interlevel_ray_fraction,
        appearance_embedding_dim=m.appearance_embedding_dim,
    )


def platform_device(platform) -> torch.device:
    """--platform: unset, 'cuda' or 'gpu' is the CUDA card (raises without
    CUDA), 'cpu' the CPU; anything else raises."""
    if platform in (None, "cuda", "gpu"):
        return resolve_device(None)
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown --platform {platform!r}: cpu, cuda or gpu")


def compute_dtype(device: torch.device) -> str:
    """bf16 on the card (the JAX tools' TPU dtype), f32 on the CPU."""
    return "bfloat16" if device.type == "cuda" else "float32"


def config_values(over: dict) -> dict:
    """JSON lists (e.g. num_proposal_samples_per_ray=[128,48]) as the
    config's tuples."""
    return {k: tuple(v) if isinstance(v, list) else v for k, v in over.items()}


def count_params(params) -> int:
    return sum(int(t.numel()) for t in tree_leaves(params))


def build_kernels(cfg, device: torch.device) -> None:
    """Compile the fused kernels before anything is timed (the JAX tool's
    warm-up compile); nothing to build off the card or off the fused path."""
    if device.type == "cuda" and nerfacto.uses_fused_path(cfg):
        _kernels.build()


def make_train_step(cfg, params: dict, optimizer, cameras):
    """One step of the study: rays of batch['ray_indices'] (B, 3) through
    the camera optimizer's deltas when ``params`` holds them, forward at
    ``step`` of the schedules, loss against batch['image'], backward,
    update. The samplers' jitter comes from ``generator`` or, given,
    ``jitters`` (one (B, 1) tensor a sampler call, see nerfacto.forward).
    Returns the (loss, psnr) tensors, not read."""
    def step(batch: dict, step: float, generator=None, jitters=None):
        rays = generate_rays(cameras, batch["ray_indices"],
                             c2w_delta=nerfacto.camera_deltas(params))
        out = nerfacto.forward(params, cfg, rays, step=float(step), train=True,
                               generator=generator, jitters=jitters)
        total, metrics = nerfacto.loss(cfg, out, batch, train=True)
        optimizer.zero_grad()
        total.backward()
        optimizer.step()
        return total.detach(), metrics["psnr"].detach()

    return step


def step_generator(seed: int, step: int) -> torch.Generator:
    """The jitter of one step: a CPU generator seeded by the seed and step
    (the JAX tool's fold_in(PRNGKey(seed), step))."""
    return torch.Generator().manual_seed(seed * 1_000_003 + step)


def run_round(train_step, batches: list, step0: int, seed: int = 1, jitters=None):
    """len(batches) steps from ``step0``, each batch a dict of tensors on
    the step's device, each step's jitter from ``step_generator(seed,
    step)`` or, given, from ``jitters[i]``. Returns the last step's (loss,
    psnr) as floats: the one read from the device a round."""
    for i, batch in enumerate(batches):
        if jitters is None:
            loss, psnr = train_step(batch, step0 + i, generator=step_generator(seed, step0 + i))
        else:
            loss, psnr = train_step(batch, step0 + i, jitters=jitters[i])
    return float(loss), float(psnr)


def device_batch(batch: dict, device: torch.device) -> dict:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def eval_psnr(dm, cfg, params: dict, step: int, device: torch.device, model=nerfacto,
              chunk: int = EVAL_CHUNK) -> float:
    """Mean PSNR over the held-out cameras, each rendered in full through
    Renderer.render_camera in ``chunk``-ray chunks."""
    renderer = Renderer(params, cfg, dm.eval_outputs.cameras(device), step=float(step),
                        eval_num_rays_per_chunk=chunk, device=device, model=model)
    vals = []
    for ci in range(dm.num_eval_images()):
        pred = renderer.render_camera(ci)["rgb"]
        gt = dm.eval_image(ci)["image"]
        mse = float(np.mean((pred - gt) ** 2))
        vals.append(10.0 * np.log10(1.0 / max(mse, 1e-12)))
    return float(np.mean(vals))


class LaunchCounter:
    """The fused kernels' launches (fused_field.LAUNCHES, DX_LAUNCHES) of a
    phase, apart for its train steps and its eval chunks."""

    def __init__(self):
        self.train, self.train_dx, self.eval = {}, {}, {}
        self.steps = self.chunks = 0

    @staticmethod
    def _add(into: dict, before: dict, now: dict) -> None:
        for k, v in now.items():
            if v != before[k]:
                into[k] = into.get(k, 0) + v - before[k]

    def track(self, fn, kind: str, units: int = 0):
        """Run ``fn`` and add its launches to ``kind`` ('train', with
        ``units`` steps, or 'eval', with ``units`` chunks)."""
        before, before_dx = dict(ff.LAUNCHES), dict(ff.DX_LAUNCHES)
        out = fn()
        if kind == "train":
            self._add(self.train, before, ff.LAUNCHES)
            self._add(self.train_dx, before_dx, ff.DX_LAUNCHES)
            self.steps += units
        else:
            self._add(self.eval, before, ff.LAUNCHES)
            self.chunks += units
        return out

    def summary(self, name: str) -> dict:
        return {"name": name, "train_steps": self.steps, "train": self.train,
                "train_dx": self.train_dx, "eval_chunks": self.chunks, "eval": self.eval}


def eval_chunks(dm, chunk: int = EVAL_CHUNK) -> int:
    """Chunks of one eval_psnr."""
    h, w = dm.eval_image(0)["image"].shape[:2]
    return dm.num_eval_images() * -(-h * w // chunk)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--field", default="fourier")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--max-norm", type=float, default=1.0)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--scan-steps", type=int, default=50,
                    help="steps between two reads of the loss from the device")
    ap.add_argument("--img", type=int, default=128, help="train/eval image size")
    ap.add_argument("--cams", type=int, default=28)
    ap.add_argument("--eval-cams", type=int, default=4)
    ap.add_argument("--name", default="run")
    ap.add_argument("--platform", default=None, help="cpu; the CUDA card if unset")
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
    cfg = nerfacto.NerfactoConfig(
        num_images=args.cams,
        field_type=args.field,
        near_plane=0.05,
        far_plane=8.0,
        appearance_embedding_dim=0,
        compute_dtype=compute_dtype(dev),
        **config_values(parse_overrides(args.overrides)),
    )
    params = nerfacto.init(cfg, seed=0, device=dev)
    mark_trainable(params)
    n_params = count_params(params)
    group = OptimizerConfig(lr=args.lr, eps=1e-15, max_norm=args.max_norm)
    optimizer = build_optimizer({"proposal_networks": group, "fields": group},
                                nerfacto.param_groups(params), device=dev)
    train_step = make_train_step(cfg, params, optimizer, dm.train_outputs.cameras(dev))
    build_kernels(cfg, dev)

    K = args.scan_steps
    launches = LaunchCounter()
    traj = []
    t_train = 0.0
    rays_done = 0
    step = 0
    while step < args.steps:
        # next_train is seeded by its step: every step gets its own batch
        batches = [device_batch(dm.next_train(step + i), dev) for i in range(K)]
        t0 = time.perf_counter()
        loss, tr_psnr = launches.track(lambda: run_round(train_step, batches, step), "train", K)
        t_train += time.perf_counter() - t0
        rays_done += K * args.batch
        step += K
        if step % args.eval_every < K:
            ep = launches.track(lambda: eval_psnr(dm, cfg, params, step, dev), "eval",
                                eval_chunks(dm))
            traj.append((step, round(tr_psnr, 2), round(ep, 2)))
            print(
                f"[{args.name}] step {step}: train_psnr={tr_psnr:.2f} "
                f"eval_psnr={ep:.2f} rays/s={rays_done / t_train:,.0f}",
                flush=True,
            )

    print("# launches " + json.dumps(launches.summary(args.name)), flush=True)
    print(
        json.dumps(
            {
                "name": args.name,
                "field": args.field,
                "overrides": parse_overrides(args.overrides),
                "lr": args.lr,
                "batch": args.batch,
                "params": n_params,
                "rays_per_sec": round(rays_done / t_train, 1),
                "trajectory": traj,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
