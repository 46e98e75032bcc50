"""Benchmark of the PyTorch/CUDA port: nerfacto train-step throughput at
reference scale on one CUDA card (the counterpart of bench.py).

Measures rays/sec through the full train step (generate_rays -> forward ->
loss -> backward through the hand-written kernels -> per-group Adam). The
HEADLINE JSON line is the flagship operating point
(nerf_kbs_tpu_torch.methods.nerfacto_tpu_method): 16384 rays/batch, tri-basis
fourier field, proposal samples (96, 32) -> 48 nerf samples, detached PDF
resampling, KITTI-sized cameras, bf16 on the card. On the fused path one
step launches the proposal-field forward (A) twice, the field forward (B)
once, the proposal-field backward (C) twice and the field backward (D) once;
bench_method checks those counts.

Then '#'-prefixed lines give the eval-render throughput (forward only,
65536-ray chunks, A twice and B once a chunk) and the hash-grid parity path
(the reference operating point: 4096 rays, (256, 96) proposals, the
non-fused path, no hand-written kernel), and a last '#' line names the
device.

    python3 bench_torch.py                 # on the CUDA card
    python3 bench_torch.py --device cpu    # the plain path on the CPU, small

vs_baseline = value / 5e6, the fraction of the 5M rays/sec north-star
target from BASELINE.md, as in bench.py, so the two lines read side by side.
Without CUDA, and without --device cpu, it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import numpy as np
import torch

from nerf_kbs_tpu_torch.cameras.cameras import generate_rays
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
from nerf_kbs_tpu_torch.data.synthetic import orbit_cameras
from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig, build_optimizer
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
from nerf_kbs_tpu_torch.models import nerfacto
from nerf_kbs_tpu_torch.ops import fused_field as ff

# the bench scene: 32 orbit cameras of KITTI's frame size
NUM_CAMERAS, HEIGHT, WIDTH = 32, 376, 1241
# kernel launches a train step and an eval chunk on the fused path, by
# fused_field.LAUNCHES key (the flagship widths run the wgmma bodies)
FUSED_STEP = {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1,
              "fourier_mlp_bwd_wgmma": 2, "fourier_field_mlp_bwd_wgmma": 1}
FUSED_CHUNK = {"fourier_mlp_wgmma": 2, "fourier_field_mlp_wgmma": 1}


def _random_ray_indices(generator: torch.Generator, shape: tuple) -> torch.Tensor:
    """Fresh (camera, row, col) triples of shape (*shape, 3) int32 for the
    bench scene, drawn on the generator's device; shared by the train and
    render benches so both sample the same distribution."""
    dev = generator.device
    return torch.stack([torch.randint(0, hi, shape, generator=generator, device=dev)
                        for hi in (NUM_CAMERAS, HEIGHT, WIDTH)], dim=-1).to(torch.int32)


def bench_config(field_type: str, device: torch.device):
    """The model config of bench.py's operating points. The fourier one is
    derived from the registry (nerfacto_tpu_method) so that the bench cannot
    drift from the shipped model; only its max_res is bench-local (the bench
    scene is analytic, and frequencies above its sampling density are a
    quality knob, not a cost one). The hash one is the reference's parity
    point. bf16 on the card, f32 on the CPU."""
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    if field_type == "fourier":
        return dataclasses.replace(nerfacto_tpu_method().model, num_images=NUM_CAMERAS,
                                   compute_dtype=dtype, max_res=64, base_res=4)
    return nerfacto.NerfactoConfig(
        num_images=NUM_CAMERAS, field_type=field_type, hidden_dim=64, compute_dtype=dtype,
        fourier_basis="sincos", max_res=2048, base_res=16,
        num_proposal_samples_per_ray=(256, 96), interlevel_ray_fraction=1.0)


def bench_cameras(device: torch.device):
    """bench.py's scene: the orbit cameras with the [-1, 1]^3 box."""
    return DataparserOutputs([], orbit_cameras(NUM_CAMERAS, h=HEIGHT, w=WIDTH),
                             np.array([[-1.0] * 3, [1.0] * 3])).cameras(device)


def bench_optimizer(params: dict, device: torch.device):
    """bench.py's optimizer: Adam at a constant 1e-2 in both groups."""
    group = OptimizerConfig(lr=1e-2, eps=1e-15)
    return build_optimizer({"proposal_networks": group, "fields": group},
                           nerfacto.param_groups(params), device=device)


def make_train_step(cfg, params: dict, optimizer, cameras):
    """One bench step: rays of ``ray_indices`` (B, 3), forward at step 500
    of the schedules, loss against ``image`` (B, 3), backward, update. The
    samplers' jitter comes from ``generator`` or, given, ``jitters`` (one
    tensor a sampler call, see nerfacto.forward). Returns the loss."""
    def step(ray_indices, image, generator=None, jitters=None):
        rays = generate_rays(cameras, ray_indices)
        out = nerfacto.forward(params, cfg, rays, step=500, train=True, generator=generator,
                               jitters=jitters)
        total, _ = nerfacto.loss(cfg, out, {"ray_indices": ray_indices, "image": image},
                                 train=True)
        optimizer.zero_grad()
        total.backward()
        optimizer.step()
        return total.detach()

    return step


def make_render_chunk(cfg, params: dict, cameras):
    """One eval chunk: the forward-only render of the rays of
    ``ray_indices`` (B, 3) at step 30000 of the schedules. Returns the sum
    of its rgb and depth, so that nothing is skipped."""
    @torch.no_grad()
    def chunk(ray_indices):
        out = nerfacto.forward(params, cfg, generate_rays(cameras, ray_indices), step=30000,
                               train=False)
        return out["rgb"].sum() + out["depth"].sum()

    return chunk


def _check_launches(before: dict, per_unit: dict, units: int, what: str) -> None:
    """The fused kernels launched since ``before`` must be ``units`` x
    ``per_unit`` (none at all where ``per_unit`` is empty)."""
    got = {k: v - before[k] for k, v in ff.LAUNCHES.items() if v != before[k]}
    want = {k: units * v for k, v in per_unit.items()}
    if got != want:
        raise RuntimeError(f"{what}: kernel launches {got}, want {want} for {units}")


def _best_rate(run_round, rounds: int, rays_per_round: int, device: torch.device) -> float:
    """Best of 3 timed windows of ``rounds`` calls of ``run_round`` on the
    host clock, each window opened and closed by a synchronize, in
    rays/sec. The value of each window's last round must be finite."""
    best = 0.0
    for _ in range(3):  # best-of-3: run-to-run noise of a shared host
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            last = run_round()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        if not math.isfinite(float(last)):
            raise RuntimeError(f"non-finite bench value {float(last)}")
        best = max(best, rays_per_round * rounds / dt)
    return best


def bench_method(field_type: str, batch_size: int, steps: int, device=None, inner: int = 50,
                 seed: int = 0) -> float:
    """Train rays/sec: ``max(steps // inner, 1)`` rounds of ``inner`` steps
    each, best of 3 windows after 2 warm-up rounds, as bench.py times it.
    Each round draws its (inner, B, 3) ray indices and (inner, B, 3) target
    colours in one go from a generator seeded with ``seed`` (bench.py's
    scan inputs), then steps through them; the weights come from ``seed``
    too."""
    dev = resolve_device(device)
    cfg = bench_config(field_type, dev)
    params = nerfacto.init(cfg, seed=seed, device=dev)
    mark_trainable(params)
    step = make_train_step(cfg, params, bench_optimizer(params, dev), bench_cameras(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run_round():
        indices = _random_ray_indices(gen, (inner, batch_size))
        images = torch.rand(inner, batch_size, 3, generator=gen, device=dev)
        for i in range(inner):
            loss = step(indices[i], images[i], generator=gen)
        return loss

    per_step = FUSED_STEP if dev.type == "cuda" and nerfacto.uses_fused_path(cfg) else {}
    before = dict(ff.LAUNCHES)
    for _ in range(2):  # warm-up: first launches, allocator, kernel builds
        run_round()
    rounds = max(steps // inner, 1)
    rate = _best_rate(run_round, rounds, batch_size * inner, dev)
    _check_launches(before, per_step, (2 + 3 * rounds) * inner, "bench_method steps")
    return rate


def bench_render(batch_size: int, steps: int, device=None, inner: int = 20,
                 seed: int = 0) -> float:
    """Forward-only (eval render) rays/sec at the flagship point, the
    serving path behind the viewer and --render-only, in chunks of
    ``batch_size`` rays (the reference's eval chunk is 1<<16): rounds of
    ``inner`` chunks of fresh random pixels, each chunk's rgb and depth
    summed so that nothing is skipped, timed as bench_method times."""
    dev = resolve_device(device)
    cfg = bench_config("fourier", dev)
    chunk = make_render_chunk(cfg, nerfacto.init(cfg, seed=seed, device=dev), bench_cameras(dev))
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run_round():
        indices = _random_ray_indices(gen, (inner, batch_size))
        return sum(chunk(indices[i]) for i in range(inner))

    per_chunk = FUSED_CHUNK if dev.type == "cuda" else {}
    before = dict(ff.LAUNCHES)
    run_round()
    rounds = max(steps // inner, 1)
    rate = _best_rate(run_round, rounds, batch_size * inner, dev)
    _check_launches(before, per_chunk, (1 + 3 * rounds) * inner, "bench_render chunks")
    return rate


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="'cpu' for the plain path on the CPU; the CUDA card if omitted")
    parser.add_argument("--seed", type=int, default=0,
                        help="seeds the weights, the ray indices and the target colours")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    on_card = dev.type == "cuda"
    # 16k-ray batches, 100 steps in rounds of 50 as on the TPU; on the CPU
    # bench.py's small sizes, and the render in 128-ray chunks, whose plain
    # path would hold GBs of per-sample activations at 65536 rays
    batch, steps, inner = (16384, 100, 50) if on_card else (128, 2, 2)
    rate = bench_method("fourier", batch, steps, dev, inner=inner, seed=args.seed)
    print(json.dumps({
        "metric": ("nerfacto_tpu_torch_train_rays_per_sec_per_gpu" if on_card
                   else "nerfacto_tpu_torch_train_rays_per_sec_cpu"),
        "value": round(rate, 1),
        "unit": "rays/sec",
        "vs_baseline": round(rate / 5e6, 4),
    }), flush=True)
    chunk, chunks, inner = (65536, 60, 20) if on_card else (128, 1, 1)
    render_rate = bench_render(chunk, chunks, dev, inner=inner, seed=args.seed)
    print(f"# eval-render (forward-only, {chunk}-ray chunks): {render_rate:.1f} rays/sec",
          flush=True)
    # the hash path keeps the reference's 4096-ray batch, at a fifth of the
    # steps; on the CPU in rounds of one step, whose 2^19-entry tables take
    # about a second a step there
    hash_rate = bench_method("hash", min(batch, 4096), max(steps // 5, 2), dev,
                             inner=10 if on_card else 1, seed=args.seed)
    print(f"# hash-grid parity path: {hash_rate:.1f} rays/sec", flush=True)
    name = torch.cuda.get_device_name(dev) if on_card else "cpu (plain path)"
    print(f"# device: {name}; torch {torch.__version__}", flush=True)


if __name__ == "__main__":
    main()
