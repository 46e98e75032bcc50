"""Step times of the port's training paths on the card, for comparing two
trees in turns.

    OMP_NUM_THREADS=1 python3 tools/step_times_torch.py OUT.json [--scene DIR] [--steps 30]

Times, in the tree this script sits in: bench_torch.py's train step (16,384
random rays of its 32 cameras, as chip_smoke.py's phase train builds it),
one step of ilf050 and of sem30k-flagship2 at full width and 16,384 rays,
and one step of run 3 (semantic-nerfw as registered, the hash field, 4,096
rays) (chip_smoke.repeat_trainer, on chip_smoke.py's 8-frame 376x1241 street
scene, written into ``--scene`` when that holds none). Per path: the host
time of each of ``--steps`` steps after 5 warm-up steps, each ended by a
synchronise (median and all), and one more step under torch.profiler: the
device busy time and the device time of the fixed-order segment sums
(csrc/segment_sum.cu), of sorting, of fills and memsets, of scatters,
gathers and index adds, of kernels C and D and of their partials'
reduction (GROUPS). Then the preprocessing trainers' steps
(chip_smoke.preprocess_trainers; ``trainer_times``). Also the card's name
and power limit. Run from two trees in one chip call (parent, change,
change, parent) to compare them: the script runs from a copy of the parent
tree too (copy it there).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

# device kernel names by group (substrings of the profiler's kernel names)
GROUPS = {
    "segment_sum": ("segment_pieces_kernel", "segment_runs_kernel", "segment_tiles_kernel",
                    "segment_carry_kernel"),
    "sort": ("RadixSort", "sortKeyValueInplace", "bitonicSort", "radix_hist_kernel",
             "radix_scan_kernel", "radix_scatter_kernel"),
    "fills_and_memsets": ("FillFunctor", "Memset"),
    "scatter_gather_and_index_adds": ("scatter_gather", "indexFuncLargeIndex",
                                      "indexFuncSmallIndex", "indexing_backward"),
    "kernel_C": ("fourier_mlp_bwd",),
    "kernel_D": ("fourier_field_bwd", "nkt_field_dw"),
    "reduce_partials": ("nkt_reduce_partials",),
}


def bench_step():
    """bench_torch.py's train step, as phase train builds it."""
    import torch

    import bench_torch
    from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
    from nerf_kbs_tpu_torch.models import nerfacto

    dev = torch.device("cuda")
    cfg = bench_torch.bench_config("fourier", dev)
    params = nerfacto.init(cfg, seed=0, device=dev)
    mark_trainable(params)
    opt = bench_torch.bench_optimizer(params, dev)
    train_step = bench_torch.make_train_step(cfg, params, opt, bench_torch.bench_cameras(dev))
    gen = torch.Generator(device=dev).manual_seed(1)

    def step():
        idx = bench_torch._random_ray_indices(gen, (16384,))
        return train_step(idx, torch.rand(16384, 3, generator=gen, device=dev), generator=gen)
    return step


def trainer_step(path: str, scene: str, out: str):
    trainer = cs.repeat_trainer(path, scene, out)

    def step():
        return trainer.train_step(trainer.dm.next_train(trainer.step))
    return step


def measure(step, steps: int) -> dict:
    import torch

    for _ in range(5):
        step()
    times = []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    wall_us, events = cs.device_events(step)
    groups = {g: sum(us for name, us, _ in events if any(k in name for k in keys)) / 1e3
              for g, keys in GROUPS.items()}
    return {"median_ms": sorted(times)[len(times) // 2], "step_ms": times,
            "profiled_step_wall_ms": wall_us / 1e3,
            "device_busy_ms": sum(us for _, us, _ in events) / 1e3,
            "device_ms_by_group": groups,
            "top_kernels_ms": {name: us / 1e3 for name, us, _ in events[:12]}}


def trainer_times(steps: int) -> dict:
    """Host ms a step of each preprocessing trainer: the median of ``steps``
    steps after 2 warm-up steps, each ended by a synchronise, twice. On a
    tree whose steps run under ``networks.deterministic_convolutions``, each
    turn also times them with that scope replaced by a null context (cuDNN
    then picks its algorithms as outside the trainers), in turns."""
    import contextlib

    import torch

    from nerf_kbs_tpu_torch.process_data import networks

    scoped = hasattr(networks, "deterministic_convolutions")
    arms = ("as_built", "unrestricted") if scoped else ("as_built",)
    result = {}
    for name in ("raft", "segmenter", "inpaint"):
        result[name] = {arm: [] for arm in arms}
        for _ in range(2):
            for arm in arms:
                saved = getattr(networks, "deterministic_convolutions", None)
                if arm == "unrestricted":
                    networks.deterministic_convolutions = contextlib.nullcontext
                try:
                    model, step = cs.preprocess_trainers()[name](torch.device("cuda"))
                    for _ in range(2):
                        step()
                    times = []
                    for _ in range(steps):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        step()
                        torch.cuda.synchronize()
                        times.append((time.perf_counter() - t0) * 1e3)
                finally:
                    if scoped:
                        networks.deterministic_convolutions = saved
                result[name][arm].append(sorted(times)[len(times) // 2])
                del model, step
                torch.cuda.empty_cache()
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out")
    ap.add_argument("--scene", default=str(ROOT / "build" / "step_times_scene"))
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args()
    import tempfile

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("step_times_torch: CUDA is not available")
    import nerf_kbs_tpu_torch  # noqa: F401  (sets allow_tf32 = False)

    scene = Path(args.scene) / "scene"
    if not (scene / "00.txt").is_file():
        Path(args.scene).mkdir(parents=True, exist_ok=True)
        cs.phase_scene(args.scene)
    result = {"tree": str(ROOT), "card": subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), "paths": {}}
    result["paths"]["bench_step"] = measure(bench_step(), args.steps)
    torch.cuda.empty_cache()
    for path in ("ilf050", "sem30k-flagship2", "run3"):
        step = trainer_step(path, str(scene), tempfile.mkdtemp(prefix=f"nkt_times_{path}_"))
        result["paths"][path] = measure(step, args.steps)
        del step
        torch.cuda.empty_cache()
    result["trainers_ms"] = trainer_times(10)
    print(json.dumps({"tree": str(ROOT), "trainers_ms": result["trainers_ms"]}), flush=True)
    for path, r in result["paths"].items():
        print(json.dumps({"tree": str(ROOT), "path": path, "median_ms": r["median_ms"],
                          "device_busy_ms": r["device_busy_ms"],
                          "device_ms_by_group": r["device_ms_by_group"]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    # before torch and the host sampler load their OpenMP runtime
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.exit(main())
