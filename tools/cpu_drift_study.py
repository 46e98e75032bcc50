"""How far do three f32 training steps on the CPU plain path drift from
themselves? Two card-against-CPU checks of ``chip_smoke.py`` hold fewer than
three steps (``vanilla-nerf`` at 10 position frequencies, and the camera
optimizer's tangent gradient of ``semantic-nerfw`` on the hash path,
``TANGENT_GRAD_TOL``). This script runs the same three steps as
``chip_smoke._card_vs_cpu`` (same scenes, argv, seeds, batches and jitter) on
the CPU only: in f32 at 1 and at 8 threads, and in f64 (``chip_smoke.to_f64``:
every parameter, moment and camera cast to float64, which the plain path
carries through). It prints one JSON line per configuration with each
step's loss, the relative differences between the runs, and for the camera
optimizer each step's tangent gradient against the f64 run's.

    python tools/cpu_drift_study.py [out_dir]

It writes the 8-frame street scene (376x1241) and the 8-frame vKITTI scene
(375x1242) as the smoke does (about a minute on one core), and needs no card.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
import nerf_kbs_tpu_torch.methods  # noqa: E402,F401  (fills the registry)
from nerf_kbs_tpu_torch.engine import cli  # noqa: E402
from nerf_kbs_tpu_torch.engine.optimizers import tree_leaves  # noqa: E402


def three_steps(method: str, argv: list, threads: int, f64: bool, tangents: bool) -> dict:
    torch.set_num_threads(threads)
    spec = cli.apply_overrides(cli.method_registry[method](), smoke._pairs(argv))
    tag = f"drift_{threads}_{'f64' if f64 else 'f32'}"
    t = cli.build_trainer(dataclasses.replace(
        spec, trainer=dataclasses.replace(spec.trainer, experiment_name=tag)), device="cpu")
    if f64:
        smoke.to_f64(t)
    losses, grads, dtypes = [], [], set()
    for s in range(3):
        m = t.train_step(t._to_device(t.dm.next_train(s)))
        losses.append(float(m["total_loss"]))
        dtypes.add(str(m["total_loss"].dtype))
        if tangents:
            grads.append(t.params["camera_opt"].grad.double().clone())
    return {"losses": losses, "grads": grads, "loss_dtypes": sorted(dtypes),
            "param_dtypes": sorted({str(p.dtype) for p in tree_leaves(t.params)})}


def _rel(a: list, b: list) -> list:
    return [abs(x - y) / abs(y) for x, y in zip(a, b)]


def _grad_rel(a: list, b: list) -> list:
    return [float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b)]


def study(name: str, method: str, argv: list, tangents: bool) -> dict:
    runs = {(th, f64): three_steps(method, argv, th, f64, tangents)
            for th, f64 in ((1, False), (8, False), (1, True), (8, True))}
    ref = runs[(1, True)]
    rec = {"study": name, "method": method, "threads": torch.get_num_threads(),
           "losses": {f"{th}_{'f64' if f else 'f32'}": r["losses"] for (th, f), r in runs.items()},
           "loss_dtypes": {f"{th}_{'f64' if f else 'f32'}": r["loss_dtypes"]
                           for (th, f), r in runs.items()},
           "param_dtypes_f64": ref["param_dtypes"],
           "rel_f32_8_vs_1_threads": _rel(runs[(8, False)]["losses"], runs[(1, False)]["losses"]),
           "rel_f32_1_thread_vs_f64": _rel(runs[(1, False)]["losses"], ref["losses"]),
           "rel_f32_8_threads_vs_f64": _rel(runs[(8, False)]["losses"], ref["losses"]),
           "rel_f64_8_vs_1_threads": _rel(runs[(8, True)]["losses"], ref["losses"])}
    if tangents:
        rec.update({
            "tangent_grad_rel_f32_8_vs_1_threads": _grad_rel(runs[(8, False)]["grads"],
                                                             runs[(1, False)]["grads"]),
            "tangent_grad_rel_f32_1_thread_vs_f64": _grad_rel(runs[(1, False)]["grads"],
                                                              ref["grads"]),
            "tangent_grad_rel_f32_8_threads_vs_f64": _grad_rel(runs[(8, False)]["grads"],
                                                               ref["grads"]),
            "tangent_grad_rel_f64_8_vs_1_threads": _grad_rel(runs[(8, True)]["grads"],
                                                             ref["grads"])})
    print(json.dumps(rec), flush=True)
    return rec


def main() -> None:
    out = Path(sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="nkt_drift_"))
    from nerf_kbs_tpu_torch.data.synthetic_kitti import write_dynamic_dataset, write_vkitti_dataset

    h, w = smoke.SCENE_HW
    scene = str(write_dynamic_dataset(out / "scene", n_frames=8, h=h, w=w))
    vh, vw = smoke.VKITTI_HW
    vkitti = str(write_vkitti_dataset(out / "vkitti", n_frames=8, h=vh, w=vw))
    argv4 = ["--dataparser.data_dir", vkitti, "--dataparser.train_split_fraction", "0.75",
             "--trainer.output_dir", str(out)] + smoke.STEPS
    study("vanilla_nerf_10_frequencies", "vanilla-nerf",
          argv4 + smoke.REDUCED_VANILLA + ["--model.pos_frequencies", "10"], tangents=False)
    study("run7b_camera_optimizer_hash", "semantic-nerfw",
          smoke._run_argv(scene, str(out)) + smoke._run2_data(scene) + smoke.CAMERA_OPT
          + smoke.REDUCED_HASH, tangents=True)


if __name__ == "__main__":
    main()
