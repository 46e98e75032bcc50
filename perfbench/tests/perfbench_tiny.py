"""A benchmark of the real cells' configurations cut to tiny widths for the
CPU tests: the same files, loaded and overridden, written into a temporary
root beside a BENCHMARK.json that names them."""

from __future__ import annotations

import copy
import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BENCH_DIR = REPO / "perfbench"

SCENE = {"writer": "kitti_syn", "frames": 4, "h": 24, "w": 80, "seed": 0}
COMMON = {"hidden_dim": 16, "hidden_dim_color": 16, "proposal_hidden_dim": 8,
          "proposal_num_levels": 2, "proposal_max_res": [16, 32],
          "num_proposal_samples_per_ray": [16, 8], "num_nerf_samples_per_ray": 8}
TINY = {
    "nerfacto-tpu-ilf050": {**COMMON, "fourier_num_levels": 2, "fourier_features_per_level": 8,
                            "proposal_fourier_features_per_level": 4},
    "semantic-nerfw-hash": {**COMMON, "num_levels": 4, "log2_hashmap_size": 10, "base_res": 4,
                            "max_res": 32, "proposal_log2_hashmap_size": 8,
                            "appearance_embedding_dim": 4},
}
RAYS = 64


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg["scene"] = dict(SCENE)
    argv = list(cfg["argv"])
    for flag, value in (("--dataparser.last_frame", "4"), ("--dataparser.image_height", "24"),
                        ("--dataparser.image_width", "80"),
                        ("--dataparser.train_split_fraction", "0.75")):
        if flag in argv:
            argv[argv.index(flag) + 1] = value
        else:
            argv += [flag, value]
    for k, v in TINY[name].items():
        argv += [f"--model.{k}", ",".join(map(str, v)) if isinstance(v, list) else str(v)]
        cfg["model"][k] = v
    cfg["argv"] = argv + ["--datamanager.num_workers", "2"]
    cfg["model"]["compute_dtype"] = "float32"
    return cfg


def write_bench(root: Path, cells=None) -> Path:
    """BENCHMARK.json and the tiny cells' files under ``root``; returns
    root. ``cells``: {cell name: config name} (the two real cells by
    default)."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = cells or {w["name"]: w["config"] for w in real["workloads"]}
    sub = root / "perfbench"
    for d in ("configs", "traffic", "checks"):
        (sub / d).mkdir(parents=True, exist_ok=True)
    spec = copy.deepcopy(real)
    spec["workloads"] = []
    spec["configs"] = []
    for cell, config in cells.items():
        (sub / "configs" / f"{config}.json").write_text(json.dumps(tiny_config(config)))
        mix = f"tiny-{cell}"
        (sub / "traffic" / f"{mix}.json").write_text(json.dumps({"kind": "train",
                                                                "rays_per_step": RAYS}))
        (sub / "checks" / f"{cell}.json").write_text(
            (BENCH_DIR / "checks" / f"{cell}.json").read_text())
        spec["workloads"].append({"name": cell, "config": config, "traffic": mix, "chips": 1,
                                  "why": "tiny"})
        spec["configs"].append({"name": config, "source": "x",
                                "file": f"perfbench/configs/{config}.json", "reduced": [],
                                "why": "tiny"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def bench(root: Path):
    from perfbench.lib.bench import Bench

    return Bench(root, dirs=[root / "perfbench", BENCH_DIR])
