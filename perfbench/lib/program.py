"""The system under test: the port's trainer, built as its CLI builds it.

Nothing here imports the port when this module is imported; ``Program``
does. The scene is written once per checkout into ``perfbench/cache/`` by
the port's own writer and loaded, every run, through the port's dataparser
and ``InMemoryDataManager``.
"""

from __future__ import annotations

import dataclasses
import shutil
from pathlib import Path

import numpy as np

CACHE = Path(__file__).resolve().parents[1] / "cache"


def ensure_scene(scene: dict, cache: Path = CACHE) -> Path:
    """The scene's directory under ``cache``, written by the port's
    ``data.synthetic_kitti.write_dataset`` when it is not there yet (a
    directory without its ``complete`` marker is written again)."""
    name = f"{scene['writer']}-{scene['frames']}x{scene['h']}x{scene['w']}-s{scene['seed']}"
    out = cache / name
    if (out / "complete").is_file():
        return out
    from nerf_kbs_tpu_torch.data.synthetic_kitti import write_dataset

    part = cache / f"{name}.partial"
    shutil.rmtree(part, ignore_errors=True)
    shutil.rmtree(out, ignore_errors=True)
    write_dataset(part, n_frames=scene["frames"], h=scene["h"], w=scene["w"], seed=scene["seed"])
    (part / "complete").write_text("written\n")
    part.rename(out)
    return out


def _pairs(argv: list) -> dict:
    if len(argv) % 2:
        raise ValueError(f"argv of --option value pairs expected, got {argv}")
    return {argv[i].lstrip("-"): argv[i + 1] for i in range(0, len(argv), 2)}


def flat_params(tree, prefix: str = "") -> dict:
    """{'fields/base_mlp/w/0': tensor, ...} of a nested dict / list tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flat_params(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _config_value(model_cfg, key: str):
    """A model section key as the port's resolved config gives it."""
    if hasattr(model_cfg, key):
        return getattr(model_cfg, key)
    if key == "proposal_num_layers":
        return model_cfg.proposal_field(0).num_layers
    return getattr(model_cfg.field, key)


def _same(a, b) -> bool:
    if isinstance(a, (tuple, list)) or isinstance(b, (tuple, list)):
        return list(a) == list(b)
    if isinstance(a, float) or isinstance(b, float):
        return float(a) == float(b)
    return a == b


class Program:
    """The trainer of one configuration on ``device``, and what the
    benchmark reads of it."""

    def __init__(self, cfg: dict, rays_per_step: int, seed: int, device: str,
                 cache: Path = CACHE):
        import nerf_kbs_tpu_torch.methods  # noqa: F401  (registers the methods)
        from nerf_kbs_tpu_torch.engine import cli

        self.cfg = cfg
        scene = ensure_scene(cfg["scene"], cache)
        out_dir = cache / "out"
        overrides = _pairs([a.replace("{scene}", str(scene)) for a in cfg["argv"]])
        overrides.update({
            "datamanager.train_num_rays_per_batch": str(rays_per_step),
            "datamanager.seed": str(seed),
            "trainer.seed": str(seed),
            "trainer.output_dir": str(out_dir),
        })
        spec = cli.apply_overrides(cli.method_registry[cfg["method"]](), overrides)
        self.trainer = cli.build_trainer(spec, device=device)
        self.device = self.trainer.device
        self.model_cfg = self.trainer.model_config
        self._check_config()

    def _check_config(self) -> None:
        """The configuration file states what the port runs: every model
        and optimizer number of the file must be the port's."""
        m = self.model_cfg
        if self.device.type == "cuda" and m.compute_dtype != self.cfg["model"]["compute_dtype"]:
            raise ValueError(f"port computes in {m.compute_dtype}, the config states "
                             f"{self.cfg['model']['compute_dtype']}")
        for k, v in self.cfg["model"].items():
            if k == "compute_dtype":
                continue
            got = _config_value(m, k)
            if not _same(got, v):
                raise ValueError(f"config {self.cfg['name']}: model.{k} is {got!r} in the port, "
                                 f"{v!r} in the file")
        for g, opt in self.cfg["optimizers"].items():
            port = dataclasses.asdict(self.trainer.optimizer.configs[g])
            for k, v in opt.items():
                if not ((port[k] is None) if v is None else _same(port[k], v)):
                    raise ValueError(f"config {self.cfg['name']}: optimizers.{g}.{k} is "
                                     f"{port[k]!r} in the port, {v!r} in the file")

    # ------------------------------------------------------------- state
    def params(self) -> dict:
        return flat_params(self.trainer.params)

    def load_params(self, values: dict) -> None:
        """Copy the benchmark's weights into the port's leaves, path by
        path; the two trees must hold the same paths and shapes."""
        import torch

        mine = self.params()
        if set(mine) != set(values):
            raise ValueError(f"parameter trees differ: port only "
                             f"{sorted(set(mine) - set(values))}, benchmark only "
                             f"{sorted(set(values) - set(mine))}")
        with torch.no_grad():
            for k, t in mine.items():
                if tuple(t.shape) != tuple(values[k].shape):
                    raise ValueError(f"{k}: port {tuple(t.shape)}, benchmark "
                                     f"{tuple(values[k].shape)}")
                t.copy_(values[k])

    def first_moments(self) -> dict:
        """Adam's first moment of every leaf that has one, by path."""
        out = {}
        for g, st in self.trainer.optimizer.state.items():
            out.update(flat_params(st["mu"], g))
        return out

    def cameras(self) -> dict:
        """The train split's camera arrays as the dataparser read them."""
        return {k: np.asarray(v) for k, v in self.trainer.dm.train_outputs.cameras_np.items()}

    def num_images(self) -> int:
        return len(self.trainer.dm.train_outputs.cameras_np["fx"])

    def launches(self) -> dict:
        """The kernel wrappers' launch counters, by name."""
        from nerf_kbs_tpu_torch.ops import fused_field, segment_sum

        return {**{f"fused_field.{k}": v for k, v in fused_field.LAUNCHES.items() if v},
                **{f"segment_sum.{k}": v for k, v in segment_sum.LAUNCHES.items() if v}}

    @staticmethod
    def kernel_names() -> dict:
        """{kernel name: its csrc source stem} of every __global__ function
        the port's CUDA sources define; a name defined in a header (shared
        by several sources) maps to None."""
        import re

        import nerf_kbs_tpu_torch

        csrc = Path(nerf_kbs_tpu_torch.__file__).parent / "csrc"
        pat = re.compile(r"__global__\s+void\s+"
                         r"(?:__launch_bounds__\s*\((?:[^()]|\([^()]*\))*\)\s*)?(\w+)")
        out = {}
        for p in sorted(csrc.glob("*.cu*")):
            for name in pat.findall(p.read_text()):
                out[name] = p.stem if p.suffix == ".cu" else None
        return out
