"""Method registry and dataclass CLI:

    python -m nerf_kbs_tpu_torch.engine.cli <method> [--dotted.field value ...]

the counterpart of the JAX package's ``engine/cli.py``. A method name maps to
a MethodSpec factory (``methods.py`` registers the built-in ones,
``register_method`` adds more, and ``discover_methods`` imports the plugin
modules named in ``NKT_TORCH_METHODS``). Every leaf field of the spec's nested
dataclasses can be overridden by its dotted path (``--model.hidden_dim 64``)
or by a suffix of the path that is unique (``--hidden_dim 64``); the paths
are the JAX package's.

Run modes: training (then ``eval_all_images`` and a checkpoint), with the
live viewer on a daemon thread when ``--viewer-port N`` is given or
``--trainer.vis`` contains "viewer" (port 7007); and, from the checkpoint
under ``--trainer.load_dir``, ``--eval-only``, ``--render-only``
(``--render-dir``, ``--render-ring-view``, and the eval-camera overrides
``--render-focal-mult F``, ``--render-pos-shift x,y,z`` and
``--render-frame-range lo,hi``) and ``--serve PORT`` (the viewer).
``--help`` lists the methods, or with a method its options.

Runs on the CUDA card; ``main(argv, device="cpu")`` runs the plain path on
the CPU, in bf16 never (``MethodSpec.model_config``: mixed precision applies
on the card only). With ``NKT_NUM_PROCESSES`` (or torchrun's ``WORLD_SIZE``)
above 1 every process runs the same command and they train data parallel
(``build_trainer``); rank 0 serves the live viewer.
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
import sys
import types
import typing
from typing import Any, Callable, Optional

import torch

from nerf_kbs_tpu_torch.data.datamanager import DataManagerConfig, InMemoryDataManager
from nerf_kbs_tpu_torch.engine.optimizers import OptimizerConfig
from nerf_kbs_tpu_torch.engine.trainer import Trainer, TrainerConfig
from nerf_kbs_tpu_torch.parallel import multihost
from nerf_kbs_tpu_torch.parallel.mesh import make_mesh


@dataclasses.dataclass
class MethodSpec:
    """Everything needed to train one method."""

    model_name: str  # 'nerfacto' | 'semantic_nerfw' | 'vanilla_nerf'
    model: Any
    trainer: TrainerConfig
    optimizers: dict[str, OptimizerConfig]
    dataparser: Optional[Any] = None  # None: the synthetic sphere scene
    datamanager: DataManagerConfig = dataclasses.field(default_factory=DataManagerConfig)
    description: str = ""

    def model_config(self, device="cuda"):
        """The model config as ``device`` runs it: bf16 compute under
        ``trainer.mixed_precision`` on the card, the config's own dtype on
        the CPU (as the JAX package keeps bf16 to the TPU)."""
        if self.trainer.mixed_precision and torch.device(device).type == "cuda":
            return dataclasses.replace(self.model, compute_dtype="bfloat16")
        return self.model


def _model_module(name: str):
    from nerf_kbs_tpu_torch.models import nerfacto, semantic_nerfw, vanilla_nerf

    return {"nerfacto": nerfacto, "semantic_nerfw": semantic_nerfw,
            "vanilla_nerf": vanilla_nerf}[name]


method_registry: dict[str, Callable[[], MethodSpec]] = {}


def register_method(name: str, factory: Callable[[], MethodSpec]) -> None:
    method_registry[name] = factory


def discover_methods() -> None:
    """Import the plugin modules listed in ``NKT_TORCH_METHODS``
    (comma-separated module names), each of which calls ``register_method``
    when imported. It reads its own variable, not the JAX CLI's
    ``NKT_METHODS``: a module listed there registers into the JAX package's
    registry and imports jax."""
    for mod in filter(None, os.environ.get("NKT_TORCH_METHODS", "").split(",")):
        importlib.import_module(mod.strip())


# ---------------------------------------------------------------------------
# dataclass <- CLI overrides
# ---------------------------------------------------------------------------


def _iter_leaf_fields(obj: Any, prefix: str = ""):
    """(dotted path, current value) of every leaf field of a nested
    dataclass / dict-of-dataclasses tree."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            path = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(v) and not isinstance(v, type):
                yield from _iter_leaf_fields(v, path + ".")
            elif isinstance(v, dict) and v and all(dataclasses.is_dataclass(x) for x in v.values()):
                for k2, v2 in v.items():
                    yield from _iter_leaf_fields(v2, f"{path}.{k2}.")
            else:
                yield path, v


def _leaf_declared_type(spec: Any, path: list[str]):
    """The annotated type of a leaf, Optional unwrapped: it parses an
    override of a field whose current value is None."""
    obj = spec
    for p in path[:-1]:
        obj = getattr(obj, p) if dataclasses.is_dataclass(obj) else obj[p]
    if not dataclasses.is_dataclass(obj):
        return None
    t = typing.get_type_hints(type(obj)).get(path[-1])
    if typing.get_origin(t) in (typing.Union, types.UnionType):
        non_none = [a for a in typing.get_args(t) if a is not type(None)]
        if len(non_none) == 1:
            t = non_none[0]
    return t


def _convert(raw: str, current: Any, declared: Any = None):
    if current is None and raw.lower() != "none" and declared in (float, int, bool):
        return _convert(raw, declared())
    if isinstance(current, bool):
        if raw.lower() in ("true", "1", "yes"):
            return True
        if raw.lower() in ("false", "0", "no"):
            return False
        raise ValueError(f"bad bool {raw!r}")
    if isinstance(current, int):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        parts = [p for p in raw.replace("(", "").replace(")", "").split(",") if p]
        elem = current[0] if current else 0
        return tuple(type(elem)(p) for p in parts)
    if current is None or isinstance(current, str):
        return None if raw.lower() == "none" else raw
    raise ValueError(f"unsupported override type {type(current)} for {raw!r}")


def _set_path(obj: Any, path: list[str], value: Any):
    """A copy of a nested dataclass / dict tree with one dotted path set."""
    if len(path) == 1:
        return dataclasses.replace(obj, **{path[0]: value})
    head = path[0]
    child = getattr(obj, head) if dataclasses.is_dataclass(obj) else obj[head]
    if isinstance(child, dict):
        new_child = dict(child)
        new_child[path[1]] = (_set_path(child[path[1]], path[2:], value) if len(path) > 2
                              else value)
    else:
        new_child = _set_path(child, path[1:], value)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{head: new_child})
    new = dict(obj)
    new[head] = new_child
    return new


def apply_overrides(spec: MethodSpec, overrides: dict[str, str]) -> MethodSpec:
    leaves = dict(_iter_leaf_fields(spec))
    for key, raw in overrides.items():
        norm = key.replace("-", "_")
        if norm not in leaves:
            matches = [p for p in leaves if p.endswith("." + norm) or p == norm]
            if len(matches) != 1:
                raise SystemExit(f"unknown or ambiguous option --{key} "
                                 f"(candidates: {matches or sorted(leaves)[:20]})")
            norm = matches[0]
        path = norm.split(".")
        spec = _set_path(spec, path, _convert(raw, leaves[norm], _leaf_declared_type(spec, path)))
    return spec


# ---------------------------------------------------------------------------
# run
# ---------------------------------------------------------------------------


def build_trainer(spec: MethodSpec, device=None) -> Trainer:
    """The spec's model module and config; the datamanager (the
    dataparser's train and 'val' splits, or the sphere scene without a
    dataparser); where the model has them, ``num_images`` and
    ``num_semantic_classes`` from the data (the semantic head switched off,
    with a warning, when the data has no labels); the compute dtype from
    ``spec.model_config``; with the camera optimizer, its 'camera_opt' Adam
    group unless the spec has one.

    With more than one process (``parallel.multihost.initialize``:
    ``NKT_NUM_PROCESSES`` or torchrun's ``WORLD_SIZE``) each process takes
    ``train_num_rays_per_batch // world`` rays a step, drawn with the seed
    ``seed + 7919 * rank``, on its own device (``multihost.rank_device``),
    and the trainer runs data parallel over the process group."""
    info = multihost.initialize(device=device)
    world, rank = info["process_count"], info["process_index"]
    if world > 1:
        b = spec.datamanager.train_num_rays_per_batch
        if b % world:
            raise SystemExit(f"train_num_rays_per_batch {b} not divisible by {world} processes")
        spec = dataclasses.replace(spec, datamanager=dataclasses.replace(
            spec.datamanager, train_num_rays_per_batch=b // world,
            seed=spec.datamanager.seed + 7919 * rank))
    mesh = make_mesh(device)
    dev = mesh.device
    module = _model_module(spec.model_name)
    if spec.dataparser is None:
        from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager

        dm = SyntheticDataManager(seed=spec.datamanager.seed,
                                  rays_per_batch=spec.datamanager.train_num_rays_per_batch)
    else:
        dm = InMemoryDataManager(spec.dataparser.parse("train"), spec.dataparser.parse("val"),
                                 spec.datamanager)
    model_cfg = spec.model_config(dev)
    if hasattr(model_cfg, "num_images"):
        model_cfg = dataclasses.replace(model_cfg,
                                        num_images=len(dm.train_outputs.cameras_np["fx"]))
    if getattr(model_cfg, "use_semantic", False):
        if getattr(dm, "semantics", None):
            model_cfg = dataclasses.replace(model_cfg,
                                            num_semantic_classes=len(dm.semantics.classes))
        elif model_cfg.num_semantic_classes <= 0:
            print("WARNING: use_semantic=true but the dataset provides no semantic labels — "
                  "disabling the semantic head", flush=True)
            model_cfg = dataclasses.replace(model_cfg, use_semantic=False)
    optimizers = dict(spec.optimizers)
    if getattr(model_cfg, "camera_optimizer", "off") != "off" and "camera_opt" not in optimizers:
        # Adam 6e-4 decaying to 6e-6 over the run: pose registration needs
        # the late-training floor (a constant 6e-4 lets the poses drift)
        optimizers["camera_opt"] = OptimizerConfig(
            lr=6e-4, eps=1e-8, lr_final=6e-6, max_steps=spec.trainer.max_num_iterations)
    return Trainer(spec.trainer, model_cfg, optimizers, dm, model=module, mesh=mesh)


# run-mode flags and their defaults; both spellings (dash and underscore)
_MODES = {"eval-only": "false", "render-only": "false", "render-dir": "renders",
          "render-ring-view": "false", "serve": "0", "viewer-port": "0",
          "render-focal-mult": None, "render-pos-shift": None, "render-frame-range": None}


def _resolve_viewer_port(viewer_port: int, vis: str) -> int:
    """``vis`` containing "viewer" starts the live viewer on 7007 (the
    reference's vis="viewer" and nerfstudio's port); an explicit
    ``--viewer-port`` wins."""
    if not viewer_port and "viewer" in vis:
        return 7007
    return viewer_port


def _parse_argv(argv: list[str]) -> tuple[str, dict, dict]:
    method = argv.pop(0)
    overrides: dict[str, str] = {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if not a.startswith("--"):
            raise SystemExit(f"expected --option, got {a!r}")
        if "=" in a:
            k, _, v = a[2:].partition("=")
            i += 1
        elif i + 1 < len(argv):
            k, v = a[2:], argv[i + 1]
            i += 2
        else:
            raise SystemExit(f"missing value for {a}")
        overrides[k] = v
    modes = {}
    for name, default in _MODES.items():
        modes[name] = overrides.pop(name, overrides.pop(name.replace("-", "_"), default))
    return method, overrides, modes


def main(argv: Optional[list[str]] = None, device=None):
    """Runs one mode (see the module docstring). Returns the live viewer,
    still serving, when training started one (the caller's ``shutdown``
    stops it; the process's exit ends its daemon thread otherwise), else
    None."""
    argv = list(sys.argv[1:] if argv is None else argv)
    from nerf_kbs_tpu_torch.utils.profiling import install_faulthandler

    install_faulthandler()
    import nerf_kbs_tpu_torch.methods  # noqa: F401  (registers the built-in methods)

    discover_methods()
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m nerf_kbs_tpu_torch.engine.cli <method> [--field value ...]\n\n"
              "methods:")
        for name, factory in sorted(method_registry.items()):
            print(f"  {name:20s} {factory().description}")
        return
    if argv[0] not in method_registry:
        raise SystemExit(f"unknown method {argv[0]!r}; available: {sorted(method_registry)}")
    if "--help" in argv or "-h" in argv:
        spec = method_registry[argv[0]]()
        print(f"method {argv[0]!r}: {spec.description}\n\noptions (--path value):")
        for path, v in _iter_leaf_fields(spec):
            print(f"  --{path} (= {v!r})")
        return
    method, overrides, modes = _parse_argv(argv)
    spec = apply_overrides(method_registry[method](), overrides)
    trainer = build_trainer(spec, device=device)

    def on(flag):
        return modes[flag].lower() in ("1", "true", "yes")

    eval_dumps = str(trainer.out_dir / "eval_images")
    if int(modes["serve"]):
        from nerf_kbs_tpu_torch.engine.viewer import ViewerServer

        ViewerServer(trainer, eval_image_dir=eval_dumps, port=int(modes["serve"])).serve_forever()
        return None
    if on("eval-only"):
        final = trainer.eval_all_images()
        trainer._log({"step": trainer.step, **{f"eval_all_{k}": v for k, v in final.items()}})
        print(json.dumps({"step": trainer.step, **final}), flush=True)
        return None
    if on("render-only"):
        from nerf_kbs_tpu_torch.engine.render import render_trajectory

        focal, shift, frames = (modes[k] for k in ("render-focal-mult", "render-pos-shift",
                                                   "render-frame-range"))
        written = render_trajectory(
            trainer, modes["render-dir"], ring_view=on("render-ring-view"),
            focal_mult=float(focal) if focal else None,
            pos_shift=tuple(float(v) for v in shift.split(",")) if shift else None,
            frame_range=tuple(int(v) for v in frames.split(",")) if frames else None)
        print(f"rendered {len(written)} frames to {modes['render-dir']}", flush=True)
        return None
    viewer = None
    viewer_port = _resolve_viewer_port(int(modes["viewer-port"]), trainer.config.vis)
    if viewer_port and trainer.mesh.rank == 0:  # one viewer for the ranks, on one port
        from nerf_kbs_tpu_torch.engine.viewer import ViewerServer

        viewer = ViewerServer(trainer, eval_image_dir=eval_dumps, port=viewer_port,
                              mode="training")
        viewer.start_background()
        print(f"live viewer on http://{viewer.host}:{viewer.port} "
              "(/ /ws /status /render /orbit /latest)", flush=True)
    metrics = trainer.train()
    if trainer.last_eval_all is not None and trainer.last_eval_all[0] == trainer.step:
        final = trainer.last_eval_all[1]  # the loop's, logged once as in the JAX package
    else:
        final = trainer.eval_all_images()
        trainer._log({"step": trainer.step, **{f"eval_all_{k}": v for k, v in final.items()}})
    trainer.save_checkpoint()
    print(f"done: {metrics} eval={final}", flush=True)
    return viewer


if __name__ == "__main__":
    # run the package's copy of this module: methods.py registers there
    from nerf_kbs_tpu_torch.engine import cli

    cli.main()
