"""The port's entry points: each train*_torch.py launcher hands the port's
CLI main the argv that its JAX twin (train*.py) hands the JAX main;
bench_torch.py, the four launchers and the port's tools (tools/*_torch.py)
import nothing of JAX; tools/wallclock_to_psnr.py, which imports nothing of
JAX either, reads the metrics.jsonl of the port's Trainer."""

import ast
import runpy
import subprocess
import sys
from pathlib import Path

import pytest

import nerf_kbs_tpu.engine.cli as jcli
import nerf_kbs_tpu_torch.engine.cli as tcli

REPO = Path(__file__).resolve().parents[1]
# each JAX launcher with its default method
LAUNCHERS = {"train.py": "semantic-nerfw", "train_nerf.py": "vanilla-nerf",
             "train_nerfacto.py": "nerfacto", "train_z1.py": "test-nerfacto"}
ARGVS = {
    "none": [],
    "options": ["--trainer.max_num_iterations", "2", "--dataparser.data_dir", "scene"],
    "method": ["nerfacto-tpu", "--trainer.max_num_iterations", "2"],
    "help": ["--help"],
    "h": ["-h"],
}
# the JAX package's tools with a port counterpart, tools/<name>_torch.py
TOOLS = ["study_field", "study_camera_opt", "study_vanilla", "study_flow", "train_segmenter",
         "tune_decoder", "validate_inpaint", "regen_data", "demo_motion_pipeline"]
PORT_ENTRY_POINTS = (["bench_torch.py"] + [f.replace(".py", "_torch.py") for f in LAUNCHERS]
                     + [f"tools/{t}_torch.py" for t in TOOLS])
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "nerf_kbs_tpu")


def _handed(monkeypatch, cli, script: Path, argv: list) -> list:
    """The argv lists that ``script``, run as a program with ``argv``,
    hands ``cli.main``."""
    seen = []
    monkeypatch.setattr(cli, "main", lambda args=None, **kw: seen.append(list(args)))
    monkeypatch.setattr(sys, "argv", [str(script)] + argv)
    runpy.run_path(str(script), run_name="__main__")
    return seen


@pytest.mark.parametrize("argv", ARGVS.values(), ids=ARGVS.keys())
@pytest.mark.parametrize("launcher", LAUNCHERS)
def test_launcher_hands_main_the_jax_twins_argv(monkeypatch, launcher, argv):
    want = _handed(monkeypatch, jcli, REPO / launcher, argv)
    got = _handed(monkeypatch, tcli, REPO / launcher.replace(".py", "_torch.py"), argv)
    assert got == want
    if argv[:1] in (["--help"], ["-h"]) or argv[:1] == ["nerfacto-tpu"]:
        assert got == [argv]  # passed through untouched
    else:
        assert got == [[LAUNCHERS[launcher]] + argv]


@pytest.mark.parametrize("name", PORT_ENTRY_POINTS)
def test_entry_point_source_imports_no_jax(name):
    """Every import statement of the file, at any depth, names a module
    outside the JAX package and its libraries."""
    tree = ast.parse((REPO / name).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert any(m.startswith("nerf_kbs_tpu_torch") for m in mods), mods
    assert not [m for m in mods if m.split(".")[0] in JAX_MODULES], mods


# tools that need no port: they import nothing of JAX (check_evidence.py,
# wallclock_to_psnr.py), or are the port's own already (make_lpips_ckpt.py,
# torch; cpu_drift_study.py, the port's CPU study)
PORT_READY_TOOLS = ["check_evidence.py", "wallclock_to_psnr.py", "make_lpips_ckpt.py",
                    "cpu_drift_study.py"]


@pytest.mark.parametrize("name", PORT_READY_TOOLS)
def test_tool_without_a_counterpart_imports_no_jax(name):
    tree = ast.parse((REPO / "tools" / name).read_text())
    mods = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    mods += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in mods if m.split(".")[0] in JAX_MODULES], mods


def test_entry_points_load_without_jax():
    """bench_torch imported and the four launchers loaded (not as programs)
    in a fresh interpreter leave no JAX module behind."""
    code = (
        "import runpy, sys\n"
        "import bench_torch\n"
        f"for f in {PORT_ENTRY_POINTS[1:]!r}:\n"
        "    runpy.run_path(f)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {JAX_MODULES!r}]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_wallclock_to_psnr_reads_the_port_trainers_metrics(tmp_path, monkeypatch, capsys):
    """tools/wallclock_to_psnr.py on the metrics.jsonl of 4 steps of the
    port's Trainer (an eval image every 2 steps): a row per logged step with
    its train and eval PSNR at the run's own elapsed_s, and the first
    crossing of a threshold every row clears."""
    import json

    import numpy as np

    from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager
    from nerf_kbs_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
    from nerf_kbs_tpu_torch.models.nerfacto import NerfactoConfig

    monkeypatch.syspath_prepend(str(REPO / "tools"))
    import wallclock_to_psnr

    cfg = NerfactoConfig(num_images=4, field_type="fourier", hidden_dim=16, hidden_dim_color=16,
                         fourier_num_levels=2, fourier_features_per_level=8,
                         proposal_num_levels=2, proposal_fourier_features_per_level=4,
                         max_res=32, proposal_max_res=(16, 32), appearance_embedding_dim=0,
                         num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
                         near_plane=0.05, far_plane=8.0, compute_dtype="float32")
    dm = SyntheticDataManager(num_cameras=4, num_eval_cameras=1, h=12, w=12, rays_per_batch=32)
    tc = TrainerConfig(output_dir=str(tmp_path), method_name="m", log_every=1,
                       steps_per_eval_image=2, steps_per_eval_batch=10**9,
                       steps_per_eval_all_images=10**9, steps_per_save=10**9,
                       eval_num_rays_per_chunk=144)
    Trainer(tc, cfg, nerfacto_tpu_method().optimizers, dm, device="cpu").train(4)
    path = tmp_path / "exp" / "m" / "metrics.jsonl"
    lines = [json.loads(ln) for ln in path.read_text().splitlines()]
    rows = wallclock_to_psnr.load_run(path, 32)
    assert [r[0] for r in rows] == [ln["step"] for ln in lines] == [1, 2, 2, 3, 4, 4]
    assert [r[1] for r in rows] == [ln["elapsed_s"] for ln in lines]
    assert {k for r in rows for k in r[2]} == {"psnr", "eval_psnr"}
    lowest = min(v for r in rows for v in r[2].values())
    got = wallclock_to_psnr.crossings(rows, [lowest])
    assert got == {"psnr": {lowest: (1, lines[0]["elapsed_s"])},
                   "eval_psnr": {lowest: (2, lines[2]["elapsed_s"])}}
    assert all(np.isfinite(v) for r in rows for v in r[2].values())
    monkeypatch.setattr(sys, "argv", ["wallclock_to_psnr.py", str(path), "--batch", "32",
                                      "--thresholds", f"{lowest}"])
    wallclock_to_psnr.main()
    out = capsys.readouterr().out
    assert "(last step 4" in out and "eval_psnr" in out and "psnr" in out
