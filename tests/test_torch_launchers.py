"""The port's root entry points: each train*_torch.py launcher hands the
port's CLI main the argv that its JAX twin (train*.py) hands the JAX main,
and bench_torch.py and the four launchers import nothing of JAX."""

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
PORT_ENTRY_POINTS = ["bench_torch.py"] + [f.replace(".py", "_torch.py") for f in LAUNCHERS]
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
