"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``nerf_kbs_tpu`` (compared whole: the port,
``nerf_kbs_tpu_torch``, begins with the JAX package's name), in a process
that loads every harness module and runs a cell on the CPU; and the
reference imports nothing of the port."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "nerf_kbs_tpu"}

PROBE = f"""
import sys, tempfile, time
from pathlib import Path
sys.path.insert(0, {str(REPO)!r}); sys.path.insert(0, {str(REPO / 'perfbench' / 'tests')!r})
import perfbench.run as run
import perfbench_tiny as tiny
from perfbench.lib import cell
from perfbench.lib.bench import Bench
for sub in ("metrics", "work", "loops"):
    b = Bench(Path({str(REPO)!r}))
    for p in sorted((Path({str(REPO)!r}) / "perfbench" / sub).glob("*.py")):
        b.module(sub, p.stem)
root = tiny.write_bench(Path(tempfile.mkdtemp()))
for name in ("ilf050-train-128k", "hash-train-16k"):
    cell.run(tiny.bench(root), name, 3, 0.1, True, "cpu", time.perf_counter())
print(sorted({{m.split(".", 1)[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True,
                         timeout=600, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    tops, found = out.stdout.strip().splitlines()[-2:]
    tops = set(ast.literal_eval(tops))
    assert "nerf_kbs_tpu_torch" in tops
    assert not tops & FORBIDDEN, tops & FORBIDDEN
    assert found == "[]"


def test_the_guard_compares_whole_names(monkeypatch):
    sys.path.insert(0, str(REPO))
    from perfbench import run

    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "nerf_kbs_tpu_torch_probe", sys)
    assert run.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "nerf_kbs_tpu.ops", sys)
    assert "nerf_kbs_tpu" in run.forbidden_modules()


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_program():
    for p in (REPO / "perfbench" / "reference").glob("*.py"):
        names = _imports(p)
        assert not names & (FORBIDDEN | {"nerf_kbs_tpu_torch", "perfbench"}), (p, names)


def test_the_harness_imports_no_jax():
    for p in (REPO / "perfbench").rglob("*.py"):
        assert not _imports(p) & FORBIDDEN, p
