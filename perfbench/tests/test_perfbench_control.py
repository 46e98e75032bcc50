"""The correctness check fails what it must, at a size the CPU holds: the
control (the reference with its products rounded to float8 e4m3, put in the
program's place) and each fault that a training cell can have, planted under
a run that skips only the look for a card: a step that leaves the state
unchanged, half of every batch left out, the rendered colour altered where
the model produces it. (The cells run on one chip: no exchange between
chips to leave out.)"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny as tiny  # noqa: E402
from perfbench.lib import cell, check, faults  # noqa: E402
from perfbench.lib.program import Program  # noqa: E402
from perfbench.lib.trace import Tracer  # noqa: E402
from perfbench.loops.train import Loop as TrainLoop  # noqa: E402
from perfbench.reference import nerf as ref  # noqa: E402

CELLS = ("ilf050-train-128k", "hash-train-16k")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.bench(tiny.write_bench(tmp_path_factory.mktemp("bench")))


@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails(bench, name):
    c = bench.cell(name)
    cfg = bench.config(c["config"])
    prog = Program(cfg, tiny.RAYS, 21, "cpu", cache=bench.root / "perfbench" / "cache")
    loop = TrainLoop(prog, bench.traffic(c["traffic"]), cfg, 21, Tracer(False))
    cap = check.capture(loop, ref.init_params(cfg["model"], prog.num_images(), 21,
                                              torch.device("cpu")))
    cams = prog.cameras()
    base = check.run_reference(cap, cfg, cams, torch.device("cpu"))
    ctl = check.run_reference(cap, cfg, cams, torch.device("cpu"), rounding="fp8")
    nums = check.numbers(check.reference_side(cap, ctl), check.reference_side(cap, base))
    correct, _ = check.verdict(nums, bench.limits(name))
    assert not correct, nums


@pytest.mark.parametrize("fault", faults.NAMES)
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_fails(bench, name, fault):
    out = cell.run(bench, name, 2**31 + 99, 0.1, False, "cpu", time.perf_counter(), fault=fault)
    assert not out["result"]["correct"], out["checks"]


def test_a_sound_run_passes(bench):
    out = cell.run(bench, CELLS[0], 2**31 + 99, 0.1, False, "cpu", time.perf_counter())
    assert out["result"]["correct"], out["checks"]
