"""The harness is driven by data: a cell made of new files only (a
configuration, a traffic mix, the check's limits) and one ``workloads``
entry is found, parsed and run, with no harness file changed; so is a new
kind of traffic (a loop of its own under ``loops/``) that reports an
end-to-end metric of its own. A rate is all the work of the window over
all its time, and a span's reading the mean over every step of the
window."""

from __future__ import annotations

import hashlib
import json
import sys
import time
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny as tiny  # noqa: E402
from perfbench.lib import cell  # noqa: E402
from perfbench.lib.bench import Bench, BenchError  # noqa: E402
from perfbench.loops.train import Loop as TrainLoop  # noqa: E402


def _harness_digest() -> str:
    h = hashlib.sha256()
    for p in sorted((REPO / "perfbench").rglob("*.py")):
        if "tests" not in p.parts:
            h.update(p.read_bytes())
    return h.hexdigest()


def test_a_cell_of_new_files_runs(tmp_path):
    before = _harness_digest()
    sub = tmp_path / "perfbench"
    for d in ("configs", "traffic", "checks"):
        (sub / d).mkdir(parents=True)
    (sub / "configs" / "new-config.json").write_text(
        json.dumps(tiny.tiny_config("nerfacto-tpu-ilf050")))
    (sub / "traffic" / "new-mix.json").write_text(json.dumps({"kind": "train",
                                                             "rays_per_step": 32}))
    (sub / "checks" / "new-cell.json").write_text(json.dumps(
        {"loss_gap": 1e-3, "grad_gap_worst_leaf": 1e-2, "change_gap_median_leaf": 1e-3}))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "new-config", "source": "x",
                            "file": "perfbench/configs/new-config.json", "reduced": [],
                            "why": "a new configuration"})
    spec["workloads"].append({"name": "new-cell", "config": "new-config", "traffic": "new-mix",
                              "chips": 1, "why": "a new cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and spec["workloads"][0]["name"] in m["workloads"]:
            m["workloads"].append("new-cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = Bench(tmp_path, dirs=[sub, REPO / "perfbench"])
    assert bench.traffic("new-mix")["rays_per_step"] == 32
    out = cell.run(bench, "new-cell", 11, 0.2, False, "cpu", time.perf_counter())
    res = out["result"]
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "train_rays_per_s"}
    traced = cell.run(bench, "new-cell", 12, 0.2, True, "cpu", time.perf_counter())
    assert "host_step_ms.train" in traced["result"]["metrics"]
    assert "busy_s" in traced["result"]["device"] and "breakdown" in traced["result"]
    assert _harness_digest() == before
    with pytest.raises(BenchError):
        bench.cell("no-such-cell")



NEW_KIND = """
from perfbench.loops import train

make_program, judge = train.make_program, train.judge


class Loop(train.Loop):
    @staticmethod
    def end_to_end(window):
        return {"steps_per_s": window["steps"] / window["window_s"]}
"""


def test_a_kind_of_new_files_runs(tmp_path):
    before = _harness_digest()
    name = "ilf050-train-128k"
    root = tiny.write_bench(tmp_path, {name: "nerfacto-tpu-ilf050"})
    sub = root / "perfbench"
    (sub / "loops").mkdir()
    (sub / "loops" / "new-kind.py").write_text(NEW_KIND)
    (sub / "traffic" / "new-kind-mix.json").write_text(json.dumps({"kind": "new-kind",
                                                                  "rays_per_step": 32}))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"][0]["traffic"] = "new-kind-mix"
    spec["end_to_end"].append({"name": "steps_per_s", "unit": "steps/s", "better": "higher",
                               "bound": 0.05, "source": "host_clock",
                               "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    out = cell.run(tiny.bench(root), name, 13, 0.2, False, "cpu", time.perf_counter())
    res = out["result"]
    assert res["correct"] and set(res["metrics"]) == {"setup_s", "steps_per_s"}
    assert res["metrics"]["steps_per_s"]["value"] > 0
    assert _harness_digest() == before


class _Trainer:
    """Steps that take 1, 5 and 20 ms in turn."""

    def __init__(self):
        import torch

        self.device = torch.device("cpu")
        self.step = 0
        self.dm = self
        self.times = [0.001, 0.005, 0.020]

    def next_train(self, step):
        return {"ray_indices": [[0, 0, 0]] * 4}

    def train_step(self, batch, jitters=None):
        import torch

        time.sleep(self.times[self.step % 3])
        self.step += 1
        return {"total_loss": torch.tensor(1.0)}


def test_the_rate_is_all_work_over_all_time():
    from perfbench.lib.trace import Tracer

    program = type("P", (), {"trainer": _Trainer()})()
    tracer = Tracer(False)
    loop = TrainLoop(program, {"rays_per_step": 4}, {"model": {"num_proposal_iterations": 2},
                                                     "start_step": 0}, 1, tracer)
    w = loop.run(0.3)
    spans = tracer.spans["train_step"]
    assert w["steps"] == len(spans) and w["rays"] == 4 * len(spans)
    # the window covers every step's whole time, slow and fast alike
    assert w["window_s"] >= sum(spans) + sum(tracer.spans["batch_draw"])
    assert w["window_s"] - sum(spans) < 0.05
    ctx = cell.Context(None, None, None, None, w, dict(tracer.spans), None)
    host = Bench(REPO).reader("host_step_ms.train").read(ctx, "host_step_ms.train")
    assert host == pytest.approx(1e3 * sum(spans) / len(spans))
    assert loop.failed() == 0
