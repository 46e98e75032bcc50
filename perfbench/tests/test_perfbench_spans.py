"""The program's spans as the benchmark reads them (``metrics/span_host_ms.py``,
``metrics/span_device_ms.py``): a tiny traced run of each cell on the CPU
lists every ``span_host_ms.*`` metric of its cell, the program's step span
reads what the harness's span around the call reads, and no point inside the
harness's spans, past their edges, is left without a program span, so that
no idle gap is named by the bare harness span. On a card: the spans add no
device operation to the trace."""

from __future__ import annotations

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
from perfbench.lib.trace import DeviceRecord, Tracer  # noqa: E402

CELLS = {"ilf050-train-128k": "nerfacto-tpu-ilf050", "hash-train-16k": "semantic-nerfw-hash"}
PHASES = ("h2d", "forward", "loss", "backward", "optimizer")
SEED = 2**31 + 7


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.write_bench(tmp_path_factory.mktemp("spans"))


@pytest.mark.parametrize("name", list(CELLS))
def test_a_traced_run_lists_every_span_metric(root, name):
    bench = tiny.bench(root)
    out = cell.run(bench, name, SEED, 0.5, True, "cpu", time.perf_counter())
    metrics = {k: v["value"] for k, v in out["result"]["metrics"].items()}
    want = {m["name"] for m in bench.per_layer(name) if m["name"].startswith("span_host_ms.")}
    assert want and want <= set(metrics), want - set(metrics)
    # the event pairs time a CUDA stream alone
    assert not [k for k in metrics if k.startswith("span_device_ms.")]
    step = metrics["span_host_ms.train_step"]
    assert step <= metrics["host_step_ms.train"]
    assert step == pytest.approx(metrics["host_step_ms.train"], rel=0.05)
    assert 0.9 * step <= sum(metrics[f"span_host_ms.train_step.{p}"] for p in PHASES) <= step
    assert metrics["span_host_ms.next_train"] <= metrics["batch_draw_ms"]
    assert out["result"]["correct"]


def _host_events(events):
    """(host operations, harness spans, program spans) that start inside the
    profile's window, each [(start us, end us, name)] sorted, as
    ``DeviceRecord`` splits them."""
    from torch.autograd import DeviceType

    host = [e for e in events if e.device_type == DeviceType.CPU]
    (lo, hi), = [(e.time_range.start, e.time_range.end) for e in host
                 if e.name == "perfbench.window"]
    cpu, marks, spans = [], [], []
    for e in host:
        iv = (e.time_range.start, e.time_range.end)
        if e.name == "perfbench.window" or not lo <= iv[0] <= hi:
            continue
        if e.name.startswith("perfbench."):
            marks.append((*iv, e.name[len("perfbench."):]))
        else:
            cpu.append((*iv, e.name))
            if e.name.startswith("nkt."):
                spans.append((*iv, e.name[len("nkt."):]))
    return sorted(cpu), sorted(marks), sorted(spans)


def _traced_window(root, name, seconds=None, steps=None, device="cpu", cfg=None, rays=None):
    """(the loop's tracer, the window, the profile's events, the program,
    the window's span totals: count, host ns and device ms) of a traced
    window after warm-up, as ``lib/cell.py`` runs one: ``seconds`` long, or
    ``steps`` steps. One step runs in the profiler before the window: the
    first operations of a session are slow to mark, and the first kernels
    can go unrecorded."""
    import torch

    from nerf_kbs_tpu_torch.utils import profiling

    bench = tiny.bench(root)
    w = bench.cell(name)
    cfg = cfg or bench.config(w["config"])
    traffic = bench.traffic(w["traffic"])
    if rays:
        traffic["rays_per_step"] = rays
    kind = bench.module("loops", traffic["kind"])
    program = kind.make_program(cfg, traffic, SEED, device, root / "perfbench" / "cache")
    tracer = Tracer(profile=True)
    loop = kind.Loop(program, traffic, cfg, SEED, tracer)
    loop.warm_up()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    with torch.profiler.profile(activities=acts) as prof:
        loop.step(*loop.draw())
        sync()
        tracer.spans.clear()
        before = profiling.span_totals()
        with torch.profiler.record_function("perfbench.window"):
            if steps is None:
                window = loop.run(seconds)
            else:
                for _ in range(steps):
                    loop.step(*loop.draw())
                sync()
                window = {"steps": steps}
    totals = {}
    for n, t in profiling.span_totals().items():
        was = before.get(n, {})
        totals[n] = {k: t[k] - was.get(k, 0) for k in ("count", "host_ns", "device_ms") if k in t}
    return tracer, window, prof.events(), program, totals


@pytest.mark.parametrize("name", list(CELLS))
def test_no_gap_is_named_by_a_bare_harness_span(root, name):
    tracer, window, events, program, totals = _traced_window(root, name, seconds=0.3)
    steps = window["steps"]
    assert steps > 0 and totals["train_step"]["count"] == steps
    assert totals["next_train"]["count"] == steps
    # the program's step span over the same steps as the harness's
    harness_ns = 1e9 * sum(tracer.spans["train_step"])
    assert totals["train_step"]["host_ns"] <= harness_ns
    assert totals["train_step"]["host_ns"] == pytest.approx(harness_ns, rel=0.05)

    cpu, marks, spans = _host_events(events)
    inner = {"train_step": "train_step", "batch_draw": "next_train"}
    assert sorted(m[2] for m in marks) == sorted(["train_step", "batch_draw"] * steps)
    for s, e, label in marks:
        # the program's span covers the harness's but for its edges: a mark's
        # entry and exit, tens of microseconds under the profiler
        (cover,) = [sp for sp in spans if sp[2] == inner[label] and s <= sp[0] and sp[1] <= e]
        assert (cover[0] - s) + (e - cover[1]) <= max(0.02 * (e - s), 200.0), (label, s, e, cover)
    # a gap at the middle of each harness span is named by what ran inside
    gaps = [(s + (e - s) / 3, e - (e - s) / 3) for s, e, _ in marks]
    labels = DeviceRecord._label(gaps, cpu, marks, top=len(gaps))
    assert labels and not set(labels) & {"train_step", "batch_draw"}, labels
    assert all(k.startswith(("train_step: ", "batch_draw: ")) for k in labels), labels
    record = DeviceRecord(events, program.kernel_names())
    assert not set(record.idle_gaps) & {"train_step", "batch_draw"}, record.idle_gaps


def window_kernels(root: str, name: str, marks: bool) -> dict:
    """On a card: four traced steps of the cell at its configuration's own
    widths on the tiny scene, with the spans' marks or with the marks
    replaced by nothing: {'kernels': their device kernels in order,
    'annotations': the profile's device-side ``nkt.*`` events, 'flagged':
    whether each is a user annotation, 'kept': the ``nkt.*`` names the
    harness's record kept, 'forward_device_ms': the forward's event pairs}.
    Run in a process of its own: a later profiler session of a process can
    lose kernel records."""
    import contextlib

    from torch.autograd import DeviceType

    from nerf_kbs_tpu_torch.utils import profiling

    if not marks:
        profiling.record_function = lambda _name: contextlib.nullcontext()
    cfg = tiny.tiny_config(CELLS[name])
    real = json.loads((tiny.BENCH_DIR / "configs" / f"{CELLS[name]}.json").read_text())
    own = set(zip(real["argv"][::2], real["argv"][1::2]))
    widths = {f"--model.{k}" for k in tiny.TINY[CELLS[name]]}
    pairs = list(zip(cfg["argv"][::2], cfg["argv"][1::2]))
    cfg["argv"] = [a for p in pairs if p[0] not in widths or p in own for a in p]
    cfg["model"] = real["model"]
    _, _, events, program, totals = _traced_window(Path(root), name, steps=4, device="cuda",
                                                   cfg=cfg, rays=1024)
    record = DeviceRecord(events, program.kernel_names())
    device = [e for e in events if e.device_type == DeviceType.CUDA and e.name.startswith("nkt.")]
    return {"kernels": [n for n, _, _, k in record.events if k],
            "annotations": len(device),
            "flagged": all(getattr(e, "is_user_annotation", False) for e in device),
            "kept": [n for n, *_ in record.events if n.startswith("nkt.")],
            "forward_device_ms": totals.get("train_step.forward", {}).get("device_ms", 0.0)}


PROBE = """
import json, sys
sys.path[:0] = [{tests!r}, {repo!r}]
import test_perfbench_spans as t
print(json.dumps(t.window_kernels({root!r}, {name!r}, {marks!r})))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CELLS))
def test_spans_add_no_device_operation(root, name):
    """On a card: the marks reach the device trace only as user annotations,
    which the harness's record drops, and the same four steps (seed,
    weights, batches) give the same kernels with the marks and without."""
    import subprocess

    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def run(marks):
        probe = PROBE.format(tests=str(Path(__file__).resolve().parent), repo=str(REPO),
                             root=str(root), name=name, marks=marks)
        out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                             timeout=900, cwd=REPO)
        assert out.returncode == 0, out.stderr[-3000:]
        return json.loads(out.stdout.strip().splitlines()[-1])

    on, off = run(True), run(False)
    assert on["annotations"] > 0 and on["flagged"] and not on["kept"]
    assert on["forward_device_ms"] > 0 and off["annotations"] == 0
    assert len(on["kernels"]) == len(off["kernels"]) and on["kernels"] == off["kernels"]
