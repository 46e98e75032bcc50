"""One run of one cell: set-up, the measured window, the per-layer readers
(traced runs), the correctness check, and the result line's content. What
belongs to the cell's kind of traffic (the loop, its end-to-end readings and
its check) comes from ``loops/<kind>.py``, found by the mix's ``kind``."""

from __future__ import annotations

import gc
import time

from perfbench.lib import faults
from perfbench.lib.bench import Bench
from perfbench.lib.trace import Tracer

# a traced run's window: the profile of a longer one takes minutes to read
# back (a shorter ``--seconds`` shortens it)
TRACE_SECONDS = 3.0


class Context:
    """What a per-layer reader reads: the cell, its configuration and
    traffic, the window ({'steps', 'window_s', ...}) and its host spans,
    the device record, and the bench (for the work counts)."""

    def __init__(self, bench, cell, cfg, traffic, window, spans, record):
        self.bench, self.cell, self.cfg, self.traffic = bench, cell, cfg, traffic
        self.window, self.spans, self.record = window, spans, record

    @property
    def steps(self) -> int:
        return self.window["steps"]


def run(bench: Bench, name: str, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, fault: str | None = None) -> dict:
    """The cell's run; returns {'result': the result line's keys but
    'checks', 'checks': {name: {value, limit}}, 'notes': lines for standard
    error}. A traced run's window is the traced part: at most
    ``TRACE_SECONDS``."""
    import torch

    cell = bench.cell(name)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    kind = bench.module("loops", traffic["kind"])
    notes = []

    marks = [("start", t_start), ("imports", time.perf_counter())]
    program = kind.make_program(cfg, traffic, seed, device,
                                bench.root / "perfbench" / "cache")
    marks.append(("scene and trainer", time.perf_counter()))
    dev = program.device
    tracer = Tracer(profile=trace)
    loop = kind.Loop(program, traffic, cfg, seed, tracer)
    faults.apply(fault, loop)
    cap = loop.capture(seed)
    marks.append(("weights and checked steps", time.perf_counter()))
    loop.warm_up()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    marks.append(("warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    notes.append("set-up: " + ", ".join(f"{phase} {b - a:.3f} s"
                                        for (_, a), (phase, b) in zip(marks, marks[1:])))
    tracer.spans.clear()

    before = program.launches()
    tracer.start()
    window = loop.run(min(seconds, TRACE_SECONDS) if trace else seconds)
    tracer.stop()
    after = program.launches()
    launches = {k: v - before.get(k, 0) for k, v in after.items() if v - before.get(k, 0)}
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    failed = loop.failed()

    metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
    e2e = loop.end_to_end(window)
    for m in bench.end_to_end(name):
        if m["name"] in e2e:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"attempted": window["steps"], "failed": failed, "device": device_info}
    per_step = {k: v / window["steps"] for k, v in launches.items()}
    notes.append(f"window{' (traced)' if trace else ''}: {loop.note(window)}; set-up "
                 f"{setup_s:.6f} s; wrapper launches a step {per_step} (the configuration "
                 f"expects {cfg.get('launches_per_step')})")

    if trace:
        record = tracer.record(program.kernel_names())
        ctx = Context(bench, cell, cfg, traffic, window, dict(tracer.spans), record)
        layer = {}
        for m in bench.per_layer(name):
            value = bench.reader(m["name"]).read(ctx, m["name"])
            if value is not None:
                layer[m["name"]] = {"value": value, "unit": m["unit"]}
        metrics = layer
        device_info["busy_s"] = record.busy_s
        device_info["window_s"] = record.window_us * 1e-6
        result["breakdown"] = {"device_ops": record.top_ops(), "idle_gaps": record.top_gaps()}
        del record, ctx
    result["metrics"] = metrics

    del loop, program, tracer
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    correct, table, note = kind.judge(cap, cfg, dev, limits)
    notes.append(note)
    result["correct"] = bool(correct and failed == 0)
    return {"result": result, "checks": table, "notes": notes}
