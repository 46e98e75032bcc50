"""The benchmark's description and the files it names.

``BENCHMARK.json`` at the root of the checkout lists configurations, cells
(``workloads``) and metrics. Everything that belongs to one of them lives in
a file of its own, found by its name under ``perfbench/``:

- ``configs/<config>.json``: the configuration (the entry's ``file``);
- ``traffic/<mix>.json``: a traffic mix's parameters; its ``kind`` names
  the generator that reads it, ``loops/<kind>.py`` (the loop, the kind's
  end-to-end readings and its correctness check);
- ``checks/<cell>.json``: the limits of a cell's correctness check;
- ``metrics/<family>.py``: the reader of a per-layer metric, chosen by the
  part of the metric's name before its first dot (``<kernel>_roofline``
  falls back to ``metrics/roofline.py``);
- ``work/<kernel>.py``: a kernel's operations, bytes and instructions.

A later cell, configuration, metric or roofline is new files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path


class BenchError(RuntimeError):
    pass


class Bench:
    """``root``: the directory holding BENCHMARK.json; ``dirs``: the
    benchmark directories searched for a named file, in order (the
    checkout's ``perfbench/`` by default)."""

    def __init__(self, root: Path, dirs: list | None = None):
        self.root = Path(root)
        path = self.root / "BENCHMARK.json"
        if not path.is_file():
            raise BenchError(f"no BENCHMARK.json in {self.root}")
        self.spec = json.loads(path.read_text())
        self.dirs = [Path(d) for d in (dirs or [self.root / "perfbench"])]
        self._modules: dict = {}

    # ------------------------------------------------------------ entries
    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise BenchError(f"no workload {name!r} in BENCHMARK.json "
                         f"({[w['name'] for w in self.spec['workloads']]})")

    def config_entry(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise BenchError(f"no config {name!r} in BENCHMARK.json")

    def end_to_end(self, cell: str) -> list:
        """The cell's end-to-end metric entries."""
        return [m for m in self.spec["end_to_end"] if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        return [m for m in self.spec["per_layer"] if cell in m.get("workloads", [cell])]

    # -------------------------------------------------------------- files
    def find(self, sub: str, name: str) -> Path:
        for d in self.dirs:
            p = d / sub / name
            if p.is_file():
                return p
        raise BenchError(f"no {sub}/{name} under {[str(d) for d in self.dirs]}")

    def config(self, name: str) -> dict:
        cfg = json.loads((self.root / self.config_entry(name)["file"]).read_text())
        cfg["name"] = name
        return cfg

    def traffic(self, mix: str) -> dict:
        t = json.loads(self.find("traffic", f"{mix}.json").read_text())
        t["name"] = mix
        return t

    def limits(self, cell: str) -> dict:
        return json.loads(self.find("checks", f"{cell}.json").read_text())

    def module(self, sub: str, name: str):
        key = (sub, name)
        if key not in self._modules:
            path = self.find(sub, f"{name}.py")
            spec = importlib.util.spec_from_file_location(f"perfbench_{sub}_{name}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]

    def reader(self, metric: str):
        """The per-layer reader of ``metric`` (a module with ``read(ctx,
        name)``)."""
        family = metric.split(".", 1)[0]
        try:
            return self.module("metrics", family)
        except BenchError:
            if family.endswith("_roofline"):
                return self.module("metrics", "roofline")
            raise

    def work(self, kernel: str):
        return self.module("work", kernel)
