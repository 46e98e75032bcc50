"""Spans on the host clock and, in a traced run, the device's record of the
window from ``torch.profiler``.

The harness's own spans wrap its calls into the program (the batch draw,
the training step); they are timed in every run and, in a traced run, also
marked in the profile (``perfbench.<name>``), so that an idle gap on the
device can be named by what the host was doing. ``DeviceRecord`` reduces a
traced window to what the per-layer readers need: every device operation
with its duration and, for a kernel built from the port's ``csrc/``, the
source it comes from.
"""

from __future__ import annotations

import bisect
import contextlib
import re
import time
from collections import defaultdict


def short_name(name: str) -> str:
    """A kernel's name without its trailing parameter list, at most 120
    characters."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i].rstrip() or name
                break
    return name[:120]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


class Tracer:
    """Host spans always; the profiler between ``start`` and ``stop`` when
    ``profile``."""

    def __init__(self, profile: bool):
        self.profile = profile
        self.spans: dict = defaultdict(list)
        self._prof = None
        self._window = None

    @contextlib.contextmanager
    def span(self, name: str):
        if self.profile:
            from torch.profiler import record_function

            mark = record_function(f"perfbench.{name}")
        else:
            mark = contextlib.nullcontext()
        t0 = time.perf_counter()
        with mark:
            yield
        self.spans[name].append(time.perf_counter() - t0)

    def start(self) -> None:
        if not self.profile:
            return
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._window = record_function("perfbench.window")
        self._window.__enter__()

    def stop(self) -> None:
        """Stop the profiler (once)."""
        if self._prof is None or self._window is None:
            return
        self._window.__exit__(None, None, None)
        self._window = None
        self._prof.__exit__(None, None, None)

    def record(self, kernel_names: dict) -> "DeviceRecord | None":
        if self._prof is None:
            return None
        return DeviceRecord(self._prof.events(), kernel_names)


class DeviceRecord:
    """The traced window: ``events`` [(short name, seconds, csrc source or
    None, is a kernel)] of every device operation in it, in start order;
    ``busy_s``, the union of their intervals; ``idle_gaps``, the gaps between
    them summed by what the host was doing ({label: seconds})."""

    def __init__(self, function_events, kernel_names: dict):
        from torch.autograd import DeviceType

        cpu, device, marks, window = [], [], [], None
        for e in function_events:
            tr = e.time_range
            if e.device_type == DeviceType.CUDA:
                # the device side of a host annotation is no device work
                if not (getattr(e, "is_user_annotation", False)
                        or e.name.startswith("perfbench.")):
                    device.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CPU:
                if e.name == "perfbench.window":
                    window = (tr.start, tr.end)
                elif e.name.startswith("perfbench."):
                    marks.append((tr.start, tr.end, e.name[len("perfbench."):]))
                else:
                    cpu.append((tr.start, tr.end, e.name))
        if window is None:
            raise RuntimeError("the profile holds no perfbench.window span")
        lo, hi = window
        device = sorted((max(s, lo), min(e, hi), n) for s, e, n in device if e > lo and s < hi)
        self.window_us = hi - lo

        names = sorted(kernel_names, key=len, reverse=True)
        pat = re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b") if names else None
        self.events = []
        last_source = None
        for s, e, n in device:
            source, kernel = None, not is_copy(n)
            m = pat.search(n) if (pat is not None and kernel) else None
            if m is not None:
                source = kernel_names[m.group(1)]
                if source is None:  # a header's kernel: its launcher's source
                    source = last_source
                else:
                    last_source = source
            self.events.append((short_name(n), (e - s) * 1e-6, source, kernel))

        merged = []
        for s, e, _ in device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.busy_s = sum(e - s for s, e in merged) * 1e-6
        edges = [lo] + [x for iv in merged for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        self.idle_gaps = self._label(gaps, sorted(cpu), sorted(marks))

    @staticmethod
    def _label(gaps, cpu, marks, top: int = 400) -> dict:
        """The longest ``top`` gaps, summed by the innermost host operation
        running at each one's middle, under the harness span it lies in."""
        starts = [c[0] for c in cpu]
        mstarts = [m[0] for m in marks]
        out: dict = defaultdict(float)
        for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:top]:
            mid = 0.5 * (s + e)
            span = "outside a step"
            i = bisect.bisect_right(mstarts, mid) - 1
            if i >= 0 and marks[i][1] >= mid:
                span = marks[i][2]
            op = None
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(j - 20000, -1), -1):
                if cpu[k][1] >= mid:
                    op = cpu[k][2]
                    break
            out[span if op is None else f"{span}: {op}"] += (e - s) * 1e-6
        return dict(out)

    def top_ops(self, n: int = 10) -> list:
        by: dict = defaultdict(float)
        for name, d, _, _ in self.events:
            by[name] += d
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def top_gaps(self, n: int = 10) -> list:
        return sorted(([k, v] for k, v in self.idle_gaps.items()), key=lambda kv: -kv[1])[:n]
