"""Observability: the SIGUSR1 stack dump, a torch.profiler trace, the
program's own spans, and the card's memory counters (the JAX package's
``utils/profiling.py`` on ``torch.profiler`` and ``torch.cuda``).

``span(name)`` names a piece of the program's work where it happens: the
training step and its phases, the batch draw, the kernel wrappers. Spans are
on exactly while a ``torch.profiler`` records (``trace`` below, or any other
profiler session). Off, ``span`` reads one bool and returns a shared null
context. On, a span

- marks the profile, ``record_function("nkt.<name>")``: the mark lies on the
  clock of the device's kernels, so a trace viewer, or a reader of the
  device's idle gaps, sees which span the host was in;
- adds its host duration to in-memory totals by name (``span_totals``): a
  count, the host ns including child spans, the self ns (the duration less
  the part of it that child spans on the same thread cover) and the parents
  it ran under;
- given a CUDA device, records a pair of CUDA events on the device's current
  stream, and ``span_totals`` adds the finished pairs' time (``device_ms``):
  the stream's time from reaching the span's first work to finishing its
  last, busy or idle.

The totals hold the last tracing session: the first span of a session clears
them, a session being known as new once a span or ``span_totals`` saw tracing
off (``trace`` starts one itself). They change under a lock, since a live
viewer's thread renders through the same wrappers while the trainer steps.
The autograd engine runs the backward of CUDA tensors on a thread of its own,
so a wrapper span inside a backward has no parent there.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import faulthandler
import functools
import json
import signal
import sys
import threading
import time
from pathlib import Path
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd.profiler import record_function


def install_faulthandler() -> None:
    """SIGUSR1 dumps every thread's stack (for a hung run) to the process's
    standard error, whatever has replaced ``sys.stderr``."""
    try:
        faulthandler.register(signal.SIGUSR1, file=sys.__stderr__)
    except (AttributeError, ValueError):  # no SIGUSR1 on this platform
        faulthandler.enable(file=sys.__stderr__)


class _Totals:
    """The spans' totals by name, the CUDA event pairs not yet added to them,
    and finished events kept for reuse."""

    # pending event pairs at which a device span's exit adds the finished ones
    FOLD_AT = 32

    def __init__(self):
        self.lock = threading.Lock()
        self.by_name: dict = {}
        # (name, start, end, device index)
        self.pending: collections.deque = collections.deque()
        self.free: dict = {}  # device index -> [finished events]
        self.stale = True  # tracing was seen off: the next span clears the totals
        self.local = threading.local()

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack

    def open_session(self) -> None:
        if self.stale:
            with self.lock:
                if self.stale:
                    self.by_name = {}
                    self.pending.clear()
                    self.stale = False

    def event(self, device_index: int) -> torch.cuda.Event:
        with self.lock:
            pool = self.free.get(device_index)
            if pool:
                return pool.pop()
        return torch.cuda.Event(enable_timing=True)

    def add(self, name: str, parent: str, host_ns: int, self_ns: int, pair) -> None:
        with self.lock:
            t = self.by_name.get(name)
            if t is None:
                t = self.by_name[name] = {"count": 0, "host_ns": 0, "self_ns": 0, "parents": {}}
            t["count"] += 1
            t["host_ns"] += host_ns
            t["self_ns"] += self_ns
            t["parents"][parent] = t["parents"].get(parent, 0) + 1
            if pair is not None:
                t.setdefault("device_ms", 0.0)
                self.pending.append((name, *pair))
        if pair is not None and len(self.pending) >= self.FOLD_AT:
            self.fold()

    def fold(self) -> None:
        """Add every finished event pair's time to its span's ``device_ms``."""
        with self.lock:
            unfinished = collections.deque()
            for name, start, end, index in self.pending:
                if not end.query():
                    unfinished.append((name, start, end, index))
                    continue
                self.by_name[name]["device_ms"] += start.elapsed_time(end)
                self.free.setdefault(index, []).extend((start, end))
            self.pending = unfinished


_TOTALS = _Totals()
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "stream", "parent", "children_ns", "mark", "start", "t0")

    def __init__(self, name: str, stream):
        self.name, self.stream = name, stream

    def __enter__(self):
        # the host time includes the span's own mark and events: the caller
        # waits for them too
        self.t0 = time.perf_counter_ns()
        _TOTALS.open_session()
        stack = _TOTALS.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self)
        self.children_ns = 0
        self.mark = record_function("nkt." + self.name)
        self.mark.__enter__()
        self.start = None
        if self.stream is not None:
            self.start = _TOTALS.event(self.stream.device_index)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        pair = None
        if self.stream is not None:
            end = _TOTALS.event(self.stream.device_index)
            end.record(self.stream)
            pair = (self.start, end, self.stream.device_index)
        self.mark.__exit__(*exc)
        _TOTALS.stack().pop()
        host_ns = time.perf_counter_ns() - self.t0
        parent = self.parent
        if parent is not None:
            parent.children_ns += host_ns
        _TOTALS.add(self.name, "" if parent is None else parent.name, host_ns,
                    host_ns - self.children_ns, pair)
        return False


def span(name: str, device: Optional[torch.device] = None):
    """A context that marks ``name`` while a profiler records (see the module
    docstring), and otherwise does nothing. ``device``: where the span's work
    runs; a CUDA device adds the time of its current stream (``device_ms``)."""
    if not _autograd_profiler._is_profiler_enabled:
        _TOTALS.stale = True
        return _OFF
    stream = None
    if device is not None and device.type == "cuda":
        stream = torch.cuda.current_stream(device)
    return _Span(name, stream)


def spanned(name: str):
    """Decorator: every call of the function runs inside ``span(name)``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return call

    return wrap


def span_totals() -> dict:
    """The spans of the last tracing session, by name: {'count', 'host_ns'
    (including child spans), 'self_ns', 'parents' ({parent span's name, ''
    for none: count}) and, for a span given a CUDA device, 'device_ms' (its
    event pairs that have finished)}. A copy."""
    if not _autograd_profiler._is_profiler_enabled:
        _TOTALS.stale = True
    _TOTALS.fold()
    with _TOTALS.lock:
        return copy.deepcopy(_TOTALS.by_name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CPU, and the card when there is one) and write
    a Chrome trace, ``<log_dir>/trace.json``, viewable in Perfetto, with the
    program's spans (``nkt.*``) in it, and their totals, ``spans.json``
    (``span_totals``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    _TOTALS.stale = True
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))
    (Path(log_dir) / "spans.json").write_text(json.dumps(span_totals(), indent=1,
                                                         sort_keys=True) + "\n")


def device_memory_stats(device=None) -> Optional[dict]:
    """The card's live and peak allocated bytes and its total memory, under
    the JAX package's keys (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_limit``); None without a card."""
    if not torch.cuda.is_available():
        return None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": total}
