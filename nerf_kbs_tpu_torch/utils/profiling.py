"""Observability: the SIGUSR1 stack dump, a torch.profiler trace, step timers
with rays/s, and the card's memory counters (the JAX package's
``utils/profiling.py`` on ``torch.profiler`` and ``torch.cuda``)."""

from __future__ import annotations

import contextlib
import faulthandler
import signal
import sys
import time
from pathlib import Path
from typing import Optional

import torch


def install_faulthandler() -> None:
    """SIGUSR1 dumps every thread's stack (for a hung run) to the process's
    standard error, whatever has replaced ``sys.stderr``."""
    try:
        faulthandler.register(signal.SIGUSR1, file=sys.__stderr__)
    except (AttributeError, ValueError):  # no SIGUSR1 on this platform
        faulthandler.enable(file=sys.__stderr__)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block (the CPU, and the card when there is one) and write
    a Chrome trace, ``<log_dir>/trace.json``, viewable in Perfetto."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(log_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


class StepTimer:
    """Wall-clock step timing with rays/s. ``tick(rays, sync_on=t)`` with a
    CUDA tensor ``t`` waits for the card first, so that the time is the
    device's and not the enqueue's."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()
        self._rays = 0
        self._steps = 0

    def tick(self, rays: int, sync_on=None):
        if isinstance(sync_on, torch.Tensor) and sync_on.is_cuda:
            torch.cuda.synchronize(sync_on.device)
        self._rays += rays
        self._steps += 1

    def rates(self) -> dict:
        dt = max(time.perf_counter() - self._t0, 1e-9)
        return {"steps_per_sec": self._steps / dt, "rays_per_sec": self._rays / dt,
                "elapsed_s": dt}


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
