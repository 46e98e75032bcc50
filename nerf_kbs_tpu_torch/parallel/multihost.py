"""Process-group set-up and per-process data sharding helpers, the
counterpart of the JAX package's ``parallel/multihost.py``.

Every process runs the same program and drives one device. ``initialize``
joins the processes into a ``torch.distributed`` process group, and each
process feeds its share of the global ray batch.

The backend: NCCL when every rank has a card of its own; gloo when the ranks
share a card (more ranks than cards: NCCL refuses two ranks on one GPU) or
run on the CPU. A rank's device is ``cuda:(LOCAL_RANK % device_count)``.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from nerf_kbs_tpu_torch.device import resolve_device


def _env_int(name: str) -> Optional[int]:
    raw = os.environ.get(name)
    return int(raw) if raw else None


def choose_backend(world: int, device=None) -> str:
    """'nccl' when ``world`` ranks on CUDA each get a card of their own,
    else 'gloo'."""
    on_cuda = device is None or torch.device(device).type == "cuda"
    if on_cuda and torch.cuda.is_available() and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """The device this process drives: ``device`` when given, else the card
    ``LOCAL_RANK % device_count`` (raises without CUDA, as
    ``device.resolve_device`` does)."""
    if device is not None:
        return resolve_device(device)
    resolve_device(None)
    return torch.device("cuda", (_env_int("LOCAL_RANK") or 0) % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> dict:
    """Joins the process group when there is more than one process; a no-op
    when a group exists already or with one process. ``num_processes``
    defaults to ``NKT_NUM_PROCESSES``, else torchrun's ``WORLD_SIZE``, else
    1; ``process_id`` to ``RANK``. The group rendezvouses at
    ``tcp://coordinator_address`` when given, else through ``env://``
    (``MASTER_ADDR``, ``MASTER_PORT``). ``device`` is where this process
    computes (None: its card), which picks the backend. Returns
    {process_index, process_count, local_devices, global_devices}."""
    if num_processes is None:
        num_processes = _env_int("NKT_NUM_PROCESSES") or _env_int("WORLD_SIZE") or 1
    if num_processes > 1 and not dist.is_initialized():
        if process_id is None:
            process_id = _env_int("RANK")
            if process_id is None:
                raise RuntimeError(f"{num_processes} processes but no rank: pass process_id or "
                                   "set RANK")
        backend = choose_backend(num_processes, device)
        if backend == "nccl":
            torch.cuda.set_device(rank_device(device))
        init = f"tcp://{coordinator_address}" if coordinator_address else "env://"
        dist.init_process_group(backend, init_method=init, world_size=num_processes,
                                rank=process_id)
    rank, world = host_shard_info()
    return {"process_index": rank, "process_count": world, "local_devices": 1,
            "global_devices": world}


def host_shard_info() -> tuple[int, int]:
    """(rank, world size) of this process, (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def all_sum_host_values(*arrays):
    """The element-wise sums over the processes of small host arrays, in
    their shapes, as float64: one flat all-reduce (on the rank's card with
    NCCL, on the CPU with gloo). The identity with one process."""
    rank, world = host_shard_info()
    if world == 1:
        return arrays
    flat = np.concatenate([np.asarray(a, np.float64).ravel() for a in arrays])
    buf = torch.from_numpy(flat)
    if dist.get_backend() == "nccl":
        buf = buf.to(torch.device("cuda", torch.cuda.current_device()))
    dist.all_reduce(buf, op=dist.ReduceOp.SUM)
    summed = buf.cpu().numpy()
    out, off = [], 0
    for a in arrays:
        n = np.asarray(a).size
        out.append(summed[off:off + n].reshape(np.shape(a)))
        off += n
    return tuple(out)


def local_batch_slice(global_batch: int) -> slice:
    """The rows of a global batch that this process holds:
    ``global_batch // world`` of them, in rank order."""
    rank, world = host_shard_info()
    if global_batch % world != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {world} hosts")
    per = global_batch // world
    return slice(rank * per, (rank + 1) * per)
