"""Data parallelism over the ray batch across processes, the counterpart of
the JAX package's ``parallel/mesh.py``.

In the JAX package one mesh spans every chip, the batch is sharded on its
'data' axis, the parameters are replicated and XLA inserts the gradient
reduction. Here every process drives one device and holds a full copy of the
parameters and optimizer state (``replicate``: broadcast from rank 0), feeds
its share of the global batch (``shard_batch``), and makes the step's
collectives itself: ``all_reduce_grads`` (one flat sum per dtype, then / world)
between backward and update, and ``mean_over_ranks`` for the step's metrics.

A step computes the loss of the GLOBAL batch, as the sharded JAX step does.
Terms that are means over equal-sized local batches are exact under the
averaged gradients. The others (masked means, the depth alignment's
closed-form solve, a prefix of the batch) read the step's shard through
``global_batch``: ``batch_sum`` sums over the ranks, differentiably, and
``global_rows`` places the rank's rows in the global batch. A term that every rank
computes over the global rows backpropagates through ``batch_sum``'s
all-reduce, which sums the ranks' cotangents: each rank's gradient is then
``world`` times its rows' share, and the division in ``all_reduce_grads``
gives the gradient of the global loss. The sampler jitter is drawn for the
global batch and each rank takes its rows (``ops.samplers``).

With the gloo backend every collective is staged through the host: gloo
reduces CPU tensors. Not ported: ``batch_sharding`` and
``replicated_sharding`` (XLA shardings) and ``shard_batch_stack`` (the
scanned dispatch).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from nerf_kbs_tpu_torch.device import resolve_device
from nerf_kbs_tpu_torch.parallel.multihost import host_shard_info, rank_device

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the data-parallel group: ``rank`` of
    ``world``, the ``device`` it computes on and the process ``group``
    (None without one: then every collective is skipped)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup]
    axis_name: str = DATA_AXIS

    @property
    def stage_on_host(self) -> bool:
        return self.group is not None and dist.get_backend(self.group) == "gloo"


def make_mesh(device=None) -> Mesh:
    """The mesh of this process: the world's group when one exists (its
    card ``LOCAL_RANK % device_count`` unless ``device`` is given), else a
    one-process mesh on ``device`` (CUDA unless "cpu")."""
    rank, world = host_shard_info()
    if not dist.is_initialized():
        return Mesh(0, 1, resolve_device(device), None)
    return Mesh(rank, world, rank_device(device), dist.group.WORLD)


def _all_reduce_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Sum of ``t`` over the ranks, in place."""
    if mesh.group is None:
        return t
    if mesh.stage_on_host and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=mesh.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def _broadcast_(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Rank 0's ``t`` on every rank, in place."""
    if mesh.group is None:
        return t
    if mesh.stage_on_host and t.device.type != "cpu":
        host = t.cpu()
        dist.broadcast(host, src=0, group=mesh.group)
        t.copy_(host)
    else:
        dist.broadcast(t, src=0, group=mesh.group)
    return t


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) else []


def _by_dtype(tensors: list) -> dict:
    groups: dict = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    return groups


def shard_batch(mesh: Mesh, tree):
    """A batch of this rank's rows (NumPy arrays or tensors in a dict), on
    the rank's device. As in the JAX package's multi-process runs, each
    process passes its own share of the global batch: its datamanager draws
    ``global // world`` rows (``engine.cli.build_trainer``), or it takes its
    ``multihost.local_batch_slice`` of a global batch."""
    return {k: torch.as_tensor(v).to(mesh.device, non_blocking=True) for k, v in tree.items()}


@torch.no_grad()
def replicate(mesh: Mesh, tree):
    """Every tensor leaf of ``tree`` set, in place, to rank 0's value: one
    broadcast per dtype. The initialisations are seeded, so this changes
    nothing in a fresh run; it guarantees that every rank starts from one
    state. Returns ``tree``."""
    if mesh.group is None:
        return tree
    for leaves in _by_dtype(_leaves(tree)).values():
        flat = _broadcast_(mesh, torch.cat([t.reshape(-1) for t in leaves]))
        off = 0
        for t in leaves:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
    return tree


@torch.no_grad()
def all_reduce_grads(mesh: Mesh, params) -> None:
    """Every leaf's ``.grad`` replaced by the mean of the ranks' gradients:
    one flat all-reduce (sum) per dtype, then / world. Every rank runs the
    same graph on rows of one shape, so the leaves with a gradient are the
    same on every rank; leaves without one (None) are left alone."""
    if mesh.group is None:
        return
    leaves = [p for p in _leaves(params) if p.grad is not None]
    for group in _by_dtype(leaves).values():
        flat = _all_reduce_(mesh, torch.cat([p.grad.reshape(-1) for p in group]))
        flat.div_(mesh.world)
        off = 0
        for p in group:
            p.grad = flat[off:off + p.numel()].view_as(p)
            off += p.numel()


@torch.no_grad()
def mean_over_ranks(mesh: Mesh, metrics: dict) -> dict:
    """The step's scalar metrics averaged over the ranks in one all-reduce.
    A '*psnr*' metric is averaged as the MSE it stands for and converted
    back: the global batch's PSNR where it is the PSNR of a mean over equal
    local batches."""
    if mesh.group is None:
        return metrics
    keys = sorted(metrics)
    as_mse = [mesh.world > 1 and "psnr" in k for k in keys]
    vals = [metrics[k].detach().float().reshape(()) for k in keys]
    vals = torch.stack([10.0 ** (-v / 10.0) if m else v for v, m in zip(vals, as_mse)])
    vals = _all_reduce_(mesh, vals) / mesh.world
    return {k: -10.0 * torch.log10(v) if m else v
            for k, v, m in zip(keys, vals.unbind(), as_mse)}


# ------------------------------------------------------------ global batch
_STEP_MESH: contextvars.ContextVar[Optional[Mesh]] = contextvars.ContextVar(
    "nkt_step_mesh", default=None)


@contextlib.contextmanager
def global_batch(mesh: Mesh):
    """Within the block, ``batch_sum`` and ``global_rows`` refer to the
    global batch that ``mesh``'s ranks hold (the training step's forward and
    loss). Outside it they see one local batch."""
    token = _STEP_MESH.set(mesh if mesh.group is not None else None)
    try:
        yield
    finally:
        _STEP_MESH.reset(token)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_reduce_(mesh, x.clone())

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(ctx.mesh, g.clone()), None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` (per-rank partial sums) summed over the ranks of the step's
    global batch, differentiably; ``x`` itself outside ``global_batch``."""
    mesh = _STEP_MESH.get()
    return x if mesh is None else _AllReduceSum.apply(x, mesh)


def global_rows(n: int) -> tuple[int, int]:
    """(the first row of the step's global batch that this rank's ``n`` rows
    hold, the global batch's rows); (0, n) outside ``global_batch``."""
    mesh = _STEP_MESH.get()
    return (0, n) if mesh is None else (mesh.rank * n, mesh.world * n)


__all__ = ["DATA_AXIS", "Mesh", "all_reduce_grads", "batch_sum", "global_batch",
           "global_rows", "make_mesh", "mean_over_ranks", "replicate", "shard_batch"]
