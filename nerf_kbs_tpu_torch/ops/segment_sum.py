"""Fixed-order segment sums: the backward of the training step's index
selections without float atomics.

``segment_sum(values, idx, num_targets)`` gives ``out[r, e]``, the sum of
``values[r, q]`` over the q with ``idx[r, q] == e``, in one fixed order: the
kernel adds in ascending q, as the JAX package's ``jnp.sum`` over its one-hot
query axis does (``nerf_kbs_tpu/ops/losses.py`` ``_outer_cw_bwd``,
``nerf_kbs_tpu/ops/samplers.py`` ``_bracket_bwd``), within pieces of 256
entries of a row, and the pieces' sums in ascending order; a run inside one
piece gets the bits of the serial sum. ``idx`` rows are non-decreasing; a
single index row may be shared by every value row. The same inputs give the
same bits on every launch, so a training step repeats bit for bit on one
card.

``gather_columns`` is a gather of table columns whose backward sums each
column's cotangents this way (the hash table's levels, the preprocessing
warp's bilinear taps).

A wrapper given CUDA tensors launches ``csrc/segment_sum.cu`` or raises;
given CPU tensors it runs the plain version, ``scatter_add_``, which the CPU
runs serially. ``LAUNCHES`` counts kernel launches, under a lock (a live
viewer's thread shares the module with the trainer's).
"""

from __future__ import annotations

import threading

import torch

from nerf_kbs_tpu_torch.ops import _kernels

LAUNCHES = {"segment_sum": 0}
_lock = threading.Lock()
_DTYPES = {torch.float32: 0, torch.float64: 1}


def reset_launches() -> None:
    with _lock:
        LAUNCHES["segment_sum"] = 0


def segment_sum_reference(values: torch.Tensor, idx: torch.Tensor,
                          num_targets: int) -> torch.Tensor:
    """The plain version: ``scatter_add_`` into zeros (serial in ascending q on
    the CPU; the kernel's order wherever no run crosses a 256-entry piece)."""
    out = values.new_zeros(values.shape[0], num_targets)
    return out.scatter_add_(1, idx.long().expand(values.shape), values)


def segment_sum(values: torch.Tensor, idx: torch.Tensor, num_targets: int) -> torch.Tensor:
    """values (R, Q) f32 or f64, idx (R, Q) or (1, Q) integer, non-decreasing
    along each row, in [0, num_targets) -> (R, num_targets) of the values'
    dtype."""
    if values.dim() != 2 or idx.dim() != 2 or idx.shape[1] != values.shape[1] \
            or idx.shape[0] not in (1, values.shape[0]):
        raise ValueError(f"segment_sum: values {tuple(values.shape)}, idx {tuple(idx.shape)}")
    devs = {values.device.type, idx.device.type}
    if devs == {"cpu"}:
        return segment_sum_reference(values, idx, num_targets)
    if devs != {"cuda"}:
        raise ValueError(f"segment_sum: inputs must all be on the CPU or all on CUDA, got {devs}")
    if values.dtype not in _DTYPES:
        raise ValueError(f"segment_sum: values must be float32 or float64, got {values.dtype}")
    R, Q = values.shape
    if max(R, Q, num_targets) >= 2**31:
        raise ValueError(f"segment_sum: {R} x {Q} into {num_targets}: 32-bit indices")
    v = values.contiguous()
    i = idx.to(torch.int32).contiguous()
    out = torch.empty(R, num_targets, device=v.device, dtype=v.dtype)
    pieces = torch.empty_like(v)  # each piece's sum, at its last entry
    _kernels.call("segment_sum", v.data_ptr(), i.data_ptr(), R, Q, i.shape[0], num_targets,
                  pieces.data_ptr(), out.data_ptr(), _DTYPES[v.dtype],
                  torch.cuda.current_stream(v.device).cuda_stream)
    with _lock:
        LAUNCHES["segment_sum"] += 1
    return out


class _GatherColumns(torch.autograd.Function):
    """rows (F, W) at flat column indices (M,) -> (F, M), the indices lying in
    [lo, lo + span). The backward adds each column's cotangents in ascending
    entry order, with no atomics: one stable sort of the indices (integer
    work, the same permutation every time), the cotangents gathered into
    that order, then ``segment_sum`` of the F rows over the one sorted index
    row."""

    @staticmethod
    def forward(ctx, rows, flat_idx, lo: int, span: int):
        ctx.save_for_backward(flat_idx)
        ctx.lo, ctx.span, ctx.width = lo, span, rows.shape[1]
        return rows.index_select(1, flat_idx)

    @staticmethod
    def backward(ctx, g):
        (flat_idx,) = ctx.saved_tensors
        slots, order = torch.sort((flat_idx - ctx.lo).to(torch.int32), stable=True)
        d_rows = g.new_zeros(g.shape[0], ctx.width)
        d_rows[:, ctx.lo:ctx.lo + ctx.span] = segment_sum(g.index_select(1, order), slots[None],
                                                          ctx.span)
        return d_rows, None, None, None


def gather_columns(rows: torch.Tensor, flat_idx: torch.Tensor, lo: int = 0,
                   span: int | None = None) -> torch.Tensor:
    """``rows.index_select(1, flat_idx)`` whose gradient sums into each column
    in a fixed order; ``flat_idx`` (M,) int64 in [lo, lo + span) (span: all
    columns from lo by default)."""
    return _GatherColumns.apply(rows, flat_idx, lo, rows.shape[1] - lo if span is None else span)
