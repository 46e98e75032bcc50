"""Fixed-order segment sums: the backward of the training step's index
selections without float atomics.

``segment_sum(values, idx, num_targets)`` gives ``out[r, e]``, the sum of
``values[r, q]`` over the q with ``idx[r, q] == e``, in one fixed order.
Two regimes (``csrc/segment_sum.cu`` writes both orders out):

- short rows, each with its own non-decreasing index row (the interlevel
  bounds, the pdf sampler's brackets and running maximum): in ascending q,
  as the JAX package's ``jnp.sum`` over its one-hot query axis does
  (``nerf_kbs_tpu/ops/losses.py`` ``_outer_cw_bwd``,
  ``nerf_kbs_tpu/ops/samplers.py`` ``_bracket_bwd``), within pieces of 256
  entries, the pieces' sums in ascending order; a run inside one piece gets
  the bits of the serial sum;
- one long sorted index row that every value row shares
  (``segment_sum_by_key``: tiles of 1,024 sorted entries reduced by a warp
  scan, runs that cross tiles finished by a second pass in tile order).

``gather_columns`` and ``gather_column_sets`` gather table columns; their
backward sorts the column indices (``sort_keys``: a stable LSD radix sort
over only the key bits the span needs) and sums each column's cotangents
with ``segment_sum_by_key``, read through the sort's permutation. The hash
table's levels go through one ``gather_column_sets`` call a field, which
writes each level's span of one gradient tensor once. The same inputs give
the same bits on every launch, so a training step repeats bit for bit on one
card.

A wrapper given CUDA tensors launches its kernel or raises; given CPU
tensors it runs the plain version (``torch.sort(stable=True)``,
``scatter_add_``, which the CPU runs serially). ``LAUNCHES`` counts kernel
launches by wrapper, under a lock (a live viewer's thread shares the module
with the trainer's). A launching wrapper's call is the span
``segment_sum`` (``utils/profiling.py``).
"""

from __future__ import annotations

import threading

import torch

from nerf_kbs_tpu_torch.ops import _kernels
from nerf_kbs_tpu_torch.utils.profiling import spanned

LAUNCHES = {"segment_sum": 0, "segment_sum_by_key": 0, "radix_sort": 0}
_lock = threading.Lock()
_DTYPES = {torch.float32: 0, torch.float64: 1}
# csrc/segment_sum.cu: sorted entries a block of the by-key sum, keys a block
# of the sort, and the sort's widest digit
BY_KEY_TILE = 1024
SORT_TILE = 4096
SORT_DIGIT_BITS = 9


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(name: str) -> None:
    with _lock:
        LAUNCHES[name] += 1


def _devices(*tensors) -> str:
    devs = {t.device.type for t in tensors}
    if devs == {"cpu"}:
        return "cpu"
    if devs != {"cuda"}:
        raise ValueError(f"segment_sum: inputs must all be on the CPU or all on CUDA, got {devs}")
    return "cuda"


def _aligned_int32(t: torch.Tensor) -> torch.Tensor:
    """t as contiguous int32 whose start the kernels may read 16 bytes at a time."""
    t = t.to(torch.int32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def segment_sum_reference(values: torch.Tensor, idx: torch.Tensor,
                          num_targets: int) -> torch.Tensor:
    """The plain version: ``scatter_add_`` into zeros (serial in ascending q on
    the CPU; the kernel's order wherever no run crosses a 256-entry piece of
    an index row of its own)."""
    out = values.new_zeros(values.shape[0], num_targets)
    return out.scatter_add_(1, idx.long().expand(values.shape), values)


@spanned("segment_sum")
def segment_sum(values: torch.Tensor, idx: torch.Tensor, num_targets: int) -> torch.Tensor:
    """values (R, Q) f32 or f64, idx (R, Q) or (1, Q) integer, non-decreasing
    along each row, in [0, num_targets) -> (R, num_targets) of the values'
    dtype. An index row a value row: the short-row kernel; one index row
    that R > 1 value rows share: ``segment_sum_by_key``."""
    if values.dim() != 2 or idx.dim() != 2 or idx.shape[1] != values.shape[1] \
            or idx.shape[0] not in (1, values.shape[0]):
        raise ValueError(f"segment_sum: values {tuple(values.shape)}, idx {tuple(idx.shape)}")
    if _devices(values, idx) == "cpu":
        return segment_sum_reference(values, idx, num_targets)
    if values.dtype not in _DTYPES:
        raise ValueError(f"segment_sum: values must be float32 or float64, got {values.dtype}")
    R, Q = values.shape
    if max(R, Q, num_targets) >= 2**31:
        raise ValueError(f"segment_sum: {R} x {Q} into {num_targets}: 32-bit indices")
    if idx.shape[0] != R:
        out = values.new_empty(R, num_targets)
        _segment_sum_by_key(values, idx[0], None, out)
        return out
    v = values.contiguous()
    i = idx.to(torch.int32).contiguous()
    out = torch.empty(R, num_targets, device=v.device, dtype=v.dtype)
    pieces = torch.empty_like(v)  # each piece's sum, at its last entry
    _kernels.call("segment_sum", v.data_ptr(), i.data_ptr(), R, Q, num_targets,
                  pieces.data_ptr(), out.data_ptr(), _DTYPES[v.dtype],
                  torch.cuda.current_stream(v.device).cuda_stream)
    _count("segment_sum")
    return out


def segment_sum_by_key_reference(values: torch.Tensor, keys: torch.Tensor,
                                 perm: torch.Tensor | None, out: torch.Tensor,
                                 own: int | None = None) -> torch.Tensor:
    """The plain version of ``segment_sum_by_key``: the values gathered into
    sorted order, ``scatter_add_`` into zeros (serial in ascending sorted
    position on the CPU), then the span's two parts into ``out``."""
    F, span = out.shape
    own = span if own is None else own
    k = keys.long()
    inside = (k >= 0) & (k < span)
    v = values if perm is None else values.index_select(1, perm)
    sums = values.new_zeros(F, span).scatter_add_(
        1, torch.where(inside, k, 0).expand(F, k.shape[0]), torch.where(inside, v, 0))
    out[:, :own] = sums[:, :own]
    out[:, own:] += sums[:, own:]
    return out


def _segment_sum_by_key(values: torch.Tensor, keys: torch.Tensor, perm: torch.Tensor | None,
                        out: torch.Tensor, own: int | None = None) -> torch.Tensor:
    """``out[f, e] = sum over k with keys[k] == e of values[f, perm[k]]``:
    values (F, W) f32 or f64 of any strides (two interleaved rows, the
    transpose of a contiguous (W, 2), are read a pair a load), keys (M,)
    integer, non-decreasing, perm (M,) integer indices into W (None: the
    identity, M == W), out (F, span) of the values' dtype, rows may be
    strided (a column span of a larger tensor). Targets [0, own) (own: all
    by default) are overwritten, a
    target no key names with 0.0; targets [own, span) get the sums added to
    what they hold. Keys outside [0, span) are not summed. Returns out."""
    F, span = out.shape
    own = span if own is None else own
    M = keys.shape[0]
    if values.dim() != 2 or values.shape[0] != F or keys.dim() != 1 or not 0 <= own <= span \
            or (perm is None and values.shape[1] != M) \
            or (perm is not None and perm.shape != keys.shape):
        raise ValueError(f"segment_sum_by_key: values {tuple(values.shape)}, keys "
                         f"{tuple(keys.shape)}, perm {None if perm is None else tuple(perm.shape)}"
                         f", out {tuple(out.shape)}, own {own}")
    if out.dtype != values.dtype:
        raise ValueError(f"segment_sum_by_key: out {out.dtype}, values {values.dtype}")
    rest = () if perm is None else (perm,)
    if _devices(values, keys, out, *rest) == "cpu":
        return segment_sum_by_key_reference(values, keys, perm, out, own)
    if values.dtype not in _DTYPES:
        raise ValueError(f"segment_sum_by_key: values must be float32 or float64, "
                         f"got {values.dtype}")
    if max(M, values.shape[1], span) >= 2**31 or out.stride(1) != 1:
        raise ValueError(f"segment_sum_by_key: {M} keys into {span}, out strides {out.stride()}")
    g = values if min(values.stride()) >= 1 else values.contiguous()
    k = _aligned_int32(keys)
    p = None if perm is None else _aligned_int32(perm)
    ntiles = max(-(-M // BY_KEY_TILE), 1)
    partials = torch.empty(2 * F * ntiles, device=g.device, dtype=g.dtype)
    _kernels.call("segment_sum_by_key", g.data_ptr(), g.stride(0), g.stride(1), k.data_ptr(),
                  None if p is None else p.data_ptr(), M, F, out.data_ptr(), out.stride(0),
                  own, span, partials.data_ptr(), partials.numel(), _DTYPES[g.dtype],
                  torch.cuda.current_stream(g.device).cuda_stream)
    _count("segment_sum_by_key")
    return out


segment_sum_by_key = spanned("segment_sum")(_segment_sum_by_key)


@spanned("segment_sum")
def sort_keys(keys: torch.Tensor, span: int) -> tuple[torch.Tensor, torch.Tensor]:
    """keys (M,) integer in [0, span) -> (the keys ascending, the positions
    that sort them), both int32, ties in ascending position:
    ``torch.sort(stable=True)``. On the card a radix sort over the
    ceil(log2 span) bits the keys can have."""
    if keys.dim() != 1 or span < 1:
        raise ValueError(f"sort_keys: keys {tuple(keys.shape)}, span {span}")
    if _devices(keys) == "cpu":
        s, order = torch.sort(keys.to(torch.int32), stable=True)
        return s, order.to(torch.int32)
    M = keys.shape[0]
    if M >= 2**31 or span > 2**31:
        raise ValueError(f"sort_keys: {M} keys in [0, {span}): 32-bit indices")
    bits = max(1, (span - 1).bit_length())
    passes = -(-bits // SORT_DIGIT_BITS)
    radix = 1 << -(-bits // passes)
    k = _aligned_int32(keys)
    # keys, perm, two scratch, each row starting on 16 bytes
    out = torch.empty(4, -(-M // 4) * 4, device=k.device, dtype=torch.int32)[:, :M]
    counts = torch.empty(radix * (-(-M // SORT_TILE) + 1), device=k.device, dtype=torch.int32)
    _kernels.call("radix_sort", k.data_ptr(), M, bits, out[0].data_ptr(), out[1].data_ptr(),
                  out[2].data_ptr(), out[3].data_ptr(), counts.data_ptr(), counts.numel(),
                  torch.cuda.current_stream(k.device).cuda_stream)
    _count("radix_sort")
    return out[0], out[1]


class _GatherColumnSets(torch.autograd.Function):
    """rows (F, W) gathered at L sets of column indices -> L tensors (F, M_l),
    or (M_l, F) when ``entry_major`` (gathered from a transposed copy of
    rows: an entry's F values in one place, for the gather and for the
    backward's reads). Set l is ``(lo, own, span)`` and its indices
    ``slots_l`` (M_l,) lie in [0, span), column lo + slot; the owned spans
    [lo, lo + own) tile the row. The backward gives d_rows (F, W) with each
    set's owned columns written once (its sums, 0.0 where no index names
    one) and its columns [lo + own, lo + span) added to what the sets of
    higher lo wrote there: the sets are visited from the highest lo down,
    each a stable sort of its slots (integer work, the same permutation
    every time) and ``segment_sum_by_key`` of its cotangents read through
    the permutation."""

    @staticmethod
    def forward(ctx, rows, sets, entry_major, *slots):
        owned = sorted((lo, lo + own) for lo, own, _ in sets)
        if [a for a, _ in owned] != [0] + [b for _, b in owned[:-1]] \
                or owned[-1][1] != rows.shape[1] or any(span < own for _, own, span in sets):
            raise ValueError(f"gather_column_sets: sets {sets} do not tile {rows.shape[1]} columns")
        ctx.save_for_backward(*slots)
        ctx.sets, ctx.width, ctx.entry_major = sets, rows.shape[1], entry_major
        if entry_major:
            table = rows.t().contiguous()
            return tuple(table.narrow(0, lo, span).index_select(0, s)
                         for (lo, _, span), s in zip(sets, slots))
        return tuple(rows.narrow(1, lo, span).index_select(1, s)
                     for (lo, _, span), s in zip(sets, slots))

    @staticmethod
    def backward(ctx, *grads):
        slots = ctx.saved_tensors
        order = sorted(range(len(slots)), key=lambda i: -ctx.sets[i][0])
        if ctx.entry_major:
            grads = [None if g is None else g.t() for g in grads]
        g0 = next(g for g in grads if g is not None)
        d_rows = g0.new_empty(g0.shape[0], ctx.width)
        for i in order:
            lo, own, span = ctx.sets[i]
            out = d_rows.narrow(1, lo, span)
            if grads[i] is None:
                out[:, :own] = 0.0
                continue
            keys, perm = sort_keys(slots[i], span)
            segment_sum_by_key(grads[i], keys, perm, out, own)
        return (d_rows, None, None, *[None] * len(slots))


def gather_column_sets(rows: torch.Tensor, sets, slots, entry_major: bool = False) -> tuple:
    """``rows.narrow(1, lo, span).index_select(1, slots_l)`` for each set
    ``(lo, own, span)`` of ``sets`` and its slots (M_l,) integer in [0,
    span), transposed to (M_l, F) when ``entry_major``, whose gradient sums
    into each column in a fixed order (see ``_GatherColumnSets``): the hash
    table's levels, one call a field."""
    return _GatherColumnSets.apply(rows, tuple(tuple(s) for s in sets), entry_major, *slots)


def gather_columns(rows: torch.Tensor, flat_idx: torch.Tensor) -> torch.Tensor:
    """``rows.index_select(1, flat_idx)`` whose gradient sums into each column
    in a fixed order; ``flat_idx`` (M,) integer."""
    (out,) = gather_column_sets(rows, [(0, rows.shape[1], rows.shape[1])], [flat_idx])
    return out
