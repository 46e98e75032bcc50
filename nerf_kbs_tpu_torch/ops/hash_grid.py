"""The multiresolution hash grid as one hand-written operation a field: the
wrappers of ``csrc/hash_grid.cu``'s two kernels, the autograd Function that
joins them with the fixed-order table gradient, and their plain versions.

Layouts (``csrc/hash_grid.cu`` has the arithmetic):
- the table parameter is flat and feature-major, entry (f, level, slot) at
  ``f * L * T + level * T + slot``, as the JAX package's; the kernels read
  its entry-major copy (L * T, F), made once a call;
- a corner's key is its global column ``level * T + slot``; the keys of a
  call are (L, N, 8) int32, level-major, corner c of a cell at offset
  ``(c & 1, (c >> 1) & 1, (c >> 2) & 1)``;
- the backward's entry cotangents ``g[n, l, f] * w[n, l, c]`` are
  (L, N, 8, F), in the keys' order.

The table's gradient is one ``sort_keys`` of the call's keys (a stable
radix sort over the ceil(log2(L * T)) bits they can have) and one
``segment_sum_by_key`` of the entry cotangents, read through the sort's
permutation, into the whole (F, L * T) gradient: every column owned, so a
dense level's far-face corners (weight 0) that reach into the next level's
slots add into that run. A fixed order, no atomics: a step repeats bit for
bit. The backward is once differentiable; a caller that differentiates the
encoding twice (``models.fields._normals``) calls
``ops.encoding.hash_encoding_plain``.

A wrapper given CUDA tensors launches its kernel or raises; given CPU tensors
it runs the plain version, which repeats the kernel's arithmetic and order.
``LAUNCHES`` counts launches: ``hash_grid_fwd``, ``hash_grid_bwd`` and, of
the backward launches, those that ran the positions' gradient
(``hash_grid_bwd_dx``), under a lock (a live viewer's thread renders through
the same wrappers). A launching wrapper's call is the span ``hash_grid``
(``utils/profiling.py``); the sort and the sum are ``segment_sum``'s.
"""

from __future__ import annotations

import threading

import torch
from torch.autograd.function import once_differentiable

from nerf_kbs_tpu_torch.ops import _kernels
from nerf_kbs_tpu_torch.ops.segment_sum import segment_sum_by_key, sort_keys
from nerf_kbs_tpu_torch.utils.profiling import spanned

LAUNCHES = {"hash_grid_fwd": 0, "hash_grid_bwd": 0, "hash_grid_bwd_dx": 0}
_lock = threading.Lock()
# what the kernels take: features a level (a template each), levels
FEATURES = (1, 2, 4, 8)
MAX_LEVELS = 32
_PRIMES = (1, 2654435761, 805459861)


def reset_launches() -> None:
    with _lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _count(*names: str) -> None:
    with _lock:
        for name in names:
            LAUNCHES[name] += 1


def _on_cpu(*tensors) -> bool:
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"hash_grid: inputs must all be on the CPU or all on CUDA, got {devs}")


def levels(config) -> tuple[list, list]:
    """(resolution, dense) of each level: dense where the level's
    (res + 1)^3 corners fit its T slots."""
    T = config.table_size
    res = list(config.resolutions)
    return res, [(r + 1) ** 3 <= T for r in res]


def entry_major(table: torch.Tensor, config) -> torch.Tensor:
    """The flat feature-major table (F * L * T,) as (L * T, F), contiguous."""
    F = config.features_per_level
    return table.detach().view(F, -1).t().contiguous()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous f32 whose start the kernels may read 16 bytes at a time."""
    t = t.float().contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# ---------------------------------------------------------------------------
# the plain versions: the kernels' arithmetic, each product and add rounded
# on its own, in the kernels' order
# ---------------------------------------------------------------------------

_BITS = torch.tensor([[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)])


def corners_reference(p: torch.Tensor, level: int, res: int, dense: bool, config):
    """Clamped points p (N, 3) f32 at one level: the corners' keys (N, 8)
    int64, their weights (N, 8) f32 and the axis weights, per axis (N, 2)
    (1 - frac, frac)."""
    L, T = config.num_levels, config.table_size
    ps = p * float(res)
    fl = torch.floor(ps)
    frac = ps - fl
    c = fl.to(torch.int64)
    axis = [torch.stack([1.0 - frac[:, d], frac[:, d]], dim=-1) for d in range(3)]
    b = _BITS.to(p.device)
    x, y, z = (c[:, d:d + 1] + b[:, d] for d in range(3))
    if dense:
        r1 = res + 1
        keys = (level * T + x + r1 * (y + r1 * z)).clamp_max(L * T - 1)
    else:
        keys = level * T + (((x * _PRIMES[0]) ^ (y * _PRIMES[1]) ^ (z * _PRIMES[2])) & (T - 1))
    w = axis[0][:, b[:, 0]] * axis[1][:, b[:, 1]] * axis[2][:, b[:, 2]]
    return keys, w, axis


def hash_grid_fwd_reference(entries: torch.Tensor, positions: torch.Tensor, config,
                            need_keys: bool):
    """The forward kernel's plain version: (enc (N, L * F), keys (L, N, 8)
    int32 or None)."""
    p = positions.clamp(0.0, 1.0)
    feats, keys = [], []
    for lvl, (res, dense) in enumerate(zip(*levels(config))):
        k, w, _ = corners_reference(p, lvl, res, dense, config)
        t = entries[k]  # (N, 8, F)
        acc = t[:, 0] * w[:, 0:1]
        for c in range(1, 8):
            acc = acc + t[:, c] * w[:, c:c + 1]
        feats.append(acc)
        keys.append(k.to(torch.int32))
    enc = torch.cat(feats, dim=-1)
    return enc, (torch.stack(keys) if need_keys else None)


def _clamp_grad_factor(x: torch.Tensor) -> torch.Tensor:
    """The clamp's gradient factor: 1 inside (0, 1), 0.5 at exactly 0 or 1
    (jnp.clip's maximum or minimum splits it there), 0 outside."""
    inside = (x > 0.0) & (x < 1.0)
    face = (x == 0.0) | (x == 1.0)
    return torch.where(inside, 1.0, torch.where(face, 0.5, 0.0))


def hash_grid_bwd_reference(entries, positions: torch.Tensor, grad: torch.Tensor, config,
                            need_vals: bool, need_dx: bool):
    """The backward kernel's plain version: (vals (L, N, 8, F) or None,
    d positions (N, 3) or None)."""
    F = config.features_per_level
    p = positions.clamp(0.0, 1.0)
    g_all = grad.reshape(p.shape[0], -1, F)
    vals, dp = [], torch.zeros_like(p)
    for lvl, (res, dense) in enumerate(zip(*levels(config))):
        k, w, axis = corners_reference(p, lvl, res, dense, config)
        g = g_all[:, lvl]  # (N, F)
        if need_vals:
            vals.append(g[:, None, :] * w[:, :, None])
        if not need_dx:
            continue
        t = entries[k]  # (N, 8, F)
        df = [torch.zeros_like(p[:, 0]) for _ in range(3)]
        for c in range(8):
            s = g[:, 0] * t[:, c, 0]
            for f in range(1, F):
                s = s + g[:, f] * t[:, c, f]
            bits = [c & 1, (c >> 1) & 1, (c >> 2) & 1]
            for d in range(3):
                e0, e1 = [e for e in range(3) if e != d]
                term = s * (axis[e0][:, bits[e0]] * axis[e1][:, bits[e1]])
                df[d] = df[d] + term if bits[d] else df[d] - term
        dp = dp + torch.stack(df, dim=-1) * float(res)
    dpos = None
    if need_dx:
        dpos = torch.where(_clamp_grad_factor(positions) == 0.0, 0.0,
                           dp * _clamp_grad_factor(positions))
    return (torch.stack(vals) if need_vals else None), dpos


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def _check(entries: torch.Tensor, positions: torch.Tensor, config) -> tuple:
    L, F, T = config.num_levels, config.features_per_level, config.table_size
    if F not in FEATURES or not 1 <= L <= MAX_LEVELS or T & (T - 1) or L * T >= 2**31:
        raise ValueError(f"hash_grid: {L} levels of {F} features, T = {T}: the kernels take "
                         f"features {FEATURES}, 1 to {MAX_LEVELS} levels, T a power of two, "
                         f"L * T < 2^31")
    if entries is not None and (entries.dtype != torch.float32
                                or tuple(entries.shape) != (L * T, F)):
        raise ValueError(f"hash_grid: entries {entries.dtype} {tuple(entries.shape)}, "
                         f"want float32 {(L * T, F)}")
    if positions.dim() != 2 or positions.shape[1] != 3 or positions.dtype != torch.float32:
        raise ValueError(f"hash_grid: positions {positions.dtype} {tuple(positions.shape)}, "
                         f"want float32 (N, 3)")
    res, dense = levels(config)
    return _kernels.int_array(res), _kernels.int_array(dense), T.bit_length() - 1


def _check_keys(n: int, config) -> None:
    if 8 * n * config.num_levels >= 2**31:
        raise ValueError(f"hash_grid: {n} points x {config.num_levels} levels x 8 corners: "
                         f"the sort and the by-key sum take fewer than 2^31 keys")


@spanned("hash_grid")
def hash_grid_fwd(table: torch.Tensor, positions: torch.Tensor, config, need_keys: bool):
    """The flat table (F * L * T,), positions (N, 3) f32 -> (the encoding
    (N, L * F) f32, the corners' keys (L, N, 8) int32 when ``need_keys``,
    else None, the entry-major table the kernel read)."""
    entries = entry_major(table, config)
    if _on_cpu(entries, positions):
        return (*hash_grid_fwd_reference(entries, positions, config, need_keys), entries)
    res, dense, log2_t = _check(entries, positions, config)
    L, F = config.num_levels, config.features_per_level
    n = positions.shape[0]
    if need_keys:
        _check_keys(n, config)
    pos = positions.contiguous()
    enc = torch.empty(n, L * F, device=pos.device, dtype=torch.float32)
    keys = torch.empty(L, n, 8, device=pos.device, dtype=torch.int32) if need_keys else None
    _kernels.call("hash_grid_fwd", entries.data_ptr(), pos.data_ptr(), n, L, F, log2_t, res,
                  dense, enc.data_ptr(), keys.data_ptr() if need_keys else None,
                  torch.cuda.current_stream(pos.device).cuda_stream)
    _count("hash_grid_fwd")
    return enc, keys, entries


@spanned("hash_grid")
def hash_grid_bwd(entries, positions: torch.Tensor, grad: torch.Tensor, config,
                  need_vals: bool, need_dx: bool):
    """The encoding's cotangent grad (N, L * F) -> (the entries' cotangents
    (L, N, 8, F) f32 when ``need_vals``, the positions' gradient (N, 3) f32
    when ``need_dx``; None for the other). ``entries`` as the forward's;
    only the positions' gradient reads it (None will do without ``need_dx``)."""
    if not (need_vals or need_dx) or (need_dx and entries is None):
        raise ValueError(f"hash_grid_bwd: need_vals {need_vals}, need_dx {need_dx}, entries "
                         f"{None if entries is None else tuple(entries.shape)}")
    if _on_cpu(entries, positions, grad):
        return hash_grid_bwd_reference(entries, positions, grad, config, need_vals, need_dx)
    res, dense, log2_t = _check(entries, positions, config)
    L, F = config.num_levels, config.features_per_level
    n = positions.shape[0]
    if tuple(grad.shape) != (n, L * F):
        raise ValueError(f"hash_grid_bwd: grad {tuple(grad.shape)}, want {(n, L * F)}")
    if need_vals:
        _check_keys(n, config)
    pos, g = positions.contiguous(), _aligned(grad)
    vals = torch.empty(L, n, 8, F, device=pos.device) if need_vals else None
    dpos = torch.empty(n, 3, device=pos.device) if need_dx else None
    _kernels.call("hash_grid_bwd", entries.data_ptr() if need_dx else None, pos.data_ptr(),
                  g.data_ptr(), n, L, F, log2_t, res, dense,
                  vals.data_ptr() if need_vals else None, dpos.data_ptr() if need_dx else None,
                  torch.cuda.current_stream(pos.device).cuda_stream)
    _count("hash_grid_bwd", *["hash_grid_bwd_dx"] * need_dx)
    return vals, dpos


def table_gradient(keys: torch.Tensor, vals: torch.Tensor, config) -> torch.Tensor:
    """The flat table's gradient (F * L * T,) from a call's keys (L, N, 8)
    and entry cotangents (L, N, 8, F): one stable sort of the keys, one
    by-key sum into every column (0.0 where no key names one)."""
    F, width = config.features_per_level, config.num_levels * config.table_size
    sorted_keys, perm = sort_keys(keys.reshape(-1), width)
    d_rows = vals.new_empty(F, width)
    # (F, M): two features interleaved, read a pair a load
    segment_sum_by_key(vals.reshape(-1, F).t(), sorted_keys, perm, d_rows)
    return d_rows.view(-1)


class _HashGrid(torch.autograd.Function):
    """table (F * L * T,), positions (N, 3) f32 -> the encoding (N, L * F).
    The forward saves the keys when the table needs a gradient and the
    entry-major table when the positions do."""

    @staticmethod
    def forward(ctx, table, positions, config, need_table, need_dx):
        enc, keys, entries = hash_grid_fwd(table, positions, config, need_table)
        ctx.config = config
        ctx.save_for_backward(entries if need_dx else None, positions, keys)
        return enc

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        entries, positions, keys = ctx.saved_tensors
        need_table, need_dx = ctx.needs_input_grad[:2]
        if not (need_table or need_dx):
            return None, None, None, None, None
        vals, dpos = hash_grid_bwd(entries, positions, grad, ctx.config, need_table, need_dx)
        d_table = table_gradient(keys, vals, ctx.config) if need_table else None
        return d_table, dpos, None, None, None


def hash_grid(table: torch.Tensor, positions: torch.Tensor, config) -> torch.Tensor:
    """Encode positions (..., 3) -> (..., L * F), level-major, through the
    kernels (CUDA tensors) or their plain versions (CPU tensors). Positions
    are clamped into [0, 1] (an outside point reads its edge cell and passes
    no gradient). The table is the flat feature-major parameter."""
    batch_shape = positions.shape[:-1]
    p = positions.reshape(-1, 3).float()
    grad_on = torch.is_grad_enabled()
    need_table = grad_on and table.requires_grad
    need_dx = grad_on and p.requires_grad
    enc = _HashGrid.apply(table, p, config, need_table, need_dx)
    return enc.reshape(*batch_shape, config.output_dim)
