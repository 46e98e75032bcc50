"""The hash grid's kernel wrappers (``nerf_kbs_tpu_torch/ops/hash_grid.py``)
on the CPU: the global key layout, the wrappers' argument checks, and the
autograd Function's CPU path (the kernels' plain versions, the sort and the
by-key sum) against the plain encoding, ``hash_encoding_plain``. The kernels
themselves are held to these on the card (``tests/test_torch_cuda_kernels.py``).
About 10 s."""

import numpy as np
import pytest
import torch

from nerf_kbs_tpu_torch.ops import hash_grid as hg
from nerf_kbs_tpu_torch.ops import segment_sum as seg
from nerf_kbs_tpu_torch.ops.encoding import (
    HashEncodingConfig,
    _level_corners,
    hash_encoding_apply,
    hash_encoding_plain,
)

CONFIGS = {
    # dense 2 and 3 (the second's far face spills into level 2's slots),
    # hashed 5 and 7 in 64 slots
    "f2_spill_and_collide": dict(num_levels=4, features_per_level=2, log2_hashmap_size=6,
                                 base_resolution=2, max_resolution=8),
    # the last level dense, its far face past the table's end (clamped)
    "f1_dense_past_the_table": dict(num_levels=2, features_per_level=1, log2_hashmap_size=10,
                                    base_resolution=4, max_resolution=9),
    "f4_spill_and_collide": dict(num_levels=4, features_per_level=4, log2_hashmap_size=6,
                                 base_resolution=2, max_resolution=8),
    "f3_three_levels": dict(num_levels=3, features_per_level=3, log2_hashmap_size=8,
                            base_resolution=3, max_resolution=20),
}


def _inputs(kw, n=600, seed=0):
    """(config, table, positions): inside, exactly on faces, on the cube's
    corners and outside."""
    cfg = HashEncodingConfig(**kw)
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    k = n // 10
    pts[:k, 0], pts[k:2 * k, 1], pts[2 * k:3 * k, 2] = 1.0, 0.0, rng.integers(0, 2, k)
    pts[3 * k:3 * k + 8] = [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)]
    pts[4 * k:5 * k] = rng.uniform(-0.5, 1.5, (k, 3))
    size = cfg.features_per_level * cfg.num_levels * cfg.table_size
    table = torch.tensor(rng.uniform(-1, 1, size), dtype=torch.float32)
    return cfg, table, torch.tensor(pts, dtype=torch.float32)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_keys_are_each_levels_slots_past_its_start(case):
    """Key (l, n, c) is level l's corner-c slot of point n (the plain
    encoding's index, dense or hashed) plus l * T, a dense far face clamped
    to the table's last column; the keys are level-major, the corners in
    the plain encoding's order."""
    cfg, table, pts = _inputs(CONFIGS[case])
    L, T = cfg.num_levels, cfg.table_size
    _, keys, entries = hg.hash_grid_fwd(table, pts, cfg, True)
    assert keys.dtype == torch.int32 and tuple(keys.shape) == (L, pts.shape[0], 8)
    assert tuple(entries.shape) == (L * T, cfg.features_per_level)
    p = pts.clamp(0, 1)
    for lvl, res in enumerate(cfg.resolutions):
        idx, _ = _level_corners(p, res, T)
        assert torch.equal(keys[lvl].long(), (idx + lvl * T).clamp_max(L * T - 1))
    assert int(keys.min()) >= 0 and int(keys.max()) < L * T


def test_dense_far_faces_reach_the_next_level_and_the_tables_end():
    """The cases above do exercise both: a key past its level's T slots,
    and a clamped one at the table's last column."""
    cfg, table, pts = _inputs(CONFIGS["f2_spill_and_collide"])
    keys = hg.hash_grid_fwd(table, pts, cfg, True)[1].long()
    assert int(keys[1].max()) >= 2 * cfg.table_size  # level 1 into level 2
    cfg, table, pts = _inputs(CONFIGS["f1_dense_past_the_table"])
    keys = hg.hash_grid_fwd(table, pts, cfg, True)[1].long()
    assert int(keys[1].max()) == 2 * cfg.table_size - 1


@pytest.mark.parametrize("case", sorted(CONFIGS))
@pytest.mark.parametrize("need_dx", [False, True])
def test_function_matches_the_plain_encoding(case, need_dx):
    """The Function on the CPU against ``hash_encoding_plain``: the
    encoding (8 products summed in another order: 8 ulps of the largest
    |entry|), the table's gradient (the same products, one sort and one
    by-key sum a field against one a level: equal but for the order of a
    slot's adds, 1e-5 of its sum of |terms|), the positions' gradient (the
    same products summed over levels and corners in another order: 1e-5 of
    the largest), or none where the positions need none."""
    cfg, table, pts = _inputs(CONFIGS[case])
    cot = torch.tensor(np.random.default_rng(1).normal(size=(pts.shape[0], cfg.output_dim)),
                       dtype=torch.float32)

    def grads(encode, c=cot):
        tb, p = table.clone().requires_grad_(), pts.clone().requires_grad_(need_dx)
        out = encode(tb, p, cfg)
        (out * c).sum().backward()
        return out.detach(), tb.grad, p.grad

    got, got_table, got_dx = grads(hg.hash_grid)
    want, want_table, want_dx = grads(hash_encoding_plain)
    _, scale, _ = grads(hash_encoding_plain, cot.abs())
    assert float((got - want).abs().max()) <= 8 * 2.0**-24 * float(table.abs().max())
    assert torch.all((got_table - want_table).abs() <= 1e-5 * scale + 1e-6)
    if need_dx:
        assert float((got_dx - want_dx).abs().max()) <= 1e-5 * float(want_dx.abs().max())
        # no gradient outside the cube; half at an exact face
        outside = (pts < 0) | (pts > 1)
        assert torch.all(got_dx[outside] == 0) and torch.equal(got_dx == 0, want_dx == 0)
    else:
        assert got_dx is None


def test_function_positions_batch_shape_and_a_frozen_table():
    """Positions (..., 3) come back (..., L * F); a table that needs no
    gradient gets none, and the positions' gradient is the same; no grad
    mode keeps no keys."""
    cfg, table, pts = _inputs(CONFIGS["f2_spill_and_collide"], n=300)
    p = pts.reshape(5, 60, 3).clone().requires_grad_()
    out = hg.hash_grid(table, p, cfg)
    assert tuple(out.shape) == (5, 60, cfg.output_dim)
    out.sum().backward()
    p2 = pts.clone().requires_grad_()
    hash_encoding_plain(table, p2, cfg).sum().backward()
    assert table.grad is None
    assert float((p.grad.reshape(-1, 3) - p2.grad).abs().max()) <= \
        1e-5 * float(p2.grad.abs().max())
    with torch.no_grad():
        enc = hg.hash_grid(table.requires_grad_(), pts, cfg)
    assert enc.grad_fn is None


def test_one_sort_and_one_by_key_sum_a_field(monkeypatch):
    """The table's gradient is one sort of the field's 8 N L keys over
    ceil(log2(L T)) bits and one by-key sum of F rows into all L T columns,
    every column owned."""
    calls = []
    sort_keys, by_key = hg.sort_keys, hg.segment_sum_by_key

    def spy_sort(keys, span):
        calls.append(("sort", keys.shape[0], span))
        return sort_keys(keys, span)

    def spy_sum(values, keys, perm, out, own=None):
        calls.append(("sum", tuple(values.shape), tuple(out.shape), own))
        return by_key(values, keys, perm, out, own)

    monkeypatch.setattr(hg, "sort_keys", spy_sort)
    monkeypatch.setattr(hg, "segment_sum_by_key", spy_sum)
    cfg, table, pts = _inputs(CONFIGS["f2_spill_and_collide"], n=500)
    tb = table.clone().requires_grad_()
    hg.hash_grid(tb, pts, cfg).sum().backward()
    M, LT = 8 * 500 * 4, 4 * 64
    assert calls == [("sort", M, LT), ("sum", (2, M), (2, LT), None)]


def test_cpu_dispatch_and_no_launches():
    """On the CPU too ``hash_encoding_apply`` is the hash grid's Function
    (the wrappers alone choose by device), and its CPU path launches
    nothing."""
    cfg, table, pts = _inputs(CONFIGS["f2_spill_and_collide"], n=200)
    hg.reset_launches()
    tb = table.clone().requires_grad_()
    enc = hash_encoding_apply(tb, pts.clone().requires_grad_(), cfg)
    # the (N, L * F) output's reshape to the positions' batch shape
    assert type(enc.grad_fn.next_functions[0][0]).__name__ == "_HashGridBackward"
    assert torch.equal(enc, hg.hash_grid(table, pts, cfg))
    enc.sum().backward()
    assert not any(hg.LAUNCHES.values())


def test_wrapper_argument_checks():
    """What the kernels do not take raises before a launch: features a level
    outside 1, 2, 4, 8, more than 32 levels, L * T from 2^31, entries or
    positions of another shape or dtype, 2^31 keys or more, a backward with
    nothing to compute, devices mixed."""
    cfg, table, pts = _inputs(CONFIGS["f2_spill_and_collide"], n=100)
    entries = hg.entry_major(table, cfg)
    hg._check(entries, pts, cfg)
    for kw in (dict(features_per_level=3), dict(num_levels=33, max_resolution=64),
               dict(num_levels=2, log2_hashmap_size=30)):
        bad = HashEncodingConfig(**{**CONFIGS["f2_spill_and_collide"], **kw})
        with pytest.raises(ValueError, match="hash_grid"):
            hg._check(None, pts, bad)
    with pytest.raises(ValueError, match="entries"):
        hg._check(entries.double(), pts, cfg)
    with pytest.raises(ValueError, match="entries"):
        hg._check(entries[1:], pts, cfg)
    with pytest.raises(ValueError, match="positions"):
        hg._check(entries, pts[:, :2], cfg)
    with pytest.raises(ValueError, match="positions"):
        hg._check(entries, pts.double(), cfg)
    with pytest.raises(ValueError, match="2\\^31 keys"):
        hg._check_keys(2**31 // (8 * cfg.num_levels), cfg)
    hg._check_keys(2**31 // (8 * cfg.num_levels) - 1, cfg)
    grad = torch.zeros(100, cfg.output_dim)
    with pytest.raises(ValueError, match="need_vals"):
        hg.hash_grid_bwd(entries, pts, grad, cfg, False, False)
    with pytest.raises(ValueError, match="need_vals"):
        hg.hash_grid_bwd(None, pts, grad, cfg, True, True)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        hg.hash_grid_fwd(table, pts.to("meta"), cfg, False)


def test_normals_differentiate_the_plain_encoding_twice(monkeypatch):
    """``_normals`` differentiates the density twice, which the kernels'
    once-differentiable backward cannot: it calls the plain encoding by
    name, on every device, and no other path does."""
    from nerf_kbs_tpu_torch.models import fields

    def refuse(*_):
        raise AssertionError("the normals called hash_encoding_apply")

    cfg = fields.NerfactoFieldConfig(encoding="hash", hash=HashEncodingConfig(
        **CONFIGS["f2_spill_and_collide"]), hidden_dim=16, geo_feat_dim=7, num_layers=2,
        hidden_dim_color=16, num_layers_color=2, appearance_embedding_dim=0,
        disable_scene_contraction=True)
    params = fields.nerfacto_field_init(cfg, torch.Generator().manual_seed(0), "cpu")
    params["hash_table"].requires_grad_()
    pts = torch.tensor(np.random.default_rng(2).uniform(-0.9, 0.9, (3, 4, 3)),
                       dtype=torch.float32)
    monkeypatch.setattr(fields, "hash_encoding_apply", refuse)
    normals = fields._normals(params, cfg, pts, None)
    normals.sum().backward()
    assert params["hash_table"].grad is not None
    assert torch.isfinite(normals).all()


def test_segment_sum_counters_untouched_on_the_cpu():
    """The sort and the by-key sum run their plain versions on the CPU and
    count no launch (the card's counts are the chip's tests')."""
    seg.reset_launches()
    cfg, table, pts = _inputs(CONFIGS["f1_dense_past_the_table"], n=100)
    tb = table.clone().requires_grad_()
    hg.hash_grid(tb, pts, cfg).sum().backward()
    assert not any(seg.LAUNCHES.values())
