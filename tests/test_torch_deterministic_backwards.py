"""The port's fixed-order backwards against the JAX package on the CPU, f32:
the interlevel bounds' cw gradient (``_outer_cw_bounds`` against
``_outer_cw_bwd``), the pdf sampler's brackets (``_bracket_values`` against
``_bracket_bwd``, and through ``pdf_sampler``, its running maximum too,
with a jitter that rounds to 1), the hash table's gradient (against ``jax.grad`` of
``hash_encoding_apply`` on a table small enough that hashes collide; the
port's hash grid operation and its plain encoding), and
the plain segment sum against an f64 loop. All four sites hand
``segment_sum`` index rows that are non-decreasing, which the kernel on the
card needs (the CPU's ``scatter_add_`` does not): a recording stand-in
checks that. Then the comparisons the repeat checks rest on
(``chip_smoke.first_divergence``, ``tools/repeat_bits_torch.py``'s
``compare_logs``). Inputs come from NumPy seeds; ~20 s in one process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.ops import encoding as jenc
from nerf_kbs_tpu.ops import losses as jlosses
from nerf_kbs_tpu.ops import samplers as jsamp
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.ops import encoding as tenc
from nerf_kbs_tpu_torch.ops import hash_grid as thg
from nerf_kbs_tpu_torch.ops import losses as tlosses
from nerf_kbs_tpu_torch.ops import samplers as tsamp
from nerf_kbs_tpu_torch.ops import segment_sum as tseg

# the gradients are sums of a few f32 cotangents taken in another order than
# XLA's: within 1e-6 of JAX's (relative to 1, the cotangents' scale)
TOL = 1e-6


@pytest.fixture
def sorted_calls(monkeypatch):
    """Replaces segment_sum in the three modules, and the gathers' sorted
    sum (ops.segment_sum.segment_sum_by_key), by the plain versions after a
    check that every index row is non-decreasing and inside the targets (and
    a gather's permutation a permutation); returns the calls' (rows,
    entries, targets)."""
    calls = []

    def checked(values, idx, num_targets):
        assert bool((idx[:, 1:] >= idx[:, :-1]).all()), "an index row is not sorted"
        assert int(idx.min()) >= 0 and int(idx.max()) < num_targets
        calls.append((values.shape[0], values.shape[1], num_targets))
        return tseg.segment_sum_reference(values, idx, num_targets)

    by_key = tseg.segment_sum_by_key

    def checked_by_key(values, keys, perm, out, own=None):
        checked(values.index_select(1, perm), keys[None], out.shape[1])
        assert torch.equal(torch.sort(perm.long()).values, torch.arange(len(perm)))
        return by_key(values, keys, perm, out, own)

    for mod in (tlosses, tsamp, tseg):
        monkeypatch.setattr(mod, "segment_sum", checked)
    # the gathers of the hash table's levels (ops.segment_sum.gather_column_sets)
    # and the hash grid's table gradient (ops.hash_grid.table_gradient)
    for mod in (tseg, thg):
        monkeypatch.setattr(mod, "segment_sum_by_key", checked_by_key)
    return calls


def _sorted_rows(rng, r, s, lo=0.0, hi=1.0):
    return np.sort(rng.uniform(lo, hi, (r, s + 1)), axis=-1).astype(np.float32)


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


# ---------------------------------------------------------------------------
# the plain segment sum
# ---------------------------------------------------------------------------


def _segments(case, rng):
    """(values (R, Q), idx (R or 1, Q), targets) of one case."""
    if case == "random_runs":
        idx = np.sort(rng.integers(0, 20, (5, 40)), axis=-1)
        return rng.normal(size=(5, 40)), idx, 20
    if case == "empty_runs":  # only even targets are named
        idx = np.sort(rng.integers(0, 15, (4, 30)), axis=-1) * 2
        return rng.normal(size=(4, 30)), idx, 31
    if case == "one_element_rows":
        return rng.normal(size=(6, 1)), rng.integers(0, 7, (6, 1)), 7
    if case == "long_runs":  # one target takes almost every entry
        idx = np.full((3, 5000), 4)
        idx[:, :3], idx[:, -2:] = 1, 9
        return rng.normal(size=(3, 5000)) * 1e3, idx, 10
    # one index row shared by every value row (the hash table's feature rows)
    return rng.normal(size=(3, 500)), np.sort(rng.integers(0, 64, (1, 500)), axis=-1), 64


@pytest.mark.parametrize("case", ["random_runs", "empty_runs", "one_element_rows",
                                  "long_runs", "shared_index_row"])
def test_plain_segment_sum_matches_an_f64_loop(case):
    values, idx, n = _segments(case, np.random.default_rng(0))
    want = np.zeros((values.shape[0], n))
    for r in range(values.shape[0]):
        for q in range(values.shape[1]):
            want[r, idx[min(r, idx.shape[0] - 1), q]] += values[r, q]
    got64 = tseg.segment_sum(torch.as_tensor(values), torch.as_tensor(idx, dtype=torch.int32), n)
    assert got64.dtype == torch.float64
    np.testing.assert_array_equal(got64.numpy(), want)  # the same adds in the same order
    v32 = values.astype(np.float32)
    got32 = tseg.segment_sum(torch.as_tensor(v32), torch.as_tensor(idx), n)
    scale = np.abs(v32).sum(axis=-1, keepdims=True)
    assert np.all(np.abs(got32.numpy() - want) <= 4e-7 * scale)


def test_segment_sum_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        tseg.segment_sum(torch.zeros(3, 4), torch.zeros(2, 4, dtype=torch.int32), 5)
    with pytest.raises(ValueError):
        tseg.segment_sum(torch.zeros(3, 4), torch.zeros(3, 5, dtype=torch.int32), 5)


# ---------------------------------------------------------------------------
# the interlevel bounds
# ---------------------------------------------------------------------------


def _outer_case(case, rng):
    R, Se, Sq = 6, 10, 12
    t_env = _sorted_rows(rng, R, Se)
    tq = _sorted_rows(rng, R, Sq)
    if case == "ties":  # most queries inside one env bin
        t_env = np.broadcast_to(np.linspace(0, 1, Se + 1, dtype=np.float32), (R, Se + 1)).copy()
        tq = _sorted_rows(rng, R, Sq, 0.31, 0.39)
        tq[:, -2:] = [0.55, 0.8]
    elif case == "t0_before_every_edge":
        t_env = _sorted_rows(rng, R, Se, 0.4, 1.0)
    elif case == "t1_past_every_edge":
        t_env = _sorted_rows(rng, R, Se, 0.0, 0.5)
    cw = np.cumsum(rng.random((R, Se + 1)), -1).astype(np.float32)
    return t_env, cw, tq[:, :-1].copy(), tq[:, 1:].copy()


@pytest.mark.parametrize("case", ["random", "ties", "t0_before_every_edge",
                                  "t1_past_every_edge"])
def test_outer_cw_bounds_backward_matches_jax(case, sorted_calls):
    rng = np.random.default_rng(1)
    t_env, cw, t0, t1 = _outer_case(case, rng)
    if case == "t0_before_every_edge":
        assert (t0[:, 0] < t_env[:, 0]).all()
    if case == "t1_past_every_edge":
        assert (t1[:, -1] > t_env[:, -1]).all()
    gs = [rng.normal(size=t0.shape).astype(np.float32) for _ in range(2)]
    jout, vjp = jax.vjp(jlosses._outer_cw_bounds, *map(jnp.asarray, (t_env, cw, t0, t1)))
    jd_cw = np.asarray(vjp(tuple(map(jnp.asarray, gs)))[1])
    tcw = _leaf(cw)
    tout = tlosses._outer_cw_bounds(torch.as_tensor(t_env), tcw, torch.as_tensor(t0),
                                    torch.as_tensor(t1))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=TOL, atol=TOL)
    torch.autograd.backward(tout, [torch.as_tensor(g) for g in gs])
    np.testing.assert_allclose(tcw.grad.numpy(), jd_cw, rtol=TOL, atol=TOL)
    assert sorted_calls == [(2 * cw.shape[0], t0.shape[1], cw.shape[1])]


# ---------------------------------------------------------------------------
# the pdf sampler's brackets
# ---------------------------------------------------------------------------


def _bracket_case(case, rng):
    R, S, Q = 7, 12, 9
    w = rng.random((R, S)).astype(np.float32) + 0.01
    cdf = np.concatenate([np.zeros((R, 1)), np.cumsum(w, -1)], -1)
    cdf = (cdf / cdf[:, -1:]).astype(np.float32)
    cdf[:, -1] = 1.0
    edges = _sorted_rows(rng, R, S)
    u = np.sort(rng.random((R, Q)) * 0.999, axis=-1).astype(np.float32)
    if case == "ties":  # most queries in one bin
        u = np.sort(rng.uniform(cdf[:, 5:6], cdf[:, 6:7], (R, Q)), axis=-1).astype(np.float32)
    elif case == "on_cdf_values":
        u = np.ascontiguousarray(np.sort(cdf[:, rng.integers(0, S, Q)], axis=-1))
    return cdf, edges, u


@pytest.mark.parametrize("case", ["random", "ties", "on_cdf_values"])
def test_bracket_values_backward_matches_jax(case, sorted_calls):
    rng = np.random.default_rng(2)
    cdf, edges, u = _bracket_case(case, rng)
    gs = [rng.normal(size=u.shape).astype(np.float32) for _ in range(4)]
    jout, vjp = jax.vjp(jsamp._bracket_values, *map(jnp.asarray, (cdf, edges, u)))
    jd_cdf, jd_edges, _ = vjp(tuple(map(jnp.asarray, gs)))
    tc, te = _leaf(cdf), _leaf(edges)
    tout = tsamp._bracket_values(tc, te, torch.as_tensor(u))
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    torch.autograd.backward(tout, [torch.as_tensor(g) for g in gs])
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jd_cdf), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jd_edges), rtol=TOL, atol=TOL)
    assert sorted_calls == [(4 * u.shape[0], u.shape[1], cdf.shape[1])]


def _rays(n):
    rng = np.random.default_rng(3)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    kw = dict(pixel_area=np.full((n, 1), 1e-4, np.float32),
              directions_norm=np.ones((n, 1), np.float32),
              camera_indices=np.zeros((n, 1), np.int32),
              nears=np.full((n, 1), 0.05, np.float32), fars=np.full((n, 1), 20.0, np.float32))
    jr = jcam.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tr = tcam.RayBundle(origins=torch.as_tensor(o), directions=torch.as_tensor(d),
                        **{k: torch.as_tensor(v) for k, v in kw.items()})
    return jr, tr


def test_pdf_sampler_gradient_with_a_jitter_rounded_to_one_matches_jax(monkeypatch,
                                                                       sorted_calls):
    """A jitter just below 1 puts the top quantile at exactly 1.0 = cdf_last
    in f32: the port's bracket takes the last bin, JAX's masked reductions
    an empty upper bracket; the new edges and their gradients with respect
    to the weights and the old edges agree."""
    R, S, Q = 5, 24, 8
    jr, tr = _rays(R)
    rng = np.random.default_rng(4)
    w = rng.random((R, S)).astype(np.float32)
    s_edges = _sorted_rows(rng, R, S)
    ct = rng.normal(size=(R, Q + 1)).astype(np.float32)
    rand = np.full((R, 1), np.float32(1.0) - np.float32(2.0 ** -24), np.float32)
    assert np.float32(1.0 - 1.0 / (Q + 1)) + rand[0, 0] / np.float32(Q + 1) == np.float32(1.0)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(rand))

    def jf(w_, e_):
        js = jsamp.RaySamples(spacing_starts=e_[:, :-1], spacing_ends=e_[:, 1:],
                              starts=e_[:, :-1], ends=e_[:, 1:])
        out = jsamp.pdf_sampler(jr, js, w_, Q, "piecewise", key=jax.random.PRNGKey(0))
        edges = jnp.concatenate([out.spacing_starts, out.spacing_ends[:, -1:]], -1)
        return jnp.sum(edges * ct)

    jg_w, jg_e = jax.grad(jf, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(s_edges))
    tw, te = _leaf(w), _leaf(s_edges)
    ts = tsamp.RaySamples(spacing_starts=te[:, :-1], spacing_ends=te[:, 1:],
                          starts=te[:, :-1], ends=te[:, 1:])
    out = tsamp.pdf_sampler(tr, ts, tw, Q, "piecewise", rand=torch.as_tensor(rand))
    edges = torch.cat([out.spacing_starts, out.spacing_ends[:, -1:]], -1)
    np.testing.assert_allclose(edges.detach().numpy()[:, -1], s_edges[:, -1], rtol=0, atol=1e-6)
    torch.sum(edges * torch.as_tensor(ct)).backward()
    # through the cdf's cumulative sum and the division of the inverse CDF
    # as well: 1e-4 of the largest entry, as the sampler's gradient test of
    # test_torch_train_ops.py holds it
    for got, want in ((tw.grad, jg_w), (te.grad, jg_e)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max()
    # the running maximum of the new edges, then the brackets
    assert sorted_calls == [(R, Q + 1, Q + 1), (4 * R, Q + 1, S + 1)]


# ---------------------------------------------------------------------------
# the hash table
# ---------------------------------------------------------------------------

# 64 slots a level: two dense levels (27 and 64 slots, the second spilling
# its far face past the level's end), two hashed levels where the corners of
# 500 points collide
HASH = dict(num_levels=4, features_per_level=2, log2_hashmap_size=6, base_resolution=2,
            max_resolution=8)


@pytest.mark.parametrize("encoding", ["hash_encoding_apply", "hash_encoding_plain"])
@pytest.mark.parametrize("points", ["inside", "faces_and_outside"])
def test_hash_table_gradient_matches_jax(points, encoding, sorted_calls):
    jc, tc = jenc.HashEncodingConfig(**HASH), tenc.HashEncodingConfig(**HASH)
    assert [(r + 1) ** 3 <= 64 for r in tc.resolutions] == [True, True, False, False]
    rng = np.random.default_rng(5)
    pts = rng.random((500, 3))
    if points == "faces_and_outside":
        pts[:100, 0], pts[100:200, 1], pts[200:300, 2] = 1.0, 0.0, 1.0
        pts[300:400] = rng.uniform(-0.5, 1.5, (100, 3))
    pts = pts.astype(np.float32)
    table = rng.uniform(-1, 1, (2 * 4 * 64,)).astype(np.float32)
    cot = rng.normal(size=(500, 8)).astype(np.float32)
    jg = jax.grad(lambda tb: jnp.sum(jenc.hash_encoding_apply(tb, jnp.asarray(pts), jc) * cot))(
        jnp.asarray(table))
    tb = _leaf(table)
    encode = getattr(tenc, encoding)
    (encode(tb, torch.as_tensor(pts), tc) * torch.as_tensor(cot)).sum().backward()
    # a slot sums ~60 to ~500 products of order 1
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=2e-5)
    if encoding == "hash_encoding_apply":
        # the hash grid's operation: one sum of F = 2 rows over the 4 x 500
        # x 8 corners into all 4 x 64 columns (level 1's far face adds into
        # level 2's slots in the same sorted run)
        assert sorted_calls == [(2, 16000, 256)]
        return
    # the plain encoding: one sum a level over its 500 x 8 corners, F = 2
    # rows sharing the index row (the backward visits the levels last to
    # first: level 1's far face adds into level 2's slots)
    assert [c[:2] for c in sorted_calls] == [(2, 4000)] * 4
    assert [c[2] for c in sorted_calls] == [64, 64, 4 * (1 + 4 + 16) + 1, 64]


# ---------------------------------------------------------------------------
# the comparisons the repeat checks rest on
# ---------------------------------------------------------------------------


def test_first_divergence_names_the_first_step_and_what_parts():
    import chip_smoke

    def rec(mu, loss):
        return {"losses": {"total_loss": loss, "psnr": float("nan")},
                "state": {"fields/p": [1, 2], "fields/mu": mu}}

    a = [rec([3, 4], 0.5), rec([5, 6], 0.25), rec([7, 8], 0.125)]
    assert chip_smoke.first_divergence(a, [dict(r) for r in a]) is None  # NaN equals NaN
    b = [rec([3, 4], 0.5), rec([5, 7], 0.25), rec([7, 8], 0.126)]
    assert chip_smoke.first_divergence(a, b) == {"step": 2, "state": ["fields/mu"], "losses": []}
    assert chip_smoke.first_divergence(a, a[:2])["step"] == 3


def _repeat_tool():
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "repeat_bits_torch", Path(__file__).resolve().parents[1] / "tools" / "repeat_bits_torch.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def test_compare_logs_skips_only_time_and_rate_fields(tmp_path, capsys):
    import json

    tool = _repeat_tool()
    line = {"step": 1000, "psnr": 20.5, "eval_all_ssim": 0.8, "rays_per_sec": 6.0e5,
            "elapsed_s": 64.0}
    paths = [tmp_path / f"{k}.jsonl" for k in "abc"]
    paths[0].write_text(json.dumps(line) + "\n")
    paths[1].write_text(json.dumps({**line, "rays_per_sec": 7.0e5, "elapsed_s": 61.0}) + "\n")
    paths[2].write_text(json.dumps({**line, "eval_all_ssim": 0.81}) + "\n")
    assert tool.compare_logs(str(paths[0]), str(paths[1])) == 0
    assert tool.compare_logs(str(paths[0]), str(paths[2])) == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert "eval_all_ssim" in out[0]["fields_compared"]
    assert "rays_per_sec" not in out[0]["fields_compared"]
    assert out[1]["first"][0]["fields"] == {"eval_all_ssim": [0.8, 0.81]}


def test_compare_checksums_names_the_first_step_where_two_trees_part(tmp_path, capsys):
    """Two OUT.json files of tools/repeat_bits_torch.py (two trees' runs of
    one path): equal checksums and losses compare equal; a checksum that
    differs at step 2 is named there."""
    import json

    tool = _repeat_tool()
    sums = [{"fields/p": [1, 2]}, {"fields/p": [3, 4]}, {"fields/p": [5, 6]}]
    losses = [{"total_loss": 0.5}, {"total_loss": 0.25}, {"total_loss": 0.125}]

    def write(name, checks):
        f = tmp_path / name
        f.write_text(json.dumps({"paths": {"ilf050": {"checksums": checks,
                                                      "losses": [losses, losses, losses]}}}))
        return str(f)

    a, b = write("a.json", sums), write("b.json", [dict(x) for x in sums])
    c = write("c.json", [sums[0], {"fields/p": [3, 5]}, sums[2]])
    assert tool.compare_checksums(a, b) == 0
    assert tool.compare_checksums(a, c) == 1
    out = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert out[0]["ilf050"] == {"steps": [3, 3], "first_divergence": None}
    assert out[1]["ilf050"]["first_divergence"] == {"step": 2, "state": ["fields/p"],
                                                    "losses": []}
