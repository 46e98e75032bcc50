"""Port vs JAX package, the non-fused field path on the CPU in f32: the hash,
CP, Fourier and frequency encodings (values and gradients), the scene
contraction and box normalisation, the render heads and normal losses, the
nerfacto and proposal fields with every head (semantics, appearance,
transient, predicted normals) and the analytic normals (their second-order
backward), and nerfacto's forward on the non-fused branch. JAX runs its own
non-fused path (NKT_FUSED unset, so no Pallas call); both sides get the same
seeded NumPy inputs and the JAX parameters."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.models import fields as jfields
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu.ops import contraction as jcon
from nerf_kbs_tpu.ops import encoding as jenc
from nerf_kbs_tpu.ops import losses as jL
from nerf_kbs_tpu.ops import rendering as jren
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import fields as tfields
from nerf_kbs_tpu_torch.models import nerfacto as tnerf
from nerf_kbs_tpu_torch.ops import contraction as tcon
from nerf_kbs_tpu_torch.ops import encoding as tenc
from nerf_kbs_tpu_torch.ops import losses as tL
from nerf_kbs_tpu_torch.ops import rendering as tren

# 4 levels at resolutions 4, 8, 16, 32 in a 1024-slot table: levels 0 and 1
# are dense ((res + 1)^3 <= 1024), levels 2 and 3 hashed
HASH = dict(num_levels=4, features_per_level=2, log2_hashmap_size=10, base_resolution=4,
            max_resolution=32)
CP = dict(num_levels=3, features_per_level=4, base_resolution=4, max_resolution=16)


def _rel(got, want) -> float:
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _t(a):
    return torch.as_tensor(np.array(a))


def _points(n=96, seed=0):
    """Random points in [0, 1]^3, points with a coordinate exactly on the
    faces 0 and 1 (and on both), and points outside [0, 1]."""
    rng = np.random.default_rng(seed)
    inside = rng.random((n, 3))
    faces = rng.random((24, 3))
    faces[:8, 0], faces[8:16, 1], faces[16:, 2] = 0.0, 1.0, rng.integers(0, 2, 8)
    corners = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [0.0, 1.0, 0.5], [1.0, 0.25, 0.0]])
    outside = rng.uniform(-0.5, 1.5, (24, 3))
    return np.concatenate([inside, faces, corners, outside]).astype(np.float32), n + 28


def _hash_pair():
    jc, tc = jenc.HashEncodingConfig(**HASH), tenc.HashEncodingConfig(**HASH)
    assert tc.resolutions == jc.resolutions == (4, 8, 16, 32)
    dense = [(r + 1) ** 3 <= tc.table_size for r in tc.resolutions]
    assert dense == [True, True, False, False]
    table = np.random.default_rng(1).uniform(-1, 1, (2 * 4 * 1024,)).astype(np.float32)
    return jc, tc, table


# the two hash encodings of the port: ``hash_encoding_apply``, the hash
# grid's operation (``ops.hash_grid.hash_grid``: on the CPU its kernels'
# plain versions, which the kernels equal bit for bit, and the one sort and
# by-key sum a field), and ``hash_encoding_plain``, the normals' encoding
HASH_ENCODINGS = ["hash_encoding_apply", "hash_encoding_plain"]


@pytest.mark.parametrize("encoding", HASH_ENCODINGS)
def test_hash_encoding_matches_jax_and_its_reference(encoding):
    encode = getattr(tenc, encoding)
    jc, tc, table = _hash_pair()
    pts, n_in = _points()
    tb = _t(table).requires_grad_()
    got = encode(tb, _t(pts).reshape(4, -1, 3), tc)
    assert got.shape == (4, pts.shape[0] // 4, 8)
    # the first is the hash grid's Function (its output reshaped to (4, -1))
    is_function = type(got.grad_fn.next_functions[0][0]).__name__ == "_HashGridBackward"
    assert is_function == (encoding == "hash_encoding_apply")
    got = got.detach()
    want = jenc.hash_encoding_apply(jnp.asarray(table), jnp.asarray(pts), jc)
    assert _rel(got.reshape(-1, 8), want) <= 1e-6
    ref = jenc._hash_encoding_apply_reference(jnp.asarray(table), jnp.asarray(pts[:n_in]), jc)
    assert _rel(got.reshape(-1, 8)[:n_in], ref) <= 1e-6
    # outside points read their clamped point's cells
    clamped = encode(_t(table), _t(np.clip(pts, 0, 1)), tc)
    assert torch.equal(got.reshape(-1, 8), clamped)


@pytest.mark.parametrize("encoding", HASH_ENCODINGS)
def test_hash_encoding_dense_far_face_stays_in_the_table(encoding):
    """A dense level (10^3 <= 1024 slots) whose far-face corners (res + 1, the
    ones of weight 0) index past the table's end: JAX's gather fills those
    reads with NaN, so its second feature is NaN there; the port keeps the
    index inside the table (on the card an index past the end would be a
    device fault) and returns the finite value, equal to JAX's wherever
    JAX's is finite."""
    kw = dict(num_levels=1, features_per_level=2, log2_hashmap_size=10, base_resolution=9,
              max_resolution=9)
    jc, tc = jenc.HashEncodingConfig(**kw), tenc.HashEncodingConfig(**kw)
    table = np.random.default_rng(20).uniform(-1, 1, (2 * 1024,)).astype(np.float32)
    pts, _ = _points(seed=21)
    got = getattr(tenc, encoding)(_t(table), _t(pts), tc).numpy()
    want = np.asarray(jenc.hash_encoding_apply(jnp.asarray(table), jnp.asarray(pts), jc))
    assert np.isnan(want).any() and np.isfinite(got).all()
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-6)


@pytest.mark.parametrize("encoding", HASH_ENCODINGS)
def test_hash_encoding_gradients_match_jax(encoding):
    """The table gradient (a scatter-add through the gather) and the
    position gradient, faces and outside points included, against jax.grad
    of the same weighted sum."""
    jc, tc, table = _hash_pair()
    pts, _ = _points(seed=2)
    cot = np.random.default_rng(3).normal(size=(pts.shape[0], 8)).astype(np.float32)
    jg_table, jg_pts = jax.grad(
        lambda tb, p: jnp.sum(jenc.hash_encoding_apply(tb, p, jc) * cot), argnums=(0, 1)
    )(jnp.asarray(table), jnp.asarray(pts))
    tb, p = _t(table).requires_grad_(), _t(pts).requires_grad_()
    (getattr(tenc, encoding)(tb, p, tc) * _t(cot)).sum().backward()
    assert _rel(tb.grad, jg_table) <= 1e-5
    assert _rel(p.grad, jg_pts) <= 1e-5


# The JAX package's hash encoding and its gradients on fixed inputs, kept for
# the card's tests, which run without JAX (tests/test_torch_cuda_kernels.py
# holds the kernels to them). ``JAX_PLATFORMS=cpu PYTHONPATH=. python
# tests/test_torch_fields.py`` writes the file; a case's F features a level name a kernel template, and its
# levels are dense (level 1's far face reaching level 2's slots) and hashed
# with colliding corners.
HASH_GRID_JAX_FILE = Path(__file__).resolve().parent / "data" / "hash_grid_jax.npz"
HASH_GRID_JAX_CASES = {
    f"f{F}": dict(num_levels=4, features_per_level=F, log2_hashmap_size=6, base_resolution=2,
                  max_resolution=8) for F in (1, 2, 4)
}
HASH_GRID_JAX_KEYS = ("num_levels", "features_per_level", "log2_hashmap_size",
                      "base_resolution", "max_resolution")


def hash_grid_jax_arrays() -> dict:
    """Per case ``<case>/config`` (HASH_GRID_JAX_KEYS' values), the inputs
    ``table``, ``pts`` (inside, on faces and outside), ``cot``, and JAX's
    ``enc``, ``d_table`` and ``d_pts`` of sum(enc * cot)."""
    out = {}
    for i, (name, kw) in enumerate(sorted(HASH_GRID_JAX_CASES.items())):
        jc = jenc.HashEncodingConfig(**kw)
        pts, _ = _points(n=400, seed=30 + i)
        rng = np.random.default_rng(40 + i)
        size = jc.features_per_level * jc.num_levels * jc.table_size
        table = rng.uniform(-1, 1, (size,)).astype(np.float32)
        cot = rng.normal(size=(pts.shape[0], jc.num_levels * jc.features_per_level))
        cot = cot.astype(np.float32)
        enc = jenc.hash_encoding_apply(jnp.asarray(table), jnp.asarray(pts), jc)
        d_table, d_pts = jax.grad(
            lambda tb, p: jnp.sum(jenc.hash_encoding_apply(tb, p, jc) * cot), argnums=(0, 1)
        )(jnp.asarray(table), jnp.asarray(pts))
        arrays = dict(config=np.array([kw[k] for k in HASH_GRID_JAX_KEYS]), table=table, pts=pts,
                      cot=cot, enc=enc, d_table=d_table, d_pts=d_pts)
        out.update({f"{name}/{k}": np.asarray(v) for k, v in arrays.items()})
    return out


def test_hash_grid_jax_file_is_the_jax_packages():
    """The kept file holds what the JAX package computes now (its inputs
    equal, its numbers within 1e-6 of the largest of each), finite."""
    with np.load(HASH_GRID_JAX_FILE) as f:
        kept = dict(f)
    fresh = hash_grid_jax_arrays()
    assert sorted(kept) == sorted(fresh)
    for k, v in fresh.items():
        assert np.isfinite(kept[k]).all(), k
        if k.split("/")[1] in ("config", "table", "pts", "cot"):
            np.testing.assert_array_equal(kept[k], v, err_msg=k)
        else:
            assert _rel(kept[k], v) <= 1e-6, k


@pytest.mark.parametrize("encoding", HASH_ENCODINGS)
@pytest.mark.parametrize("case", sorted(HASH_GRID_JAX_CASES))
def test_hash_encoding_matches_the_kept_jax_numbers(encoding, case):
    """The CPU side of the card's check against the kept JAX numbers, with
    its tolerances: the encoding within 1e-6 of the largest |value| (the 8
    corners summed in another order), the table's and the positions'
    gradients within 1e-5 of their largest (another order of each slot's
    and each point's sum)."""
    with np.load(HASH_GRID_JAX_FILE) as f:
        a = {k.split("/")[1]: f[k] for k in f.files if k.startswith(case + "/")}
    tc = tenc.HashEncodingConfig(**dict(zip(HASH_GRID_JAX_KEYS, a["config"].tolist())))
    tb, p = _t(a["table"]).requires_grad_(), _t(a["pts"]).requires_grad_()
    enc = getattr(tenc, encoding)(tb, p, tc)
    (enc * _t(a["cot"])).sum().backward()
    assert _rel(enc, a["enc"]) <= 1e-6
    assert _rel(tb.grad, a["d_table"]) <= 1e-5
    assert _rel(p.grad, a["d_pts"]) <= 1e-5


def test_cp_encoding_and_gradients_match_jax():
    jc, tc = jenc.CPEncodingConfig(**CP), tenc.CPEncodingConfig(**CP)
    assert tc.resolutions == jc.resolutions
    rng = np.random.default_rng(4)
    tables = [rng.uniform(-1, 1, (3, r + 1, 4)).astype(np.float32) for r in tc.resolutions]
    pts, _ = _points(seed=5)
    cot = rng.normal(size=(pts.shape[0], tc.output_dim)).astype(np.float32)
    jval = jenc.cp_encoding_apply([jnp.asarray(x) for x in tables], jnp.asarray(pts), jc)
    jg_tables, jg_pts = jax.grad(
        lambda tb, p: jnp.sum(jenc.cp_encoding_apply(tb, p, jc) * cot), argnums=(0, 1)
    )([jnp.asarray(x) for x in tables], jnp.asarray(pts))
    tb = [_t(x).requires_grad_() for x in tables]
    p = _t(pts).requires_grad_()
    got = tenc.cp_encoding_apply(tb, p, tc)
    assert _rel(got, jval) <= 1e-6
    (got * _t(cot)).sum().backward()
    for a, b in zip(tb, jg_tables):
        assert _rel(a.grad, b) <= 1e-6
    assert _rel(p.grad, jg_pts) <= 1e-6


@pytest.mark.parametrize("include_input", [True, False])
def test_positional_encoding_matches_jax(include_input):
    x = np.random.default_rng(6).uniform(-1, 1, (5, 7, 3)).astype(np.float32)
    got = tenc.positional_encoding(_t(x), 4, include_input=include_input)
    want = jenc.positional_encoding(jnp.asarray(x), 4, include_input=include_input)
    assert got.shape == want.shape and _rel(got, want) <= 1e-6


@pytest.mark.parametrize("basis", ["sincos", "tri"])
def test_fourier_encoding_apply_matches_jax(basis):
    kw = dict(num_levels=3, features_per_level=8, base_resolution=2, max_resolution=16,
              basis=basis)
    jc, tc = jenc.FourierEncodingConfig(**kw), tenc.FourierEncodingConfig(**kw)
    B = np.asarray(jenc.fourier_encoding_init(jax.random.PRNGKey(0), jc))
    x = np.random.default_rng(7).random((6, 9, 3)).astype(np.float32)
    win = np.asarray(jenc.fourier_window(jc, 0.55))
    want = jenc.fourier_encoding_apply(jnp.asarray(B), jnp.asarray(x), jc, window=jnp.asarray(win))
    got = tenc.fourier_encoding_apply(_t(B).requires_grad_(), _t(x), tc,
                                      window=tenc.fourier_window(tc, 0.55, "cpu"))
    assert _rel(got, want) <= 1e-6
    assert not got.requires_grad  # B is frozen


@pytest.mark.parametrize("order", [None, float("inf")])
def test_contraction_and_box_match_jax(order):
    x = (np.random.default_rng(8).normal(size=(40, 3)) * 2.0).astype(np.float32)
    jx = jnp.asarray(x)
    assert _rel(tcon.scene_contraction(_t(x), order), jcon.scene_contraction(jx, order)) <= 1e-6
    assert _rel(tcon.contract_to_unit_cube(_t(x), order),
                jcon.contract_to_unit_cube(jx, order)) <= 1e-6
    box = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    assert _rel(tcon.normalize_aabb(_t(x), _t(box)),
                jcon.normalize_aabb(jx, jnp.asarray(box))) <= 1e-6


@pytest.mark.parametrize("background", ["last_sample", "white", "black", "color"])
def test_render_heads_match_jax(background):
    rng = np.random.default_rng(9)
    w = rng.random((7, 5)).astype(np.float32) / 5
    rgb, sem = rng.random((7, 5, 3)).astype(np.float32), rng.normal(size=(7, 5, 4))
    n = rng.normal(size=(7, 5, 3)).astype(np.float32)
    betas = rng.random((7, 5)).astype(np.float32)
    bg = np.array([0.2, 0.5, 0.9], np.float32)
    jbg = jnp.asarray(bg) if background == "color" else None
    tbg = _t(bg) if background == "color" else None
    jw, tw = jnp.asarray(w), _t(w)
    assert _rel(tren.render_rgb(tw, _t(rgb), background, tbg),
                jren.render_rgb(jw, jnp.asarray(rgb), background, jbg)) <= 1e-6
    sem = sem.astype(np.float32)
    assert _rel(tren.render_semantics(tw, _t(sem)),
                jren.render_semantics(jw, jnp.asarray(sem))) <= 1e-6
    assert _rel(tren.render_normals(tw, _t(n)), jren.render_normals(jw, jnp.asarray(n))) <= 1e-6
    assert _rel(tren.render_uncertainty(tw, _t(betas)),
                jren.render_uncertainty(jw, jnp.asarray(betas))) <= 1e-6
    dirs = rng.normal(size=(7, 3)).astype(np.float32)
    assert _rel(tL.orientation_loss(tw, _t(n), _t(dirs)),
                jL.orientation_loss(jw, jnp.asarray(n), jnp.asarray(dirs))) <= 1e-6
    assert _rel(tL.pred_normal_loss(tw, _t(n), _t(rgb)),
                jL.pred_normal_loss(jw, jnp.asarray(n), jnp.asarray(rgb))) <= 1e-6
    with pytest.raises(ValueError, match="background"):
        tren.render_rgb(tw, _t(rgb), "pink")


# ------------------------------------------------------------------ fields


def _field_cfgs(encoding, **change):
    """Tiny field configs with every head on, in both packages."""
    kw = {**dict(num_images=3, encoding=encoding, hidden_dim=16, hidden_dim_color=16,
                 appearance_embedding_dim=4, use_semantics=True, num_semantic_classes=3,
                 hidden_dim_semantics=16, use_transient_embedding=True,
                 transient_embedding_dim=4, hidden_dim_transient=8, use_pred_normals=True),
          **change}
    enc = dict(hash=(jenc.HashEncodingConfig(**HASH), tenc.HashEncodingConfig(**HASH)),
               cp=(jenc.CPEncodingConfig(**CP), tenc.CPEncodingConfig(**CP)),
               fourier=(jenc.FourierEncodingConfig(num_levels=2, features_per_level=8,
                                                   base_resolution=2, max_resolution=8),
                        tenc.FourierEncodingConfig(num_levels=2, features_per_level=8,
                                                   base_resolution=2, max_resolution=8)))
    jn = jfields.NerfactoFieldConfig(**kw, hash=enc["hash"][0], cp=enc["cp"][0],
                                     fourier=enc["fourier"][0])
    tn = tfields.NerfactoFieldConfig(**kw, hash=enc["hash"][1], cp=enc["cp"][1],
                                     fourier=enc["fourier"][1])
    pkw = dict(encoding=encoding, hidden_dim=8,
               disable_scene_contraction=change.get("disable_scene_contraction", False))
    jd = jfields.DensityFieldConfig(**pkw, hash=enc["hash"][0], cp=enc["cp"][0],
                                    fourier=enc["fourier"][0])
    td = tfields.DensityFieldConfig(**pkw, hash=enc["hash"][1], cp=enc["cp"][1],
                                    fourier=enc["fourier"][1])
    return jn, tn, jd, td


def _field_params(init, cfg, seed):
    """JAX parameters with the hash table drawn from U(-1, 1): at its init
    scale of 1e-4 every comparison would be vacuous."""
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    if "hash_table" in p:
        p["hash_table"] = np.random.default_rng(seed).uniform(
            -1, 1, p["hash_table"].shape).astype(np.float32)
    tp = params_from_jax(p, device="cpu")
    mark_trainable(tp)
    return jax.tree.map(jnp.asarray, p), tp


def _field_inputs(seed=10, r=6, s=5, scale=1.5):
    rng = np.random.default_rng(seed)
    pos = (rng.normal(size=(r, s, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(r, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    cams = rng.integers(0, 3, (r, 1)).astype(np.int32)
    return pos, d, cams


def _window(jn, tn):
    if jn.encoding != "fourier":
        return None, None
    return jenc.fourier_window(jn.fourier, 0.6), tenc.fourier_window(tn.fourier, 0.6, "cpu")


def _check_grads(tp, jgrads, tol):
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(tp)
    assert len(leaves) == len(jax.tree.leaves(want))
    for (path, t), j in zip(leaves, jax.tree.leaves(want)):
        if not t.requires_grad:  # fourier_B
            assert t.grad is None and not j.any(), path
        elif not j.any():  # a head or row this call does not reach
            assert t.grad is None or not t.grad.any(), path
        else:
            assert _rel(t.grad, j) <= tol, (path, _rel(t.grad, j))


@pytest.mark.parametrize("encoding,train,change", [
    ("hash", True, {}), ("hash", False, {}), ("cp", True, {}), ("fourier", True, {}),
    ("hash", True, {"disable_scene_contraction": True}),
    ("fourier", False, {"disable_scene_contraction": True}),
])
def test_nerfacto_field_apply_matches_jax(encoding, train, change):
    """Every output (semantics, per-camera or mean appearance, the transient
    heads in training, predicted normals) to 1e-5 of its largest magnitude,
    and every parameter's gradient of a seeded scalar of them to 1e-4."""
    jn, tn, _, _ = _field_cfgs(encoding, **change)
    jp, tp = _field_params(jfields.nerfacto_field_init, jn, 11)
    pos, d, cams = _field_inputs()
    jw, tw = _window(jn, tn)
    keys = ["density", "rgb", "semantics", "pred_normals"]
    keys += ["transient_density", "transient_rgb", "uncertainty"] if train else []
    rng = np.random.default_rng(12)

    def japply(p):
        return jfields.nerfacto_field_apply(p, jn, jnp.asarray(pos), jnp.asarray(d),
                                            jnp.asarray(cams), train=train, window=jw)

    shapes = jax.eval_shape(japply, jp)
    cot = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in shapes.items()}

    def jfun(p):
        out = japply(p)
        return sum(jnp.sum(out[k] * cot[k]) for k in keys), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(jfun, has_aux=True))(jp)
    tout = tfields.nerfacto_field_apply(tp, tn, _t(pos), _t(d), _t(cams), train=train,
                                        window=tw)
    assert set(tout) == set(jout) == set(keys)
    for k in keys:
        assert _rel(tout[k], jout[k]) <= 1e-5, (k, _rel(tout[k], jout[k]))
    if change:  # outside the box the density is zero, as in JAX
        assert bool((tout["density"][np.abs(pos).max(-1) > 1] == 0).all())
    sum(torch.sum(tout[k] * _t(cot[k])) for k in keys).backward()
    _check_grads(tp, jgrads, 1e-4)


@pytest.mark.parametrize("encoding,change", [
    ("hash", {}), ("cp", {}), ("fourier", {}), ("hash", {"disable_scene_contraction": True}),
])
def test_density_field_apply_matches_jax(encoding, change):
    _, _, jd, td = _field_cfgs(encoding, **change)
    jp, tp = _field_params(jfields.density_field_init, jd, 13)
    pos, _, _ = _field_inputs(14, r=9, s=7)
    jw, tw = _window(jd, td)
    cot = np.random.default_rng(15).normal(size=pos.shape[:2]).astype(np.float32)
    jval, jgrads = jax.value_and_grad(
        lambda p: jnp.sum(jfields.density_field_apply(p, jd, jnp.asarray(pos), window=jw) * cot)
    )(jp)
    got = tfields.density_field_apply(tp, td, _t(pos), window=tw)
    want = jfields.density_field_apply(jp, jd, jnp.asarray(pos), window=jw)
    assert _rel(got, want) <= 1e-5
    (got * _t(cot)).sum().backward()
    _check_grads(tp, jgrads, 1e-4)


@pytest.mark.parametrize("encoding,change", [
    ("hash", {}), ("fourier", {}), ("cp", {"disable_scene_contraction": True}),
])
def test_normals_and_their_second_order_backward_match_jax(encoding, change):
    """compute_normals against JAX's 'normals' to 1e-4, then the gradient of
    orientation_loss + pred_normal_loss (the model's form: the analytic
    normals detached in the second) with respect to every parameter, to 1e-3:
    a backward through the gradient of the density."""
    jn, tn, _, _ = _field_cfgs(encoding, use_transient_embedding=False, **change)
    jp, tp = _field_params(jfields.nerfacto_field_init, jn, 16)
    pos, d, cams = _field_inputs(17, scale=0.6)
    jw, tw = _window(jn, tn)
    w = np.random.default_rng(18).random(pos.shape[:2]).astype(np.float32) / 5

    def jloss(p):
        out = jfields.nerfacto_field_apply(p, jn, jnp.asarray(pos), jnp.asarray(d),
                                           jnp.asarray(cams), compute_normals=True, window=jw)
        n = out["normals"]
        return (jL.orientation_loss(jnp.asarray(w), n, jnp.asarray(d))
                + jL.pred_normal_loss(jnp.asarray(w), jax.lax.stop_gradient(n),
                                      out["pred_normals"])), n

    (_, jn_out), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jp)
    out = tfields.nerfacto_field_apply(tp, tn, _t(pos), _t(d), _t(cams), train=True,
                                       compute_normals=True, window=tw)
    assert _rel(out["normals"], jn_out) <= 1e-4
    assert out["normals"].requires_grad
    loss = (tL.orientation_loss(_t(w), out["normals"], _t(d))
            + tL.pred_normal_loss(_t(w), out["normals"].detach(), out["pred_normals"]))
    loss.backward()
    _check_grads(tp, jgrads, 1e-3)
    # at eval (no_grad) the normals come from a local enable_grad, detached
    with torch.no_grad():
        ev = tfields.nerfacto_field_apply(tp, tn, _t(pos), _t(d), _t(cams),
                                          compute_normals=True, window=tw)
    assert not ev["normals"].requires_grad
    assert _rel(ev["normals"], jn_out) <= 1e-4


@pytest.mark.parametrize("encoding", ["hash", "cp", "fourier"])
def test_params_convert_leaf_for_leaf(encoding):
    """params_from_jax on a field with every head (the 1-D hash table, the
    list of cp tables, the transient embedding, trunk and heads, the
    predicted-normal MLP) gives the tree the port's own init builds, leaf for
    leaf and shape for shape."""
    jn, tn, jd, td = _field_cfgs(encoding)
    trees = []
    for jinit, tinit, jc, tc in ((jfields.nerfacto_field_init, tfields.nerfacto_field_init, jn, tn),
                                 (jfields.density_field_init, tfields.density_field_init, jd, td)):
        conv = params_from_jax(jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jc)),
                               device="cpu")
        own = tinit(tc, torch.Generator().manual_seed(0), "cpu")
        paths = jax.tree_util.tree_leaves_with_path
        assert [(p, tuple(t.shape)) for p, t in paths(conv)] == \
            [(p, tuple(t.shape)) for p, t in paths(own)]
        trees.append(conv)
    assert {"transient_emb", "transient_mlp", "transient_density_head", "transient_rgb_head",
            "uncertainty_head", "pred_normal_mlp"} <= set(trees[0])


# ------------------------------------------------------------------ model


TINY_HASH = dict(num_images=3, num_levels=4, log2_hashmap_size=10, base_res=4, max_res=32,
                 proposal_num_levels=2, proposal_log2_hashmap_size=8,
                 proposal_max_res=(16, 32), hidden_dim=16, hidden_dim_color=16,
                 proposal_hidden_dim=8, num_proposal_samples_per_ray=(16, 8),
                 num_nerf_samples_per_ray=8, appearance_embedding_dim=4,
                 fourier_num_levels=2, fourier_features_per_level=8,
                 proposal_fourier_features_per_level=4)


def model_pair(**change):
    """Tiny nerfacto configs in both packages and the JAX parameters (hash
    tables from U(-1, 1)) in both."""
    kw = {**TINY_HASH, **change}
    jcfg, tcfg = jnerf.NerfactoConfig(**kw), tnerf.NerfactoConfig(**kw)
    jp = jax.tree.map(np.asarray, jnerf.init(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(19)
    for field in [jp["fields"], *jp["proposal_networks"]]:
        if "hash_table" in field:
            field["hash_table"] = rng.uniform(-1, 1, field["hash_table"].shape).astype(
                np.float32)
    tp = params_from_jax(jp, device="cpu")
    return jcfg, tcfg, jax.tree.map(jnp.asarray, jp), tp


def rays_pair(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    cam = rng.integers(0, 3, (n, 1)).astype(np.int32)
    kw = dict(pixel_area=np.full((n, 1), 1e-4, np.float32),
              directions_norm=np.ones((n, 1), np.float32))
    jr = jcam.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                        camera_indices=jnp.asarray(cam),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tr = tcam.RayBundle(origins=_t(o), directions=_t(d), camera_indices=_t(cam),
                        **{k: _t(v) for k, v in kw.items()})
    return jr, tr


def jitters(key, rounds, n_rays):
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


def forward_pair(change, train, n=24):
    """Both packages' forward on the same rays and jitter (JAX's keys)."""
    jcfg, tcfg, jp, tp = model_pair(**change)
    jr, tr = rays_pair(n)
    key = jax.random.PRNGKey(5) if train else None
    jout = jax.jit(lambda p, r, k: jnerf.forward(p, jcfg, r, key=k, step=300, train=train))(
        jp, jr, key)
    tj = jitters(key, tcfg.num_proposal_iterations, n) if train else None
    tout = tnerf.forward(tp, tcfg, tr, step=300, train=train, jitters=tj)
    return jout, tout


@pytest.mark.parametrize("change,train", [
    (dict(field_type="hash", use_semantic=True, num_semantic_classes=3), True),
    (dict(field_type="hash", use_semantic=True, num_semantic_classes=3), False),
    (dict(field_type="fourier", predict_normals=True), True),
    (dict(field_type="cp", disable_scene_contraction=True, background_color="white"), False),
])
def test_forward_non_fused_matches_jax(change, train):
    assert not tnerf.uses_fused_path(tnerf.NerfactoConfig(**{**TINY_HASH, **change}))
    jout, tout = forward_pair(change, train)
    keys = ["rgb", "depth", "accumulation", "expected_depth", "prop_depth_0", "prop_depth_1"]
    keys += ["semantics"] * ("use_semantic" in change)
    keys += ["normals", "pred_normals"] * ("predict_normals" in change)
    for k in keys:
        assert _rel(tout[k], jout[k]) <= 1e-4, (k, _rel(tout[k], jout[k]))
    for k in ("_view_dirs", "_origins"):
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))


def test_route_is_the_jax_packages():
    base = tnerf.NerfactoConfig(**TINY_HASH)
    f = dataclasses.replace(base, field_type="fourier")
    assert tnerf.uses_fused_path(f)
    assert not tnerf.uses_fused_path(f, compute_normals=True)
    for change in (dict(field_type="hash"), dict(field_type="cp"),
                   dict(predict_normals=True), dict(disable_scene_contraction=True)):
        assert not tnerf.uses_fused_path(dataclasses.replace(f, **change)), change


if __name__ == "__main__":
    HASH_GRID_JAX_FILE.parent.mkdir(exist_ok=True)
    np.savez_compressed(HASH_GRID_JAX_FILE, **hash_grid_jax_arrays())
    print(HASH_GRID_JAX_FILE)
