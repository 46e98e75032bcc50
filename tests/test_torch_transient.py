"""Port vs JAX package, the NeRF-W transient path and the eval appearance fit
on the CPU in f32: semantic-nerfw's training forward with the transient
heads (combined weights, uncertainty, transient density), its loss terms and
every parameter's gradient, for the hash and the Fourier field; and
``Trainer.fit_eval_appearance`` with ``fit_psnr`` / ``fit_psnr_right``
against the JAX trainer, including the guard for an image past the table.
JAX runs its non-fused path (no NKT_FUSED), as the transient path always
does; the port is handed the jitter JAX draws from its keys."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_kbs_tpu.methods  # noqa: F401  (registers the JAX methods)
import nerf_kbs_tpu_torch.methods  # noqa: F401  (registers the port's methods)
from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.data import synthetic_kitti as jsk
from nerf_kbs_tpu.engine import cli as jcli
from nerf_kbs_tpu.engine import trainer as jtrainer_mod
from nerf_kbs_tpu.models import semantic_nerfw as jsem
from nerf_kbs_tpu.parallel.mesh import make_mesh
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.engine.optimizers import tree_copy_
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import semantic_nerfw as tsem

FIELDS = {
    "hash": dict(field_type="hash", num_levels=4, log2_hashmap_size=10, base_res=4, max_res=32,
                 proposal_num_levels=2, proposal_log2_hashmap_size=8),
    "fourier": dict(field_type="fourier", fourier_num_levels=2, fourier_features_per_level=8,
                    proposal_fourier_features_per_level=4, proposal_num_levels=2, base_res=4,
                    max_res=32, fourier_basis="tri"),
}
SMALL = dict(num_images=3, hidden_dim=16, hidden_dim_color=16, hidden_dim_transient=16,
             proposal_max_res=(16, 32), num_proposal_samples_per_ray=(16, 8),
             num_nerf_samples_per_ray=8, appearance_embedding_dim=4, use_semantic=True,
             num_semantic_classes=4, use_depth=True, use_mask=True, use_transient_embedding=True)
KEYS = ("rgb", "accumulation", "depth", "weights", "directions_norm", "uncertainty",
        "density_transient", "semantics", "prop_depth_0", "prop_depth_1")


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    cam = rng.integers(0, 3, (n, 1)).astype(np.int32)
    kw = dict(pixel_area=np.full((n, 1), 1e-4, np.float32),
              directions_norm=rng.uniform(1.0, 1.3, (n, 1)).astype(np.float32))
    jr = jcam.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                        camera_indices=jnp.asarray(cam),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tr = tcam.RayBundle(origins=torch.as_tensor(o), directions=torch.as_tensor(d),
                        camera_indices=torch.as_tensor(cam),
                        **{k: torch.as_tensor(v) for k, v in kw.items()})
    return jr, tr


def _batch(n, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n, 3)).astype(np.float32),
            "depth_image": rng.uniform(0.2, 2.0, (n, 1)).astype(np.float32),
            "mask": (rng.random((n, 1)) > 0.25).astype(np.float32),
            "semantics_label": rng.integers(0, 4, n).astype(np.int32)}


def _jitters(key, rounds, n_rays):
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-8)


def _models(field):
    kw = {**SMALL, **FIELDS[field]}
    jcfg, tcfg = jsem.SemanticNerfWConfig(**kw), tsem.SemanticNerfWConfig(**kw)
    jp = jsem.init(jax.random.PRNGKey(0), jcfg)
    # transient heads with some spread: at init the transient density is
    # ~softplus(-3) everywhere and the uncertainty ~softplus(0)
    jp = jax.tree_util.tree_map_with_path(
        lambda path, a: a + 0.3 * jax.random.normal(jax.random.PRNGKey(len(str(path))), a.shape)
        if "transient" in str(path) or "uncertainty" in str(path) else a, jp)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    return jcfg, tcfg, jp, tp


@pytest.mark.parametrize("field", ["hash", "fourier"])
def test_transient_forward_matches_jax(field):
    """Every output of the training forward with the transient path, to 1e-4
    of its scale; at eval the model is nerfacto's forward (no transient
    output)."""
    jcfg, tcfg, jp, tp = _models(field)
    n = 32
    jr, tr = _rays(n)
    key = jax.random.PRNGKey(5)
    jout = jax.jit(lambda p: jsem.forward(p, jcfg, jr, key=key, step=300, train=True))(jp)
    with torch.no_grad():
        tout = tsem.forward(tp, tcfg, tr, step=300, train=True,
                            jitters=_jitters(key, jcfg.num_proposal_iterations, n))
    assert set(KEYS) <= set(tout)
    assert tout["uncertainty"].shape == (n, 1) and tout["density_transient"].shape == (n, 8)
    assert float(tout["uncertainty"].min()) >= tcfg.uncertainty_min
    for k in KEYS:
        assert _rel(tout[k].numpy(), jout[k]) <= 1e-4, (k, _rel(tout[k].numpy(), jout[k]))
    with torch.no_grad():
        ev = tsem.forward(tp, tcfg, tr, step=300, train=False)
    assert "uncertainty" not in ev and "density_transient" not in ev


@pytest.mark.parametrize("field", ["hash", "fourier"])
def test_transient_loss_and_gradients_match_jax(field):
    """The loss with the transient terms (uncertainty_loss = 3 + mean log
    beta, density_loss, the beta-weighted rgb_loss in place of the masked
    one) beside the interlevel, distortion, semantic and depth terms: each
    to 1e-5; the gradient of every parameter, the transient heads and
    embedding included, to 2e-4 of its scale."""
    jcfg, tcfg, jp, tp = _models(field)
    n = 48
    jr, tr = _rays(n)
    batch = _batch(n)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        out = jsem.forward(p, jcfg, jr, key=key, step=300, train=True)
        return jsem.loss(jcfg, out, {k: jnp.asarray(v) for k, v in batch.items()}, train=True)

    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    out = tsem.forward(tp, tcfg, tr, step=300, train=True,
                       jitters=_jitters(key, jcfg.num_proposal_iterations, n))
    total, metrics = tsem.loss(tcfg, out, {k: torch.as_tensor(v) for k, v in batch.items()},
                               train=True)
    assert set(metrics) == set(jmetrics)
    assert {"uncertainty_loss", "density_loss", "rgb_loss", "semantics_loss",
            "depth_loss"} <= set(metrics)
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    total.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    seen = set()
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree.leaves(want)):
        if not t.requires_grad:
            assert t.grad is None and not j.any()
            continue
        assert t.grad is not None, path
        assert _rel(t.grad.numpy(), j.numpy()) <= 2e-4, (path, _rel(t.grad.numpy(), j.numpy()))
        seen.add(jax.tree_util.keystr(path))
    assert any("transient_emb" in p for p in seen) and any("uncertainty_head" in p for p in seen)


# ------------------------------------------------------ eval appearance fit

H, W = 47, 156
TINY = ["--model.hidden_dim", "16", "--model.hidden_dim_color", "16",
        "--model.hidden_dim_transient", "16", "--model.num_levels", "4",
        "--model.log2_hashmap_size", "10", "--model.base_res", "4", "--model.max_res", "32",
        "--model.proposal_num_levels", "2", "--model.proposal_log2_hashmap_size", "8",
        "--model.proposal_max_res", "16,32", "--model.num_proposal_samples_per_ray", "16,8",
        "--model.num_nerf_samples_per_ray", "8", "--datamanager.train_num_rays_per_batch", "64",
        "--datamanager.num_workers", "2", "--trainer.eval_num_rays_per_chunk", "4096",
        "--model.use_transient_embedding", "true", "--trainer.eval_fit_appearance_steps", "3"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jsk.write_dynamic_dataset(tmp_path_factory.mktemp("nerfw") / "scene", n_frames=8,
                                     h=H, w=W)


def _argv(scene, out):
    return TINY + ["--dataparser.data_dir", str(scene), "--dataparser.first_frame", "0",
                   "--dataparser.last_frame", "8", "--dataparser.train_split_fraction", "0.75",
                   "--dataparser.image_height", str(H), "--dataparser.image_width", str(W),
                   "--trainer.output_dir", str(out), "--dataparser.semantics_dir",
                   str(scene / "sem"), "--dataparser.mask_dir", str(scene / "mask"),
                   "--dataparser.depth_unit_scale_factor", "1.0"]


@pytest.fixture(scope="module")
def trainers(scene, tmp_path_factory):
    """semantic-nerfw as registered (hash field, appearance embedding 32)
    with the transient embedding and 3 fit steps, in both packages, from the
    same parameters."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jtrainer_mod, "make_mesh", lambda *a: make_mesh(jax.devices()[:1]))
    argv = _argv(scene, tmp_path_factory.mktemp("out"))
    ov = dict(zip([a[2:] for a in argv[::2]], argv[1::2]))
    jt = jcli.build_trainer(jcli.apply_overrides(jcli.method_registry["semantic-nerfw"](), ov))
    tt = tcli.build_trainer(tcli.apply_overrides(tcli.method_registry["semantic-nerfw"](), ov),
                            device="cpu")
    tree_copy_(tt.params, jax.tree.map(np.array, jt.params))
    jt.step = tt.step = 3
    yield jt, tt
    mp.undo()


def test_fit_eval_appearance_matches_jax(trainers):
    """Three Adam steps on the left half of eval image 1: the fitted row of
    the appearance table to 1e-4 of its scale (every other row unchanged),
    and eval_image's fit_psnr and fit_psnr_right to 1e-4, beside psnr and
    psnr_right."""
    jt, tt = trainers
    assert tt.model_config.appearance_embedding_dim == 32 and tt.model_config.num_images == 6
    p_l, cams_l = jt._local_render_state(jt.eval_cameras)
    jfit, _ = jt.fit_eval_appearance(1, p_l, cams_l)
    tfit, mcfg = tt.fit_eval_appearance(1)
    assert not mcfg.use_average_appearance_embedding
    jrow = np.asarray(jfit["fields"]["appearance_emb"])
    trow = tfit["fields"]["appearance_emb"].numpy()
    before = tt.params["fields"]["appearance_emb"].detach().numpy()
    assert _rel(trow[1], jrow[1]) <= 1e-4
    assert np.abs(trow[1] - before.mean(0)).max() > 1e-3  # the row moved from the mean
    np.testing.assert_array_equal(np.delete(trow, 1, 0), np.delete(before, 1, 0))
    jm, tm = jt.eval_image(1, write_images=False), tt.eval_image(1, write_images=False)
    assert {"fit_psnr", "fit_psnr_right", "psnr", "psnr_right"} <= set(tm)
    for k in ("fit_psnr", "fit_psnr_right", "psnr", "psnr_right"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, err_msg=k)
    assert tt.params["fields"]["appearance_emb"].grad is None  # the model itself is untouched


def test_fit_eval_appearance_guard_and_off(trainers):
    """An image index past the table's rows skips the fit in both packages
    (None); with 0 steps the protocol is off and eval_image has no fit
    metrics."""
    jt, tt = trainers
    p_l, cams_l = jt._local_render_state(jt.eval_cameras)
    n = tt.model_config.num_images
    assert jt.fit_eval_appearance(n, p_l, cams_l) is None
    assert tt.fit_eval_appearance(n) is None
    steps = tt.config.eval_fit_appearance_steps
    tt.config.eval_fit_appearance_steps = 0
    try:
        assert tt.fit_eval_appearance(0) is None
        assert "fit_psnr" not in tt.eval_image(0, write_images=False)
    finally:
        tt.config.eval_fit_appearance_steps = steps
