"""Port vs JAX package, the semantics branch and the supervision losses on the
CPU in f32: depth and semantic losses, image metrics, the plain MLP heads,
the split field (forward and every parameter's gradient) and the nerfacto and
semantic-nerfw losses with depth, masks and semantics. JAX runs its fused
Pallas path in interpret mode (NKT_FUSED=1); the port is handed the jitter
JAX draws from its keys."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.models import fields as jfields
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu.models import semantic_nerfw as jsem
from nerf_kbs_tpu.ops import losses as jL
from nerf_kbs_tpu.ops import metrics as jM
from nerf_kbs_tpu.ops import mlp as jmlp
from nerf_kbs_tpu.ops.encoding import FourierEncodingConfig as JFourier
from nerf_kbs_tpu.ops.encoding import fourier_window as j_window
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import fields as tfields
from nerf_kbs_tpu_torch.models import nerfacto as tnerf
from nerf_kbs_tpu_torch.models import semantic_nerfw as tsem
from nerf_kbs_tpu_torch.ops import losses as tL
from nerf_kbs_tpu_torch.ops import metrics as tM
from nerf_kbs_tpu_torch.ops import mlp as tmlp
from nerf_kbs_tpu_torch.ops.encoding import FourierEncodingConfig as TFourier
from nerf_kbs_tpu_torch.ops.encoding import fourier_window as t_window

SMALL = dict(
    num_images=3, field_type="fourier", fourier_num_levels=2, fourier_features_per_level=8,
    proposal_fourier_features_per_level=4, proposal_num_levels=2, hidden_dim=16,
    hidden_dim_color=16, base_res=4, max_res=32, proposal_max_res=(16, 32),
    num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8, fourier_basis="tri",
    stop_grad_sampling=True, interlevel_ray_fraction=0.5, appearance_embedding_dim=0,
    use_semantic=True, num_semantic_classes=4, use_depth=True, use_mask=True,
)


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("NKT_FUSED", "1")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-8)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol * max(float(np.abs(np.asarray(want)).max()), 1.0))


# ----------------------------------------------------------------- losses


@pytest.mark.parametrize("masked", [False, True])
def test_depth_losses_match_jax(masked):
    rng = np.random.default_rng(0)
    pred = rng.uniform(0.5, 3.0, (40, 1)).astype(np.float32)
    gt = (2.0 * pred + 0.3 + rng.normal(0, 0.05, pred.shape)).astype(np.float32)
    mask = (rng.random((40, 1)) > 0.3).astype(np.float32) if masked else None
    tm = None if mask is None else torch.as_tensor(mask)
    jm = None if mask is None else jnp.asarray(mask)
    for tf, jf in ((tL.monodepth_loss, jL.monodepth_loss),
                   (tL.euclidean_depth_loss, jL.euclidean_depth_loss)):
        _close(tf(torch.as_tensor(pred), torch.as_tensor(gt), tm),
               jf(jnp.asarray(pred), jnp.asarray(gt), jm), 1e-5)
    m = np.ones((2, 40), np.float32) if mask is None else np.stack([mask[:, 0]] * 2)
    p2, g2 = np.stack([pred[:, 0], pred[::-1, 0]]), np.stack([gt[:, 0], gt[:, 0]])
    for a, b in zip(tL.normalized_depth_scale_and_shift(*map(torch.as_tensor, (p2, g2, m))),
                    jL.normalized_depth_scale_and_shift(*map(jnp.asarray, (p2, g2, m)))):
        _close(a, b, 1e-5)
    # a degenerate system (one pixel): scale and shift 0, as in JAX
    one = np.zeros((1, 40), np.float32)
    one[0, 3] = 1.0
    for a in tL.normalized_depth_scale_and_shift(torch.as_tensor(p2[:1]), torch.as_tensor(g2[:1]),
                                                 torch.as_tensor(one)):
        assert float(a) == 0.0


def test_semantic_losses_match_jax():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 2, (50, 5)).astype(np.float32)
    labels = rng.integers(0, 5, 50).astype(np.int32)
    _close(tL.semantic_loss(torch.as_tensor(logits), torch.as_tensor(labels)),
           jL.semantic_loss(jnp.asarray(logits), jnp.asarray(labels)), 1e-5)
    colors = rng.random((6, 3)).astype(np.float32)
    pix = np.clip(colors[rng.integers(0, 6, 30)] + rng.normal(0, 0.05, (30, 3)), 0, 1)
    pix = pix.astype(np.float32)
    np.testing.assert_array_equal(
        tL.colors_to_labels(torch.as_tensor(pix), torch.as_tensor(colors)).numpy(),
        np.asarray(jL.colors_to_labels(jnp.asarray(pix), jnp.asarray(colors))))


def test_image_metrics_match_jax():
    rng = np.random.default_rng(2)
    gt = rng.random((37, 52, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.1, gt.shape), 0, 1).astype(np.float32)
    mask = rng.random((37, 52)) > 0.4
    tp, tg = torch.as_tensor(pred), torch.as_tensor(gt)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    _close(tM.psnr(tp, tg), jM.psnr(jp, jg), 1e-5)
    _close(tM.masked_psnr(tp, tg, torch.as_tensor(mask)), jM.masked_psnr(jp, jg, jnp.asarray(mask)),
           1e-5)
    _close(tM.masked_psnr(tp, tg, torch.as_tensor(mask[..., None].astype(np.float32))),
           jM.masked_psnr(jp, jg, jnp.asarray(mask[..., None].astype(np.float32))), 1e-5)
    _close(tM.ssim(tp, tg), jM.ssim(jp, jg), 1e-5)
    assert abs(float(tM.ssim(tg, tg)) - 1.0) < 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_mlp_heads_match_jax(dtype):
    """mlp_apply_t and mlp_apply: inputs and hidden activations cast to the
    compute dtype, f32 accumulation, f32 bias; the sigmoid head."""
    rng = np.random.default_rng(3)
    for out_act in (None, "sigmoid"):
        jc = jmlp.MLPConfig(in_dim=31, num_layers=3, layer_width=16, out_dim=3,
                            out_activation=out_act, compute_dtype=dtype)
        tc = tmlp.MLPConfig(in_dim=31, num_layers=3, layer_width=16, out_dim=3,
                            out_activation=out_act, compute_dtype=dtype)
        jp = jmlp.mlp_init(jax.random.PRNGKey(0), jc)
        jp["b"] = [b + 0.1 for b in jp["b"]]
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        x = rng.normal(size=(31, 70)).astype(np.float32)
        tol = 1e-5 if dtype == "float32" else 1e-3  # bf16: f32 sums in other orders
        _close(tmlp.mlp_apply_t(tp, torch.as_tensor(x), tc),
               jmlp.mlp_apply_t(jp, jnp.asarray(x), jc), tol)
        _close(tmlp.mlp_apply(tp, torch.as_tensor(x.T), tc), jmlp.mlp_apply(jp, jnp.asarray(x.T), jc),
               tol)


# ------------------------------------------------------------ split field


def _field_cfgs():
    kw = dict(num_levels=3, features_per_level=8, base_resolution=4, max_resolution=64,
              basis="tri")
    fk = dict(encoding="fourier", hidden_dim=16, num_layers=3, hidden_dim_color=16,
              appearance_embedding_dim=4, num_images=3, use_semantics=True,
              num_semantic_classes=5, hidden_dim_semantics=8)
    return (jfields.NerfactoFieldConfig(fourier=JFourier(**kw), **fk),
            tfields.NerfactoFieldConfig(fourier=TFourier(**kw), **fk))


def _field_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x_t = (rng.normal(size=(3, 6, 5)) * 2.0).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = np.array([[0], [2], [1], [0], [1], [2]], np.int32)
    cot = {k: rng.normal(size=s).astype(np.float32)
           for k, s in (("density", (6, 5)), ("rgb_t", (3, 6, 5)), ("semantics_t", (5, 6, 5)))}
    return x_t, dirs, cams, cot


@pytest.mark.parametrize("train", [False, True])
def test_split_field_forward_and_gradients_match_jax(fused, train):
    """nerfacto_field_apply_t with semantics: the base MLP through the fused
    MLP kernel's path (kernel A forward, C backward), the rgb head on
    [geo; feats], the semantic head on geo with its gradient stopped; every
    output, and the gradient of every parameter of a random linear function
    of them, to 2e-4."""
    jn, tn = _field_cfgs()
    x_t, dirs, cams, cot = _field_inputs()
    jp = jfields.nerfacto_field_init(jax.random.PRNGKey(1), jn)
    jp["semantic_mlp"]["b"] = [b + 0.05 for b in jp["semantic_mlp"]["b"]]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)

    def jfun(p):
        out = jfields.nerfacto_field_apply_t(p, jn, jnp.asarray(x_t), jnp.asarray(dirs),
                                             jnp.asarray(cams), train=train,
                                             window=j_window(jn.fourier, 0.6), need_dx=False)
        return sum(jnp.sum(out[k] * cot[k]) for k in cot), out

    (jval, jout), jgrads = jax.value_and_grad(jfun, has_aux=True)(jp)
    tout = tfields.nerfacto_field_apply_t(tp, tn, torch.as_tensor(x_t), torch.as_tensor(dirs),
                                          torch.as_tensor(cams), train=train,
                                          window=t_window(tn.fourier, 0.6, "cpu"), need_dx=False)
    assert set(tout) == {"density", "rgb_t", "semantics_t"}
    for k in cot:
        assert _rel(tout[k].detach().numpy(), jout[k]) <= 2e-4, k
    sum(torch.sum(tout[k] * torch.as_tensor(v)) for k, v in cot.items()).backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    leaves = jax.tree_util.tree_leaves_with_path(tp)
    for (path, t), j in zip(leaves, jax.tree.leaves(want)):
        if not t.requires_grad:  # fourier_B
            assert t.grad is None and not j.any()
            continue
        if not j.any():  # the mean embedding at eval gets no gradient either way
            assert t.grad is None or not t.grad.any(), path
            continue
        assert _rel(t.grad.numpy(), j.numpy()) <= 2e-4, (path, _rel(t.grad.numpy(), j.numpy()))


def test_split_field_gradient_paths():
    """The rgb head sends a gradient into geo, so the base MLP's backward
    (kernel C on the card) gets one on all 16 output rows; the semantic head
    reads geo detached and sends none."""
    _, tn = _field_cfgs()
    x_t, dirs, cams, _ = _field_inputs(4)
    tp = tfields.nerfacto_field_init(tn, torch.Generator().manual_seed(0), "cpu")
    mark_trainable(tp)
    args = (torch.as_tensor(x_t), torch.as_tensor(dirs), torch.as_tensor(cams))
    out = tfields.nerfacto_field_apply_t(tp, tn, *args, train=True, need_dx=False)
    out["rgb_t"].sum().backward()
    dw = tp["base_mlp"]["w"][-1].grad  # (hidden, 1 + geo)
    assert not dw[:, 0].any()  # density takes no part here
    assert bool((dw[:, 1:].abs().sum(0) > 0).all())  # every geo row
    assert tp["semantic_mlp"]["w"][0].grad is None

    tp = tfields.nerfacto_field_init(tn, torch.Generator().manual_seed(0), "cpu")
    mark_trainable(tp)
    out = tfields.nerfacto_field_apply_t(tp, tn, *args, train=True, need_dx=False)
    out["semantics_t"].sum().backward()
    assert all(w.grad is None for w in tp["base_mlp"]["w"])
    assert all(w.grad is not None and w.grad.any() for w in tp["semantic_mlp"]["w"])


def test_split_field_refuses_zero_classes():
    _, tn = _field_cfgs()
    with pytest.raises(ValueError, match="num_semantic_classes"):
        tfields.nerfacto_field_init(dataclasses.replace(tn, num_semantic_classes=0),
                                    torch.Generator().manual_seed(0), "cpu")


# ------------------------------------------------------------ model losses


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


def _jitters(key, rounds, n_rays):
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


def _batch(n, seed=1):
    rng = np.random.default_rng(seed)
    return {"image": rng.random((n, 3)).astype(np.float32),
            "depth_image": rng.uniform(0.2, 2.0, (n, 1)).astype(np.float32),
            "mask": (rng.random((n, 1)) > 0.25).astype(np.float32),
            "semantics_label": rng.integers(0, 4, n).astype(np.int32)}


@pytest.mark.parametrize("model,change", [
    ("nerfacto", {}),
    ("nerfacto", {"is_euclidean_depth": True, "pass_semantic_gradients": True,
                  "appearance_embedding_dim": 4}),
    ("semantic_nerfw", {}),
    ("semantic_nerfw", {"use_mask": False, "fourier_basis": "sincos"}),
])
def test_model_loss_and_gradients_match_jax(fused, model, change):
    """The training loss with depth, mask and semantics through the split
    field, and the gradient of every parameter: loss terms to 1e-5, gradients
    to 2e-4."""
    jmod, tmod = (jnerf, tnerf) if model == "nerfacto" else (jsem, tsem)
    jcls = jnerf.NerfactoConfig if model == "nerfacto" else jsem.SemanticNerfWConfig
    tcls = tnerf.NerfactoConfig if model == "nerfacto" else tsem.SemanticNerfWConfig
    kw = {**SMALL, **change}
    jcfg, tcfg = jcls(**kw), tcls(**kw)
    jp = jmod.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    n = 48
    jr, tr = _rays(n)
    batch = _batch(n)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        out = jmod.forward(p, jcfg, jr, key=key, step=300, train=True)
        return jmod.loss(jcfg, out, {k: jnp.asarray(v) for k, v in batch.items()}, train=True)

    (jtotal, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    out = tmod.forward(tp, tcfg, tr, step=300, train=True,
                       jitters=_jitters(key, jcfg.num_proposal_iterations, n))
    assert out["semantics"].shape == (n, 4)
    total, metrics = tmod.loss(tcfg, out, {k: torch.as_tensor(v) for k, v in batch.items()},
                               train=True)
    assert set(metrics) == set(jmetrics)
    sem_key = "semantic_loss" if model == "nerfacto" else "semantics_loss"
    assert {sem_key, "depth_loss", "rgb_loss"} <= set(metrics)
    _close(float(total.detach()), float(jtotal), 1e-5)
    for k in metrics:
        _close(float(metrics[k].detach()), float(jmetrics[k]), 1e-5)
    total.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    seen = 0
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree.leaves(want)):
        if not t.requires_grad:
            assert t.grad is None and not j.any()
            continue
        assert t.grad is not None, path
        assert _rel(t.grad.numpy(), j.numpy()) <= 2e-4, (path, _rel(t.grad.numpy(), j.numpy()))
        seen += 1
    assert seen >= 20  # proposals, base, rgb and semantic heads


@pytest.mark.parametrize("stop_grad_sampling", [True, False])
def test_depth_term_gradient_paths_match_jax(fused, stop_grad_sampling):
    """The depth term reads the median depth, a sample midpoint picked by the
    cumulative weights, so its gradient reaches the sample positions alone:
    with detached sampling no parameter, else only the proposal networks
    (through the resampling). The same leaves in both packages, to 2e-4."""
    kw = {**SMALL, "stop_grad_sampling": stop_grad_sampling}
    jcfg, tcfg = jsem.SemanticNerfWConfig(**kw), tsem.SemanticNerfWConfig(**kw)
    jp = jsem.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    n = 48
    jr, tr = _rays(n)
    batch = _batch(n)
    key = jax.random.PRNGKey(3)

    def depth_term(p):
        out = jsem.forward(p, jcfg, jr, key=key, step=300, train=True)
        return jsem.loss(jcfg, out, {k: jnp.asarray(v) for k, v in batch.items()},
                         train=True)[1]["depth_loss"]

    jval, jgrads = jax.value_and_grad(depth_term)(jp)
    out = tsem.forward(tp, tcfg, tr, step=300, train=True,
                       jitters=_jitters(key, jcfg.num_proposal_iterations, n))
    term = tsem.loss(tcfg, out, {k: torch.as_tensor(v) for k, v in batch.items()},
                     train=True)[1]["depth_loss"]
    _close(float(term.detach()), float(jval), 1e-5)
    assert out["depth"].requires_grad == term.requires_grad == (not stop_grad_sampling)
    if term.requires_grad:
        term.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    reached = []
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree.leaves(want)):
        name = jax.tree_util.keystr(path)
        got = t.grad is not None and bool(t.grad.any())
        assert got == bool(j.any()), name
        if got:
            assert _rel(t.grad.numpy(), j.numpy()) <= 2e-4, (name, _rel(t.grad.numpy(), j.numpy()))
            reached.append(name)
    assert all("proposal_networks" in name for name in reached), reached
    assert bool(reached) == (not stop_grad_sampling)


def test_eval_loss_and_masked_psnr(fused):
    """At eval semantic-nerfw still scores the semantic term and a masked
    PSNR; nerfacto scores the rgb term only."""
    tcfg = tsem.SemanticNerfWConfig(**SMALL)
    tp = tsem.init(tcfg, seed=0, device="cpu")
    _, tr = _rays(16, seed=2)
    out = tsem.forward(tp, tcfg, tr, step=10, train=False)
    batch = {k: torch.as_tensor(v) for k, v in _batch(16, seed=4).items()}
    _, m = tsem.loss(tcfg, out, batch, train=False)
    assert set(m) == {"psnr", "rgb_loss", "semantics_loss"}
    want = float(tM.masked_psnr(out["rgb"], batch["image"], batch["mask"][..., 0]))
    assert float(m["psnr"]) == pytest.approx(want)
    _, m = tnerf.loss(tnerf.NerfactoConfig(**SMALL), out, batch, train=False)
    assert set(m) == {"psnr", "rgb_loss"}


def test_transient_embedding_raises():
    """The transient path is ported (held against JAX in
    tests/test_torch_transient.py): init makes the transient heads, the
    training forward gives the uncertainty and the eval forward is
    nerfacto's. Nothing raises any more: with flow_loss_mult set, the
    transient training forward and loss run and match JAX's, whose
    semantic-nerfw loss has no flow term."""
    cfg = tsem.SemanticNerfWConfig(**SMALL, use_transient_embedding=True)
    params = tsem.init(cfg, device="cpu")
    assert {"transient_emb", "transient_mlp", "uncertainty_head"} <= set(params["fields"])
    _, tr = _rays(4)
    out = tsem.forward(params, cfg, tr, train=True, generator=torch.Generator().manual_seed(0))
    assert out["uncertainty"].shape == (4, 1)
    assert "uncertainty" not in tsem.forward(params, cfg, tr, train=False)
    kw = dict(SMALL, use_transient_embedding=True, flow_loss_mult=0.1)
    jcfg, tcfg = jsem.SemanticNerfWConfig(**kw), tsem.SemanticNerfWConfig(**kw)
    jp = jsem.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    jr, tr = _rays(16, seed=2)
    batch = _batch(16)
    key = jax.random.PRNGKey(1)
    _, jm = jax.jit(lambda p: jsem.loss(jcfg, jsem.forward(p, jcfg, jr, key=key, step=900,
                                                           train=True),
                                        {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    with torch.no_grad():
        tout = tsem.forward(tp, tcfg, tr, step=900, train=True,
                            jitters=_jitters(key, jcfg.num_proposal_iterations, 16))
        _, tm = tsem.loss(tcfg, tout, {k: torch.as_tensor(v) for k, v in batch.items()})
    assert set(tm) == set(jm) and "flow_loss" not in tm
    for k in tm:
        _close(float(tm[k]), float(jm[k]), 1e-4)
