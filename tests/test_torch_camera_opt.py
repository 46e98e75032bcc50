"""Port vs JAX package, the camera optimizer on the CPU in f32: every rigid
transform with its gradient (at tangent 0 exactly too), ``generate_rays``
with per-camera pose deltas, the loss and the whole ``camera_opt`` gradient
of a training forward on the fused path (where the backward kernels' dx
branches now run) and on the hash path, three ``build_trainer`` steps of
``nerfacto-tpu --model.camera_optimizer SO3xR3`` and of ``semantic-nerfw``
with it, and a checkpoint round trip of the tangents and their Adam state.
JAX runs its fused Pallas path in interpret mode (NKT_FUSED=1); the port is
handed the jitter JAX draws from its keys."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.cameras import transforms as jtf
from nerf_kbs_tpu.data.outputs import DataparserOutputs as JOutputs
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu.models import semantic_nerfw as jsem
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.cameras import transforms as ttf
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs as TOutputs
from nerf_kbs_tpu_torch.data.synthetic import orbit_cameras
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.engine.optimizers import tree_leaves
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import nerfacto as tnerf
from nerf_kbs_tpu_torch.models import semantic_nerfw as tsem
from tests.test_torch_cli import (  # noqa: F401  (scene: a module fixture)
    TINY,
    TINY_HASH,
    _overrides,
    _steps_track_jax,
    _supervision,
    _window,
    scene,
)

FIELDS = {
    "fourier": dict(field_type="fourier", fourier_num_levels=2, fourier_features_per_level=8,
                    proposal_fourier_features_per_level=4, proposal_num_levels=2,
                    fourier_basis="tri"),
    "hash": dict(field_type="hash", num_levels=4, log2_hashmap_size=10, proposal_num_levels=2,
                 proposal_log2_hashmap_size=8),
}
SMALL = dict(num_images=3, hidden_dim=16, hidden_dim_color=16, base_res=4, max_res=32,
             proposal_max_res=(16, 32), num_proposal_samples_per_ray=(16, 8),
             num_nerf_samples_per_ray=8, camera_optimizer="SO3xR3")


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def _tangents(n, zero_rows=(), scale=0.05, seed=0):
    t = (np.random.default_rng(seed).normal(size=(n, 6)) * scale).astype(np.float32)
    t[list(zero_rows)] = 0.0
    return t


# each transform with its input width; the camera optimizer's maps also at 0
TRANSFORMS = [
    ("euler2mat", 3, {}), ("quat2mat", 4, {}), ("skew", 3, {}),
    ("pose_vec2mat", 6, {"rotation_mode": "euler"}),
    ("pose_vec2mat", 6, {"rotation_mode": "quat"}),
    ("pose_vec2mat", 7, {"rotation_mode": "quat"}),
    ("pose_vec2mat", 6, {"rotation_mode": "axisangle"}),
    ("exp_map_so3", 3, {}), ("exp_map_se3", 6, {}), ("compose_se3", None, {}),
]


@pytest.mark.parametrize("name,width,kw", TRANSFORMS)
def test_transforms_match_jax_with_gradients(name, width, kw):
    """Values and the gradient of a random linear functional of the output,
    on random inputs with some rows at 0 exactly (and near it, inside the
    Taylor branch): both finite and equal there."""
    rng = np.random.default_rng(1)
    if name == "compose_se3":
        args = [np.asarray(jtf.exp_map_se3(jnp.asarray(_tangents(5, (0,), 0.5, s))))
                for s in (2, 3)]
    else:
        x = (rng.normal(size=(6, width)) * 0.7).astype(np.float32)
        x[0] = 0.0
        x[1] *= 1e-5  # theta^2 < 1e-8: the Taylor branch
        if name == "quat2mat" or kw.get("rotation_mode") == "quat":
            x[0, 3 if width == 7 else 0] = 1.0  # a quaternion of norm 0 has no rotation
        args = [x]
    jfn, tfn = getattr(jtf, name), getattr(ttf, name)
    want = np.asarray(jfn(*map(jnp.asarray, args), **kw))
    w = rng.normal(size=want.shape).astype(np.float32)
    jgrads = jax.grad(lambda *a: jnp.sum(jfn(*a, **kw) * w), argnums=tuple(range(len(args))))(
        *map(jnp.asarray, args))
    targs = [torch.tensor(a, requires_grad=True) for a in args]
    got = tfn(*targs, **kw)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5, atol=1e-6)
    torch.sum(got * torch.as_tensor(w)).backward()
    for t, j in zip(targs, jgrads):
        assert torch.isfinite(t.grad).all()
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-5, atol=1e-5)


def _cameras(n=3, h=10, w=12):
    cams_np = orbit_cameras(n, h=h, w=w)
    box = np.array([[-1.0] * 3, [1.0] * 3])
    return JOutputs([], cams_np, box).cameras(), TOutputs([], cams_np, box).cameras("cpu")


def _indices(n_rays, n_cams=3, h=10, w=12, seed=4):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, n_cams, n_rays), rng.integers(0, h, n_rays),
                     rng.integers(0, w, n_rays)], -1).astype(np.int32)


@pytest.mark.parametrize("zero", [False, True])
def test_generate_rays_with_delta_matches_jax(zero):
    """Origins, directions, the pixel area and directions_norm through
    c2w' = delta . c2w, and the gradient of a functional of the rays with
    respect to the tangents that make the delta (from 0 exactly too)."""
    jc, tc = _cameras()
    idx = _indices(40)
    tang = _tangents(3) * (0.0 if zero else 1.0)
    wo, wd = (np.random.default_rng(5).normal(size=(40, 3)).astype(np.float32) for _ in range(2))

    def jf(t):
        r = jcam.generate_rays(jc, jnp.asarray(idx), c2w_delta=jtf.exp_map_se3(t))
        return jnp.sum(r.origins * wo) + jnp.sum(r.directions * wd), r

    (_, jr), jg = jax.jit(jax.value_and_grad(jf, has_aux=True))(jnp.asarray(tang))
    tt = torch.tensor(tang, requires_grad=True)
    tr = tcam.generate_rays(tc, torch.as_tensor(idx), c2w_delta=ttf.exp_map_se3(tt))
    for k in ("origins", "directions", "pixel_area", "directions_norm"):
        np.testing.assert_allclose(getattr(tr, k).detach().numpy(), np.asarray(getattr(jr, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    (torch.sum(tr.origins * torch.as_tensor(wo))
     + torch.sum(tr.directions * torch.as_tensor(wd))).backward()
    assert torch.isfinite(tt.grad).all() and float(tt.grad[:, 3:].abs().max()) > 0
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(jg), rtol=1e-5, atol=1e-5)
    # without a delta the rays are the plain ones, and tangent 0 is the identity
    plain = tcam.generate_rays(tc, torch.as_tensor(idx))
    if zero:
        assert torch.equal(plain.origins, tr.origins.detach())
        assert torch.equal(plain.directions, tr.directions.detach())


@pytest.mark.parametrize("field,zero", [("fourier", False), ("fourier", True), ("hash", False)])
def test_camera_opt_loss_and_gradient_match_jax(monkeypatch, field, zero):
    """jax.value_and_grad of loss . forward . generate_rays(delta) against
    the port's backward, the tangents random or 0 exactly: the loss, its
    terms (the regularizer among them) and the camera_opt gradient,
    translation and rotation each to 1e-4 of its largest magnitude. On the
    fused path every backward kernel runs its dx branch, and the rotation
    reaches the field's SH features through the directions."""
    if field == "fourier":
        monkeypatch.setenv("NKT_FUSED", "1")
    kw = {**SMALL, **FIELDS[field], "stop_grad_sampling": True, "appearance_embedding_dim": 0}
    jcfg, tcfg = jnerf.NerfactoConfig(**kw), tnerf.NerfactoConfig(**kw)
    assert tnerf.uses_fused_path(tcfg) == (field == "fourier")
    jp = jnerf.init(jax.random.PRNGKey(0), jcfg)
    assert jp["camera_opt"].shape == (3, 6) and not np.asarray(jp["camera_opt"]).any()
    jp["camera_opt"] = jnp.asarray(_tangents(3, scale=0.0 if zero else 0.03))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    jc, tc = _cameras()
    n = 48
    idx = _indices(n)
    image = np.random.default_rng(1).random((n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        rays = jcam.generate_rays(jc, jnp.asarray(idx), c2w_delta=jnerf.camera_deltas(p))
        out = jnerf.forward(p, jcfg, rays, key=key, step=300, train=True)
        return jnerf.loss(jcfg, out, {"image": jnp.asarray(image)}, train=True)

    (jtotal, jm), jg = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    rays = tcam.generate_rays(tc, torch.as_tensor(idx), c2w_delta=tnerf.camera_deltas(tp))
    jit = [torch.tensor(np.array(jax.random.uniform(k, (n, 1))))
           for k in jax.random.split(key, 3)]
    out = tnerf.forward(tp, tcfg, rays, step=300, train=True, jitters=jit)
    assert out["_camera_opt_tangent"] is tp["camera_opt"]
    total, tm = tnerf.loss(tcfg, out, {"image": torch.as_tensor(image)}, train=True)
    total.backward()
    assert set(tm) == set(jm) and "camera_opt_regularizer" in tm
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-4, atol=1e-9,
                                   err_msg=k)
    got, want = tp["camera_opt"].grad.numpy(), np.asarray(jg["camera_opt"])
    assert np.isfinite(got).all()
    for part, cols in (("translation", slice(0, 3)), ("rotation", slice(3, 6))):
        assert np.abs(want[:, cols]).max() > 0, part
        assert _rel(got[:, cols], want[:, cols]) <= 1e-4, (part, _rel(got[:, cols],
                                                                      want[:, cols]))


def test_camera_opt_direction_term_reaches_the_field(monkeypatch):
    """The rotation gradient's direction term: on the fused path the SH
    features are built from the rays' directions, so a delta that only
    rotates moves the field's colour; with the directions detached the
    rotation gradient changes (the term is not lost)."""
    monkeypatch.setenv("NKT_FUSED", "1")
    cfg = tnerf.NerfactoConfig(**{**SMALL, **FIELDS["fourier"], "stop_grad_sampling": True,
                                  "appearance_embedding_dim": 0, "camera_opt_rot_penalty": 0.0,
                                  "camera_opt_trans_penalty": 0.0})
    params = tnerf.init(cfg, seed=0, device="cpu")
    mark_trainable(params)
    _, tc = _cameras()
    idx = torch.as_tensor(_indices(32))
    grads = []
    for detach in (False, True):
        params["camera_opt"].grad = None
        rays = tcam.generate_rays(tc, idx, c2w_delta=tnerf.camera_deltas(params))
        if detach:
            rays = dataclasses.replace(rays, directions=rays.directions.detach())
        out = tnerf.forward(params, cfg, rays, step=10, train=True,
                            generator=torch.Generator().manual_seed(0))
        torch.sum(out["rgb"]).backward()
        grads.append(params["camera_opt"].grad[:, 3:].clone())
    assert float(grads[0].abs().max()) > 0
    assert not torch.allclose(grads[0], grads[1])


@pytest.mark.parametrize("method", ["nerfacto-tpu", "semantic-nerfw"])
def test_build_trainer_camera_opt_steps_track_jax(scene, tmp_path, monkeypatch, method):
    """Three steps against JAX: nerfacto-tpu (the fused path, dx in every
    backward kernel) and semantic-nerfw as registered (hash field, depth,
    semantics, masks), each with --model.camera_optimizer SO3xR3: the
    camera_opt Adam group (6e-4 decaying to 6e-6), the rays made in the step
    from the tangents, the regularizer among the metrics; every parameter,
    the tangents included, tracks JAX's."""
    argv = TINY + ["--trainer.output_dir", str(tmp_path), "--model.camera_optimizer", "SO3xR3"]
    argv += _window(scene, tmp_path)
    if method == "nerfacto-tpu":
        monkeypatch.setenv("NKT_FUSED", "1")
    else:
        argv += TINY_HASH + _supervision(scene)
    tt = _steps_track_jax(method, argv, monkeypatch)
    assert tt.optimizer.configs["camera_opt"].lr == 6e-4
    assert tt.optimizer.configs["camera_opt"].lr_final == 6e-6
    assert tuple(tt.params["camera_opt"].shape) == (6, 6)
    assert float(tt.params["camera_opt"].detach().abs().max()) > 0  # the tangents moved
    assert tnerf.uses_fused_path(tt.model_config) == (method == "nerfacto-tpu")


def test_camera_opt_checkpoint_round_trip(scene, tmp_path):
    """The tangents and their Adam moments and count go into the checkpoint
    and come back; eval renders use the dataparser's cameras (no delta)."""
    argv = (TINY + TINY_HASH + _window(scene, tmp_path)
            + ["--model.camera_optimizer", "SO3xR3", "--trainer.output_dir", str(tmp_path)])
    spec = tcli.apply_overrides(tcli.method_registry["nerfacto"](), _overrides(argv))
    tr = tcli.build_trainer(spec, device="cpu")
    for s in range(2):
        tr.train_step(tr._to_device(tr.dm.next_train(s)))
    tr.save_checkpoint()
    moved = tr.params["camera_opt"].detach().clone()
    assert float(moved.abs().max()) > 0
    back = tcli.build_trainer(dataclasses.replace(spec, trainer=dataclasses.replace(
        spec.trainer, load_dir=str(tr.out_dir), experiment_name="reloaded")), device="cpu")
    assert back.step == 2 and torch.equal(back.params["camera_opt"], moved)
    for a, b in zip(tree_leaves(back.optimizer.state["camera_opt"]),
                    tree_leaves(tr.optimizer.state["camera_opt"])):
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    assert back.optimizer.state["camera_opt"]["count"] == 2
    assert torch.equal(back.eval_cameras.c2w, tr.eval_cameras.c2w)


def test_semantic_nerfw_camera_deltas_and_regularizer():
    """semantic_nerfw shares nerfacto's camera_deltas and adds the same
    regularizer in its loss; its transient training forward gives no
    tangents, so no regularizer (as in the JAX package)."""
    assert tsem.camera_deltas is tnerf.camera_deltas and jsem.camera_deltas is jnerf.camera_deltas
    t = torch.as_tensor(_tangents(3))
    cfg = tsem.SemanticNerfWConfig(**{**SMALL, **FIELDS["hash"]})
    want = (cfg.camera_opt_trans_penalty * torch.mean(torch.sum(t[:, :3] ** 2, -1))
            + cfg.camera_opt_rot_penalty * torch.mean(torch.sum(t[:, 3:] ** 2, -1)))
    reg = tnerf.camera_opt_regularizer(cfg, {"_camera_opt_tangent": t})
    assert torch.equal(reg["camera_opt_regularizer"], want)
    assert tnerf.camera_opt_regularizer(cfg, {}) == {}
    off = dataclasses.replace(cfg, camera_opt_trans_penalty=0.0, camera_opt_rot_penalty=0.0)
    assert tnerf.camera_opt_regularizer(off, {"_camera_opt_tangent": t}) == {}
