"""Port vs JAX package, the training slice on the CPU in f32: loss and
gradients of one nerfacto training forward, and a few trainer steps on the
synthetic sphere scene. JAX runs its fused Pallas path in interpret mode
(NKT_FUSED=1); the port is handed the jitter JAX draws from its keys."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.data.synthetic import SyntheticDataManager as JDataManager
from nerf_kbs_tpu.engine import optimizers as jopt
from nerf_kbs_tpu.methods import nerfacto_tpu_method as j_method
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager as TDataManager
from nerf_kbs_tpu_torch.engine import optimizers as topt
from nerf_kbs_tpu_torch.engine.trainer import Trainer, TrainerConfig, mark_trainable
from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method as t_method
from nerf_kbs_tpu_torch.models import nerfacto as tnerf

SMALL = dict(
    num_images=3, field_type="fourier", fourier_num_levels=2, fourier_features_per_level=8,
    proposal_fourier_features_per_level=4, proposal_num_levels=2, hidden_dim=16,
    hidden_dim_color=16, base_res=4, max_res=32, proposal_max_res=(16, 32),
    num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8, fourier_basis="tri",
)


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("NKT_FUSED", "1")


def _rays(n, seed=0):
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
    tr = tcam.RayBundle(origins=torch.as_tensor(o), directions=torch.as_tensor(d),
                        camera_indices=torch.as_tensor(cam),
                        **{k: torch.as_tensor(v) for k, v in kw.items()})
    return jr, tr


def _jitters(key, rounds, n_rays):
    """What jnerf.forward draws from ``key``: one (R, 1) uniform per sampler
    call, from the key split rounds + 1 ways."""
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-8)


@pytest.mark.parametrize("change", [
    dict(stop_grad_sampling=True, interlevel_ray_fraction=0.5, appearance_embedding_dim=0),
    dict(stop_grad_sampling=False, appearance_embedding_dim=0),
    dict(stop_grad_sampling=True, appearance_embedding_dim=4, fourier_basis="sincos",
         background_color="white"),
])
def test_loss_and_gradients_match_jax(fused, change):
    """jax.value_and_grad(loss . forward) against the port's backward on the
    same parameters, rays, targets and jitter: the flagship's settings, the
    sampler left differentiable (which exercises dx and the bracket
    gradient), and per-camera appearance rows (which exercises dfeats)."""
    kw = {**SMALL, **change}
    jcfg, tcfg = jnerf.NerfactoConfig(**kw), tnerf.NerfactoConfig(**kw)
    jp = jnerf.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    n = 48
    jr, tr = _rays(n)
    image = np.random.default_rng(1).random((n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        out = jnerf.forward(p, jcfg, jr, key=key, step=300, train=True)
        return jnerf.loss(jcfg, out, {"image": jnp.asarray(image)}, train=True)

    (jtotal, jmetrics), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(jp)
    out = tnerf.forward(tp, tcfg, tr, step=300, train=True,
                        jitters=_jitters(key, jcfg.num_proposal_iterations, n))
    total, metrics = tnerf.loss(tcfg, out, {"image": torch.as_tensor(image)}, train=True)
    total.backward()
    # f32 throughout: the same operations in another summation order
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-4)
    for k in ("rgb_loss", "interlevel_loss", "distortion_loss", "psnr"):
        np.testing.assert_allclose(float(metrics[k].detach()), float(jmetrics[k]), rtol=1e-3,
                                   atol=1e-7, err_msg=k)
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    seen = 0
    for path, t, j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree.leaves(tp),
                          jax.tree.leaves(want)):
        if not t.requires_grad:  # fourier_B: no gradient here, zeros in JAX
            assert t.grad is None and not j.any()
            continue
        assert t.grad is not None, path[0]
        assert _rel(t.grad.numpy(), j.numpy()) <= 2e-3, (path[0], _rel(t.grad.numpy(), j.numpy()))
        seen += int(j.abs().max() > 0)
    assert seen >= 16  # both proposal nets and both field chains learn


def test_train_forward_eval_outputs_and_history(fused):
    tcfg = tnerf.NerfactoConfig(**SMALL)
    tp = tnerf.init(tcfg, seed=0, device="cpu")
    _, tr = _rays(12)
    out = tnerf.forward(tp, tcfg, tr, step=10, train=True,
                        generator=torch.Generator().manual_seed(0))
    assert out["ray_samples"].starts.shape == (12, 8)
    assert [w.shape for _, w in out["proposal_history"]] == [(12, 16), (12, 8)]
    again = tnerf.forward(tp, tcfg, tr, step=10, train=True,
                          generator=torch.Generator().manual_seed(0))
    assert torch.equal(out["rgb"], again["rgb"])
    other = tnerf.forward(tp, tcfg, tr, step=10, train=True,
                          generator=torch.Generator().manual_seed(1))
    assert not torch.equal(out["rgb"], other["rgb"])
    total, metrics = tnerf.loss(tcfg, out, {"image": torch.zeros(12, 3)}, train=False)
    assert set(metrics) == {"psnr", "rgb_loss"} and float(total) == float(metrics["rgb_loss"])


def test_trainer_steps_track_jax(fused, tmp_path):
    """Three steps of the port's Trainer against the JAX train step (forward,
    loss, grad, per-group optax update) on the same synthetic batches, from
    the same parameters, with the registry's optimizers."""
    kw = {**SMALL, "stop_grad_sampling": True, "interlevel_ray_fraction": 0.5,
          "appearance_embedding_dim": 0, "num_images": 6}
    jcfg, tcfg = jnerf.NerfactoConfig(**kw), tnerf.NerfactoConfig(**kw)
    dm_kw = dict(num_cameras=6, h=16, w=16, rays_per_batch=64, seed=0, num_eval_cameras=2)
    jdm, tdm = JDataManager(**dm_kw), TDataManager(**dm_kw)
    spec = t_method()
    assert {g: dataclasses.asdict(c) for g, c in spec.optimizers.items()} == {
        g: dataclasses.asdict(c) for g, c in j_method().optimizers.items()}
    assert spec.datamanager.train_num_rays_per_batch == 4096

    trainer = Trainer(TrainerConfig(output_dir=str(tmp_path), seed=0, log_every=1,
                                    steps_per_save=1000, steps_per_eval_image=1000),
                      tcfg, spec.optimizers, tdm, device="cpu")
    jp = jnerf.init(jax.random.PRNGKey(0), jcfg)
    topt.tree_copy_(trainer.params, jax.tree.map(np.asarray, jp))
    jtx = jopt.build_optimizer(j_method().optimizers, jp)
    jstate = jtx.init(jp)
    base_key = jax.random.PRNGKey(1)

    @jax.jit
    def jstep(p, state, batch, key, step):
        def loss_fn(p_):
            rays = jcam.generate_rays(jdm.train_cameras, batch["ray_indices"])
            out = jnerf.forward(p_, jcfg, rays, key=key, step=step, train=True)
            return jnerf.loss(jcfg, out, batch, train=True)

        (total, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        upd, state = jtx.update(grads, state, p)
        return optax.apply_updates(p, upd), state, total

    for step in range(3):
        jb, tb = jdm.next_train(step), tdm.next_train(step)
        np.testing.assert_array_equal(jb["ray_indices"], tb["ray_indices"])
        np.testing.assert_array_equal(jb["image"], tb["image"])
        key = jax.random.fold_in(base_key, step)
        jp, jstate, jtotal = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in jb.items()}, key,
                                   jnp.asarray(step, jnp.float32))
        m = trainer.train_step({k: torch.as_tensor(v) for k, v in tb.items()},
                               jitters=_jitters(key, 2, 64))
        # Adam's first steps move every weight by ~lr whatever the gradient's
        # size, so small gradient differences show in the next loss: 1e-3
        np.testing.assert_allclose(float(m["total_loss"]), float(jtotal), rtol=1e-3)
    assert trainer.step == 3
    want = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for t, j in zip(jax.tree.leaves(trainer.params), jax.tree.leaves(want)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=2e-3)


def test_trainer_loop_logs_evaluates_and_resumes(tmp_path):
    tcfg = tnerf.NerfactoConfig(**{**SMALL, "stop_grad_sampling": True, "num_images": 4,
                                   "appearance_embedding_dim": 0})
    dm = TDataManager(num_cameras=4, h=12, w=12, rays_per_batch=48)
    spec = t_method()
    cfg = TrainerConfig(output_dir=str(tmp_path), log_every=4, steps_per_save=8,
                        steps_per_eval_image=8, steps_per_eval_batch=1000,
                        eval_num_rays_per_chunk=64)
    trainer = Trainer(cfg, tcfg, spec.optimizers, dm, device="cpu")
    frozen = trainer.params["fields"]["fourier_B"].clone()
    before = trainer.params["proposal_networks"][1]["mlp"]["w"][0].detach().clone()
    last = trainer.train(8)
    assert last["step"] == 8 and np.isfinite(last["total_loss"]) and last["rays_per_sec"] > 0
    assert torch.equal(trainer.params["fields"]["fourier_B"], frozen)
    assert not torch.equal(trainer.params["proposal_networks"][1]["mlp"]["w"][0], before)
    lines = (trainer.out_dir / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 3 and "eval_psnr" in lines[-1]
    em = trainer.eval_image(0)
    assert em["psnr"] > 0 and em["image_idx"] == 0
    batch = {"ray_indices": np.array([[0, 1, 2], [1, 3, 4]], np.int32),
             "image": np.ones((2, 3), np.float32)}
    assert np.isfinite(trainer.eval_batch(batch)["eval_batch_psnr"])

    resumed = Trainer(dataclasses.replace(cfg, load_dir=str(trainer.out_dir),
                                          experiment_name="resumed"),
                      tcfg, spec.optimizers, dm, device="cpu")
    assert resumed.step == 8 and resumed.optimizer.state["fields"]["count"] == 8
    for a, b in zip(jax.tree.leaves(resumed.params), jax.tree.leaves(trainer.params)):
        assert torch.equal(a, b)
    # the resumed run replays batches and jitter: one more step on each agrees
    b8 = {k: torch.as_tensor(v) for k, v in dm.next_train(8).items()}
    assert float(resumed.train_step(b8)["total_loss"]) == float(
        trainer.train_step(b8)["total_loss"])


def test_trainer_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dm = TDataManager(num_cameras=2, h=4, w=4, rays_per_batch=8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(TrainerConfig(output_dir=str(tmp_path)), tnerf.NerfactoConfig(**SMALL),
                t_method().optimizers, dm)
