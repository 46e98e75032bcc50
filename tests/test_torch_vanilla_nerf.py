"""Port vs JAX package, vanilla NeRF and what it needs, on the CPU in f32: the
MLP's skip connections, the ray-box collider (axis-parallel rays and misses
included), the inverse-CDF sampler that keeps the coarse edges, the model's
forward, loss and gradients with and without the temporal distortion, and
the AdamW and SGD updates against optax. The port is handed the jitter JAX
draws from its keys."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.engine import optimizers as jopt
from nerf_kbs_tpu.models import vanilla_nerf as jvan
from nerf_kbs_tpu.ops import mlp as jmlp
from nerf_kbs_tpu.ops import rendering as jR
from nerf_kbs_tpu.ops import samplers as jS
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.engine import optimizers as topt
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import vanilla_nerf as tvan
from nerf_kbs_tpu_torch.ops import mlp as tmlp
from nerf_kbs_tpu_torch.ops import rendering as tR
from nerf_kbs_tpu_torch.ops import samplers as tS

SMALL = dict(num_coarse_samples=8, num_importance_samples=8, pos_frequencies=4,
             dir_frequencies=2, mlp_num_layers=4, mlp_layer_width=32, skip_connections=(2,),
             temporal_distortion_layers=2, temporal_distortion_width=16)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-8)


def _rays(n, seed=0, times=True):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32)
    # aim most rays at the box: origin outside, direction to a point inside
    target = rng.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    aim = rng.random(n) < 0.75
    d[aim] = (target - o)[aim] / np.linalg.norm((target - o)[aim], axis=-1, keepdims=True)
    kw = dict(origins=o, directions=d, pixel_area=np.full((n, 1), 1e-4, np.float32),
              camera_indices=np.zeros((n, 1), np.int32),
              directions_norm=np.ones((n, 1), np.float32))
    if times:
        kw["times"] = rng.uniform(-1, 1, (n, 1)).astype(np.float32)
    return (jcam.RayBundle(**{k: jnp.asarray(v) for k, v in kw.items()}),
            tcam.RayBundle(**{k: torch.as_tensor(v) for k, v in kw.items()}))


@pytest.mark.parametrize("skips,dtype", [((2,), "float32"), ((1, 3), "float32"),
                                         ((2,), "bfloat16")])
def test_mlp_skip_connections_match_jax(skips, dtype):
    """A skip layer takes [h, x]: its weight has fan-in width + in_dim, in
    both layouts; the output (1e-5, bf16 1e-3) and every weight's gradient
    (1e-5, bf16 2e-3) match."""
    rng = np.random.default_rng(0)
    kw = dict(in_dim=9, num_layers=4, layer_width=16, out_dim=3, skip_connections=skips,
              compute_dtype=dtype)
    jc, tc = jmlp.MLPConfig(**kw), tmlp.MLPConfig(**kw)
    jp = jmlp.mlp_init(jax.random.PRNGKey(1), jc)
    jp["b"] = [b + 0.05 for b in jp["b"]]
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    ti = tmlp.mlp_init(tc, torch.Generator().manual_seed(0), "cpu")
    assert [w.shape for w in ti["w"]] == [tuple(w.shape) for w in jp["w"]]
    assert all(ti["w"][i].shape[0] == 16 + 9 for i in skips)
    x = rng.normal(size=(40, 9)).astype(np.float32)
    tol, gtol = (1e-5, 1e-5) if dtype == "float32" else (1e-3, 2e-3)
    jout, jvjp = jax.vjp(lambda p: jmlp.mlp_apply(p, jnp.asarray(x), jc), jp)
    mark_trainable(tp)
    tout = tmlp.mlp_apply(tp, torch.as_tensor(x), tc)
    assert _rel(tout.detach().numpy(), jout) <= tol
    g = rng.normal(size=tout.shape).astype(np.float32)
    (jg,) = jvjp(jnp.asarray(g))
    tout.backward(torch.as_tensor(g))
    for t, j in zip(tp["w"] + tp["b"], jg["w"] + jg["b"]):
        assert _rel(t.grad.numpy(), j) <= gtol
    xt = rng.normal(size=(9, 30)).astype(np.float32)
    assert _rel(tmlp.mlp_apply_t(tp, torch.as_tensor(xt), tc).detach().numpy(),
                jmlp.mlp_apply_t(jp, jnp.asarray(xt), jc)) <= tol


def test_aabb_box_collider_matches_jax():
    """Near and far of rays through, past and along the faces of the box,
    with direction components of exactly 0 and of +-1e-12 (both taken as
    +1e-10), and the near plane's clamp: bit for bit but for the division's
    rounding (1e-6 relative)."""
    jr, tr = _rays(200, seed=3, times=False)
    o, d = np.asarray(jr.origins).copy(), np.asarray(jr.directions).copy()
    o[:4] = [[0.0, 0.0, -3.0], [2.0, 0.0, 0.0], [0.5, 0.5, 0.5], [0.0, 3.0, 0.0]]
    d[:4] = [[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 0.0, 0.0]]  # last misses
    d[4] = [1e-12, -1e-12, 1.0]
    o[4] = [0.1, 0.1, -2.0]
    o[5], d[5] = [1.0, 1.0, -2.0], [0.0, 0.0, 1.0]  # along an edge of the box
    box = np.array([[-1.0] * 3, [1.0] * 3], np.float32)
    for near_plane in (0.0, 0.05, 2.5):
        jout = jR.aabb_box_collider(jr.replace(origins=jnp.asarray(o), directions=jnp.asarray(d)),
                                    jnp.asarray(box), near_plane=near_plane)
        tout = tR.aabb_box_collider(
            tcam.RayBundle(**{**tr.__dict__, "origins": torch.as_tensor(o),
                              "directions": torch.as_tensor(d)}),
            torch.as_tensor(box), near_plane=near_plane)
        for k in ("nears", "fars"):
            np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        miss = ~(np.asarray(jout.fars) > np.asarray(jout.nears) + 2e-4)[:, 0]
        assert miss[3] and np.all(tout.fars.numpy()[miss] == np.float32(near_plane + 1e-4))


def test_pdf_sampler_include_original_matches_jax():
    """Inverse-CDF samples from jittered quantiles (the same u in both),
    merged with the old edges and sorted: every distance to 2e-6 relative
    (1e-6 absolute; the cumulative sums round apart), and the gradient to
    the weights to 1e-4 of its scale."""
    rng = np.random.default_rng(4)
    jr, tr = _rays(24, seed=5, times=False)
    jr = jR.near_far_collider(jr, 0.1, 4.0)
    tr = tR.near_far_collider(tr, 0.1, 4.0)
    key = jax.random.PRNGKey(2)
    k1, k2 = jax.random.split(key)
    jc = jS.uniform_sampler(jr, 8, spacing="uniform", key=k1)
    tc = tS.uniform_sampler(tr, 8, spacing="uniform", jitter=torch.tensor(
        np.array(jax.random.uniform(k1, (24, 1)))))
    w = rng.random((24, 8)).astype(np.float32) ** 3
    jf, jvjp = jax.vjp(lambda ww: jS.pdf_sampler(jr, jc, ww, 10, spacing="uniform", key=k2,
                                                  include_original=True).starts, jnp.asarray(w))
    tw = torch.tensor(w, requires_grad=True)
    tf = tS.pdf_sampler(tr, tc, tw, 10, spacing="uniform", include_original=True,
                        rand=torch.tensor(np.array(jax.random.uniform(k2, (24, 1)))))
    assert tf.starts.shape == (24, 8 + 11)
    assert torch.all(tf.ends >= tf.starts)
    np.testing.assert_allclose(tf.starts.detach().numpy(), np.asarray(jf), rtol=2e-6, atol=1e-6)
    g = rng.normal(size=(24, 19)).astype(np.float32)
    (jg,) = jvjp(jnp.asarray(g))
    tf.starts.backward(torch.as_tensor(g))
    assert _rel(tw.grad.numpy(), jg) <= 1e-4


@pytest.mark.parametrize("distortion,collider", [(True, "aabb"), (False, "aabb"),
                                                 (True, "near_far")])
def test_vanilla_nerf_forward_loss_and_gradients_match_jax(distortion, collider):
    """The training forward (jittered coarse samples, importance samples
    merged with them), every output to 1e-4 of its scale; the coarse and fine
    losses to 1e-5; every parameter's gradient to 2e-4 of the largest
    gradient of its MLP (a bias gradient is a sum over every sample that
    cancels to a small value), the temporal distortion's included; the eval
    forward without jitter."""
    kw = dict(SMALL, enable_temporal_distortion=distortion, collider=collider, far_plane=6.0)
    jcfg, tcfg = jvan.VanillaNerfConfig(**kw), tvan.VanillaNerfConfig(**kw)
    jp = jvan.init(jax.random.PRNGKey(0), jcfg)
    if distortion:  # a warp that moves: the zero-initialised last layer, seeded
        td = jp["temporal_distortion"]
        td["w"][-1] = 0.05 * jax.random.normal(jax.random.PRNGKey(9), td["w"][-1].shape)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    assert set(tvan.param_groups(tp)) == set(jvan.param_groups(jp))
    n = 40
    jr, tr = _rays(n, seed=1)
    gt = np.random.default_rng(2).random((n, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jitters = [torch.tensor(np.array(jax.random.uniform(k, (n, 1))))
               for k in jax.random.split(key)]

    def loss_fn(p):
        out = jvan.forward(p, jcfg, jr, key=key, train=True)
        total, m = jvan.loss(jcfg, out, {"image": jnp.asarray(gt)})
        return total, (m, out)

    (jtotal, (jm, jout)), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(jp)
    tout = tvan.forward(tp, tcfg, tr, train=True, jitters=jitters)
    for k in ("rgb", "rgb_coarse", "accumulation", "depth", "weights"):
        assert _rel(tout[k].detach().numpy(), jout[k]) <= 1e-4, k
    assert tout["weights"].shape == (n, 8 + 9)
    total, tm = tvan.loss(tcfg, tout, {"image": torch.as_tensor(gt)})
    assert set(tm) == set(jm)
    for k in tm:
        np.testing.assert_allclose(float(tm[k].detach()), float(jm[k]), rtol=1e-5, err_msg=k)
    total.backward()
    want = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    scale = {}
    for path, j in jax.tree_util.tree_leaves_with_path(want):
        mlp = jax.tree_util.keystr(path[:-2])
        scale[mlp] = max(scale.get(mlp, 0.0), float(j.abs().max()))
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree.leaves(want)):
        err = float((t.grad - j).abs().max()) / scale[jax.tree_util.keystr(path[:-2])]
        assert err <= 2e-4, (path, err)
    with torch.no_grad():
        ev = tvan.forward(tp, tcfg, tr, train=False, generator=torch.Generator().manual_seed(0))
    jev = jvan.forward(jp, jcfg, jr, key=None, train=False)
    assert _rel(ev["rgb"].numpy(), jev["rgb"]) <= 1e-4


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(optimizer="adamw", lr=1e-2, eps=1e-8, weight_decay=0.1)),
    ("adamw_clip_decay", dict(optimizer="adamw", lr=3e-3, eps=1e-8, weight_decay=0.01,
                              max_norm=0.5, lr_final=1e-4, max_steps=5)),
    ("sgd", dict(optimizer="sgd", lr=0.1)),
    ("sgd_clip", dict(optimizer="sgd", lr=0.05, max_norm=0.3)),
])
def test_adamw_and_sgd_match_optax(name, kw):
    """Five updates of a group with a frozen leaf (no gradient: a zero
    gradient, so AdamW still decays it): every parameter to 1e-6."""
    rng = np.random.default_rng(11)
    p0 = {"w": rng.normal(size=(5, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32),
          "frozen": rng.normal(size=(3,)).astype(np.float32)}
    grads = [{"w": rng.normal(size=(5, 4)).astype(np.float32),
              "b": rng.normal(size=(4,)).astype(np.float32),
              "frozen": np.zeros(3, np.float32)} for _ in range(5)]
    tx = jopt.OptimizerConfig(**kw).build()
    jp = jax.tree.map(jnp.asarray, p0)
    st = tx.init(jp)
    for g in grads:
        upd, st = tx.update(jax.tree.map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {"g": {k: torch.tensor(v, requires_grad=k != "frozen") for k, v in p0.items()}}
    opt = topt.build_optimizer({"g": topt.OptimizerConfig(**kw)}, tp, device="cpu")
    for g in grads:
        opt.zero_grad()
        for k in ("w", "b"):
            tp["g"][k].grad = torch.tensor(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp["g"][k].detach().numpy(), np.asarray(jp[k]), atol=1e-6,
                                   err_msg=k)
