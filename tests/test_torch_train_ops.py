"""Port vs JAX package, the training pieces on the CPU: the backwards of the
fused Fourier MLP and field (JAX runs its Pallas backward kernels in
interpret mode, the port its plain backwards), trunc_exp, the sampler and
loss gradients, and the per-group optimizer. Inputs come from numpy seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.engine import optimizers as jopt
from nerf_kbs_tpu.ops import fused_field as jff
from nerf_kbs_tpu.ops import losses as jlosses
from nerf_kbs_tpu.ops import mlp as jmlp
from nerf_kbs_tpu.ops import rendering as jrend
from nerf_kbs_tpu.ops import samplers as jsamp
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.convert import opt_state_from_jax, params_from_jax
from nerf_kbs_tpu_torch.engine import optimizers as topt
from nerf_kbs_tpu_torch.ops import fused_field as tff
from nerf_kbs_tpu_torch.ops import losses as tlosses
from nerf_kbs_tpu_torch.ops import mlp as tmlp
from nerf_kbs_tpu_torch.ops import rendering as trend
from nerf_kbs_tpu_torch.ops import samplers as tsamp

# gradients relative to the reference tensor's largest magnitude. f32: the
# same float operations in another summation order; bf16: both sides round dh
# and the activations at the same points, but a last-bit difference in an f32
# sum can flip single bf16 roundings
RTOL = {False: 1e-4, True: 2e-2}


def _close(got, want, tol, name=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-6)
    assert float(np.abs(got - want).max()) <= tol * scale, (
        name, float(np.abs(got - want).max()), scale)


def _mlp(rng, dims):
    ws = [(rng.uniform(-1, 1, (a, b)) * (6.0 / a) ** 0.5).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=(b,)) * 0.1).astype(np.float32) for b in dims[1:]]
    return ws, bs


def _case(seed, H, n, basis):
    rng = np.random.default_rng(seed)
    x = rng.random((3, n)).astype(np.float32)
    B = (rng.normal(size=(3, H)) * 3.0).astype(np.float32)
    if basis == "sincos":
        B = (B * 2 * np.pi).astype(np.float32)
    return rng, x, B


def _leaf(a):
    return torch.tensor(a, requires_grad=True)


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


# ---------------------------------------------------------------------------
# (a) fused backwards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("need_dx", [False, True])
# the last two cases are the nerfacto field's base MLP (H = 128) and
# semantic-nerfw's 2-layer base, which the semantics path runs alone in this
# kernel; 130 and 300 points are ragged against JAX's 128-point tile
@pytest.mark.parametrize("dims,n", [((24, 16, 5), 300), ((24, 16, 1), 190),
                                    ((256, 128, 128, 16), 130),
                                    ((256, 128, 16), 300)])
def test_fourier_mlp_vjp_matches_jax_kernel(basis, bf16, need_dx, dims, n):
    H = dims[0] // 2
    rng, x, B = _case(0, H, n, basis)
    ws, bs = _mlp(rng, dims)
    g = rng.normal(size=(dims[-1], n)).astype(np.float32)
    jspec = jff.FusedMLPSpec(h_freqs=H, layer_dims=dims, tile=128, interpret=True, bf16=bf16,
                             basis=basis, need_dx=need_dx)
    _, vjp = jax.vjp(lambda x_, B_, ws_, bs_: jff.fourier_mlp(jspec, x_, B_, ws_, bs_),
                     jnp.asarray(x), jnp.asarray(B), _j(ws), _j(bs))
    jdx, jdB, jdws, jdbs = vjp(jnp.asarray(g))

    tspec = tff.FusedMLPSpec(h_freqs=H, layer_dims=dims, bf16=bf16, basis=basis,
                             need_dx=need_dx)
    tx, tB = _leaf(x), _leaf(B)
    tws, tbs = [_leaf(w) for w in ws], [_leaf(b) for b in bs]
    out = tff.fourier_mlp(tspec, tx, tB, tws, tbs)
    out.backward(torch.as_tensor(g))
    tol = RTOL[bf16]
    for i, (t, jd) in enumerate(zip(tws + tbs, list(jdws) + list(jdbs))):
        _close(t.grad.numpy(), jd, tol, f"param {i}")
    assert tB.grad is None and not np.asarray(jdB).any()
    if need_dx:
        _close(tx.grad.numpy(), jdx, tol, "dx")
    else:
        assert tx.grad is None and not np.asarray(jdx).any()
    # CPU tensors never launch
    assert tff.LAUNCHES["fourier_mlp_bwd"] == tff.LAUNCHES["fourier_mlp_bwd_base_wgmma"] == 0


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("need_dx", [False, True])
def test_fourier_field_vjp_matches_jax_kernel(basis, bf16, need_dx):
    n, F = 259, 5
    rng, x, B = _case(1, 12, n, basis)
    base_dims, rgb_dims = (24, 16, 16, 8), (7 + F, 16, 3)
    bws, bbs = _mlp(rng, base_dims)
    rws, rbs = _mlp(rng, rgb_dims)
    feats = rng.normal(size=(F, n)).astype(np.float32)
    g = rng.normal(size=(4, n)).astype(np.float32)
    jspec = jff.FusedFieldSpec(h_freqs=12, feat_dim=F, base_dims=base_dims, rgb_dims=rgb_dims,
                               tile=128, interpret=True, bf16=bf16, basis=basis,
                               need_dx=need_dx)
    _, vjp = jax.vjp(
        lambda *a: jff.fourier_field_mlp(jspec, *a),
        jnp.asarray(x), jnp.asarray(feats), jnp.asarray(B), _j(bws), _j(bbs), _j(rws), _j(rbs))
    jdx, jdf, _, jdbw, jdbb, jdrw, jdrb = vjp(jnp.asarray(g))

    tspec = tff.FusedFieldSpec(h_freqs=12, feat_dim=F, base_dims=base_dims, rgb_dims=rgb_dims,
                               bf16=bf16, basis=basis, need_dx=need_dx)
    tx, tf = _leaf(x), _leaf(feats)
    leaves = [[_leaf(a) for a in grp] for grp in (bws, bbs, rws, rbs)]
    out = tff.fourier_field_mlp(tspec, tx, tf, torch.as_tensor(B), *leaves)
    out.backward(torch.as_tensor(g))
    tol = RTOL[bf16]
    _close(tf.grad.numpy(), jdf, tol, "dfeats")
    for name, grp, jgrp in zip(("dbw", "dbb", "drw", "drb"), leaves, (jdbw, jdbb, jdrw, jdrb)):
        for i, (t, jd) in enumerate(zip(grp, jgrp)):
            _close(t.grad.numpy(), jd, tol, f"{name}{i}")
    if need_dx:
        _close(tx.grad.numpy(), jdx, tol, "dx")
    else:
        assert tx.grad is None and not np.asarray(jdx).any()


@pytest.mark.parametrize("basis", ["tri", "sincos"])
def test_plain_backwards_equal_autograd_in_f32(basis):
    """In f32 nothing is rounded, so the hand-written plain backwards must
    equal autograd of the plain forwards."""
    n, F = 120, 5
    rng, x, B = _case(2, 12, n, basis)
    tB = torch.as_tensor(B)
    for dims in ((24, 16, 5), (24, 16, 1)):
        ws, bs = _mlp(rng, dims)
        g = torch.as_tensor(rng.normal(size=(dims[-1], n)).astype(np.float32))
        leaves = [_leaf(x)] + [_leaf(a) for a in ws + bs]
        k = len(ws)
        tff.fourier_mlp_reference(leaves[0], tB, leaves[1:1 + k], leaves[1 + k:], basis,
                                  False).backward(g)
        dx, dws, dbs = tff.fourier_mlp_backward_reference(
            torch.as_tensor(x), tB, [torch.as_tensor(w) for w in ws],
            [torch.as_tensor(b) for b in bs], g, basis, False, True)
        for t, d in zip(leaves, [dx] + dws + dbs):
            _close(d.numpy(), t.grad.numpy(), 1e-5)
    base_dims, rgb_dims = (24, 16, 16, 8), (7 + F, 16, 3)
    bws, bbs = _mlp(rng, base_dims)
    rws, rbs = _mlp(rng, rgb_dims)
    feats = rng.normal(size=(F, n)).astype(np.float32)
    g = torch.as_tensor(rng.normal(size=(4, n)).astype(np.float32))
    tx, tf = _leaf(x), _leaf(feats)
    grp = [[_leaf(a) for a in part] for part in (bws, bbs, rws, rbs)]
    tff.fourier_field_reference(tx, tf, tB, *grp, basis, False).backward(g)
    res = tff.fourier_field_backward_reference(
        torch.as_tensor(x), torch.as_tensor(feats), tB,
        *[[torch.as_tensor(a) for a in part] for part in (bws, bbs, rws, rbs)], g, basis, False,
        True)
    flat = [res[0], res[1], *res[2], *res[3], *res[4], *res[5]]
    for t, d in zip([tx, tf] + [t for part in grp for t in part], flat):
        _close(d.numpy(), t.grad.numpy(), 1e-5)


# ---------------------------------------------------------------------------
# (b) trunc_exp, _bracket_values, _outer_cw_bounds
# ---------------------------------------------------------------------------


def test_trunc_exp_gradient_matches_jax():
    x = np.array([-20.0, -15.0, -3.0, 0.0, 2.5, 11.0, 12.0, 15.0, 17.0], np.float32)
    g = np.linspace(0.5, 1.5, x.size).astype(np.float32)
    jy, vjp = jax.vjp(jmlp.trunc_exp, jnp.asarray(x))
    tx = _leaf(x)
    ty = tmlp.trunc_exp(tx)
    ty.backward(torch.as_tensor(g))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=1e-6)


def _sorted_rows(rng, r, s):
    w = rng.random((r, s)).astype(np.float32) + 0.01
    c = np.concatenate([np.zeros((r, 1), np.float32), np.cumsum(w, -1)], -1)
    return (c / c[:, -1:]).astype(np.float32)


def test_bracket_values_gradient_matches_jax():
    rng = np.random.default_rng(3)
    R, S, Q = 7, 12, 9
    cdf = _sorted_rows(rng, R, S)
    cdf[:, -1] = 1.0
    edges = _sorted_rows(rng, R, S)
    u = (rng.random((R, Q)) * 0.999).astype(np.float32)
    gs = [rng.normal(size=(R, Q)).astype(np.float32) for _ in range(4)]
    jout, vjp = jax.vjp(jsamp._bracket_values, jnp.asarray(cdf), jnp.asarray(edges),
                        jnp.asarray(u))
    jd_cdf, jd_edges, _ = vjp(tuple(jnp.asarray(g) for g in gs))
    tc, te = _leaf(cdf), _leaf(edges)
    tout = tsamp._bracket_values(tc, te, torch.as_tensor(u))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6)
    torch.autograd.backward(tout, [torch.as_tensor(g) for g in gs])
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jd_cdf), atol=1e-5)
    np.testing.assert_allclose(te.grad.numpy(), np.asarray(jd_edges), atol=1e-5)


def test_outer_cw_bounds_gradient_matches_jax():
    rng = np.random.default_rng(4)
    R, Se, Sq = 6, 10, 7
    # some query edges lie past every env edge
    t_env = (_sorted_rows(rng, R, Se) * 0.9).astype(np.float32)
    cw = np.cumsum(rng.random((R, Se + 1)).astype(np.float32), -1)
    tq = _sorted_rows(rng, R, Sq)
    t0, t1 = tq[:, :-1].copy(), tq[:, 1:].copy()
    gs = [rng.normal(size=(R, Sq)).astype(np.float32) for _ in range(2)]
    jout, vjp = jax.vjp(jlosses._outer_cw_bounds, *_j([t_env, cw, t0, t1]))
    jd_cw = vjp(tuple(_j(gs)))[1]
    tcw = _leaf(cw)
    tout = tlosses._outer_cw_bounds(torch.as_tensor(t_env), tcw, torch.as_tensor(t0),
                                    torch.as_tensor(t1))
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), atol=1e-6)
    torch.autograd.backward(tout, [torch.as_tensor(g) for g in gs])
    np.testing.assert_allclose(tcw.grad.numpy(), np.asarray(jd_cw), atol=1e-5)


# ---------------------------------------------------------------------------
# samplers with jitter, render_weights, (c) the losses
# ---------------------------------------------------------------------------


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
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


def _jsamples(jr, tr, n, key):
    """The same jittered uniform samples on both sides: the port is handed the
    numbers JAX draws from the key."""
    js = jsamp.uniform_sampler(jr, n, key=key)
    ts = tsamp.uniform_sampler(tr, n, jitter=torch.tensor(
        np.array(jax.random.uniform(key, (jr.origins.shape[0], 1)))))
    return js, ts


@pytest.mark.parametrize("single_jitter", [True, False])
def test_jittered_samplers_match_jax(single_jitter):
    R, S, Q = 9, 12, 7
    jr, tr = _rays(R)
    k0, k1 = jax.random.split(jax.random.PRNGKey(5))
    shape0 = (R, 1) if single_jitter else (R, S + 1)
    js = jsamp.uniform_sampler(jr, S, key=k0, single_jitter=single_jitter)
    ts = tsamp.uniform_sampler(tr, S, single_jitter=single_jitter, jitter=torch.tensor(
        np.array(jax.random.uniform(k0, shape0))))
    w = np.random.default_rng(6).random((R, S)).astype(np.float32)
    shape1 = (R, 1) if single_jitter else (R, Q + 1)
    js2 = jsamp.pdf_sampler(jr, js, jnp.asarray(w), Q, "piecewise", key=k1,
                            single_jitter=single_jitter)
    ts2 = tsamp.pdf_sampler(tr, ts, torch.as_tensor(w), Q, "piecewise",
                            single_jitter=single_jitter,
                            rand=torch.tensor(np.array(jax.random.uniform(k1, shape1))))
    for a, b in ((ts, js), (ts2, js2)):
        for f in ("spacing_starts", "spacing_ends", "starts", "ends"):
            np.testing.assert_allclose(getattr(a, f).numpy(), np.asarray(getattr(b, f)),
                                       rtol=1e-5, atol=1e-6, err_msg=f)
    # a generator draws jitter of the right shape and keeps edges sorted
    tg = tsamp.uniform_sampler(tr, S, generator=torch.Generator().manual_seed(0),
                               single_jitter=single_jitter)
    assert bool((tg.spacing_ends >= tg.spacing_starts).all())
    assert not torch.equal(tg.spacing_starts, tsamp.uniform_sampler(tr, S).spacing_starts)


def test_pdf_sampler_jitter_that_rounds_to_one_matches_jax(monkeypatch):
    """A jitter just below 1 makes the top quantile round to exactly 1.0 =
    cdf_last in f32; it belongs to the last bin (the index search used to
    step past the end there)."""
    R, S, Q = 5, 96, 32
    jr, tr = _rays(R, seed=4)
    js, ts = jsamp.uniform_sampler(jr, S), tsamp.uniform_sampler(tr, S)
    w = np.random.default_rng(14).random((R, S)).astype(np.float32)
    rand = np.full((R, 1), np.float32(1.0) - np.float32(2.0 ** -24), np.float32)
    top = np.float32(1.0 - 1.0 / (Q + 1)) + rand[0, 0] / np.float32(Q + 1)
    assert top == np.float32(1.0)
    monkeypatch.setattr(jax.random, "uniform", lambda key, shape: jnp.asarray(rand))
    jout = jsamp.pdf_sampler(jr, js, jnp.asarray(w), Q, "piecewise", key=jax.random.PRNGKey(0))
    tout = tsamp.pdf_sampler(tr, ts, torch.as_tensor(w), Q, "piecewise",
                             rand=torch.as_tensor(rand))
    for f in ("spacing_starts", "spacing_ends", "starts", "ends"):
        np.testing.assert_allclose(getattr(tout, f).numpy(), np.asarray(getattr(jout, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("stop_grad", [False, True])
def test_pdf_sampler_gradient_matches_jax(stop_grad):
    """d(sum of new edges times a cotangent) / d(weights): through the cdf,
    the bracket gather and the in-place-free last entry; zero when detached."""
    R, S, Q = 8, 10, 6
    jr, tr = _rays(R, seed=1)
    key = jax.random.PRNGKey(7)
    js, ts = _jsamples(jr, tr, S, key)
    rng = np.random.default_rng(8)
    w = rng.random((R, S)).astype(np.float32)
    ct = rng.normal(size=(R, Q)).astype(np.float32)

    def jf(w_):
        out = jsamp.pdf_sampler(jr, js, w_, Q, "piecewise", stop_grad=stop_grad)
        return jnp.sum(out.ends * ct + out.spacing_starts * ct)

    jg = jax.grad(jf)(jnp.asarray(w))
    tw = _leaf(w)
    out = tsamp.pdf_sampler(tr, ts, tw, Q, "piecewise", stop_grad=stop_grad)
    val = torch.sum(out.ends * torch.as_tensor(ct) + out.spacing_starts * torch.as_tensor(ct))
    if stop_grad:
        assert not val.requires_grad and not np.asarray(jg).any()
        return
    val.backward()
    _close(tw.grad.numpy(), jg, 1e-4)


def test_render_weights_and_depth_gradients_match_jax():
    R, S = 6, 11
    jr, tr = _rays(R, seed=2)
    js, ts = _jsamples(jr, tr, S, jax.random.PRNGKey(9))
    rng = np.random.default_rng(10)
    dens = (rng.random((R, S)) * 3).astype(np.float32)
    ct = rng.normal(size=(R, S)).astype(np.float32)

    def jf(d):
        w = jrend.render_weights(d, js.deltas)
        return jnp.sum(w * ct) + jnp.sum(jrend.render_expected_depth(w, js))

    jg = jax.grad(jf)(jnp.asarray(dens))
    td = _leaf(dens)
    w = trend.render_weights(td, ts.deltas)
    (torch.sum(w * torch.as_tensor(ct)) + torch.sum(trend.render_expected_depth(w, ts))).backward()
    _close(td.grad.numpy(), jg, 1e-4)


def test_interlevel_and_distortion_losses_match_jax():
    R = 10
    jr, tr = _rays(R, seed=3)
    keys = jax.random.split(jax.random.PRNGKey(11), 3)
    (j0, t0), (j1, t1), (jf_, tf_) = (_jsamples(jr, tr, n, k)
                                      for n, k in zip((16, 12, 8), keys))
    rng = np.random.default_rng(12)
    w0, w1, wf = (rng.random((R, n)).astype(np.float32) / n for n in (16, 12, 8))

    def jloss(w0_, w1_, wf_):
        return (jlosses.interlevel_loss(jf_, wf_, [(j0, w0_), (j1, w1_)])
                + 0.5 * jlosses.distortion_loss(jf_, wf_))

    jval, jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2))(*_j([w0, w1, wf]))
    tws = [_leaf(a) for a in (w0, w1, wf)]
    tval = (tlosses.interlevel_loss(tf_, tws[2], [(t0, tws[0]), (t1, tws[1])])
            + 0.5 * tlosses.distortion_loss(tf_, tws[2]))
    tval.backward()
    np.testing.assert_allclose(float(tval.detach()), float(jval), rtol=1e-5)
    assert float(jval) > 0
    for t, jg in zip(tws, jgrads):
        _close(t.grad.numpy(), jg, 1e-4)


# ---------------------------------------------------------------------------
# (e) the optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["adam", "radam"])
def test_build_optimizer_matches_optax(kind):
    """Five updates from the same gradients, with the clip active, decay and
    warm-up, starting from a carried-over non-zero state."""
    rng = np.random.default_rng(13)

    def tree(scale):
        return {
            "fields": {"fourier_B": (rng.normal(size=(3, 4)) * scale).astype(np.float32),
                       "mlp": {"w": [(rng.normal(size=(8, 5)) * scale).astype(np.float32)],
                               "b": [(rng.normal(size=(5,)) * scale).astype(np.float32)]}},
            "proposal_networks": [{"w": (rng.normal(size=(6, 3)) * scale).astype(np.float32)}],
        }

    params = tree(1.0)
    kw = dict(optimizer=kind, lr=1e-2, eps=1e-15, lr_final=1e-4, max_steps=20)
    jcfgs = {"fields": jopt.OptimizerConfig(max_norm=0.5, **kw),
             "proposal_networks": jopt.OptimizerConfig(warmup_steps=8, **kw)}
    tcfgs = {"fields": topt.OptimizerConfig(max_norm=0.5, **kw),
             "proposal_networks": topt.OptimizerConfig(warmup_steps=8, **kw)}
    jp = jax.tree.map(jnp.asarray, params)
    jtx = jopt.build_optimizer(jcfgs, jp)
    jstate = jtx.init(jp)
    tp = params_from_jax(params, device="cpu")
    for leaf in topt.tree_leaves(tp):
        leaf.requires_grad_(True)
    tp["fields"]["fourier_B"].requires_grad_(False)
    opt = topt.build_optimizer(tcfgs, tp, device="cpu")

    def grads(i):
        g = tree(3.0 if i % 2 else 0.05)  # above and below the clip
        g["fields"]["fourier_B"][:] = 0.0  # the frozen leaf: zero in JAX, None in the port
        return g

    carried = False
    for i in range(8):
        g = grads(i)
        upd, jstate = jtx.update(jax.tree.map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, upd)
        if i < 3:
            continue  # JAX runs ahead: its state after 3 updates is carried over
        if not carried:
            def adam_state(st):
                found = [s for s in jax.tree.leaves(
                    st, is_leaf=lambda s: hasattr(s, "mu")) if hasattr(s, "mu")]
                return found[0]

            states = {grp: adam_state(jstate[grp]) for grp in jstate}
            opt.load_state_dict(opt_state_from_jax(
                {grp: {"mu": jax.tree.map(np.asarray, s.mu), "nu": jax.tree.map(np.asarray, s.nu),
                       "count": int(s.count)} for grp, s in states.items()}, device="cpu"))
            topt.tree_copy_(tp, jax.tree.map(np.asarray, jp))
            carried = True
            continue
        for leaf, gl in zip(topt.tree_leaves(tp), topt.tree_leaves(g)):
            leaf.grad = torch.as_tensor(gl) if leaf.requires_grad else None
        opt.step()
    assert opt.state["fields"]["count"] == 8
    want = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    moved = 0
    for t, j, p0 in zip(jax.tree.leaves(tp), jax.tree.leaves(want), jax.tree.leaves(params)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), rtol=2e-5, atol=1e-6)
        moved += int(np.abs(t.detach().numpy() - p0).max() > 1e-3)
    assert moved == 3
    np.testing.assert_array_equal(tp["fields"]["fourier_B"].numpy(),
                                  params["fields"]["fourier_B"])


def test_optimizer_config_schedule_matches_optax():
    for kw in (dict(lr=1e-3), dict(lr=1e-3, lr_final=1e-5, max_steps=50),
               dict(lr=2e-3, lr_final=1e-4, max_steps=30, warmup_steps=10)):
        js, ts = jopt.OptimizerConfig(**kw).schedule(), topt.OptimizerConfig(**kw).schedule()
        for count in (0, 1, 5, 10, 11, 29, 30, 49, 50, 80, 1000):
            np.testing.assert_allclose(ts(count), float(js(count)), rtol=1e-5)


def test_build_optimizer_rejects_unported_and_wrong_device(monkeypatch):
    """Every optimizer a JAX config can name builds (sgd and adamw too, held
    against optax in tests/test_torch_vanilla_nerf.py); an unknown name, a
    group without a config and a parameter off the device raise."""
    p = {"fields": {"w": torch.zeros(2, requires_grad=True)}}
    for name in ("adam", "radam", "adamw", "sgd"):
        topt.build_optimizer({"fields": topt.OptimizerConfig(optimizer=name)}, p, device="cpu")
    with pytest.raises(ValueError, match="lamb"):
        topt.build_optimizer({"fields": topt.OptimizerConfig(optimizer="lamb")}, p, device="cpu")
    with pytest.raises(ValueError, match="no optimizer configured"):
        topt.build_optimizer({}, p, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        topt.build_optimizer({"fields": topt.OptimizerConfig()}, p)
