"""Port vs JAX package, the training side of the preprocessing networks on
the CPU in f32: RAFT's sequence loss and its metrics, the one-cycle learning
rate against optax's, one RAFT fine-tuning step (AdamW behind the global-norm
clip) against the JAX driver's, one step of the inpainting trainer and of
the segmenter trainer against optax, the segmenter's targets and boundary
weights, a ``save_segmenter`` file read back by the JAX loader, and the
ranges of ``random_stroke_masks``. Weights are seeded flax variables carried
to the port by ``process_data.convert``.

The first Adam step moves a parameter by lr * g / (|g| + eps), eps 1e-8:
about lr in the direction of its gradient, whatever the gradient's size.
The step changes with g by lr eps dg / |g|^2, so where |g| is above 1e-5
and 1e-3 of its tensor's largest (the gradients agree to ~1e-5 of that),
the updated parameters are held to 1e-3 of lr (and one ulp); a smaller gradient (many are
within rounding of zero: the biases before an instance norm or of the
attention's keys, whose gradients vanish exactly) may point either way, and
is held to 2 lr. That step hardly sees the gradient's size, so each
trainer's gradients are also held to the JAX package's (RAFT's after the
global-norm clip), and ``ClippedAdamW`` alone to optax's chain over four
steps with a rate and a weight decay large enough to show. The inpainting
generator warps by its predicted flow with bilinear sampling, whose
derivative jumps where a coordinate crosses an integer; at seeded weights the flow is within rounding of zero, so the test
gives the flow head a bias of (0.37, -0.23) pixels in both packages.
RAFT's convex upsampling goes through the published layout on both sides
(the JAX function is swapped inside the test; its own layout scrambles the
children, see ``tests/test_torch_preprocess_networks.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_kbs_tpu.process_data import inpaint as jinpaint
from nerf_kbs_tpu.process_data import raft_driver as jdriver
from nerf_kbs_tpu.process_data.networks import inpaint_net as jinp
from nerf_kbs_tpu.process_data.networks import raft as jraft
from nerf_kbs_tpu.process_data.networks import segmenter as jseg
from nerf_kbs_tpu_torch.process_data import convert
from nerf_kbs_tpu_torch.process_data import inpaint as tinpaint
from nerf_kbs_tpu_torch.process_data import raft_driver as tdriver
from nerf_kbs_tpu_torch.process_data.networks import inpaint_net as tinp
from nerf_kbs_tpu_torch.process_data.networks import raft as traft
from nerf_kbs_tpu_torch.process_data.networks import segmenter as tseg
from tests.test_torch_preprocess_networks import nchw, seeded_flax
from tests.test_torch_process_data import _published_convex_upsample


def _close_after_first_step(model: torch.nn.Module, want: dict, lr: float):
    """``model``'s parameters after one Adam step against ``want`` (module
    docstring), split by the gradient the step used."""
    got = dict(model.named_parameters())
    assert sorted(got) == sorted(want)
    steady = 0
    for k, p in got.items():
        diff = np.abs(p.detach().numpy() - want[k].numpy())
        assert diff.max() <= 2 * lr, k
        g = np.abs(p.grad.numpy())
        large = g > max(1e-5, 1e-3 * g.max())
        tol = 1e-3 * lr + np.spacing(np.abs(want[k].numpy()))  # and one ulp of the parameter
        assert np.all(diff[large] <= tol[large]), k
        steady += int(large.sum())
    assert steady > 0.4 * sum(p.numel() for p in got.values())


def _grads_close(model: torch.nn.Module, want: dict, rtol: float = 2e-5):
    """``model``'s gradients against ``want``, each tensor to ``rtol`` of
    its largest entry. A tensor whose gradient vanishes (below 1e-6 of the
    largest entry of all: the biases before an instance norm, rounding
    noise in both packages) is held to 1e-7 of that entry."""
    got = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert sorted(got) == sorted(want)
    top = max(float(np.abs(want[k].numpy()).max()) for k in got)
    for k, g in got.items():
        w = want[k].numpy()
        big = float(np.abs(w).max())
        atol = rtol * big if big >= 1e-6 * top else 1e-7 * top
        np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=k)


def _flow_case(seed: int, t: int = 3, b: int = 2, h: int = 8, w: int = 12):
    rng = np.random.default_rng(seed)
    preds = rng.normal(0, 4, (t, b, 2, h, w)).astype(np.float32)
    gt = rng.normal(0, 4, (b, 2, h, w)).astype(np.float32)
    gt[0, :, 0, :3] = 500.0  # past max_flow: not valid
    preds[-1, 1, :, 2] = gt[1, :, 2] + 0.5  # small end-point errors
    valid = (rng.uniform(0, 1, (b, h, w)) > 0.3).astype(np.float32)
    return preds, gt, valid


@pytest.mark.parametrize("seed,gamma", [(0, 0.8), (1, 0.5)])
def test_sequence_loss_and_metrics_match_jax(seed, gamma):
    preds, gt, valid = _flow_case(seed)
    nhwc = (0, 1, 3, 4, 2)
    want_loss, want_m = jraft.sequence_loss(
        jnp.asarray(preds.transpose(nhwc)), jnp.asarray(gt.transpose(0, 2, 3, 1)),
        jnp.asarray(valid), gamma=gamma)
    loss, m = traft.sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                                  torch.from_numpy(valid), gamma=gamma)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-6)
    assert sorted(m) == sorted(want_m) == ["1px", "3px", "5px", "epe"]
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(want_m[k]), rtol=1e-6, err_msg=k)


def test_sequence_loss_without_valid_pixels_is_zero():
    preds, gt, _ = _flow_case(2)
    loss, m = traft.sequence_loss(torch.from_numpy(preds), torch.from_numpy(gt),
                                  torch.zeros(gt.shape[0], *gt.shape[2:]))
    assert float(loss) == 0.0 and float(m["epe"]) == 0.0


@pytest.mark.parametrize("num_steps,peak,pct", [(8, 4e-4, 0.05), (1000, 1e-3, 0.3)])
def test_onecycle_rate_matches_optax(num_steps, peak, pct):
    """Every count of the schedule and past its end, as RAFT's trainer
    builds it (num_steps + 100 transition steps)."""
    want = optax.linear_onecycle_schedule(transition_steps=num_steps + 100, peak_value=peak,
                                          pct_start=pct)
    got = tdriver.linear_onecycle_schedule(num_steps + 100, peak, pct_start=pct)
    counts = sorted({0, 1, 2, 5, 6, 7, 8, 50, num_steps + 99, num_steps + 100,
                     num_steps + 150} | set(range(0, num_steps + 120, 37)))
    np.testing.assert_allclose([got(c) for c in counts], [float(want(c)) for c in counts],
                               rtol=1e-6)


@pytest.fixture(scope="module")
def raft_step_pair():
    """One step of both RAFT trainers (2 iterations, 32 x 40, batch 2) from
    the same seeded variables and batch."""
    cfg_j = jdriver.RaftTrainConfig(iters=2, num_steps=8)
    rv = seeded_flax(jraft.RAFT(jraft.RaftConfig(iters=2)).init, 32, 40, seed=5)
    rng = np.random.default_rng(6)
    img1 = rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
    batch = {"img1": img1, "img2": np.roll(img1, 2, axis=2),
             "flow": rng.normal(0, 2, (2, 32, 40, 2)).astype(np.float32),
             "valid": (rng.uniform(0, 1, (2, 32, 40)) > 0.2).astype(np.float32)}
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jraft, "convex_upsample", _published_convex_upsample)
        mp.setattr(jraft.RAFT, "init", lambda self, key, h, w: rv)
        raft_j, variables, tx_j, opt_state = jdriver.make_raft_train_state(cfg_j, 32, 40)
        step_j = jdriver.make_raft_train_step(raft_j, tx_j, cfg_j)
        before = convert.raft_from_jax(jax.tree.map(np.asarray, variables))
        jb = jax.tree.map(jnp.asarray, batch)

        def loss_j(v):  # the driver's loss, for its gradient before the clip
            flows = raft_j.compute_flow(v, jb["img1"], jb["img2"], iters=cfg_j.iters,
                                        all_iters=True)
            return jraft.sequence_loss(flows, jb["flow"], jb["valid"], cfg_j.gamma)[0]

        grads = jax.jit(jax.grad(loss_j))(variables)
        norm = float(optax.global_norm(grads))
        new_v, _, loss_j, m_j = step_j(variables, opt_state, jb)
        clipped = jax.tree.map(lambda g: np.asarray(g) * min(1.0, cfg_j.clip / norm), grads)
        want = (float(loss_j), {k: float(v) for k, v in m_j.items()},
                convert.raft_from_jax(jax.tree.map(np.asarray, new_v)),
                convert.raft_from_jax(clipped), norm)
    finally:
        mp.undo()
    cfg_t = tdriver.RaftTrainConfig(iters=2, num_steps=8)
    raft_t, tx_t = tdriver.make_raft_train_state(cfg_t, device="cpu")
    raft_t.load_state_dict(before)
    step_t = tdriver.make_raft_train_step(raft_t, tx_t, cfg_t)
    loss_t, m_t = step_t({"img1": nchw(batch["img1"]), "img2": nchw(batch["img2"]),
                          "flow": nchw(batch["flow"]), "valid": torch.from_numpy(batch["valid"])})
    got = (float(loss_t), {k: float(v) for k, v in m_t.items()}, raft_t)
    return got, want, tx_t


def test_raft_train_step_loss_and_metrics_match_jax(raft_step_pair):
    got, want, _ = raft_step_pair
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for k in want[1]:
        np.testing.assert_allclose(got[1][k], want[1][k], rtol=1e-5, atol=1e-6, err_msg=k)


def test_raft_train_step_gradient_matches_jax(raft_step_pair):
    """The gradient the port's AdamW took, after the global-norm clip,
    against jax.grad of the JAX driver's loss scaled by optax's clip: the
    seeded network's norm is far above 1, so the clipped norm is 1."""
    got, want, _ = raft_step_pair
    assert want[4] > 10.0
    _grads_close(got[2], want[3])
    norm = np.sqrt(sum(np.sum(p.grad.double().numpy() ** 2) for p in got[2].parameters()))
    np.testing.assert_allclose(norm, 1.0, rtol=1e-5)


@pytest.mark.parametrize("clip,weight_decay", [(1.0, 1e-4), (1.0, 0.2), (1e3, 0.2)])
def test_clipped_adamw_matches_optax(clip, weight_decay):
    """``ClippedAdamW`` against optax's ``chain(clip_by_global_norm,
    adamw)`` under the one-cycle rate, four steps of gradients whose global
    norms (5, 0.3, 2, 0.5) fall on both sides of the clip. The rate peaks at
    0.05 so that the weight decay moves the parameters by far more than the
    tolerance; dropping the clip or the decay from the reference must fail
    the comparison."""
    rng = np.random.default_rng(13)
    shapes = [(6, 5), (5,), (3, 4, 2)]
    p0 = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
    grads = []
    for n in (5.0, 0.3, 2.0, 0.5):
        g = [rng.normal(0, 1, s).astype(np.float32) for s in shapes]
        scale = n / np.sqrt(sum(np.sum(x.astype(np.float64) ** 2) for x in g))
        grads.append([(x * scale).astype(np.float32) for x in g])

    def reference(clip_norm, wd):
        tx = optax.chain(optax.clip_by_global_norm(clip_norm), optax.adamw(
            optax.linear_onecycle_schedule(transition_steps=108, peak_value=0.05,
                                           pct_start=0.05), eps=1e-8, weight_decay=wd))
        params = [jnp.asarray(x) for x in p0]
        state = tx.init(params)
        for g in grads:
            updates, state = tx.update([jnp.asarray(x) for x in g], state, params)
            params = optax.apply_updates(params, updates)
        return [np.asarray(x) for x in params]

    params = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in p0]
    tx = tdriver.ClippedAdamW(params, tdriver.linear_onecycle_schedule(108, 0.05, pct_start=0.05),
                              clip, 1e-8, weight_decay)
    for g in grads:
        tx.zero_grad()
        for p, x in zip(params, g):
            p.grad = torch.from_numpy(x.copy())
        tx.step()
    got = [p.detach().numpy() for p in params]
    for a, b in zip(got, reference(clip, weight_decay)):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

    def gap(other):
        return max(float(np.abs(a - b).max()) for a, b in zip(got, other))

    if clip < 5.0:  # the clip scales the first and third gradients
        assert gap(reference(1e9, weight_decay)) > 1e-3
    if weight_decay > 0.1:
        assert gap(reference(clip, 0.0)) > 1e-3


def test_raft_train_step_update_matches_jax(raft_step_pair):
    """The clip triggers (the seeded network's gradient norm is far above
    1) and the first rate is peak / 25."""
    got, want, tx = raft_step_pair
    assert tx.count == 1
    _close_after_first_step(got[2], want[2], 4e-4 / 25)


def test_inpaint_train_step_matches_optax():
    """T = 4 at 32 x 32, seeded masks passed to both sides."""
    rng = np.random.default_rng(9)
    frames = rng.uniform(0, 1, (1, 4, 32, 32, 3)).astype(np.float32)
    masks = tinpaint.random_stroke_masks(torch.Generator().manual_seed(3), 4, 32, 32)[None]
    j = jinp.InpaintGenerator()
    jv = seeded_flax(j.init, jnp.asarray(frames), jnp.asarray(masks.numpy()), seed=7)
    jv["params"]["flow"]["out"]["bias"] = np.array([0.37, -0.23], np.float32)  # see docstring
    f, m = jnp.asarray(frames), jnp.asarray(masks.numpy())
    # the JAX trainer's loss, for its gradient
    grads = jax.jit(jax.grad(lambda v: jnp.mean(jnp.abs(j.apply(v, f, m) - f)
                                                * (1.0 + 3.0 * m[..., None]))))(jv)
    init, step = jinpaint.make_inpaint_train_step(j, lr=1e-3)
    new_v, _, loss_j = step(jv, init(jv), f, m)
    gen = tinp.InpaintGenerator()
    gen.load_state_dict(convert.inpaint_from_jax(jax.tree.map(np.asarray, jv)))
    loss_t = tinpaint.make_inpaint_train_step(gen, lr=1e-3)(
        torch.from_numpy(frames).permute(0, 1, 4, 2, 3), masks)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    _grads_close(gen, convert.inpaint_from_jax(jax.tree.map(np.asarray, grads)))
    _close_after_first_step(gen, convert.inpaint_from_jax(jax.tree.map(np.asarray, new_v)), 1e-3)


def _instances(h: int = 30, w: int = 44) -> np.ndarray:
    lbl = np.zeros((h, w), np.int32)
    lbl[3:12, 4:15] = 1
    lbl[8:20, 15:30] = 2  # touches instance 1
    lbl[22:28, 35:42] = 5
    return lbl


@pytest.mark.parametrize("weighted", [False, True])
def test_segmenter_train_step_matches_optax(weighted):
    """One Adam step of ``segmenter_loss`` (the JAX trainer's optimizer,
    ``tools/train_segmenter.py``) on targets of an instance map, with and
    without the boundary weight."""
    rng = np.random.default_rng(11)
    lbl = _instances()
    fg, off, valid = jseg.make_targets(lbl)
    x = rng.uniform(0, 1, (1, 30, 44, 6)).astype(np.float32)
    jb = {"x": x, "fg": fg[None], "off": off[None], "valid": valid[None]}
    if weighted:
        jb["w"] = jseg.boundary_weight(lbl)[None]
    j = jseg.InstanceSegmenter()
    jv = seeded_flax(j.init, jnp.asarray(x), seed=12)
    jb = jax.tree.map(jnp.asarray, jb)
    (loss_j, m_j), grads = jax.jit(jax.value_and_grad(
        lambda v: jseg.segmenter_loss(j, v, jb), has_aux=True))(jv)
    tx = optax.adam(3e-4)
    updates, _ = tx.update(grads, tx.init(jv), jv)
    new_v = optax.apply_updates(jv, updates)

    model = tseg.InstanceSegmenter()
    model.load_state_dict(convert.segmenter_from_jax(jax.tree.map(np.asarray, jv)))
    tb = {"x": nchw(x), "fg": torch.from_numpy(fg[None]), "off": nchw(off[None]),
          "valid": torch.from_numpy(valid[None])}
    if weighted:
        tb["w"] = torch.from_numpy(tseg.boundary_weight(lbl)[None])
    loss_t, m_t = tseg.make_segmenter_train_step(model)(tb)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for k in ("bce", "offset_l1", "fg_acc"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5, err_msg=k)
    _grads_close(model, convert.segmenter_from_jax(jax.tree.map(np.asarray, grads)))
    _close_after_first_step(model, convert.segmenter_from_jax(jax.tree.map(np.asarray, new_v)),
                            3e-4)


@pytest.mark.parametrize("radius,gain", [(2, 4.0), (0, 1.5), (4, 2.0)])
def test_make_targets_and_boundary_weight_equal_jax(radius, gain):
    lbl = _instances()
    for got, want in zip(tseg.make_targets(lbl, offset_scale=32.0),
                         jseg.make_targets(lbl, offset_scale=32.0)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tseg.boundary_weight(lbl, radius, gain),
                                  jseg.boundary_weight(lbl, radius, gain))


def test_save_segmenter_is_read_back_by_the_jax_loader(tmp_path):
    """The port's file through the JAX package's ``load_segmenter``: the
    same variables as the port's weights, and the same predictions."""
    model = tseg.InstanceSegmenter()
    from nerf_kbs_tpu_torch.process_data.networks import init_weights

    init_weights(model, torch.Generator().manual_seed(4))
    path = tmp_path / "segmenter.npz"
    tseg.save_segmenter(str(path), model)
    jmodel, jv = jseg.load_segmenter(str(path))
    back = convert.segmenter_from_jax(jax.tree.map(np.asarray, jv))
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), err_msg=k)
    x = np.random.default_rng(5).uniform(0, 1, (24, 36, 6)).astype(np.float32)
    fg_j, off_j = jseg.predict(jmodel, jv, x)
    fg_t, off_t = tseg.predict(model.eval(), x)
    np.testing.assert_allclose(fg_t, fg_j, atol=1e-5)
    reloaded = tseg.load_segmenter(str(path), device="cpu")
    for k, v in model.state_dict().items():
        np.testing.assert_array_equal(reloaded.state_dict()[k].numpy(), v.numpy(), err_msg=k)


@pytest.mark.parametrize("t,h,w,rects", [(5, 40, 64, 3), (2, 12, 10, 1)])
def test_random_stroke_masks_ranges_and_shapes(t, h, w, rects):
    """Seeded draws repeat; each frame's hole is a union of at most
    ``rects`` rectangles inside JAX's ranges (corners below h - 8 and w - 8,
    sides from 4 to under a third of the frame)."""
    m = tinpaint.random_stroke_masks(torch.Generator().manual_seed(1), t, h, w, rects)
    again = tinpaint.random_stroke_masks(torch.Generator().manual_seed(1), t, h, w, rects)
    assert m.shape == (t, h, w) and m.dtype == torch.float32
    assert torch.equal(m, again) and set(m.unique().tolist()) <= {0.0, 1.0}
    for frame in m.numpy():
        ys, xs = np.nonzero(frame)
        assert len(ys) >= 16
        assert ys.min() < max(h - 8, 1) and xs.min() < max(w - 8, 1)
        assert frame.sum() <= rects * (max(h // 3, 5) - 1) * (max(w // 3, 5) - 1)
