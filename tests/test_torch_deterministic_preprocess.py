"""The preprocessing trainers' fixed-order pieces against the JAX package on
the CPU, f32: the inpainter's x2 bilinear upsampling stencil against
``jax.image.resize(..., "bilinear")`` (forward and ``jax.vjp``, edges and
one-pixel sides included), its window attention block's explicit product
(output, input and parameter gradients against the JAX block's
``jax.vjp``, with converted weights), the edge padding's
concatenation against ``F.pad``'s replicate mode, and the scope of
``networks.deterministic_convolutions`` (the flags it sets and puts back,
and that each trainer's step runs under it). Inputs come from NumPy seeds;
~15 s in one process."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.process_data.networks import inpaint_net as jinp
from nerf_kbs_tpu_torch.process_data import convert
from nerf_kbs_tpu_torch.process_data import inpaint as tinpaint
from nerf_kbs_tpu_torch.process_data import networks
from nerf_kbs_tpu_torch.process_data import raft_driver as traft
from nerf_kbs_tpu_torch.process_data.networks import inpaint_net as tinp
from nerf_kbs_tpu_torch.process_data.networks import segmenter as tseg

# the stencil and JAX's resize weigh the same two taps (0.75 rounds once,
# 0.25 is exact) and add them in either order; at an edge JAX renormalises
# its one tap to 1.0: within 1e-6 of values of order 1, and so are the
# gradients (sums of up to four such taps)
UP_TOL = 1e-6


@pytest.mark.parametrize("b,h,w,c", [(2, 5, 7, 3), (1, 1, 4, 2), (1, 6, 1, 1), (1, 16, 12, 8)])
def test_upsample2_bilinear_matches_jax_resize(b, h, w, c):
    rng = np.random.default_rng(h * 10 + w)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    cot = rng.normal(size=(b, 2 * h, 2 * w, c)).astype(np.float32)
    want, vjp = jax.vjp(lambda y: jax.image.resize(y, (b, 2 * h, 2 * w, c), "bilinear"),
                        jnp.asarray(x))
    (want_dx,) = vjp(jnp.asarray(cot))
    tx = torch.tensor(x.transpose(0, 3, 1, 2), requires_grad=True)
    got = tinp.upsample2_bilinear(tx)
    got.backward(torch.from_numpy(cot.transpose(0, 3, 1, 2)))
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=UP_TOL)
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_dx),
                               rtol=0, atol=UP_TOL)


@pytest.mark.parametrize("dim,n", [(2, 3), (3, 1), (3, 0)])
def test_pad_edge_matches_replicate_padding(dim, n):
    """``networks.pad_edge`` against ``F.pad(..., mode="replicate")`` at the
    far end of one dimension of an (N, C, H, W) tensor: the same values and
    the same gradient (the edge's gradient sums its copies')."""
    rng = np.random.default_rng(dim * 10 + n)
    x = rng.normal(size=(2, 3, 5, 4)).astype(np.float32)
    pad = (0, n, 0, 0) if dim == 3 else (0, 0, 0, n)
    cot = rng.normal(size=np.add(x.shape, [0, 0, pad[3], pad[1]])).astype(np.float32)
    a, b = torch.tensor(x, requires_grad=True), torch.tensor(x, requires_grad=True)
    got, want = networks.pad_edge(a, dim, n), torch.nn.functional.pad(b, pad, mode="replicate")
    np.testing.assert_array_equal(got.detach().numpy(), want.detach().numpy())
    got.backward(torch.from_numpy(cot))
    want.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=1e-6, atol=1e-6)


def _seeded(module, *args, seed=0):
    """Flax variables of ``module.init``'s tree, filled from a NumPy seed
    (kernels N(0, 1 / fan_in), biases N(0, 0.05), norm scales U(0.5, 1.5));
    the JAX initialisers are not run."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: module.init(k, *args), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan = leaf.shape[0] if leaf.ndim == 3 and path[-2].key != "out" else \
                int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, 1 / np.sqrt(fan), leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def test_window_attention_block_gradient_matches_jax():
    """(B, T, H, W, C) = (1, 2, 8, 8, 16), four heads, 4 x 4 windows: 32
    tokens a window. The output, the input's gradient and every parameter's
    against the JAX block's vjp."""
    ch, heads, win = 16, 4, 4
    rng = np.random.default_rng(7)
    x = rng.normal(size=(1, 2, 8, 8, ch)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    j = jinp.WindowAttentionBlock(ch, heads, win)
    jv = _seeded(j, jnp.asarray(x), seed=7)
    want, vjp = jax.vjp(j.apply, jv, jnp.asarray(x))
    jd_v, jd_x = vjp(jnp.asarray(cot))
    m = tinp.WindowAttentionBlock(ch, heads, win)
    m.load_state_dict(convert.state_dict_from_flax(jv["params"]))
    tx = torch.tensor(x, requires_grad=True)
    got = m(tx)
    got.backward(torch.from_numpy(cot))
    scale = float(np.abs(np.asarray(want)).max())
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jd_x), rtol=0,
                               atol=1e-5 * float(np.abs(np.asarray(jd_x)).max()))
    want_grads = convert.state_dict_from_flax(jax.tree.map(np.asarray, jd_v)["params"])
    largest = max(float(w.abs().max()) for w in want_grads.values())
    for name, p in m.named_parameters():
        w = want_grads[name].numpy()
        # the key bias's gradient vanishes exactly (it shifts each query's
        # scores by a constant): rounding noise on both sides, held to the
        # largest gradient's scale
        scale = largest if name == "attn.key.bias" else float(np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0, atol=1e-5 * scale, err_msg=name)


def test_deterministic_convolutions_sets_and_restores_the_flags():
    cudnn = torch.backends.cudnn
    saved = cudnn.deterministic, cudnn.benchmark, cudnn.enabled, cudnn.allow_tf32
    try:
        cudnn.deterministic, cudnn.benchmark = False, True
        with networks.deterministic_convolutions():
            assert (cudnn.deterministic, cudnn.benchmark) == (True, False)
            assert (cudnn.enabled, cudnn.allow_tf32) == saved[2:]
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
        with pytest.raises(RuntimeError), networks.deterministic_convolutions():
            raise RuntimeError
        assert (cudnn.deterministic, cudnn.benchmark) == (False, True)
    finally:
        cudnn.deterministic, cudnn.benchmark = saved[:2]


def test_each_trainer_step_runs_its_backward_under_deterministic_convolutions(monkeypatch):
    """One CPU step of each trainer at a tiny size with a recording stand-in
    for the scope: the forward and the backward run inside it."""
    inside = []

    @contextlib.contextmanager
    def recording():
        inside.append(True)
        yield
        inside.append(False)

    monkeypatch.setattr(networks, "deterministic_convolutions", recording)
    seen = []

    def spy(name):
        def hook(grad):
            seen.append((name, inside[-1]))
        return hook

    g = torch.Generator().manual_seed(0)
    model = networks.init_weights(tseg.InstanceSegmenter(), g)
    model.head.weight.register_hook(spy("segmenter"))
    batch = {"x": torch.rand(1, 6, 16, 16, generator=g), "fg": torch.ones(1, 16, 16),
             "off": torch.zeros(1, 2, 16, 16), "valid": torch.ones(1, 16, 16)}
    tseg.make_segmenter_train_step(model)(batch)

    gen = tinpaint.seeded_generator(0)
    gen.decoder.out.weight.register_hook(spy("inpaint"))
    masks = tinpaint.random_stroke_masks(torch.Generator().manual_seed(1), 2, 16, 16)[None]
    tinpaint.make_inpaint_train_step(gen)(torch.rand(1, 2, 3, 16, 16, generator=g), masks)

    cfg = traft.RaftTrainConfig(iters=1)
    raft, tx = traft.make_raft_train_state(cfg, device="cpu")
    next(raft.parameters()).register_hook(spy("raft"))
    img = torch.rand(1, 3, 32, 32, generator=g)
    traft.make_raft_train_step(raft, tx, cfg)(
        {"img1": img, "img2": img, "flow": torch.zeros(1, 2, 32, 32),
         "valid": torch.ones(1, 32, 32)})
    assert seen == [("segmenter", True), ("inpaint", True), ("raft", True)]
    assert inside == [True, False] * 3
