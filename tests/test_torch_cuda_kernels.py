"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes: the two forwards and the two backwards. Marked ``cuda``: they skip on hosts without a card.
Run on a CUDA host with ``python -m pytest tests/test_torch_cuda_kernels.py``."""

import numpy as np
import pytest
import torch

from nerf_kbs_tpu_torch.ops import fused_field as ff

pytestmark = pytest.mark.cuda

# f32: the same products summed in another order; bf16: as f32, plus a
# possible flip of one bf16 rounding where an f32 sum differs in its last bit
TOL = {False: 1e-4, True: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _mlp(rng, dims, dev):
    ws = [torch.tensor(rng.uniform(-1, 1, (a, b)) * (6.0 / a) ** 0.5, dtype=torch.float32,
                       device=dev) for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.tensor(rng.normal(size=(b,)) * 0.1, dtype=torch.float32, device=dev)
          for b in dims[1:]]
    return ws, bs


def _inputs(rng, H, n, basis, dev):
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32, device=dev)
    B = rng.normal(size=(3, H)) * 7.0 * (2 * np.pi if basis == "sincos" else 1.0)
    return x, torch.tensor(B, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("dims,n", [((24, 16, 5), 300), ((80, 16, 1), 1001)])
def test_fourier_mlp_kernel(dev, basis, bf16, dims, n):
    rng = np.random.default_rng(0)
    x, B = _inputs(rng, dims[0] // 2, n, basis, dev)
    ws, bs = _mlp(rng, dims, dev)
    spec = ff.FusedMLPSpec(h_freqs=dims[0] // 2, layer_dims=dims, bf16=bf16, basis=basis)
    before = ff.LAUNCHES["fourier_mlp"]
    got = ff.fourier_mlp(spec, x, B, ws, bs)
    assert ff.LAUNCHES["fourier_mlp"] == before + 1
    want = ff.fourier_mlp_reference(x, B, ws, bs, basis, bf16)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL[bf16]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("bf16", [False, True])
def test_fourier_field_kernel(dev, basis, bf16):
    rng = np.random.default_rng(1)
    n, F = 777, 16
    x, B = _inputs(rng, 32, n, basis, dev)
    base_dims, rgb_dims = (64, 32, 32, 16), (15 + F, 32, 3)
    bws, bbs = _mlp(rng, base_dims, dev)
    rws, rbs = _mlp(rng, rgb_dims, dev)
    feats = torch.tensor(rng.normal(size=(F, n)), dtype=torch.float32, device=dev)
    spec = ff.FusedFieldSpec(h_freqs=32, feat_dim=F, base_dims=base_dims, rgb_dims=rgb_dims,
                             bf16=bf16, basis=basis)
    got = ff.fourier_field_mlp(spec, x, feats, B, bws, bbs, rws, rbs)
    want = ff.fourier_field_reference(x, feats, B, bws, bbs, rws, rbs, basis, bf16)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= TOL[bf16]


def _rel_err(got, want):
    """Largest difference relative to the reference tensor's largest
    magnitude: weight gradients are sums over all points."""
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-6)


# backward outputs, relative to each tensor's largest magnitude. f32: another
# summation order; bf16: also flips of single bf16 roundings of dh and of
# activations, which the sums over points average out
BWD_TOL = {False: 1e-4, True: 2e-2}


def _check_all(names, got, want, tol):
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        assert bool(torch.isfinite(a).all()), name
        assert _rel_err(a, b) <= tol, (name, _rel_err(a, b))


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("dims,n", [((24, 16, 5), 300), ((80, 16, 1), 1001),
                                    ((64, 32, 32, 4), 5000)])
def test_fourier_mlp_backward_kernel(dev, basis, bf16, need_dx, dims, n):
    rng = np.random.default_rng(2)
    x, B = _inputs(rng, dims[0] // 2, n, basis, dev)
    ws, bs = _mlp(rng, dims, dev)
    g = torch.tensor(rng.normal(size=(dims[-1], n)), dtype=torch.float32, device=dev)
    spec = ff.FusedMLPSpec(h_freqs=dims[0] // 2, layer_dims=dims, bf16=bf16, basis=basis,
                           need_dx=need_dx)
    x = x.requires_grad_()
    ws = [w.requires_grad_() for w in ws]
    bs = [b.requires_grad_() for b in bs]
    before = dict(ff.LAUNCHES)
    out = ff.fourier_mlp(spec, x, B, ws, bs)
    # a non-contiguous gradient, as autograd hands over views
    out.backward(g.T.contiguous().T)
    assert ff.LAUNCHES["fourier_mlp"] == before["fourier_mlp"] + 1
    assert ff.LAUNCHES["fourier_mlp_bwd"] == before["fourier_mlp_bwd"] + 1
    dx, dws, dbs = ff.fourier_mlp_backward_reference(
        x.detach(), B, [w.detach() for w in ws], [b.detach() for b in bs], g, basis, bf16,
        need_dx)
    torch.cuda.synchronize()
    names = [f"dW{i}" for i in range(len(ws))] + [f"db{i}" for i in range(len(bs))]
    _check_all(names, [t.grad for t in ws + bs], dws + dbs, BWD_TOL[bf16])
    if need_dx:
        _check_all(["dx"], [x.grad], [dx], BWD_TOL[bf16])
    else:
        assert x.grad is None
    # the same launch again gives the same bits
    again = ff._mlp_backward(spec, x.detach(), B, [w.detach() for w in ws],
                             [b.detach() for b in bs], g)
    for a, t in zip(again[1] + again[2], ws + bs):
        assert torch.equal(a, t.grad)


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("need_dx", [False, True])
def test_fourier_field_backward_kernel(dev, basis, bf16, need_dx):
    rng = np.random.default_rng(3)
    n, F = 2777, 16
    x, B = _inputs(rng, 32, n, basis, dev)
    base_dims, rgb_dims = (64, 32, 32, 16), (15 + F, 32, 3)
    bws, bbs = _mlp(rng, base_dims, dev)
    rws, rbs = _mlp(rng, rgb_dims, dev)
    feats = torch.tensor(rng.normal(size=(F, n)), dtype=torch.float32, device=dev)
    g = torch.tensor(rng.normal(size=(4, n)), dtype=torch.float32, device=dev)
    spec = ff.FusedFieldSpec(h_freqs=32, feat_dim=F, base_dims=base_dims, rgb_dims=rgb_dims,
                             bf16=bf16, basis=basis, need_dx=need_dx)
    before = ff.LAUNCHES["fourier_field_mlp_bwd"]
    got = ff._field_backward(spec, x, feats, B, bws, bbs, rws, rbs, g)
    assert ff.LAUNCHES["fourier_field_mlp_bwd"] == before + 1
    want = ff.fourier_field_backward_reference(x, feats, B, bws, bbs, rws, rbs, g, basis, bf16,
                                               need_dx)
    torch.cuda.synchronize()
    assert (got[0] is None) == (not need_dx)
    flat_g = [got[1], *got[2], *got[3], *got[4], *got[5]] + ([got[0]] if need_dx else [])
    flat_w = [want[1], *want[2], *want[3], *want[4], *want[5]] + ([want[0]] if need_dx else [])
    _check_all([f"out{i}" for i in range(len(flat_g))], flat_g, flat_w, BWD_TOL[bf16])
    again = ff._field_backward(spec, x, feats, B, bws, bbs, rws, rbs, g)
    flat_a = [again[1], *again[2], *again[3], *again[4], *again[5]]
    for a, b in zip(flat_a, flat_g):
        assert torch.equal(a, b)
