"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes: the two forwards and the two backwards, every wgmma
body also at the edge N values. Marked ``cuda``: they skip on hosts without a card.
Run on a CUDA host with ``python -m pytest tests/test_torch_cuda_kernels.py``."""

from pathlib import Path

import numpy as np
import pytest
import torch

from nerf_kbs_tpu_torch.ops import fused_field as ff

pytestmark = pytest.mark.cuda

# f32: the same products summed in another order; bf16: as f32, plus a
# possible flip of one bf16 rounding where an f32 sum differs in its last bit
TOL = {False: 1e-4, True: 2e-2}
# the nerfacto field's base MLP (H = 128) as the semantics path runs it alone
# in the fused MLP kernels, through their base-width wgmma bodies in bf16;
# enough points that a weight gradient is a sum over many (see BWD_TOL)
BASE_WIDTHS = ((256, 128, 128, 16), 20000)
# semantic-nerfw's 2-layer base (H = 128, one hidden layer), the same bodies
BASE2_WIDTHS = ((256, 128, 16), 20000)


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
@pytest.mark.parametrize("dims,n", [((24, 16, 5), 300), ((80, 16, 1), 1001),
                                    BASE_WIDTHS, BASE2_WIDTHS])
def test_fourier_mlp_kernel(dev, basis, bf16, dims, n):
    rng = np.random.default_rng(0)
    x, B = _inputs(rng, dims[0] // 2, n, basis, dev)
    ws, bs = _mlp(rng, dims, dev)
    spec = ff.FusedMLPSpec(h_freqs=dims[0] // 2, layer_dims=dims, bf16=bf16, basis=basis)
    key = "fourier_mlp" + ff._mlp_body(spec, "fourier_mlp")
    before = ff.LAUNCHES[key]
    got = ff.fourier_mlp(spec, x, B, ws, bs)
    assert ff.LAUNCHES[key] == before + 1
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
                                    ((64, 32, 32, 4), 5000), BASE_WIDTHS, BASE2_WIDTHS])
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
    fwd = "fourier_mlp" + ff._mlp_body(spec, "fourier_mlp")
    bwd = "fourier_mlp_bwd" + ff._mlp_body(spec, "fourier_mlp_bwd")
    assert ff.LAUNCHES[fwd] == before[fwd] + 1
    assert ff.LAUNCHES[bwd] == before[bwd] + 1
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


# ---------------------------------------------------------------------------
# wgmma: the layout rules of csrc/wgmma_chain.cuh, then the two field kernels
# at the flagship widths, which run its bodies
# ---------------------------------------------------------------------------


def _core_image(m: torch.Tensor) -> torch.Tensor:
    """bf16 matrix m[r][c] (c contiguous) in the 8x8 core-matrix layout."""
    rows, cols = m.shape
    r, c = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    img = torch.empty(rows * cols, dtype=torch.bfloat16, device=m.device)
    img[torch.from_numpy(ff._core_offset(r, c, rows)).reshape(-1).to(m.device)] = \
        m.to(torch.bfloat16).reshape(-1)
    return img


def _probe(a_rows, a_img, a_place, b_img, b_place, ksteps, n, trans_a, trans_b):
    from nerf_kbs_tpu_torch.ops import _kernels

    out = torch.full((64, n), float("nan"), device=b_img.device)
    _kernels.call(
        "wgmma_probe", None if a_rows is None else a_rows.data_ptr(),
        0 if a_rows is None else a_rows.shape[1],
        None if a_img is None else a_img.data_ptr(), 0 if a_img is None else 2 * a_img.numel(),
        *a_place, b_img.data_ptr(), 2 * b_img.numel(), *b_place, ksteps, n, trans_a, trans_b,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return out


def _rounded(t):
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("n", [16, 32, 64, 128])
def test_wgmma_forward_layout(dev, n):
    """A in registers, W^T [n][k] in the core layout read K-major."""
    rng = np.random.default_rng(n)
    a = torch.tensor(rng.normal(size=(64, 32)), dtype=torch.float32, device=dev)
    w = torch.tensor(rng.normal(size=(32, n)), dtype=torch.float32, device=dev)
    place = (0, 32 * n, 16 * n, 128)  # start, k-step, leading, stride
    want = _rounded(a) @ _rounded(w)
    got = _probe(a, None, (0, 0, 0, 0), _core_image(w.T.contiguous()), place, 2, n, 0, 0)
    assert float((got - want).abs().max()) <= 1e-3


def test_wgmma_backward_layout(dev):
    """dh in registers times W^T: the same [out][in] image read with trans."""
    rng = np.random.default_rng(5)
    n_out, n_in, in0, n = 32, 64, 32, 32
    dh = torch.tensor(rng.normal(size=(64, n_out)), dtype=torch.float32, device=dev)
    w = torch.tensor(rng.normal(size=(n_in, n_out)), dtype=torch.float32, device=dev)
    place = (in0 * 2 * n_out, 256, 128, 16 * n_out)
    want = _rounded(dh) @ _rounded(w)[in0:in0 + n].T
    img = _core_image(w.T.contiguous())
    got = _probe(dh, None, (0, 0, 0, 0), img, place, n_out // 16, n, 0, 1)
    assert float((got - want).abs().max()) <= 1e-3


@pytest.mark.parametrize("n", [16, 64, 128])
def test_wgmma_weight_gradient_layout(dev, n):
    """act^T . dh over a tile of 64 points, both [point][feature] in shared
    memory, read with trans on both sides."""
    rng = np.random.default_rng(7 + n)
    act = torch.tensor(rng.normal(size=(64, 128)), dtype=torch.float32, device=dev)
    dh = torch.tensor(rng.normal(size=(64, n)), dtype=torch.float32, device=dev)
    a_place = (8 * 1024, 256, 128, 1024)  # features 64..127
    b_place = (0, 256, 128, 1024)
    want = _rounded(act)[:, 64:].T @ _rounded(dh)
    args = (_core_image(act), a_place, _core_image(dh), b_place)
    got = _probe(None, args[0], a_place, args[2], b_place, 4, n, 1, 1)
    assert float((got - want).abs().max()) <= 1e-3


def test_wgmma_backward_layout_16_columns(dev):
    """dh (64, 16) in registers times a 16-column slice of W_0^T [16][80]:
    the m64n16k16 shape with the trans flag, as the proposal field's dx takes
    d_enc k-step by k-step."""
    rng = np.random.default_rng(17)
    n_out, n_in = 16, 80
    dh = torch.tensor(rng.normal(size=(64, n_out)), dtype=torch.float32, device=dev)
    w = torch.tensor(rng.normal(size=(n_in, n_out)), dtype=torch.float32, device=dev)
    img = _core_image(w.T.contiguous())
    for ks in range(n_in // 16):
        place = (ks * 512, 256, 128, 16 * n_out)
        want = _rounded(dh) @ _rounded(w)[16 * ks:16 * ks + 16].T
        got = _probe(dh, None, (0, 0, 0, 0), img, place, 1, 16, 0, 1)
        assert float((got - want).abs().max()) <= 1e-3, ks


@pytest.mark.parametrize("first", [0, 16])
def test_wgmma_weight_gradient_layout_80_features(dev, first):
    """enc^T . dh over a tile of 64 points with enc [point][80 features] and
    dh [point][16]: 64 feature rows from `first` on, as the proposal field's
    dW_0 takes features [0, 64) and [16, 80)."""
    rng = np.random.default_rng(19 + first)
    enc = torch.tensor(rng.normal(size=(64, 80)), dtype=torch.float32, device=dev)
    dh = torch.tensor(rng.normal(size=(64, 16)), dtype=torch.float32, device=dev)
    a_place = (first // 8 * 1024, 256, 128, 1024)
    b_place = (0, 256, 128, 1024)
    want = _rounded(enc)[:, first:first + 64].T @ _rounded(dh)
    got = _probe(None, _core_image(enc), a_place, _core_image(dh), b_place, 4, 16, 1, 1)
    assert float((got - want).abs().max()) <= 1e-3


FLAGSHIP_BASE = (256, 128, 128, 16)
EDGE_N = [1, 63, 64, 65, 64 * 3 + 1, 5000]


def _flagship(rng, n, F, basis, dev):
    x, B = _inputs(rng, 128, n, basis, dev)
    rgb_dims = (15 + F, 64, 64, 3)
    bws, bbs = _mlp(rng, FLAGSHIP_BASE, dev)
    rws, rbs = _mlp(rng, rgb_dims, dev)
    feats = torch.tensor(rng.normal(size=(F, n)), dtype=torch.float32, device=dev)
    spec = dict(h_freqs=128, feat_dim=F, base_dims=FLAGSHIP_BASE, rgb_dims=rgb_dims, bf16=True,
                basis=basis)
    return x, B, feats, bws, bbs, rws, rbs, spec


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("F", [16, 48])
@pytest.mark.parametrize("n", EDGE_N)
def test_fourier_field_kernel_flagship(dev, basis, F, n):
    rng = np.random.default_rng(11)
    x, B, feats, bws, bbs, rws, rbs, kw = _flagship(rng, n, F, basis, dev)
    spec = ff.FusedFieldSpec(**kw)
    before = dict(ff.LAUNCHES)
    got = ff.fourier_field_mlp(spec, x, feats, B, bws, bbs, rws, rbs)
    assert ff.LAUNCHES["fourier_field_mlp_wgmma"] == before["fourier_field_mlp_wgmma"] + 1
    assert ff.LAUNCHES["fourier_field_mlp"] == before["fourier_field_mlp"]
    want = ff.fourier_field_reference(x, feats, B, bws, bbs, rws, rbs, basis, True)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL[True]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("F", [16, 48])
@pytest.mark.parametrize("n", EDGE_N)
def test_fourier_field_backward_kernel_flagship(dev, basis, need_dx, F, n):
    rng = np.random.default_rng(13)
    x, B, feats, bws, bbs, rws, rbs, kw = _flagship(rng, n, F, basis, dev)
    g = torch.tensor(rng.normal(size=(4, n)), dtype=torch.float32, device=dev)
    spec = ff.FusedFieldSpec(need_dx=need_dx, **kw)
    before, before_dx = dict(ff.LAUNCHES), dict(ff.DX_LAUNCHES)
    got = ff._field_backward(spec, x, feats, B, bws, bbs, rws, rbs, g)
    assert ff.LAUNCHES["fourier_field_mlp_bwd_wgmma"] == before["fourier_field_mlp_bwd_wgmma"] + 1
    assert ff.DX_LAUNCHES == {**before_dx, "fourier_field_mlp_bwd_wgmma":
                              before_dx["fourier_field_mlp_bwd_wgmma"] + int(need_dx)}
    assert ff.LAUNCHES["fourier_field_mlp_bwd"] == before["fourier_field_mlp_bwd"]
    want = ff.fourier_field_backward_reference(x, feats, B, bws, bbs, rws, rbs, g, basis, True,
                                               need_dx)
    torch.cuda.synchronize()
    assert (got[0] is None) == (not need_dx)
    flat_g = [got[1], *got[2], *got[3], *got[4], *got[5]] + ([got[0]] if need_dx else [])
    flat_w = [want[1], *want[2], *want[3], *want[4], *want[5]] + ([want[0]] if need_dx else [])
    names = (["dfeats"] + [f"d_base_w{i}" for i in range(3)] + [f"d_base_b{i}" for i in range(3)]
             + [f"d_rgb_w{i}" for i in range(3)] + [f"d_rgb_b{i}" for i in range(3)] + ["dx"])
    # One bf16 rounding of a hidden activation that falls the other way in
    # kernel and plain version can flip a relu mask downstream, at a handful
    # of points in thousands. With this few points a weight gradient then
    # moves by percents. So: the last rgb layer's gradients, which pass no
    # mask, against the plain version; every output against the WMMA body,
    # which masks and rounds at the same places (the tests above hold that
    # body to the plain version); and the per-point outputs against the plain
    # version at all but a few points.
    _check_all([names[9], names[12]], [flat_g[9], flat_g[12]], [flat_w[9], flat_w[12]],
               BWD_TOL[True])
    ff.FORCE_WMMA = frozenset({"fourier_field_mlp_bwd"})
    try:
        old = ff._field_backward(spec, x, feats, B, bws, bbs, rws, rbs, g)
    finally:
        ff.FORCE_WMMA = frozenset()
    flat_o = [old[1], *old[2], *old[3], *old[4], *old[5]] + ([old[0]] if need_dx else [])
    _check_all(names, flat_g, flat_o, 1e-3)
    for a, b in [(flat_g[0], flat_w[0])] + ([(flat_g[-1], flat_w[-1])] if need_dx else []):
        off = ((a - b).abs() > BWD_TOL[True] * b.abs().max()).any(dim=0)
        assert int(off.sum()) <= max(1, n // 500)
    again = ff._field_backward(spec, x, feats, B, bws, bbs, rws, rbs, g)
    flat_a = [again[1], *again[2], *again[3], *again[4], *again[5]]
    for a, b in zip(flat_a, flat_g):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the two proposal-field kernels at the flagship widths (H = 40, (80, 16, 1)),
# which run their wgmma bodies
# ---------------------------------------------------------------------------

MLP_DIMS = (80, 16, 1)
# one past the tiles that the resident warpgroups of a 132-SM card take at once
MLP_EDGE_N = EDGE_N + [64 * 132 * 8 + 1]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("n", MLP_EDGE_N)
def test_fourier_mlp_kernel_flagship(dev, basis, n):
    rng = np.random.default_rng(21)
    x, B = _inputs(rng, 40, n, basis, dev)
    ws, bs = _mlp(rng, MLP_DIMS, dev)
    spec = ff.FusedMLPSpec(h_freqs=40, layer_dims=MLP_DIMS, bf16=True, basis=basis)
    before = dict(ff.LAUNCHES)
    got = ff.fourier_mlp(spec, x, B, ws, bs)
    assert ff.LAUNCHES["fourier_mlp_wgmma"] == before["fourier_mlp_wgmma"] + 1
    assert ff.LAUNCHES["fourier_mlp"] == before["fourier_mlp"]
    want = ff.fourier_mlp_reference(x, B, ws, bs, basis, True)
    ff.FORCE_WMMA = frozenset({"fourier_mlp"})
    try:
        old = ff.fourier_mlp(spec, x, B, ws, bs)
    finally:
        ff.FORCE_WMMA = frozenset()
    assert ff.LAUNCHES["fourier_mlp"] == before["fourier_mlp"] + 1
    torch.cuda.synchronize()
    assert got.shape == (1, n) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL[True]
    assert float((got - old).abs().max()) <= TOL[True]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("n", MLP_EDGE_N)
def test_fourier_mlp_backward_kernel_flagship(dev, basis, need_dx, n):
    rng = np.random.default_rng(23)
    x, B = _inputs(rng, 40, n, basis, dev)
    ws, bs = _mlp(rng, MLP_DIMS, dev)
    g = torch.tensor(rng.normal(size=(1, n)), dtype=torch.float32, device=dev)
    spec = ff.FusedMLPSpec(h_freqs=40, layer_dims=MLP_DIMS, bf16=True, basis=basis,
                           need_dx=need_dx)

    def flat(res):
        return [*res[1], *res[2]] + ([res[0]] if need_dx else [])

    before = dict(ff.LAUNCHES)
    got = ff._mlp_backward(spec, x, B, ws, bs, g)
    assert ff.LAUNCHES["fourier_mlp_bwd_wgmma"] == before["fourier_mlp_bwd_wgmma"] + 1
    assert ff.LAUNCHES["fourier_mlp_bwd"] == before["fourier_mlp_bwd"]
    want = ff.fourier_mlp_backward_reference(x, B, ws, bs, g, basis, True, need_dx)
    ff.FORCE_WMMA = frozenset({"fourier_mlp_bwd"})
    try:
        old = ff._mlp_backward(spec, x, B, ws, bs, g)
    finally:
        ff.FORCE_WMMA = frozenset()
    torch.cuda.synchronize()
    assert (got[0] is None) == (not need_dx)
    names = ["dW0", "dW1", "db0", "db1", "dx"]
    # db_1 = sum of g passes no mask and no rounding: against the plain
    # version. Every output against the WMMA body, which rounds and masks at
    # the same places (the tests above hold that body to the plain version)
    # and differs in the order of the f32 sums only. Against the plain version
    # a relu mask can fall the other way at a point, which moves a gradient
    # summed over few points by percents: there dx is held at all but a few
    # points, and the weight gradients once the points are thousands.
    _check_all([names[3]], [flat(got)[3]], [flat(want)[3]], 1e-4)
    _check_all(names, flat(got), flat(old), 2e-3)
    if n >= 5000:
        _check_all(names[:4], flat(got)[:4], flat(want)[:4], BWD_TOL[True])
    if need_dx:
        off = ((got[0] - want[0]).abs() > BWD_TOL[True] * want[0].abs().max()).any(dim=0)
        assert int(off.sum()) <= max(1, n // 500)
    again = ff._mlp_backward(spec, x, B, ws, bs, g)
    for a, b in zip(flat(again), flat(got)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the two fused-MLP kernels at the base widths (H = 128, (256, 128, 128, 16)
# and (256, 128, 16)), which run their base-width wgmma bodies
# ---------------------------------------------------------------------------

BASE_DIMS = [BASE_WIDTHS[0], BASE2_WIDTHS[0]]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("dims", BASE_DIMS)
def test_fourier_mlp_kernel_base(dev, basis, n, dims):
    rng = np.random.default_rng(25)
    x, B = _inputs(rng, 128, n, basis, dev)
    ws, bs = _mlp(rng, dims, dev)
    spec = ff.FusedMLPSpec(h_freqs=128, layer_dims=dims, bf16=True, basis=basis)
    before = dict(ff.LAUNCHES)
    got = ff.fourier_mlp(spec, x, B, ws, bs)
    assert ff.LAUNCHES["fourier_mlp_base_wgmma"] == before["fourier_mlp_base_wgmma"] + 1
    assert ff.LAUNCHES["fourier_mlp"] == before["fourier_mlp"]
    want = ff.fourier_mlp_reference(x, B, ws, bs, basis, True)
    ff.FORCE_WMMA = frozenset({"fourier_mlp"})
    try:
        old = ff.fourier_mlp(spec, x, B, ws, bs)
    finally:
        ff.FORCE_WMMA = frozenset()
    assert ff.LAUNCHES["fourier_mlp"] == before["fourier_mlp"] + 1
    torch.cuda.synchronize()
    assert got.shape == (16, n) and bool(torch.isfinite(got).all())
    assert float((got - want).abs().max()) <= TOL[True]
    assert float((got - old).abs().max()) <= TOL[True]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("need_dx", [False, True])
@pytest.mark.parametrize("n", EDGE_N)
@pytest.mark.parametrize("dims", BASE_DIMS)
def test_fourier_mlp_backward_kernel_base(dev, basis, need_dx, n, dims):
    rng = np.random.default_rng(27)
    x, B = _inputs(rng, 128, n, basis, dev)
    ws, bs = _mlp(rng, dims, dev)
    g = torch.tensor(rng.normal(size=(16, n)), dtype=torch.float32, device=dev)
    spec = ff.FusedMLPSpec(h_freqs=128, layer_dims=dims, bf16=True, basis=basis,
                           need_dx=need_dx)

    def flat(res):
        return [*res[1], *res[2]] + ([res[0]] if need_dx else [])

    before = dict(ff.LAUNCHES)
    got = ff._mlp_backward(spec, x, B, ws, bs, g)
    assert ff.LAUNCHES["fourier_mlp_bwd_base_wgmma"] == before["fourier_mlp_bwd_base_wgmma"] + 1
    assert ff.LAUNCHES["fourier_mlp_bwd"] == before["fourier_mlp_bwd"]
    want = ff.fourier_mlp_backward_reference(x, B, ws, bs, g, basis, True, need_dx)
    ff.FORCE_WMMA = frozenset({"fourier_mlp_bwd"})
    try:
        old = ff._mlp_backward(spec, x, B, ws, bs, g)
    finally:
        ff.FORCE_WMMA = frozenset()
    torch.cuda.synchronize()
    assert (got[0] is None) == (not need_dx)
    L = len(dims) - 1
    names = [f"dW{i}" for i in range(L)] + [f"db{i}" for i in range(L)] + ["dx"]
    # the last layer's dW and db pass no mask: against the plain version. Every output
    # against the WMMA body, which rounds and masks at the same places and
    # differs in the order of the f32 sums only. Against the plain version a
    # relu mask can fall the other way at a point, which moves a gradient
    # summed over few points by percents: there dx is held at all but a few
    # points, and the weight gradients once the points are thousands.
    last = [L - 1, 2 * L - 1]
    _check_all([names[i] for i in last], [flat(got)[i] for i in last],
               [flat(want)[i] for i in last], BWD_TOL[True])
    _check_all(names, flat(got), flat(old), 2e-3)
    if n >= 5000:
        _check_all(names[:2 * L], flat(got)[:2 * L], flat(want)[:2 * L], BWD_TOL[True])
    if need_dx:
        off = ((got[0] - want[0]).abs() > BWD_TOL[True] * want[0].abs().max()).any(dim=0)
        assert int(off.sum()) <= max(1, n // 500)
    again = ff._mlp_backward(spec, x, B, ws, bs, g)
    for a, b in zip(flat(again), flat(got)):
        assert torch.equal(a, b)


def _segment_sum_in_pieces(v: np.ndarray, idx: np.ndarray, n: int, piece: int = 256):
    """The short-row kernel's order in NumPy scalars of v's dtype: each run
    in ascending q within pieces of ``piece`` entries, the pieces' sums in
    order."""
    out = np.zeros((v.shape[0], n), v.dtype)
    for r in range(v.shape[0]):
        row = idx[min(r, idx.shape[0] - 1)]
        for e in range(n):
            lo, hi = np.searchsorted(row, e), np.searchsorted(row, e + 1)
            s, k = v.dtype.type(0), lo
            while k < hi:
                end = min(hi, (k // piece + 1) * piece)
                p = v.dtype.type(0)
                for j in range(k, end):
                    p = p + v[r, j]
                s, k = s + p, end
            out[r, e] = s
    return out


def _segment_sum_by_key_order(v, keys, perm=None, span=None, own=None, out=None,
                              tile=1024, items=4, threads=256):
    """The by-key kernel's order (csrc/segment_sum.cu, regime 2) in NumPy
    scalars of v's dtype: tiles of ``tile`` sorted positions, ``items``
    consecutive positions a thread added serially from a run's head, the
    threads' last partials scanned Kogge-Stone within each warp, the warps'
    totals combined in ascending order, and runs that cross tiles finished
    from their tiles' partials in ascending tile order."""
    F, M = v.shape[0], len(keys)
    span = int(keys.max()) + 1 if span is None else span
    own = span if own is None else own
    out = np.zeros((F, span), v.dtype) if out is None else out.copy()
    out[:, :own] = 0
    vals = v if perm is None else v[:, perm]
    head = np.ones(M, bool)
    head[1:] = keys[1:] != keys[:-1]
    end = np.ones(M, bool)
    end[:-1] = keys[1:] != keys[:-1]
    ntiles = -(-M // tile)
    part = np.zeros((F, 2, ntiles), v.dtype)

    def put(f, k, x):
        if 0 <= k < span:
            out[f, k] = x if k < own else out[f, k] + x

    def comb(c, x):  # (h, a) + (h', a')
        return (c[0] or x[0], x[1] if x[0] else c[1] + x[1])

    for f in range(F):
        for tl in range(ntiles):
            base, last = tl * tile, min(tl * tile + tile, M) - 1
            s, agg = {}, []
            for t in range(threads):
                sv, hd = None, False
                for i in range(items):
                    p = base + t * items + i
                    if p >= M:
                        break
                    x = vals[f, p]
                    sv = x if (i == 0 or head[p]) else sv + x
                    s[p] = sv
                    hd |= bool(head[p])
                agg.append((hd, sv if sv is not None else v.dtype.type(0)))
            warps = threads // 32
            incl = []
            for w in range(warps):
                a = agg[w * 32:(w + 1) * 32]
                for d in (1, 2, 4, 8, 16):
                    a = [a[l] if l < d else comb(a[l - d], a[l]) for l in range(32)]
                incl.append(a)
            wc = [None] * warps
            c = incl[0][31]
            for w in range(1, warps):
                wc[w] = c
                c = comb(c, incl[w][31])
            for t in range(threads):
                w, lane = divmod(t, 32)
                if t == 0:
                    carry = None
                elif w == 0:
                    carry = incl[0][lane - 1]
                else:
                    carry = wc[w] if lane == 0 else comb(wc[w], incl[w][lane - 1])
                for i in range(items):
                    p = base + t * items + i
                    if p >= M:
                        break
                    if not end[p] and p != last:
                        continue
                    in_thread = any(head[base + t * items + j] for j in range(i + 1))
                    total, began = s[p], in_thread
                    if not in_thread and carry is not None:
                        total, began = carry[1] + s[p], carry[0]
                    if began and end[p]:
                        put(f, int(keys[p]), total)
                    else:
                        part[f, 0 if end[p] else 1, tl] = total
        for tl in range(ntiles - 1):
            lp = (tl + 1) * tile - 1
            k = keys[lp]
            if keys[lp + 1] != k or (tl > 0 and keys[tl * tile - 1] == k):
                continue
            sm, u = part[f, 1, tl], tl + 1
            while True:
                ul = min((u + 1) * tile, M) - 1
                if ul + 1 < M and keys[ul] == k and keys[ul + 1] == k:
                    sm = sm + part[f, 1, u]
                    u += 1
                else:
                    sm = sm + part[f, 0, u]
                    break
            put(f, int(k), sm)
    return out


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["short_rows", "long_runs", "shared_index_row", "one_element"])
def test_segment_sum_kernel(dev, dtype, case):
    """The fixed-order segment sum against its order written out in NumPy
    (bit for bit: the pieces of the short-row kernel, or the by-key kernel's
    tiles for an index row that the value rows share) and against
    scatter_add_ on the CPU (serial: the same bits where no run of a row's
    own index row crosses a 256-entry piece, else within the rounding of a
    sum in any order); a repeat gives the same bits."""
    from nerf_kbs_tpu_torch.ops import segment_sum as seg

    rng = np.random.default_rng(1)
    if case == "short_rows":
        v, i, n = rng.normal(size=(3000, 48)), np.sort(rng.integers(0, 97, (3000, 48)), -1), 97
    elif case == "long_runs":
        v, i, n = rng.normal(size=(2, 7000)), np.full((2, 7000), 3), 8
        i[:, :5], i[:, -7:] = 0, 7
    elif case == "shared_index_row":
        v, i, n = rng.normal(size=(2, 5000)), np.sort(rng.integers(0, 300, (1, 5000)), -1), 300
    else:
        v, i, n = rng.normal(size=(500, 1)), rng.integers(0, 3, (500, 1)), 3
    v = v.astype(dtype)
    vt, it = torch.as_tensor(v), torch.as_tensor(i, dtype=torch.int32)
    shared = case == "shared_index_row"
    counter = "segment_sum_by_key" if shared else "segment_sum"
    before = seg.LAUNCHES[counter]
    got = seg.segment_sum(vt.to(dev), it.to(dev), n)
    again = seg.segment_sum(vt.to(dev), it.to(dev), n)
    torch.cuda.synchronize()
    assert seg.LAUNCHES[counter] == before + 2 and torch.equal(got, again)
    want = _segment_sum_by_key_order(v, i[0], span=n) if shared else _segment_sum_in_pieces(v, i, n)
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    serial = seg.segment_sum_reference(vt, it, n)
    if v.shape[1] <= 256 and not shared:
        assert torch.equal(got.cpu(), serial)
    bound = v.shape[1] * np.finfo(dtype).eps * np.abs(v).sum(-1, keepdims=True)
    assert np.all(np.abs(got.cpu().numpy() - serial.numpy()) <= bound)


def _by_key_case(case, rng):
    """(keys (M,) sorted, span) of one case of the by-key kernel."""
    if case == "long_runs":  # a run of 7,000 between short ones
        keys = np.full(9000, 5)
        keys[:1000], keys[8000:] = np.sort(rng.integers(0, 5, 1000)), 6 + np.arange(1000) % 3
        return np.sort(keys), 10
    if case == "empty_targets_one_entry_runs":
        return np.sort(rng.choice(200_000, 9000, replace=False)), 200_000
    if case == "run_across_many_tiles":  # edges on and off the 1,024-entry tiles
        keys = np.repeat(np.arange(6), [1024, 3 * 1024, 5000, 1, 1023, 30_000])
        return keys, 6
    return np.sort(rng.integers(0, 300, 20_000)), 300  # a shared row, many short runs


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["long_runs", "empty_targets_one_entry_runs",
                                  "run_across_many_tiles", "short_runs"])
@pytest.mark.parametrize("permuted", [False, True])
@pytest.mark.parametrize("rows", ["three_rows", "two_interleaved"])
def test_segment_sum_by_key_kernel(dev, dtype, case, permuted, rows):
    """The by-key kernel (F = 3 rows, or 2 interleaved as the hash levels'
    (M, 2) cotangents, sharing one sorted index row, read through a
    permutation or not) against its order written out in NumPy, bit for
    bit, into a column span of a wider output whose targets past ``own``
    keep what they held and add the sums; a repeat gives the same bits."""
    from nerf_kbs_tpu_torch.ops import segment_sum as seg

    rng = np.random.default_rng(2)
    keys, n = _by_key_case(case, rng)
    M = len(keys)
    F = 3 if rows == "three_rows" else 2
    v = rng.normal(size=(F, M)).astype(dtype)
    perm = rng.permutation(M) if permuted else None
    own = n - n // 4
    pre = rng.normal(size=(F, n + 7)).astype(dtype)
    wide = torch.as_tensor(pre, device=dev)
    wide2 = wide.clone()
    vt = torch.as_tensor(v, device=dev) if F == 3 else \
        torch.as_tensor(np.ascontiguousarray(v.T), device=dev).t()
    args = (vt, torch.as_tensor(keys, device=dev, dtype=torch.int32),
            None if perm is None else torch.as_tensor(perm, device=dev, dtype=torch.int32))
    before = seg.LAUNCHES["segment_sum_by_key"]
    seg.segment_sum_by_key(*args, wide[:, 3:3 + n], own)
    seg.segment_sum_by_key(*args, wide2[:, 3:3 + n], own)
    torch.cuda.synchronize()
    assert seg.LAUNCHES["segment_sum_by_key"] == before + 2 and torch.equal(wide, wide2)
    got = wide.cpu().numpy()
    np.testing.assert_array_equal(got[:, :3], pre[:, :3])
    np.testing.assert_array_equal(got[:, 3 + n:], pre[:, 3 + n:])
    want = _segment_sum_by_key_order(v, keys, perm, n, own, pre[:, 3:3 + n])
    np.testing.assert_array_equal(got[:, 3:3 + n], want)


@pytest.mark.parametrize("span", [1, 300, 2**17, 2**19, 2**22 + 5, 2**27])
def test_radix_sort_kernel(dev, span):
    """The radix sort's keys and permutation against torch.sort(stable=True)
    exactly (one to three passes of up to 9-bit digits; duplicates
    everywhere); a repeat gives the same permutation."""
    from nerf_kbs_tpu_torch.ops import segment_sum as seg

    rng = np.random.default_rng(3)
    keys = torch.as_tensor(rng.integers(0, span, 1_000_003), dtype=torch.int32)
    keys[:5000] = span - 1
    want_keys, want_perm = torch.sort(keys, stable=True)
    before = seg.LAUNCHES["radix_sort"]
    got_keys, got_perm = seg.sort_keys(keys.to(dev), span)
    _, again = seg.sort_keys(keys.to(dev), span)
    torch.cuda.synchronize()
    assert seg.LAUNCHES["radix_sort"] == before + 2
    assert got_keys.dtype == got_perm.dtype == torch.int32
    assert torch.equal(got_keys.cpu(), want_keys)
    assert torch.equal(got_perm.cpu().long(), want_perm) and torch.equal(got_perm, again)


@pytest.mark.parametrize("entry_major", [False, True])
def test_gather_column_sets_backward_on_the_card(dev, entry_major):
    """The hash levels' gather on the card (entry-major as the hash
    encoding calls it, or feature-major): four levels whose second spills
    its far face into the third's slots, the table's gradient against the
    plain path on the CPU in f64 (f32 sums in another order), bit for bit on
    a repeat."""
    from nerf_kbs_tpu_torch.ops import segment_sum as seg

    rng = np.random.default_rng(4)
    F, T, n = 2, 4096, 50_000
    spans = [T, T + 300, T, T]
    slots = [rng.integers(0, s, n * 8) for s in spans]
    slots[0][: n * 4] = 7  # a busy slot: a run across tiles
    rows = rng.normal(size=(F, 4 * T)).astype(np.float32)
    cot = [rng.normal(size=(F, n * 8)).astype(np.float32) for _ in spans]
    sets = [(lvl * T, T, s) for lvl, s in enumerate(spans)]

    def grad(device, dtype=torch.float32, cot_of=lambda c: c):
        r = torch.tensor(rows, device=device, dtype=dtype, requires_grad=True)
        outs = seg.gather_column_sets(r, sets, [torch.as_tensor(s, device=device, dtype=torch.int32)
                                                for s in slots], entry_major)
        cots = [torch.as_tensor(cot_of(c), device=device, dtype=dtype) for c in cot]
        if entry_major:
            cots = [c.t().contiguous() for c in cots]
        torch.autograd.backward(outs, cots)
        return r.grad

    got, again = grad(dev), grad(dev)
    want = grad("cpu", torch.float64).numpy()
    scale = grad("cpu", torch.float64, np.abs).numpy()  # each slot's sum of |cotangent|
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    # f32 sums of up to 200,000 cotangents in a tree order
    assert np.all(np.abs(got.cpu().numpy() - want) <= 1e-5 * scale + 1e-6)


# the hash grid's cases (ops/hash_grid.py, csrc/hash_grid.cu): the features
# a level of each template, dense levels whose far face reaches the next
# level's slots or past the table's end, hashed levels whose corners collide
HASH_GRID_CASES = {
    # two dense levels, the second's far face past the table (clamped)
    "f1_dense_past_the_table": dict(num_levels=2, features_per_level=1, log2_hashmap_size=10,
                                    base_resolution=4, max_resolution=9),
    # dense 2 and 3 (the second spills into level 2's slots), hashed 5 and 7
    # in 64 slots: every slot of the hashed levels collides
    "f2_spill_and_collide": dict(num_levels=4, features_per_level=2, log2_hashmap_size=6,
                                 base_resolution=2, max_resolution=8),
    "f4_spill_and_collide": dict(num_levels=4, features_per_level=4, log2_hashmap_size=6,
                                 base_resolution=2, max_resolution=8),
    "f8_spill_and_collide": dict(num_levels=3, features_per_level=8, log2_hashmap_size=9,
                                 base_resolution=3, max_resolution=12),
    # the semantic-nerfw field's levels at a smaller table
    "f2_sixteen_levels": dict(num_levels=16, features_per_level=2, log2_hashmap_size=15,
                              base_resolution=16, max_resolution=2048),
}


def _hash_grid_inputs(kw, dev, n=20_000, seed=7):
    """(config, table, positions): points inside, exactly on faces (0 or 1
    on an axis), on the cube's corners and outside it."""
    from nerf_kbs_tpu_torch.ops.encoding import HashEncodingConfig

    cfg = HashEncodingConfig(**kw)
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    k = n // 10
    pts[:k, 0], pts[k:2 * k, 1], pts[2 * k:3 * k, 2] = 1.0, 0.0, rng.integers(0, 2, k)
    pts[3 * k:3 * k + 8] = [[c & 1, (c >> 1) & 1, (c >> 2) & 1] for c in range(8)]
    pts[4 * k:5 * k] = rng.uniform(-0.5, 1.5, (k, 3))
    size = cfg.features_per_level * cfg.num_levels * cfg.table_size
    table = torch.tensor(rng.uniform(-1, 1, size), dtype=torch.float32, device=dev)
    return cfg, table, torch.tensor(pts, dtype=torch.float32, device=dev)


@pytest.mark.parametrize("case", sorted(HASH_GRID_CASES))
def test_hash_grid_forward_kernel(dev, case):
    """The forward kernel against its plain version run on the card (the
    same products and adds in the same order, and the same keys: bit for
    bit) and against the plain encoding (the 8 corners' products summed in
    another order: within 8 ulps of the largest |entry|, the sum of the
    corners' |weights| being 1); a repeat gives the same bits; one launch
    counted a call."""
    from nerf_kbs_tpu_torch.ops import hash_grid as hg
    from nerf_kbs_tpu_torch.ops.encoding import hash_encoding_plain

    cfg, table, pts = _hash_grid_inputs(HASH_GRID_CASES[case], dev)
    before = hg.LAUNCHES["hash_grid_fwd"]
    enc, keys, entries = hg.hash_grid_fwd(table, pts, cfg, True)
    again, _, _ = hg.hash_grid_fwd(table, pts, cfg, False)
    torch.cuda.synchronize()
    assert hg.LAUNCHES["hash_grid_fwd"] == before + 2
    want, want_keys = hg.hash_grid_fwd_reference(entries, pts, cfg, True)
    assert torch.equal(enc, want) and torch.equal(keys, want_keys) and torch.equal(enc, again)
    plain = hash_encoding_plain(table, pts, cfg)
    assert float((enc - plain).abs().max()) <= 8 * 2.0**-24 * float(table.abs().max())


@pytest.mark.parametrize("case", sorted(HASH_GRID_CASES))
@pytest.mark.parametrize("need_dx", [False, True])
def test_hash_grid_backward_kernel(dev, case, need_dx):
    """Through the autograd Function: the table's gradient against the
    plain encoding's on the CPU in f64 (f32 products summed in another
    order: within 1e-5 of each slot's sum of |cotangent x weight|), the
    positions' gradient against the plain encoding's on the card (the
    same products summed over levels and corners in another order: 1e-5 of
    the largest), both bit for bit against the kernels' plain versions on
    the card fed to the same sort and by-key sum, and on a repeat; the
    launches (the forward, the backward, the backward's dx branch) counted."""
    from nerf_kbs_tpu_torch.ops import hash_grid as hg
    from nerf_kbs_tpu_torch.ops.encoding import hash_encoding_plain

    cfg, table, pts = _hash_grid_inputs(HASH_GRID_CASES[case], dev)
    cot = torch.tensor(np.random.default_rng(8).normal(size=(pts.shape[0], cfg.output_dim)),
                       dtype=torch.float32, device=dev)

    def grads(encode, device=dev, dtype=torch.float32, c=cot):
        tb = table.to(device, dtype, copy=True).requires_grad_()
        p = pts.to(device, copy=True).requires_grad_(need_dx)
        (encode(tb, p, cfg) * c.to(device, dtype)).sum().backward()
        return tb.grad, p.grad

    before = dict(hg.LAUNCHES)
    got, got_dx = grads(hg.hash_grid)
    again, again_dx = grads(hg.hash_grid)
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in hg.LAUNCHES.items()} == {
        "hash_grid_fwd": 2, "hash_grid_bwd": 2, "hash_grid_bwd_dx": 2 * need_dx}
    assert torch.equal(got, again) and (not need_dx or torch.equal(got_dx, again_dx))
    assert (got_dx is None) == (not need_dx)

    # the plain versions' entry cotangents and positions' gradient, the
    # same sort and sum
    _, keys, entries = hg.hash_grid_fwd(table, pts, cfg, True)
    vals, ref_dx = hg.hash_grid_bwd_reference(entries, pts, cot, cfg, True, need_dx)
    assert torch.equal(got, hg.table_gradient(keys, vals, cfg))
    kvals, _ = hg.hash_grid_bwd(entries, pts, cot, cfg, True, False)
    assert torch.equal(kvals, vals)

    want = grads(hash_encoding_plain, "cpu", torch.float64)[0].numpy()
    scale = grads(hash_encoding_plain, "cpu", torch.float64, cot.abs())[0].numpy()
    assert np.all(np.abs(got.cpu().numpy() - want) <= 1e-5 * scale + 1e-6)
    if need_dx:
        assert torch.equal(got_dx, ref_dx)
        plain_dx = grads(hash_encoding_plain)[1]
        assert float((got_dx - plain_dx).abs().max()) <= 1e-5 * float(plain_dx.abs().max())


# the JAX package's numbers for the hash grid, kept by tests/test_torch_fields.py
# (which checks them against JAX on the CPU): this host has no JAX
HASH_GRID_JAX_FILE = Path(__file__).resolve().parent / "data" / "hash_grid_jax.npz"
HASH_GRID_JAX_KEYS = ("num_levels", "features_per_level", "log2_hashmap_size",
                      "base_resolution", "max_resolution")


@pytest.mark.parametrize("case", ["f1", "f2", "f4"])
@pytest.mark.parametrize("need_dx", [False, True])
def test_hash_grid_kernels_match_jax(dev, case, need_dx):
    """The kernels through ``hash_encoding_apply`` on the card, moved to the
    CPU, against the JAX package's encoding and jax.grad of sum(enc * cot)
    on the same inputs (points inside, on faces and outside; dense levels
    spilling into the next level's slots, hashed levels colliding), with
    test_torch_fields.py's tolerances for the JAX package: the encoding
    within 1e-6 of its largest |value| (the 8 corners summed in another
    order), the table's and the positions' gradients within 1e-5 of their
    largest (another order of each slot's and each point's sum); both
    kernels launched, the backward's dx branch as asked."""
    from nerf_kbs_tpu_torch.ops import hash_grid as hg
    from nerf_kbs_tpu_torch.ops.encoding import HashEncodingConfig, hash_encoding_apply

    with np.load(HASH_GRID_JAX_FILE) as f:
        a = {k.split("/")[1]: f[k] for k in f.files if k.startswith(case + "/")}
    cfg = HashEncodingConfig(**dict(zip(HASH_GRID_JAX_KEYS, a["config"].tolist())))

    def rel(got, want):
        return float(np.abs(got.detach().cpu().numpy() - want).max()) / float(np.abs(want).max())

    tb = torch.tensor(a["table"], device=dev).requires_grad_()
    p = torch.tensor(a["pts"], device=dev).requires_grad_(need_dx)
    before = dict(hg.LAUNCHES)
    enc = hash_encoding_apply(tb, p, cfg)
    (enc * torch.tensor(a["cot"], device=dev)).sum().backward()
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in hg.LAUNCHES.items()} == {
        "hash_grid_fwd": 1, "hash_grid_bwd": 1, "hash_grid_bwd_dx": int(need_dx)}
    assert rel(enc, a["enc"]) <= 1e-6
    assert rel(tb.grad, a["d_table"]) <= 1e-5
    if need_dx:
        assert rel(p.grad, a["d_pts"]) <= 1e-5
    else:
        assert p.grad is None
