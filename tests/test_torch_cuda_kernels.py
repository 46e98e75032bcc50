"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes: the two forwards and the two backwards, every wgmma
body also at the edge N values. Marked ``cuda``: they skip on hosts without a card.
Run on a CUDA host with ``python -m pytest tests/test_torch_cuda_kernels.py``."""

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
                                    BASE_WIDTHS])
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
                                    ((64, 32, 32, 4), 5000), BASE_WIDTHS])
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
    before = dict(ff.LAUNCHES)
    got = ff._field_backward(spec, x, feats, B, bws, bbs, rws, rbs, g)
    assert ff.LAUNCHES["fourier_field_mlp_bwd_wgmma"] == before["fourier_field_mlp_bwd_wgmma"] + 1
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
# the two fused-MLP kernels at the field's base widths (H = 128, (256, 128,
# 128, 16)), which run their base-width wgmma bodies
# ---------------------------------------------------------------------------

BASE_DIMS = BASE_WIDTHS[0]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("n", EDGE_N)
def test_fourier_mlp_kernel_base(dev, basis, n):
    rng = np.random.default_rng(25)
    x, B = _inputs(rng, 128, n, basis, dev)
    ws, bs = _mlp(rng, BASE_DIMS, dev)
    spec = ff.FusedMLPSpec(h_freqs=128, layer_dims=BASE_DIMS, bf16=True, basis=basis)
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
def test_fourier_mlp_backward_kernel_base(dev, basis, need_dx, n):
    rng = np.random.default_rng(27)
    x, B = _inputs(rng, 128, n, basis, dev)
    ws, bs = _mlp(rng, BASE_DIMS, dev)
    g = torch.tensor(rng.normal(size=(16, n)), dtype=torch.float32, device=dev)
    spec = ff.FusedMLPSpec(h_freqs=128, layer_dims=BASE_DIMS, bf16=True, basis=basis,
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
    names = ["dW0", "dW1", "dW2", "db0", "db1", "db2", "dx"]
    # dW2 and db2 pass no mask: against the plain version. Every output
    # against the WMMA body, which rounds and masks at the same places and
    # differs in the order of the f32 sums only. Against the plain version a
    # relu mask can fall the other way at a point, which moves a gradient
    # summed over few points by percents: there dx is held at all but a few
    # points, and the weight gradients once the points are thousands.
    _check_all([names[2], names[5]], [flat(got)[2], flat(got)[5]],
               [flat(want)[2], flat(want)[5]], BWD_TOL[True])
    _check_all(names, flat(got), flat(old), 2e-3)
    if n >= 5000:
        _check_all(names[:6], flat(got)[:6], flat(want)[:6], BWD_TOL[True])
    if need_dx:
        off = ((got[0] - want[0]).abs() > BWD_TOL[True] * want[0].abs().max()).any(dim=0)
        assert int(off.sum()) <= max(1, n // 500)
    again = ff._mlp_backward(spec, x, B, ws, bs, g)
    for a, b in zip(flat(again), flat(got)):
        assert torch.equal(a, b)
