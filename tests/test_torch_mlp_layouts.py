"""What the wgmma bodies of the two fused-MLP kernels leave to the host, on
the CPU: at the proposal fields' widths the pair order of the encoding along
the first layer's K axis, the bf16 image of W_0^T in that order and its
inverse on the way out of the backward; the shape tests of the dispatch
(also of the base-width bodies), the launch counters and the size of the
partial."""

import numpy as np
import pytest
import torch

from nerf_kbs_tpu_torch.ops import fused_field as ff

DIMS = (80, 16, 1)


def _mlp(rng, dims):
    ws = [torch.tensor(rng.uniform(-1, 1, (a, b)) * (6.0 / a) ** 0.5, dtype=torch.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.tensor(rng.normal(size=(b,)) * 0.1, dtype=torch.float32) for b in dims[1:]]
    return ws, bs


@pytest.mark.parametrize("H", [8, 16, 40, 128])
def test_pair_order_is_a_permutation_that_pairs_s_and_c(H):
    order = ff._mlp_k_order(H)
    assert sorted(order) == list(range(2 * H))
    k = np.arange(2 * H)
    s_cols, c_cols = k[k % 16 < 8], k[k % 16 >= 8]
    # column k holds s of a frequency, column k + 8 the c of the same one
    assert (c_cols == s_cols + 8).all()
    assert (order[s_cols] < H).all() and (order[c_cols] == order[s_cols] + H).all()
    # a k-step holds 8 consecutive frequencies, k-steps in rising order
    assert (order[s_cols] == np.arange(H)).all()


@pytest.mark.parametrize("H", [4, 12, 41])
def test_pair_order_refuses_other_widths(H):
    with pytest.raises(ValueError):
        ff._mlp_k_order(H)


@pytest.mark.parametrize("rounded", [True, False])
@pytest.mark.parametrize("dims", [DIMS, (32, 16, 1), (64, 32, 3)])
def test_mlp_image_against_unpack(dims, rounded):
    """The image is W_0^T with its columns in pair order, bf16, in the core
    layout, bit for bit; from unrounded weights (the backward's) the cast
    rounds as ``_cast`` does."""
    rng = np.random.default_rng(0)
    ws, bs = _mlp(rng, dims)
    wb = ff._pack(ws, bs, dims, rounded)
    image = ff._mlp_image(wb, dims)
    K, N = dims[0], dims[1]
    assert image.dtype == torch.bfloat16 and image.numel() == N * K
    w0 = ff._cast(ff._unpack(wb, dims)[0][0], True)
    want = w0[torch.from_numpy(ff._mlp_k_order(K // 2))].T  # [N][K in pair order]
    n_, k_ = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
    got = image.float()[torch.from_numpy(ff._core_offset(n_, k_, N))]
    assert torch.equal(got, want)


def test_mlp_image_needs_whole_k_steps():
    with pytest.raises(ValueError):
        ff._mlp_image_index((80, 24, 1))


@pytest.mark.parametrize("basis", ["tri", "sincos"])
def test_pair_order_forward_and_its_inverse_on_dw0(basis):
    """Encoding and W_0 rows permuted alike give the plain pre-activation up
    to summation order, and the dW_0 the kernel accumulates in image order,
    scattered through the order, is ``_pack``'s dW_0 bit for bit. The relu
    mask is the reference's own: its forward (``_encode_grads``,
    ``_chain_fwd``) runs once and feeds both the mask and its backward
    (``_chain_bwd``), since a pre-activation within rounding of zero can
    land on either side in two separate f32 products."""
    rng = np.random.default_rng(1)
    n, H = 257, 40
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(3, H)) * 5.0, dtype=torch.float32)
    ws, bs = _mlp(rng, DIMS)
    g = torch.tensor(rng.normal(size=(1, n)), dtype=torch.float32)
    order = torch.from_numpy(ff._mlp_k_order(H))
    s, c, _, _ = ff._encode_grads(x, B, basis)
    enc = ff._cast(torch.cat([s, c]), True)
    pre, acts = ff._chain_fwd(enc, ws, bs, True)
    w0 = ff._cast(ws[0], True)
    pre_pairs = w0[order].T @ enc[order] + bs[0][:, None]
    assert float((pre[0] - pre_pairs).abs().max()) <= 1e-5
    _, dws, _ = ff._chain_bwd(ws, pre, acts, g, True, dot_first=True, need_din=False)
    dh = ff._cast(ws[1] @ g * (pre[0] > 0), True)
    in_image_order = enc[order] @ dh.T  # row k is feature order[k]
    back = torch.empty_like(in_image_order)
    back[order] = in_image_order
    assert torch.equal(back, enc @ dh.T)
    assert float((back - dws[0]).abs().max()) <= 1e-5 * float(dws[0].abs().max())


@pytest.mark.parametrize("basis", ["tri", "sincos"])
def test_pair_order_dx(basis):
    """d_enc taken k-step by k-step from the image (columns 0..7 ds, 8..15 dc
    of 8 frequencies) gives the plain dx. The relu mask and the plain dx
    share one forward of the reference (see the test above)."""
    rng = np.random.default_rng(2)
    n, H = 130, 40
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(3, H)) * 5.0, dtype=torch.float32)
    ws, bs = _mlp(rng, DIMS)
    g = torch.tensor(rng.normal(size=(1, n)), dtype=torch.float32)
    s, c, dsdu, dcdu = ff._encode_grads(x, B, basis)
    pre, acts = ff._chain_fwd(ff._cast(torch.cat([s, c]), True), ws, bs, True)
    d_enc, _, _ = ff._chain_bwd(ws, pre, acts, g, True, dot_first=True, need_din=True)
    want = ff._dx_from_denc(d_enc, dsdu, dcdu, B)
    dh = ff._cast(ws[1] @ g * (pre[0] > 0), True)
    order = ff._mlp_k_order(H)
    w0_pairs = ff._cast(ws[0], True)[torch.from_numpy(order)]  # rows in pair order
    dx = torch.zeros(3, n)
    for ks in range(H // 8):
        de = w0_pairs[16 * ks:16 * ks + 16] @ dh  # (16, n)
        hs = slice(8 * ks, 8 * ks + 8)
        dx += B[:, hs] @ (de[:8] * dsdu[hs] + de[8:] * dcdu[hs])
    assert float((dx - want).abs().max()) <= 1e-5 * max(float(want.abs().max()), 1.0)


def test_wgmma_mlp_shapes():
    def spec(**kw):
        return ff.FusedMLPSpec(**{**dict(h_freqs=40, layer_dims=DIMS), **kw})

    assert ff._wgmma_mlp(spec())
    assert ff._wgmma_mlp(spec(basis="tri", need_dx=False))
    assert not ff._wgmma_mlp(spec(bf16=False))
    assert not ff._wgmma_mlp(spec(h_freqs=32, layer_dims=(64, 16, 1)))
    assert not ff._wgmma_mlp(spec(layer_dims=(80, 32, 1)))
    assert not ff._wgmma_mlp(spec(layer_dims=(80, 16, 3)))
    assert not ff._wgmma_mlp(spec(layer_dims=(80, 16, 16, 1)))


BASE = (256, 128, 128, 16)


@pytest.mark.parametrize("kw,want", [
    ({}, True), ({"basis": "tri", "need_dx": False}, True),
    ({"bf16": False}, False),
    ({"h_freqs": 64, "layer_dims": (128, 128, 128, 16)}, False),
    ({"layer_dims": (256, 64, 64, 16)}, False),
    ({"layer_dims": (256, 128, 128, 1)}, False),
    ({"layer_dims": (256, 128, 16)}, True),
    ({"layer_dims": (256, 128, 16), "basis": "tri", "need_dx": False}, True),
    ({"layer_dims": (256, 128, 16), "bf16": False}, False),
    ({"layer_dims": (256, 128, 128, 128, 16)}, False),
    ({"layer_dims": (256, 64, 16)}, False),
    ({"layer_dims": (256, 128, 1)}, False),
    ({"h_freqs": 40, "layer_dims": DIMS}, False)])
def test_wgmma_mlp_base_shapes(kw, want):
    """The base-width bodies take bf16, H = 128, (256, 128, 128, 16) or
    (256, 128, 16) in either basis and refuse every other shape; the two
    predicates never both hold, and the body names the counter."""
    spec = ff.FusedMLPSpec(**{**dict(h_freqs=128, layer_dims=BASE), **kw})
    assert ff._wgmma_mlp_base(spec) == want
    assert not (ff._wgmma_mlp_base(spec) and ff._wgmma_mlp(spec))
    for kernel in ("fourier_mlp", "fourier_mlp_bwd"):
        body = ff._mlp_body(spec, kernel)
        assert body == ("_base_wgmma" if want else "_wgmma" if ff._wgmma_mlp(spec) else "")
        assert kernel + body in ff.LAUNCHES
        ff.FORCE_WMMA = frozenset({kernel})
        try:
            assert ff._mlp_body(spec, kernel) == ""
        finally:
            ff.FORCE_WMMA = frozenset()


def test_launch_counters_and_forcing():
    """Every kernel counts its bodies apart (the fused-MLP kernels' base-width
    bodies under keys of their own), and nothing is forced through a WMMA
    body unless a measurement names it."""
    assert set(ff.LAUNCHES) == {*ff.KERNELS, *(f"{k}_wgmma" for k in ff.KERNELS),
                                "fourier_mlp_base_wgmma", "fourier_mlp_bwd_base_wgmma"}
    assert ff.FORCE_WMMA == frozenset()
    ff.LAUNCHES["fourier_mlp_wgmma"] += 3
    ff.reset_launches()
    assert not any(ff.LAUNCHES.values())


def test_dx_launch_counters():
    """DX_LAUNCHES keeps a count for each backward body, which a launch
    with need_dx adds to beside its LAUNCHES count, and reset_launches
    clears it too."""
    assert set(ff.DX_LAUNCHES) == {"fourier_mlp_bwd", "fourier_field_mlp_bwd",
                                   "fourier_mlp_bwd_wgmma", "fourier_field_mlp_bwd_wgmma",
                                   "fourier_mlp_bwd_base_wgmma"}
    ff.reset_launches()
    ff._count("fourier_mlp_bwd_wgmma", True)
    ff._count("fourier_field_mlp_bwd_wgmma", False)
    assert ff.LAUNCHES["fourier_mlp_bwd_wgmma"] == ff.LAUNCHES["fourier_field_mlp_bwd_wgmma"] == 1
    assert {k: v for k, v in ff.DX_LAUNCHES.items() if v} == {"fourier_mlp_bwd_wgmma": 1}
    ff.reset_launches()
    assert not any(ff.LAUNCHES.values()) and not any(ff.DX_LAUNCHES.values())


@pytest.mark.parametrize("dims,want", [(DIMS, 80 * 16 + 16 + 16 * 16 + 16),
                                       ((64, 32, 3), 64 * 32 + 32 + 32 * 16 + 16)])
def test_mlp_partial_stride(dims, want):
    """One block's partial: dW_0 (80, 16), db_0 (16), dW_1 padded to (16, 16)
    and db_1 padded to 16 floats for the proposal chain."""
    assert ff._partial_stride(dims) == want


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("need_dx", [False, True])
def test_flagship_mlp_on_the_cpu_is_the_plain_version(basis, need_dx):
    """CPU tensors never reach a kernel, whatever the dispatch would choose."""
    rng = np.random.default_rng(3)
    n, H = 77, 40
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(3, H)), dtype=torch.float32)
    ws, bs = _mlp(rng, DIMS)
    g = torch.tensor(rng.normal(size=(1, n)), dtype=torch.float32)
    spec = ff.FusedMLPSpec(h_freqs=H, layer_dims=DIMS, basis=basis, need_dx=need_dx)
    ff.reset_launches()
    out = ff.fourier_mlp(spec, x, B, ws, bs)
    assert torch.equal(out, ff.fourier_mlp_reference(x, B, ws, bs, basis, True))
    dx, dws, dbs = ff._mlp_backward(spec, x, B, ws, bs, g)
    rx, rws, rbs = ff.fourier_mlp_backward_reference(x, B, ws, bs, g, basis, True, need_dx)
    assert (dx is None) == (not need_dx)
    assert all(torch.equal(a, b) for a, b in zip(dws + dbs, rws + rbs))
    assert not any(ff.LAUNCHES.values())


@pytest.mark.parametrize("basis", ["tri", "sincos"])
def test_base_mlp_on_the_cpu_is_the_plain_version(basis):
    """CPU tensors at the base widths never reach a kernel either."""
    rng = np.random.default_rng(4)
    n, H = 70, 128
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(3, H)), dtype=torch.float32)
    ws, bs = _mlp(rng, BASE)
    g = torch.tensor(rng.normal(size=(16, n)), dtype=torch.float32)
    spec = ff.FusedMLPSpec(h_freqs=H, layer_dims=BASE, basis=basis)
    ff.reset_launches()
    out = ff.fourier_mlp(spec, x, B, ws, bs)
    assert torch.equal(out, ff.fourier_mlp_reference(x, B, ws, bs, basis, True))
    dx, dws, dbs = ff._mlp_backward(spec, x, B, ws, bs, g)
    rx, rws, rbs = ff.fourier_mlp_backward_reference(x, B, ws, bs, g, basis, True, True)
    assert all(torch.equal(a, b) for a, b in zip([dx] + dws + dbs, [rx] + rws + rbs))
    assert not any(ff.LAUNCHES.values())
