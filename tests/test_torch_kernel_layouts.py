"""What the wgmma field kernels' host side decides, on the CPU: the shifted
rgb weight matrix, the weight image's layout, and the sizes of the scratch
and partial tensors the wrappers allocate; the same for the fused-MLP
kernels' base-width bodies (the base chain's image alone, their scratch)."""

import numpy as np
import pytest
import torch

from nerf_kbs_tpu_torch.ops import fused_field as ff

FLAGSHIP_BASE = (256, 128, 128, 16)


def _mlp(rng, dims):
    ws = [torch.tensor(rng.uniform(-1, 1, (a, b)) * (6.0 / a) ** 0.5, dtype=torch.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.tensor(rng.normal(size=(b,)) * 0.1, dtype=torch.float32) for b in dims[1:]]
    return ws, bs


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("F,base_dims,rgb_hidden", [(16, FLAGSHIP_BASE, (64, 64)),
                                                    (48, FLAGSHIP_BASE, (64, 64)),
                                                    (16, (64, 32, 16), (32,)),
                                                    (9, (24, 16, 8), (16, 16))])
def test_shifted_rgb_rows_give_the_same_field(basis, F, base_dims, rgb_hidden):
    """The rgb chain fed [sigma_raw; geo; feats] through a first matrix with
    a zero row in front gives the unshifted result in f32, to a few ulps: the
    zero row is exact in the algebra, but a CPU sgemm picks its blocking (and
    so its summation order) from the product's shape and the host's vector
    width, and the two chains' products differ in K and N (one row, one
    column). With MKL on its AVX2 path they differ by up to 1.2e-7 absolute
    and 5.5e-7 relative."""
    rng = np.random.default_rng(0)
    n, H, G = 301, base_dims[0] // 2, base_dims[-1] - 1
    rgb_dims = (G + F, *rgb_hidden, 3)
    x = torch.tensor(rng.random((3, n)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(3, H)) * 3.0, dtype=torch.float32)
    feats = torch.tensor(rng.normal(size=(F, n)), dtype=torch.float32)
    bws, bbs = _mlp(rng, base_dims)
    rws, rbs = _mlp(rng, rgb_dims)
    want = ff.fourier_field_reference(x, feats, B, bws, bbs, rws, rbs, basis, False)
    # a base chain whose output repeats sigma_raw: the reference then feeds
    # [sigma_raw; geo; feats] to the rgb chain
    bws2 = bws[:-1] + [torch.cat([bws[-1][:, :1], bws[-1]], dim=1)]
    bbs2 = bbs[:-1] + [torch.cat([bbs[-1][:1], bbs[-1]])]
    rws2 = [ff._shift_rgb_rows(rws[0])] + rws[1:]
    assert rws2[0].shape == (1 + G + F, rgb_dims[1]) and not rws2[0][0].any()
    got = ff.fourier_field_reference(x, feats, B, bws2, bbs2, rws2, rbs, basis, False)
    eps = torch.finfo(torch.float32).eps
    torch.testing.assert_close(got, want, rtol=8 * eps, atol=2 * eps)


@pytest.mark.parametrize("base_dims,rgb_dims", [
    (FLAGSHIP_BASE, (31, 64, 64, 3)), (FLAGSHIP_BASE, (63, 64, 64, 3)),
    ((64, 32, 32, 16), (31, 32, 3)), ((24, 16, 8), (16, 16, 16, 3))])
def test_weight_image_against_unpack(base_dims, rgb_dims):
    """Every layer of the image is W^T, padded to 16 with zeros, in the core
    layout; the rgb chain's first matrix is shifted down one row."""
    rng = np.random.default_rng(1)
    bws, bbs = _mlp(rng, base_dims)
    rws, rbs = _mlp(rng, rgb_dims)
    base_wb = ff._pack(bws, bbs, base_dims, True)
    rgb_wb = ff._pack(rws, rbs, rgb_dims, True)
    image = ff._weight_image(base_wb, rgb_wb, base_dims, rgb_dims)
    assert image.dtype == torch.bfloat16
    off = 0
    layers = [(w, 0) for w in ff._unpack(base_wb, base_dims)[0]]
    layers += [(w, int(i == 0)) for i, w in enumerate(ff._unpack(rgb_wb, rgb_dims)[0])]
    for w, shift in layers:
        din, dout = w.shape
        K, N = ff._pad16(din + shift), ff._pad16(dout)
        want = torch.zeros(N, K)
        want[:dout, shift:shift + din] = w.T
        n_, k_ = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
        at = torch.from_numpy(ff._core_offset(n_, k_, N))
        got = image[off:off + N * K].float()[at]
        assert torch.equal(got, want)  # the packed weights are already bf16 values
        off += N * K
    assert off == image.numel()


@pytest.mark.parametrize("rounded", [True, False])
def test_base_image_against_unpack(rounded):
    """The base-width bodies' image is the base chain's part of the field's
    image: every layer W^T in the core layout, bf16, bit for bit; from
    unrounded weights (the backward's) the cast rounds as ``_cast`` does."""
    rng = np.random.default_rng(2)
    ws, bs = _mlp(rng, FLAGSHIP_BASE)
    wb = ff._pack(ws, bs, FLAGSHIP_BASE, rounded)
    image = ff._base_image(wb, FLAGSHIP_BASE)
    assert image.dtype == torch.bfloat16 and image.numel() * 2 == 102400
    off = 0
    for w in ff._unpack(wb, FLAGSHIP_BASE)[0]:
        K, N = w.shape
        n_, k_ = np.meshgrid(np.arange(N), np.arange(K), indexing="ij")
        got = image[off:off + N * K].float()[torch.from_numpy(ff._core_offset(n_, k_, N))]
        assert torch.equal(got, ff._cast(w, True).T)
        off += N * K
    assert off == image.numel()
    rgb_wb = ff._pack(*_mlp(rng, (31, 64, 64, 3)), (31, 64, 64, 3), rounded)
    field = ff._weight_image(wb, rgb_wb, FLAGSHIP_BASE, (31, 64, 64, 3))
    assert torch.equal(field[:image.numel()], image)


def test_core_offset_is_a_permutation_of_cores():
    r, c = np.meshgrid(np.arange(64), np.arange(128), indexing="ij")
    off = ff._core_offset(r, c, 64)
    assert sorted(off.reshape(-1)) == list(range(64 * 128))
    # 8 rows by 8 columns are 64 contiguous elements, a row 8 of them
    assert off[8, 16] == (2 * 8 + 1) * 64 and off[9, 16] - off[8, 16] == 8
    assert off[8, 17] - off[8, 16] == 1


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 193, 786432, 1000003])
@pytest.mark.parametrize("F", [16, 48])
def test_field_scratch_bytes(n, F):
    acts = np.array([128, 128, 16 + F, 64, 64])  # layer inputs but the encoding
    grads = np.array([128, 128, 16, 64, 64, 16])  # pre-activation gradients
    tiles = -(-n // 64)
    assert ff._field_scratch_bytes(n, F) == int(tiles * 64 * 2 * (acts.sum() + grads.sum()))


@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 193, 196608, 1000003])
def test_mlp_base_scratch_bytes(n):
    acts = [128, 128]  # the hidden layers' inputs (the encoding is recomputed)
    grads = [128, 128, 16]  # the three pre-activation gradients
    assert ff._mlp_base_scratch_bytes(n) == -(-n // 64) * 64 * 2 * (sum(acts) + sum(grads))


@pytest.mark.parametrize("chains", [
    (FLAGSHIP_BASE, (31, 64, 64, 3)), (FLAGSHIP_BASE, (63, 64, 64, 3)),
    ((80, 16, 1),), ((64, 32, 32, 16), (31, 32, 3))])
def test_partial_stride(chains):
    def pad(v):
        return int(np.ceil(v / 16) * 16)

    want = sum(pad(a) * pad(b) + pad(b) for dims in chains for a, b in zip(dims, dims[1:]))
    assert ff._partial_stride(*chains) == want


def test_wgmma_shapes():
    def spec(**kw):
        base = dict(h_freqs=128, feat_dim=16, base_dims=FLAGSHIP_BASE, rgb_dims=(31, 64, 64, 3))
        return ff.FusedFieldSpec(**{**base, **kw})

    assert ff._wgmma_field(spec())
    assert ff._wgmma_field(spec(feat_dim=48, rgb_dims=(63, 64, 64, 3), basis="tri"))
    assert not ff._wgmma_field(spec(bf16=False))
    assert not ff._wgmma_field(spec(feat_dim=32, rgb_dims=(47, 64, 64, 3)))
    assert not ff._wgmma_field(spec(rgb_dims=(31, 64, 3)))
    assert not ff._wgmma_field(spec(h_freqs=64, base_dims=(128, 128, 128, 16)))
