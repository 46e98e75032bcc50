"""The hand-written CUDA kernels against their plain PyTorch versions on the
card, at small shapes. Marked ``cuda``: they skip on hosts without a card.
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
