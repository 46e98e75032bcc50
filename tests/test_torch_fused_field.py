"""Port vs JAX package: the fused Fourier MLP and the fully fused field.

The JAX side runs its Pallas kernels in interpret mode on the CPU; the port
runs its wrappers on CPU tensors, which take the plain PyTorch versions.
Inputs come from numpy with fixed seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.models import fields as jfields
from nerf_kbs_tpu.ops import fused_field as jff
from nerf_kbs_tpu.ops.encoding import FourierEncodingConfig as JFourier
from nerf_kbs_tpu.ops.encoding import fourier_window as j_window
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.models import fields as tfields
from nerf_kbs_tpu_torch.ops import fused_field as tff
from nerf_kbs_tpu_torch.ops.encoding import FourierEncodingConfig as TFourier
from nerf_kbs_tpu_torch.ops.encoding import fourier_window as t_window

# f32 field outputs: the same float operations in another summation order
ATOL = 1e-4
# bf16 compute: both sides round at the same points, but a last-bit
# difference in an f32 sum can flip one bf16 rounding (2^-8 relative)
ATOL_BF16 = 2e-2


def _mlp(rng, dims):
    ws = [(rng.uniform(-1, 1, (a, b)) * (6.0 / a) ** 0.5).astype(np.float32)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [(rng.normal(size=(b,)) * 0.1).astype(np.float32) for b in dims[1:]]
    return ws, bs


def _case(seed, H, n, basis):
    rng = np.random.default_rng(seed)
    x = rng.random((3, n)).astype(np.float32)
    B = (rng.normal(size=(3, H)) * 7.0).astype(np.float32)
    if basis == "sincos":
        B = (B * 2 * np.pi).astype(np.float32)
    return rng, x, B


def _t(arrs):
    return [torch.as_tensor(a) for a in arrs]


def _j(arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("basis", ["tri", "sincos"])
# the last case is the nerfacto field's base MLP (H = 128), which the
# semantics path runs alone in this kernel; 130 points are ragged against
# JAX's 128-point tile
@pytest.mark.parametrize("dims,n", [((24, 16, 5), 300), ((24, 16, 16, 1), 190),
                                    ((256, 128, 128, 16), 130)])
@pytest.mark.parametrize("bf16", [False, True])
def test_fourier_mlp_matches_jax_kernel(basis, dims, n, bf16):
    H = dims[0] // 2
    rng, x, B = _case(0, H, n, basis)
    ws, bs = _mlp(rng, dims)
    jspec = jff.FusedMLPSpec(h_freqs=H, layer_dims=dims, tile=128, interpret=True,
                             bf16=bf16, basis=basis)
    want = np.asarray(jff.fourier_mlp(jspec, jnp.asarray(x), jnp.asarray(B), _j(ws), _j(bs)))
    tspec = tff.FusedMLPSpec(h_freqs=H, layer_dims=dims, bf16=bf16, basis=basis)
    got = tff.fourier_mlp(tspec, torch.as_tensor(x), torch.as_tensor(B), _t(ws), _t(bs))
    assert got.shape == (dims[-1], n)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_BF16 if bf16 else ATOL, rtol=0)
    # CPU tensors never launch
    assert tff.LAUNCHES["fourier_mlp"] == tff.LAUNCHES["fourier_mlp_base_wgmma"] == 0


@pytest.mark.parametrize("basis", ["tri", "sincos"])
@pytest.mark.parametrize("bf16", [False, True])
def test_fourier_field_mlp_matches_jax_kernel(basis, bf16):
    n, F = 259, 5
    rng, x, B = _case(1, 12, n, basis)
    base_dims, rgb_dims = (24, 16, 16, 8), (7 + F, 16, 3)
    bws, bbs = _mlp(rng, base_dims)
    rws, rbs = _mlp(rng, rgb_dims)
    feats = rng.normal(size=(F, n)).astype(np.float32)
    jspec = jff.FusedFieldSpec(h_freqs=12, feat_dim=F, base_dims=base_dims, rgb_dims=rgb_dims,
                               tile=128, interpret=True, bf16=bf16, basis=basis)
    want = np.asarray(jff.fourier_field_mlp(
        jspec, jnp.asarray(x), jnp.asarray(feats), jnp.asarray(B), _j(bws), _j(bbs),
        _j(rws), _j(rbs)))
    tspec = tff.FusedFieldSpec(h_freqs=12, feat_dim=F, base_dims=base_dims,
                               rgb_dims=rgb_dims, bf16=bf16, basis=basis)
    got = tff.fourier_field_mlp(tspec, torch.as_tensor(x), torch.as_tensor(feats),
                                torch.as_tensor(B), _t(bws), _t(bbs), _t(rws), _t(rbs))
    assert got.shape == (4, n)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL_BF16 if bf16 else ATOL, rtol=0)


def test_plain_field_matches_jax_reference():
    n, F = 64, 4
    rng, x, B = _case(2, 6, n, "sincos")
    bws, bbs = _mlp(rng, (12, 8, 5))
    rws, rbs = _mlp(rng, (4 + F, 8, 3))
    feats = rng.normal(size=(F, n)).astype(np.float32)
    want = jff.fourier_field_reference(*_j([x, feats, B]), _j(bws), _j(bbs), _j(rws), _j(rbs))
    got = tff.fourier_field_reference(*_t([x, feats, B]), _t(bws), _t(bbs), _t(rws), _t(rbs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    want = jff.fourier_mlp_reference(*_j([x, B]), _j(bws), _j(bbs), basis="tri")
    got = tff.fourier_mlp_reference(*_t([x, B]), _t(bws), _t(bbs), basis="tri")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _field_cfgs(basis):
    kw = dict(num_levels=3, features_per_level=8, base_resolution=4, max_resolution=64,
              basis=basis)
    jd = jfields.DensityFieldConfig(encoding="fourier", fourier=JFourier(**kw), hidden_dim=16)
    td = tfields.DensityFieldConfig(encoding="fourier", fourier=TFourier(**kw), hidden_dim=16)
    fk = dict(encoding="fourier", hidden_dim=16, num_layers=3, hidden_dim_color=16,
              appearance_embedding_dim=4, num_images=3)
    jn = jfields.NerfactoFieldConfig(fourier=JFourier(**kw), **fk)
    tn = tfields.NerfactoFieldConfig(fourier=TFourier(**kw), **fk)
    return jd, td, jn, tn


@pytest.mark.parametrize("basis", ["tri", "sincos"])
def test_field_modules_with_window_fold(basis):
    """density_field_apply_t / nerfacto_field_apply_t: contraction, the window
    folded into W0, the 2*pi on B for sincos only, SH and appearance rows."""
    jd, td, jn, tn = _field_cfgs(basis)
    rng = np.random.default_rng(3)
    x_t = (rng.normal(size=(3, 6, 5)) * 2.0).astype(np.float32)
    dirs = rng.normal(size=(6, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    cams = np.array([[0], [2], [1], [0], [1], [2]], np.int32)
    jwin = j_window(jd.fourier, 0.45)
    twin = t_window(td.fourier, 0.45, "cpu")
    jp = jfields.density_field_init(jax.random.PRNGKey(0), jd)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    want = jfields.density_field_apply_t(jp, jd, jnp.asarray(x_t), window=jwin)
    got = tfields.density_field_apply_t(tp, td, torch.as_tensor(x_t), window=twin)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=ATOL)

    jp = jfields.nerfacto_field_init(jax.random.PRNGKey(1), jn)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for train in (False, True):  # mean embedding / per-camera rows
        want = jfields.nerfacto_field_apply_t(
            jp, jn, jnp.asarray(x_t), jnp.asarray(dirs), jnp.asarray(cams), train=train,
            window=j_window(jn.fourier, 0.45), need_dx=False)
        got = tfields.nerfacto_field_apply_t(
            tp, tn, torch.as_tensor(x_t), torch.as_tensor(dirs), torch.as_tensor(cams),
            train=train, window=t_window(tn.fourier, 0.45, "cpu"))
        for k in ("density", "rgb_t"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4,
                                       atol=ATOL, err_msg=k)


def test_semantics_branch_not_ported():
    """The semantics branch is ported (tests/test_torch_semantics.py); what
    stays refused is a head without classes, as in the JAX package."""
    _, _, _, tn = _field_cfgs("tri")
    with pytest.raises(ValueError, match="num_semantic_classes"):
        tfields.nerfacto_field_init(dataclasses.replace(tn, use_semantics=True),
                                    torch.Generator().manual_seed(0), "cpu")


def test_wrappers_reject_mixed_devices():
    rng, x, B = _case(4, 4, 10, "tri")
    ws, bs = _mlp(rng, (8, 4, 1))
    spec = tff.FusedMLPSpec(h_freqs=4, layer_dims=(8, 4, 1), basis="tri")
    with pytest.raises(ValueError, match="on the CPU or all on CUDA"):
        tff.fourier_mlp(spec, torch.as_tensor(x).to("meta"), torch.as_tensor(B), _t(ws), _t(bs))
