"""Port vs JAX package: pointwise ops, ray generation, samplers and the
render ops, on the CPU in f32. Inputs come from numpy with a fixed seed and
go to both sides."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.data.outputs import DataparserOutputs as JOutputs
from nerf_kbs_tpu.data.synthetic import orbit_cameras as j_orbit
from nerf_kbs_tpu.ops import contraction as jcon
from nerf_kbs_tpu.ops import encoding as jenc
from nerf_kbs_tpu.ops import fused_field as jff
from nerf_kbs_tpu.ops import mlp as jmlp
from nerf_kbs_tpu.ops import rendering as jren
from nerf_kbs_tpu.ops import samplers as jsam
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs as TOutputs
from nerf_kbs_tpu_torch.data.synthetic import orbit_cameras as t_orbit
from nerf_kbs_tpu_torch.ops import contraction as tcon
from nerf_kbs_tpu_torch.ops import encoding as tenc
from nerf_kbs_tpu_torch.ops import fused_field as tff
from nerf_kbs_tpu_torch.ops import mlp as tmlp
from nerf_kbs_tpu_torch.ops import rendering as tren
from nerf_kbs_tpu_torch.ops import samplers as tsam

# pointwise f32 ops: both sides do the same float operations up to ordering
ATOL = 1e-5


def close(got, want, atol=ATOL, rtol=1e-5, err_msg=""):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=atol, rtol=rtol, err_msg=err_msg)


def t(a):
    return torch.as_tensor(np.asarray(a))


def test_contract_to_unit_cube_t():
    x = np.random.default_rng(0).normal(size=(3, 7, 9)).astype(np.float32) * 3.0
    close(tcon.contract_to_unit_cube_t(t(x)), jcon.contract_to_unit_cube_t(jnp.asarray(x)))


@pytest.mark.parametrize("levels", [1, 2, 3, 4])
def test_sh_encoding(levels):
    d = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    close(tenc.sh_encoding(t(d), levels), jenc.sh_encoding(jnp.asarray(d), levels))


@pytest.mark.parametrize("progress", [0.0, 0.37, 1.0])
def test_fourier_window_and_resolutions(progress):
    jc = jenc.FourierEncodingConfig(num_levels=5, features_per_level=16, base_resolution=4,
                                    max_resolution=256)
    tc = tenc.FourierEncodingConfig(num_levels=5, features_per_level=16, base_resolution=4,
                                    max_resolution=256)
    assert tc.output_dim == jc.output_dim
    np.testing.assert_allclose(tc.resolutions, jc.resolutions)
    close(tenc.fourier_window(tc, progress, "cpu"), jenc.fourier_window(jc, progress))


def test_fourier_encoding_init_scales():
    tc = tenc.FourierEncodingConfig(num_levels=4, features_per_level=8, base_resolution=4,
                                    max_resolution=64)
    B = tenc.fourier_encoding_init(tc, torch.Generator().manual_seed(0), "cpu")
    assert B.shape == (3, 16)
    # each column is a unit direction times its level's resolution
    want = np.repeat(np.asarray(tc.resolutions, np.float32), 4)
    close(torch.linalg.vector_norm(B, dim=0), want)


def test_tri_waves_and_trunc_exp():
    u = np.linspace(-5.3, 5.3, 997).astype(np.float32)
    close(tff.tri_s(t(u)), jff.tri_s(jnp.asarray(u)))
    close(tff.tri_c(t(u)), jff.tri_c(jnp.asarray(u)))
    x = np.linspace(-20, 20, 101).astype(np.float32)
    close(tmlp.trunc_exp(t(x)), jmlp.trunc_exp(jnp.asarray(x)), rtol=1e-6, atol=0)


def test_mlp_init_dims():
    cfg = tmlp.MLPConfig(in_dim=256, num_layers=3, layer_width=128, out_dim=16)
    p = tmlp.mlp_init(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jmlp.mlp_init(jax.random.PRNGKey(0), jmlp.MLPConfig(256, 3, 128, 16))
    assert [tuple(w.shape) for w in p["w"]] == [tuple(w.shape) for w in jp["w"]]
    assert [tuple(b.shape) for b in p["b"]] == [tuple(b.shape) for b in jp["b"]]
    assert float(p["w"][0].abs().max()) <= (6.0 / 256) ** 0.5


def test_orbit_cameras_copy():
    want, got = j_orbit(5, h=6, w=8), t_orbit(5, h=6, w=8)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _cameras(distortion: bool):
    cams = j_orbit(3, h=6, w=8)
    if distortion:
        cams["distortion"] = np.tile(
            np.array([[0.05, -0.02, 0.01, 0.003, 0.002, -0.001]], np.float32), (3, 1))
    box = np.array([[-1.0] * 3, [1.0] * 3])
    return JOutputs([], cams, box).cameras(), TOutputs([], cams, box).cameras("cpu")


@pytest.mark.parametrize("distortion", [False, True])
def test_generate_rays(distortion):
    jc, tc = _cameras(distortion)
    idx = np.stack(np.meshgrid(np.arange(3), np.arange(6), np.arange(8), indexing="ij"),
                   -1).reshape(-1, 3).astype(np.int32)
    jr = jcam.generate_rays(jc, jnp.asarray(idx))
    tr = tcam.generate_rays(tc, t(idx))
    for k in ("origins", "directions", "directions_norm", "camera_indices"):
        close(getattr(tr, k), getattr(jr, k), err_msg=k)
    close(tr.pixel_area, jr.pixel_area, atol=1e-7, rtol=1e-4)


def _rays(n=20, seed=2):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    jr = jcam.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                        pixel_area=jnp.full((n, 1), 1e-4),
                        camera_indices=jnp.zeros((n, 1), jnp.int32),
                        directions_norm=jnp.ones((n, 1)))
    tr = tcam.RayBundle(origins=t(o), directions=t(d), pixel_area=torch.full((n, 1), 1e-4),
                        camera_indices=torch.zeros(n, 1, dtype=torch.int32),
                        directions_norm=torch.ones(n, 1))
    return jren.near_far_collider(jr, 0.05, 1000.0), tren.near_far_collider(tr, 0.05, 1000.0)


@pytest.mark.parametrize("spacing", ["uniform", "lindisp", "piecewise"])
def test_uniform_sampler(spacing):
    jr, tr = _rays()
    js = jsam.uniform_sampler(jr, 16, spacing=spacing, key=None)
    ts = tsam.uniform_sampler(tr, 16, spacing=spacing)
    close(tr.nears, jr.nears)
    for k in ("spacing_starts", "spacing_ends", "starts", "ends"):
        close(getattr(ts, k), getattr(js, k), err_msg=k)
    close(ts.positions_t(tr), js.positions_t(jr), rtol=1e-5, atol=1e-4)


def test_bracket_values_equal_compare_all():
    rng = np.random.default_rng(3)
    R, S, Q = 12, 24, 17
    w = rng.random((R, S)).astype(np.float32) + 0.01
    cdf = np.concatenate([np.zeros((R, 1)), np.cumsum(w / w.sum(-1, keepdims=True), -1)], -1)
    cdf = np.minimum(cdf, 1.0).astype(np.float32)
    cdf[:, -1] = 1.0
    edges = np.sort(rng.random((R, S + 1)), -1).astype(np.float32)
    u = np.broadcast_to(
        np.linspace(0, 1 - 1 / Q, Q, dtype=np.float32) + np.float32(0.5 / Q), (R, Q)).copy()
    u[0, :3] = cdf[0, 3:6]  # queries exactly on a cdf value
    want = jsam._bracket_values(jnp.asarray(cdf), jnp.asarray(edges), jnp.asarray(u))
    got = tsam._bracket_values(t(cdf), t(edges), t(u))
    for g, wv in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(wv))


def test_pdf_sampler_and_proposal_weights():
    jr, tr = _rays()
    js = jsam.uniform_sampler(jr, 24, spacing="piecewise", key=None)
    ts = tsam.uniform_sampler(tr, 24, spacing="piecewise")
    w = np.random.default_rng(4).random((20, 24)).astype(np.float32) ** 4
    jw = jsam.anneal_weights(jnp.asarray(w), 1.0)
    tw = tsam.anneal_weights(t(w), 1.0)
    close(tw, jw)
    jn = jsam.pdf_sampler(jr, js, jw, 12, spacing="piecewise", key=None)
    tn = tsam.pdf_sampler(tr, ts, tw, 12, spacing="piecewise")
    for k in ("spacing_starts", "spacing_ends", "starts", "ends"):
        close(getattr(tn, k), getattr(jn, k), err_msg=k)


def test_render_ops():
    jr, tr = _rays()
    js = jsam.uniform_sampler(jr, 16, spacing="uniform", key=None)
    ts = tsam.uniform_sampler(tr, 16, spacing="uniform")
    dens = (np.random.default_rng(5).random((20, 16)) * 0.02).astype(np.float32)
    jw = jren.render_weights(jnp.asarray(dens), js.deltas)
    tw = tren.render_weights(t(dens), ts.deltas)
    close(tw, jw)
    close(tren.render_accumulation(tw), jren.render_accumulation(jw))
    close(tren.render_median_depth(tw, ts), jren.render_median_depth(jw, js), rtol=1e-5)
    close(tren.render_expected_depth(tw, ts), jren.render_expected_depth(jw, js), rtol=1e-5)
