"""Port vs JAX package, the preprocessing networks on the CPU in f32: the
ResNet encoder, monodepth2's disparities at 4 scales and its pose, RAFT
(``compute_flow`` with ``all_iters``, the correlation pyramid and
``lookup_corr``'s channel order), the segmenter (seeded, and the committed
``outputs/segmenter3`` checkpoint through ``predict`` and
``extract_instances``) and the inpainting generator, each on the JAX
module's weights carried across by ``process_data.convert``; the public-
layout loaders (``load_raft_weights``, ``load_monodepth2_weights``) against
the JAX loaders on synthetic state dicts.

Tolerances (f32, different summation orders in XLA's and MKL's
convolutions): 1e-5 absolute on O(1) outputs (disparities, images,
probabilities), relative 1e-5 on features and on RAFT's flow in pixels.

One difference is deliberate and pinned here: RAFT's convex upsampling. The
port puts child (u, v) of coarse pixel (i, j) at (8i + u, 8j + v), as the
published RAFT does; the JAX package flattens the children in the wrong
order (``test_convex_upsample_lays_children_out_as_published``), so the
port's flow is held against JAX's through ``scrambled_as_jax``."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.process_data.networks import inpaint_net as jinp
from nerf_kbs_tpu.process_data.networks import monodepth2 as jmd
from nerf_kbs_tpu.process_data.networks import raft as jraft
from nerf_kbs_tpu.process_data.networks import resnet as jres
from nerf_kbs_tpu.process_data.networks import segmenter as jseg
from nerf_kbs_tpu.process_data.networks.raft_port import load_raft_weights as j_load_raft
from nerf_kbs_tpu_torch.process_data import convert
from nerf_kbs_tpu_torch.process_data.networks import init_weights
from nerf_kbs_tpu_torch.process_data.networks import inpaint_net as tinp
from nerf_kbs_tpu_torch.process_data.networks import monodepth2 as tmd
from nerf_kbs_tpu_torch.process_data.networks import raft as traft
from nerf_kbs_tpu_torch.process_data.networks import resnet as tres
from nerf_kbs_tpu_torch.process_data.networks import segmenter as tseg
from nerf_kbs_tpu_torch.process_data.networks.raft_port import load_raft_weights
from tests.test_networks import _fake_raft_state_dict
from tests.test_port_oracles import _fake_depth_decoder_sd, _fake_resnet18_sd, _randn

SEGMENTER3 = str(Path(__file__).resolve().parent.parent / "outputs" / "segmenter3"
                 / "segmenter.npz")


def scrambled_as_jax(up: torch.Tensor) -> np.ndarray:
    """The JAX package's layout of an upsampled flow, NHWC (B, 8h, 8w, 2),
    from the port's (B, 2, 8h, 8w): JAX flattens the children as (h, v, w,
    c, u) where (h, u, w, v, c) is meant."""
    b, _, hh, ww = up.shape
    t = up.reshape(b, 2, hh // 8, 8, ww // 8, 8).permute(0, 2, 5, 4, 1, 3)
    return t.reshape(b, hh, ww, 2).numpy()


def tonp(tree):
    return jax.tree.map(np.asarray, tree)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def seeded_flax(init, *args, seed: int = 0) -> dict:
    """Flax variables of ``init(key, *args)``'s tree and shapes
    (``jax.eval_shape``: traced, not run), filled from a NumPy seed:
    kernels from N(0, 1 / fan_in), biases N(0, 0.05), norm scales and
    BatchNorm variances U(0.5, 1.5), BatchNorm means N(0, 0.05). Every leaf
    is away from flax's init values, so that each conversion is tested; and
    the JAX initialisers, which take tens of seconds to compile op by op on
    the CPU, are not run."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, *args), jax.random.PRNGKey(0))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            # (in, out), HWIO, or (C, heads, hd) / (heads, hd, C) for attention
            fan = leaf.shape[0] if leaf.ndim == 3 and path[-2].key != "out" else \
                int(np.prod(leaf.shape[:-1]))
            return rng.normal(0, 1 / np.sqrt(fan), leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return rng.normal(0, 0.05, leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


@pytest.mark.parametrize("layers,in_images", [((2, 2, 2, 2), 1), ((3, 4, 6, 3), 2)])
def test_resnet_encoder_matches_jax(layers, in_images):
    rng = np.random.default_rng(len(layers) + sum(layers))
    j = jres.ResNetEncoder(layers=layers, num_input_images=in_images)
    x = rng.uniform(0, 1, (2, 37, 50, 3 * in_images)).astype(np.float32)
    jv = seeded_flax(j.init, jnp.asarray(x), seed=sum(layers))
    want = jax.jit(j.apply)(jv, jnp.asarray(x))
    m = tres.ResNetEncoder(layers=layers, num_input_images=in_images)
    m.load_state_dict(convert.resnet_from_jax(jv))
    with torch.no_grad():
        got = m(nchw(x))
    assert len(got) == 5
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())


@pytest.fixture(scope="module")
def monodepth(rng):
    jm = jmd.Monodepth2()
    jv = seeded_flax(jm.init, 64, 96)
    m = tmd.Monodepth2()
    m.load_state_dict(convert.monodepth2_from_jax(jv))
    return jm, jv, m.eval()


def test_monodepth2_disparity_at_every_scale_matches_jax(monodepth, rng):
    """The decoder's 4 sigmoid disparities at an odd-ish size (70 x 90: the
    decoder crops the upsampled map to each skip)."""
    jm, jv, m = monodepth
    x = rng.uniform(0, 1, (2, 70, 90, 3)).astype(np.float32)
    want = jax.jit(lambda v, x: jm.depth_decoder.apply(
        v["depth_decoder"], jm.encoder.apply(v["encoder"], x)))(jv, jnp.asarray(x))
    with torch.no_grad():
        got = m.depth_decoder(m.encoder(nchw(x)))
        full = m.predict_disparity(nchw(x))
    assert sorted(got) == [0, 1, 2, 3]
    for s in range(4):
        assert got[s].shape == np.asarray(want[s]).shape
        np.testing.assert_allclose(got[s].numpy(), np.asarray(want[s]), atol=1e-5)
    np.testing.assert_array_equal(full.numpy(), got[0].numpy())


def test_monodepth2_pose_matches_jax(monodepth, rng):
    jm, jv, m = monodepth
    a, b = rng.uniform(0, 1, (2, 1, 64, 96, 3)).astype(np.float32)
    want = np.asarray(jax.jit(jm.predict_pose)(jv, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = m.predict_pose(nchw(a), nchw(b)).numpy()
    assert got.shape == (1, 6)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def raft_pair():
    jr = jraft.RAFT(jraft.RaftConfig(iters=2))
    rv = seeded_flax(jr.init, 32, 40, seed=1)
    r = traft.RAFT(traft.RaftConfig(iters=2))
    r.load_state_dict(convert.raft_from_jax(rv))
    return jr, rv, r.eval()


def test_raft_compute_flow_all_iters_matches_jax(raft_pair):
    """32 x 40 (a 4 x 5 coarse grid: the pyramid's last level is empty, as
    in JAX), 2 iterations, every iteration's upsampled flow and the final
    one, in JAX's (scrambled) layout."""
    jr, rv, r = raft_pair
    rng = np.random.default_rng(2)
    a = rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
    b = np.roll(a, 3, axis=2)
    want = np.asarray(jax.jit(lambda v, a, b: jr.compute_flow(v, a, b, all_iters=True))(
        rv, jnp.asarray(a), jnp.asarray(b)))
    with torch.no_grad():
        got = r.compute_flow(nchw(a), nchw(b), all_iters=True)
        last = r.compute_flow(nchw(a), nchw(b))
    assert got.shape == (2, 2, 2, 32, 40)
    got_j = np.stack([scrambled_as_jax(g) for g in got])
    scale = np.abs(want).max()
    np.testing.assert_allclose(got_j, want, atol=1e-5 * scale)
    np.testing.assert_array_equal(last.numpy(), got[-1].numpy())


def test_correlation_pyramid_matches_jax():
    rng = np.random.default_rng(3)
    f1, f2 = rng.normal(size=(2, 1, 5, 7, 16)).astype(np.float32)
    want = jraft.correlation_pyramid(jnp.asarray(f1), jnp.asarray(f2), 4)
    got = traft.correlation_pyramid(nchw(f1), nchw(f2), 4)
    for g, w in zip(got, want):
        w = np.asarray(w).transpose(0, 3, 1, 2)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def test_lookup_corr_channel_order_matches_jax():
    """Each level holds its pixel index at (y, x) as 100 y + x, so a tap's
    value names where it sampled: channel 81 l + 9 i + j of pixel (y, x)
    must sample level l at (y / 2^l + i - 4, x / 2^l + j - 4), the window's
    row offset outer and column offset inner (zero outside). The same
    against JAX's lookup at fractional coordinates."""
    h, w = 6, 11
    levels = [torch.tensor([[100.0 * y + x for x in range(w >> lv)] for y in range(h >> lv)])
              for lv in range(3)]
    pyramid = [lv.reshape(1, 1, *lv.shape).expand(h * w, 1, *lv.shape).contiguous()
               for lv in levels]
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32),
                            torch.arange(w, dtype=torch.float32), indexing="ij")
    coords = torch.stack([gy, gx])[None]
    out = traft.lookup_corr(pyramid, coords, radius=4)
    assert out.shape == (1, 3 * 81, h, w)
    for lv in range(3):
        for i in range(9):
            for j in range(9):
                ch = 81 * lv + 9 * i + j
                for y, x in ((0, 0), (3, 5), (5, 10)):
                    sy, sx = y / 2**lv + i - 4, x / 2**lv + j - 4
                    hl, wl = h >> lv, w >> lv
                    if float(sy).is_integer() and float(sx).is_integer():
                        inside = 0 <= sy < hl and 0 <= sx < wl
                        want = 100.0 * sy + sx if inside else 0.0
                        assert float(out[0, ch, y, x]) == pytest.approx(want), (lv, i, j, y, x)
    rng = np.random.default_rng(4)
    frac = coords + torch.from_numpy(rng.uniform(-2, 2, (1, 2, h, w)).astype(np.float32))
    want = np.asarray(jraft.lookup_corr([jnp.asarray(p.permute(0, 2, 3, 1).numpy())
                                         for p in pyramid],
                                        jnp.asarray(frac.permute(0, 2, 3, 1).numpy()), 4))
    np.testing.assert_allclose(traft.lookup_corr(pyramid, frac, 4).permute(0, 2, 3, 1).numpy(),
                               want, atol=2e-3)


def test_convex_upsample_lays_children_out_as_published():
    """A constant coarse flow (1, -0.5) with uniform masks upsamples to 8x
    itself at every fine pixel whose 3x3 neighbourhood is inside: the port
    does; the JAX package's ``convex_upsample`` mixes the x and y flow into
    each channel and leaves columns empty (Queue 3 of ROADMAP.md). The
    port's result, re-scrambled, equals JAX's."""
    flow = np.zeros((1, 3, 4, 2), np.float32)
    flow[..., 0], flow[..., 1] = 1.0, -0.5
    mask = np.random.default_rng(5).normal(size=(1, 3, 4, 576)).astype(np.float32)
    got = traft.convex_upsample(nchw(flow), nchw(np.zeros_like(mask)))
    inner = got[0, :, 8:16, 8:24]
    np.testing.assert_allclose(inner[0].numpy(), 8.0, rtol=1e-6)
    np.testing.assert_allclose(inner[1].numpy(), -4.0, rtol=1e-6)
    jax_const = np.asarray(jraft.convex_upsample(jnp.asarray(flow), jnp.zeros((1, 3, 4, 576))))
    assert not np.allclose(jax_const[0, 8:16, 8:24, 0], 8.0)
    varied = np.random.default_rng(6).normal(size=flow.shape).astype(np.float32)
    np.testing.assert_allclose(
        scrambled_as_jax(traft.convex_upsample(nchw(varied), nchw(mask))),
        np.asarray(jraft.convex_upsample(jnp.asarray(varied), jnp.asarray(mask))), atol=1e-5)


def test_load_raft_weights_matches_the_jax_loader(tmp_path, raft_pair):
    """A public-layout checkpoint (DataParallel ``module.`` prefix): the
    port's state dict equals the JAX loader's variables converted, key for
    key, and runs."""
    sd = {("module." + k): torch.from_numpy(np.asarray(v))
          for k, v in _fake_raft_state_dict().items()}
    path = tmp_path / "raft-fake.pth"
    torch.save(sd, path)
    got = load_raft_weights(str(path))
    want = convert.raft_from_jax(tonp(j_load_raft(str(path))))
    assert sorted(got) == sorted(want) == sorted(raft_pair[2].state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_load_monodepth2_weights_matches_the_jax_loader(tmp_path):
    """The four public files (``encoder.`` prefixes, the encoder's extra
    ints, BatchNorm's ``num_batches_tracked``): every key equal to the JAX
    loader's variables converted."""
    g = torch.Generator().manual_seed(7)
    enc = _fake_resnet18_sd(g, "encoder.", 3)
    enc |= {"height": 192, "width": 640, "use_stereo": False,
            "encoder.bn1.num_batches_tracked": torch.tensor(5)}
    pose_sd = {f"net.{i}.{leaf}": _randn(g, *shape) for i, (shape_w, shape_b) in enumerate(
        [((256, 512, 1, 1), (256,)), ((256, 256, 3, 3), (256,)), ((256, 256, 3, 3), (256,)),
         ((12, 256, 1, 1), (12,))]) for leaf, shape in (("weight", shape_w), ("bias", shape_b))}
    for name, sd in (("encoder.pth", enc), ("depth.pth", _fake_depth_decoder_sd(g)),
                     ("pose_encoder.pth", _fake_resnet18_sd(g, "encoder.", 6)),
                     ("pose.pth", pose_sd)):
        torch.save(sd, tmp_path / name)
    got = tmd.load_monodepth2_weights(str(tmp_path))
    want = convert.monodepth2_from_jax(tonp(jmd.load_monodepth2_weights(str(tmp_path))))
    assert sorted(got) == sorted(want) == sorted(tmd.Monodepth2().state_dict())
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


def test_segmenter_module_matches_jax():
    """Seeded flax weights at 45 x 67 (odd sizes: the pools floor and the
    upsampled maps are edge-padded up to each skip)."""
    rng = np.random.default_rng(8)
    j = jseg.InstanceSegmenter()
    x = rng.uniform(0, 1, (1, 45, 67, 6)).astype(np.float32)
    jv = seeded_flax(j.init, jnp.asarray(x), seed=3)
    m = tseg.InstanceSegmenter()
    m.load_state_dict(convert.segmenter_from_jax(jv))
    want = np.asarray(jax.jit(j.apply)(jv, jnp.asarray(x))).transpose(0, 3, 1, 2)
    with torch.no_grad():
        got = m(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _segmenter_scene():
    """rgb, moving probability and optical flow of the port's dynamic street
    scene (two moving cars) at 94 x 310, the signals the segmenter reads."""
    from nerf_kbs_tpu_torch.data import synthetic_kitti as sk

    h, w = 94, 310
    cam = (sk.FX * w / 1242.0, sk.FY * h / 375.0, sk.CX * w / 1242.0, sk.CY * h / 375.0)
    static, movers, poses = sk.make_scene(0, 90.0 + 3 * 0.8), sk.make_movers(), sk.make_poses(3)
    rgb, _, _, dyn = sk.render_dynamic_frame(poses[1], static, movers, 1, h, w, *cam)
    flow, valid, _ = sk.render_dynamic_flow(poses[1], poses[2], static, movers, 1, 2, h, w, *cam)
    prob = dyn.astype(np.float32) * 0.9
    return rgb.astype(np.float32), prob, np.moveaxis(flow * valid[..., None], -1, 0)


def test_load_segmenter_checkpoint_predicts_and_extracts_as_jax():
    """The committed segmenter3 checkpoint read with NumPy alone: ``predict``
    to 1e-5 and ``extract_instances`` equal label for label, on both sides'
    own predictions and on the same inputs."""
    model, variables = jseg.load_segmenter(SEGMENTER3)
    port = tseg.load_segmenter(SEGMENTER3, device="cpu")
    rgb, prob, flow = _segmenter_scene()
    x = tseg.make_inputs(rgb, prob, flow)
    np.testing.assert_array_equal(x, jseg.make_inputs(rgb, prob, flow))
    fg_j, off_j = jseg.predict(model, variables, x)
    fg_t, off_t = tseg.predict(port, x)
    np.testing.assert_allclose(fg_t, fg_j, atol=1e-5)
    np.testing.assert_allclose(off_t, off_j, atol=1e-5 * np.abs(off_j).max())
    lbl_j = jseg.extract_instances(fg_j, off_j, min_area=32)
    assert lbl_j.max() >= 1
    np.testing.assert_array_equal(tseg.extract_instances(fg_t, off_t, min_area=32), lbl_j)
    np.testing.assert_array_equal(tseg.extract_instances(fg_j, off_j, min_area=32), lbl_j)


@pytest.mark.parametrize("hw", [(32, 32), (40, 48)])
def test_inpaint_generator_matches_jax(hw):
    """T = 4; at 40 x 48 the 1/4-resolution map (10 x 12) is edge-padded up
    to the 8-wide attention window and cropped back."""
    h, w = hw
    rng = np.random.default_rng(h)
    j = jinp.InpaintGenerator()
    fr = rng.uniform(0, 1, (1, 4, h, w, 3)).astype(np.float32)
    mk = (rng.uniform(0, 1, (1, 4, h, w)) > 0.7).astype(np.float32)
    jv = seeded_flax(j.init, jnp.asarray(fr), jnp.asarray(mk), seed=h)
    m = tinp.InpaintGenerator()
    m.load_state_dict(convert.inpaint_from_jax(jv))
    want = np.asarray(jax.jit(j.apply)(jv, jnp.asarray(fr), jnp.asarray(mk)))
    with torch.no_grad():
        got = m(torch.from_numpy(fr).permute(0, 1, 4, 2, 3), torch.from_numpy(mk))
    np.testing.assert_allclose(got.permute(0, 1, 3, 4, 2).numpy(), want, atol=1e-5)


def test_init_weights_is_seeded():
    """The same generator seed gives the same weights whatever the global
    RNG's state; another seed gives others."""
    a = init_weights(tinp.InpaintGenerator(), torch.Generator().manual_seed(0)).state_dict()
    torch.manual_seed(123)
    b = init_weights(tinp.InpaintGenerator(), torch.Generator().manual_seed(0)).state_dict()
    c = init_weights(tinp.InpaintGenerator(), torch.Generator().manual_seed(1)).state_dict()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    assert any(not torch.equal(a[k], c[k]) for k in a if k.endswith("weight") and a[k].ndim > 1)
