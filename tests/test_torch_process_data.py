"""Port vs JAX package, the preprocessing ops on the CPU in f32: every
function of ``process_data/warp.py`` and ``motion_mask.py`` (the sampler's
taps at and past the border too), the NumPy bicubic resizer against PIL and
the erode and dilate against OpenCV (bit for bit on uint8; PIL and OpenCV are
references only), the exact motion chain of ``tools/demo_motion_pipeline.py``
at a small size, and ``motion_mask_driver.run`` end to end at an awkward size
with JAX's seeded networks carried across.

RAFT's convex upsampling differs on purpose: the port lays the 8 x 8
children out as the published RAFT does, the JAX package scrambles them
(``tests/test_torch_preprocess_networks.py``). Where a JAX driver runs RAFT
here, its ``convex_upsample`` is swapped for the published layout
(``_published_convex_upsample``) so that both sides compute the same flow."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.process_data import motion_mask as JMM
from nerf_kbs_tpu.process_data import warp as JW
from nerf_kbs_tpu_torch.process_data import motion_mask as MM
from nerf_kbs_tpu_torch.process_data import warp as W
from nerf_kbs_tpu_torch.utils import images as timg

# f32 tolerances: geometry through a 3x3 inverse and products of pixel
# coordinates of a few hundred; probabilities and depths are O(1)
GEOM_ATOL = 2e-4
ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def K_of(b=2, f=50.0, cx=16.0, cy=12.0):
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]], np.float32)
    return np.tile(K, (b, 1, 1)), np.tile(np.linalg.inv(K).astype(np.float32), (b, 1, 1))


@pytest.fixture(scope="module")
def geo():
    rng = np.random.default_rng(0)
    depth = rng.uniform(2.0, 20.0, (2, 24, 32)).astype(np.float32)
    K, K_inv = K_of()
    pose6 = (rng.normal(size=(2, 6)) * np.array([0.3, 0.1, 0.5, 0.05, 0.08, 0.03])).astype(
        np.float32)
    img = rng.uniform(0, 1, (2, 3, 24, 32)).astype(np.float32)
    return depth, K, K_inv, pose6, img


def test_pixel2cam_and_cam2pixel_match_jax(geo):
    depth, K, K_inv, pose6, _ = geo
    pts_j = np.asarray(JW.pixel2cam(jnp.asarray(depth), jnp.asarray(K_inv)))
    pts_t = W.pixel2cam(t(depth), t(K_inv)).numpy()
    np.testing.assert_allclose(pts_t, pts_j, atol=GEOM_ATOL, rtol=1e-6)
    pose = np.concatenate([np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
                           pose6[:, :3, None]], -1)
    np.testing.assert_allclose(
        W.cam2pixel(t(pts_j), t(K), t(pose)).numpy(),
        np.asarray(JW.cam2pixel(jnp.asarray(pts_j), jnp.asarray(K), jnp.asarray(pose))),
        atol=GEOM_ATOL, rtol=1e-5)


@pytest.mark.parametrize("mode", ["euler", "axisangle", "quat", "matrix"])
def test_pose2flow_matches_jax(geo, mode):
    depth, K, K_inv, pose6, _ = geo
    if mode == "matrix":
        rng = np.random.default_rng(1)
        q, _ = np.linalg.qr(np.eye(3) + 0.05 * rng.normal(size=(3, 3)))
        pose = np.tile(np.concatenate([q * np.sign(np.diag(q)), [[0.2], [0.0], [0.4]]], 1),
                       (2, 1, 1)).astype(np.float32)
    else:
        pose = pose6
    want = np.asarray(JW.pose2flow(jnp.asarray(depth), jnp.asarray(pose), jnp.asarray(K),
                                   jnp.asarray(K_inv), rotation_mode=mode))
    got = W.pose2flow(t(depth), t(pose), t(K), t(K_inv), rotation_mode=mode).numpy()
    assert got.shape == (2, 2, 24, 32)
    np.testing.assert_allclose(got, want, atol=GEOM_ATOL, rtol=1e-5)


def test_grid_sample_taps_at_and_past_the_border_match_jax():
    """Coordinates on the last row and column, within one pixel past each
    edge (where some taps are inside and keep their share), far outside,
    and exact integers."""
    rng = np.random.default_rng(2)
    img = rng.uniform(-1, 1, (2, 3, 7, 9)).astype(np.float32)
    edge_u = np.array([-1.5, -1.0, -0.999, -0.25, 0.0, 0.5, 7.25, 8.0, 8.001, 8.5, 8.999, 9.0,
                       20.0], np.float32)
    edge_v = np.array([-1.0, -0.5, 0.0, 3.0, 5.75, 6.0, 6.4, 6.999, 7.0, -30.0, 2.5, 6.0, 0.0],
                      np.float32)
    uu, vv = np.meshgrid(edge_u, edge_v, indexing="ij")
    coords = np.stack([uu, vv])[None].repeat(2, 0)
    coords[1] += rng.uniform(-0.01, 0.01, coords[1].shape).astype(np.float32)
    want = np.asarray(JW.grid_sample_bilinear(jnp.asarray(img), jnp.asarray(coords)))
    got = W.grid_sample_bilinear(t(img), t(coords)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # a point half a pixel past the right edge keeps half of the last column
    np.testing.assert_allclose(got[0, :, 9, 2], 0.5 * img[0, :, 0, 8], atol=1e-6)
    assert np.all(got[0, :, 12] == 0.0) and np.all(got[0, :, :, 9] == 0.0)


def test_flow_warp_flow2oob_and_inverse_warp_match_jax(geo):
    depth, K, _, pose6, img = geo
    rng = np.random.default_rng(3)
    flow = rng.normal(0, 4, (2, 2, 24, 32)).astype(np.float32)
    np.testing.assert_allclose(W.flow_warp(t(img), t(flow)).numpy(),
                               np.asarray(JW.flow_warp(jnp.asarray(img), jnp.asarray(flow))),
                               atol=ATOL)
    np.testing.assert_array_equal(W.flow2oob(t(flow)).numpy(),
                                  np.asarray(JW.flow2oob(jnp.asarray(flow))))
    for mode in ("euler", "axisangle"):
        wj, vj = JW.inverse_warp(jnp.asarray(img), jnp.asarray(depth), jnp.asarray(pose6),
                                 jnp.asarray(K), rotation_mode=mode)
        wt, vt = W.inverse_warp(t(img), t(depth), t(pose6), t(K), rotation_mode=mode)
        # a pixel landing within ~1e-4 px of the border may flip its
        # validity; inside, the sampler is continuous
        assert (vt.numpy() != np.asarray(vj)).mean() <= 1e-3
        both = (vt.numpy() & np.asarray(vj))[:, None]
        np.testing.assert_allclose(np.where(both, wt.numpy(), 0), np.where(both, wj, 0),
                                   atol=5e-4)


def test_flow_to_image_matches_jax():
    rng = np.random.default_rng(4)
    flow = rng.normal(0, 3, (20, 30, 2)).astype(np.float32)
    np.testing.assert_array_equal(W.flow_to_image(flow), JW.flow_to_image(flow))
    np.testing.assert_array_equal(W.flow_to_image(flow, max_flow=2.0),
                                  JW.flow_to_image(flow, max_flow=2.0))


def test_moving_probability_cosine_and_hard_mask_match_jax():
    rng = np.random.default_rng(5)
    opt = rng.normal(0, 2, (2, 30, 40)).astype(np.float32)
    rig = rng.normal(0, 2, (2, 30, 40)).astype(np.float32)
    opt[:, 5:15, 10:20] += 8.0
    pj = np.asarray(JMM.moving_probability(jnp.asarray(opt), jnp.asarray(rig)))
    pt = MM.moving_probability(t(opt), t(rig)).numpy()
    np.testing.assert_allclose(pt, pj, atol=ATOL)
    np.testing.assert_allclose(MM.cosine_flow_distance(t(opt), t(rig)).numpy(),
                               np.asarray(JMM.cosine_flow_distance(jnp.asarray(opt),
                                                                   jnp.asarray(rig))), atol=ATOL)
    hj = np.asarray(JMM.hard_motion_mask(jnp.asarray(pj), 0.3))
    ht = MM.hard_motion_mask(t(pj), 0.3).numpy()
    assert ht.dtype == np.uint8
    np.testing.assert_array_equal(ht, hj)


def test_disparity_post_processing_and_depth_match_jax():
    rng = np.random.default_rng(6)
    l, r = rng.uniform(0, 1, (2, 1, 12, 37)).astype(np.float32)
    np.testing.assert_allclose(
        MM.post_process_disparity(t(l), t(r)).numpy(),
        np.asarray(JMM.post_process_disparity(jnp.asarray(l), jnp.asarray(r))), atol=ATOL)
    sj, dj = JMM.disp_to_depth(jnp.asarray(l))
    st, dt = MM.disp_to_depth(t(l))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-6)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), rtol=1e-6)
    for cam in ("kitti", "tum", "other"):
        np.testing.assert_allclose(MM.metric_depth(dt, cam).numpy(),
                                   np.asarray(JMM.metric_depth(dj, cam)), rtol=1e-6)


def test_host_fusion_components_panoptic_and_render_match_jax():
    rng = np.random.default_rng(7)
    motion = (rng.uniform(0, 1, (40, 60)) > 0.6).astype(np.uint8)
    motion[5:20, 5:25] = 1
    ins = np.ones((40, 60), np.float32)
    ins[4:22, 4:26] = 0.0
    for m_th in (0.6, 0.99):
        for a, b in zip(MM.fuse_instance_motion_mask(ins, motion, m_th),
                        JMM.fuse_instance_motion_mask(ins, motion, m_th)):
            np.testing.assert_array_equal(a, b)
    # an instance mask at another size goes through the nearest zoom
    small = ins[::2, ::2]
    for a, b in zip(MM.fuse_instance_motion_mask(small, motion),
                    JMM.fuse_instance_motion_mask(small, motion)):
        np.testing.assert_array_equal(a, b)
    inst = JMM.instances_from_components(motion, min_area=20)
    np.testing.assert_array_equal(MM.instances_from_components(motion, min_area=20), inst)
    np.testing.assert_array_equal(MM.per_object_fusion(inst, motion),
                                  JMM.per_object_fusion(inst, motion))
    pano = rng.integers(0, 20, (40, 60, 3)).astype(np.uint8)
    np.testing.assert_array_equal(MM.panoptic_to_dynamic_mask(pano),
                                  JMM.panoptic_to_dynamic_mask(pano))
    img = rng.integers(0, 256, (40, 60, 3)).astype(np.uint8)
    np.testing.assert_array_equal(MM.render_mask_on_image(img, motion),
                                  JMM.render_mask_on_image(img, motion))


@pytest.mark.parametrize("radius", [1, 3, 10])
def test_erode_mask_matches_jax_and_opencv(radius):
    pytest.importorskip("cv2")
    rng = np.random.default_rng(radius)
    mask = (rng.uniform(0, 1, (50, 70)) > 0.15).astype(np.uint8)
    mask[:, :3] = 1
    np.testing.assert_array_equal(MM.erode_mask(mask, radius), JMM.erode_mask(mask, radius))


@pytest.mark.parametrize("size,iters", [(10, 4), (10, 1), (5, 2), (4, 3)])
def test_dilate_mask_matches_jax_and_opencv(size, iters):
    """OpenCV's cross with its anchor at size // 2 (for an even size the arms
    reach one pixel further up and left), iterated, with a border that never
    grows from outside the image."""
    pytest.importorskip("cv2")
    rng = np.random.default_rng(size * 10 + iters)
    mask = (rng.uniform(0, 1, (45, 61)) > 0.98).astype(np.uint8)
    mask[0, 30] = mask[44, 0] = mask[20, 60] = 1
    np.testing.assert_array_equal(MM.dilate_mask(mask, size, iters),
                                  JMM.dilate_mask(mask, size, iters))


def test_morphology_of_grey_levels_matches_opencv():
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(8)
    g = rng.integers(0, 256, (33, 47), dtype=np.uint8)
    for size in (2, 3, 7, 10, 21):
        ell = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (size, size))
        cross = cv2.getStructuringElement(cv2.MORPH_CROSS, (size, size))
        np.testing.assert_array_equal(timg.erode(g, timg.ellipse_offsets(size)), cv2.erode(g, ell))
        np.testing.assert_array_equal(timg.dilate(g, timg.cross_offsets(size), 2),
                                      cv2.dilate(g, cross, iterations=2))


@pytest.mark.parametrize("ih,iw,oh,ow", [(376, 1241, 192, 640), (376, 1241, 240, 432),
                                         (90, 161, 90, 161), (37, 53, 90, 161), (50, 7, 13, 17),
                                         (240, 432, 91, 33)])
def test_resize_bicubic_matches_pil(ih, iw, oh, ow):
    """PIL's default ``Image.resize`` filter (BICUBIC) bit for bit on uint8,
    RGB and grey, down and up; an equal size returns the pixels as they
    are."""
    Image = pytest.importorskip("PIL.Image")
    rng = np.random.default_rng(ih + iw)
    img = rng.integers(0, 256, (ih, iw, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timg.resize_bicubic(img, ow, oh),
                                  np.asarray(Image.fromarray(img).resize((ow, oh))))
    np.testing.assert_array_equal(timg.resize_bicubic(img[..., 1], ow, oh),
                                  np.asarray(Image.fromarray(img[..., 1]).resize((ow, oh))))


def test_exact_motion_chain_matches_the_jax_tool(tmp_path, monkeypatch):
    """The chain of ``tools/demo_motion_pipeline.py`` (exact depth and pose
    -> pose2flow -> moving_probability -> hard mask -> components ->
    per-object fusion, scored against the true dynamic masks) at 4 frames of
    94 x 310: the JAX tool itself against the port's
    ``process_data.exact_chain.exact_motion_chain`` on the CPU, mask for
    mask."""
    pytest.importorskip("PIL.Image")
    from nerf_kbs_tpu_torch.process_data.exact_chain import exact_motion_chain
    from nerf_kbs_tpu_torch.utils.images import decode_png

    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parent.parent / "tools"))
    import demo_motion_pipeline

    out = tmp_path / "jax"
    monkeypatch.setattr(sys, "argv", ["demo", "--frames", "4", "--h", "94", "--w", "310",
                                      "--out", str(out), "--platform", ""])
    demo_motion_pipeline.main()
    want = json.loads((out / "result.json").read_text())
    got = exact_motion_chain(4, 94, 310, 0.3, device="cpu")
    assert len(got["masks"]) == 3
    for i, m in enumerate(got["masks"]):
        np.testing.assert_array_equal(m * 255, decode_png((out / f"mask_{i:03d}.png").read_bytes()))
    np.testing.assert_allclose(got["per_frame_iou"], want["per_frame_iou"], atol=5e-5)
    assert abs(got["mean_iou"] - want["mean_iou"]) < 1e-9
    assert got["median_static_flow_err_px"] == pytest.approx(want["median_static_flow_err_px"],
                                                             abs=1e-4)


def _published_convex_upsample(flow, mask):
    """RAFT's convex upsampling with the children where the published RAFT
    puts them (the port's ``convex_upsample``), in the JAX package's NHWC."""
    b, h, w, _ = flow.shape
    m = jax.nn.softmax(mask.reshape(b, h, w, 9, 8, 8), axis=3)
    fp = jnp.pad(8.0 * flow, ((0, 0), (1, 1), (1, 1), (0, 0)))
    neigh = jnp.stack([fp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)],
                      axis=3)
    up = jnp.einsum("bhwkuv,bhwkc->bhuwvc", m, neigh)
    return up.reshape(b, 8 * h, 8 * w, 2)


@pytest.fixture(scope="module")
def driver_runs(tmp_path_factory):
    """The JAX driver and the port's at 90 x 161 (a multiple of neither 8
    nor 32) over 3 frames, RAFT at 2 iterations, the same seeded flax
    variables in both (handed to the JAX driver in place of its own init,
    carried to the port's networks by ``convert``)."""
    Image = pytest.importorskip("PIL.Image")
    from nerf_kbs_tpu.process_data import motion_mask_driver as jdrv
    from nerf_kbs_tpu.process_data.networks import monodepth2 as jmd
    from nerf_kbs_tpu.process_data.networks import raft as jraft
    from nerf_kbs_tpu_torch.process_data import convert
    from nerf_kbs_tpu_torch.process_data import motion_mask_driver as drv
    from nerf_kbs_tpu_torch.process_data.networks.monodepth2 import Monodepth2
    from nerf_kbs_tpu_torch.process_data.networks.raft import RAFT, RaftConfig
    from tests.test_torch_preprocess_networks import seeded_flax

    root = tmp_path_factory.mktemp("driver")
    d = root / "frames"
    d.mkdir()
    rng = np.random.default_rng(0)
    base = rng.uniform(0, 255, (90, 161, 3)).astype(np.uint8)
    for i in range(3):
        Image.fromarray(np.roll(base, shift=2 * i, axis=1)).save(d / f"{i:03d}.png")

    def cfg(out):
        return dict(image_path=str(d), output_path=str(root / out), camera="custom", fx=100.0,
                    fy=100.0, cx=80.0, cy=45.0, width=161, height=90, raft_iters=2)

    m2_vars = seeded_flax(jmd.Monodepth2().init, 90, 161, seed=0)
    raft_vars = seeded_flax(jraft.RAFT(jraft.RaftConfig(iters=2)).init, 90, 161, seed=1)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jraft, "convex_upsample", _published_convex_upsample)
        mp.setattr(jmd.Monodepth2, "init", lambda self, key, h, w: m2_vars)
        mp.setattr(jraft.RAFT, "init", lambda self, key, h, w: raft_vars)
        jdrv.run(jdrv.MotionMaskConfig(**cfg("jax")))
    finally:
        mp.undo()

    m2 = Monodepth2()
    m2.load_state_dict(convert.monodepth2_from_jax(m2_vars))
    raft = RAFT(RaftConfig(iters=2))
    raft.load_state_dict(convert.raft_from_jax(raft_vars))
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(drv, "build_networks", lambda c, dev: (m2.eval(), raft.eval(), None))
        res = drv.run(drv.MotionMaskConfig(**cfg("torch")), device="cpu")
    finally:
        mp.undo()
    return root, res


def test_motion_mask_driver_matches_jax_end_to_end(driver_runs):
    """Every output PNG and poses.npy. Masks go by the share of differing
    pixels (a moving probability within ~1e-6 of the threshold may fall
    either side in f32), at most 0.2%; the 8-bit probability and depth
    images by one level; the rigid flow's colour coding by its share."""
    from nerf_kbs_tpu_torch.utils.images import decode_png

    root, res = driver_runs
    assert res["frames"] == 2
    pj, pt = np.load(root / "jax" / "poses.npy"), np.load(root / "torch" / "poses.npy")
    assert pt.shape == (2, 4, 4)
    np.testing.assert_allclose(pt, pj, atol=1e-6)
    for sub, rule in (("hard_mask", "share"), ("combined_mask", "share"), ("rendered", "share"),
                      ("moving_prob", "level"), ("depth_show", "level"), ("cam_flow", "share")):
        files = sorted((root / "jax" / sub).glob("*.png"))
        assert [f.name for f in files] == ["000.png", "001.png"], sub
        for f in files:
            a = decode_png(f.read_bytes()).astype(int)
            b = decode_png((root / "torch" / sub / f.name).read_bytes()).astype(int)
            assert a.shape == b.shape and a.shape[:2] == (90, 161), sub
            if rule == "level":
                assert np.abs(a - b).max() <= 1, sub
            else:
                assert (a != b).any(axis=-1 if a.ndim == 3 else None).mean() <= 2e-3, sub
