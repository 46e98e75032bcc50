"""Port vs JAX package, the SUDS stream data path on the CPU: the NumPy
resizers against PIL and OpenCV, every ``ImageMetadata`` loader against the
JAX package's (which reads with PIL and OpenCV), the metadata.json parser,
the stream's chunks row for row in both fill modes (rollover, sharding, flow
and sky rows), the flow and sky terms with their gradients, three trainer
steps over the stream with flow and sky supervision, and the scene writers'
flow. PIL and OpenCV are the references here only; the port never imports
them."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.data import image_metadata as jim
from nerf_kbs_tpu.data import stream as jstream
from nerf_kbs_tpu.data import synthetic_kitti as jsk
from nerf_kbs_tpu.data.dataparsers import suds_metadata as jsuds
from nerf_kbs_tpu.engine import optimizers as jopt
from nerf_kbs_tpu.engine.trainer import Trainer as JTrainer
from nerf_kbs_tpu.engine.trainer import TrainerConfig as JTrainerConfig
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu.ops import losses as jL
from nerf_kbs_tpu.parallel.mesh import make_mesh, shard_batch
from nerf_kbs_tpu_torch.data import image_metadata as tim
from nerf_kbs_tpu_torch.data import stream as tstream
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.data.dataparsers import suds_metadata as tsuds
from nerf_kbs_tpu_torch.engine import optimizers as topt
from nerf_kbs_tpu_torch.engine.optimizers import tree_copy_
from nerf_kbs_tpu_torch.engine.trainer import Trainer, TrainerConfig
from nerf_kbs_tpu_torch.models import nerfacto as tnerf
from nerf_kbs_tpu_torch.ops import losses as tL
from nerf_kbs_tpu_torch.utils import images as timg
from nerf_kbs_tpu_torch.utils.images import decode_png, encode_png_u8, encode_png_u16
from nerf_kbs_tpu_torch.utils.jpeg import encode_jpeg

H, W = 12, 20
SIZES = [(10, 13, 7, 20), (47, 156, 23, 78), (24, 32, 48, 64), (100, 37, 31, 29),
         (6, 6, 6, 9), (192, 640, 376, 1241)]


@pytest.mark.parametrize("ih,iw,oh,ow", SIZES)
def test_resizers_match_pil_and_opencv(ih, iw, oh, ow):
    """LANCZOS and NEAREST bit for bit with PIL on uint8 (RGB and grey);
    INTER_NEAREST bit for bit and INTER_LINEAR on float32 flow to 1e-5 with
    OpenCV."""
    Image = pytest.importorskip("PIL.Image")
    cv2 = pytest.importorskip("cv2")
    rng = np.random.default_rng(ih * iw)
    img = rng.integers(0, 256, (ih, iw, 3), dtype=np.uint8)
    np.testing.assert_array_equal(timg.resize_lanczos(img, ow, oh),
                                  np.asarray(Image.fromarray(img).resize((ow, oh), Image.LANCZOS)))
    np.testing.assert_array_equal(
        timg.resize_lanczos(img[..., 0], ow, oh),
        np.asarray(Image.fromarray(img[..., 0]).resize((ow, oh), Image.LANCZOS)))
    np.testing.assert_array_equal(
        timg.resize_nearest(img[..., 1], ow, oh),
        np.asarray(Image.fromarray(img[..., 1]).resize((ow, oh), Image.NEAREST)))
    np.testing.assert_array_equal(timg.resize_nearest_cv(img[..., 2], ow, oh),
                                  cv2.resize(img[..., 2], (ow, oh),
                                             interpolation=cv2.INTER_NEAREST))
    flow = (rng.normal(size=(ih, iw, 2)) * 20).astype(np.float32)
    np.testing.assert_allclose(timg.resize_linear_cv(flow, ow, oh),
                               cv2.resize(flow, (ow, oh), interpolation=cv2.INTER_LINEAR),
                               rtol=1e-5, atol=1e-5)


def _asset_item(tmp_path, size, fmt):
    """One frame's files at ``size`` (h, w), read as a frame of (H, W): rgb
    (PNG or JPEG), mask, sky, depth (.npy or 16-bit PNG), features, and flow
    with and without its validity channel."""
    h, w = size
    rng = np.random.default_rng(h * 7 + w)
    rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if fmt == "jpg":
        (tmp_path / "rgb.jpg").write_bytes(encode_jpeg(rgb, quality=90))
    else:
        (tmp_path / "rgb.png").write_bytes(encode_png_u8(rgb))
    (tmp_path / "mask.png").write_bytes(encode_png_u8(
        ((rng.random((h, w)) > 0.3) * 255).astype(np.uint8)))
    (tmp_path / "sky.png").write_bytes(encode_png_u8(
        ((rng.random((h, w, 3)) > 0.5) * 200).astype(np.uint8)))
    depth = rng.uniform(0, 6000, (h, w))
    if fmt == "jpg":
        (tmp_path / "depth.png").write_bytes(encode_png_u16(depth.astype(np.uint16)))
    else:
        np.save(tmp_path / "depth.npy", depth.astype(np.float32))
    np.save(tmp_path / "feat.npy", rng.normal(size=(h // 2, w // 2, 4)).astype(np.float32))
    fl = rng.normal(size=(h, w, 3)).astype(np.float32) * 5
    fl[..., 2] = rng.random((h, w)) > 0.2
    np.save(tmp_path / "flow3.npy", fl)
    np.save(tmp_path / "flow2.npy", fl[..., :2])
    kw = dict(image_path=str(tmp_path / f"rgb.{fmt}"), c2w=np.eye(4, dtype=np.float32)[:3],
              W=W, H=H, intrinsics=np.array([20.0, 20.0, W / 2, H / 2], np.float32),
              image_index=0, time=0.5, video_id=1,
              depth_path=str(tmp_path / ("depth.png" if fmt == "jpg" else "depth.npy")),
              mask_path=str(tmp_path / "mask.png"), sky_mask_path=str(tmp_path / "sky.png"),
              feature_path=str(tmp_path / "feat.npy"),
              forward_flow_path=str(tmp_path / "flow3.npy"),
              backward_flow_path=str(tmp_path / "flow2.npy"), pose_scale_factor=25.0,
              local_cache=str(tmp_path / "cache"))
    return jim.ImageMetadata(**kw), tim.ImageMetadata(**kw)


@pytest.mark.parametrize("size,fmt", [((H, W), "png"), ((9, 31), "png"), ((24, 40), "jpg"),
                                      ((7, 11), "jpg")])
def test_image_metadata_loaders_match_jax(tmp_path, size, fmt):
    """Every loader at the frame's size and resized to it: rgb (LANCZOS),
    mask and sky (NEAREST), depth (.npy and 16-bit PNG, INTER_NEAREST, over
    the pose scale), features, flow (INTER_LINEAR, rescaled displacements)
    and its validity (INTER_NEAREST); the local cache copies."""
    pytest.importorskip("PIL.Image")
    pytest.importorskip("cv2")
    j, t = _asset_item(tmp_path, size, fmt)
    np.testing.assert_array_equal(t.load_image(), j.load_image())
    for name in ("load_mask", "load_sky_mask", "load_depth", "load_features"):
        got, want = getattr(t, name)(), getattr(j, name)()
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("load_forward_flow", "load_backward_flow"):
        (gf, gv), (wf, wv) = getattr(t, name)(), getattr(j, name)()
        assert gf.shape == (H, W, 2)
        np.testing.assert_allclose(gf, wf, rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_array_equal(gv, wv, err_msg=name)
    assert any((tmp_path / "cache").rglob("*.npy"))
    t.mask_path = j.mask_path = t.sky_mask_path = j.sky_mask_path = None
    np.testing.assert_array_equal(t.load_mask(), j.load_mask())
    assert t.load_sky_mask() is None


def _write_suds_scene(root, n_frames=5, val=(2,)):
    """The port's dynamic street scene at (H, W) with sky masks from its
    semantic colours and a metadata.json over it: OpenGL camera-to-world,
    the scene's intrinsics, depth, masks, forward flow with its neighbour,
    frame ``val`` held out."""
    scene = tsk.write_dynamic_dataset(root / "scene", n_frames=n_frames, h=H, w=W)
    (scene / "sky").mkdir()
    sky = np.asarray(tsk.SEMANTIC_COLORS[tsk.SEMANTIC_CLASSES.index("sky")])
    p2 = [ln for ln in (scene / "calib.txt").read_text().splitlines() if ln.startswith("P2:")]
    P = np.array(p2[0].split()[1:], np.float64).reshape(3, 4)
    frames = []
    for i, row in enumerate(np.loadtxt(scene / "00.txt").reshape(-1, 3, 4)):
        sem = decode_png((scene / "sem" / f"{i:06}.png").read_bytes())
        (scene / "sky" / f"{i:06}.png").write_bytes(
            encode_png_u8((np.all(sem == sky, -1) * 255).astype(np.uint8)))
        c2w = row.copy()
        c2w[:, 1:3] *= -1.0  # OpenCV camera axes -> OpenGL
        fr = {"rgb_path": str(scene / "00" / f"{i:06}.png"), "c2w": c2w.tolist(), "W": W,
              "H": H, "intrinsics": [P[0, 0], P[1, 1], P[0, 2], P[1, 2]], "image_index": i,
              "time": i / (n_frames - 1), "video_id": 0,
              "depth_path": str(scene / "depth" / f"{i:06}.npy"),
              "mask_path": str(scene / "mask" / f"{i:06}.png"),
              "sky_mask_path": str(scene / "sky" / f"{i:06}.png"), "is_val": i in val}
        if i + 1 < n_frames:
            fr["forward_flow_path"] = str(scene / "flow_fwd" / f"{i:06}.npy")
            fr["forward_neighbor_index"] = i + 1
        if i > 0:
            fr["backward_neighbor_index"] = i - 1
        frames.append(fr)
    meta = root / "metadata.json"
    meta.write_text(json.dumps({"origin": [0.0, 0.0, 0.0], "pose_scale_factor": 20.0,
                                "scene_bounds": [[-1.0] * 3, [1.0] * 3], "frames": frames}))
    return str(meta)


@pytest.fixture(scope="module")
def suds(tmp_path_factory):
    return _write_suds_scene(tmp_path_factory.mktemp("suds"))


def test_suds_parser_matches_jax(suds):
    """load_items (the neighbour remap around the val frame) and parse
    (cameras, times, video ids, the scene box, the scale) of both splits."""
    for split in ("train", "val"):
        jitems, jmeta = jsuds.SudsMetadataConfig(metadata_path=suds).load_items(split)
        titems, tmeta = tsuds.SudsMetadataConfig(metadata_path=suds).load_items(split)
        assert jmeta == tmeta and len(jitems) == len(titems)
        for a, b in zip(titems, jitems):
            for k, v in vars(b).items():
                got = getattr(a, k)
                assert (np.array_equal(got, v) if isinstance(v, np.ndarray) else got == v), k
        jo = jsuds.SudsMetadataConfig(metadata_path=suds).parse(split)
        to = tsuds.SudsMetadataConfig(metadata_path=suds).parse(split)
        for k in jo.cameras_np:
            np.testing.assert_array_equal(to.cameras_np[k], jo.cameras_np[k], err_msg=k)
        for k in ("times", "video_ids", "scene_box"):
            np.testing.assert_array_equal(getattr(to, k), getattr(jo, k), err_msg=k)
        assert to.image_filenames == jo.image_filenames
        assert to.mask_filenames == jo.mask_filenames
        assert to.depth_filenames == jo.depth_filenames
        assert to.dataparser_scale == jo.dataparser_scale
        assert len(to.metadata["all_items"]) == 5 and to.metadata["pose_scale_factor"] == 20.0
    train, _ = tsuds.SudsMetadataConfig(metadata_path=suds).load_items("train")
    # frame 1's forward neighbour was the val frame 2: dropped with its flow
    assert train[1].forward_neighbor_index is None and train[1].forward_flow_path is None
    assert train[2].backward_neighbor_index is None and train[2].forward_neighbor_index == 3
    with pytest.raises(ValueError, match="unknown split"):
        tsuds.SudsMetadataConfig(metadata_path=suds).load_items("bogus")


@pytest.mark.parametrize("random_subset,shards", [(True, 1), (False, 1), (True, 2), (False, 2)])
def test_stream_chunks_match_jax_row_for_row(suds, random_subset, shards):
    """Both packages' streams over the same items and seed: every batch
    equal, key for key and row for row, across several chunk swaps, in both
    fill modes and on each of two shards; the flow rows (valid and
    neighbour-less frames), the sky rows, depth, time and video id."""
    items = {p: m.SudsMetadataConfig(metadata_path=suds).load_items("train")[0]
             for p, m in (("j", jsuds), ("t", tsuds))}
    evals = {p: m.SudsMetadataConfig(metadata_path=suds).load_items("val")[0]
             for p, m in (("j", jsuds), ("t", tsuds))}
    seen_flow = seen_sky = False
    for shard in range(shards):
        kw = dict(items_per_chunk=300, train_num_rays_per_batch=64,
                  load_random_subset=random_subset, num_asset_workers=2, seed=5, shard_index=shard, num_shards=shards,
                  with_flow=True, with_sky=True)
        jdm = jstream.ChunkedStreamDataManager(items["j"], evals["j"], jstream.StreamConfig(**kw))
        tdm = tstream.ChunkedStreamDataManager(items["t"], evals["t"], tstream.StreamConfig(**kw))
        try:
            for step in range(12):  # several chunk swaps
                jb, tb = jdm.next_train(step), tdm.next_train(step)
                assert set(tb) == set(jb)
                for k in jb:
                    assert tb[k].dtype == jb[k].dtype, k
                    np.testing.assert_array_equal(tb[k], jb[k], err_msg=f"step {step} {k}")
                seen_flow |= bool(tb["flow_valid"].any())
                seen_sky |= bool(tb["sky"].any())
            assert tdm.num_eval_images() == jdm.num_eval_images() == 1
            for k, v in jdm.eval_image(0).items():
                np.testing.assert_array_equal(tdm.eval_image(0)[k], v, err_msg=k)
            jpos, jcams = jdm.all_indices_eval_cameras(focal_mult=0.5, pos_shift=[1.0, 0.0, 2.0])
            tpos, tout = tdm.all_indices_eval_cameras(focal_mult=0.5, pos_shift=[1.0, 0.0, 2.0])
            assert tpos == jpos
            for k in ("fx", "fy", "c2w"):
                np.testing.assert_array_equal(tout.cameras_np[k], np.asarray(getattr(jcams, k)))
            np.testing.assert_array_equal(tdm.train_outputs.video_ids, np.zeros(4))
        finally:
            jdm.close()
            tdm.close()
    assert seen_flow and seen_sky


def test_stream_eval_cameras_stride_by_rank(suds):
    """The rank-strided eval assignment takes rank and world as arguments
    (the JAX package reads them from jax.process_index)."""
    items, _ = tsuds.SudsMetadataConfig(metadata_path=suds, train_with_val_images=True
                                        ).load_items("train")
    dm = tstream.ChunkedStreamDataManager(items, items, tstream.StreamConfig(items_per_chunk=64))
    try:
        assert dm.all_indices_eval_cameras()[0] == [0, 1, 2, 3, 4]
        assert dm.all_indices_eval_cameras(rank=1, world=2)[0] == [1, 3]
        assert dm.all_indices_eval_cameras(start_frame=1, end_frame=3)[0] == [1, 2]
        assert dm.all_indices_eval_cameras(video_ids={7})[0] == []
    finally:
        dm.close()


def test_flow_and_sky_terms_match_jax_with_gradients():
    """induced_flow and flow_loss (with and without validity), and the sky
    term of nerfacto.loss: values and the gradients with respect to the
    origins, directions, depth and accumulation."""
    rng = np.random.default_rng(0)
    n = 32
    o = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.uniform(0.5, 3.0, (n, 1)).astype(np.float32)
    w2c = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    w2c[:, :, 3] = [0.1, -0.05, -4.0]
    K = np.tile(np.array([[30.0, 28.0, 10.0, 6.0]], np.float32), (n, 1))
    xy = rng.uniform(0, 20, (n, 2)).astype(np.float32)
    gt = rng.normal(size=(n, 2)).astype(np.float32)
    valid = (rng.random((n, 1)) > 0.3).astype(np.float32)
    sky = (rng.random((n, 1)) > 0.5).astype(np.float32)
    acc = rng.uniform(0, 1, (n, 1)).astype(np.float32)
    # the rgb and sky terms only: the proposal terms off
    cfg = tnerf.NerfactoConfig(sky_loss_mult=0.3, interlevel_loss_mult=0.0,
                               distortion_loss_mult=0.0)
    for v in (valid, None):
        def jf(o_, d_, z_, a_):
            pred = jL.induced_flow(o_, d_, z_, xy, w2c, K)
            sky_t = cfg.sky_loss_mult * jnp.sum(sky * a_ ** 2) / jnp.maximum(jnp.sum(sky), 1.0)
            return jL.flow_loss(pred, gt, v) + sky_t, pred

        (jval, jpred), jg = jax.value_and_grad(jf, argnums=(0, 1, 2, 3), has_aux=True)(
            *map(jnp.asarray, (o, d, depth, acc)))
        ts = [torch.tensor(a, requires_grad=True) for a in (o, d, depth, acc)]
        pred = tL.induced_flow(*ts[:3], torch.as_tensor(xy), torch.as_tensor(w2c),
                               torch.as_tensor(K))
        np.testing.assert_allclose(pred.detach().numpy(), np.asarray(jpred), rtol=1e-5, atol=1e-4)
        outputs = {"accumulation": ts[3], "rgb": torch.zeros(n, 3)}
        batch = {"image": torch.zeros(n, 3), "sky": torch.as_tensor(sky)}
        _, m = tnerf.loss(cfg, outputs, batch)
        val = tL.flow_loss(pred, torch.as_tensor(gt), None if v is None else torch.as_tensor(v))
        (val + m["sky_loss"]).backward()
        total = float((val + m["sky_loss"]).detach())
        np.testing.assert_allclose(total, float(jval), rtol=1e-5)
        for t, j in zip(ts, jg):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(j), rtol=1e-4, atol=1e-6)


def test_trainer_steps_over_the_stream_track_jax(suds, tmp_path, monkeypatch):
    """Three steps of both trainers over both streams (the same rows) with
    flow_loss_mult and sky_loss_mult set, the fused path at tiny widths:
    every loss term to 2e-3, the parameters to 2e-3 after three steps."""
    kw = dict(num_images=4, field_type="fourier", fourier_num_levels=2,
              fourier_features_per_level=8, proposal_fourier_features_per_level=4,
              proposal_num_levels=2, hidden_dim=16, hidden_dim_color=16, base_res=4, max_res=32,
              proposal_max_res=(16, 32), num_proposal_samples_per_ray=(16, 8),
              num_nerf_samples_per_ray=8, fourier_basis="tri", stop_grad_sampling=True,
              appearance_embedding_dim=0, flow_loss_mult=1e-3, sky_loss_mult=0.1)
    scfg = dict(items_per_chunk=200, train_num_rays_per_batch=64, load_random_subset=True,
                num_asset_workers=2, seed=7, with_flow=True, with_sky=True)
    jitems, _ = jsuds.SudsMetadataConfig(metadata_path=suds).load_items("train")
    titems, _ = tsuds.SudsMetadataConfig(metadata_path=suds).load_items("train")
    jdm = jstream.ChunkedStreamDataManager(jitems, [], jstream.StreamConfig(**scfg))
    tdm = tstream.ChunkedStreamDataManager(titems, [], tstream.StreamConfig(**scfg))
    opts = {"proposal_networks": dict(lr=1e-2, eps=1e-15), "fields": dict(lr=1e-2, eps=1e-15)}
    monkeypatch.setenv("NKT_FUSED", "1")
    try:
        jt = JTrainer(JTrainerConfig(output_dir=str(tmp_path / "j"), seed=3), jnerf,
                      jnerf.NerfactoConfig(**kw),
                      {k: jopt.OptimizerConfig(**v) for k, v in opts.items()}, jdm,
                      mesh=make_mesh(jax.devices()[:1]))
        tt = Trainer(TrainerConfig(output_dir=str(tmp_path / "t"), seed=3),
                     tnerf.NerfactoConfig(**kw),
                     {k: topt.OptimizerConfig(**v) for k, v in opts.items()}, tdm, device="cpu")
        tree_copy_(tt.params, jax.tree.map(np.array, jt.params))
        for step in range(3):
            jb, tb = jdm.next_train(step), tdm.next_train(step)
            for k in jb:
                np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
            key = jax.random.fold_in(jt._base_key, step)
            jt.params, jt.opt_state, jm = jt._train_step(
                jt.params, jt.opt_state, jt.train_cameras, shard_batch(jt.mesh, jb), key,
                jnp.asarray(step, jnp.float32))
            tm = tt.train_step(tt._to_device(tb), jitters=[
                torch.tensor(np.array(jax.random.uniform(k, (64, 1))))
                for k in jax.random.split(key, 3)])
            assert set(tm) == set(jm) and {"flow_loss", "sky_loss"} <= set(tm)
            for k in tm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=2e-3, atol=1e-7,
                                           err_msg=k)
            assert float(tm["flow_loss"]) > 0 and float(tm["sky_loss"]) > 0
        for t, j in zip(jax.tree.leaves(tt.params), jax.tree.leaves(jt.params)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), atol=2e-3)
    finally:
        jdm.close()
        tdm.close()


def test_scene_writers_flow_matches_jax(tmp_path):
    """render_flow, render_dynamic_flow, the static write_dataset with
    write_flow and write_dynamic_dataset (whose flow comes from each frame's
    one trace) against the JAX package's: arrays equal, PNGs as decoded
    pixels."""
    Image = pytest.importorskip("PIL.Image")
    h, w = 10, 24
    sx, sy = w / 1242.0, h / 375.0
    cam = (tsk.FX * sx, tsk.FY * sy, tsk.CX * sx, tsk.CY * sy)
    poses = tsk.make_poses(3)
    boxes = tsk.make_scene(length=90.0)
    for a, b in zip(tsk.render_flow(poses[0], poses[2], boxes, h, w, *cam),
                    jsk.render_flow(poses[0], poses[2], jsk.make_scene(length=90.0), h, w, *cam)):
        np.testing.assert_array_equal(a, b)
    movers = tsk.make_movers()
    got = tsk.render_dynamic_flow(poses[0], poses[1], boxes, movers, 0, 1, h, w, *cam)
    want = jsk.render_dynamic_flow(poses[0], poses[1], jsk.make_scene(length=90.0),
                                   jsk.make_movers(), 0, 1, h, w, *cam)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for name, kw in (("write_dataset", dict(write_flow=True)), ("write_dynamic_dataset", {})):
        a = getattr(jsk, name)(tmp_path / f"j_{name}", n_frames=3, h=h, w=w, **kw)
        b = getattr(tsk, name)(tmp_path / f"t_{name}", n_frames=3, h=h, w=w, **kw)
        files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
        assert files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
        assert sum(f.parent.name == "flow_fwd" for f in files) == 2
        for f in files:
            if f.suffix == ".npy":
                np.testing.assert_array_equal(np.load(b / f), np.load(a / f), err_msg=str(f))
            elif f.suffix == ".png":
                np.testing.assert_array_equal(decode_png((b / f).read_bytes()),
                                              np.asarray(Image.open(a / f)), err_msg=str(f))
            else:
                assert (b / f).read_text() == (a / f).read_text()
