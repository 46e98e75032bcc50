"""Port vs JAX package, the vKITTI and transforms.json dataparsers and the
vKITTI scene writer, on the CPU: every field of the parsers' outputs on the
trees the JAX package's own parser tests build (cameras, times, file names,
depth and mask paths, the world transform and scale), the split override,
per-frame intrinsics, distortion and the downscale folders; the port's
``write_vkitti_dataset`` against the JAX one (the same tables, the same
depth bit for bit, images within JPEG tolerance); and the datamanager on
that scene (JPEG frames, 16-bit PNG depth) against the JAX one."""

import json
from pathlib import Path

import numpy as np
import pytest

from nerf_kbs_tpu.data import synthetic_kitti as jsk
from nerf_kbs_tpu.data.datamanager import DataManagerConfig as JDMConfig
from nerf_kbs_tpu.data.datamanager import InMemoryDataManager as JDM
from nerf_kbs_tpu.data.dataparsers import transforms_json as jtj
from nerf_kbs_tpu.data.dataparsers import vkitti as jvk
from nerf_kbs_tpu.native import lib as jnative
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.data.datamanager import DataManagerConfig as TDMConfig
from nerf_kbs_tpu_torch.data.datamanager import InMemoryDataManager as TDM
from nerf_kbs_tpu_torch.data.dataparsers import transforms_json as ttj
from nerf_kbs_tpu_torch.data.dataparsers import vkitti as tvk
from nerf_kbs_tpu_torch.utils import images

Image = pytest.importorskip("PIL.Image")


def _write_png(path, arr):
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path)


def _same_outputs(t, j):
    """Every field the port's DataparserOutputs shares with the JAX one:
    camera arrays bit for bit, times, paths, the transform and scale to f64
    rounding."""
    assert set(t.cameras_np) == set(j.cameras_np)
    for k, v in j.cameras_np.items():
        assert t.cameras_np[k].dtype == v.dtype, k
        np.testing.assert_array_equal(t.cameras_np[k], v, err_msg=k)
    assert t.image_filenames == j.image_filenames
    assert t.depth_filenames == j.depth_filenames
    assert t.mask_filenames == j.mask_filenames
    assert t.depth_unit_scale_factor == j.depth_unit_scale_factor
    np.testing.assert_array_equal(t.scene_box, j.scene_box)
    if j.times is None:
        assert t.times is None
    else:
        np.testing.assert_array_equal(t.times, j.times)
    np.testing.assert_allclose(t.dataparser_transform, j.dataparser_transform, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(t.dataparser_scale, j.dataparser_scale, rtol=1e-12)


def make_vkitti_tree(root: Path, n=6, size=(6, 8)):
    """The JAX package's vKITTI parser test tree: 6 frames of a camera
    moving along z, PIL-written .jpg frames."""
    intr, extr = [], []
    for i in range(n):
        intr.append(f"{i} 0 120.0 121.0 6.0 5.0")
        T = np.eye(4)
        T[2, 3] = -i
        extr.append(f"{i} 0 " + " ".join(map(str, T.reshape(-1))))
    (root / "intrinsic.txt").write_text("frame cameraID K\n" + "\n".join(intr))
    (root / "extrinsic.txt").write_text("frame cameraID r\n" + "\n".join(extr))
    rng = np.random.default_rng(3)
    for i in range(n):
        _write_png(root / "frames" / "rgb" / "Camera_0" / f"rgb_{i:05}.jpg",
                   rng.integers(0, 255, (*size, 3), dtype=np.uint8))
    return root


@pytest.mark.parametrize("kw", [
    dict(train_split_fraction=0.75),
    dict(train_split_fraction=0.5, use_depth=True, first_frame=1, last_frame=6),
    dict(train_split_fraction=0.75, auto_scale_poses=False, center_method="none",
         orientation_method="none"),
])
def test_vkitti_parser_matches_jax(tmp_path, kw):
    make_vkitti_tree(tmp_path)
    for split in ("train", "val"):
        t = tvk.VKittiDataParserConfig(data_dir=str(tmp_path), **kw).parse(split)
        j = jvk.VKittiDataParserConfig(data_dir=str(tmp_path), **kw).parse(split)
        _same_outputs(t, j)
        assert t.cameras_np["width"][0] == 8 and t.cameras_np["height"][0] == 6
        assert t.times.min() >= -1.0 and t.times.max() <= 1.0


def test_vkitti_parser_size_fallback_and_errors(tmp_path):
    """Without the first frame on disk both take vKITTI 2's 1242x375; a
    camera with no frames raises."""
    make_vkitti_tree(tmp_path)
    for f in (tmp_path / "frames" / "rgb" / "Camera_0").glob("*.jpg"):
        f.unlink()
    t = tvk.VKittiDataParserConfig(data_dir=str(tmp_path), train_split_fraction=0.75).parse()
    j = jvk.VKittiDataParserConfig(data_dir=str(tmp_path), train_split_fraction=0.75).parse()
    _same_outputs(t, j)
    assert (t.cameras_np["width"][0], t.cameras_np["height"][0]) == (1242, 375)
    with pytest.raises(ValueError, match="no frames for camera 1"):
        tvk.VKittiDataParserConfig(data_dir=str(tmp_path), camera_id=1).parse()


def make_transforms_tree(root: Path, n=8, h=10, w=12, split_override=False, per_frame=False,
                         downscale=None, masks=False):
    """The JAX package's transforms.json parser test tree, with optional
    per-frame intrinsics, a downscale folder set and masks."""
    rng = np.random.default_rng(1)
    frames = []
    for i in range(n):
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        _write_png(root / "images" / f"frame_{i:04}.png", img)
        c2w = np.eye(4)
        c2w[:3, 3] = rng.normal(size=3)
        fr = {"file_path": f"images/frame_{i:04}.png", "transform_matrix": c2w.tolist(),
              "depth_file_path": f"depth/{i:04}.npy"}
        if per_frame:
            fr.update({"fl_x": 40.0 + i, "w": w + 2 * (i % 2), "cx": 5.0 + 0.25 * i})
        if masks:
            fr["mask_path"] = f"masks/{i:04}.png"
            _write_png(root / "masks" / f"{i:04}.png",
                       (rng.random((h, w)) > 0.3).astype(np.uint8) * 255)
        frames.append(fr)
        (root / "depth").mkdir(exist_ok=True)
        np.save(root / "depth" / f"{i:04}.npy", rng.uniform(0, 10, (h, w)).astype(np.float32))
        if downscale:
            d = downscale
            _write_png(root / f"images_{d}" / f"frame_{i:04}.png", img[::d, ::d])
            (root / f"depth_{d}").mkdir(exist_ok=True)
            np.save(root / f"depth_{d}" / f"{i:04}.npy", np.zeros((h // d, w // d), np.float32))
            if masks:
                _write_png(root / f"masks_{d}" / f"{i:04}.png",
                           np.zeros((h // d, w // d), np.uint8))
    meta = {"fl_x": 50.0, "fl_y": 52.0, "cx": w / 2, "cy": h / 2, "w": w, "h": h,
            "k1": 0.01, "k2": 0.0, "k3": 0.0, "k4": 0.0, "p1": 0.0, "p2": 0.0,
            "applied_scale": 0.5, "frames": frames}
    if split_override:
        meta["train_filenames"] = [f["file_path"] for f in frames[:5]]
        meta["val_filenames"] = [f["file_path"] for f in frames[5:]]
    (root / "transforms.json").write_text(json.dumps(meta))
    return root


@pytest.mark.parametrize("tree,kw", [
    (dict(), dict(train_split_fraction=0.75)),
    (dict(split_override=True), dict()),
    (dict(per_frame=True, masks=True), dict(train_split_fraction=0.75, scale_factor=2.0)),
    (dict(downscale=2, masks=True), dict(downscale_factor=2, train_split_fraction=0.75)),
    (dict(h=40, w=50, downscale=2), dict(max_dim=30, train_split_fraction=0.75)),  # auto: 2
    # no images_2 folder: full resolution
    (dict(h=40, w=50), dict(max_dim=30, train_split_fraction=0.75)),
])
def test_transforms_json_parser_matches_jax(tmp_path, tree, kw):
    make_transforms_tree(tmp_path, **tree)
    for split in ("train", "val"):
        t = ttj.TransformsJsonConfig(data=str(tmp_path), **kw).parse(split)
        j = jtj.TransformsJsonConfig(data=str(tmp_path), **kw).parse(split)
        _same_outputs(t, j)
        assert "distortion" in t.cameras_np
    if tree.get("downscale"):
        assert "images_2" in t.image_filenames[0] and "depth_2" in t.depth_filenames[0]


def test_transforms_json_errors_match_jax(tmp_path):
    """Depth on some frames of a split only, and a missing downscaled mask
    folder, raise in both."""
    make_transforms_tree(tmp_path, downscale=2)
    meta = json.loads((tmp_path / "transforms.json").read_text())
    meta["frames"][4]["mask_path"] = "masks/0004.png"  # a train frame
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    for cfg in (ttj.TransformsJsonConfig, jtj.TransformsJsonConfig):
        with pytest.raises(ValueError, match="every frame or none"):
            cfg(data=str(tmp_path), train_split_fraction=0.75).parse("train")
    for fr in meta["frames"]:
        fr["mask_path"] = "masks/x.png"
    (tmp_path / "transforms.json").write_text(json.dumps(meta))
    for cfg in (ttj.TransformsJsonConfig, jtj.TransformsJsonConfig):
        with pytest.raises(ValueError, match="downscale 2 active"):
            cfg(data=str(tmp_path), downscale_factor=2).parse("train")


@pytest.fixture(scope="module")
def vkitti_scenes(tmp_path_factory):
    root = tmp_path_factory.mktemp("vk")
    return (tsk.write_vkitti_dataset(root / "port", n_frames=4, h=47, w=156),
            jsk.write_vkitti_dataset(root / "jax", n_frames=4, h=47, w=156))


def test_write_vkitti_dataset_matches_jax(vkitti_scenes):
    """The same intrinsic and extrinsic tables (text equal), the same depth
    (the 16-bit PNGs decode to equal arrays, in the port and in PIL), and
    frames within JPEG tolerance of each other (both quality 97 at 4:2:0:
    max abs difference <= 12, mean <= 1.0 of 255)."""
    port, jax_ = vkitti_scenes
    for name in ("intrinsic.txt", "extrinsic.txt"):
        assert (port / name).read_text() == (jax_ / name).read_text()
    for i in range(4):
        dp = port / "frames" / "depth" / "Camera_0" / f"depth_{i:05d}.png"
        dj = jax_ / "frames" / "depth" / "Camera_0" / f"depth_{i:05d}.png"
        want = np.asarray(Image.open(dj)).astype(np.uint16)
        np.testing.assert_array_equal(images.decode_png(dp.read_bytes()), want)
        np.testing.assert_array_equal(np.asarray(Image.open(dp)).astype(np.uint16), want)
        rp = np.asarray(Image.open(port / "frames" / "rgb" / "Camera_0" / f"rgb_{i:05d}.jpg"))
        rj = np.asarray(Image.open(jax_ / "frames" / "rgb" / "Camera_0" / f"rgb_{i:05d}.jpg"))
        err = np.abs(rp.astype(int) - rj)
        assert err.max() <= 12 and err.mean() <= 1.0, (err.max(), err.mean())


def test_vkitti_datamanager_matches_jax(vkitti_scenes, monkeypatch):
    """Both datamanagers on the JAX-written scene (PIL's JPEGs, 16-bit PNG
    depth in centimetres): every train batch and eval image bit for bit."""
    monkeypatch.setattr(jnative, "_lib", False)
    scene = vkitti_scenes[1]
    kw = dict(data_dir=str(scene), train_split_fraction=0.75, use_depth=True)
    tm = TDM(tvk.VKittiDataParserConfig(**kw).parse("train"),
             tvk.VKittiDataParserConfig(**kw).parse("val"),
             TDMConfig(train_num_rays_per_batch=128, num_workers=2))
    jm = JDM(jvk.VKittiDataParserConfig(**kw).parse("train"),
             jvk.VKittiDataParserConfig(**kw).parse("val"),
             JDMConfig(train_num_rays_per_batch=128, num_workers=2))
    for step in (0, 7):
        jb, tb = jm.next_train(step), tm.next_train(step)
        assert set(tb) == set(jb) == {"ray_indices", "image", "depth_image"}
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
    want, got = jm.eval_image(0), tm.eval_image(0)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert float(got["depth_image"].max()) > 1.0  # centimetres times 1e-2 times the scale
