"""Port vs JAX package, the data path on the CPU: the PNG decoder against PIL,
the scene writer, the pose utilities, the KITTI dataparser and the in-memory
datamanager's batches."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from nerf_kbs_tpu.cameras import poses as jposes
from nerf_kbs_tpu.data import datamanager as jdm
from nerf_kbs_tpu.data import synthetic_kitti as jsk
from nerf_kbs_tpu.data.dataparsers import kitti as jkitti
from nerf_kbs_tpu_torch.cameras import poses as tposes
from nerf_kbs_tpu_torch.data import datamanager as tdm
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.data.dataparsers import kitti as tkitti
from nerf_kbs_tpu_torch.utils import images

H, W, FRAMES = 47, 156, 8


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same 8-frame 47x156 scene written by both packages' writers."""
    root = tmp_path_factory.mktemp("scenes")
    jsk.write_dynamic_dataset(root / "jax", n_frames=FRAMES, h=H, w=W)
    tsk.write_dynamic_dataset(root / "port", n_frames=FRAMES, h=H, w=W)
    return root / "jax", root / "port"


def _pil_png(arr, mode=None, **save):
    buf = io.BytesIO()
    (arr if isinstance(arr, Image.Image) else Image.fromarray(arr, mode)).save(buf, "png", **save)
    return buf.getvalue()


def _row_filters(data: bytes) -> set:
    h = struct.unpack(">I", data[20:24])[0]
    pos, idat = 8, b""
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        if data[pos + 4:pos + 8] == b"IDAT":
            idat += data[pos + 8:pos + 8 + n]
        pos += 12 + n
    raw = zlib.decompress(idat)
    stride = len(raw) // h
    return {raw[r * stride] for r in range(h)}


def _test_image(rng, shape):
    """Smooth ramps (PIL filters them with Sub, Up, Average or Paeth) over
    noise (left unfiltered)."""
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    ramp = (np.add.outer(np.arange(shape[0]) * 3, np.arange(shape[1]) * 2) % 256).astype(np.uint8)
    img[: shape[0] // 2] = ramp[: shape[0] // 2].reshape(
        (shape[0] // 2, shape[1]) + (1,) * (len(shape) - 2))
    return img


@pytest.mark.parametrize("mode,shape", [("RGB", (40, 61, 3)), ("L", (33, 50)),
                                        ("RGBA", (21, 30, 4)), ("LA", (18, 25, 2))])
def test_decode_png_matches_pil(mode, shape):
    rng = np.random.default_rng(0)
    img = _test_image(rng, shape)
    seen = set()
    for optimize in (False, True):
        data = _pil_png(img, mode, optimize=optimize)
        seen |= _row_filters(data)
        got = images.decode_png(data)
        im = Image.open(io.BytesIO(data))
        np.testing.assert_array_equal(got, np.asarray(im))
        for conv in ("RGB", "L"):
            np.testing.assert_array_equal(images.convert(got, conv), np.asarray(im.convert(conv)))
    if mode == "RGB":
        assert seen == {0, 1, 2, 3, 4}, seen  # all five row filters came up


@pytest.mark.parametrize("colors", [2, 4, 16, 200])
def test_decode_palette_png_matches_pil(colors):
    """Palette images at 1, 2, 4 and 8 bits a pixel: the palette's colours,
    and PIL's luma of them for 'L'."""
    rng = np.random.default_rng(colors)
    pal = Image.fromarray(_test_image(rng, (30, 45, 3))).convert(
        "P", palette=Image.ADAPTIVE, colors=colors)
    data = _pil_png(pal)
    got = images.decode_png(data)
    np.testing.assert_array_equal(got, np.asarray(pal.convert("RGB")))
    np.testing.assert_array_equal(images.convert(got, "L"), np.asarray(pal.convert("L")))


def test_l_conversion_and_mask_threshold_match_pil():
    """'L' is PIL's integer luma, so ``mask > 0`` matches the JAX loader's bit
    for bit, dark colours included."""
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 4, (64, 64, 3), dtype=np.uint8)  # many lumas round to 0 or 1
    want = np.asarray(Image.fromarray(rgb).convert("L"))
    np.testing.assert_array_equal(images.convert(rgb, "L"), want)
    assert (want == 0).any() and (want > 0).any()


def test_encoder_round_trips_through_pil():
    rng = np.random.default_rng(2)
    for shape in ((9, 14), (9, 14, 2), (9, 14, 3), (9, 14, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        data = images.encode_png_u8(img)
        assert _row_filters(data) == {1}
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
        np.testing.assert_array_equal(images.decode_png(data), img)


def test_decode_png_refuses_16_bit_and_interlaced():
    """A 16-bit grey PNG is read (as uint16, what PIL gives), a 16-bit
    palette header is refused as invalid; interlaced files and damaged chunks
    raise."""
    d16 = np.arange(20, dtype=np.uint16).reshape(4, 5) * 3000
    sixteen = _pil_png(d16)
    np.testing.assert_array_equal(images.decode_png(sixteen), d16)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(sixteen))).astype(np.uint16),
                                  d16)
    bad = bytearray(images.encode_png_u8(np.zeros((3, 4), np.uint8)))
    bad[24], bad[25] = 16, 3  # bit depth 16, colour type palette
    bad[29:33] = struct.pack(">I", zlib.crc32(bytes(bad[12:29])))
    with pytest.raises(ValueError, match="bit depth 16"):
        images.decode_png(bytes(bad))
    data = bytearray(images.encode_png_u8(np.zeros((3, 4), np.uint8)))
    data[28] = 1  # IHDR's interlace byte, then its CRC anew
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(ValueError, match="interlaced"):
        images.decode_png(bytes(data))
    data[20] ^= 1  # a damaged chunk
    with pytest.raises(ValueError, match="CRC"):
        images.decode_png(bytes(data))


def test_scene_writer_matches_jax(scenes):
    """Same pixels, depth, semantic colours and masks as the JAX writer, the
    same calib, pose and class files, and the same forward-flow files."""
    jdir, tdir = scenes
    for i in range(FRAMES):
        for sub in ("00", "sem", "mask"):
            want = np.asarray(Image.open(jdir / sub / f"{i:06}.png"))
            np.testing.assert_array_equal(images.decode_png((tdir / sub / f"{i:06}.png")
                                                            .read_bytes()), want)
        np.testing.assert_array_equal(np.load(tdir / "depth" / f"{i:06}.npy"),
                                      np.load(jdir / "depth" / f"{i:06}.npy"))
    for name in ("calib.txt", "00.txt", "semantics_list.txt"):
        assert (tdir / name).read_text() == (jdir / name).read_text()
    for i in range(FRAMES - 1):
        np.testing.assert_array_equal(np.load(tdir / "flow_fwd" / f"{i:06}.npy"),
                                      np.load(jdir / "flow_fwd" / f"{i:06}.npy"))
    assert not (tdir / "flow_fwd" / f"{FRAMES - 1:06}.npy").exists()
    mask = images.read_image(tdir / "mask" / "000003.png", "L")
    assert (mask == 0).any() and (mask == 255).any()  # the moving cars are masked


@pytest.mark.parametrize("method", ["pca", "up", "vertical", "none"])
@pytest.mark.parametrize("center", ["poses", "focus", "none"])
def test_pose_utilities_match_jax(method, center):
    poses = jsk.make_poses(12)
    c2w = jposes.to_homogeneous(jposes.opencv_to_world(poses))
    np.testing.assert_allclose(tposes.to_homogeneous(tposes.opencv_to_world(poses)), c2w)
    want = jposes.auto_orient_and_center_poses(c2w, method=method, center_method=center)
    got = tposes.auto_orient_and_center_poses(c2w, method=method, center_method=center)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=1e-12)
    np.testing.assert_allclose(tposes.auto_scale_poses(want[0], 2.0)[0],
                               jposes.auto_scale_poses(want[0], 2.0)[0], atol=1e-12)


@pytest.mark.parametrize("n,frac", [(8, 0.75), (8, 0.9), (115, 0.75), (5, 0.5)])
def test_evenly_spaced_split_matches_jax(n, frac):
    for split in ("train", "val", "test", "eval"):
        np.testing.assert_array_equal(tkitti.evenly_spaced_split(n, frac, split),
                                      jkitti.evenly_spaced_split(n, frac, split))


def _parser_kw(root, **kw):
    return dict(data_dir=str(root), first_frame=0, last_frame=FRAMES, train_split_fraction=0.75,
                image_height=H, image_width=W, **kw)


@pytest.mark.parametrize("extra", [
    {},
    {"semantics": True, "use_depth": True, "mask": True, "depth_unit_scale_factor": 1.0},
    {"orientation_method": "pca", "center_method": "focus", "scale_factor": 0.5},
])
def test_kitti_parser_matches_jax(scenes, extra):
    root = scenes[0]
    kw = {k: v for k, v in extra.items() if k not in ("semantics", "mask")}
    if extra.get("semantics"):
        kw["semantics_dir"] = str(root / "sem")
    if extra.get("mask"):
        kw["mask_dir"] = str(root / "mask")
    for split in ("train", "val"):
        want = jkitti.KittiDataParserConfig(**_parser_kw(root, **kw)).parse(split)
        got = tkitti.KittiDataParserConfig(**_parser_kw(root, **kw)).parse(split)
        assert got.image_filenames == want.image_filenames
        assert got.mask_filenames == want.mask_filenames
        assert got.depth_filenames == want.depth_filenames
        for k, v in want.cameras_np.items():
            np.testing.assert_allclose(got.cameras_np[k], v, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(got.dataparser_transform, want.dataparser_transform, atol=1e-6)
        assert abs(got.dataparser_scale - want.dataparser_scale) <= 1e-6
        assert got.depth_unit_scale_factor == want.depth_unit_scale_factor
        if want.semantics is None:
            assert got.semantics is None
        else:
            assert got.semantics.classes == want.semantics.classes
            assert got.semantics.filenames == want.semantics.filenames
            np.testing.assert_allclose(got.semantics.colors, want.semantics.colors, atol=1e-6)


def test_kitti_parser_window_errors(scenes):
    for first, last, msg in ((3, 3, "empty frame window"), (0, FRAMES + 1, "exceeds pose count")):
        with pytest.raises(ValueError, match=msg):
            tkitti.KittiDataParserConfig(**{**_parser_kw(scenes[0]), "first_frame": first,
                                            "last_frame": last}).parse()


@pytest.mark.parametrize("supervised", [False, True])
def test_datamanager_batches_match_jax(scenes, monkeypatch, supervised):
    """next_train(step) against the JAX datamanager, both on their native
    draws, and the eval images and eval batches; masks ride along
    as weights."""
    root = scenes[1]  # the port's files: the JAX loader reads them with PIL
    kw = dict(use_depth=True, depth_unit_scale_factor=1.0, semantics_dir=str(root / "sem"),
              mask_dir=str(root / "mask")) if supervised else {}
    dm_kw = dict(train_num_rays_per_batch=256, eval_num_rays_per_batch=64, seed=3, num_workers=2)
    jcfg = jkitti.KittiDataParserConfig(**_parser_kw(root, **kw))
    tcfg = tkitti.KittiDataParserConfig(**_parser_kw(root, **kw))
    jm = jdm.InMemoryDataManager(jcfg.parse("train"), jcfg.parse("val"),
                                 jdm.DataManagerConfig(**dm_kw))
    tm = tdm.InMemoryDataManager(tcfg.parse("train"), tcfg.parse("val"),
                                 tdm.DataManagerConfig(**dm_kw))
    for step in (0, 1, 7):
        want, got = jm.next_train(step), tm.next_train(step)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if supervised:
        assert set(got) == {"ray_indices", "image", "depth_image", "mask", "semantics_label"}
        assert 0 < got["mask"].mean() < 1  # moving pixels are drawn, with weight 0
    assert tm.num_eval_images() == jm.num_eval_images() == 2
    for i in range(2):
        want, got = jm.eval_image(i), tm.eval_image(i)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for k, v in jm.next_eval_batch(5).items():
        np.testing.assert_array_equal(tm.next_eval_batch(5)[k], v, err_msg=k)


def test_datamanager_refuses_png_depth_and_empty_split(scenes, tmp_path):
    """16-bit PNG depth is read now (as the JAX loader reads it with
    OpenCV); depth in another format, and an empty split, raise by name."""
    root = scenes[1]
    out = tkitti.KittiDataParserConfig(**_parser_kw(root, use_depth=True)).parse("train")
    cm = (np.load(root / "depth" / "000000.npy") * 100).clip(0, 65535).astype(np.uint16)
    (tmp_path / "000000.png").write_bytes(images.encode_png_u16(cm))
    out.depth_filenames = [str(tmp_path / "000000.png")] * len(out.image_filenames)
    out.depth_unit_scale_factor = 0.01
    got = tdm.InMemoryDataManager(out, out).train_assets["depths"]
    want = jdm._load_depth(str(tmp_path / "000000.png"), 0.01 * out.dataparser_scale)
    np.testing.assert_array_equal(got[0], want)
    out.depth_filenames = [str(tmp_path / "000000.exr")] * len(out.image_filenames)
    with pytest.raises(ValueError, match=r"\.npy and \.png"):
        tdm.InMemoryDataManager(out, out)
    empty = tkitti.KittiDataParserConfig(**{**_parser_kw(root), "train_split_fraction": 1.0})
    with pytest.raises(ValueError, match="empty split"):
        tdm.InMemoryDataManager(empty.parse("train"), empty.parse("val"))
