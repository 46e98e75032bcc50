"""Port vs JAX package, the preprocessing tools' files on the CPU: COLMAP text
and binary models with points3D and ``colmap_to_json``; ``metadata.json``
from ``build_kitti_metadata`` key for key (depth at a working resolution
resized with OpenCV's nearest rule); ``create_transform`` in the variant
mode and with its copy and LANCZOS downscales; ``extract_flows``' files;
the inpainting driver's frames, masks, completed frames and JPEGs; and the
``cli`` tools. PIL and OpenCV serve the JAX side only.

The networks get the same seeded flax variables on both sides (the JAX
package's init replaced, the port's through ``convert``); RAFT's convex
upsampling on the JAX side takes the published layout, as in
``tests/test_torch_process_data.py``."""

import json
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.process_data import colmap_io as JC
from nerf_kbs_tpu.process_data import create_transform as JCT
from nerf_kbs_tpu.process_data import metadata as JM
from nerf_kbs_tpu_torch.process_data import colmap_io as C
from nerf_kbs_tpu_torch.process_data import create_transform as CT
from nerf_kbs_tpu_torch.process_data import metadata as M
from nerf_kbs_tpu_torch.utils.images import decode_png
from nerf_kbs_tpu_torch.utils.jpeg import decode_jpeg
from tests.test_metadata import write_binary_model, write_text_model
from tests.test_torch_preprocess_networks import seeded_flax
from tests.test_torch_process_data import _published_convex_upsample


def assert_same_json(a, b, path="$"):
    """Equal structure and keys; numbers to 1e-9 (both sides are NumPy)."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same_json(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_json(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert a == pytest.approx(b, rel=1e-9, abs=1e-9), path
    else:
        assert a == b, path


def write_points3d(d, pts):
    """points3D.txt and points3D.bin of the same points: (id, x, y, z, error,
    image ids)."""
    lines = [f"{pid} {x} {y} {z} 255 0 0 {err} " + " ".join(f"{i} 0" for i in ids)
             for pid, x, y, z, err, ids in pts]
    (d / "points3D.txt").write_text("\n".join(lines) + "\n")
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for pid, x, y, z, err, ids in pts:
            f.write(struct.pack("<Qddd", pid, x, y, z) + struct.pack("<BBB", 255, 0, 0))
            f.write(struct.pack("<dQ", err, len(ids)))
            f.write(b"".join(struct.pack("<ii", i, 0) for i in ids))


def test_colmap_text_and_binary_models_match_jax(tmp_path):
    write_text_model(tmp_path / "text", n=6)
    write_binary_model(tmp_path / "bin", n=3)
    for sub in ("text", "bin"):
        cams, imgs = C.read_model(str(tmp_path / sub))
        jcams, jimgs = JC.read_model(str(tmp_path / sub))
        assert sorted(cams) == sorted(jcams) and sorted(imgs) == sorted(jimgs)
        for k in cams:
            a, b = cams[k], jcams[k]
            assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
            np.testing.assert_array_equal(a.params, b.params)
        for k in imgs:
            a, b = imgs[k], jimgs[k]
            assert (a.name, a.camera_id) == (b.name, b.camera_id)
            np.testing.assert_array_equal(a.qvec, b.qvec)
            np.testing.assert_array_equal(C.colmap_pose_to_c2w(a), JC.colmap_pose_to_c2w(b))
    pts = [(1, 0.0, 0.1, 2.0, 0.5, [1, 2]), (7, -0.3, 0.2, 4.0, 1.5, [3]), (9, 1, 2, 3, 0.1, [])]
    write_points3d(tmp_path / "text", pts)
    for name in ("points3D.txt", "points3D.bin"):
        reader = C.read_points3d_text if name.endswith("txt") else C.read_points3d_binary
        jreader = JC.read_points3d_text if name.endswith("txt") else JC.read_points3d_binary
        got, want = reader(str(tmp_path / "text" / name)), jreader(str(tmp_path / "text" / name))
        assert sorted(got) == sorted(want) == [1, 7, 9]
        for k in got:
            np.testing.assert_array_equal(got[k].xyz, want[k].xyz)
            np.testing.assert_array_equal(got[k].image_ids, want[k].image_ids)
            assert got[k].error == want[k].error


def test_colmap_to_json_matches_jax(tmp_path):
    write_text_model(tmp_path / "sparse", n=6)
    kw = dict(masks_rel_dir="masks", depths_rel_dir="depth")
    assert C.colmap_to_json(str(tmp_path / "sparse"), str(tmp_path / "t"), **kw) == 6
    JC.colmap_to_json(str(tmp_path / "sparse"), str(tmp_path / "j"), **kw)
    assert_same_json(json.loads((tmp_path / "t" / "transforms.json").read_text()),
                     json.loads((tmp_path / "j" / "transforms.json").read_text()))


@pytest.mark.parametrize("test_every,train_every", [(4, None), (None, 3)])
def test_build_kitti_metadata_matches_jax(tmp_path, test_every, train_every):
    """8 frames over a PINHOLE 32 x 24 camera; depth .npy of half the frames
    at a 16 x 12 working size (resized with OpenCV's nearest rule in JAX,
    ``resize_nearest_cv`` in the port); metadata.json key for key, and the
    returned items."""
    pytest.importorskip("cv2")
    sparse = tmp_path / "colmap" / "0"
    write_text_model(sparse, n=8)
    rng = np.random.default_rng(0)
    depth_dir = tmp_path / "motion" / "0003" / "depth_npy"
    depth_dir.mkdir(parents=True)
    for i in range(1, 9, 2):
        np.save(depth_dir / f"frame_{i:04}.npy", rng.uniform(0.5, 3.0, (12, 16)).astype(np.float32))

    def cfg(cls, out):
        return cls(colmap_sparse_dir=str(sparse), image_dir=str(tmp_path / "fill_img"),
                   motion_dir=str(tmp_path / "motion"), sequence="0003",
                   output_path=str(tmp_path / out), test_every=test_every,
                   train_every=train_every)

    items = M.build_kitti_metadata(cfg(M.KittiMetadataConfig, "t.json"))
    jitems = JM.build_kitti_metadata(cfg(JM.KittiMetadataConfig, "j.json"))
    assert_same_json(json.loads((tmp_path / "t.json").read_text()),
                     json.loads((tmp_path / "j.json").read_text()))
    assert len(items) == len(jitems) == 8
    for a, b in zip(items, jitems):
        np.testing.assert_array_equal(a.c2w, b.c2w)
        assert (a.is_val, a.forward_neighbor_index, a.backward_neighbor_index, a.time) == \
            (b.is_val, b.forward_neighbor_index, b.backward_neighbor_index, b.time)


def test_val_frames_neighbours_and_frame_window_match_jax():
    for n, te, tr in ((20, 5, None), (20, None, 4), (9, None, 1), (7, 3, None)):
        val = M.get_val_frames(n, te, tr)
        assert val == JM.get_val_frames(n, te, tr)
        for i in range(1, n - 1):
            for direction in (-1, 1):
                for inter in (True, False):
                    assert M.get_neighbor(i, val, direction, inter) == \
                        JM.get_neighbor(i, val, direction, inter)
    names = [f"{i:03}.png" for i in (5, 1, 3, 0, 2, 4)]
    assert CT.split_frame_window(names, 1, 4) == JCT.split_frame_window(names, 1, 4)


@pytest.fixture(scope="module")
def images_dir(tmp_path_factory):
    """4 PNG frames of 45 x 67 with a COLMAP model (and points3D) of them."""
    Image = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("images")
    src = root / "src"
    src.mkdir()
    rng = np.random.default_rng(1)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (45, 67, 3), dtype=np.uint8)).save(
            src / f"im{i}.png")
    sparse = root / "sparse"
    write_text_model(sparse, n=4)
    write_points3d(sparse, [(1, 0.0, 0.0, 2.0, 0.5, [1, 2, 3]), (2, 0.1, 0.05, 4.0, 0.5, [1, 4]),
                            (3, 0.0, 0.0, -1.0, 0.5, [2]), (4, 0.0, 0.0, 3.0, 99.0, [1])])
    return root


def test_create_transform_variant_mode_matches_jax(tmp_path, images_dir):
    """``use_existing_model`` with the SfM depth export: transforms.json and
    every depth .npy."""
    for mod, out in ((CT, "t"), (JCT, "j")):
        mod.main(mod.ProcessImagesConfig(data=str(images_dir / "src"),
                                         output_dir=str(tmp_path / out),
                                         use_existing_model=str(images_dir / "sparse"),
                                         export_sfm_depth=True))
    assert_same_json(json.loads((tmp_path / "t" / "transforms.json").read_text()),
                     json.loads((tmp_path / "j" / "transforms.json").read_text()))
    depths = sorted(p.name for p in (tmp_path / "j" / "depth").glob("*.npy"))
    assert len(depths) == 4
    assert sorted(p.name for p in (tmp_path / "t" / "depth").glob("*.npy")) == depths
    for name in depths:
        np.testing.assert_array_equal(np.load(tmp_path / "t" / "depth" / name),
                                      np.load(tmp_path / "j" / "depth" / name))


def test_create_transform_copies_and_downscales_as_jax(tmp_path, images_dir):
    """The copy into images/ (bytes) and images_{2,4,8}/ (PIL's LANCZOS, bit
    for bit), then transforms.json from a model already at
    colmap/sparse/0."""
    import shutil

    for mod, out in ((CT, "t"), (JCT, "j")):
        shutil.copytree(images_dir / "sparse", tmp_path / out / "colmap" / "sparse" / "0")
        mod.main(mod.ProcessImagesConfig(data=str(images_dir / "src"),
                                         output_dir=str(tmp_path / out)))
    for sub in ("images", "images_2", "images_4", "images_8"):
        names = sorted(p.name for p in (tmp_path / "j" / sub).iterdir())
        assert names == [f"frame_{i:05d}.png" for i in range(4)], sub
        for n in names:
            a = decode_png((tmp_path / "t" / sub / n).read_bytes())
            b = decode_png((tmp_path / "j" / sub / n).read_bytes())
            np.testing.assert_array_equal(a, b)
    assert decode_png((tmp_path / "t" / "images_8" / "frame_00000.png").read_bytes()).shape == \
        (5, 8, 3)
    assert_same_json(json.loads((tmp_path / "t" / "transforms.json").read_text()),
                     json.loads((tmp_path / "j" / "transforms.json").read_text()))


@pytest.fixture(scope="module")
def frames_dir(tmp_path_factory):
    """5 frames of 50 x 70 (a street-like gradient with a moving block) and
    a mask of each (the block), PNG."""
    Image = pytest.importorskip("PIL.Image")
    root = tmp_path_factory.mktemp("frames")
    (root / "images").mkdir()
    (root / "masks").mkdir()
    yy, xx = np.mgrid[0:50, 0:70]
    base = np.stack([xx * 3, yy * 4, (xx + yy) * 2], -1) % 256
    for i in range(5):
        img = base.copy()
        img[10:25, 5 + 6 * i:20 + 6 * i] = (200, 30, 30)
        Image.fromarray(img.astype(np.uint8)).save(root / "images" / f"{i:04}.png")
        m = np.zeros((50, 70), np.uint8)
        m[10:25, 5 + 6 * i:20 + 6 * i] = 255
        Image.fromarray(m).save(root / "masks" / f"{i:04}.png")
    return root


def test_extract_flows_files_match_jax(tmp_path, frames_dir, monkeypatch):
    """3 frames at 40 x 64, 2 iterations: flow_fwd/, flow_bwd/ (names by the
    pair's first and second frame) and flow_viz/."""
    from nerf_kbs_tpu.process_data import raft_driver as jrd
    from nerf_kbs_tpu.process_data.networks import raft as jraft
    from nerf_kbs_tpu_torch.process_data import convert
    from nerf_kbs_tpu_torch.process_data import raft_driver as rd
    from nerf_kbs_tpu_torch.process_data.networks.raft import RAFT, RaftConfig

    rv = seeded_flax(jraft.RAFT(jraft.RaftConfig(iters=2)).init, 40, 64, seed=4)
    kw = dict(image_dir=str(frames_dir / "images"), iters=2, width=64, height=40)
    monkeypatch.setattr(jraft, "convex_upsample", _published_convex_upsample)
    monkeypatch.setattr(jraft.RAFT, "init", lambda self, key, h, w: rv)
    jrd.extract_flows(jrd.FlowExtractConfig(output_dir=str(tmp_path / "j"), **kw), max_frames=3)
    raft = RAFT(RaftConfig(iters=2))
    raft.load_state_dict(convert.raft_from_jax(rv))
    monkeypatch.setattr(rd, "make_raft", lambda iters, checkpoint, seed: raft)
    res = rd.extract_flows(rd.FlowExtractConfig(output_dir=str(tmp_path / "t"), **kw),
                           max_frames=3, device="cpu")
    assert res["pairs"] == 2
    for sub, names in (("flow_fwd", ["0000", "0001"]), ("flow_bwd", ["0001", "0002"])):
        for n in names:
            a = np.load(tmp_path / "t" / sub / f"{n}.npy")
            b = np.load(tmp_path / "j" / sub / f"{n}.npy")
            assert a.shape == (40, 64, 2) and a.dtype == np.float32
            np.testing.assert_allclose(a, b, atol=1e-5 * np.abs(b).max())
    for n in ("0000", "0001"):
        a = decode_png((tmp_path / "t" / "flow_viz" / f"{n}.png").read_bytes()).astype(int)
        b = decode_png((tmp_path / "j" / "flow_viz" / f"{n}.png").read_bytes()).astype(int)
        assert np.abs(a - b).max() <= 1


@pytest.fixture(scope="module")
def inpaint_runs(tmp_path_factory, frames_dir):
    """The JAX and the port's inpainting drivers at 42 x 54 (not a multiple
    of 4), window 4, stride 2, over the 5 frames, the same seeded generator."""
    from nerf_kbs_tpu.process_data import inpaint as jinp
    from nerf_kbs_tpu.process_data.networks.inpaint_net import InpaintGenerator as JGen
    from nerf_kbs_tpu_torch.process_data import convert
    from nerf_kbs_tpu_torch.process_data import inpaint as inp
    from nerf_kbs_tpu_torch.process_data.networks.inpaint_net import InpaintGenerator

    root = tmp_path_factory.mktemp("inpaint")
    kw = dict(image_dir=str(frames_dir / "images"), mask_dir=str(frames_dir / "masks"),
              width=54, height=42, window=4, neighbor_stride=2)
    jv = seeded_flax(JGen().init, jnp.zeros((1, 4, 44, 56, 3)), jnp.zeros((1, 4, 44, 56)), seed=5)
    jwritten = jinp.run(jinp.InpaintDriverConfig(output_dir=str(root / "j"), **kw), variables=jv)
    gen = InpaintGenerator()
    gen.load_state_dict(convert.inpaint_from_jax(jv))
    cfg = inp.InpaintDriverConfig(output_dir=str(root / "t"), **kw)
    written = inp.run(cfg, generator=gen, device="cpu")
    jcfg = jinp.InpaintDriverConfig(**kw)
    return cfg, jcfg, gen, jv, written, jwritten


def test_inpaint_loader_matches_jax(inpaint_runs):
    """Frames (PIL's BICUBIC) and dilated masks (PIL's NEAREST, then
    OpenCV's cross dilation) bit for bit; a frame without a mask raises."""
    pytest.importorskip("cv2")
    from nerf_kbs_tpu.process_data import inpaint as jinp
    from nerf_kbs_tpu_torch.process_data import inpaint as inp

    cfg, jcfg, *_ = inpaint_runs
    f, m, n = inp.load_frames_and_masks(cfg)
    jf, jm, jn = jinp.load_frames_and_masks(jcfg)
    assert n == jn and f.shape == (5, 42, 54, 3)
    np.testing.assert_array_equal(f, jf)
    np.testing.assert_array_equal(m, jm)


def test_inpaint_video_matches_jax(inpaint_runs):
    """The windows, the edge pad to 44 x 56 and back, the composite and the
    0.5 / 0.5 blend of revisited frames, to 1e-5."""
    from nerf_kbs_tpu.process_data import inpaint as jinp
    from nerf_kbs_tpu.process_data.networks.inpaint_net import InpaintGenerator as JGen
    from nerf_kbs_tpu_torch.process_data import inpaint as inp

    cfg, jcfg, gen, jv, *_ = inpaint_runs
    f, m, _ = inp.load_frames_and_masks(cfg)
    got = inp.inpaint_video(f, m, generator=gen, neighbor_stride=2, window=4, device="cpu")
    want = jinp.inpaint_video(f, m, generator=JGen(), variables=jv, neighbor_stride=2, window=4)
    assert got.shape == (5, 42, 54, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_array_equal(got[m == 0], f[m == 0])


def test_inpaint_run_writes_the_jpegs_jax_writes(inpaint_runs):
    """fill_img/rgb_%05d.jpg at quality 95. The two packages' encoders round
    differently (PIL's libjpeg against the port's NumPy encoder), so the
    files are held by what they decode to: each port file is the port's
    encoding of its completed frame, and it is as close to that frame as
    JAX's file is to JAX's (mean absolute error within 5% of it)."""
    from nerf_kbs_tpu_torch.process_data import inpaint as inp
    from nerf_kbs_tpu_torch.utils.jpeg import encode_jpeg

    cfg, _, gen, _, written, jwritten = inpaint_runs
    assert [p.rsplit("/", 1)[1] for p in written] == [f"rgb_{i:05d}.jpg" for i in range(5)]
    assert [p.rsplit("/", 1)[1] for p in jwritten] == [p.rsplit("/", 1)[1] for p in written]
    f, m, _ = inp.load_frames_and_masks(cfg)
    frames = (inp.inpaint_video(f, m, generator=gen, neighbor_stride=2, window=4, device="cpu")
              * 255).astype(np.uint8)
    for i, (a, b) in enumerate(zip(written, jwritten)):
        data = open(a, "rb").read()
        assert data == encode_jpeg(frames[i], quality=95)
        err = np.abs(decode_jpeg(data).astype(int) - frames[i]).mean()
        jerr = np.abs(decode_jpeg(open(b, "rb").read()).astype(int) - frames[i]).mean()
        assert err <= 1.05 * jerr, (i, err, jerr)


def test_window_plan_visits_every_frame_as_jax():
    """The JAX driver's windows: each clip of its real frames, then their
    mirror up to the window (at most doubling a short clip)."""
    from nerf_kbs_tpu_torch.process_data.inpaint import window_plan

    for t, stride, window in ((8, 4, 10), (5, 2, 4), (13, 20, 5), (1, 4, 10), (12, 3, 3)):
        plan = window_plan(t, stride, window)
        for ids in plan:
            real = list(dict.fromkeys(ids))
            assert real == list(range(real[0], real[0] + len(real)))
            assert ids == (real + real[::-1])[:min(window, 2 * len(real))]
        assert set().union(*map(set, plan)) == set(range(t))
    assert window_plan(8, 4, 10) == [list(range(8)) + [7, 6]] * 3


def test_cli_tools_run_and_match_the_functions(tmp_path, images_dir, frames_dir, capsys):
    """Each of the five tools through ``cli.main(..., device="cpu")``: images
    (variant mode) and metadata equal the functions' files; motion-mask,
    flows and inpaint write their outputs; flags are typed by annotation
    (an ``Optional[int]`` too); an unknown flag or tool exits."""
    from nerf_kbs_tpu_torch.process_data import cli

    cli.main(["images", "--data", str(images_dir / "src"), "--output-dir", str(tmp_path / "img"),
              "--use-existing-model", str(images_dir / "sparse")], device="cpu")
    JCT.main(JCT.ProcessImagesConfig(data=str(images_dir / "src"), output_dir=str(tmp_path / "j"),
                                     use_existing_model=str(images_dir / "sparse")))
    assert_same_json(json.loads((tmp_path / "img" / "transforms.json").read_text()),
                     json.loads((tmp_path / "j" / "transforms.json").read_text()))
    cli.main(["metadata", "--colmap-sparse-dir", str(images_dir / "sparse"), "--output-path",
              str(tmp_path / "meta.json"), "--test-every", "none", "--train-every", "2"])
    meta = json.loads((tmp_path / "meta.json").read_text())
    assert [fr["is_val"] for fr in meta["frames"]] == [False, True, False, True]
    frames = str(frames_dir / "images")
    cli.main(["motion-mask", "--image-path", frames, "--output-path", str(tmp_path / "mm"),
              "--camera", "custom", "--fx", "60", "--fy", "60", "--cx", "35", "--cy", "25",
              "--width", "70", "--height", "50", "--raft-iters", "1"], device="cpu")
    assert len(list((tmp_path / "mm" / "combined_mask").glob("*.png"))) == 4
    assert np.load(tmp_path / "mm" / "poses.npy").shape == (4, 4, 4)
    cli.main(["flows", "--image-dir", frames, "--output-dir", str(tmp_path / "fl"), "--iters",
              "1", "--width", "64", "--height", "40", "--both-directions", "false"], device="cpu")
    assert len(list((tmp_path / "fl" / "flow_fwd").glob("*.npy"))) == 4
    assert not list((tmp_path / "fl" / "flow_bwd").glob("*.npy"))
    cli.main(["inpaint", "--image-dir", frames, "--mask-dir", str(frames_dir / "masks"),
              "--output-dir", str(tmp_path / "fill"), "--width", "36", "--height", "28",
              "--window", "3"], device="cpu")
    assert len(list((tmp_path / "fill").glob("rgb_*.jpg"))) == 5
    out = capsys.readouterr().out
    assert "wrote metadata for 4 frames" in out and "wrote 5 frames" in out
    with pytest.raises(SystemExit):
        cli.main(["inpaint", "--checkpoint", "x.npz"])
    with pytest.raises(SystemExit):
        cli.main(["colmap"])
