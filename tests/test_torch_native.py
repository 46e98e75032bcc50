"""Port vs JAX package, the host sampler (``nerf_kbs_tpu_torch.native``):
``sample_ray_batch`` with and without depths bit for bit against
``nerf_kbs_tpu.native.lib`` at 1 and 4 OpenMP threads (one subprocess per
count: the runtime reads the count when it starts), at one thread also at
the reference runs' shape, the datamanager's default batches against
JAX's, and a failed build. About 14 s."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from nerf_kbs_tpu.data import datamanager as jdm
from nerf_kbs_tpu.data.dataparsers import kitti as jkitti
from nerf_kbs_tpu.native import lib as jnative
from nerf_kbs_tpu_torch.data import datamanager as tdm
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.data.dataparsers import kitti as tkitti
from nerf_kbs_tpu_torch.native import build as tbuild
from nerf_kbs_tpu_torch.native import lib as tnative

ROOT = Path(__file__).resolve().parents[1]

# Both libraries in one process share one OpenMP runtime, so one thread
# count. The worker writes both packages' draws of every case.
_WORKER = r"""
import sys
import numpy as np
from nerf_kbs_tpu.native import lib as jn
from nerf_kbs_tpu_torch.native import lib as tn

rng = np.random.default_rng(0)
imgs = rng.integers(0, 256, (3, 17, 23, 3), dtype=np.uint8)
depths = rng.uniform(1, 5, (3, 17, 23))  # float64: both coerce to float32
out = {}
for name, lib in (("jax", jn), ("port", tn)):
    assert lib.available()
    for case, kw in (("plain", {}), ("depth", {"depths": depths})):
        for seed in (7, 2**63 + 5):
            got = lib.sample_ray_batch(imgs, 1000, seed, **kw)
            if case == "plain":  # the JAX sampler writes zero depths without depths
                got.pop("depth_image", None)
            for k, v in got.items():
                out[f"{name}/{case}/{seed}/{k}"] = v
np.savez(sys.argv[1], imgs=imgs, depths=depths, **out)
"""


@pytest.fixture(scope="module")
def draws(tmp_path_factory):
    """{threads: the worker's arrays} at OMP_NUM_THREADS 1 and 4."""
    tmp = tmp_path_factory.mktemp("native")
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    procs = {}
    for threads in (1, 4):
        env = dict(os.environ, OMP_NUM_THREADS=str(threads), PYTHONPATH=str(ROOT))
        procs[threads] = subprocess.Popen(
            [sys.executable, str(worker), str(tmp / f"t{threads}.npz")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = {}
    for threads, p in procs.items():
        log, _ = p.communicate(timeout=300)
        assert p.returncode == 0, log.decode(errors="replace")[-4000:]
        with np.load(tmp / f"t{threads}.npz") as z:
            out[threads] = dict(z)
    return out


@pytest.mark.parametrize("threads", [1, 4])
def test_native_matches_jax_bit_for_bit(draws, threads):
    d = draws[threads]
    keys = [k[len("jax/"):] for k in d if k.startswith("jax/")]
    assert len(keys) == 2 * 2 * 2 + 2  # ids and rgb of both cases and seeds, depths
    for k in keys:
        want, got = d[f"jax/{k}"], d[f"port/{k}"]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert {k.split("/")[-1] for k in d if k.startswith("port/plain/")} == {"ray_indices",
                                                                           "image"}


@pytest.mark.parametrize("threads", [1, 4])
def test_native_gathers_the_drawn_pixels(draws, threads):
    """Every draw lies in the stack, and its rgb and depth are the drawn
    pixel's (rgb times the f32 reciprocal of 255, as the library scales)."""
    d = draws[threads]
    imgs, depths = d["imgs"], d["depths"].astype(np.float32)
    ids = d["port/depth/7/ray_indices"]
    assert ids.shape == (1000, 3) and ids.dtype == np.int32
    cam, row, col = ids.T.astype(np.int64)
    assert cam.min() >= 0 and row.min() >= 0 and col.min() >= 0
    assert cam.max() < 3 and row.max() < 17 and col.max() < 23
    inv255 = np.float32(1.0) / np.float32(255.0)
    np.testing.assert_array_equal(d["port/depth/7/image"],
                                  imgs[cam, row, col].astype(np.float32) * inv255)
    np.testing.assert_array_equal(d["port/depth/7/depth_image"][:, 0], depths[cam, row, col])
    # every camera, row and column is reached; the seed changes the draw
    assert len(np.unique(cam)) == 3 and len(np.unique(col)) == 23
    assert not np.array_equal(ids, d[f"port/depth/{2**63 + 5}/ray_indices"])


def test_native_draws_depend_on_the_thread_count(draws):
    """Each OpenMP thread seeds its own stream, so 1 and 4 threads draw
    different batches (by design, in both packages)."""
    one, four = draws[1]["port/plain/7/ray_indices"], draws[4]["port/plain/7/ray_indices"]
    assert not np.array_equal(one, four)
    # the first thread's share starts from the same stream
    np.testing.assert_array_equal(one[:10], four[:10])


_REFERENCE_WORKER = r"""
import numpy as np
from nerf_kbs_tpu.native import lib as jn
from nerf_kbs_tpu_torch.native import lib as tn

# the reference runs' train stack (tools/reference_runs_torch.sh: 36 train
# images of 375 x 1242) and batch, the datamanager's seed 0, steps 1k to 5k
rng = np.random.default_rng(0)
imgs = rng.integers(0, 256, (36, 375, 1242, 3), dtype=np.uint8)
depths = rng.random((36, 375, 1242), dtype=np.float32)
for step in range(1000, 6000, 1000):
    seed = 0 * 1_000_003 + step
    got = tn.sample_ray_batch(imgs, 16384, seed, depths=depths)
    want = jn.sample_ray_batch(imgs, 16384, seed, depths=depths)
    for k in got:
        assert np.array_equal(got[k], want[k].reshape(got[k].shape)), (step, k)
print("identical")
"""


def test_native_draws_the_reference_runs_batches_at_one_thread(tmp_path):
    """At one OpenMP thread (the JAX reference runs' host had one core, and
    tools/reference_runs_torch.sh pins one) both samplers draw the same
    batches at the reference runs' shape, bit for bit."""
    worker = tmp_path / "worker.py"
    worker.write_text(_REFERENCE_WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, str(worker)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "identical", out.stderr[-4000:]


def test_native_coerces_and_checks_inputs():
    """Depths of another dtype or layout are coerced as the JAX package
    coerces them; a non-uint8 stack or depths of another shape raise."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 256, (2, 9, 13, 3), dtype=np.uint8)
    depths = np.asfortranarray(rng.uniform(1, 3, (2, 9, 13)))
    want = jnative.sample_ray_batch(imgs, 300, 5, depths=depths)
    got = tnative.sample_ray_batch(imgs, 300, 5, depths=depths)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with pytest.raises(ValueError, match="uint8"):
        tnative.sample_ray_batch(imgs.astype(np.float32), 4, 1)
    with pytest.raises(ValueError, match="depths"):
        tnative.sample_ray_batch(imgs, 4, 1, depths=depths[:, :5])


def test_datamanager_default_draws_match_jax(tmp_path):
    """Both InMemoryDataManagers on their default (native) draws, with depth,
    masks and semantics: the same batches bit for bit."""
    assert tnative.available() and jnative.available()
    root = tmp_path / "scene"
    tsk.write_dynamic_dataset(root, n_frames=4, h=24, w=40)
    kw = dict(data_dir=str(root), first_frame=0, last_frame=4, train_split_fraction=0.75,
              image_height=24, image_width=40, use_depth=True, depth_unit_scale_factor=1.0,
              semantics_dir=str(root / "sem"), mask_dir=str(root / "mask"))
    dm_kw = dict(train_num_rays_per_batch=512, seed=3, num_workers=2)
    jm = jdm.InMemoryDataManager(jkitti.KittiDataParserConfig(**kw).parse("train"),
                                 jkitti.KittiDataParserConfig(**kw).parse("val"),
                                 jdm.DataManagerConfig(**dm_kw))
    tm = tdm.InMemoryDataManager(tkitti.KittiDataParserConfig(**kw).parse("train"),
                                 tkitti.KittiDataParserConfig(**kw).parse("val"),
                                 tdm.DataManagerConfig(**dm_kw))
    for step in (0, 5):
        want, got = jm.next_train(step), tm.next_train(step)
        assert set(got) == set(want) == {"ray_indices", "image", "depth_image", "mask",
                                         "semantics_label"}
        for k in want:
            assert got[k].dtype == np.asarray(want[k]).dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_failed_build_raises(tmp_path, monkeypatch):
    """No compiler, or a source that does not compile: the build raises with
    the reason, and the sampler stays unloaded."""
    monkeypatch.setattr(tbuild, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(tbuild, "CXX", "no-such-compiler-nkt")
    with pytest.raises(RuntimeError, match="no-such-compiler-nkt not found"):
        tbuild.build()
    monkeypatch.setattr(tbuild, "CXX", "g++")
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tbuild, "SRC", bad)
    with pytest.raises(RuntimeError, match="building the native sampler failed"):
        tbuild.build()
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native sampler failed"):
        tnative.available()
    assert tnative._lib is None
    assert not list((tmp_path / "build").glob("*.so"))
