"""Port vs JAX package, the method registry and the CLI on the CPU: the specs
and their override paths, trainers built from scenes on disk in the KITTI,
Virtual KITTI 2 and transforms.json layouts (three steps of each package's
trainer on the same batches and jitter), and the run modes of
``nerf_kbs_tpu_torch.engine.cli.main``. JAX runs its fused Pallas path in
interpret mode (NKT_FUSED=1)."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_kbs_tpu.methods  # noqa: F401  (registers the JAX methods)
from nerf_kbs_tpu.data import synthetic_kitti as jsk
from nerf_kbs_tpu.engine import cli as jcli
from nerf_kbs_tpu.engine import trainer as jtrainer_mod
from nerf_kbs_tpu.native import lib as jnative
from nerf_kbs_tpu.parallel.mesh import make_mesh, shard_batch
from nerf_kbs_tpu_torch import methods as tmethods
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.engine.optimizers import tree_copy_
from nerf_kbs_tpu_torch.models import nerfacto as tnerf

REPO = Path(__file__).resolve().parents[1]
H, W = 47, 156
# nerfacto-tpu's model fields, for semantic-nerfw on the fused Fourier path
FOURIER = ["--model.field_type", "fourier", "--model.hidden_dim", "128", "--model.num_layers", "3",
           "--model.base_res", "4", "--model.max_res", "256", "--model.fourier_basis", "tri",
           "--model.num_proposal_samples_per_ray", "96,32", "--model.stop_grad_sampling", "true",
           "--model.interlevel_ray_fraction", "0.5", "--model.appearance_embedding_dim", "0"]
# tiny hash grids for the CPU: 4 levels from 4 to 32 in 2^10 slots (two dense
# levels, two hashed), proposals 2 levels in 2^8
TINY_HASH = ["--model.num_levels", "4", "--model.log2_hashmap_size", "10", "--model.base_res", "4",
             "--model.max_res", "32", "--model.proposal_num_levels", "2",
             "--model.proposal_log2_hashmap_size", "8"]
# tiny widths for the CPU
TINY = ["--model.hidden_dim", "16", "--model.fourier_num_levels", "2",
        "--model.fourier_features_per_level", "8", "--model.proposal_num_levels", "2",
        "--model.proposal_fourier_features_per_level", "4", "--model.hidden_dim_color", "16",
        "--model.proposal_max_res", "16,32", "--model.num_proposal_samples_per_ray", "16,8",
        "--model.num_nerf_samples_per_ray", "8", "--datamanager.train_num_rays_per_batch", "64",
        "--datamanager.num_workers", "2", "--trainer.eval_num_rays_per_chunk", "4096",
        "--trainer.log_every", "1"]


# tiny vanilla-nerf widths for the CPU, on the vKITTI-layout scene (6 train
# frames, 2 eval)
TINY_VANILLA = ["--model.mlp_layer_width", "32", "--model.mlp_num_layers", "4",
                "--model.skip_connections", "2", "--model.num_coarse_samples", "8",
                "--model.num_importance_samples", "8", "--model.temporal_distortion_width", "16",
                "--model.pos_frequencies", "4", "--model.dir_frequencies", "2",
                "--datamanager.train_num_rays_per_batch", "64", "--datamanager.num_workers", "2",
                "--trainer.eval_num_rays_per_chunk", "4096", "--trainer.log_every", "1",
                "--dataparser.train_split_fraction", "0.75"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The dynamic street scene in the KITTI layout, and beside it a
    transforms.json of the same frames (OpenGL camera-to-world, the scene's
    intrinsics, depth .npy)."""
    root = jsk.write_dynamic_dataset(tmp_path_factory.mktemp("cli") / "scene", n_frames=8, h=H,
                                     w=W)
    p2 = [ln for ln in (root / "calib.txt").read_text().splitlines() if ln.startswith("P2:")]
    P = np.array(p2[0].split()[1:], np.float64).reshape(3, 4)
    frames = []
    for i, row in enumerate(np.loadtxt(root / "00.txt").reshape(-1, 3, 4)):
        c2w = np.eye(4)
        c2w[:3] = row
        c2w[:3, 1:3] *= -1.0  # OpenCV camera axes -> OpenGL
        frames.append({"file_path": f"00/{i:06}.png", "transform_matrix": c2w.tolist(),
                       "depth_file_path": f"depth/{i:06}.npy"})
    (root / "transforms.json").write_text(json.dumps(
        {"fl_x": P[0, 0], "fl_y": P[1, 1], "cx": P[0, 2], "cy": P[1, 2], "w": W, "h": H,
         "frames": frames}))
    return root


@pytest.fixture(scope="module")
def vkitti_scene(tmp_path_factory):
    return tsk.write_vkitti_dataset(tmp_path_factory.mktemp("cli") / "vkitti", n_frames=8, h=H,
                                    w=W)


def _window(scene, out):
    return ["--dataparser.data_dir", str(scene), "--dataparser.first_frame", "0",
            "--dataparser.last_frame", "8", "--dataparser.train_split_fraction", "0.75",
            "--dataparser.image_height", str(H), "--dataparser.image_width", str(W),
            "--trainer.output_dir", str(out)]


def _supervision(scene):
    return ["--dataparser.semantics_dir", str(scene / "sem"), "--dataparser.mask_dir",
            str(scene / "mask"), "--dataparser.depth_unit_scale_factor", "1.0"]


def _overrides(argv):
    """--k v pairs as the CLI reads them."""
    return dict(zip([a[2:] for a in argv[::2]], argv[1::2]))


def _leaves(spec, cli):
    return dict(cli._iter_leaf_fields(spec))


def test_registry_matches_jax():
    assert set(tcli.method_registry) == set(jcli.method_registry)


@pytest.mark.parametrize("name", sorted(jcli.method_registry))
def test_method_specs_match_jax(name):
    """Every leaf of the port's spec has the JAX spec's path and value (the
    description aside); the model and dataparser leaves are the same sets."""
    jl = _leaves(jcli.method_registry[name](), jcli)
    tl = _leaves(tcli.method_registry[name](), tcli)
    for path, v in tl.items():
        if path == "description":
            continue
        assert path in jl and jl[path] == v, (path, v, jl.get(path))
    for head in ("model.", "dataparser."):
        assert {p for p in jl if p.startswith(head)} == {p for p in tl if p.startswith(head)}


@pytest.mark.parametrize("method,argv", [
    ("nerfacto-tpu", ["--dataparser.last_frame", "8", "--trainer.max_num_iterations", "30",
                      "--dataparser.train_split_fraction", "0.75", "--hidden_dim", "64",
                      "--fields.lr", "0.002", "--optimizers.fields.max_norm", "2"]),
    ("semantic-nerfw", FOURIER + ["--dataparser.semantics_dir", "s", "--mask_dir", "m",
                                  "--dataparser.depth_unit_scale_factor", "1.0",
                                  "--optimizers.proposal_networks.lr_final", "1e-5"]),
])
def test_apply_overrides_match_jax(method, argv):
    ov = _overrides(argv)
    jl = _leaves(jcli.apply_overrides(jcli.method_registry[method](), ov), jcli)
    tl = _leaves(tcli.apply_overrides(tcli.method_registry[method](), ov), tcli)
    assert all(jl[p] == v for p, v in tl.items() if p != "description")
    assert tl["model.field_type"] == "fourier"
    with pytest.raises(SystemExit, match="unknown or ambiguous"):
        tcli.apply_overrides(tcli.method_registry[method](), {"lr": "1"})


@pytest.mark.parametrize("method,argv,name", [
    ("nerfacto", [], "field_type"),
    ("nerfacto-big", [], "field_type"),
    ("synthetic-nerfacto", [], "field_type"),
    ("semantic-nerfw", [], "field_type"),
    ("vanilla-nerf", [], "vanilla_nerf"),
    ("test-nerfacto", ["--model.field_type", "fourier"], "transforms.json"),
])
def test_unported_methods_raise_by_name(scene, vkitti_scene, tmp_path, method, argv, name):
    """Every method that once raised builds as registered, at tiny widths, and
    takes a finite step on the CPU: the hash-field methods (the cases named
    'field_type'), vanilla-nerf on a vKITTI-layout scene (JPEG frames, the
    temporal distortion reading the frames' times), and test-nerfacto on a
    transforms.json scene (here with the Fourier field, the fused path)."""
    if name == "field_type":
        extra = TINY + TINY_HASH + ["--trainer.output_dir", str(tmp_path)]
        if method != "synthetic-nerfacto":
            extra += _window(scene, tmp_path)
        if method == "semantic-nerfw":
            extra += _supervision(scene)
    elif name == "vanilla_nerf":
        extra = TINY_VANILLA + ["--dataparser.data_dir", str(vkitti_scene),
                                "--trainer.output_dir", str(tmp_path)]
    else:
        extra = argv + TINY + ["--dataparser.data", str(scene), "--dataparser.train_split_fraction",
                               "0.75", "--trainer.output_dir", str(tmp_path)]
    spec = tcli.apply_overrides(tcli.method_registry[method](), _overrides(extra))
    trainer = tcli.build_trainer(spec, device="cpu")
    m = trainer.train_step(trainer._to_device(trainer.dm.next_train(0)))
    assert np.isfinite(float(m["total_loss"]))
    if name == "field_type":
        assert trainer.model_config.field_type == "hash"
        assert trainer.params["fields"]["hash_table"].shape == (2 * 4 * 1024,)
    elif name == "vanilla_nerf":
        assert trainer.model_config.enable_temporal_distortion
        assert trainer.train_cameras.times is not None
        assert float(trainer.params["temporal_distortion"]["w"][-1].detach().abs().max()) > 0
    else:
        assert trainer.model_config.field_type == "fourier"
        assert trainer.dm.train_outputs.image_filenames[0].endswith("00/000000.png")


def _jitters(key, rounds, n_rays):
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


def _steps_track_jax(method, argv, monkeypatch, prepare=None, both=False):
    """Both packages' build_trainer on the same argv (num_images and the
    class count from the data), then three steps from the same parameters on
    the same batches and jitter: losses to rtol 2e-3, parameters to atol 2e-3
    after the three steps. ``prepare`` may change the JAX parameters (a
    NumPy tree) before both start from them. Returns the port's trainer, or
    with ``both`` (JAX's, the port's)."""
    monkeypatch.setattr(jnative, "_lib", False)  # the JAX datamanager's NumPy draws
    monkeypatch.setattr(jtrainer_mod, "make_mesh", lambda *a: make_mesh(jax.devices()[:1]))
    ov = _overrides(argv)
    jt = jcli.build_trainer(jcli.apply_overrides(jcli.method_registry[method](), ov))
    tt = tcli.build_trainer(tcli.apply_overrides(tcli.method_registry[method](), ov), device="cpu")
    assert tt.model_config == type(tt.model_config)(**{
        f.name: getattr(jt.model_config, f.name) for f in dataclasses.fields(tt.model_config)})
    assert tt.model_config.compute_dtype == "float32"
    start = jax.tree.map(np.array, jt.params)
    if prepare is not None:
        prepare(start)
        jt.params = jax.device_put(start, jax.tree.map(lambda a: a.sharding, jt.params))
    tree_copy_(tt.params, start)
    # nerfacto's proposal rounds + 1 draws; vanilla NeRF's coarse and fine draws
    rounds = getattr(jt.model_config, "num_proposal_iterations", 1)
    n_rays = int(ov["datamanager.train_num_rays_per_batch"])
    for step in range(3):
        jb, tb = jt.dm.next_train(step), tt.dm.next_train(step)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        key = jax.random.fold_in(jt._base_key, step)
        jt.params, jt.opt_state, jm = jt._train_step(
            jt.params, jt.opt_state, jt.train_cameras, shard_batch(jt.mesh, jb), key,
            jnp.asarray(step, jnp.float32))
        tm = tt.train_step(tt._to_device(tb), jitters=_jitters(key, rounds, n_rays))
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=2e-3)
    want = params_from_jax(jax.tree.map(np.asarray, jt.params), device="cpu")
    for t, j in zip(jax.tree.leaves(tt.params), jax.tree.leaves(want)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=2e-3)
    jt.step = tt.step
    return (jt, tt) if both else tt


@pytest.mark.parametrize("method", ["nerfacto-tpu", "semantic-nerfw"])
def test_build_trainer_steps_track_jax(scene, tmp_path, monkeypatch, method):
    """The fused Fourier path: nerfacto-tpu, and semantic-nerfw with
    --model.field_type fourier and its supervision."""
    monkeypatch.setenv("NKT_FUSED", "1")
    argv = _window(scene, tmp_path) + TINY
    if method == "semantic-nerfw":
        argv += FOURIER[:2] + FOURIER[10:] + _supervision(scene)
    tt = _steps_track_jax(method, argv, monkeypatch)
    assert tt.model_config.num_images == 6
    if method == "semantic-nerfw":
        assert tt.model_config.num_semantic_classes == 4


@pytest.mark.parametrize("method,extra", [
    ("synthetic-nerfacto", TINY_HASH),
    ("semantic-nerfw", TINY_HASH),
    ("nerfacto-tpu", ["--model.predict_normals", "true"]),
])
def test_build_trainer_non_fused_steps_track_jax(scene, tmp_path, monkeypatch, method, extra):
    """The non-fused path, three steps against JAX: synthetic-nerfacto and
    semantic-nerfw as registered (hash fields; semantic-nerfw with depth,
    semantics and masks), and nerfacto-tpu with predicted normals (the
    Fourier field off the kernels, the normal losses' second-order
    backward)."""
    argv = TINY + extra + ["--trainer.output_dir", str(tmp_path)]
    if method != "synthetic-nerfacto":
        argv += _window(scene, tmp_path)
    if method == "semantic-nerfw":
        argv += _supervision(scene)
    tt = _steps_track_jax(method, argv, monkeypatch)
    cfg = tt.model_config
    assert not tnerf.uses_fused_path(cfg)
    if method == "nerfacto-tpu":
        assert cfg.predict_normals and "pred_normal_mlp" in tt.params["fields"]
    else:
        assert cfg.field_type == "hash" and "hash_table" in tt.params["fields"]


@pytest.mark.parametrize("method", ["vanilla-nerf", "test-nerfacto"])
def test_build_trainer_new_methods_track_jax(scene, vkitti_scene, tmp_path, monkeypatch, method):
    """Three steps against JAX of the last two registry names as registered:
    vanilla-nerf (temporal distortion, aabb collider, RAdam with the clip)
    on a vKITTI-layout scene, whose JPEG frames both datamanagers decode to
    the same batches; and test-nerfacto (hash nerfacto) on a transforms.json
    scene."""
    if method == "vanilla-nerf":
        argv = TINY_VANILLA + ["--dataparser.data_dir", str(vkitti_scene),
                               "--trainer.output_dir", str(tmp_path)]
    else:
        argv = TINY + TINY_HASH + ["--dataparser.data", str(scene),
                                   "--dataparser.train_split_fraction", "0.75",
                                   "--trainer.output_dir", str(tmp_path)]
    tt = _steps_track_jax(method, argv, monkeypatch)
    if method == "vanilla-nerf":
        assert set(tt.params) == {"fields", "temporal_distortion"}
        assert tt.model_config.skip_connections == (2,)
    else:
        assert tt.model_config.num_images == 6 and "hash_table" in tt.params["fields"]


def test_eval_matches_jax_after_three_steps(scene, tmp_path, monkeypatch):
    """Trainer.eval_image and eval_all_images of both packages on the tiny
    semantic-nerfw scene as registered (hash field, depth, semantics,
    masks), after the same three steps from the same parameters, the field's
    table drawn from U(-1, 1) so that the rendered depth varies: every metric
    (psnr, ssim, psnr_right, masked_psnr, semantic_accuracy, depth_mse) to
    1e-4 of its value, the same keys."""

    def spread_table(p):
        p["fields"]["hash_table"] = np.random.default_rng(0).uniform(
            -1, 1, p["fields"]["hash_table"].shape).astype(np.float32)

    argv = (TINY + TINY_HASH + ["--trainer.output_dir", str(tmp_path)]
            + _window(scene, tmp_path) + _supervision(scene))
    jt, tt = _steps_track_jax("semantic-nerfw", argv, monkeypatch, spread_table, both=True)
    depth = tt._renderer().render_camera(0)["depth"]
    assert depth.std() > 0.05 * depth.mean()  # the alignment is well posed
    for got, want in [(tt.eval_image(i, write_images=False), jt.eval_image(i, write_images=False))
                      for i in range(2)] + [(tt.eval_all_images(), jt.eval_all_images())]:
        assert set(got) == set(want)
        assert {"psnr", "ssim", "psnr_right", "masked_psnr", "semantic_accuracy",
                "depth_mse"} <= set(got)
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=k)


def test_eval_depth_mse_of_a_constant_depth_is_unaligned(scene, tmp_path):
    """The singular case: at initialisation the tiny Fourier semantic-nerfw
    renders one constant median depth (every ray's last midpoint), so the
    alignment's system has det = 0 exactly in f64, and the port returns
    scale = shift = 0: depth_mse is the masked mean of the squared target.
    The JAX package's answer here is not pinned: in f32 its det is rounding
    noise whose sign depends on XLA's summation order, and where the noise
    comes out above its threshold it aligns with a scale of ~1."""
    from nerf_kbs_tpu_torch.ops.losses import normalized_depth_scale_and_shift

    argv = _window(scene, tmp_path) + TINY + FOURIER[:2] + FOURIER[10:] + _supervision(scene)
    tt = tcli.build_trainer(tcli.apply_overrides(tcli.method_registry["semantic-nerfw"](),
                                                 _overrides(argv)), device="cpu")
    out = tt._renderer().render_camera(0)
    pred = out["depth"].reshape(-1)
    assert np.ptp(pred) == 0.0
    gt = tt.dm.eval_image(0)
    target = (np.asarray(gt["depth_image"], np.float32).reshape(-1)
              * out["directions_norm"].reshape(-1))
    m = (target > 0).astype(np.float64)
    p64 = pred.astype(np.float64)
    assert (m * p64 * p64).sum() * m.sum() - (m * p64).sum() ** 2 == 0.0  # det in f64
    scale, shift = normalized_depth_scale_and_shift(
        *(torch.as_tensor(a[None], dtype=torch.float32) for a in (pred, target, m)))
    assert float(scale) == 0.0 and float(shift) == 0.0
    want = float((m * target.astype(np.float64) ** 2).sum() / m.sum())
    np.testing.assert_allclose(tt.eval_image(0, write_images=False)["depth_mse"], want,
                               rtol=1e-5)


def _metrics(out_dir, method):
    path = Path(out_dir) / "exp" / method / "metrics.jsonl"
    return [json.loads(ln) for ln in path.read_text().splitlines()]


@pytest.mark.parametrize("method", ["nerfacto-tpu", "semantic-nerfw"])
def test_cli_trains_then_eval_only_reproduces(scene, tmp_path, capsys, method):
    argv = _window(scene, tmp_path) + TINY + ["--trainer.max_num_iterations", "3"]
    if method == "semantic-nerfw":
        argv += FOURIER[:2] + FOURIER[10:] + _supervision(scene)
    tcli.main([method] + argv, device="cpu")
    lines = _metrics(tmp_path, method)
    assert [ln["step"] for ln in lines if "total_loss" in ln] == [1, 2, 3]
    final = {k[len("eval_all_"):]: v for k, v in lines[-1].items() if k.startswith("eval_all_")}
    assert final["num_images"] == 2 and np.isfinite(final["psnr"])
    if method == "semantic-nerfw":
        assert {"masked_psnr", "depth_mse", "semantic_accuracy", "ssim"} <= set(final)
        assert all(np.isfinite(ln["depth_loss"]) and np.isfinite(ln["semantics_loss"])
                   for ln in lines if "total_loss" in ln)
    out_dir = tmp_path / "exp" / method
    assert len(list(out_dir.glob("ckpt_*.pt"))) == 1
    capsys.readouterr()
    tcli.main([method] + argv + ["--eval-only", "true", "--trainer.load_dir", str(out_dir)],
              device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed.pop("step") == 3
    assert printed == final


def test_cli_modes_help_and_render_only(scene, tmp_path, capsys):
    tcli.main(["--help"], device="cpu")
    out = capsys.readouterr().out
    assert all(name in out for name in tcli.method_registry)
    tcli.main(["nerfacto-tpu", "--help"], device="cpu")
    assert "--model.field_type (= 'fourier')" in capsys.readouterr().out
    argv = ["nerfacto-tpu"] + _window(scene, tmp_path) + TINY
    tcli.main(argv + ["--trainer.max_num_iterations", "1"], device="cpu")
    renders = tmp_path / "renders"
    tcli.main(argv + ["--render-only", "true", "--render-dir", str(renders), "--trainer.load_dir",
                      str(tmp_path / "exp" / "nerfacto-tpu"), "--dataparser.last_frame", "3",
                      "--dataparser.train_split_fraction", "0.5"], device="cpu")
    assert (renders / "rgb_00000.png").read_bytes()[:4] == b"\x89PNG"
    with pytest.raises(NotImplementedError, match="render-focal-mult"):
        tcli.main(argv + ["--render-focal-mult", "2"], device="cpu")
    with pytest.raises(SystemExit, match="unknown method"):
        tcli.main(["nerfacto-tpu-slow"], device="cpu")


def test_cli_semantic_head_off_without_labels(scene, tmp_path, capsys):
    spec = tcli.apply_overrides(tcli.method_registry["semantic-nerfw"](),
                                _overrides(_window(scene, tmp_path) + TINY + FOURIER[:2]
                                           + FOURIER[10:]))
    trainer = tcli.build_trainer(spec, device="cpu")
    assert not trainer.model_config.use_semantic and "semantic_mlp" not in trainer.params["fields"]
    assert "disabling the semantic head" in capsys.readouterr().out


def test_cli_raises_without_cuda(scene, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcli.main(["nerfacto-tpu"] + _window(scene, tmp_path) + TINY)
    spec = tmethods.nerfacto_tpu_method()
    assert spec.model_config().compute_dtype == "bfloat16"


@pytest.mark.parametrize("device,dtype", [("cuda", "bfloat16"), ("cpu", "float32")])
def test_mixed_precision_is_bf16_on_the_card_only(device, dtype):
    spec = tmethods.nerfacto_tpu_method()
    assert spec.model_config(device).compute_dtype == dtype
    assert spec.model_config(torch.device(device)).compute_dtype == dtype
    off = dataclasses.replace(spec, trainer=dataclasses.replace(spec.trainer,
                                                                mixed_precision=False))
    assert off.model_config(device).compute_dtype == "float32"


def test_module_entry_point_lists_methods():
    res = subprocess.run([sys.executable, "-m", "nerf_kbs_tpu_torch.engine.cli", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120, check=True)
    assert "semantic-nerfw" in res.stdout and "nerfacto-tpu-fast" in res.stdout
