"""Port vs JAX package, the method registry and the CLI on the CPU: the specs
and their override paths, trainers built from a KITTI-layout scene on disk
(three steps of each package's trainer on the same batches and jitter), and
the run modes of ``nerf_kbs_tpu_torch.engine.cli.main``. JAX runs its fused
Pallas path in interpret mode (NKT_FUSED=1)."""

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
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.engine.optimizers import tree_copy_

REPO = Path(__file__).resolve().parents[1]
H, W = 47, 156
# nerfacto-tpu's model fields, for semantic-nerfw on the fused Fourier path
FOURIER = ["--model.field_type", "fourier", "--model.hidden_dim", "128", "--model.num_layers", "3",
           "--model.base_res", "4", "--model.max_res", "256", "--model.fourier_basis", "tri",
           "--model.num_proposal_samples_per_ray", "96,32", "--model.stop_grad_sampling", "true",
           "--model.interlevel_ray_fraction", "0.5", "--model.appearance_embedding_dim", "0"]
# tiny widths for the CPU
TINY = ["--model.hidden_dim", "16", "--model.fourier_num_levels", "2",
        "--model.fourier_features_per_level", "8", "--model.proposal_num_levels", "2",
        "--model.proposal_fourier_features_per_level", "4", "--model.hidden_dim_color", "16",
        "--model.proposal_max_res", "16,32", "--model.num_proposal_samples_per_ray", "16,8",
        "--model.num_nerf_samples_per_ray", "8", "--datamanager.train_num_rays_per_batch", "64",
        "--datamanager.num_workers", "2", "--trainer.eval_num_rays_per_chunk", "4096",
        "--trainer.log_every", "1"]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return jsk.write_dynamic_dataset(tmp_path_factory.mktemp("cli") / "scene", n_frames=8, h=H,
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
    description says what is ported); the model and dataparser leaves are
    the same sets (the vanilla-nerf model and its vKITTI parser are not
    ported)."""
    jl = _leaves(jcli.method_registry[name](), jcli)
    tl = _leaves(tcli.method_registry[name](), tcli)
    for path, v in tl.items():
        if path == "description" or (name == "vanilla-nerf" and path in ("model", "dataparser")):
            continue
        assert path in jl and jl[path] == v, (path, v, jl.get(path))
    if name != "vanilla-nerf":
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
def test_unported_methods_raise_by_name(method, argv, name):
    spec = tcli.apply_overrides(tcli.method_registry[method](), _overrides(argv))
    with pytest.raises(NotImplementedError, match=name):
        tcli.build_trainer(spec, device="cpu")


def _jitters(key, rounds, n_rays):
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


@pytest.mark.parametrize("method", ["nerfacto-tpu", "semantic-nerfw"])
def test_build_trainer_steps_track_jax(scene, tmp_path, monkeypatch, method):
    """Both packages' build_trainer on the same argv and scene (num_images
    and the class count from the data), then three steps from the same
    parameters on the same batches and jitter: losses to 2e-3, parameters to
    2e-3 after the three steps."""
    monkeypatch.setenv("NKT_FUSED", "1")
    monkeypatch.setattr(jnative, "_lib", False)  # the JAX datamanager's NumPy draws
    monkeypatch.setattr(jtrainer_mod, "make_mesh", lambda *a: make_mesh(jax.devices()[:1]))
    argv = _window(scene, tmp_path) + TINY
    if method == "semantic-nerfw":
        argv += FOURIER[:2] + FOURIER[10:] + _supervision(scene)
    ov = _overrides(argv)
    jt = jcli.build_trainer(jcli.apply_overrides(jcli.method_registry[method](), ov))
    tt = tcli.build_trainer(tcli.apply_overrides(tcli.method_registry[method](), ov), device="cpu")
    assert tt.model_config == type(tt.model_config)(**{
        f.name: getattr(jt.model_config, f.name) for f in dataclasses.fields(tt.model_config)})
    assert tt.model_config.num_images == 6 and tt.model_config.compute_dtype == "float32"
    if method == "semantic-nerfw":
        assert tt.model_config.num_semantic_classes == 4
    tree_copy_(tt.params, jax.tree.map(np.asarray, jt.params))
    rounds = jt.model_config.num_proposal_iterations
    for step in range(3):
        jb, tb = jt.dm.next_train(step), tt.dm.next_train(step)
        for k in jb:
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        key = jax.random.fold_in(jt._base_key, step)
        jt.params, jt.opt_state, jm = jt._train_step(
            jt.params, jt.opt_state, jt.train_cameras, shard_batch(jt.mesh, jb), key,
            jnp.asarray(step, jnp.float32))
        tm = tt.train_step(tt._to_device(tb), jitters=_jitters(key, rounds, 64))
        assert set(tm) == set(jm)
        np.testing.assert_allclose(float(tm["total_loss"]), float(jm["total_loss"]), rtol=2e-3)
    want = params_from_jax(jax.tree.map(np.asarray, jt.params), device="cpu")
    for t, j in zip(jax.tree.leaves(tt.params), jax.tree.leaves(want)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=2e-3)


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
