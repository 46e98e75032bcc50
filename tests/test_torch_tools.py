"""The port's tools (tools/*_torch.py) against the JAX package's tools on the
CPU: every NumPy helper bit for bit against the JAX tool's own function,
one study_field training round and one camera-only step of
study_camera_opt's frozen arm against the same round rebuilt from the JAX
package's functions on converted weights (f32; JAX runs its fused Pallas
path in interpret mode, NKT_FUSED=1), and each tool's main at tiny sizes on
the CPU, to its end, with the key set of the JAX tool's committed result."""

import dataclasses
import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_kbs_tpu.cameras.cameras import generate_rays as j_generate_rays
from nerf_kbs_tpu.cameras.transforms import compose_se3 as j_compose_se3
from nerf_kbs_tpu.cameras.transforms import exp_map_se3 as j_exp_map_se3
from nerf_kbs_tpu.data.synthetic import SyntheticDataManager as JDataManager
from nerf_kbs_tpu.engine.optimizers import OptimizerConfig as JOptimizerConfig
from nerf_kbs_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.engine.optimizers import build_optimizer
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.models import nerfacto as tnerf
from nerf_kbs_tpu_torch.ops import fused_field as ff

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import demo_motion_pipeline_torch  # noqa: E402
import regen_data_torch  # noqa: E402
import study_camera_opt_torch as tcam  # noqa: E402
import study_field_torch as tfield  # noqa: E402
import study_flow_torch  # noqa: E402
import study_vanilla_torch  # noqa: E402
import train_segmenter_torch as tseg  # noqa: E402
import tune_decoder_torch  # noqa: E402
import validate_inpaint_torch as tinp  # noqa: E402

CPU = torch.device("cpu")
# a few narrow layers of the fused Fourier field
SMALL = ["fourier_num_levels=2", "fourier_features_per_level=8", "proposal_num_levels=2",
         "proposal_fourier_features_per_level=4", "hidden_dim=16", "hidden_dim_color=16",
         "base_res=4", "max_res=32", "proposal_max_res=[16,32]",
         "num_proposal_samples_per_ray=[16,8]", "num_nerf_samples_per_ray=8",
         "fourier_basis=tri"]
SCENE = ["--img", "16", "--cams", "4", "--eval-cams", "2", "--batch", "64"]
CAMS = 4


@pytest.fixture(autouse=True)
def two_threads():
    """Two CPU threads a test: the suite's workers share the host's cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def jax_tools(monkeypatch):
    """The JAX tools' modules, imported from tools/ as the tools import each
    other."""
    monkeypatch.syspath_prepend(str(REPO / "tools"))
    import study_camera_opt
    import study_field
    import train_segmenter
    import validate_inpaint

    return {"field": study_field, "camera": study_camera_opt, "segmenter": train_segmenter,
            "inpaint": validate_inpaint}


def _committed(rel: str) -> dict:
    return json.loads((REPO / "outputs" / rel).read_text())


def _json_lines(out: str) -> list:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


# ---------------------------------------------------------------------------
# NumPy helpers, bit for bit
# ---------------------------------------------------------------------------


def _poses(rng, n):
    a = rng.normal(size=(n, 3, 3))
    q = np.linalg.qr(a)[0] * np.sign(np.linalg.det(np.linalg.qr(a)[0]))[:, None, None]
    return np.concatenate([q, rng.normal(size=(n, 3, 1))], axis=-1)


def test_kabsch_and_pose_errors_equal_jax(jax_tools):
    j = jax_tools["camera"]
    rng = np.random.default_rng(0)
    src, dst = rng.normal(size=(28, 3)), rng.normal(size=(28, 3))
    for got, want in zip(tcam.kabsch_se3(src, dst), j.kabsch_se3(src, dst)):
        np.testing.assert_array_equal(got, want)
    hat, true = _poses(rng, 28), _poses(rng, 28)
    assert tcam.pose_errors(hat, true) == j.pose_errors(hat, true)
    assert tcam.pose_errors(true, true) == j.pose_errors(true, true)


def test_parse_overrides_and_flagship_equal_jax(jax_tools):
    j = jax_tools["field"]
    pairs = SMALL + ["field_type=hash", "stop_grad_sampling=true", "lr=1e-3", "name=a=b"]
    assert tfield.parse_overrides(pairs) == j.parse_overrides(pairs)
    for img in (16, 128):
        assert tfield.flagship_study_overrides(img) == j.flagship_study_overrides(img)


@pytest.mark.parametrize("touching", [True, False])
def test_random_movers_equal_jax(jax_tools, touching):
    j = jax_tools["segmenter"]
    for seed in range(4):
        got = tseg.random_movers(np.random.default_rng(seed), touching)
        want = j.random_movers(np.random.default_rng(seed), touching)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.velocity, w.velocity)
            for f in ("lo", "hi", "base_color"):
                np.testing.assert_array_equal(getattr(g.box, f), getattr(w.box, f))
            assert g.box.kind == w.box.kind


def test_flows_and_probability_equal_jax(jax_tools):
    """static_reprojection_flow and moving_probability_np on the same
    arrays."""
    j = jax_tools["segmenter"]
    rng = np.random.default_rng(1)
    pa, pb = _poses(rng, 2)
    depth = np.where(rng.random((24, 40)) < 0.2, 0.0, rng.uniform(1, 60, (24, 40)))
    args = (pa, pb, depth, 30.0, 28.0, 20.0, 12.0)
    rigid = tseg.static_reprojection_flow(*args)
    np.testing.assert_array_equal(rigid, j.static_reprojection_flow(*args))
    optical = rigid + rng.normal(size=rigid.shape).astype(np.float32)
    np.testing.assert_array_equal(tseg.moving_probability_np(optical, rigid),
                                  j.moving_probability_np(optical, rigid))


def test_make_samples_equal_jax(jax_tools):
    """One touching scene of 2 frames at 24 x 80: inputs, targets and the
    instance labels."""
    got = tseg.make_samples(3, 2, 24, 80, touching=True)
    want = jax_tools["segmenter"].make_samples(3, 2, 24, 80, touching=True)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_instance_metrics_equal_jax(jax_tools):
    j = jax_tools["segmenter"]
    rng = np.random.default_rng(2)
    for _ in range(4):
        pred, gt = rng.integers(0, 4, (20, 30)), rng.integers(0, 3, (20, 30))
        assert tseg.instance_quality(pred, gt) == j.instance_quality(pred, gt)
        assert tseg.mask_iou(pred, gt) == j.mask_iou(pred, gt)
    empty = np.zeros((5, 5), int)
    assert tseg.instance_quality(empty, empty) == j.instance_quality(empty, empty)
    assert tseg.mask_iou(empty, empty) == j.mask_iou(empty, empty)


def test_masked_psnr_equal_jax(jax_tools):
    rng = np.random.default_rng(3)
    pred, gt = rng.random((6, 16, 16, 3)), rng.random((6, 16, 16, 3))
    for mask in (rng.random((6, 16, 16)) < 0.3, np.zeros((6, 16, 16))):
        mask = mask.astype(np.float32)
        assert tinp.masked_psnr(pred, gt, mask) == jax_tools["inpaint"].masked_psnr(pred, gt,
                                                                                    mask)


# ---------------------------------------------------------------------------
# one study round and one frozen-arm step against JAX
# ---------------------------------------------------------------------------


def _jitters(key, rounds, n_rays):
    """What jnerf.forward draws from ``key``: one (R, 1) uniform per sampler
    call, from the key split rounds + 1 ways."""
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


@pytest.fixture(scope="module")
def scene():
    """The study scene at 16 x 16 (4 train, 2 eval cameras, 64-ray
    batches), both packages', and the first batches, which must agree."""
    kw = dict(num_cameras=CAMS, num_eval_cameras=2, h=16, w=16, rays_per_batch=64)
    jdm, tdm = JDataManager(**kw), tcam.SyntheticDataManager(**kw)
    batches = [tdm.next_train(s) for s in range(2)]
    for s, b in enumerate(batches):
        for k, v in jdm.next_train(s).items():
            np.testing.assert_array_equal(b[k], np.asarray(v))
    return jdm, tdm, batches


def _j_study_config(over: dict, **extra):
    """study_field.py's config off the TPU, over ``over``."""
    return jnerf.NerfactoConfig(**{"num_images": CAMS, "field_type": "fourier",
                                   "near_plane": 0.05, "far_plane": 8.0,
                                   "appearance_embedding_dim": 0, "compute_dtype": "float32",
                                   **over, **extra})


@pytest.fixture(scope="module")
def jax_weights():
    """JAX's weights of the study config (with the camera optimizer, whose
    tangents start at 0), drawn once for the module."""
    over = tfield.config_values(tfield.parse_overrides(SMALL))
    cfg = _j_study_config(over, camera_optimizer="SO3xR3")
    return over, jax.tree.map(np.asarray, jnerf.init(jax.random.PRNGKey(0), cfg))


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-12)


def test_study_field_round_matches_jax(monkeypatch, scene, jax_weights):
    """study_field_torch's round (make_train_step, run_round: 2 steps of 64
    rays from step 0) against study_field.py's scanned round rebuilt from
    the same JAX functions, jitted, on JAX's weights converted, f32, the
    same batches and jitter. The first step's loss sees the forward and the
    loss alone: 1e-5 relative. The second follows an Adam step at 1e-3,
    whose first update moves each weight by about lr x sign(g): its loss to
    1e-4 relative, the weights after the round to 2e-4 absolute (a fifth
    of lr)."""
    monkeypatch.setenv("NKT_FUSED", "1")
    jdm, tdm, batches = scene
    over, jp0 = jax_weights
    jp = {k: v for k, v in jp0.items() if k != "camera_opt"}
    jcfg = _j_study_config(over)
    tcfg = tnerf.NerfactoConfig(num_images=CAMS, field_type="fourier", near_plane=0.05,
                                far_plane=8.0, appearance_embedding_dim=0,
                                compute_dtype="float32", **over)
    group = JOptimizerConfig(lr=1e-3, eps=1e-15, max_norm=1.0)
    joptim = j_build_optimizer({"proposal_networks": group, "fields": group},
                               jnerf.param_groups(jp))
    train_cams = jdm.train_cameras

    @jax.jit
    def multi_step(params, opt_state, stacked, keys, step0):
        def body(carry, xs):
            params, opt_state, step = carry
            batch, k = xs
            rays = j_generate_rays(train_cams, batch["ray_indices"])

            def loss_fn(p):
                out = jnerf.forward(p, jcfg, rays, key=k, step=step, train=True)
                return jnerf.loss(jcfg, out, batch, train=True)

            (loss, m), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = joptim.update(grads, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state, step + 1.0), loss

        (params, opt_state, _), losses = jax.lax.scan(body, (params, opt_state, step0),
                                                      (stacked, keys))
        return params, losses

    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    stacked = {k: jnp.stack([jnp.asarray(b[k]) for b in batches]) for k in batches[0]}
    jp_after, jlosses = multi_step(jp, joptim.init(jp), stacked, keys, jnp.asarray(0.0))

    tp = params_from_jax(jp, device="cpu")
    mark_trainable(tp)
    optim = build_optimizer({"proposal_networks": tfield.OptimizerConfig(lr=1e-3, eps=1e-15,
                                                                         max_norm=1.0),
                             "fields": tfield.OptimizerConfig(lr=1e-3, eps=1e-15,
                                                              max_norm=1.0)},
                            tnerf.param_groups(tp), device="cpu")
    step = tfield.make_train_step(tcfg, tp, optim, tdm.train_outputs.cameras(CPU))
    losses = []

    def recorded(batch, s, generator=None, jitters=None):
        loss, psnr = step(batch, s, generator=generator, jitters=jitters)
        losses.append(float(loss))
        return loss, psnr

    ff.reset_launches()
    last, _ = tfield.run_round(recorded, [tfield.device_batch(b, CPU) for b in batches], 0,
                               jitters=[_jitters(k, jcfg.num_proposal_iterations, 64)
                                        for k in keys])
    assert last == losses[-1] and len(losses) == 2
    np.testing.assert_allclose(losses[0], float(jlosses[0]), rtol=1e-5)
    np.testing.assert_allclose(losses[1], float(jlosses[1]), rtol=1e-4)
    want = params_from_jax(jax.tree.map(np.asarray, jp_after), device="cpu")
    for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(want)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=2e-4)
    assert not any(ff.LAUNCHES.values())  # the CPU runs the plain versions


def test_frozen_arm_camera_step_matches_jax(monkeypatch, scene, jax_weights):
    """One camera-only step of the frozen arm (study_camera_opt_torch's
    frozen_groups: learning rate 0 on the fields, SO3xR3 Adam on the
    tangents) on perturbed cameras at step 3000, against the JAX tool's
    frozen phase rebuilt from the JAX functions, on the same converted
    weights, batch and jitter, f32. The tangents' gradient to 1e-4
    relative, the loss to 1e-5; the fields do not move, the tangents move
    as Adam's first step moves them (lr x g / |g|) to 1e-6 absolute."""
    monkeypatch.setenv("NKT_FUSED", "1")
    jdm, tdm, batches = scene
    over, jp = jax_weights
    flagship = tfield.flagship_study_overrides(16)
    jcfg = _j_study_config({**flagship, **over}, camera_optimizer="SO3xR3")
    tcfg = tnerf.NerfactoConfig(**{"num_images": CAMS, "near_plane": 0.05, "far_plane": 8.0,
                                   "appearance_embedding_dim": 0, "camera_optimizer": "SO3xR3",
                                   **flagship, "compute_dtype": "float32", **over})
    tangent = tcam.injected_tangent(0, CAMS, 1.0, 0.03)
    jcams = jdm.train_cameras
    j_pert = dataclasses.replace(jcams, c2w=j_compose_se3(j_exp_map_se3(jnp.asarray(tangent)),
                                                           jcams.c2w))
    cam_opt = JOptimizerConfig(lr=6e-4, eps=1e-8, max_norm=1.0, lr_final=6e-6, max_steps=3000)
    jgroups = {"proposal_networks": JOptimizerConfig(lr=0.0),
               "fields": JOptimizerConfig(lr=0.0), "camera_opt": cam_opt}
    joptim = j_build_optimizer(jgroups, jnerf.param_groups(jp))
    batch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    key = jax.random.PRNGKey(11)

    def loss_fn(p):
        rays = j_generate_rays(j_pert, batch["ray_indices"], c2w_delta=jnerf.camera_deltas(p))
        out = jnerf.forward(p, jcfg, rays, key=key, step=3000.0, train=True)
        return jnerf.loss(jcfg, out, batch, train=True)[0]

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(jp)
    updates, _ = joptim.update(jgrads, joptim.init(jp), jp)
    j_after = optax.apply_updates(jp, updates)

    tp = params_from_jax(jp, device="cpu")
    mark_trainable(tp)
    tcams = tdm.train_outputs.cameras(CPU)
    t_pert = dataclasses.replace(tcams, c2w=tcam.compose_se3(
        tcam.exp_map_se3(torch.as_tensor(tangent)), tcams.c2w))
    groups = tcam.frozen_groups(tfield.OptimizerConfig(lr=6e-4, eps=1e-8, max_norm=1.0,
                                                       lr_final=6e-6, max_steps=3000))
    optim = build_optimizer(groups, tnerf.param_groups(tp), device="cpu")
    fields_before = [t.detach().clone() for t in jax.tree.leaves(
        {k: v for k, v in tp.items() if k != "camera_opt"})]
    step = tfield.make_train_step(tcfg, tp, optim, t_pert)
    ff.reset_launches()
    loss, _ = step(tfield.device_batch(batches[0], CPU), 3000,
                   jitters=_jitters(key, jcfg.num_proposal_iterations, 64))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    g = tp["camera_opt"].grad.numpy()
    assert _rel(g, jgrads["camera_opt"]) <= 1e-4
    assert np.abs(g[:, :3]).max() > 0 and np.abs(g[:, 3:]).max() > 0
    np.testing.assert_allclose(tp["camera_opt"].detach().numpy(),
                               np.asarray(j_after["camera_opt"]), atol=1e-6)
    after = [t.detach() for t in jax.tree.leaves({k: v for k, v in tp.items()
                                                  if k != "camera_opt"})]
    assert all(torch.equal(a, b) for a, b in zip(after, fields_before))
    assert not any(ff.LAUNCHES.values())


# ---------------------------------------------------------------------------
# each tool's main on the CPU
# ---------------------------------------------------------------------------


def test_study_field_main(capsys):
    tfield.main(["--platform", "cpu", "--steps", "4", "--scan-steps", "2", "--eval-every", "2",
                 "--name", "tiny", *SCENE, *SMALL])
    out = capsys.readouterr().out
    res = _json_lines(out)[-1]
    assert set(res) == set(_committed("field_ab/tri_ab.json"))
    assert [t[0] for t in res["trajectory"]] == [2, 4]
    assert all(np.isfinite(t[1:]).all() for t in np.array(res["trajectory"]))
    launches = [ln for ln in out.splitlines() if ln.startswith("# launches ")]
    summary = json.loads(launches[0][len("# launches "):])
    assert summary["train_steps"] == 4 and summary["eval_chunks"] == 4
    assert summary["train"] == summary["eval"] == {}  # the CPU launches no kernel


def test_study_camera_opt_frozen_main(tmp_path, capsys):
    out = tmp_path / "frozen.json"
    tcam.main(["--platform", "cpu", "--arms", "frozen", "--steps", "2", "--scan-steps", "2",
               "--eval-every", "2", "--out", str(out), *SCENE, *SMALL])
    res = json.loads(out.read_text())
    want = _committed("camopt_study/frozen.json")
    assert set(res) == set(want) and set(res["injected"]) == set(want["injected"])
    assert set(res["arms"][0]) == set(want["arms"][0])
    assert res["arms"][0]["trajectory"][-1][0] == 4
    assert _json_lines(capsys.readouterr().out)[-1] == res


def test_study_camera_opt_other_arms_main(capsys):
    """The clean, off, opt and probe arms: the probe's s = 1 composes to
    the clean poses, so its PSNR is the clean-pose PSNR."""
    tcam.main(["--platform", "cpu", "--arms", "clean,off,opt,probe", "--steps", "2",
               "--scan-steps", "2", "--eval-every", "2", *SCENE, *SMALL])
    arms = _json_lines(capsys.readouterr().out)[-1]["arms"]
    assert [a["arm"] for a in arms] == ["clean", "off", "opt", "probe"]
    assert {"pose_rot_err_deg", "pose_center_err", "reproj_px_err"} <= set(arms[2])
    probe = arms[3]
    assert len(probe["grad_cos_per_cam"]) == CAMS
    s1 = dict(map(tuple, probe["line_probe"]))[1.0]
    assert s1 == pytest.approx(probe["clean_pose_probe_psnr"], abs=2e-3)


def test_study_vanilla_main(capsys):
    study_vanilla_torch.main(["--platform", "cpu", "--steps", "2", "--scan-steps", "2",
                              "--eval-every", "2", "--img", "16", "--cams", "4",
                              "--eval-cams", "2", "--batch", "32", "mlp_layer_width=32",
                              "num_coarse_samples=8", "num_importance_samples=8"])
    res = _json_lines(capsys.readouterr().out)[-1]
    assert set(res) == set(_committed("vanilla_orbit/result.json"))
    assert res["trajectory"][0][0] == 2 and np.isfinite(res["trajectory"][0][2])


def test_study_flow_main(tmp_path, monkeypatch, capsys):
    """Both arms at 10 frames of 24 x 80 (9 train, 1 held out), one step
    each: the JAX tool's last line, one entry per flow_loss_mult."""
    monkeypatch.chdir(tmp_path)
    study_flow_torch.main(["--platform", "cpu", "--steps", "1", "--batch", "16", "--frames",
                           "10", "--h", "24", "--w", "80", "--data", str(tmp_path / "data")])
    res = _json_lines(capsys.readouterr().out)[-1]
    assert list(res) == ["0.0", "0.001"]
    assert all(m["num_images"] == 1 and np.isfinite(m["depth_mse"]) for m in res.values())


@pytest.fixture(scope="module")
def segmenter_run(tmp_path_factory):
    """train_segmenter_torch at 2 scenes of 2 frames, 32 x 96, 3 steps."""
    out = tmp_path_factory.mktemp("segmenter")
    tseg.main(["--platform", "cpu", "--scenes", "2", "--eval-scenes", "1", "--frames", "2",
               "--h", "32", "--w", "96", "--steps", "3", "--batch", "2", "--out", str(out)])
    return out


def test_train_segmenter_main(segmenter_run, tmp_path):
    res = json.loads((segmenter_run / "result.json").read_text())
    # the JAX tool's keys: those of its committed result and the two it
    # gained since (those of outputs/segmenter3/result.json)
    assert set(_committed("segmenter2/result.json")) <= set(res)
    assert set(res) == set(_committed("segmenter3/result.json"))
    assert set(res["heldout_touching"]) == set(
        _committed("segmenter2/result.json")["heldout_touching"])
    assert res["train_frames"] == 4 and res["eval_frames"] == 2 and res["steps"] == 3
    # the checkpoint reads back, and --eval-ckpt scores it the same
    tseg.main(["--platform", "cpu", "--eval-ckpt", str(segmenter_run / "segmenter.npz"),
               "--eval-scenes", "1", "--frames", "2", "--h", "32", "--w", "96",
               "--out", str(tmp_path)])
    again = json.loads((tmp_path / "result.json").read_text())
    assert again["heldout_touching"] == res["heldout_touching"] and again["steps"] == 0


def test_tune_decoder_main(segmenter_run, tmp_path):
    tune_decoder_torch.main(["--platform", "cpu", "--ckpt",
                             str(segmenter_run / "segmenter.npz"), "--tune-scenes", "1",
                             "--eval-scenes", "1", "--frames", "1", "--h", "32", "--w", "96",
                             "--out", str(tmp_path)])
    res = json.loads((tmp_path / "result.json").read_text())
    want = _committed("segmenter_decoder/result.json")
    assert set(res) == set(want)
    assert set(res["eval_tuned"]) == set(want["eval_tuned"])


def test_validate_inpaint_main(tmp_path):
    tinp.main(["--platform", "cpu", "--steps", "2", "--size", "32", "--frames", "8",
               "--window", "4", "--out", str(tmp_path)])
    res = json.loads((tmp_path / "result.json").read_text())
    assert set(_committed("inpaint_validation/result.json")) <= set(res)
    # the clip's last 4 frames are held out
    assert res["fill_img_count"] == 4 and len(list((tmp_path / "fill_img").iterdir())) == 4
    assert all(np.isfinite([res["masked_psnr_trained"], res["masked_psnr_gray_fill"]]))


def test_demo_motion_pipeline_main(tmp_path):
    demo_motion_pipeline_torch.main(["--platform", "cpu", "--frames", "3", "--h", "47",
                                     "--w", "156", "--out", str(tmp_path)])
    res = json.loads((tmp_path / "result.json").read_text())
    assert set(_committed("motion_pipeline_demo/result.json")) <= set(res)
    assert "mean_of_median_static_flow_err_px" in res and len(res["per_frame_iou"]) == 2
    assert len(list(tmp_path.glob("mask_*.png"))) == len(list(tmp_path.glob("overlay_*.png"))) == 2


def test_regen_data_writes_the_jax_tools_files(tmp_path, monkeypatch):
    """regen_data.py with its three writers cut to 2 frames of 24 x 80 and
    pointed under tmp_path, and regen_data_torch.py at --frames 2 --h 24
    --w 80: the same files."""
    import nerf_kbs_tpu.data.synthetic_kitti as jsk

    def shrunk(writer):
        real = getattr(jsk, writer)

        def call(out_dir, **kw):
            rel = Path(out_dir).relative_to(Path(out_dir).parents[1])
            return real(tmp_path / "jax" / rel, n_frames=2, h=24, w=80)

        return call

    for w in ("write_dataset", "write_vkitti_dataset", "write_dynamic_dataset"):
        monkeypatch.setattr(jsk, w, shrunk(w))
    runpy.run_path(str(REPO / "tools" / "regen_data.py"))
    regen_data_torch.main(["--platform", "cpu", "--root", str(tmp_path / "port"),
                           "--frames", "2", "--h", "24", "--w", "80"])

    def files(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    want = files(tmp_path / "jax")
    assert files(tmp_path / "port") == want and len(want) > 10


TOOLS = {
    "study_field_torch": tfield.main, "study_camera_opt_torch": tcam.main,
    "study_vanilla_torch": study_vanilla_torch.main, "study_flow_torch": study_flow_torch.main,
    "train_segmenter_torch": tseg.main, "tune_decoder_torch": tune_decoder_torch.main,
    "validate_inpaint_torch": tinp.main,
    "demo_motion_pipeline_torch": demo_motion_pipeline_torch.main,
    "regen_data_torch": regen_data_torch.main,
}


@pytest.mark.parametrize("name", TOOLS)
def test_tool_needs_cuda_or_platform_cpu(name, monkeypatch, tmp_path):
    """Without CUDA each tool raises unless given --platform cpu (before it
    writes anything); an unknown platform raises too."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--platform", "cuda"], ["--platform", "gpu"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TOOLS[name](argv)
    with pytest.raises(ValueError, match="unknown --platform"):
        TOOLS[name](["--platform", "tpu"])
    assert not list(tmp_path.iterdir())
