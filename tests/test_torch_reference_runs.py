"""The reference operating point's two protocols, as
``tools/reference_runs_torch.sh`` runs them on the card, against the JAX
package on the CPU: ``ilf050`` (nerfacto-tpu, ``tools/tpu_queue_q.sh``) and
``sem30k-flagship2`` (semantic-nerfw on the tri Fourier field,
``tools/tpu_queue_w.sh``). Every argv here is read from the script, and the
script's is held to the JAX queue script's, so the three cannot drift:

- the argv is the JAX run's, letter for letter, but for the output
  directory, the seed and the checkpoint cadence, and it resolves to the
  same config through both CLIs, in every field;
- the step-dependent pieces of the 30,000-step horizon agree at the steps
  where they turn: every optimizer group's learning rate, the Fourier
  window (annealed over 5,000 steps) of the field and of each proposal
  field, and the proposal weights' anneal exponent, which the interlevel
  loss sees;
- a cut run of both CLIs (tiny widths on a tiny 40-frame scene, 6 steps,
  eval cadences 2 / 3 / 6, the protocol's ``--trainer.steps_per_dispatch
  50``) logs the same keys at the same steps, in the same order;
- a run resumed through the script's resume argv from its step-3
  checkpoint logs what the uninterrupted run logged.
"""

import json
import os
import re
import shlex
import shutil
import subprocess
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
from nerf_kbs_tpu.ops.encoding import fourier_window as j_fourier_window
from nerf_kbs_tpu.ops.samplers import anneal_schedule as j_anneal_schedule
from nerf_kbs_tpu.parallel.mesh import make_mesh
from nerf_kbs_tpu_torch import methods as tmethods  # noqa: F401  (registers the port's)
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.engine.optimizers import GroupOptimizer
from nerf_kbs_tpu_torch.models import nerfacto as tnerf

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "tools" / "reference_runs_torch.sh"
# protocol -> (JAX queue script, its launcher)
QUEUE = {"ilf050": ("tools/tpu_queue_q.sh", "train_nerfacto.py"),
         "sem30k-flagship2": ("tools/tpu_queue_w.sh", "train.py")}
PROTOCOLS = sorted(QUEUE)
HORIZON = (0, 1, 999, 1000, 2500, 4999, 5000, 5001, 15000, 29999, 30000)
# tiny widths for the CPU (tests/test_torch_cli.py's TINY, the protocol's
# log cadence kept)
TINY = ["--model.hidden_dim", "16", "--model.fourier_num_levels", "2",
        "--model.fourier_features_per_level", "8", "--model.proposal_num_levels", "2",
        "--model.proposal_fourier_features_per_level", "4", "--model.hidden_dim_color", "16",
        "--model.proposal_max_res", "16,32", "--model.num_proposal_samples_per_ray", "16,8",
        "--model.num_nerf_samples_per_ray", "8", "--datamanager.train_num_rays_per_batch", "64",
        "--datamanager.num_workers", "2", "--trainer.eval_num_rays_per_chunk", "4096"]
H, W = 24, 80
CUT = ["--dataparser.image_height", str(H), "--dataparser.image_width", str(W),
       "--trainer.max_num_iterations", "6", "--trainer.log_every", "2",
       "--trainer.steps_per_eval_batch", "2", "--trainer.steps_per_eval_image", "3",
       "--trainer.steps_per_eval_all_images", "6", "--trainer.steps_per_save", "3"]
TIMING = ("rays_per_sec", "elapsed_s")


def script_argv(run, out="O"):
    """(launcher, method, argv) of run ``run`` as the script prints it."""
    words = subprocess.run(["bash", str(SCRIPT), "--argv", out, run], check=True,
                           capture_output=True, text=True).stdout.split()
    return words[0], words[1], words[2:]


def queue_argv(protocol):
    """(launcher, method, argv) of the protocol's run in its JAX queue script:
    its FLAG, then the words after ``$FLAG`` up to the redirection."""
    path, launcher = QUEUE[protocol]
    text = (REPO / path).read_text().replace("\\\n", " ")
    flag = shlex.split(re.search(r'^FLAG="([^"]*)"', text, re.M).group(1))
    for m in re.finditer(rf"python {re.escape(launcher)} (\S+) \$FLAG(.*?)>", text):
        extra = shlex.split(m.group(2))
        if extra[extra.index("--trainer.experiment_name") + 1] == protocol:
            return launcher, m.group(1), flag + extra
    raise AssertionError(f"no {protocol} run in {path}")


def pairs(argv):
    """--k v pairs as both CLIs read them (a later pair wins)."""
    assert all(a.startswith("--") for a in argv[::2]), argv
    return dict(zip([a[2:] for a in argv[::2]], argv[1::2]))


def leaves(cli, method, argv):
    return dict(cli._iter_leaf_fields(cli.apply_overrides(cli.method_registry[method](),
                                                          pairs(argv))))


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_script_argv_is_the_jax_runs(protocol):
    """The script's argv for both seeds is the JAX queue script's run with
    three pairs after it: the output directory, the seed and a checkpoint
    every 5,000 steps; the launcher is the JAX launcher's twin."""
    jl, jmethod, jargv = queue_argv(protocol)
    for seed in (42, 43):
        launcher, method, argv = script_argv(f"{protocol}-s{seed}")
        assert (launcher, method) == (jl.replace(".py", "_torch.py"), jmethod)
        assert argv == jargv + ["--trainer.output_dir", f"O/{protocol}-s{seed}",
                                "--trainer.seed", str(seed), "--trainer.steps_per_save", "5000"]


def test_training_runs_draw_at_one_thread(tmp_path):
    """The script runs every launcher at OMP_NUM_THREADS=1 whatever the
    caller's count, so the host sampler draws the JAX runs' batches (their
    host had one core); the launchers get the argv ``--argv`` prints. A
    python3 and an nvidia-smi on the PATH stand in for the real ones and
    record their calls."""
    bin_dir, calls = tmp_path / "bin", tmp_path / "calls.txt"
    bin_dir.mkdir()
    (bin_dir / "python3").write_text(
        f'#!/bin/bash\necho "OMP=${{OMP_NUM_THREADS:-unset}} $*" >> {calls}\n')
    (bin_dir / "nvidia-smi").write_text("#!/bin/bash\necho 'a card, 700.00 W'\n")
    for f in bin_dir.iterdir():
        f.chmod(0o755)
    out, runs = tmp_path / "out", ["ilf050-s42", "sem30k-flagship2-s43"]
    env = {**os.environ, "PATH": f"{bin_dir}:{os.environ['PATH']}", "OMP_NUM_THREADS": "8"}
    subprocess.run(["bash", str(SCRIPT), str(out), " ".join(runs)], env=env, check=True,
                   capture_output=True, text=True, timeout=120)
    launched = [ln for ln in calls.read_text().splitlines() if "_torch.py " in ln]
    want = [" ".join(script_argv(run, out=str(out))[:2]) + " " + " ".join(
        script_argv(run, out=str(out))[2]) for run in runs]
    assert launched == [f"OMP=1 {w}" for w in want]


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_protocol_config_matches_jax(protocol):
    """The argv resolves through both CLIs to the same value in every leaf
    of the port's spec, and its model and dataparser leaves are JAX's whole
    sets; ``steps_per_dispatch`` is accepted. What the argv trains: no
    appearance embedding, no camera optimizer, no NeRF-W eval fit, the
    fused Fourier path; differing from the JAX run's resolved config only in
    the three pairs the script adds."""
    _, method, argv = script_argv(f"{protocol}-s43")
    jl = leaves(jcli, method, argv)
    tl = leaves(tcli, method, argv)
    for path, v in tl.items():
        if path != "description":
            assert path in jl and jl[path] == v, (path, v, jl.get(path))
    for head in ("model.", "dataparser.", "datamanager."):
        assert {p for p in jl if p.startswith(head)} == {p for p in tl if p.startswith(head)}
    assert tl["trainer.steps_per_dispatch"] == 50
    assert tl["model.appearance_embedding_dim"] == 0
    assert tl["model.camera_optimizer"] == "off"
    assert tl["trainer.eval_fit_appearance_steps"] == 0
    assert tl["model.field_type"] == "fourier"
    assert tl["model.num_layers"] == (3 if protocol == "ilf050" else 2)
    jrun = leaves(jcli, method, queue_argv(protocol)[2])
    changed = {p for p in jl if jl[p] != jrun[p]}
    assert changed == {"trainer.output_dir", "trainer.seed", "trainer.steps_per_save"}
    assert (jrun["trainer.seed"], tl["trainer.seed"], tl["trainer.steps_per_save"]) == (42, 43, 5000)


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_horizon_schedules_match_jax(protocol):
    """At the steps where the 30k horizon turns: each optimizer group's
    learning rate as the port's optimizer reads it at that update count
    (optax's schedule in JAX), the Fourier windows of the field and of each
    proposal field (``nerfacto.windows``; JAX computes them inline in its
    forward: the clipped step / fourier_anneal_steps), and the proposal
    weights' anneal exponent of a training step."""
    _, method, argv = script_argv(f"{protocol}-s42")
    ov = pairs(argv)
    jspec = jcli.apply_overrides(jcli.method_registry[method](), ov)
    tspec = tcli.apply_overrides(tcli.method_registry[method](), ov)
    assert set(tspec.optimizers) == set(jspec.optimizers)
    opt = GroupOptimizer(tspec.optimizers, {g: {"w": torch.zeros(1)} for g in tspec.optimizers})
    cfg, jcfg = tspec.model, jspec.model
    assert cfg.fourier_anneal_steps == 5000 and cfg.use_proposal_weight_anneal
    for step in HORIZON:
        for g in tspec.optimizers:
            opt.state[g]["count"] = step
            np.testing.assert_allclose(opt.learning_rate(g),
                                       float(jspec.optimizers[g].schedule()(step)), rtol=1e-6,
                                       err_msg=f"{g} at {step}")
        progress = jnp.clip(jnp.asarray(step, jnp.float32) / jcfg.fourier_anneal_steps, 0.0, 1.0)
        field_w, prop_ws = tnerf.windows(cfg, step, "cpu")
        want = [j_fourier_window(jcfg.field.fourier, progress)] + [
            j_fourier_window(jcfg.proposal_field(i).fourier, progress)
            for i in range(jcfg.num_proposal_iterations)]
        for got, w in zip([field_w] + prop_ws, want, strict=True):
            np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7,
                                       err_msg=str(step))
        np.testing.assert_allclose(
            tnerf.proposal_anneal(cfg, step, True),
            float(j_anneal_schedule(jnp.asarray(step, jnp.float32),
                                    jcfg.proposal_weights_anneal_max_num_iters,
                                    jcfg.proposal_weights_anneal_slope)),
            rtol=1e-6, err_msg=str(step))
    # the anneal's ends: the field's window opens fully at step 5,000
    assert float(tnerf.windows(cfg, 5000, "cpu")[0].min()) == 1.0
    assert float(tnerf.windows(cfg, 0, "cpu")[0].max()) < 1.0


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The static street scene of the protocols (40 frames, semantics and
    masks), at 24x80."""
    return jsk.write_dataset(tmp_path_factory.mktemp("ref") / "kitti_syn", n_frames=40, h=H, w=W)


def cut_argv(protocol, scene, out):
    """The protocol's argv on the tiny scene at tiny widths, cut to 6 steps
    with eval cadences 2 / 3 / 6 and a checkpoint every 3 steps."""
    _, method, argv = script_argv(f"{protocol}-s42", out=str(out))
    return method, [a.replace("outputs/kitti_syn", str(scene)) for a in argv] + TINY + CUT


def logged(run_dir):
    return [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_cut_run_logs_like_jax(protocol, scene, tmp_path, monkeypatch):
    """Both CLIs' metrics.jsonl of the cut run: the same lines, each with
    the same step and keys, in the same order (JAX's scanned dispatch of 50
    lands on every cadence's boundary; the port dispatches each step), every
    value finite, the eval image of each step the same, eval_all_* over the 4
    eval images at step 6, once. The values themselves differ by the
    sampler's jitter, which the two packages draw from different generators
    (tests/test_torch_cli.py holds steps on JAX's jitter)."""
    monkeypatch.setenv("NKT_FUSED", "1")
    monkeypatch.setattr(jtrainer_mod, "make_mesh", lambda *a: make_mesh(jax.devices()[:1]))
    method, argv = cut_argv(protocol, scene, tmp_path / "port")
    tcli.main([method] + argv, device="cpu")
    _, jargv = cut_argv(protocol, scene, tmp_path / "jax")
    jcli.main([method] + jargv)
    run = Path(protocol) / method
    got = logged(tmp_path / "port" / f"{protocol}-s42" / run)
    want = logged(tmp_path / "jax" / f"{protocol}-s42" / run)
    assert [(m["step"], sorted(m)) for m in got] == [(m["step"], sorted(m)) for m in want]
    assert [m["step"] for m in got if "total_loss" in m] == [2, 4, 6]
    assert [m["step"] for m in got if "eval_batch_psnr" in m] == [2, 4, 6]
    assert [m.get("eval_image_idx") for m in got] == [m.get("eval_image_idx") for m in want]
    finals = [m for m in got if "eval_all_psnr" in m]
    assert len(finals) == 1 and finals[0]["step"] == 6 and finals[0]["eval_all_num_images"] == 4
    assert all(np.isfinite(v) for m in got for v in m.values())
    if protocol == "sem30k-flagship2":
        assert {"eval_all_semantic_accuracy", "eval_all_masked_psnr",
                "eval_all_depth_mse"} <= set(finals[0])


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_resume_logs_what_the_whole_run_logs(protocol, scene, tmp_path):
    """A run cut after its step-3 checkpoint, its directory holding what
    such a run leaves (the checkpoint and metrics.jsonl up to step 4),
    resumed through the script's ``--resume`` argv, logs every number of the
    uninterrupted 6-step run (the timings aside)."""
    method, argv = cut_argv(protocol, scene, tmp_path / "whole")
    tcli.main([method] + argv + ["--trainer.save_only_latest", "false"], device="cpu")
    whole = tmp_path / "whole" / f"{protocol}-s42" / protocol / method
    cut = tmp_path / "cut" / f"{protocol}-s42" / protocol / method
    cut.mkdir(parents=True)
    shutil.copy(whole / "ckpt_000000003.pt", cut)
    (cut / "metrics.jsonl").write_text("".join(
        json.dumps(m) + "\n" for m in logged(whole) if m["step"] <= 4))

    def resume():
        return subprocess.run(["bash", str(SCRIPT), "--resume", str(cut), "6"], check=True,
                              capture_output=True, text=True).stdout.split()

    extra = resume()
    assert extra == ["--trainer.load_dir", str(cut), "--trainer.max_num_iterations", "3"]
    assert max(m["step"] for m in logged(cut)) == 3
    _, cut_argv_ = cut_argv(protocol, scene, tmp_path / "cut")
    tcli.main([method] + cut_argv_ + extra, device="cpu")

    def numbers(ms):
        return [{k: v for k, v in m.items() if k not in TIMING} for m in ms]

    assert numbers(logged(cut)) == numbers(logged(whole))
    assert resume() == ["done"]
