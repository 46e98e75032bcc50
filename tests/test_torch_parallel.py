"""Port vs JAX package, data parallel training (``nerf_kbs_tpu_torch
.parallel``) on the CPU: ``multihost``'s four functions against JAX's, then
two gloo processes started once for the module (``_WORKER``), which run
``cli.main`` under ``NKT_NUM_PROCESSES=2``, ``all_sum_host_values``, two
Adam steps of a nerfacto-tpu-shaped config (the fused path's plain
versions) and of semantic-nerfw with depth, semantics and masks on explicit
global batches and jitters, a rank-strided ``eval_all_images``, a RAFT step,
and counts of the collectives. Both ranks must agree bit for bit, and match
one process on the concatenated batch (loss rtol 1e-5, parameters atol 1e-5,
the first step's reduced gradients 1e-5 of the largest, f32), and the
nerfacto loss matches JAX's on the global batch to the tolerance of
``tests/test_torch_cli.py``'s three-step parity. About 25 s."""

import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerf_kbs_tpu.methods  # noqa: F401  (registers the JAX methods)
from nerf_kbs_tpu.engine import cli as jcli
from nerf_kbs_tpu.engine import trainer as jtrainer_mod
from nerf_kbs_tpu.parallel import multihost as jmultihost
from nerf_kbs_tpu.parallel.mesh import make_mesh as jmake_mesh
from nerf_kbs_tpu.parallel.mesh import shard_batch as jshard_batch
from nerf_kbs_tpu_torch import methods as tmethods  # noqa: F401
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.engine import trainer as ttrainer_mod
from nerf_kbs_tpu_torch.engine.optimizers import tree_copy_, tree_map
from nerf_kbs_tpu_torch.parallel import mesh as tmesh
from nerf_kbs_tpu_torch.parallel import multihost as tmultihost
from nerf_kbs_tpu_torch.process_data import raft_driver as tdriver

REPO = Path(__file__).resolve().parents[1]
H, W = 24, 40
GLOBAL_B = 64
STEPS = 2
TINY = ["--model.hidden_dim", "16", "--model.fourier_num_levels", "2",
        "--model.fourier_features_per_level", "8", "--model.proposal_num_levels", "2",
        "--model.proposal_fourier_features_per_level", "4", "--model.hidden_dim_color", "16",
        "--model.proposal_max_res", "16,32", "--model.num_proposal_samples_per_ray", "16,8",
        "--model.num_nerf_samples_per_ray", "8",
        "--datamanager.train_num_rays_per_batch", str(GLOBAL_B),
        "--datamanager.num_workers", "2", "--trainer.eval_num_rays_per_chunk", "4096"]
# semantic-nerfw on the fused Fourier path (nerfacto-tpu's route)
SEMANTIC_FOURIER = ["--model.field_type", "fourier", "--model.stop_grad_sampling", "true",
                    "--model.interlevel_ray_fraction", "0.5",
                    "--model.appearance_embedding_dim", "0"]
TINY_HASH = ["--model.num_levels", "4", "--model.log2_hashmap_size", "10", "--model.base_res", "4",
             "--model.max_res", "32", "--model.proposal_num_levels", "2",
             "--model.proposal_log2_hashmap_size", "8"]


def _argv(scene, out, method):
    argv = ["--dataparser.data_dir", str(scene), "--dataparser.first_frame", "0",
            "--dataparser.last_frame", "8", "--dataparser.train_split_fraction", "0.75",
            "--dataparser.image_height", str(H), "--dataparser.image_width", str(W),
            "--trainer.output_dir", str(out)] + TINY
    if method == "semantic-nerfw":
        argv += SEMANTIC_FOURIER + [
            "--dataparser.semantics_dir", str(scene / "sem"), "--dataparser.mask_dir",
            str(scene / "mask"), "--dataparser.depth_unit_scale_factor", "1.0"]
    return argv


def _overrides(argv):
    return dict(zip([a[2:] for a in argv[::2]], argv[1::2]))


def _numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


# One rank of the data-parallel runs: argv rank, port, input pickle, output
# pickle. It imports the port only (checked at the end).
_WORKER = r"""
import os, pickle, sys
rank, port, inp, outp = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
os.environ.update(NKT_NUM_PROCESSES="2", RANK=str(rank), MASTER_ADDR="localhost",
                  MASTER_PORT=port)
import numpy as np
import torch
import torch.distributed as dist

from nerf_kbs_tpu_torch import methods  # noqa: F401
from nerf_kbs_tpu_torch.engine import cli
from nerf_kbs_tpu_torch.engine.optimizers import tree_copy_, tree_map
from nerf_kbs_tpu_torch.engine import trainer as trainer_mod
from nerf_kbs_tpu_torch.engine.trainer import Trainer
from nerf_kbs_tpu_torch.parallel import mesh as mesh_mod
from nerf_kbs_tpu_torch.parallel import multihost
from nerf_kbs_tpu_torch.process_data import raft_driver

with open(inp, "rb") as f:
    cfg = pickle.load(f)
out = {"rank": rank}


def numpy(tree):
    return tree_map(lambda t: t.detach().cpu().numpy().copy(), tree)


# every gradient as all_reduce_grads leaves it, before the optimizer's update
# (and before RAFT's clip): one list of leaves per call
grads = []
real_reduce = mesh_mod.all_reduce_grads


def recording_reduce(mesh, params):
    real_reduce(mesh, params)
    grads.append([None if t.grad is None else t.grad.detach().cpu().numpy().copy()
                  for t in mesh_mod._leaves(params)])


trainer_mod.all_reduce_grads = mesh_mod.all_reduce_grads = recording_reduce
calls = {}


def counting(name):
    orig = getattr(dist, name)

    def wrapped(*a, **k):
        calls[name] = calls.get(name, 0) + 1
        return orig(*a, **k)

    return wrapped


for name in ("all_reduce", "broadcast", "all_gather", "reduce_scatter", "all_to_all",
             "all_gather_into_tensor", "reduce_scatter_tensor", "barrier"):
    setattr(dist, name, counting(name))

# 1. cli.main joins the group from the environment; every rank logs the
# global metrics, rank 0 renders alone
built, logged = [], []
orig_build, orig_log = cli.build_trainer, Trainer._log
cli.build_trainer = lambda *a, **k: built.append(orig_build(*a, **k)) or built[-1]
Trainer._log = lambda self, m: (logged.append(dict(m)), orig_log(self, m))[1]
cli.main(cfg["cli_argv"], device="cpu")
cli.build_trainer, Trainer._log = orig_build, orig_log
trainer = built[0]
out["cli"] = {"world": trainer.mesh.world, "batch": trainer.dm.rays_per_batch,
              "losses": [m["total_loss"] for m in logged if "total_loss" in m],
              "eval": [m for m in logged if "eval_all_psnr" in m]}
if rank == 0:
    calls.clear()
    img = trainer.render_camera(0)
    out["render"] = {"finite": bool(np.isfinite(img["rgb"]).all()), "collectives": dict(calls)}

# 2. all_sum_host_values
(s,) = multihost.all_sum_host_values(np.array([1.0 + rank]))
sums = multihost.all_sum_host_values(np.full((2, 3), rank + 1.0), np.array([rank]))
out["all_sum"] = [s.tolist(), [a.tolist() for a in sums]]

# 3. the train steps of both methods on explicit global batches and jitters
n = cfg["global_batch"] // 2
rows = slice(rank * n, (rank + 1) * n)
for name, case in cfg["cases"].items():
    spec = cli.apply_overrides(cli.method_registry[case["method"]](), case["overrides"])
    tr = cli.build_trainer(spec, device="cpu")
    tree_copy_(tr.params, case["start"])
    res = {"batch": tr.dm.config.train_num_rays_per_batch}
    if "eval_before" in case:
        res["eval"] = tr.eval_all_images()
    res["losses"], res["collectives"] = [], []
    grads.clear()
    for step, (batch, jit) in enumerate(zip(case["batches"], case["jitters"])):
        calls.clear()
        m = tr.train_step({k: v[rows] for k, v in batch.items()},
                          jitters=jit and [torch.from_numpy(j[rows]) for j in jit])
        res["collectives"].append(dict(calls))
        res["losses"].append({k: float(v) for k, v in m.items()})
    res["params"] = numpy(tr.params)
    res["grads0"] = grads[0]
    out[name] = res

# 4. RAFT at world size 2: this rank's image pair of the global batch
rcfg = raft_driver.RaftTrainConfig(**cfg["raft"]["config"])
raft, tx = raft_driver.make_raft_train_state(rcfg, device="cpu")
raft.load_state_dict(cfg["raft"]["start"])
step = raft_driver.make_raft_train_step(raft, tx, rcfg, mesh=trainer.mesh)
grads.clear()
loss, metrics = step({k: torch.from_numpy(v[rank:rank + 1]) for k, v in cfg["raft"]["batch"].items()})
out["raft"] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
               "params": {k: v.numpy().copy() for k, v in raft.state_dict().items()},
               "grads0": grads[0]}

out["jax_imported"] = any(m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "nerf_kbs_tpu")
                          for m in sys.modules)
dist.destroy_process_group()
with open(outp, "wb") as f:
    pickle.dump(out, f)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jitters(key, rounds, n_rays):
    return [np.array(jax.random.uniform(k, (n_rays, 1))) for k in jax.random.split(key, rounds + 1)]


def _nchw(a):
    return np.ascontiguousarray(np.moveaxis(a, -1, 1))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the two ranks' outputs, the one-process references): JAX's and the
    port's single-process runs on the global batches, and the inputs every
    rank starts from."""
    tmp = tmp_path_factory.mktemp("parallel")
    scene = tsk.write_dynamic_dataset(tmp / "scene", n_frames=8, h=H, w=W)
    mp = pytest.MonkeyPatch()
    ref = {}
    cases = {}
    try:
        mp.setenv("NKT_FUSED", "1")  # the JAX fused path, Pallas in interpret mode
        mp.setattr(jtrainer_mod, "make_mesh", lambda *a: jmake_mesh(jax.devices()[:1]))
        # nerfacto-tpu: JAX's parameters, batches and jitters, and its losses
        ov = _overrides(_argv(scene, tmp / "jax", "nerfacto-tpu"))
        jt = jcli.build_trainer(jcli.apply_overrides(jcli.method_registry["nerfacto-tpu"](), ov))
        start = jax.tree.map(np.array, jt.params)
        batches, jitters, jlosses = [], [], []
        for step in range(STEPS):
            batches.append({k: np.asarray(v) for k, v in jt.dm.next_train(step).items()})
            key = jax.random.fold_in(jt._base_key, step)
            jitters.append(_jitters(key, 2, GLOBAL_B))
            jt.params, jt.opt_state, jm = jt._train_step(
                jt.params, jt.opt_state, jt.train_cameras, jshard_batch(jt.mesh, batches[-1]),
                key, jnp.asarray(step, jnp.float32))
            jlosses.append(float(jm["total_loss"]))
        ref["jax_losses"] = jlosses
        nerf = {"method": "nerfacto-tpu", "start": start, "batches": batches,
                "overrides": _overrides(_argv(scene, tmp / "w2", "nerfacto-tpu"))}
        cases["nerfacto-tpu"] = dict(nerf, jitters=jitters)
        # the trainer's own jitter: drawn for the global batch, each rank its rows
        cases["nerfacto-tpu/generator"] = dict(nerf, jitters=[None] * STEPS)
    finally:
        mp.undo()
    # semantic-nerfw: the port's seeded parameters, its native draws, seeded jitters
    sem_ov = _overrides(_argv(scene, tmp / "w1", "semantic-nerfw"))
    st = tcli.build_trainer(tcli.apply_overrides(tcli.method_registry["semantic-nerfw"](),
                                                 sem_ov), device="cpu")
    rng = np.random.default_rng(4)
    cases["semantic-nerfw"] = {
        "method": "semantic-nerfw", "overrides": _overrides(_argv(scene, tmp / "w2", "semantic-nerfw")),
        "start": _numpy(st.params), "eval_before": True,
        "batches": [st.dm.next_train(s) for s in range(STEPS)],
        "jitters": [[rng.uniform(size=(GLOBAL_B, 1)).astype(np.float32) for _ in range(3)]
                    for _ in range(STEPS)]}
    raft_cfg = {"iters": 2, "num_steps": 8, "seed": 3}
    rng = np.random.default_rng(6)
    img1 = rng.uniform(0, 1, (2, 32, 40, 3)).astype(np.float32)
    valid = np.stack([rng.uniform(size=(32, 40)) > 0.7, rng.uniform(size=(32, 40)) > 0.1])
    raft_batch = {"img1": _nchw(img1), "img2": _nchw(np.roll(img1, 2, axis=2)),
                  "flow": _nchw(rng.normal(0, 2, (2, 32, 40, 2)).astype(np.float32)),
                  "valid": valid.astype(np.float32)}
    raft, _ = tdriver.make_raft_train_state(tdriver.RaftTrainConfig(**raft_cfg), device="cpu")
    inputs = {
        "global_batch": GLOBAL_B, "cases": cases,
        "cli_argv": ["synthetic-nerfacto", *TINY_HASH, "--model.hidden_dim", "16",
                     "--model.hidden_dim_color", "16", "--model.num_nerf_samples_per_ray", "8",
                     "--model.num_proposal_samples_per_ray", "16,8",
                     "--datamanager.train_num_rays_per_batch", "64",
                     "--trainer.max_num_iterations", "4", "--trainer.log_every", "2",
                     "--trainer.steps_per_eval_batch", "1000", "--trainer.steps_per_eval_image",
                     "1000", "--trainer.steps_per_eval_all_images", "1000",
                     "--trainer.steps_per_save", "1000", "--trainer.eval_num_rays_per_chunk",
                     "4096", "--trainer.output_dir", str(tmp / "cli")],
        "raft": {"config": raft_cfg, "batch": raft_batch,
                 "start": {k: v.clone() for k, v in raft.state_dict().items()}}}
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inputs, f)
    worker = tmp / "worker.py"
    worker.write_text(_WORKER)
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(worker), str(r), port, str(tmp / "in.pkl"),
                               str(tmp / f"out{r}.pkl")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]

    # the one-process references, while the ranks run (their all_reduce_grads
    # is the identity; the recording gives the gradients of the global batch)
    grads = []

    def recording_reduce(mesh, params):
        real_reduce(mesh, params)
        grads.append([None if t.grad is None else t.grad.detach().cpu().numpy().copy()
                      for t in tmesh._leaves(params)])

    real_reduce = tmesh.all_reduce_grads
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer_mod, "all_reduce_grads", recording_reduce)
        mp.setattr(tmesh, "all_reduce_grads", recording_reduce)
        for name, case in cases.items():
            tr = tcli.build_trainer(tcli.apply_overrides(tcli.method_registry[case["method"]](),
                                                         case["overrides"]), device="cpu")
            tree_copy_(tr.params, case["start"])
            res = {"eval": tr.eval_all_images()} if case.get("eval_before") else {}
            res["losses"] = []
            grads.clear()
            for batch, jit in zip(case["batches"], case["jitters"]):
                m = tr.train_step(batch, jitters=jit and [torch.from_numpy(j) for j in jit])
                res["losses"].append({k: float(v) for k, v in m.items()})
            res["params"] = _numpy(tr.params)
            res["grads0"] = grads[0]
            res["start"] = case["start"]
            ref[name] = res
        rcfg = tdriver.RaftTrainConfig(**raft_cfg)
        raft1, tx1 = tdriver.make_raft_train_state(rcfg, device="cpu")
        raft1.load_state_dict(inputs["raft"]["start"])
        step = tdriver.make_raft_train_step(raft1, tx1, rcfg)
        grads.clear()
        loss, metrics = step({k: torch.from_numpy(v) for k, v in raft_batch.items()})
        ref["raft"] = {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
                       "params": {k: v.numpy().copy() for k, v in raft1.state_dict().items()},
                       "grads0": grads[0]}

    logs = []
    for p in procs:
        try:
            log, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(log.decode(errors="replace"))
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"rank failed:\n{log[-6000:]}"
    outs = []
    for r in range(2):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs, ref


def _flat(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [np.asarray(tree)]


# ------------------------------------------------------------ multihost
def test_multihost_matches_jax_at_world_one():
    tinfo, jinfo = tmultihost.initialize(device="cpu"), jmultihost.initialize()
    assert set(tinfo) == set(jinfo)
    assert (tinfo["process_index"], tinfo["process_count"]) == (0, 1) == (
        jinfo["process_index"], jinfo["process_count"])
    assert tinfo["local_devices"] == tinfo["global_devices"] == 1
    assert tmultihost.host_shard_info() == jmultihost.host_shard_info() == (0, 1)
    assert tmultihost.local_batch_slice(64) == jmultihost.local_batch_slice(64) == slice(0, 64)
    a, b = np.arange(3.0), np.ones((2, 2))
    for x, y in zip(tmultihost.all_sum_host_values(a, b), jmultihost.all_sum_host_values(a, b)):
        np.testing.assert_array_equal(x, y)


def test_multihost_rank_one_of_two_matches_jax(monkeypatch):
    """host_shard_info and local_batch_slice as rank 1 of 2 (both packages'
    process queries patched)."""
    monkeypatch.setattr(jax, "process_index", lambda *a: 1)
    monkeypatch.setattr(jax, "process_count", lambda *a: 2)
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 1)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    assert tmultihost.host_shard_info() == jmultihost.host_shard_info() == (1, 2)
    assert tmultihost.local_batch_slice(64) == jmultihost.local_batch_slice(64) == slice(32, 64)
    for mod in (tmultihost, jmultihost):
        with pytest.raises(ValueError, match="not divisible"):
            mod.local_batch_slice(63)


def test_backend_rule(monkeypatch):
    """NCCL only when every rank has a card of its own."""
    assert tmultihost.choose_backend(2, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tmultihost.choose_backend(1) == "nccl"
    assert tmultihost.choose_backend(2) == "gloo"  # two ranks on one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tmultihost.choose_backend(4, "cuda") == "nccl"
    assert tmultihost.choose_backend(4, "cpu") == "gloo"


def test_one_process_mesh_makes_no_collective():
    mesh = tmesh.make_mesh("cpu")
    assert (mesh.rank, mesh.world, mesh.group, mesh.axis_name) == (0, 1, None, "data")
    p = torch.ones(3, requires_grad=True)
    p.grad = torch.full((3,), 2.0)
    tmesh.all_reduce_grads(mesh, {"p": p})
    assert p.grad.tolist() == [2.0] * 3
    assert tmesh.global_rows(8) == (0, 8)
    x = torch.ones(2)
    assert tmesh.batch_sum(x) is x


# ------------------------------------------------------------ two ranks
def test_all_sum_host_values_two_processes(runs):
    outs, _ = runs
    for o in outs:
        assert o["all_sum"][0] == [3.0]
        assert o["all_sum"][1] == [np.full((2, 3), 3.0).tolist(), [1]]


def test_ranks_import_no_jax(runs):
    assert not any(o["jax_imported"] for o in runs[0])


@pytest.mark.parametrize("method", ["nerfacto-tpu", "nerfacto-tpu/generator", "semantic-nerfw"])
def test_world_two_step_matches_one_process(runs, method):
    """Two ranks of half the batch: equal bit for bit, and equal to one
    process on the concatenated batch, with explicit jitters or the
    trainer's own."""
    outs, ref = runs
    r0, r1 = outs[0][method], outs[1][method]
    assert r0["batch"] == r1["batch"] == GLOBAL_B // 2
    assert r0["losses"] == r1["losses"]
    for a, b in zip(_flat(r0["params"]), _flat(r1["params"])):
        np.testing.assert_array_equal(a, b)
    for got, want in zip(r0["losses"], ref[method]["losses"]):
        assert set(got) == set(want)
        for k in want:
            # a masked PSNR is averaged over the ranks as its MSE (parallel.mesh)
            rtol = 1e-3 if (k == "psnr" and method == "semantic-nerfw") else 1e-5
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    for a, b in zip(_flat(r0["params"]), _flat(ref[method]["params"])):
        np.testing.assert_allclose(a, b, atol=1e-5)
    moved = max(float(np.abs(a - s).max())
                for a, s in zip(_flat(ref[method]["params"]), _flat(ref[method]["start"])))
    assert moved > 1e-4  # the steps trained


# the gradients that all_reduce_grads leaves (the world-2 sum / world) against
# one process's on the concatenated batch, relative to the step's largest
# gradient element: a leaf whose exact gradient is zero (a bias under an
# instance norm) holds only rounding, which no relative bound of its own fits
GRAD_RTOL = 1e-5


@pytest.mark.parametrize("method", ["nerfacto-tpu", "nerfacto-tpu/generator", "semantic-nerfw",
                                    "raft"])
def test_world_two_gradient_is_the_global_batch_gradient(runs, method):
    """The first step's reduced gradients, before the update (and before
    RAFT's global-norm clip): the ranks' are equal bit for bit and equal one
    process's gradient of the global batch, not world times or 1 / world of
    it. Adam's update and the clip hide a uniform scale of the gradient, so
    the losses and parameters alone would not show one."""
    outs, ref = runs
    got, other, want = outs[0][method]["grads0"], outs[1][method]["grads0"], ref[method]["grads0"]
    assert len(got) == len(want) == len(other)
    assert [g is None for g in got] == [w is None for w in want] == [o is None for o in other]
    pairs = [(i, g, o, w) for i, (g, o, w) in enumerate(zip(got, other, want)) if w is not None]
    scale = max(float(np.abs(w).max()) for _, _, _, w in pairs)
    assert scale > 0  # the step has a gradient
    for i, g, o, w in pairs:
        np.testing.assert_array_equal(g, o, err_msg=f"leaf {i}")
        err = float(np.abs(g - w).max())
        assert err <= GRAD_RTOL * scale, (
            f"leaf {i} {w.shape}: max err {err}, the step's largest {scale}, ratio of norms "
            f"{np.linalg.norm(g) / max(np.linalg.norm(w), 1e-30)}")


def test_world_two_nerfacto_loss_matches_jax(runs):
    outs, ref = runs
    got = [m["total_loss"] for m in outs[0]["nerfacto-tpu"]["losses"]]
    np.testing.assert_allclose(got, ref["jax_losses"], rtol=2e-3)


def test_collectives_per_step(runs):
    """A nerfacto-tpu step makes the gradient all-reduce (one dtype) and the
    metrics' all-reduce, nothing else; semantic-nerfw adds the masked rgb
    term's (forward and backward) and the depth alignment's two sums (its
    depth carries no gradient with detached sampling); a render makes
    none."""
    outs, _ = runs
    for o in outs:
        assert o["nerfacto-tpu"]["collectives"] == [{"all_reduce": 2}] * STEPS
        assert o["nerfacto-tpu/generator"]["collectives"] == [{"all_reduce": 2}] * STEPS
        assert o["semantic-nerfw"]["collectives"] == [{"all_reduce": 6}] * STEPS
    assert outs[0]["render"] == {"finite": True, "collectives": {}}


def test_rank_strided_eval_matches_one_process(runs):
    outs, ref = runs
    want = ref["semantic-nerfw"]["eval"]
    assert want["num_images"] == 2
    for o in outs:
        got = o["semantic-nerfw"]["eval"]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_cli_main_two_processes(runs):
    """cli.main under NKT_NUM_PROCESSES=2 (synthetic-nerfacto): each rank
    draws half the batch, both log the same global losses and eval."""
    outs, _ = runs
    a, b = outs[0]["cli"], outs[1]["cli"]
    assert a["world"] == b["world"] == 2 and a["batch"] == b["batch"] == 32
    assert len(a["losses"]) == 2 and np.isfinite(a["losses"]).all()
    assert a["losses"] == b["losses"]
    assert a["eval"][0]["eval_all_num_images"] == 2
    drop = ("elapsed_s",)
    assert [{k: v for k, v in m.items() if k not in drop} for m in a["eval"]] == [
        {k: v for k, v in m.items() if k not in drop} for m in b["eval"]]


def test_raft_step_world_two_matches_one_process(runs):
    """Two pairs with different valid counts: the loss's denominator is the
    global count."""
    outs, ref = runs
    assert outs[0]["raft"]["loss"] == outs[1]["raft"]["loss"]
    np.testing.assert_allclose(outs[0]["raft"]["loss"], ref["raft"]["loss"], rtol=1e-5)
    for k, v in ref["raft"]["metrics"].items():
        np.testing.assert_allclose(outs[0]["raft"]["metrics"][k], v, rtol=1e-5, err_msg=k)
    for k, v in ref["raft"]["params"].items():
        np.testing.assert_array_equal(outs[0]["raft"]["params"][k], outs[1]["raft"]["params"][k])
        np.testing.assert_allclose(outs[0]["raft"]["params"][k], v, atol=1e-5, err_msg=k)
