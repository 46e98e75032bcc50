"""The reference operating point at full width, JAX package against the port,
on the CPU in f32: both protocols of ``tools/reference_runs_torch.sh``
(``ilf050``: nerfacto-tpu, 3-layer base MLP, max_res 256, proposals (96,
32); ``sem30k-flagship2``: semantic-nerfw on the tri Fourier field, 2-layer
base MLP (256, 128, 16), depth, semantics and masks) with the model,
optimizers and data configuration that the script's argv resolves to, every
width and sample count kept. Cut: the scene (two 375x1242 frames, one train
and one eval, written by each package's own writer) and the rays (256).

- Both dataparsers and datamanagers turn their own writer's files into the
  same arrays: images, depth, masks, semantic labels, the class list and its
  colours.
- One training step of each protocol at step 5,000 (every level of the
  Fourier window open): the same parameters (JAX ``init``, converted), ray
  indices and jitter, JAX's fused path in interpret mode (``NKT_FUSED=1``);
  every loss term, and every parameter group's gradient.
- The script's runs with other batches (``-d<n>``), and the copy that
  ``tools/emulate_tpu_precision.py`` writes (what it rounds).

Seconds target: 45 s in one process (about 40 s measured, imports aside;
the two writers and the JAX compiles of the two steps take most of it).

The tolerances are f32's own at this width: on three ray draws of each
protocol an f64 run of the port is as far from either package as they are
from each other (``--f64`` below). From f64, JAX and the port hold the
semantics and distortion terms to 3.5e-5, rgb to 1.7e-4, and the two
terms that read a sample picked by the weights' cumulative sums (the
median depth; the interlevel term's outer bounds, over w + 1e-7) to 7.6e-4
and 1.2e-3; each group's gradient to 7.1e-3 in the L2 norm over the
group. So the terms are held to TERM_TOL, about three times the largest
gap seen between the packages, and the groups to 2e-2.

Run as a script, the module trains both packages side by side from the
same start and prints each logged term per step and its ratio, port over
JAX; with ``--f64``, the distances of one step from a port f64 run:

    JAX_PLATFORMS=cpu OMP_NUM_THREADS=4 python tests/test_torch_reference_parity.py \\
        --protocol sem30k-flagship2 --steps 30 --start 0
    JAX_PLATFORMS=cpu python tests/test_torch_reference_parity.py --protocol ilf050 --f64
"""

import argparse
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import nerf_kbs_tpu.methods  # noqa: E402,F401  (registers the JAX methods)
from nerf_kbs_tpu.cameras import cameras as jcam  # noqa: E402
from nerf_kbs_tpu.data import synthetic_kitti as jsk  # noqa: E402
from nerf_kbs_tpu.data.datamanager import InMemoryDataManager as JDataManager  # noqa: E402
from nerf_kbs_tpu.engine import cli as jcli  # noqa: E402
from nerf_kbs_tpu_torch import methods as tmethods  # noqa: E402,F401
from nerf_kbs_tpu_torch.cameras import cameras as tcam  # noqa: E402
from nerf_kbs_tpu_torch.convert import params_from_jax  # noqa: E402
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk  # noqa: E402
from nerf_kbs_tpu_torch.data.datamanager import InMemoryDataManager as TDataManager  # noqa: E402
from nerf_kbs_tpu_torch.engine import cli as tcli  # noqa: E402
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable  # noqa: E402

SCRIPT = REPO / "tools" / "reference_runs_torch.sh"
PROTOCOLS = ("ilf050", "sem30k-flagship2")
RAYS = 256
STEP = 5000  # the protocols' fourier_anneal_steps: every level open
# relative (see the module docstring)
TERM_TOL = {"semantics_loss": 3e-4, "distortion_loss": 3e-4, "rgb_loss": 5e-4,
            "total_loss": 3e-3, "depth_loss": 3e-3, "interlevel_loss": 3e-3, "psnr": 3e-4}
GRAD_TOL = 2e-2
ASSETS = ("images", "depths", "masks", "semantic_labels")


@pytest.fixture(autouse=True)
def fused(monkeypatch):
    monkeypatch.setenv("NKT_FUSED", "1")


def protocol_pairs(protocol: str, scene: Path) -> tuple[str, dict]:
    """(method, override pairs) of the protocol's seed-42 run as the script
    prints it, on ``scene``: two frames split one and one, the rest kept."""
    words = subprocess.run(["bash", str(SCRIPT), "--argv", "O", f"{protocol}-s42"], check=True,
                           capture_output=True, text=True).stdout.split()
    pairs = dict(zip([a[2:] for a in words[2::2]], words[3::2]))
    for k, v in pairs.items():
        if v.startswith("outputs/kitti_syn"):
            pairs[k] = str(scene) + v[len("outputs/kitti_syn"):]
    pairs.update({"dataparser.last_frame": "2", "dataparser.train_split_fraction": "0.5"})
    return words[1], pairs


def build(protocol: str, jscene: Path, tscene: Path) -> dict:
    """Both packages' spec, datamanager and model config of ``protocol``,
    each on its own writer's scene, as the two CLIs' build_trainer make
    them (the card's bf16 aside: f32 on the CPU in both)."""
    method, jpairs = protocol_pairs(protocol, jscene)
    _, tpairs = protocol_pairs(protocol, tscene)
    jspec = jcli.apply_overrides(jcli.method_registry[method](), jpairs)
    tspec = tcli.apply_overrides(tcli.method_registry[method](), tpairs)
    jdm = JDataManager(jspec.dataparser.parse("train"), jspec.dataparser.parse("val"),
                       jspec.datamanager)
    tdm = TDataManager(tspec.dataparser.parse("train"), tspec.dataparser.parse("val"),
                       tspec.datamanager)
    jcfg = dataclasses.replace(jspec.model, num_images=len(jdm.train_cameras))
    tcfg = dataclasses.replace(tspec.model_config("cpu"),
                               num_images=len(tdm.train_outputs.cameras_np["fx"]))
    if jcfg.use_semantic:
        jcfg = dataclasses.replace(jcfg, num_semantic_classes=len(jdm.semantics.classes))
        tcfg = dataclasses.replace(tcfg, num_semantic_classes=len(tdm.semantics.classes))
    assert jcfg.compute_dtype == tcfg.compute_dtype == "float32"
    return {"method": method, "jspec": jspec, "tspec": tspec, "jdm": jdm, "tdm": tdm,
            "jcfg": jcfg, "tcfg": tcfg, "jmod": jcli._model_module(jspec.model_name),
            "tmod": tcli._model_module(tspec.model_name)}


def init_params(b: dict):
    """JAX init (seed 42, the runs' trainer seed), and the port's copy."""
    jp = jax.jit(b["jmod"].init, static_argnums=1)(jax.random.PRNGKey(42), b["jcfg"])
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    return jp, tp


def jitters(key, b: dict, n: int) -> list:
    """What the JAX forward draws from ``key``: one (n, 1) uniform per
    sampler call."""
    return [torch.tensor(np.array(jax.random.uniform(k, (n, 1))))
            for k in jax.random.split(key, b["jcfg"].num_proposal_iterations + 1)]


def jax_step_fn(b: dict):
    """jax.value_and_grad of the protocol's loss over (params, batch, key,
    step), jitted."""
    jmod, jcfg, cams = b["jmod"], b["jcfg"], b["jdm"].train_cameras

    def loss_fn(p, batch, key, step):
        rays = jcam.generate_rays(cams, batch["ray_indices"])
        out = jmod.forward(p, jcfg, rays, key=key, step=step, train=True)
        return jmod.loss(jcfg, out, batch, train=True)

    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))


def port_loss(b: dict, tp: dict, cams, batch: dict, jit: list, step: int):
    rays = tcam.generate_rays(cams, torch.as_tensor(batch["ray_indices"]))
    out = b["tmod"].forward(tp, b["tcfg"], rays, step=step, train=True, jitters=jit)
    return b["tmod"].loss(b["tcfg"], out, {k: torch.as_tensor(v) for k, v in batch.items()},
                          train=True)


def gather(assets: dict, idx: np.ndarray) -> dict:
    """The batch of ray indices ``idx`` as the datamanagers build it."""
    cam, row, col = idx.T
    batch = {"ray_indices": idx,
             "image": assets["images"][cam, row, col].astype(np.float32) / 255.0}
    if "depths" in assets:
        batch["depth_image"] = assets["depths"][cam, row, col][:, None].astype(np.float32)
    if "masks" in assets:
        batch["mask"] = assets["masks"][cam, row, col][:, None].astype(np.float32)
    if "semantic_labels" in assets:
        batch["semantics_label"] = assets["semantic_labels"][cam, row, col]
    return batch


def write_scenes(root: Path) -> tuple[Path, Path]:
    """Two frames of the reference scene's layout at the full 375x1242,
    under ``root``/jax and ``root``/port by each package's writer (kept
    where they are already written)."""
    if not (root / "port" / "semantics_list.txt").is_file():
        jsk.write_dataset(root / "jax", n_frames=2, h=375, w=1242)
        tsk.write_dataset(root / "port", n_frames=2, h=375, w=1242)
    return root / "jax", root / "port"


def draw(b: dict, seed: int) -> np.ndarray:
    """RAYS uniform (camera, row, col) indices of the train split."""
    rng = np.random.default_rng(seed)
    n, h, w = b["jdm"].train_assets["images"].shape[:3]
    return np.stack([rng.integers(0, n, RAYS), rng.integers(0, h, RAYS),
                     rng.integers(0, w, RAYS)], -1).astype(np.int32)


def flat(tp: dict, g: str, tree=None) -> torch.Tensor:
    """Group ``g``'s gradient as one f64 vector: the ``.grad`` of the
    trainable leaves of ``tp`` or, given ``tree`` (a tree like ``tp``), its
    leaves at those places. The frozen Fourier matrices get no gradient."""
    out = []
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp[g]),
                            jax.tree.leaves(tree[g] if tree is not None else tp[g])):
        if not t.requires_grad:
            assert t.grad is None, (g, path)
            continue
        assert t.grad is not None, (g, path)
        out.append((t.grad if tree is None else j).reshape(-1).double())
    return torch.cat(out)


def rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got - ref).norm() / ref.norm())


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    return write_scenes(tmp_path_factory.mktemp("reference_scene"))


@pytest.fixture(scope="module")
def built(scenes):
    return {p: build(p, *scenes) for p in PROTOCOLS}


def test_dataparsers_label_the_full_size_scene_alike(built):
    """Each package reads its own writer's 375x1242 files into the same
    train and eval arrays (the semantic PNGs through the class list's
    colours, nearest in L1), with the same four classes and colours."""
    b = built["sem30k-flagship2"]
    jdm, tdm = b["jdm"], b["tdm"]
    for split in ("train_assets", "eval_assets"):
        ja, ta = getattr(jdm, split), getattr(tdm, split)
        assert set(ja) == set(ta) == set(ASSETS)
        for k in ASSETS:
            assert ja[k].dtype == ta[k].dtype and np.array_equal(ja[k], ta[k]), (split, k)
    labels = jdm.train_assets["semantic_labels"]
    assert labels.shape == (1, 375, 1242)
    assert set(np.unique(labels)) == {0, 1, 2, 3}  # road, building, car and sky all present
    assert list(jdm.semantics.classes) == list(tdm.semantics.classes) == jsk.SEMANTIC_CLASSES
    np.testing.assert_array_equal(np.asarray(jdm.semantics.colors),
                                  np.asarray(tdm.semantics.colors))
    assert b["jcfg"].num_semantic_classes == b["tcfg"].num_semantic_classes == 4
    # ilf050 reads images and depth only
    assert set(built["ilf050"]["tdm"].train_assets) == {"images", "depths"}


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_script_runs_draw_other_batches_by_name(protocol):
    """A run named <protocol>-s42-d<n> is the seed-42 run in its own
    directory with --datamanager.seed n after it (the batch seed; the JAX
    runs drew at 0), which both CLIs resolve alike."""
    def argv(run):
        return subprocess.run(["bash", str(SCRIPT), "--argv", "O", run], check=True,
                              capture_output=True, text=True).stdout.split()

    base, seeded = argv(f"{protocol}-s42"), argv(f"{protocol}-s42-d2")
    assert seeded == [w.replace(f"O/{protocol}-s42", f"O/{protocol}-s42-d2") for w in base] + [
        "--datamanager.seed", "2"]
    pairs = dict(zip([a[2:] for a in seeded[2::2]], seeded[3::2]))
    for cli in (jcli, tcli):
        spec = cli.apply_overrides(cli.method_registry[seeded[1]](), pairs)
        assert (spec.datamanager.seed, spec.trainer.seed) == (2, 42)


EMULATION_CHECK = """
import sys, torch
sys.path.insert(0, sys.argv[1])
from nerf_kbs_tpu_torch.models import nerfacto
from nerf_kbs_tpu_torch.ops import fused_field as ff
assert nerfacto.__file__.startswith(sys.argv[1]), nerfacto.__file__
r = lambda t: t.detach().to(torch.bfloat16).to(torch.float32)
g = torch.Generator().manual_seed(0)
w = torch.rand(5, 7, generator=g, requires_grad=True)
v = torch.randn(3, 5, 7, generator=g, requires_grad=True)
cot = torch.randn(5, 3, generator=g)
nerfacto._TpuEinsum.apply("rs,drs->rd", w, v).backward(cot)
w2, v2 = r(w).requires_grad_(), r(v).requires_grad_()
out = torch.einsum("rs,drs->rd", w2, v2)
out.backward(r(cot))
assert torch.equal(nerfacto._TpuEinsum.apply("rs,drs->rd", w, v), out)
assert torch.equal(w.grad, w2.grad) and torch.equal(v.grad, v2.grad)
x, B = torch.rand(3, 9, generator=g), 100 * torch.randn(3, 4, generator=g)
spec = ff.FusedMLPSpec(h_freqs=4, layer_dims=(8, 2), bf16=False, basis="tri")
ws, bs = [torch.randn(8, 2, generator=g)], [torch.zeros(2)]
assert torch.equal(ff._mlp_forward(spec, x, B, ws, bs),
                   ff.fourier_mlp_reference(r(x), r(B), ws, bs, "tri"))
print("ok")
"""


def test_tpu_precision_copy_rounds_what_it_names(tmp_path):
    """tools/emulate_tpu_precision.py finds every anchor in today's port,
    and its copy rounds the composites (forward and both transposed
    products) and the fused wrappers' projection operands to bf16."""
    dest = tmp_path / "emul"
    subprocess.run([sys.executable, str(REPO / "tools" / "emulate_tpu_precision.py"), str(dest)],
                   check=True, capture_output=True)
    assert not (dest / "outputs").exists() and (dest / "train_torch.py").is_file()
    out = subprocess.run([sys.executable, "-c", EMULATION_CHECK, str(dest)], check=True,
                         capture_output=True, text=True)
    assert out.stdout.strip() == "ok"


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_one_full_width_step_matches_jax(built, protocol):
    """One training step at full width: each loss term to TERM_TOL, each
    parameter group's gradient to GRAD_TOL in the L2 norm; the groups are
    the protocol's optimizer groups."""
    b = built[protocol]
    jp, tp = init_params(b)
    idx = draw(b, 5)
    jbatch, tbatch = gather(b["jdm"].train_assets, idx), gather(b["tdm"].train_assets, idx)
    key = jax.random.PRNGKey(7)
    (jtotal, jterms), jgrads = jax_step_fn(b)(
        jp, {k: jnp.asarray(v) for k, v in jbatch.items()}, key, jnp.float32(STEP))
    total, terms = port_loss(b, tp, b["tdm"].train_outputs.cameras("cpu"), tbatch,
                             jitters(key, b, RAYS), STEP)
    assert set(terms) == set(jterms)
    want = {"rgb_loss", "interlevel_loss", "distortion_loss"} | (
        {"depth_loss", "semantics_loss"} if protocol == "sem30k-flagship2" else set())
    assert want <= set(terms)
    terms = {**terms, "total_loss": total}
    jterms = {**jterms, "total_loss": jtotal}
    for k in terms:
        got, ref = float(terms[k].detach()), float(jterms[k])
        assert abs(got - ref) <= TERM_TOL[k] * abs(ref), (k, got, ref)
    total.backward()
    jg = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
    groups = b["tmod"].param_groups(tp)
    assert set(groups) == set(b["tspec"].optimizers) & set(tp)
    for g in groups:
        frozen = [j for (_, t), j in zip(jax.tree_util.tree_leaves_with_path(tp[g]),
                                         jax.tree.leaves(jg[g])) if not t.requires_grad]
        assert not any(j.any() for j in frozen), g
        d = rel(flat(tp, g), flat(tp, g, jg))
        assert d <= GRAD_TOL, (g, d)


def f64_report(protocol: str, scene_root: Path, seeds=(5, 6, 7)) -> None:
    """One step of ``protocol`` per ray draw, as the test takes it, in JAX
    (f32), the port (f32) and the port in f64: each term's and each
    gradient group's relative distance JAX-port, JAX-f64 and port-f64."""
    from nerf_kbs_tpu_torch.cameras.cameras import Cameras
    from nerf_kbs_tpu_torch.engine.optimizers import tree_leaves

    b = build(protocol, *write_scenes(scene_root))
    jp, _ = init_params(b)
    step_fn = jax_step_fn(b)
    cams = b["tdm"].train_outputs.cameras("cpu")
    cams64 = Cameras(**{f.name: v.double() if v is not None and v.is_floating_point() else v
                        for f in dataclasses.fields(cams) for v in [getattr(cams, f.name)]})
    for seed in seeds:
        idx = draw(b, seed)
        jbatch, tbatch = gather(b["jdm"].train_assets, idx), gather(b["tdm"].train_assets, idx)
        key = jax.random.PRNGKey(7)
        (jtotal, jterms), jgrads = step_fn(jp, {k: jnp.asarray(v) for k, v in jbatch.items()},
                                          key, jnp.float32(STEP))
        jg = params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu")
        jit = jitters(key, b, RAYS)
        runs = {}
        for dtype in ("f32", "f64"):
            tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
            batch, c, jt = tbatch, cams, jit
            if dtype == "f64":
                for t in tree_leaves(tp):
                    t.data = t.data.double()
                batch = {k: v.astype(np.float64) if v.dtype == np.float32 else v
                         for k, v in tbatch.items()}
                c, jt = cams64, [j.double() for j in jit]
            mark_trainable(tp)
            total, terms = port_loss(b, tp, c, batch, jt, STEP)
            total.backward()
            runs[dtype] = (tp, {**{k: float(v.detach()) for k, v in terms.items()},
                                "total_loss": float(total.detach())})
        (tp32, t32), (tp64, t64) = runs["f32"], runs["f64"]
        j32 = {**{k: float(v) for k, v in jterms.items()}, "total_loss": float(jtotal)}
        print(protocol, "draw", seed)
        for k in sorted(t32):
            print(f"  {k:16s} JAX-port {abs(t32[k] - j32[k]) / abs(t64[k]):.1e}"
                  f"  JAX-f64 {abs(j32[k] - t64[k]) / abs(t64[k]):.1e}"
                  f"  port-f64 {abs(t32[k] - t64[k]) / abs(t64[k]):.1e}")
        for g in b["tmod"].param_groups(tp32):
            port, ref, f64 = flat(tp32, g), flat(tp32, g, jg), flat(tp64, g)
            print(f"  grad {g:16s} JAX-port {rel(port, ref):.1e}  JAX-f64 {rel(ref, f64):.1e}"
                  f"  port-f64 {rel(port, f64):.1e}")


def drift(protocol: str, steps: int, start: int, scene_root: Path) -> None:
    """Train both packages from the same start for ``steps`` steps, from
    step ``start`` (the schedules' step), on the same batches (both host
    samplers, 256 rays) and jitter (JAX's keys: fold_in(PRNGKey(43), step));
    print each logged term of both and the ratio port / JAX, then each
    parameter's relative distance at the end."""
    import optax

    from nerf_kbs_tpu.engine.optimizers import build_optimizer as jbuild
    from nerf_kbs_tpu_torch.engine.optimizers import build_optimizer as tbuild

    b = build(protocol, *write_scenes(scene_root))
    for dm in (b["jdm"], b["tdm"]):
        dm.config = dataclasses.replace(dm.config, train_num_rays_per_batch=RAYS)
    jp, tp = init_params(b)
    jopt = jbuild(b["jspec"].optimizers, b["jmod"].param_groups(jp))
    jstate = jopt.init(jp)
    topt = tbuild(b["tspec"].optimizers, b["tmod"].param_groups(tp), device="cpu")
    value_and_grad = jax_step_fn(b)

    @jax.jit
    def jstep(p, st, batch, key, step):
        (_, m), g = value_and_grad(p, batch, key, step)
        updates, st = jopt.update(g, st, p)
        return optax.apply_updates(p, updates), st, m

    tcams = b["tdm"].train_outputs.cameras("cpu")
    base = jax.random.PRNGKey(43)
    for step in range(start, start + steps):
        jbatch, tbatch = b["jdm"].next_train(step), b["tdm"].next_train(step)
        assert all(np.array_equal(jbatch[k], tbatch[k]) for k in jbatch)
        key = jax.random.fold_in(base, step)
        jp, jstate, jm = jstep(jp, jstate, {k: jnp.asarray(v) for k, v in jbatch.items()}, key,
                               jnp.float32(step))
        total, tm = port_loss(b, tp, tcams, tbatch, jitters(key, b, RAYS), step)
        topt.zero_grad()
        total.backward()
        topt.step()
        print(step, "  ".join(
            f"{k} {float(jm[k]):.6g} / {float(tm[k]):.6g} "
            f"({float(tm[k]) / float(jm[k]) if float(jm[k]) else float('nan'):.4f})"
            for k in sorted(jm) if k != "psnr"), flush=True)
    jend = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for (path, t), j in zip(jax.tree_util.tree_leaves_with_path(tp), jax.tree.leaves(jend)):
        if j.any():
            print("param", jax.tree_util.keystr(path),
                  f"{float((t.detach() - j).norm() / j.norm()):.3e}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=drift.__doc__)
    ap.add_argument("--protocol", choices=PROTOCOLS, default="sem30k-flagship2")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--f64", action="store_true", help="f64_report instead of the drift")
    ap.add_argument("--scene", default=None, help="where the two scenes are (written if absent)")
    args = ap.parse_args()
    os.environ["NKT_FUSED"] = "1"
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        root = Path(args.scene or tmp)
        if args.f64:
            f64_report(args.protocol, root)
        else:
            drift(args.protocol, args.steps, args.start, root)
