"""bench_torch.py (the port's counterpart of bench.py) against bench.py on the
CPU: the printed keys, the model config, the scene's cameras and rays, and
the train step itself, in f32 on the same converted weights, ray indices,
target colours and jitter. JAX runs its fused Pallas path in interpret mode
(NKT_FUSED=1). The step runs at bench.py's widths on 96 rays."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench
import bench_torch
from nerf_kbs_tpu.cameras.cameras import generate_rays as j_generate_rays
from nerf_kbs_tpu.data.outputs import DataparserOutputs as JOutputs
from nerf_kbs_tpu.data.synthetic import orbit_cameras as j_orbit_cameras
from nerf_kbs_tpu.engine.optimizers import OptimizerConfig as JOptimizerConfig
from nerf_kbs_tpu.engine.optimizers import build_optimizer as j_build_optimizer
from nerf_kbs_tpu.methods import nerfacto_tpu_method as j_method
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu_torch.cameras.cameras import generate_rays as t_generate_rays
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.engine.trainer import mark_trainable
from nerf_kbs_tpu_torch.ops import fused_field as ff

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def two_threads():
    """The benches' CPU products on two threads: the suite's worker
    processes share the host's cores, and with a thread per core each their
    threads wait on each other many times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _j_bench_config(field_type):
    """bench.py:bench_method's config off the TPU (bench.py:62-91)."""
    if field_type == "fourier":
        return dataclasses.replace(j_method().model, num_images=32, compute_dtype="float32",
                                   max_res=64, base_res=4)
    return jnerf.NerfactoConfig(
        num_images=32, field_type=field_type, hidden_dim=64, compute_dtype="float32",
        fourier_basis="sincos", max_res=2048, base_res=16,
        num_proposal_samples_per_ray=(256, 96), interlevel_ray_fraction=1.0)


def _j_bench_cameras():
    return JOutputs([], j_orbit_cameras(32, h=376, w=1241),
                    np.array([[-1.0] * 3, [1.0] * 3])).cameras()


def _jitters(key, rounds, n_rays):
    """What jnerf.forward draws from ``key``: one (R, 1) uniform per sampler
    call, from the key split rounds + 1 ways."""
    return [torch.tensor(np.array(jax.random.uniform(k, (n_rays, 1))))
            for k in jax.random.split(key, rounds + 1)]


def _indices(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, hi, n) for hi in (32, 376, 1241)], -1).astype(np.int32)


def _printed(capsys, main, *args):
    main(*args)
    lines = capsys.readouterr().out.splitlines()
    jsons = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert len(jsons) == 1, lines
    assert all(ln.startswith("#") for ln in lines if not ln.startswith("{")), lines
    return jsons[0], lines


def test_main_prints_bench_py_keys(capsys, monkeypatch):
    """One JSON line with bench.py's keys in bench.py's order (bench.py's
    main run with its benches stubbed), then the render, hash-grid parity
    and device comments; the CPU run's metric is not named per GPU."""
    monkeypatch.setattr(bench, "bench_method", lambda *a, **k: 1.0)
    monkeypatch.setattr(bench, "bench_render", lambda *a, **k: 1.0)
    want, _ = _printed(capsys, bench.main)
    got, lines = _printed(capsys, bench_torch.main, ["--device", "cpu", "--seed", "3"])
    assert list(got) == list(want) == ["metric", "value", "unit", "vs_baseline"]
    assert got["metric"] == "nerfacto_tpu_torch_train_rays_per_sec_cpu"
    assert got["unit"] == want["unit"] and got["value"] > 0
    assert got["vs_baseline"] == round(got["value"] / 5e6, 4)
    assert lines[1].startswith("# eval-render (forward-only, 128-ray chunks): ")
    assert lines[2].startswith("# hash-grid parity path: ")
    assert all(float(ln.split()[-2]) > 0 for ln in lines[1:3])
    assert lines[3].startswith("# device: cpu")


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.main([])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.bench_method("fourier", 8, 1, inner=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.bench_render(8, 1, inner=1)


@pytest.mark.parametrize("field_type", ["fourier", "hash"])
def test_bench_config_is_bench_py_config(field_type):
    got = bench_torch.bench_config(field_type, CPU)
    assert dataclasses.asdict(got) == dataclasses.asdict(_j_bench_config(field_type))
    on_card = bench_torch.bench_config(field_type, torch.device("cuda"))
    assert on_card == dataclasses.replace(got, compute_dtype="bfloat16")


def test_bench_scene_cameras_and_rays_equal_jax():
    jc, tc = _j_bench_cameras(), bench_torch.bench_cameras(CPU)
    for k in ("fx", "fy", "cx", "cy", "c2w", "width", "height"):
        np.testing.assert_array_equal(getattr(tc, k).numpy(), np.asarray(getattr(jc, k)),
                                      err_msg=k)
    idx = _indices(4096, 0)
    jr, tr = j_generate_rays(jc, jnp.asarray(idx)), t_generate_rays(tc, torch.as_tensor(idx))
    for k in ("origins", "directions", "pixel_area", "directions_norm"):
        np.testing.assert_allclose(getattr(tr, k).numpy(), np.asarray(getattr(jr, k)),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_random_ray_indices_cover_the_scene_and_follow_the_seed():
    draw = [bench_torch._random_ray_indices(torch.Generator().manual_seed(s), (3, 4096))
            for s in (5, 5, 6)]
    assert draw[0].shape == (3, 4096, 3) and draw[0].dtype == torch.int32
    assert torch.equal(draw[0], draw[1]) and not torch.equal(draw[0], draw[2])
    lo, hi = draw[0].amin((0, 1)), draw[0].amax((0, 1))
    assert lo.tolist() == [0, 0, 0] and hi.tolist() == [31, 375, 1240]


def test_train_step_matches_jax(monkeypatch):
    """Three bench steps of the port (make_train_step, bench_optimizer)
    against bench.py's scan body rebuilt from the same JAX functions,
    jitted, on JAX's weights converted, f32. The first loss sees only the
    forward and the loss: held to 1e-5 relative. The next two follow Adam
    at 1e-2, whose first update moves each weight by ~lr x sign(g), so they
    and the weights are held as the trainer's steps are
    (tests/test_torch_train_slice.py): 1e-3 relative, 2e-3 absolute."""
    monkeypatch.setenv("NKT_FUSED", "1")
    n = 96
    jcfg, tcfg = _j_bench_config("fourier"), bench_torch.bench_config("fourier", CPU)
    jp = jnerf.init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    mark_trainable(tp)
    group = JOptimizerConfig(lr=1e-2, eps=1e-15)
    joptim = j_build_optimizer({"proposal_networks": group, "fields": group},
                               jnerf.param_groups(jp))
    jstate = joptim.init(jp)
    cameras = _j_bench_cameras()

    @jax.jit
    def j_step(params, opt_state, ray_indices, image, k):
        batch = {"ray_indices": ray_indices, "image": image}
        rays = j_generate_rays(cameras, ray_indices)

        def loss_fn(p):
            out = jnerf.forward(p, jcfg, rays, key=k, step=500.0, train=True)
            return jnerf.loss(jcfg, out, batch, train=True)

        (loss, _), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = joptim.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    t_step = bench_torch.make_train_step(tcfg, tp, bench_torch.bench_optimizer(tp, CPU),
                                         bench_torch.bench_cameras(CPU))
    ff.reset_launches()
    losses = []
    for s in range(3):
        idx = _indices(n, 10 + s)
        image = np.random.default_rng(20 + s).random((n, 3)).astype(np.float32)
        key = jax.random.PRNGKey(30 + s)
        jp, jstate, jloss = j_step(jp, jstate, jnp.asarray(idx), jnp.asarray(image), key)
        tloss = t_step(torch.as_tensor(idx), torch.as_tensor(image),
                       jitters=_jitters(key, jcfg.num_proposal_iterations, n))
        losses.append((float(tloss), float(jloss)))
    np.testing.assert_allclose(*losses[0], rtol=1e-5)
    for got, want in losses[1:]:
        np.testing.assert_allclose(got, want, rtol=1e-3)
    want = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    for t, j in zip(jax.tree.leaves(tp), jax.tree.leaves(want)):
        np.testing.assert_allclose(t.detach().numpy(), j.numpy(), atol=2e-3)
    assert not any(ff.LAUNCHES.values())  # the CPU runs the plain versions


def test_bench_method_and_render_run_on_the_cpu():
    """Both benches end to end on the plain path at a few rays, with
    another seed and inner count than main's: positive finite rates and no
    kernel launch."""
    ff.reset_launches()
    rates = [bench_torch.bench_method("fourier", 32, 1, CPU, inner=1, seed=1),
             bench_torch.bench_render(64, 1, CPU, inner=1, seed=1)]
    assert all(np.isfinite(r) and r > 0 for r in rates), rates
    assert not any(ff.LAUNCHES.values())
