"""The plain reference (perfbench/reference/nerf.py) against the port's CPU
path at tiny widths: its parts one by one, and whole training steps of both
cells' configurations through the harness (the port's CPU path computes in
f32, as the reference does)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import perfbench_tiny as tiny  # noqa: E402
from perfbench.lib import cell, program  # noqa: E402
from perfbench.reference import nerf as ref  # noqa: E402

CELLS = ("ilf050-train-128k", "hash-train-16k")


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.bench(tiny.write_bench(tmp_path_factory.mktemp("bench")))


def test_hash_encoding_matches_the_port():
    from nerf_kbs_tpu_torch.ops.encoding import HashEncodingConfig, hash_encoding_apply

    cfg = HashEncodingConfig(num_levels=4, features_per_level=2, log2_hashmap_size=8,
                             base_resolution=4, max_resolution=32)
    enc = {"kind": "hash", "levels": 4, "per_level": 2, "log2_T": 8,
           "res": ref.hash_resolutions(4, 4, 32)}
    assert enc["res"] == list(cfg.resolutions)
    g = torch.Generator().manual_seed(0)
    table = torch.empty(2 * 4 * 256).uniform_(-1, 1, generator=g)
    x = torch.rand(300, 3, generator=g) * 1.1 - 0.05  # some points outside [0, 1]
    x[:5] = 1.0  # on the far faces: dense levels reach past their slots
    t1, x1 = table.clone().requires_grad_(), x.clone().requires_grad_()
    t2, x2 = table.clone().requires_grad_(), x.clone().requires_grad_()
    a = hash_encoding_apply(t1, x1, cfg)
    b = ref.hash_encode(t2, x2, enc)
    torch.testing.assert_close(b, a, rtol=1e-6, atol=1e-6)
    w = torch.randn(a.shape, generator=g)
    (a * w).sum().backward()
    (b * w).sum().backward()
    torch.testing.assert_close(t2.grad, t1.grad, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(x2.grad, x1.grad, rtol=1e-5, atol=1e-5)


def test_fourier_field_matches_the_plain_kernels():
    from nerf_kbs_tpu_torch.ops import fused_field as ff
    from nerf_kbs_tpu_torch.ops.contraction import contract_to_unit_cube_t

    g = torch.Generator().manual_seed(1)
    n, H = 500, 6
    x_t = torch.randn(3, n, generator=g) * 2.0
    B = torch.randn(3, H, generator=g) * 4.0
    dims = [2 * H, 16, 16, 1]
    ws = [torch.randn(a, b, generator=g) * 0.3 for a, b in zip(dims, dims[1:])]
    bs = [torch.randn(b, generator=g) * 0.1 for b in dims[1:]]
    want = ff.fourier_mlp_reference(contract_to_unit_cube_t(x_t), B, ws, bs, basis="tri")
    params = {**{f"p/w/{i}": w for i, w in enumerate(ws)},
              **{f"p/b/{i}": b for i, b in enumerate(bs)}}
    enc = {"kind": "fourier", "levels": 2, "per_level": H, "basis": "tri"}
    h = ref.fourier_encode(B, ref.contract(x_t.T), enc, None)
    got = ref.mlp(params, "p", h, 3, ref.Rounding())
    torch.testing.assert_close(got.T, want, rtol=1e-5, atol=1e-5)


def test_rays_match_the_port():
    from nerf_kbs_tpu_torch.cameras.cameras import Cameras, generate_rays

    g = torch.Generator().manual_seed(2)
    c2w = torch.randn(3, 3, 4, generator=g)
    cams = {"fx": torch.tensor([100.0, 120.0, 90.0]), "fy": torch.tensor([101.0, 119.0, 95.0]),
            "cx": torch.tensor([40.0, 41.0, 39.0]), "cy": torch.tensor([12.0, 13.0, 11.0]),
            "c2w": c2w}
    port = Cameras(**cams, width=torch.full((3,), 80), height=torch.full((3,), 24))
    idx = torch.stack([torch.randint(0, 3, (50,), generator=g),
                       torch.randint(0, 24, (50,), generator=g),
                       torch.randint(0, 80, (50,), generator=g)], -1).int()
    a = generate_rays(port, idx)
    b = ref.generate_rays(cams, idx)
    torch.testing.assert_close(b["origins"], a.origins)
    torch.testing.assert_close(b["directions"], a.directions, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(b["directions_norm"], a.directions_norm, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_parameter_trees_match_the_port(bench, name):
    cfg = bench.config(bench.cell(name)["config"])
    prog = program.Program(cfg, tiny.RAYS, 5, "cpu", cache=bench.root / "perfbench" / "cache")
    mine = ref.init_params(cfg["model"], prog.num_images(), 5, torch.device("cpu"))
    port = prog.params()
    assert sorted(mine) == sorted(port)
    for k in mine:
        assert tuple(mine[k].shape) == tuple(port[k].shape), k
    # the frequency matrices scale each level's unit directions by its resolution
    key = next((k for k in mine if k.endswith("fourier_B")), None)
    if key is not None:
        np.testing.assert_allclose(
            torch.linalg.vector_norm(mine[key], dim=0).numpy(),
            torch.linalg.vector_norm(port[key], dim=0).numpy(), rtol=1e-5)


@pytest.mark.parametrize("name", CELLS)
def test_training_steps_match_the_port(bench, name):
    """Three steps of the port's CPU path (f32) against the reference: the
    compared numbers sit at f32's round-off, far under any cell's limit."""
    out = cell.run(bench, name, 2**31 + 7, 0.2, False, "cpu", 0.0)
    assert out["result"]["correct"]
    for k, v in out["checks"].items():
        assert v["value"] < 1e-3, (k, v)


def test_configuration_sections_are_what_the_port_runs():
    """The real configurations' model and optimizer sections equal the
    port's resolved registry entries (``Program._check_config``'s rule,
    without building a trainer)."""
    import dataclasses

    import nerf_kbs_tpu_torch.methods  # noqa: F401
    from nerf_kbs_tpu_torch.engine import cli

    for name in ("nerfacto-tpu-ilf050", "semantic-nerfw-hash"):
        cfg = json.loads((tiny.BENCH_DIR / "configs" / f"{name}.json").read_text())
        over = dict(zip([a.lstrip("-") for a in cfg["argv"][::2]], cfg["argv"][1::2]))
        over = {k: v.replace("{scene}", "scene") for k, v in over.items()}
        spec = cli.apply_overrides(cli.method_registry[cfg["method"]](), over)
        m = spec.model_config("cuda")
        for k, v in cfg["model"].items():
            if k == "num_semantic_classes":
                continue  # set from the scene's labels when the trainer is built
            assert program._same(program._config_value(m, k), v), (name, k)
        for g, opt in cfg["optimizers"].items():
            port = dataclasses.asdict(spec.optimizers[g])
            for k, v in opt.items():
                assert (port[k] is None) if v is None else program._same(port[k], v), (g, k)
