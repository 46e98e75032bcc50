"""Port vs JAX package: nerfacto eval forward, the chunked renderer and the
viewer, on the CPU in f32; plus the port's import isolation and its
no-fallback device rule. JAX runs its fused Pallas path in interpret mode
(NKT_FUSED=1)."""

import dataclasses
import json
import subprocess
import sys
import urllib.error
import urllib.request
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.cameras import cameras as jcam
from nerf_kbs_tpu.data.outputs import DataparserOutputs as JOutputs
from nerf_kbs_tpu.methods import nerfacto_tpu_method as j_method
from nerf_kbs_tpu.models import nerfacto as jnerf
from nerf_kbs_tpu_torch.cameras import cameras as tcam
from nerf_kbs_tpu_torch.convert import params_from_jax
from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs as TOutputs
from nerf_kbs_tpu_torch.data.synthetic import orbit_cameras
from nerf_kbs_tpu_torch.engine.render import Renderer, render_trajectory
from nerf_kbs_tpu_torch.engine.viewer import ViewerServer
from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method as t_method
from nerf_kbs_tpu_torch.models import nerfacto as tnerf

REPO = Path(__file__).resolve().parents[1]
# composited outputs in f32: same math, other summation orders
ATOL = 1e-4
OUT_KEYS = ("rgb", "accumulation", "depth", "expected_depth", "prop_depth_0",
            "prop_depth_1", "weights", "directions_norm")

SMALL = dict(
    num_images=3, field_type="fourier", fourier_num_levels=2, fourier_features_per_level=8,
    proposal_fourier_features_per_level=4, proposal_num_levels=2, hidden_dim=16,
    hidden_dim_color=16, base_res=4, max_res=32, proposal_max_res=(16, 32),
    num_proposal_samples_per_ray=(16, 8), num_nerf_samples_per_ray=8,
)


@pytest.fixture
def fused(monkeypatch):
    monkeypatch.setenv("NKT_FUSED", "1")


def _pair(**kw):
    return jnerf.NerfactoConfig(**kw), tnerf.NerfactoConfig(**kw)


def _params(jcfg):
    jp = jnerf.init(jax.random.PRNGKey(0), jcfg)
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o = (rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    cam = rng.integers(0, 3, (n, 1)).astype(np.int32)
    kw = dict(pixel_area=np.full((n, 1), 1e-4, np.float32), directions_norm=np.ones((n, 1),
              np.float32))
    jr = jcam.RayBundle(origins=jnp.asarray(o), directions=jnp.asarray(d),
                        camera_indices=jnp.asarray(cam),
                        **{k: jnp.asarray(v) for k, v in kw.items()})
    tr = tcam.RayBundle(origins=torch.as_tensor(o), directions=torch.as_tensor(d),
                        camera_indices=torch.as_tensor(cam),
                        **{k: torch.as_tensor(v) for k, v in kw.items()})
    return jr, tr


def _compare(tout, jout, keys=OUT_KEYS):
    for k in keys:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), atol=ATOL, rtol=1e-4,
                                   err_msg=k)


@pytest.mark.parametrize("basis,background,app_dim", [
    ("tri", "last_sample", 0), ("sincos", "white", 4), ("tri", "black", 0),
])
def test_forward_small_matches_jax(fused, basis, background, app_dim):
    jcfg, tcfg = _pair(**SMALL, fourier_basis=basis, background_color=background,
                       appearance_embedding_dim=app_dim)
    jp, tp = _params(jcfg)
    jr, tr = _rays(24)
    jout = jnerf.forward(jp, jcfg, jr, key=None, step=1200, train=False)
    tout = tnerf.forward(tp, tcfg, tr, step=1200, train=False)
    _compare(tout, jout)


def test_forward_full_width_matches_jax(fused):
    """nerfacto-tpu at its full widths (H = 128, base (256, 128, 128, 16),
    rgb (31, 64, 64, 3), proposals H = 40, (96, 32) -> 48 samples), f32."""
    jcfg = j_method().model
    tcfg = t_method().model
    assert tcfg == tnerf.NerfactoConfig(**{f.name: getattr(jcfg, f.name)
                                          for f in dataclasses.fields(tcfg)})
    jp, tp = _params(jcfg)
    assert [tuple(w.shape) for w in tp["fields"]["base_mlp"]["w"]] == [
        (256, 128), (128, 128), (128, 16)]
    assert [tuple(w.shape) for w in tp["fields"]["rgb_mlp"]["w"]] == [(31, 64), (64, 64), (64, 3)]
    assert tuple(tp["proposal_networks"][0]["fourier_B"].shape) == (3, 40)
    jr, tr = _rays(16, seed=1)
    jout = jnerf.forward(jp, jcfg, jr, key=None, step=30000, train=False)
    tout = tnerf.forward(tp, tcfg, tr, step=30000, train=False)
    assert tout["weights"].shape == (16, 48)
    _compare(tout, jout)


def test_method_config_bf16_and_chunk():
    spec = t_method()
    assert spec.trainer.eval_num_rays_per_chunk == 1 << 15
    assert spec.model_config().compute_dtype == "bfloat16"
    assert spec.model_config().field.base_mlp.dims == (256, 128, 128, 16)
    assert spec.model_config().field.rgb_mlp.dims == (31, 64, 64, 3)
    assert spec.model_config().proposal_field(0).mlp.dims == (80, 16, 1)


def test_render_camera_matches_jax_forward(fused):
    jcfg, tcfg = _pair(**SMALL)
    jp, tp = _params(jcfg)
    cams_np = orbit_cameras(3, h=12, w=16)
    box = np.array([[-1.0] * 3, [1.0] * 3])
    jc = JOutputs([], cams_np, box).cameras()
    idx = np.stack(np.meshgrid([1], np.arange(12), np.arange(16), indexing="ij"),
                   -1).reshape(-1, 3).astype(np.int32)
    jout = jnerf.forward(jp, jcfg, jcam.generate_rays(jc, jnp.asarray(idx)), key=None,
                         step=700, train=False)
    # 192 pixels in chunks of 50: the last chunk is padded
    r = Renderer(tp, tcfg, TOutputs([], cams_np, box).cameras("cpu"), step=700,
                 eval_num_rays_per_chunk=50, device="cpu")
    out = r.render_camera(1)
    for k in ("rgb", "depth", "expected_depth", "accumulation", "directions_norm"):
        want = np.asarray(jout[k]).reshape(12, 16, -1)
        assert out[k].shape == want.shape, k
        np.testing.assert_allclose(out[k], want, atol=ATOL, rtol=1e-4, err_msg=k)


def _small_renderer():
    cfg = tnerf.NerfactoConfig(**SMALL)
    cams = TOutputs([], orbit_cameras(2, h=6, w=8), np.zeros((2, 3))).cameras("cpu")
    return Renderer(tnerf.init(cfg, seed=0, device="cpu"), cfg, cams, step=100,
                    eval_num_rays_per_chunk=32, device="cpu")


def test_viewer_serves_pngs():
    viewer = ViewerServer(_small_renderer(), port=0).start()
    base = f"http://127.0.0.1:{viewer.port}"
    try:
        for path in ("/render?cam=1", "/render?cam=0&kind=depth", "/orbit?theta=0.5&size=8"):
            with urllib.request.urlopen(base + path, timeout=60) as resp:
                assert resp.headers["Content-Type"] == "image/png"
                assert resp.read()[:8] == b"\x89PNG\r\n\x1a\n"
        with urllib.request.urlopen(base + "/status", timeout=60) as resp:
            assert json.loads(resp.read())["num_cameras"] == 2
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(base + "/render?cam=7", timeout=60)
        assert e.value.code == 400
        e.value.close()
    finally:
        viewer.close()


def test_render_trajectory_writes_frames(tmp_path):
    paths = render_trajectory(_small_renderer(), str(tmp_path), frames_per_segment=2)
    assert len(paths) == 3
    assert (tmp_path / "depth_00002.png").read_bytes()[:4] == b"\x89PNG"


def test_port_imports_no_jax():
    code = (
        "import sys, nerf_kbs_tpu_torch\n"
        "import nerf_kbs_tpu_torch.engine.viewer, nerf_kbs_tpu_torch.convert\n"
        "import nerf_kbs_tpu_torch.methods, nerf_kbs_tpu_torch.ops._kernels\n"
        "import nerf_kbs_tpu_torch.engine.trainer, nerf_kbs_tpu_torch.ops.losses\n"
        "import nerf_kbs_tpu_torch.engine.cli, nerf_kbs_tpu_torch.models.semantic_nerfw\n"
        "import nerf_kbs_tpu_torch.data.datamanager, nerf_kbs_tpu_torch.data.synthetic_kitti\n"
        "import nerf_kbs_tpu_torch.data.dataparsers.kitti, nerf_kbs_tpu_torch.cameras.poses\n"
        "import nerf_kbs_tpu_torch.ops.metrics, nerf_kbs_tpu_torch.utils.images\n"
        "import nerf_kbs_tpu_torch.data.stream, nerf_kbs_tpu_torch.cameras.transforms\n"
        "import nerf_kbs_tpu_torch.data.dataparsers.suds_metadata\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'nerf_kbs_tpu', 'PIL', 'cv2')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tnerf.NerfactoConfig(**SMALL)
    cams_np = orbit_cameras(2, h=4, w=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tnerf.init(cfg, seed=0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TOutputs([], cams_np, np.zeros((2, 3))).cameras()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": np.zeros(2)})
    cams = TOutputs([], cams_np, np.zeros((2, 3))).cameras("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Renderer(tnerf.init(cfg, seed=0, device="cpu"), cfg, cams)


def _png_depth_datamanager(tmp_path):
    """A datamanager given a 16-bit PNG depth file, and the JAX loader's
    reading of the same file (OpenCV): the depths must be equal."""
    from nerf_kbs_tpu.data.datamanager import _load_depth as j_load_depth
    from nerf_kbs_tpu_torch.data.datamanager import InMemoryDataManager
    from nerf_kbs_tpu_torch.utils.images import encode_png_u8, encode_png_u16

    (tmp_path / "f.png").write_bytes(encode_png_u8(np.zeros((2, 2, 3), np.uint8)))
    depth = np.array([[0, 1], [1234, 65535]], np.uint16)
    (tmp_path / "000000.png").write_bytes(encode_png_u16(depth))
    out = TOutputs([str(tmp_path / "f.png")], orbit_cameras(1, h=2, w=2), np.zeros((2, 3)),
                   depth_filenames=[str(tmp_path / "000000.png")], depth_unit_scale_factor=0.01)
    got = InMemoryDataManager(out, out).train_assets["depths"][0]
    np.testing.assert_array_equal(got, j_load_depth(str(tmp_path / "000000.png"), 0.01))


# settings ported since the cases were written: each case now runs the eval
# forward on the non-fused path and matches JAX (or, for the others, the
# transient training forward, the PNG depth loader, the camera optimizer's
# rays and fused forward, and the flow and sky terms, against their JAX
# counterparts)
PORTED = ("field_type", "predict_normals", "disable_scene_contraction",
          "use_transient_embedding", "16-bit PNG depth", "camera_optimizer", "flow_loss_mult",
          "sky_loss_mult")


def _flow_sky_batch(n, seed=6):
    """Stream-like supervision rows: rgb, the forward neighbour's w2c and
    intrinsics, the source pixel, a stored flow with its validity, sky."""
    rng = np.random.default_rng(seed)
    w2c = np.tile(np.eye(3, 4, dtype=np.float32), (n, 1, 1))
    w2c[:, :, 3] = rng.normal(size=(n, 3)).astype(np.float32) * 0.05 + [0.0, 0.0, -2.0]
    return {"image": rng.random((n, 3)).astype(np.float32),
            "fwd_w2c": w2c,
            "fwd_K": np.tile(np.array([[20.0, 20.0, 8.0, 6.0]], np.float32), (n, 1)),
            "pixel_xy": rng.uniform(0, 16, (n, 2)).astype(np.float32),
            "forward_flow": rng.normal(size=(n, 2)).astype(np.float32),
            "flow_valid": (rng.random((n, 1)) > 0.3).astype(np.float32),
            "sky": (rng.random((n, 1)) > 0.5).astype(np.float32)}


def _ported_training_case(name):
    """The camera optimizer (fused path: rays through camera_deltas of
    non-zero tangents, the eval forward) or the flow / sky terms (the
    training forward and loss on a stream-like batch), against JAX."""
    change = {"camera_optimizer": dict(camera_optimizer="SO3xR3"),
              "flow_loss_mult": dict(flow_loss_mult=0.001),
              "sky_loss_mult": dict(sky_loss_mult=0.1)}[name]
    jcfg, tcfg = _pair(**{**SMALL, **change})
    jp, tp = _params(jcfg)
    if name == "camera_optimizer":
        assert tnerf.uses_fused_path(tcfg) and tuple(tp["camera_opt"].shape) == (3, 6)
        tang = np.random.default_rng(3).normal(size=(3, 6)).astype(np.float32) * 0.05
        jp["camera_opt"], tp["camera_opt"] = jnp.asarray(tang), torch.as_tensor(tang)
        cams_np = orbit_cameras(3, h=6, w=8)
        box = np.array([[-1.0] * 3, [1.0] * 3])
        idx = np.stack(np.meshgrid([2], np.arange(6), np.arange(8), indexing="ij"),
                       -1).reshape(-1, 3).astype(np.int32)
        jr = jcam.generate_rays(JOutputs([], cams_np, box).cameras(), jnp.asarray(idx),
                                c2w_delta=jnerf.camera_deltas(jp))
        tr = tcam.generate_rays(TOutputs([], cams_np, box).cameras("cpu"), torch.as_tensor(idx),
                                c2w_delta=tnerf.camera_deltas(tp))
        jout = jax.jit(lambda p, r: jnerf.forward(p, jcfg, r, key=None, step=900,
                                                  train=False))(jp, jr)
        with torch.no_grad():
            tout = tnerf.forward(tp, tcfg, tr, step=900, train=False)
        _compare(tout, jout)
        return
    n = 16
    jr, tr = _rays(n, seed=2)
    batch = _flow_sky_batch(n)
    key = jax.random.PRNGKey(1)
    jtotal, jm = jax.jit(lambda p: jnerf.loss(
        jcfg, jnerf.forward(p, jcfg, jr, key=key, step=900, train=True),
        {k: jnp.asarray(v) for k, v in batch.items()}))(jp)
    with torch.no_grad():
        tout = tnerf.forward(tp, tcfg, tr, step=900, train=True, jitters=[
            torch.tensor(np.array(jax.random.uniform(k, (n, 1))))
            for k in jax.random.split(key, 3)])
        ttotal, tm = tnerf.loss(tcfg, tout, {k: torch.as_tensor(v) for k, v in batch.items()})
    term = {"flow_loss_mult": "flow_loss", "sky_loss_mult": "sky_loss"}[name]
    assert set(tm) == set(jm) and term in tm
    for k in tm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-4)


TINY_GRIDS = dict(num_levels=4, log2_hashmap_size=10, proposal_num_levels=2,
                  proposal_log2_hashmap_size=8)


@pytest.mark.parametrize("change,name", [
    (dict(field_type="hash", **TINY_GRIDS), "field_type"),
    (dict(field_type="cp", cp_features_per_level=4, proposal_cp_features_per_level=4),
     "field_type"),
    (dict(predict_normals=True), "predict_normals"),
    (dict(camera_optimizer="SO3xR3"), "camera_optimizer"),
    (dict(disable_scene_contraction=True, background_color="white"),
     "disable_scene_contraction"),
    ("transient", "use_transient_embedding"),
    ("png_depth", "16-bit PNG depth"),
    (dict(flow_loss_mult=0.001), "flow_loss_mult"),
    (dict(sky_loss_mult=0.1), "sky_loss_mult"),
])
def test_unported_configs_raise(change, name, tmp_path, monkeypatch):
    """Every setting of the cases is ported now, and none raises: the hash
    and cp fields, normals and disabled contraction run the eval forward on
    the non-fused path; the others run as ``_ported_training_case`` and the
    transient and PNG-depth branches say; each matches the JAX package."""
    from nerf_kbs_tpu.models import semantic_nerfw as jsem
    from nerf_kbs_tpu_torch.models import semantic_nerfw

    assert name in PORTED
    if name in ("camera_optimizer", "flow_loss_mult", "sky_loss_mult"):
        monkeypatch.setenv("NKT_FUSED", "1")
        _ported_training_case(name)
        return
    if change == "png_depth":
        _png_depth_datamanager(tmp_path)
        return
    if change == "transient":
        kw = dict(**SMALL, use_transient_embedding=True, num_semantic_classes=2,
                  appearance_embedding_dim=4)
        jcfg, tcfg = jsem.SemanticNerfWConfig(**kw), semantic_nerfw.SemanticNerfWConfig(**kw)
        jp = jsem.init(jax.random.PRNGKey(0), jcfg)
        tp = params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
        jr, tr = _rays(16, seed=2)
        key = jax.random.PRNGKey(1)
        jout = jax.jit(lambda p: jsem.forward(p, jcfg, jr, key=key, step=900, train=True))(jp)
        with torch.no_grad():
            tout = semantic_nerfw.forward(tp, tcfg, tr, step=900, train=True, jitters=[
                torch.tensor(np.array(jax.random.uniform(k, (16, 1))))
                for k in jax.random.split(key, 3)])
        _compare(tout, jout, ("rgb", "accumulation", "depth", "uncertainty",
                              "density_transient", "prop_depth_0", "prop_depth_1"))
        return
    jcfg, tcfg = _pair(**{**SMALL, **change})
    assert not tnerf.uses_fused_path(tcfg)
    jp, tp = _params(jcfg)
    jr, tr = _rays(16, seed=2)
    jout = jax.jit(lambda p, r: jnerf.forward(p, jcfg, r, key=None, step=900,
                                              train=False))(jp, jr)
    with torch.no_grad():  # as the renderer and the trainer's eval call it
        tout = tnerf.forward(tp, tcfg, tr, step=900, train=False)
    keys = OUT_KEYS + (("normals", "pred_normals") if tcfg.predict_normals else ())
    _compare(tout, jout, keys)


def test_train_forward_and_bad_background_raise():
    """The training forward runs, with flow supervision too: its loss has the
    flow term when the batch carries the flow rows (equal to JAX's
    induced_flow and flow_loss) and none without them; a bad background
    still raises."""
    from nerf_kbs_tpu.ops import losses as jL

    r = _small_renderer()
    _, tr = _rays(4)
    out = tnerf.forward(r.params, r.config, tr, train=True,
                        generator=torch.Generator().manual_seed(0))
    assert out["rgb"].shape == (4, 3) and len(out["proposal_history"]) == 2
    flow_cfg = dataclasses.replace(r.config, flow_loss_mult=0.001)
    flow_out = tnerf.forward(r.params, flow_cfg, tr, train=True,
                             generator=torch.Generator().manual_seed(0))
    assert torch.equal(flow_out["rgb"], out["rgb"])
    batch = {k: torch.as_tensor(v) for k, v in _flow_sky_batch(4).items()}
    _, m = tnerf.loss(flow_cfg, flow_out, batch)
    want = 0.001 * float(jL.flow_loss(
        jL.induced_flow(*(jnp.asarray(flow_out[k].detach().numpy())
                          for k in ("_origins", "_view_dirs", "depth")),
                        *(jnp.asarray(batch[k].numpy()) for k in ("pixel_xy", "fwd_w2c", "fwd_K"))),
        jnp.asarray(batch["forward_flow"].numpy()), jnp.asarray(batch["flow_valid"].numpy())))
    np.testing.assert_allclose(float(m["flow_loss"]), want, rtol=1e-5)
    assert "flow_loss" not in tnerf.loss(flow_cfg, out, {"image": torch.zeros(4, 3)})[1]
    with pytest.raises(ValueError, match="background_color"):
        tnerf.forward(r.params, dataclasses.replace(r.config, background_color="pink"), tr)
