"""Port vs JAX package, ``utils/tboard.py``, ``utils/lpips.py`` and
``utils/profiling.py`` on the CPU: the TensorBoard event file byte for byte
(with the clock, host name and pid fixed in both modules) and read back by
TensorBoard's own reader; LPIPS on seeded checkpoints in the official
layout (``tools/make_lpips_ckpt.py``) against the JAX package's at two image
sizes, f32, to 1e-5 relative; the trainer's ``lpips`` eval key and
``require_lpips``; the memory counters (None without a card;
``chip_smoke.py`` reads them on one) and the profiler trace."""

import dataclasses
import importlib.util
import json
import struct
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_kbs_tpu.utils import lpips as jlpips
from nerf_kbs_tpu.utils import tboard as jtb
from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager
from nerf_kbs_tpu_torch.engine.trainer import Trainer, TrainerConfig
from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
from nerf_kbs_tpu_torch.models import nerfacto as tnerf
from nerf_kbs_tpu_torch.utils import lpips as tlpips
from nerf_kbs_tpu_torch.utils import profiling
from nerf_kbs_tpu_torch.utils import tboard as ttb

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(num_images=4, field_type="fourier", fourier_num_levels=2,
             fourier_features_per_level=8, proposal_fourier_features_per_level=4,
             proposal_num_levels=2, hidden_dim=16, hidden_dim_color=16, base_res=4, max_res=32,
             proposal_max_res=(16, 32), num_proposal_samples_per_ray=(16, 8),
             num_nerf_samples_per_ray=8, appearance_embedding_dim=0)


def read_records(path: Path) -> list[bytes]:
    """The payloads of a TFRecord file, every length and payload CRC
    checked with the JAX package's masked CRC32C."""
    data, out = path.read_bytes(), []
    while data:
        (n,) = struct.unpack("<Q", data[:8])
        assert struct.unpack("<I", data[8:12])[0] == jtb._masked_crc(data[:8])
        payload = data[12:12 + n]
        assert struct.unpack("<I", data[12 + n:16 + n])[0] == jtb._masked_crc(payload)
        out.append(payload)
        data = data[16 + n:]
    return out


@pytest.fixture
def fixed_host(monkeypatch):
    """Both modules' writers see the same host and pid."""
    for mod in (jtb, ttb):
        monkeypatch.setattr(mod.socket, "gethostname", lambda: "host-a")
        monkeypatch.setattr(mod.os, "getpid", lambda: 4242)


def _write(mod, logdir: Path, stream: list, monkeypatch) -> Path:
    """The writer of ``mod`` on a clock that reads 1,700,000,000.25 and then
    advances 0.5 s a call."""
    ticks = iter(np.arange(1_700_000_000.25, 1_700_000_100.0, 0.5).tolist())
    monkeypatch.setattr(mod.time, "time", lambda: next(ticks))
    w = mod.TensorboardWriter(logdir)
    for step, scalars in stream:
        w.add_scalars(step, scalars)
    w.close()
    (path,) = list(logdir.iterdir())
    return path


STREAMS = {
    "losses": [(1, {"total_loss": 0.25, "rgb_loss": 0.125, "step": 1}),
               (2, {"total_loss": 0.2, "rays_per_sec": 123456.75, "step": 2})],
    "mixed": [(0, {"psnr": 12.5, "image_idx": 3, "name": "skip", "ok": True}),
              (300, {"eval_all_psnr": 1e-30, "lpips": float("inf")}),
              (5, {"only": "strings"})],
    "large_step": [(2 ** 40 + 7, {"x": -1.5})],
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_tboard_file_is_jax_bytes(tmp_path, fixed_host, monkeypatch, name):
    want = _write(jtb, tmp_path / "jax", STREAMS[name], monkeypatch)
    got = _write(ttb, tmp_path / "torch", STREAMS[name], monkeypatch)
    assert got.name == want.name
    assert got.read_bytes() == want.read_bytes()
    assert len(read_records(got)) == 1 + sum(
        any(isinstance(v, (int, float)) and k != "step" for k, v in s.items())
        for _, s in STREAMS[name])


def test_tboard_crc32c_known_value():
    assert ttb._crc32c(b"123456789") == 0xE3069283
    assert ttb._masked_crc(b"") == jtb._masked_crc(b"")


def test_tboard_file_reads_in_tensorboard(tmp_path):
    ev = pytest.importorskip("tensorboard.backend.event_processing.event_file_loader")
    w = ttb.TensorboardWriter(tmp_path)
    w.add_scalars(7, {"total_loss": 0.5, "psnr": 21.25, "step": 7})
    w.add_scalars(9, {"total_loss": 0.25})
    w.close()
    (path,) = list(tmp_path.iterdir())
    events = list(ev.EventFileLoader(str(path)).Load())
    assert events[0].file_version == "brain.Event:2"
    # the loader moves a simple_value into the scalar tensor it reads
    got = [(e.step, v.tag, v.tensor.float_val[0]) for e in events[1:] for v in e.summary.value]
    assert got == [(7, "total_loss", 0.5), (7, "psnr", 21.25), (9, "total_loss", 0.25)]


@pytest.fixture(scope="module")
def lpips_dir(tmp_path_factory):
    """The seeded official-layout checkpoint pair of tools/make_lpips_ckpt.py."""
    out = tmp_path_factory.mktemp("lpips")
    spec = importlib.util.spec_from_file_location("make_lpips_ckpt",
                                                  REPO / "tools" / "make_lpips_ckpt.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    argv = sys.argv
    sys.argv = ["make_lpips_ckpt.py", str(out)]
    try:
        mod.main()
    finally:
        sys.argv = argv
    return out


@pytest.mark.parametrize("hw", [(32, 48), (45, 61)])
def test_lpips_matches_jax(lpips_dir, monkeypatch, hw):
    """Two sizes, the second odd (every pool floors)."""
    monkeypatch.setenv("NKT_LPIPS_DIR", str(lpips_dir))
    rng = np.random.default_rng(hw[0])
    pred = rng.uniform(0, 1, (*hw, 3)).astype(np.float32)
    gt = np.clip(pred + rng.normal(0, 0.1, pred.shape), 0, 1).astype(np.float32)
    want = float(jlpips.load_lpips()(jnp.asarray(pred), jnp.asarray(gt)))
    model = tlpips.load_lpips(device="cpu")
    got = float(model(torch.from_numpy(pred), torch.from_numpy(gt)))
    assert want > 0
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(model(torch.from_numpy(gt), torch.from_numpy(gt))) == 0.0


def _trainer(tmp_path, **cfg) -> Trainer:
    # 16 x 16: VGG16's fourth pool leaves 1 x 1
    dm = SyntheticDataManager(num_cameras=4, h=16, w=16, rays_per_batch=48, num_eval_cameras=2)
    return Trainer(TrainerConfig(output_dir=str(tmp_path), **cfg), tnerf.NerfactoConfig(**SMALL),
                   nerfacto_tpu_method().optimizers, dm, device="cpu")


def test_load_lpips_is_none_without_files_and_required_raises(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("NKT_LPIPS_DIR", str(tmp_path / "absent"))
    assert tlpips.load_lpips(device="cpu") is None
    metrics = _trainer(tmp_path / "a").eval_image(0, write_images=False)
    assert "lpips" not in metrics and "psnr" in metrics
    assert "LPIPS checkpoints not found" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="LPIPS checkpoints not found"):
        _trainer(tmp_path / "b", require_lpips=True).eval_image(0)


def test_trainer_eval_reports_lpips(tmp_path, monkeypatch, lpips_dir):
    """The eval image's LPIPS is the module's on the render and the ground
    truth; eval_all_images averages it in JAX's key order."""
    monkeypatch.setenv("NKT_LPIPS_DIR", str(lpips_dir))
    tr = _trainer(tmp_path, require_lpips=True)
    m = tr.eval_image(1, write_images=False)
    pred = torch.from_numpy(tr.render_camera(1)["rgb"])
    gt = torch.from_numpy(np.asarray(tr.dm.eval_image(1)["image"], np.float32))
    assert m["lpips"] == pytest.approx(float(tlpips.load_lpips(device="cpu")(pred, gt)), rel=1e-6)
    keys = list(tr.eval_all_images())
    assert keys[:3] == ["psnr", "ssim", "lpips"]


@pytest.mark.skipif(torch.cuda.is_available(), reason="the host has a card; chip_smoke.py "
                    "holds the card's counters")
def test_device_memory_stats_is_none_without_a_card():
    assert profiling.device_memory_stats() is None


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "trace")) as d:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((Path(d) / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


def test_install_faulthandler_registers_sigusr1():
    import faulthandler
    import signal

    profiling.install_faulthandler()
    assert faulthandler.unregister(signal.SIGUSR1)


def test_trainer_config_fields_match_jax():
    """vis and require_lpips have JAX's names and defaults."""
    from nerf_kbs_tpu.engine.trainer import TrainerConfig as JConfig

    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    t = {f.name: f.default for f in dataclasses.fields(TrainerConfig)}
    assert t["vis"] == j["vis"] == "" and t["require_lpips"] is j["require_lpips"] is False
