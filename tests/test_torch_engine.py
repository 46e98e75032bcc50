"""Port vs JAX package, the rest of the engine on the CPU: the viewer's
RFC-6455 framing (``ws_accept_key``, ``ws_send_frame`` over a socket pair,
``ws_recv_frame``) against the JAX functions byte for byte; a whole
WebSocket session and the HTTP routes of the port's ``ViewerServer`` at tiny
widths (the JAX package's own session tests, mirrored); ``status()`` against
JAX's on the same output directory; the live viewer while ``cli.main``
trains (a gate holds the trainer at step 2 until the client is connected);
``apply_camera_overrides`` against JAX's on cameras with distortion and
times; the three ``--render-*`` flags through ``main``; ``render_trajectory``
of a tiny vanilla-nerf (temporal distortion on) against JAX's, decoded
pixels within one level of 255; ``_resolve_viewer_port`` case by case; and
``discover_methods`` with a plugin module."""

import json
import socket
import struct
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import WSClient, free_port, ws_client_frame
from nerf_kbs_tpu.cameras.cameras import Cameras as JCameras
from nerf_kbs_tpu.engine import cli as jcli
from nerf_kbs_tpu.engine import render as jrender
from nerf_kbs_tpu.engine import trainer as jtrainer_mod
from nerf_kbs_tpu.engine import viewer as jviewer
from nerf_kbs_tpu.parallel.mesh import make_mesh
from nerf_kbs_tpu_torch.cameras.cameras import Cameras as TCameras
from nerf_kbs_tpu_torch.data import synthetic_kitti as tsk
from nerf_kbs_tpu_torch.data.synthetic import SyntheticDataManager
from nerf_kbs_tpu_torch.engine import cli as tcli
from nerf_kbs_tpu_torch.engine import render as trender
from nerf_kbs_tpu_torch.engine import viewer as tviewer
from nerf_kbs_tpu_torch.engine.optimizers import tree_copy_
from nerf_kbs_tpu_torch.engine.trainer import Trainer, TrainerConfig
from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method
from nerf_kbs_tpu_torch.models import nerfacto as tnerf
from nerf_kbs_tpu_torch.utils import images
from tests.test_torch_cli import TINY, TINY_VANILLA, H, W, _window

SMALL = dict(num_images=4, field_type="fourier", fourier_num_levels=2,
             fourier_features_per_level=8, proposal_fourier_features_per_level=4,
             proposal_num_levels=2, hidden_dim=16, hidden_dim_color=16, base_res=4, max_res=32,
             proposal_max_res=(16, 32), num_proposal_samples_per_ray=(16, 8),
             num_nerf_samples_per_ray=8, appearance_embedding_dim=0)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return tsk.write_dynamic_dataset(tmp_path_factory.mktemp("engine") / "scene", n_frames=8,
                                     h=H, w=W)


@pytest.fixture(scope="module")
def vkitti_scene(tmp_path_factory):
    return tsk.write_vkitti_dataset(tmp_path_factory.mktemp("engine") / "vkitti", n_frames=8,
                                    h=H, w=W)


def _tiny_trainer(tmp_path) -> Trainer:
    dm = SyntheticDataManager(num_cameras=4, h=16, w=16, rays_per_batch=48, num_eval_cameras=2)
    return Trainer(TrainerConfig(output_dir=str(tmp_path), eval_num_rays_per_chunk=256),
                   tnerf.NerfactoConfig(**SMALL), nerfacto_tpu_method().optimizers, dm,
                   device="cpu")


# ------------------------------------------------------------------ framing


@pytest.mark.parametrize("key", ["dGhlIHNhbXBsZSBub25jZQ==", "MDEyMzQ1Njc4OWFiY2RlZg==", "x"])
def test_ws_accept_key_matches_jax(key):
    assert tviewer.ws_accept_key(key) == jviewer.ws_accept_key(key)
    if key.startswith("dGhl"):  # RFC 6455 section 1.3's example
        assert tviewer.ws_accept_key(key) == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


def _sent_bytes(send, payload: bytes, opcode: int) -> bytes:
    """What ``send(sock, payload, opcode)`` puts on the wire, read on the
    other end of a socket pair by a second thread (a 64 KiB frame outgrows
    the socket buffer)."""
    a, b = socket.socketpair()
    got = bytearray()

    def read():
        while chunk := b.recv(1 << 16):
            got.extend(chunk)

    reader = threading.Thread(target=read)
    reader.start()
    try:
        a.settimeout(0.5)
        send(a, payload, opcode)
        assert a.gettimeout() == 0.5  # restored after the send's own timeout
    finally:
        a.close()
        reader.join(timeout=30)
        b.close()
    assert not reader.is_alive()
    return bytes(got)


@pytest.mark.parametrize("n", [0, 125, 126, 65535, 65536])
def test_ws_send_frame_bytes_match_jax(n):
    payload = bytes(np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8))
    for opcode in (0x1, 0x2):
        got = _sent_bytes(tviewer.ws_send_frame, payload, opcode)
        assert got == _sent_bytes(jviewer.ws_send_frame, payload, opcode)
        assert got[0] == 0x80 | opcode and got.endswith(payload)


class _Stub:
    """A socket that serves fixed bytes, then EOF."""

    def __init__(self, data: bytes):
        self.data = data

    def recv(self, n):
        out, self.data = self.data[:n], self.data[n:]
        return out


RECV_CASES = {
    "masked_text": ws_client_frame(b'{"type": "pose"}'),
    "unmasked_binary": ws_client_frame(b"\x00\x01\x02", opcode=0x2, mask=b""),
    "fragment_then_continuation": ws_client_frame(b"abc", fin=False)
    + ws_client_frame(b"def", opcode=0x0),
    "masked_126": ws_client_frame(bytes(range(256)) * 2, opcode=0x2),
    "empty_close": ws_client_frame(b"", opcode=0x8),
    "oversized": ws_client_frame(b"", opcode=0x2, length=(1 << 20) + 1) + b"x" * 64,
    "at_the_cap": ws_client_frame(b"a" * (1 << 20), opcode=0x2, mask=b""),
    "truncated": ws_client_frame(b"hello world")[:-3],
}


@pytest.mark.parametrize("case", sorted(RECV_CASES))
def test_ws_recv_frame_matches_jax(case):
    """Each frame read to the end by both packages: the same frames, and
    the same bytes left unread (an oversized frame is refused right after
    its length)."""
    t, j = _Stub(RECV_CASES[case]), _Stub(RECV_CASES[case])
    got, want = [], []
    while True:
        a, b = tviewer.ws_recv_frame(t), jviewer.ws_recv_frame(j)
        got.append(a)
        want.append(b)
        if a is None or b is None:
            break
    assert got == want and t.data == j.data
    assert tviewer.WS_MAX_FRAME == jviewer.WS_MAX_FRAME
    if case == "fragment_then_continuation":
        assert got[:2] == [(0x1, b"abc", False), (0x0, b"def", True)]


def test_buffered_socket_serves_pipelined_bytes_first():
    a, b = socket.socketpair()
    try:
        b.sendall(b"tail")
        s = tviewer._BufferedSocket(a, b"head")
        assert tviewer._read_exact(s, 6) == b"headta"
        assert tviewer._read_exact(s, 2) == b"il"
        b.close()
        assert tviewer._read_exact(s, 1) is None
    finally:
        a.close()


# ------------------------------------------------------------------ server


def test_viewer_websocket_session(tmp_path):
    """Handshake, the first status push, a pose -> a PNG, ping -> pong, a
    fragmented pose, a status request, and the close echoed."""
    tr = _tiny_trainer(tmp_path)
    srv = tviewer.ViewerServer(tr, eval_image_dir=str(tr.out_dir / "eval_images"), port=0)
    srv.start_background()
    ws = None
    try:
        ws = WSClient(srv.port)
        assert b" 101 " in ws.head.split(b"\r\n")[0] + b" "
        assert jviewer.ws_accept_key(ws.key).encode() in ws.head
        op, payload = ws.recv()
        status = json.loads(payload)
        assert op == 0x1 and status["step"] == 0 and status["mode"] == "standalone"
        assert status["num_eval_images"] == 2
        ws.send(json.dumps({"type": "pose", "theta": 1.0, "size": 16}).encode())
        op, payload = ws.recv()
        assert op == 0x2 and images.decode_png(payload).shape == (16, 16, 3)
        ws.send(b"hi", opcode=0x9)
        assert ws.recv() == (0xA, b"hi")
        pose = json.dumps({"type": "pose", "theta": 1.1, "size": 12}).encode()
        ws.send(pose[:7], fin=False)
        ws.send(pose[7:], opcode=0x0)
        op, payload = ws.recv()
        assert op == 0x2 and images.decode_png(payload).shape == (12, 12, 3)
        ws.send(b'{"type": "status"}')
        op, payload = ws.recv()
        assert op == 0x1 and json.loads(payload)["step"] == 0
        ws.send(struct.pack(">H", 1000), opcode=0x8)
        assert ws.recv() == (0x8, struct.pack(">H", 1000))
    finally:
        if ws is not None:
            ws.close()
        srv.shutdown()


def test_viewer_websocket_pipelined_upgrade(tmp_path):
    """A first frame sent in the same segment as the upgrade request is
    answered (the session drains what the handler's reader took)."""
    tr = _tiny_trainer(tmp_path)
    srv = tviewer.ViewerServer(tr, port=0)
    srv.start_background()
    ws = None
    try:
        pose = json.dumps({"type": "pose", "theta": 0.5, "size": 16}).encode()
        ws = WSClient(srv.port, pipelined=ws_client_frame(pose))
        assert ws.recv()[0] == 0x1  # the status push
        op, payload = ws.recv()
        assert op == 0x2 and payload[:4] == b"\x89PNG"
    finally:
        if ws is not None:
            ws.close()
        srv.shutdown()


def _dumps(d: Path, steps=(10, 20)) -> Path:
    ev = d / "eval_images"
    ev.mkdir(parents=True)
    for s in steps:
        for kind in ("rgb", "depth"):
            img = np.full((4, 6, 3), s / 40.0 + (kind == "depth") * 0.25, np.float32)
            (ev / f"step{s:08d}_img0_{kind}.png").write_bytes(images.encode_png(img))
    (d / "metrics.jsonl").write_text('{"step": 1, "psnr": 3.5}\n{"step": 2, "total_loss": 0.25}\n')
    return ev


@pytest.mark.parametrize("layout", ["no_dir", "empty", "dumps"])
def test_viewer_status_matches_jax(tmp_path, layout):
    ev = tmp_path / "eval_images"
    if layout == "empty":
        ev.mkdir()
    elif layout == "dumps":
        _dumps(tmp_path)
    jt = SimpleNamespace(step=5, dm=SimpleNamespace(num_eval_images=lambda: 2))
    tt = SimpleNamespace(step=5, eval_cameras=[0, 0], device="cpu")
    j = jviewer.ViewerServer(jt, eval_image_dir=str(ev), port=0, mode="training")
    t = tviewer.ViewerServer(tt, eval_image_dir=str(ev), port=0, mode="training")
    try:
        want, got = j.status(), t.status()
        assert want.pop("port") == j.port and got.pop("port") == t.port
        assert got == want
        if layout == "dumps":
            assert got["latest_dump"] == "step00000020_img0_rgb.png"
            assert got["last_metrics"] == {"step": 2, "total_loss": 0.25}
    finally:
        j._server.server_close()
        t.shutdown()


def _get(url: str) -> tuple[int, str, bytes]:
    try:
        with urllib.request.urlopen(url, timeout=120) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        with e:
            return e.code, e.headers["Content-Type"], e.read()


def test_viewer_page_latest_and_errors(tmp_path):
    """GET / is JAX's page; /latest serves the newest dump of a kind, 404
    before any; bad queries answer 400, a plain GET of /ws 426."""
    tr = _tiny_trainer(tmp_path)
    srv = tviewer.ViewerServer(tr, eval_image_dir=str(tmp_path / "out" / "eval_images"), port=0)
    srv.start_background()
    base = f"http://127.0.0.1:{srv.port}"
    try:
        code, ctype, body = _get(base + "/")
        assert (code, ctype) == (200, "text/html") and body.decode() == jviewer._PAGE
        assert _get(base + "/latest")[0] == 404
        ev = _dumps(tmp_path / "out")
        for kind in ("rgb", "depth"):
            code, ctype, body = _get(f"{base}/latest?kind={kind}")
            assert (code, ctype) == (200, "image/png")
            assert body == (ev / f"step00000020_img0_{kind}.png").read_bytes()
        for bad in ("/render?cam=2", "/render?cam=-1", "/render?cam=0&kind=normals",
                    "/orbit?size=0", "/orbit?size=5000", "/render?cam=x"):
            assert _get(base + bad)[0] == 400, bad
        assert _get(base + "/ws")[0] == 426
        assert _get(base + "/nope")[0] == 404
    finally:
        srv.shutdown()


def test_live_viewer_during_cli_training(scene, tmp_path, monkeypatch):
    """cli.main trains 10 steps at tiny widths with --trainer.vis
    viewer+tensorboard and --viewer-port: while the trainer waits at step 2
    the client reads /, /status, /render, /orbit and /latest (no dumps yet)
    and opens a websocket; then training runs on, the status pushes rise to
    10, a pose is answered with a PNG. After main returns, /render?cam=0 is
    the trainer's own render of camera 0, and the event file holds one
    record per metrics.jsonl line."""
    port = free_port()
    gate, at_step_2 = threading.Event(), threading.Event()
    real = Trainer.train_step

    def gated(self, batch, jitters=None):
        out = real(self, batch, jitters)
        if self.step == 2:
            at_step_2.set()
            assert gate.wait(120)
        return out

    monkeypatch.setattr(Trainer, "train_step", gated)
    argv = (["nerfacto-tpu"] + _window(scene, tmp_path) + TINY
            + ["--trainer.max_num_iterations", "10", "--trainer.vis", "viewer+tensorboard",
               "--viewer-port", str(port)])
    result = {}
    runner = threading.Thread(target=lambda: result.update(viewer=tcli.main(argv, device="cpu")))
    runner.start()
    base = f"http://127.0.0.1:{port}"
    ws = None
    try:
        assert at_step_2.wait(120)
        assert _get(base + "/")[0] == 200
        status = json.loads(_get(base + "/status")[2])
        assert status["mode"] == "training" and status["step"] == 2
        # step 2 is taken, its metrics not yet logged
        assert status["num_eval_images"] == 2 and status["last_metrics"]["step"] == 1
        for path, shape in (("/render?cam=0", (H, W, 3)), ("/render?cam=1&kind=depth", (H, W, 3)),
                            ("/orbit?theta=0.4&size=24", (24, 24, 3))):
            code, ctype, body = _get(base + path)
            assert (code, ctype) == (200, "image/png") and images.decode_png(body).shape == shape
        assert _get(base + "/latest")[0] == 404
        ws = WSClient(port)
        op, payload = ws.recv()
        steps = [json.loads(payload)["step"]]
        assert op == 0x1 and steps == [2]
        gate.set()
        ws.send(json.dumps({"type": "pose", "theta": 0.2, "size": 16}).encode())
        pngs = 0
        while steps[-1] < 10 or not pngs:
            op, payload = ws.recv()
            if op == 0x1:
                steps.append(json.loads(payload)["step"])
            else:
                assert op == 0x2 and images.decode_png(payload).shape == (16, 16, 3)
                pngs += 1
        assert steps == sorted(steps) and len(set(steps)) >= 2 and steps[-1] == 10
        ws.send(b"ping", opcode=0x9)
        while (frame := ws.recv())[0] == 0x1:
            pass
        assert frame == (0xA, b"ping")
        ws.send(struct.pack(">H", 1000), opcode=0x8)
        assert ws.recv() == (0x8, struct.pack(">H", 1000))
    finally:
        gate.set()
        if ws is not None:
            ws.close()
        runner.join(timeout=300)
    assert not runner.is_alive()
    viewer = result["viewer"]
    try:
        assert viewer.trainer.step == 10
        body = _get(base + "/render?cam=0")[2]
        assert body == images.encode_png(viewer.trainer.render_camera(0)["rgb"])
        out = viewer.trainer.out_dir
        lines = (out / "metrics.jsonl").read_text().splitlines()
        (events,) = list((out / "tensorboard").iterdir())
        from tests.test_torch_utils import read_records

        assert len(read_records(events)) == 1 + len(lines)
    finally:
        viewer.shutdown()


# -------------------------------------------------------- camera overrides


def _camera_arrays(n: int = 5) -> dict:
    rng = np.random.default_rng(n)
    c2w = np.concatenate([np.tile(np.eye(3), (n, 1, 1)), rng.normal(0, 1, (n, 3, 1))], axis=2)
    return {"fx": rng.uniform(100, 200, n), "fy": rng.uniform(100, 200, n),
            "cx": rng.uniform(40, 60, n), "cy": rng.uniform(30, 50, n), "c2w": c2w,
            "width": np.full(n, 96), "height": np.full(n, 64),
            "distortion": rng.normal(0, 0.01, (n, 6)), "times": np.linspace(0, 1, n)}


@pytest.mark.parametrize("focal,shift,frames", [
    (None, None, None), (2.0, None, None), (None, (0.1, -0.2, 0.3), None),
    (0.5, (1.0, 0.0, 0.0), (1, 3))])
def test_apply_camera_overrides_matches_jax(focal, shift, frames):
    a = _camera_arrays()
    ints = ("width", "height")
    jc = JCameras(**{k: jnp.asarray(v, jnp.int32 if k in ints else jnp.float32)
                     for k, v in a.items()})
    tc = TCameras(**{k: torch.as_tensor(v, dtype=torch.int32 if k in ints else torch.float32)
                     for k, v in a.items()})
    want = jrender.apply_camera_overrides(jc, focal, shift, frames)
    got = trender.apply_camera_overrides(tc, focal, shift, frames)
    for k in a:
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-7, err_msg=k)
    assert len(got) == (5 if frames is None else frames[1] - frames[0] + 1)
    np.testing.assert_array_equal(tc.c2w.numpy(), a["c2w"].astype(np.float32))  # input kept


@pytest.fixture(scope="module")
def checkpoint(scene, tmp_path_factory):
    """nerfacto-tpu at tiny widths, one step, saved."""
    out = tmp_path_factory.mktemp("ckpt")
    argv = ["nerfacto-tpu"] + _window(scene, out) + TINY + ["--trainer.max_num_iterations", "1"]
    tcli.main(argv, device="cpu")
    return argv, str(out / "exp" / "nerfacto-tpu")


@pytest.mark.parametrize("flags,overrides", [
    (["--render-focal-mult", "2"], (2.0, None, None)),
    (["--render-pos-shift", "0.1,0,-0.05"], (None, (0.1, 0.0, -0.05), None)),
    (["--render-frame-range", "1,1"], (None, None, (1, 1))),
    (["--render_focal_mult", "0.5", "--render_pos_shift", "0,0.2,0", "--render_frame_range",
      "0,0"], (0.5, (0.0, 0.2, 0.0), (0, 0))),
])
def test_render_flags_through_main(checkpoint, tmp_path, flags, overrides):
    """--render-only with each override: the frames are those of
    render_trajectory over apply_camera_overrides of the eval cameras, byte
    for byte."""
    argv, ckpt = checkpoint
    out = tmp_path / "renders"
    tcli.main(argv + ["--render-only", "true", "--render-dir", str(out), "--trainer.load_dir",
                      ckpt, "--render_ring_view", "false"] + flags, device="cpu")
    spec = tcli.apply_overrides(tcli.method_registry["nerfacto-tpu"](),
                                {"trainer.load_dir": ckpt, **dict(zip(
                                    [a[2:] for a in argv[1::2]], argv[2::2]))})
    tr = tcli.build_trainer(spec, device="cpu")
    cams = trender.apply_camera_overrides(tr.eval_cameras, *overrides)
    path = trender.interpolate_camera_path(cams.c2w.numpy(), 8)
    frames = sorted(out.glob("rgb_*.png"))
    assert len(frames) == len(path) == (1 if overrides[2] else 9)
    traj = trender.apply_camera_overrides(cams, frame_range=(0, 0))
    traj.c2w = torch.as_tensor(path[-1:], dtype=torch.float32)
    want = images.encode_png(tr.render_camera(0, cameras=traj)["rgb"])
    assert frames[-1].read_bytes() == want


def test_render_trajectory_camera_source(tmp_path):
    tr = _tiny_trainer(tmp_path)
    a = trender.render_trajectory(tr, str(tmp_path / "eval"), frames_per_segment=1)
    b = trender.render_trajectory(tr, str(tmp_path / "train"), frames_per_segment=1,
                                  camera_source="train")
    assert len(a) == len(tr.eval_cameras) and len(b) == len(tr.train_cameras) == 4
    with pytest.raises(ValueError, match="camera_source"):
        trender.render_trajectory(tr, str(tmp_path), camera_source="test")


def test_render_trajectory_train_source_needs_a_trainer(tmp_path):
    """A Renderer holds only the eval cameras: the train path is refused,
    not rendered from the eval set."""
    renderer = _tiny_trainer(tmp_path)._renderer()
    assert not hasattr(renderer, "train_cameras")
    with pytest.raises(ValueError, match="needs a Trainer"):
        trender.render_trajectory(renderer, str(tmp_path), camera_source="train")
    assert trender.render_trajectory(renderer, str(tmp_path / "eval"), frames_per_segment=1)


def test_render_trajectory_of_vanilla_nerf_carries_times_as_jax(vkitti_scene, tmp_path,
                                                                 monkeypatch):
    """vanilla-nerf (temporal distortion on) from the same parameters in
    both packages: the frames of render_trajectory decode to within one level
    of 255 of JAX's (PIL writes JAX's), and differ from the frames rendered
    without the cameras' times, which the port dropped before."""
    Image = pytest.importorskip("PIL.Image")
    monkeypatch.setattr(jtrainer_mod, "make_mesh", lambda *a: make_mesh(jax.devices()[:1]))
    argv = TINY_VANILLA + ["--dataparser.data_dir", str(vkitti_scene),
                           "--trainer.output_dir", str(tmp_path)]
    ov = dict(zip([a[2:] for a in argv[::2]], argv[1::2]))
    jt = jcli.build_trainer(jcli.apply_overrides(jcli.method_registry["vanilla-nerf"](), ov))
    tt = tcli.build_trainer(tcli.apply_overrides(tcli.method_registry["vanilla-nerf"](), ov),
                            device="cpu")
    # the temporal distortion's last layer starts at zero (no warp at step
    # 0): both packages get the same non-zero one
    start = jax.tree.map(np.array, jt.params)
    last = start["temporal_distortion"]["w"][-1]
    last[...] = np.random.default_rng(0).normal(0, 0.2, last.shape)
    jt.params = jax.device_put(start, jax.tree.map(lambda a: a.sharding, jt.params))
    tree_copy_(tt.params, start)
    assert tt.eval_cameras.times is not None
    jpaths = jrender.render_trajectory(jt, str(tmp_path / "jax"), frames_per_segment=2)
    tpaths = trender.render_trajectory(tt, str(tmp_path / "torch"), frames_per_segment=2)
    assert len(tpaths) == len(jpaths) == 3
    for tp, jp in zip(tpaths, jpaths):
        got = images.decode_png(Path(tp).read_bytes()).astype(int)
        want = np.asarray(Image.open(jp).convert("RGB")).astype(int)
        assert np.abs(got - want).max() <= 1
    tt.eval_cameras.times = None
    untimed = trender.render_trajectory(tt, str(tmp_path / "untimed"), frames_per_segment=2)
    assert Path(untimed[1]).read_bytes() != Path(tpaths[1]).read_bytes()


# ---------------------------------------------------------------- the CLI


@pytest.mark.parametrize("port,vis", [(0, ""), (0, "viewer"), (0, "viewer+tensorboard"),
                                      (0, "tensorboard"), (8080, ""), (8080, "viewer")])
def test_resolve_viewer_port_matches_jax(port, vis):
    assert tcli._resolve_viewer_port(port, vis) == jcli._resolve_viewer_port(port, vis)


def test_discover_methods_reads_its_own_variable(tmp_path, monkeypatch):
    """A plugin named in NKT_TORCH_METHODS registers a method; a module
    named only in the JAX CLI's NKT_METHODS is not imported."""
    (tmp_path / "nkt_torch_plugin_demo.py").write_text(
        "from nerf_kbs_tpu_torch.engine import cli\n"
        "from nerf_kbs_tpu_torch.methods import nerfacto_tpu_method\n"
        "cli.register_method('plugin-demo', nerfacto_tpu_method)\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setenv("NKT_TORCH_METHODS", " nkt_torch_plugin_demo ,")
    monkeypatch.setenv("NKT_METHODS", "nkt_jax_only_plugin_that_does_not_exist")
    monkeypatch.delitem(tcli.method_registry, "plugin-demo", raising=False)
    monkeypatch.delitem(sys.modules, "nkt_torch_plugin_demo", raising=False)
    tcli.discover_methods()
    assert "plugin-demo" in tcli.method_registry
    monkeypatch.delitem(tcli.method_registry, "plugin-demo")
    assert "_UNPORTED_FLAGS" not in vars(tcli)
