"""HTTP viewer: renders eval cameras and free orbit cameras on request from
a Renderer.

  GET /status                                   JSON {mode, port, step, num_cameras}
  GET /render?cam=0&kind=rgb|depth              PNG of an eval camera
  GET /orbit?theta=0&phi=0.35&radius=1.6&size=128   PNG of an orbit camera

A lock keeps at most one render on the device at a time. The server binds
loopback by default; port 0 takes a free port (``self.port`` reports it).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
from nerf_kbs_tpu_torch.engine.render import Renderer
from nerf_kbs_tpu_torch.utils import images


class ViewerServer:
    def __init__(self, renderer: Renderer, port: int = 7007, host: str = "127.0.0.1"):
        self.renderer = renderer
        self._render_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                u = urlparse(self.path)
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                try:
                    if u.path == "/status":
                        self._send(200, json.dumps(viewer.status()).encode())
                    elif u.path == "/render":
                        png = viewer.render_eval_camera(int(q.get("cam", 0)), q.get("kind", "rgb"))
                        self._send(200, png, "image/png")
                    elif u.path == "/orbit":
                        png = viewer.render_orbit(
                            float(q.get("theta", 0.0)), float(q.get("phi", 0.35)),
                            float(q.get("radius", 1.6)), int(q.get("size", 128)),
                        )
                        self._send(200, png, "image/png")
                    else:
                        self._send(404, b'{"error": "not found"}')
                except ValueError as e:  # bad query values or camera index
                    self._send(400, json.dumps({"error": str(e)}).encode())
                except Exception as e:  # the server keeps serving; the client sees why
                    self._send(500, json.dumps({"error": repr(e)}).encode())

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]

    def status(self) -> dict:
        return {
            "mode": "standalone",
            "port": self.port,
            "step": self.renderer.step,
            "num_cameras": len(self.renderer.cameras),
        }

    def render_eval_camera(self, cam: int, kind: str) -> bytes:
        if not 0 <= cam < len(self.renderer.cameras):
            raise ValueError(f"camera {cam} out of range [0, {len(self.renderer.cameras)})")
        if kind not in ("rgb", "depth"):
            raise ValueError(f"unknown kind {kind!r}")
        with self._render_lock:
            out = self.renderer.render_camera(cam)
        if kind == "depth":
            return images.encode_png(images.apply_depth_colormap(out["depth"], out["accumulation"]))
        return images.encode_png(out["rgb"])

    def render_orbit(self, theta: float, phi: float, radius: float, size: int) -> bytes:
        if not 1 <= size <= 4096:
            raise ValueError(f"size {size} outside [1, 4096]")
        origin = radius * np.array(
            [np.cos(theta) * np.cos(phi), np.sin(theta) * np.cos(phi), np.sin(phi)]
        )
        z = origin / np.linalg.norm(origin)
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x = x / max(np.linalg.norm(x), 1e-9)
        y = np.cross(z, x)
        c2w = np.stack([x, y, z, origin], axis=1)[None].astype(np.float32)
        f = size * 1.1
        cams_np = {
            "fx": np.array([f], np.float32), "fy": np.array([f], np.float32),
            "cx": np.array([size / 2], np.float32), "cy": np.array([size / 2], np.float32),
            "c2w": c2w, "width": np.array([size], np.int32),
            "height": np.array([size], np.int32),
        }
        cameras = DataparserOutputs([], cams_np, np.array([[-1.0] * 3, [1.0] * 3])).cameras(
            self.renderer.device)
        with self._render_lock:
            out = self.renderer.render_camera(0, cameras=cameras)
        return images.encode_png(out["rgb"])

    def serve_forever(self) -> None:
        """Serve on this thread until interrupted."""
        try:
            self._server.serve_forever()
        finally:
            self._server.server_close()

    def start(self) -> "ViewerServer":
        """Serve on a daemon thread."""
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        if self._thread is not None:  # shutdown() waits for a running serve_forever
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.server_close()
