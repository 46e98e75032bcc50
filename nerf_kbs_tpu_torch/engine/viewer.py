"""The viewer: an HTTP and RFC-6455 WebSocket server that renders eval
cameras and free orbit cameras on demand (the JAX package's
``engine/viewer.py``; the transport is the stdlib's, as there).

Two modes:

- **standalone** (``python -m nerf_kbs_tpu_torch.engine.cli <method> --serve
  7007 --trainer.load_dir ...``): renders from a checkpoint;
- **during training** (``--viewer-port N``, or ``--trainer.vis viewer``,
  which means 7007): a daemon thread renders live while the training loop
  steps. ``Trainer.render_camera`` renders a copy of the parameters of one
  completed step (``Trainer.snapshot``), and a lock keeps at most one
  render in flight.

The page (GET /) is a free-camera navigator: drag orbits (theta, phi), the
wheel zooms, and with "live re-render" the pose renders again whenever
training advances. Over the WebSocket (GET /ws) the server pushes a status
JSON text frame whenever the training step advances, the client sends
{"type": "pose", theta, phi, radius, size} messages and gets binary PNG
frames back ({"type": "status"} asks for a status frame). The plain-HTTP
endpoints stay as the fallback and as a scriptable API:

  GET /            the HTML page
  GET /ws          WebSocket upgrade (status push + pose -> PNG frames)
  GET /status      JSON {mode, port, step, num_eval_images, num_dumps,
                   latest_dump, last_metrics}
  GET /render?cam=0&kind=rgb|depth                  eval-camera render
  GET /orbit?theta=0&phi=0.35&radius=1.6&size=128   free-orbit render
  GET /latest?kind=rgb|depth                        newest eval dump

A bad camera index, size or kind answers 400. The server binds loopback
unless ``host`` (or ``NKT_VIEWER_HOST``) says otherwise; port 0 takes a
free port (``self.port`` reports it).
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from urllib.parse import parse_qs, urlparse

import numpy as np

from nerf_kbs_tpu_torch.data.outputs import DataparserOutputs
from nerf_kbs_tpu_torch.utils import images

# ------------------------------------------------------------- websocket
# RFC-6455 server-side framing (stdlib only)

_WS_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"


def ws_accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + _WS_GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def ws_send_frame(sock, payload: bytes, opcode: int) -> None:
    """One unfragmented, unmasked server->client frame (FIN set).

    Sends under its own generous timeout: the caller keeps a short recv
    timeout for idle polling, but a large PNG frame to a slow client can
    legitimately block sendall for seconds — inheriting the 0.5 s poll
    timeout would raise mid-send and kill the session."""
    head = bytes([0x80 | opcode])
    n = len(payload)
    if n < 126:
        head += bytes([n])
    elif n < 1 << 16:
        head += bytes([126]) + struct.pack(">H", n)
    else:
        head += bytes([127]) + struct.pack(">Q", n)
    prev = sock.gettimeout()
    sock.settimeout(30.0)
    try:
        sock.sendall(head + payload)
    finally:
        try:
            sock.settimeout(prev)
        except OSError:
            pass


class _BufferedSocket:
    """Socket facade serving bytes the HTTP handler's BufferedReader had
    already consumed (a client may pipeline its first WS frame with the
    upgrade request in one TCP segment) before reading the real socket."""

    def __init__(self, sock, initial: bytes = b""):
        self._sock = sock
        self._initial = initial

    def recv(self, n: int) -> bytes:
        if self._initial:
            out, self._initial = self._initial[:n], self._initial[n:]
            return out
        return self._sock.recv(n)

    def sendall(self, data) -> None:
        return self._sock.sendall(data)

    def settimeout(self, t) -> None:
        return self._sock.settimeout(t)

    def gettimeout(self):
        return self._sock.gettimeout()


def _read_exact(sock, n: int):
    """Read exactly n bytes. Raises TimeoutError only when NO bytes have
    arrived yet (idle between frames); once a frame has started, retries
    through timeouts (bounded) so a short socket timeout cannot corrupt
    frame sync mid-read. Returns None on EOF / dead peer."""
    buf = b""
    stalls = 0
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except (socket.timeout, TimeoutError):
            if not buf:
                raise
            stalls += 1
            if stalls > 240:  # ~2 min mid-frame silence: peer is gone
                return None
            continue
        if not chunk:
            return None
        buf += chunk
        stalls = 0
    return buf


# Largest client->server frame we accept. Inbound traffic is small JSON
# pose/status messages; anything bigger is a hostile or desynced peer and
# must fail the session instead of buffering gigabytes in _read_exact.
WS_MAX_FRAME = 1 << 20


def ws_recv_frame(sock):
    """Receive one frame -> (opcode, payload, fin). None on EOF / oversized
    frame; propagates TimeoutError when the connection is idle (no frame
    started)."""
    hdr = _read_exact(sock, 2)
    if hdr is None:
        return None
    fin = bool(hdr[0] & 0x80)
    opcode = hdr[0] & 0x0F
    masked = bool(hdr[1] & 0x80)
    n = hdr[1] & 0x7F
    if n == 126:
        ext = _read_exact(sock, 2)
        if ext is None:
            return None
        n = struct.unpack(">H", ext)[0]
    elif n == 127:
        ext = _read_exact(sock, 8)
        if ext is None:
            return None
        n = struct.unpack(">Q", ext)[0]
    if n > WS_MAX_FRAME:
        return None
    mask = b"\x00" * 4
    if masked:  # client->server frames are always masked (RFC 6455 §5.1)
        mask = _read_exact(sock, 4)
        if mask is None:
            return None
    payload = _read_exact(sock, n) if n else b""
    if payload is None:
        return None
    if masked and n:
        payload = bytes(c ^ mask[i & 3] for i, c in enumerate(payload))
    return opcode, payload, fin

_PAGE = """<!doctype html><html><head><title>nerf-kbs-tpu viewer</title></head>
<body style="font-family:monospace;background:#111;color:#ddd">
<h3>nerf-kbs-tpu viewer</h3>
<div id="status" style="white-space:pre-wrap;font-size:11px"></div>
<div style="margin:6px 0">
 cam <input id="cam" type="number" value="0" min="0" style="width:4em">
 kind <select id="kind"><option>rgb</option><option>depth</option></select>
 <button onclick="renderCam()">eval cam</button>
 &nbsp;|&nbsp; size <select id="size"><option>128</option><option selected>192</option><option>256</option><option>384</option></select>
 <label><input id="live" type="checkbox" checked> live re-render</label>
 <span id="pose" style="color:#8c8"></span>
</div>
<p><img id="im" draggable="false"
   style="max-width:95%;image-rendering:pixelated;cursor:grab;touch-action:none;user-select:none"></p>
<div style="color:#888">drag = orbit &middot; wheel = zoom &middot; live re-renders as training advances</div>
<script>
// Continuous free-camera navigation: drag updates (theta, phi), wheel
// updates radius; at most one render request in flight, latest wins.
// Transport: WebSocket (server pushes status on step advance; pose
// messages out, binary PNG frames back) with plain-HTTP fallback.
let th=0, ph=0.35, r=1.6, inflight=false, inflightSince=0, dirty=true, lastStep=-1;
let ws=null, wsOpen=false;
const im=document.getElementById('im');
function poseStr(){return 'th='+th.toFixed(2)+' ph='+ph.toFixed(2)+' r='+r.toFixed(2);}
function showFrame(blob){
  const prev=im.src;
  im.src=URL.createObjectURL(blob);
  if(prev.startsWith('blob:')){URL.revokeObjectURL(prev);}
  document.getElementById('pose').textContent=poseStr();
}
function onStatus(s){
  document.getElementById('status').textContent=JSON.stringify(s);
  if(document.getElementById('live').checked && s.step!==undefined && s.step!==lastStep){
    lastStep=s.step; dirty=true;
  }
}
function connectWS(){
  if(!window.WebSocket){return;}
  try{ws=new WebSocket('ws://'+location.host+'/ws');}catch(e){return;}
  ws.binaryType='blob';
  ws.onopen=()=>{wsOpen=true;};
  ws.onclose=ws.onerror=()=>{wsOpen=false; ws=null; inflight=false;};
  ws.onmessage=(ev)=>{
    if(typeof ev.data==='string'){onStatus(JSON.parse(ev.data));}
    else{showFrame(ev.data); inflight=false;}
  };
}
connectWS();
async function pump(){
  // watchdog: a pose frame the server never answers (dropped message,
  // half-dead socket) must not freeze live rendering forever
  if(inflight && Date.now()-inflightSince>6000){inflight=false; dirty=true;}
  if(inflight||!dirty){return;}
  inflight=true; inflightSince=Date.now(); dirty=false;
  const size=document.getElementById('size').value;
  if(wsOpen){
    ws.send(JSON.stringify({type:'pose',theta:th,phi:ph,radius:r,size:+size}));
    return; // the binary reply clears inflight
  }
  const url='/orbit?theta='+th+'&phi='+ph+'&radius='+r+'&size='+size+'&t='+Date.now();
  try{ showFrame(await (await fetch(url)).blob()); }catch(e){}
  inflight=false;
}
setInterval(pump, 120);
let drag=null;
im.addEventListener('pointerdown', e=>{drag=[e.clientX,e.clientY]; im.setPointerCapture(e.pointerId);});
im.addEventListener('pointermove', e=>{
  if(!drag) return;
  th-=(e.clientX-drag[0])*0.01;
  ph=Math.max(-1.4, Math.min(1.4, ph+(e.clientY-drag[1])*0.01));
  drag=[e.clientX,e.clientY]; dirty=true;
});
im.addEventListener('pointerup', ()=>{drag=null;});
im.addEventListener('wheel', e=>{e.preventDefault(); r=Math.max(0.2, r*(e.deltaY>0?1.08:0.93)); dirty=true;});
function renderCam(){
  const c=document.getElementById('cam').value, k=document.getElementById('kind').value;
  im.src='/render?cam='+c+'&kind='+k+'&t='+Date.now();
}
async function refresh(){
  if(wsOpen){return;} // server pushes status over the websocket
  try{ onStatus(await (await fetch('/status')).json()); }catch(e){}
}
refresh(); setInterval(refresh, 2000);
</script></body></html>"""




class ViewerServer:
    """Serves ``trainer``: a ``Trainer`` (live or from a checkpoint) or a
    ``Renderer``, anything with ``render_camera(idx, cameras=None)``,
    ``eval_cameras``, ``step`` and ``device``. ``eval_image_dir`` (the
    trainer's eval_images/) feeds /latest and, with the metrics.jsonl
    beside it, the status."""

    def __init__(self, trainer=None, eval_image_dir: str | None = None, port: int = 7007,
                 host: str | None = None, mode: str = "standalone"):
        if host is None:
            host = os.environ.get("NKT_VIEWER_HOST", "127.0.0.1")
        self.trainer = trainer
        self.mode = mode
        self.eval_image_dir = Path(eval_image_dir) if eval_image_dir else None
        self.host = host
        self._render_lock = threading.Lock()
        self._thread: threading.Thread | None = None
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 for the 101 Switching Protocols upgrade
            protocol_version = "HTTP/1.1"

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
                    if u.path == "/":
                        self._send(200, _PAGE.encode(), "text/html")
                    elif u.path == "/ws":
                        viewer._ws_session(self)
                    elif u.path == "/status":
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
                    elif u.path == "/latest":
                        png = viewer.latest_dump(q.get("kind", "rgb"))
                        if png is None:
                            self._send(404, b'{"error": "no eval dumps yet"}')
                        else:
                            self._send(200, png, "image/png")
                    else:
                        self._send(404, b'{"error": "not found"}')
                except ValueError as e:  # bad query values, camera index, size or kind
                    self._send(400, json.dumps({"error": str(e)}).encode())
                except Exception as e:  # the server keeps serving; the client sees why
                    self._send(500, json.dumps({"error": repr(e)}).encode())

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]

    # ------------------------------------------------------------- handlers
    def status(self) -> dict:
        out = {"mode": self.mode, "port": self.port}
        if self.trainer is not None:
            out["step"] = self.trainer.step
            out["num_eval_images"] = len(self.trainer.eval_cameras)
        if self.eval_image_dir is not None and self.eval_image_dir.exists():
            dumps = sorted(self.eval_image_dir.glob("*_rgb.png"))
            out["num_dumps"] = len(dumps)
            if dumps:
                out["latest_dump"] = dumps[-1].name
        metrics_file = (self.eval_image_dir.parent / "metrics.jsonl"
                        if self.eval_image_dir is not None else None)
        if metrics_file is not None and metrics_file.exists():
            try:
                last = metrics_file.read_text().strip().rsplit("\n", 1)[-1]
                out["last_metrics"] = json.loads(last)
            except (OSError, json.JSONDecodeError):  # a line being written
                pass
        return out

    def _require_trainer(self):
        if self.trainer is None:
            raise RuntimeError("no trainer attached: rendering unavailable")
        return self.trainer

    def render_eval_camera(self, cam: int, kind: str) -> bytes:
        trainer = self._require_trainer()
        n = len(trainer.eval_cameras)
        if not 0 <= cam < n:
            raise ValueError(f"camera {cam} out of range [0, {n})")
        if kind not in ("rgb", "depth"):
            raise ValueError(f"unknown kind {kind!r}")
        with self._render_lock:
            outputs = trainer.render_camera(cam)
        return self._encode(outputs, kind)

    def render_orbit(self, theta: float, phi: float, radius: float, size: int) -> bytes:
        trainer = self._require_trainer()
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
            trainer.device)
        with self._render_lock:
            outputs = trainer.render_camera(0, cameras=cameras)
        return self._encode(outputs, "rgb")

    def _ws_session(self, handler) -> None:
        """RFC-6455 session: handshake, then serve until close. Pushes a
        status text frame whenever the training step advances (checked when
        the socket has been idle for 0.5 s); answers {"type": "pose"} with a
        binary PNG frame and {"type": "status"} with a status frame; pings
        with pongs, fragmented messages reassembled, a close echoed. Runs on
        the connection's thread."""
        key = handler.headers.get("Sec-WebSocket-Key")
        upgrade = handler.headers.get("Upgrade", "").lower()
        if upgrade != "websocket" or not key:
            handler._send(426, b'{"error": "websocket upgrade required"}')
            return
        handler.send_response(101, "Switching Protocols")
        handler.send_header("Upgrade", "websocket")
        handler.send_header("Connection", "Upgrade")
        handler.send_header("Sec-WebSocket-Accept", ws_accept_key(key))
        handler.end_headers()
        handler.close_connection = True  # the socket is the session's now
        raw = handler.connection
        # bytes the handler's buffered reader took past the request head (a
        # client may pipeline its first frame with the upgrade): drained
        # without blocking and served before the socket
        pipelined = b""
        try:
            raw.setblocking(False)
            while True:
                chunk = handler.rfile.read1(65536)
                if not chunk:
                    break
                pipelined += chunk
        except (BlockingIOError, OSError, ValueError):
            pass
        finally:
            raw.setblocking(True)
        sock = _BufferedSocket(raw, pipelined)
        sock.settimeout(0.5)  # the cadence of idle status pushes
        frag_op, frag_buf = None, b""
        try:
            st = self.status()
            last_step = st.get("step")
            ws_send_frame(sock, json.dumps(st).encode(), 0x1)
            while True:
                try:
                    frame = ws_recv_frame(sock)
                except (socket.timeout, TimeoutError):
                    # idle: the step counter first, the whole status (a glob
                    # and a file read) only when it moved
                    step = self.trainer.step if self.trainer is not None else None
                    if step != last_step:
                        st = self.status()
                        last_step = st.get("step")
                        ws_send_frame(sock, json.dumps(st).encode(), 0x1)
                    continue
                if frame is None:
                    return
                opcode, payload, fin = frame
                if opcode == 0x8:  # close: echo and finish
                    try:
                        ws_send_frame(sock, payload[:2], 0x8)
                    except OSError:
                        pass
                    return
                if opcode == 0x9:  # ping -> pong
                    ws_send_frame(sock, payload, 0xA)
                    continue
                if opcode == 0x0:  # continuation of a fragmented message
                    if frag_op is None:
                        continue  # stray continuation: dropped
                    frag_buf += payload
                    if not fin:
                        continue
                    opcode, payload = frag_op, frag_buf
                    frag_op, frag_buf = None, b""
                elif not fin:  # first fragment
                    frag_op, frag_buf = opcode, payload
                    continue
                if opcode != 0x1:  # binary frames and pongs are ignored
                    continue
                try:
                    msg = json.loads(payload.decode())
                except (UnicodeDecodeError, json.JSONDecodeError):
                    continue
                if msg.get("type") == "pose":
                    png = self.render_orbit(
                        float(msg.get("theta", 0.0)), float(msg.get("phi", 0.35)),
                        float(msg.get("radius", 1.6)), int(msg.get("size", 128)),
                    )
                    ws_send_frame(sock, png, 0x2)
                elif msg.get("type") == "status":
                    st = self.status()
                    last_step = st.get("step")
                    ws_send_frame(sock, json.dumps(st).encode(), 0x1)
        except OSError:  # the peer is gone
            return
        except Exception as e:
            # past the handshake no HTTP error can be sent: a failed render
            # ends the session, reported here
            print(f"viewer: websocket session error: {e!r}", flush=True)

    def latest_dump(self, kind: str) -> bytes | None:
        if self.eval_image_dir is None or not self.eval_image_dir.exists():
            return None
        dumps = sorted(self.eval_image_dir.glob(f"*_{kind}.png"))
        return dumps[-1].read_bytes() if dumps else None

    @staticmethod
    def _encode(outputs: dict, kind: str) -> bytes:
        if kind == "depth":
            return images.encode_png(images.apply_depth_colormap(outputs["depth"],
                                                                 outputs.get("accumulation")))
        return images.encode_png(outputs["rgb"])

    # ------------------------------------------------------------ lifecycle
    def serve_forever(self) -> None:
        """Serve on this thread until interrupted."""
        print(f"viewer listening on http://{self.host}:{self.port}", flush=True)
        try:
            self._server.serve_forever()
        finally:
            self._server.server_close()

    def start_background(self) -> threading.Thread:
        """Serve on a daemon thread."""
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self._thread

    def shutdown(self) -> None:
        if self._thread is not None:  # shutdown() waits for a running serve_forever
            self._server.shutdown()
            self._thread.join(timeout=10)
        self._server.server_close()
