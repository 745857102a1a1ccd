"""Interactive display path, the counterpart of ``tpu_rt.bench.viewer``: a
small HTTP orbit viewer in place of the reference's GL window (App.cc:62-132,
Renderer.cc:421-445; shipped disabled, ``DISPLAY_RESULT 0``, App.cc:42).  The
Renderer stays on the card's host, a browser orbits the camera with the
mouse, and every drag fetches a freshly traced frame.  No server dependency
outside the standard library (PNG via Pillow when it imports, else BMP).

    python -m tpu_rt_torch.bench.cli --scene bunny --serve 8787
    # then open http://localhost:8787/

Endpoints:
    GET /                 the orbit-viewer page
    GET /frame?yaw=&pitch=&dist=&w=&h=&ray_type=&samples=
                          rendered frame as PNG (or BMP), plus
                          X-Mrays-Per-S / X-Trace-Ms headers; a bad query
                          gets 400 with a JSON error

Unlike ``tpu_rt``'s viewer, a request's ``w`` and ``h`` are held to
[1, MAX_SIDE] and ``samples`` to [1, MAX_SAMPLES] (beyond them: 400, and no
Renderer is made), and at most MAX_RENDERERS renderers are kept, the least
recently used one freed first.
"""

from __future__ import annotations

import contextlib
import io
import json
import threading
from collections import OrderedDict
from dataclasses import replace
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

# Largest frame side and samples per pixel a request may ask for, and the
# renderers (one per size, ray type and samples) kept at once.
MAX_SIDE = 4096
MAX_SAMPLES = 64
MAX_RENDERERS = 4

_PAGE = """<!doctype html>
<title>tpu_rt viewer</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px monospace; }
 #hud { position:fixed; top:8px; left:8px; }
 img { display:block; margin:0 auto; image-rendering:pixelated; }
</style>
<div id="hud">drag to orbit &middot; wheel to zoom &middot; <span id="s"></span></div>
<img id="v" width="640" height="480">
<script>
let yaw=0, pitch=0.3, dist=1.0, busy=false, dirty=true;
const img=document.getElementById('v'), hud=document.getElementById('s');
async function refresh(){
  if(busy){dirty=true;return;} busy=true; dirty=false;
  const u=`/frame?yaw=${yaw.toFixed(3)}&pitch=${pitch.toFixed(3)}&dist=${dist.toFixed(3)}`;
  const r=await fetch(u); const b=await r.blob();
  hud.textContent=`${r.headers.get('X-Mrays-Per-S')} Mray/s, ${r.headers.get('X-Trace-Ms')} ms trace`;
  img.src=URL.createObjectURL(b);
  busy=false; if(dirty) refresh();
}
let drag=null;
img.onmousedown=e=>{drag=[e.clientX,e.clientY];};
window.onmouseup=()=>{drag=null;};
window.onmousemove=e=>{ if(!drag) return;
  yaw+=(e.clientX-drag[0])*0.01; pitch+=(e.clientY-drag[1])*0.01;
  pitch=Math.max(-1.5,Math.min(1.5,pitch)); drag=[e.clientX,e.clientY]; refresh(); };
window.onwheel=e=>{ dist*=Math.exp(e.deltaY*0.001); refresh(); };
refresh();
</script>
"""


def _encode_image(img_u8: np.ndarray) -> tuple[bytes, str]:
    """[h,w,3] u8 -> (bytes, content_type); PNG via Pillow, BMP fallback."""
    try:
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(img_u8, "RGB").save(buf, "PNG")
        return buf.getvalue(), "image/png"
    except ImportError:
        h, w, _ = img_u8.shape
        row = w * 3 + (-w * 3) % 4
        data = np.zeros((h, row), np.uint8)
        data[:, : w * 3] = img_u8[::-1, :, ::-1].reshape(h, w * 3)  # BGR, bottom-up
        head = (b"BM" + (54 + data.size).to_bytes(4, "little") + b"\0\0\0\0"
                + (54).to_bytes(4, "little") + (40).to_bytes(4, "little")
                + w.to_bytes(4, "little") + h.to_bytes(4, "little")
                + (1).to_bytes(2, "little") + (24).to_bytes(2, "little")
                + b"\0" * 24)
        return head + data.tobytes(), "image/bmp"


def _in_range(name: str, value: int, hi: int) -> int:
    if not 1 <= value <= hi:
        raise ValueError(f"{name} must be in [1, {hi}], got {value}")
    return value


class ViewerState:
    """Owns the scene and up to MAX_RENDERERS Renderers, one per (size,
    ray_type, samples), the least recently used freed first; renders orbit
    frames on demand.  One render at a time (the card is a single
    resource), guarded by a lock, on the state's device: a ``"cuda"``
    without an index is the current card when the state is made, and the
    server's handler threads render on that card."""

    def __init__(self, scene, width=640, height=480, params=None):
        from tpu_rt_torch.renderer import RendererParams

        self.scene = scene
        self.width = width
        self.height = height
        base = params or RendererParams()
        self.device = torch.device(base.device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.base = replace(base, device=str(self.device))
        self.lock = threading.Lock()
        self._renderers: OrderedDict = OrderedDict()
        lo, hi = scene.bbox()
        self.center = (np.asarray(lo) + np.asarray(hi)) * 0.5
        self.size = float(np.linalg.norm(np.asarray(hi) - np.asarray(lo))) or 1.0

    def camera(self, yaw: float, pitch: float, dist: float):
        from tpu_rt_torch.scene import Camera

        cp, sp = np.cos(pitch), np.sin(pitch)
        offset = np.array([np.sin(yaw) * cp, sp, np.cos(yaw) * cp], np.float32)
        position = self.center + offset * np.float32(self.size * 0.75 * dist)
        fwd = (self.center - position).astype(np.float32)
        fwd /= np.linalg.norm(fwd)
        return Camera(position=position.astype(np.float32), forward=fwd,
                      up=np.array([0.0, 1.0, 0.0], np.float32), fov=70.0,
                      near=self.size * 0.0005, far=self.size * 1.5)

    def _renderer(self, w, h, ray_type, samples):
        from tpu_rt_torch.renderer import Renderer

        key = (w, h, ray_type, samples)
        r = self._renderers.get(key)
        if r is None:
            _in_range("w", w, MAX_SIDE)
            _in_range("h", h, MAX_SIDE)
            _in_range("samples", samples, MAX_SAMPLES)
            r = Renderer(w, h, replace(self.base, ray_type=ray_type,
                                       num_samples=samples))
            r.set_scene(self.scene)
            self._renderers[key] = r
            while len(self._renderers) > MAX_RENDERERS:
                self._renderers.popitem(last=False)[1].free()
        self._renderers.move_to_end(key)
        return r

    def render(self, yaw=0.0, pitch=0.3, dist=1.0, w=None, h=None,
               ray_type=None, samples=None) -> tuple[np.ndarray, dict]:
        on_card = (torch.cuda.device(self.device) if self.device.type == "cuda"
                   else contextlib.nullcontext())
        with self.lock, on_card:
            r = self._renderer(w or self.width, h or self.height,
                               ray_type or self.base.ray_type,
                               samples or self.base.num_samples)
            stats = r.render_frame(self.camera(yaw, pitch, dist))
            img = r.update_result()
        u8 = (np.clip(img[..., :3], 0, 1) * 255).astype(np.uint8)
        return u8, stats


def make_server(state: ViewerState, host: str = "127.0.0.1",
                port: int = 8787) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def _send(self, code: int, body: bytes, ctype: str, headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            u = urlparse(self.path)
            if u.path == "/":
                self._send(200, _PAGE.encode(), "text/html")
                return
            if u.path == "/frame":
                q = {k: v[0] for k, v in parse_qs(u.query).items()}
                try:
                    img, stats = state.render(
                        yaw=float(q.get("yaw", 0)),
                        pitch=float(q.get("pitch", 0.3)),
                        dist=float(q.get("dist", 1)),
                        w=int(q["w"]) if "w" in q else None,
                        h=int(q["h"]) if "h" in q else None,
                        ray_type=q.get("ray_type"),
                        samples=int(q["samples"]) if "samples" in q else None)
                except Exception as e:  # noqa: BLE001
                    self._send(400, json.dumps({"error": str(e)}).encode(),
                               "application/json")
                    return
                body, ctype = _encode_image(img)
                self._send(200, body, ctype, (
                    ("X-Mrays-Per-S", f"{stats['mrays_per_s']:.4g}"),
                    ("X-Trace-Ms", f"{stats['trace_time_s'] * 1e3:.1f}")))
                return
            self.send_response(404)
            self.end_headers()

    return ThreadingHTTPServer((host, port), Handler)


def serve(state: ViewerState, host: str = "127.0.0.1", port: int = 8787):
    """Blocking serve (the CLI entry point)."""
    srv = make_server(state, host, port)
    print(f"tpu_rt_torch viewer on http://{host}:{srv.server_address[1]}/ "
          f"({state.scene.num_triangles} tris, {state.device})")
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.server_close()
