"""Interactive online visualization: a live browser viewer.

The JAX package's ``io/viewer.py`` for the port's state: the driver runs the
simulation and serves a live, orbitable view over HTTP, standard library
only. It is the counterpart of the reference's GGUI window
(run_simulation.py:70-129 in jason-huang03/SPH_Project: ti.ui.Window +
orbiting camera + live particles), which needs a local display.

    python run_simulation_torch.py --scene_file ... --viewer 8000
    # open http://localhost:8000  (drag = orbit, wheel = zoom, r = reset)

Endpoints: ``/`` (viewer page), ``/frame.png`` (current render),
``/stats`` (JSON step/time/density telemetry), ``/ctl`` (camera control).
:meth:`LiveViewer.update` copies the fields it draws to the host once.
"""
from __future__ import annotations

import json
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from .exporters import png_bytes
from .render3d import render_particles

_PAGE = """<!doctype html>
<html><head><title>sph_project_tpu_torch live view</title><style>
body { margin:0; background:#14141a; color:#cfd3dc; font:13px monospace; }
#bar { padding:6px 10px; }
#view { display:block; margin:0 auto; cursor:grab; }
</style></head><body>
<div id="bar">sph_project_tpu_torch — drag to orbit, wheel to zoom, r to reset
  <span id="stats"></span></div>
<img id="view" width="%(w)d" height="%(h)d"/>
<script>
const img = document.getElementById('view');
let drag = null;
function refresh() { img.src = '/frame.png?ts=' + Date.now(); }
img.onload = () => setTimeout(refresh, 100);
img.onerror = () => setTimeout(refresh, 500);
refresh();
img.onmousedown = e => { drag = [e.clientX, e.clientY]; e.preventDefault(); };
window.onmouseup = () => drag = null;
window.onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  drag = [e.clientX, e.clientY];
  fetch(`/ctl?dyaw=${dx * 0.01}&dpitch=${dy * 0.01}`);
};
window.onwheel = e => fetch(`/ctl?dzoom=${e.deltaY > 0 ? 1.1 : 0.9}`);
window.onkeydown = e => { if (e.key == 'r') fetch('/ctl?reset=1'); };
setInterval(async () => {
  const s = await (await fetch('/stats')).json();
  document.getElementById('stats').textContent =
    ` | step ${s.step}  t=${s.t.toFixed(4)}s  ${s.steps_per_s.toFixed(2)} steps/s  rho_max ${s.rho_max.toFixed(0)}`;
}, 500);
</script></body></html>"""

_PALETTE = np.array(
    [(90, 140, 230), (230, 150, 90), (140, 220, 120), (220, 220, 120),
     (200, 120, 210), (120, 210, 210), (230, 120, 120), (170, 170, 170)],
    np.uint8)


class LiveViewer:
    """Serves a live orbitable particle view while the host loop steps."""

    def __init__(self, params, port: int = 8000, size=(800, 800)):
        self.params = params
        self.size = size
        lo = np.asarray(params.domain_start, np.float64)
        hi = np.asarray(params.domain_end, np.float64)
        if len(lo) == 2:
            lo, hi = np.append(lo, 0.0), np.append(hi, 0.0)
        self._target0 = (lo + hi) / 2.0
        self._dist0 = float(np.linalg.norm(hi - lo)) * 1.2
        self.yaw, self.pitch, self.dist = 0.8, 0.5, self._dist0
        self._lock = threading.Lock()
        self._png = png_bytes(np.zeros((size[1], size[0], 3), np.uint8))
        self._stats = {"step": 0, "t": 0.0, "steps_per_s": 0.0,
                       "rho_max": 0.0}
        self._pos = None
        self._obj = None
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                u = urlparse(self.path)
                if u.path == "/":
                    body = (_PAGE % {"w": size[0], "h": size[1]}).encode()
                    self._reply(200, "text/html", body)
                elif u.path == "/frame.png":
                    with viewer._lock:
                        body = viewer._png
                    self._reply(200, "image/png", body)
                elif u.path == "/stats":
                    with viewer._lock:
                        body = json.dumps(viewer._stats).encode()
                    self._reply(200, "application/json", body)
                elif u.path == "/ctl":
                    q = parse_qs(u.query)
                    viewer._ctl(q)
                    self._reply(200, "text/plain", b"ok")
                else:
                    self._reply(404, "text/plain", b"not found")

            def _reply(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", port), Handler)
        self.port = self._server.server_address[1]
        t = threading.Thread(target=self._server.serve_forever, daemon=True)
        t.start()

    def _ctl(self, q):
        redraw = False
        with self._lock:
            if "dyaw" in q:
                self.yaw += float(q["dyaw"][0])
                redraw = True
            if "dpitch" in q:
                self.pitch = float(np.clip(
                    self.pitch + float(q["dpitch"][0]), -1.4, 1.4))
                redraw = True
            if "dzoom" in q:
                self.dist = float(np.clip(self.dist * float(q["dzoom"][0]),
                                          0.1 * self._dist0, 5 * self._dist0))
                redraw = True
            if "reset" in q:
                self.yaw, self.pitch = 0.8, 0.5
                self.dist = self._dist0
                redraw = True
        if redraw:
            self._render()

    def _eye(self):
        cy, sy = math.cos(self.yaw), math.sin(self.yaw)
        cp, sp = math.cos(self.pitch), math.sin(self.pitch)
        d = self.dist
        return self._target0 + d * np.array([cy * cp, sp, sy * cp])

    def _render(self):
        with self._lock:
            pos, obj = self._pos, self._obj
            eye = tuple(self._eye())
        if pos is None:
            return
        img = zbuf = None
        for oid in np.unique(obj):
            sel = obj == oid
            img, zbuf = render_particles(
                pos[sel], size=self.size, eye=eye,
                target=tuple(self._target0),
                color=tuple(int(c) for c in _PALETTE[int(oid) % len(_PALETTE)]),
                img=img, zbuf=zbuf)
        png = png_bytes(img)
        with self._lock:
            self._png = png

    def update(self, state, steps_per_s: float = 0.0) -> None:
        """Snapshot the device state and refresh the served frame."""
        p = state.particles
        act = (p.material != 0).cpu().numpy()
        pos = p.pos.cpu().numpy().astype(np.float64)[act]
        if pos.shape[1] == 2:
            pos = np.concatenate([pos, np.zeros((len(pos), 1))], axis=1)
        dens = p.density.cpu().numpy()[act]
        with self._lock:
            self._pos = pos
            self._obj = p.object_id.cpu().numpy()[act]
            self._stats = {
                "step": int(state.step_count), "t": float(state.t),
                "steps_per_s": float(steps_per_s),
                "rho_max": float(dens.max()) if len(dens) else 0.0,
            }
        self._render()

    def close(self):
        self._server.shutdown()
