"""stdlib-HTTP interactive viewer: orbit camera + sliders + JPEG frames.

Port of ``sim_a_splat_tpu/viewer/server.py`` (standard library and numpy
only).  Endpoints:

- ``GET /``           single-page UI (canvas + sliders, no external deps)
- ``GET /frame.jpg``  latest rendered frame (re-rendered on camera/slider
                      change, cached otherwise)
- ``GET /state``      JSON {camera: {...}, sliders: {name: value}}
- ``POST /camera``    JSON orbit parameters {azim, elev, dist, target}
- ``POST /sliders``   JSON {name: value}

The render callback is the caller's and runs in the request thread, one
render at a time under a lock; it may return a numpy array or a tensor on
any device.  :func:`scene_render_fn` is the port's callback for a splat
scene: it renders through ``rasterize_sh``, so on the card through kernel
K1f, and what the browser shows is what the env observes.  Where PIL is
missing the frame is sent as a raw PPM, as the reference does; that is a
choice of image encoding on the host and touches no device or kernel.
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class SliderSpec:
    name: str
    lo: float
    hi: float
    value: float
    step: float = 0.01


def orbit_pose(azim: float, elev: float, dist: float,
               target: Sequence[float]):
    """Orbit-camera pose → (q wxyz, t) in the OpenCV convention the
    renderer uses (+z forward, +y down; ops/projection.py)."""
    ca, sa = np.cos(azim), np.sin(azim)
    ce, se = np.cos(elev), np.sin(elev)
    target = np.asarray(target, np.float64)
    # camera position on the orbit sphere
    fwd = np.asarray([ce * ca, ce * sa, -se])      # unit: camera → target
    pos = target - dist * fwd
    z = fwd                                        # +z looks at target
    x = np.cross(np.asarray([0.0, 0.0, 1.0]), z)
    n = np.linalg.norm(x)
    x = np.asarray([1.0, 0.0, 0.0]) if n < 1e-9 else x / n
    y = np.cross(z, x)                             # +y down-ish
    R = np.stack([x, y, z], axis=1)                # columns = camera axes
    # rotation matrix → quaternion (wxyz)
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-9:
        q = np.asarray([w, (R[2, 1] - R[1, 2]) / (4 * w),
                        (R[0, 2] - R[2, 0]) / (4 * w),
                        (R[1, 0] - R[0, 1]) / (4 * w)])
    else:                                          # w≈0 fallback
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(1e-12, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
        q = np.zeros(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = s / 4.0
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    q = q / np.linalg.norm(q)
    return q.astype(np.float32), pos.astype(np.float32)


_PAGE = """<!doctype html><html><head><meta charset="utf-8">
<title>sim-a-splat viewer</title><style>
body{font-family:sans-serif;background:#111;color:#ddd;margin:0;display:flex}
#view{flex:1;display:flex;align-items:center;justify-content:center}
img{max-width:100%%;image-rendering:pixelated;cursor:grab}
#panel{width:260px;padding:12px;background:#1c1c1c}
label{display:block;margin-top:10px;font-size:13px}
input[type=range]{width:100%%}</style></head><body>
<div id="view"><img id="frame" src="/frame.jpg"></div>
<div id="panel"><h3>sim-a-splat</h3><div id="sliders"></div>
<p style="font-size:12px;color:#888">drag: orbit &middot; wheel: zoom</p></div>
<script>
let cam=%(camera)s, sliders=%(sliders)s, busy=false, dirty=true;
const img=document.getElementById('frame');
async function refresh(){
  if(busy||!dirty) return; busy=true; dirty=false;
  img.src='/frame.jpg?t='+Date.now();
  await new Promise(r=>{img.onload=r; img.onerror=r}); busy=false;
}
setInterval(refresh, 50);
async function post(url, body){await fetch(url,{method:'POST',body:JSON.stringify(body)}); dirty=true;}
let drag=null;
img.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY];e.preventDefault()});
window.addEventListener('mouseup',()=>drag=null);
window.addEventListener('mousemove',e=>{
  if(!drag) return;
  cam.azim-=(e.clientX-drag[0])*0.01; cam.elev+=(e.clientY-drag[1])*0.01;
  cam.elev=Math.max(-1.5,Math.min(1.5,cam.elev));
  drag=[e.clientX,e.clientY]; post('/camera',cam);});
img.addEventListener('wheel',e=>{cam.dist*=Math.exp(e.deltaY*0.001);
  post('/camera',cam); e.preventDefault()});
const sd=document.getElementById('sliders');
for(const s of sliders){
  const l=document.createElement('label');
  l.textContent=s.name+' ';
  const v=document.createElement('span'); v.textContent=s.value.toFixed(2);
  const r=document.createElement('input');
  Object.assign(r,{type:'range',min:s.lo,max:s.hi,step:s.step,value:s.value});
  r.addEventListener('input',()=>{v.textContent=(+r.value).toFixed(2);
    post('/sliders',{[s.name]:+r.value});});
  l.appendChild(v); l.appendChild(r); sd.appendChild(l);
}
</script></body></html>"""


class SplatViewer:
    """Serve an interactive view of ``render_fn(q, t, sliders) → (H, W, 3)``
    float [0,1] image.  ``render_fn`` receives the orbit camera pose (wxyz
    quaternion + position, OpenCV convention) and the current slider dict.
    """

    def __init__(
        self,
        render_fn: Callable[[np.ndarray, np.ndarray, dict], np.ndarray],
        sliders: Optional[Sequence[SliderSpec]] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        azim: float = -1.57,
        elev: float = 0.5,
        dist: float = 4.0,
        target: Sequence[float] = (0.0, 0.0, 0.0),
    ):
        self.render_fn = render_fn
        self.sliders = {s.name: s for s in (sliders or [])}
        self.camera = {"azim": azim, "elev": elev, "dist": dist,
                       "target": list(target)}
        self._lock = threading.Lock()
        self._frame_cache: Optional[bytes] = None
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):     # quiet
                pass

            def _send(self, code, body, ctype="application/json"):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = self.path.split("?")[0]
                if path == "/":
                    page = _PAGE % {
                        "camera": json.dumps(viewer.camera),
                        "sliders": json.dumps(
                            [dataclasses.asdict(s)
                             for s in viewer.sliders.values()]),
                    }
                    self._send(200, page.encode(), "text/html")
                elif path == "/frame.jpg":
                    self._send(200, viewer.render_jpeg(), "image/jpeg")
                elif path == "/state":
                    self._send(200, json.dumps({
                        "camera": viewer.camera,
                        "sliders": {k: s.value
                                    for k, s in viewer.sliders.items()},
                    }).encode())
                else:
                    self._send(404, b"{}")

            def do_POST(self):
                n = int(self.headers.get("Content-Length", "0"))
                data = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/camera":
                    with viewer._lock:
                        viewer.camera.update(
                            {k: data[k] for k in
                             ("azim", "elev", "dist", "target") if k in data})
                        viewer._frame_cache = None
                    self._send(200, b"{}")
                elif self.path == "/sliders":
                    with viewer._lock:
                        for k, v in data.items():
                            if k in viewer.sliders:
                                viewer.sliders[k].value = float(v)
                        viewer._frame_cache = None
                    self._send(200, b"{}")
                else:
                    self._send(404, b"{}")

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address[:2]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/"

    def render_jpeg(self, quality: int = 85) -> bytes:
        with self._lock:
            if self._frame_cache is not None:
                return self._frame_cache
            cam = dict(self.camera)
            vals = {k: s.value for k, s in self.sliders.items()}
        q, t = orbit_pose(cam["azim"], cam["elev"], cam["dist"],
                          cam["target"])
        img = self.render_fn(q, t, vals)
        if hasattr(img, "detach"):         # a tensor, possibly on the card
            img = img.detach().cpu().numpy()
        img = np.asarray(img)
        u8 = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        try:
            from PIL import Image

            buf = io.BytesIO()
            Image.fromarray(u8).save(buf, "JPEG", quality=quality)
            data = buf.getvalue()
        except ImportError:                # PIL-less host: raw PPM fallback
            header = f"P6 {u8.shape[1]} {u8.shape[0]} 255\n".encode()
            data = header + u8.tobytes()
        with self._lock:
            self._frame_cache = data
        return data

    def invalidate(self) -> None:
        """Force a re-render on next frame request (scene state changed)."""
        with self._lock:
            self._frame_cache = None

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=2)


def scene_render_fn(scene, width: int = 320, height: int = 240,
                    fov: float = 1.05, raster=None, device="cuda"):
    """The viewer's render callback for a ``GaussianScene``: the orbit pose
    through ``rasterize_sh`` (kernel K1f on the card) at ``width`` ×
    ``height`` on a white background → (H, W, 3) image on ``device``.
    ``raster`` defaults to K = 1,024, 3σ.  Sliders are not read."""
    import torch

    from sim_a_splat_torch import resolve_device
    from sim_a_splat_torch.ops.projection import Camera
    from sim_a_splat_torch.ops.rasterize_tiles import (
        RasterConfig, rasterize_sh,
    )
    from sim_a_splat_torch.ops.transforms import SE3

    dev = resolve_device(device)
    scene = scene.to(dev)
    cfg = raster or RasterConfig(tile_capacity=1024, sigma_cutoff=3.0)
    white = torch.ones(3, device=dev)
    covs = scene.covs()

    def render(q, t, sliders):
        cam = Camera.from_fov(SE3(torch.as_tensor(q, device=dev),
                                  torch.as_tensor(t, device=dev)),
                              fov, width, height)
        with torch.no_grad():
            img, _ = rasterize_sh(scene.means, covs, scene.sh_coeffs(),
                                  scene.opacities(), cam, scene.sh_degree,
                                  cfg, background=white)
        return img

    return render
