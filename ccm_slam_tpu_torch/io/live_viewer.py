"""Live streaming viewer: the reference Viewer's continuous surface.

Counterpart of ``ccm_slam_tpu/io/live_viewer.py``.  The reference ``Viewer``
(cslam/src/Viewer.cpp, RunClient:156 / RunServer:194) publishes a continuous
stream of RViz markers (keyframe frusta, landmark clouds, trajectories, the
covisibility graph) and the annotated camera frame over image_transport.
Here an embedded HTTP server streams the same content to any browser; the
run calls ``publish_map`` / ``publish_frame`` from its loop:

  * ``GET /``              self-contained HTML canvas client (auto-refreshing)
  * ``GET /scene?since=N`` long-polls until the scene version exceeds N,
    then returns ``{"version": V, "scene": {...}}`` (``export.scene_dict``
    plus a sampled landmark cloud)
  * ``GET /frame.png``     the latest annotated camera frame (Viewer::DrawFrame)

A map handed to the viewer from another thread than the one that updates it
should be a ``host_copy``, taken on the updating thread.
"""

from __future__ import annotations

import dataclasses
import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..models import map_store as ms
from . import export

_PAGE = """<!doctype html>
<html><head><title>ccm_slam_tpu live viewer</title><style>
body{margin:0;background:#111;color:#ddd;font-family:monospace}
#bar{padding:6px 10px;background:#1a1a1a}
#wrap{display:flex;flex-wrap:wrap}
canvas{background:#181818;margin:8px}
img{margin:8px;max-width:47vw;image-rendering:pixelated}
</style></head><body>
<div id="bar">ccm_slam_tpu &mdash; <span id="stat">connecting&hellip;</span></div>
<div id="wrap"><canvas id="cv" width="900" height="700"></canvas>
<img id="fr" alt="(no camera frame yet)"></div>
<script>
const cv=document.getElementById('cv'),cx=cv.getContext('2d');
let ver=-1;
function proj(pts){ // pick the two highest-variance axes, fit to canvas
  if(!pts.length)return p=>[0,0];
  let n=pts.length,mu=[0,0,0],va=[0,0,0];
  for(const p of pts)for(let i=0;i<3;i++)mu[i]+=p[i]/n;
  for(const p of pts)for(let i=0;i<3;i++)va[i]+=(p[i]-mu[i])**2;
  const ax=[0,1,2].sort((a,b)=>va[b]-va[a]).slice(0,2).sort();
  let lo=[1e30,1e30],hi=[-1e30,-1e30];
  for(const p of pts){for(let i=0;i<2;i++){const v=p[ax[i]];
    lo[i]=Math.min(lo[i],v);hi[i]=Math.max(hi[i],v);}}
  const s=Math.min((cv.width-60)/Math.max(1e-6,hi[0]-lo[0]),
                   (cv.height-60)/Math.max(1e-6,hi[1]-lo[1]));
  return p=>[30+(p[ax[0]]-lo[0])*s, cv.height-30-(p[ax[1]]-lo[1])*s];
}
function draw(sc){
  cx.clearRect(0,0,cv.width,cv.height);
  let all=[];
  for(const k in sc.trajectories)all=all.concat(sc.trajectories[k].keyframes);
  if(sc.landmarks)all=all.concat(sc.landmarks.pos);
  const P=proj(all);
  if(sc.landmarks){cx.fillStyle='rgba(160,160,160,0.5)';
    for(const p of sc.landmarks.pos){const q=P(p);cx.fillRect(q[0],q[1],1,1);}}
  cx.strokeStyle='rgba(110,110,110,0.35)';cx.lineWidth=1;
  const C=sc.keyframe_centers;
  for(const e of sc.covisibility_edges){const a=C[e[0]],b=C[e[1]];
    if(!a||!b)continue;const qa=P(a),qb=P(b);
    cx.beginPath();cx.moveTo(qa[0],qa[1]);cx.lineTo(qb[0],qb[1]);cx.stroke();}
  for(const k in sc.trajectories){const t=sc.trajectories[k];
    cx.strokeStyle='rgb('+t.color.map(c=>c*255|0).join(',')+')';cx.lineWidth=2;
    cx.beginPath();t.keyframes.forEach((p,i)=>{const q=P(p);
      i?cx.lineTo(q[0],q[1]):cx.moveTo(q[0],q[1]);});cx.stroke();}
  cx.strokeStyle='#f33';cx.lineWidth=2;
  for(const e of sc.loop_edges){const a=C[e[0]],b=C[e[1]];
    if(!a||!b)continue;const qa=P(a),qb=P(b);
    cx.beginPath();cx.moveTo(qa[0],qa[1]);cx.lineTo(qb[0],qb[1]);cx.stroke();}
  document.getElementById('stat').textContent=
    sc.n_keyframes+' KFs, '+sc.n_landmarks+' landmarks, '
    +sc.loop_edges.length+' loop edges (v'+ver+')';
}
async function loop(){
  for(;;){try{
    const r=await fetch('/scene?since='+ver);
    if(r.status==200){const j=await r.json();
      if(j.version>ver){ver=j.version;draw(j.scene);
        document.getElementById('fr').src='/frame.png?v='+ver;}}
  }catch(e){await new Promise(s=>setTimeout(s,1000));}}
}
loop();
</script></body></html>"""


class LiveViewer:
    """Embedded HTTP scene streamer.  ``publish_*`` are thread-safe; the HTTP
    server runs on daemon threads."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._cond = threading.Condition()
        self._version = 0
        self._scene: dict | None = None
        self._frame_png: bytes | None = None
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silence per-request stderr spam
                pass

            def _send(self, code, ctype, body):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                url = urlparse(self.path)
                if url.path == "/":
                    self._send(200, "text/html", _PAGE.encode())
                elif url.path == "/scene":
                    q = parse_qs(url.query)
                    try:
                        since = int(q.get("since", ["-1"])[0])
                        timeout = float(q.get("timeout", ["10"])[0])
                    except ValueError:
                        self._send(400, "text/plain", b"bad query")
                        return
                    # clamp so one client cannot pin a handler thread
                    timeout = min(max(timeout, 0.0), 30.0)
                    with viewer._cond:
                        if viewer._version <= since:
                            viewer._cond.wait(timeout)
                        ver, scene = viewer._version, viewer._scene
                    if scene is None or ver <= since:
                        self._send(204, "application/json", b"")
                    else:
                        body = json.dumps({"version": ver, "scene": scene})
                        self._send(200, "application/json", body.encode())
                elif url.path == "/frame.png":
                    png = viewer._frame_png
                    if png is None:
                        self._send(404, "text/plain", b"no frame yet")
                    else:
                        self._send(200, "image/png", png)
                else:
                    self._send(404, "text/plain", b"not found")

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True, name="live-viewer"
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"http://{host}:{port}/"

    def publish_map(
        self,
        m: ms.MapState,
        covis_min_weight: int = 100,
        max_landmarks: int = 20000,
    ) -> int:
        """Snapshot a map state into the stream (PubTrajectories +
        PubCovGraph + PubMapPointsAsCloud equivalent).  Returns the new scene
        version."""
        scene = export.scene_dict(m, covis_min_weight=covis_min_weight)
        alive = export._np(m.mps.valid & ~m.mps.bad)
        pos = export._np(m.mps.pos)[alive]
        client = export._np(m.mps.client_id)[alive]
        if len(pos) > max_landmarks:  # deterministic stride subsample
            step = int(np.ceil(len(pos) / max_landmarks))
            pos, client = pos[::step], client[::step]
        scene["landmarks"] = {
            "pos": np.round(pos, 4).tolist(),
            "client": client.tolist(),
        }
        with self._cond:
            self._scene = scene
            self._version += 1
            self._cond.notify_all()
            return self._version

    def publish_frame(self, img, frame) -> None:
        """Annotated camera frame (Viewer::UpdateAndDrawFrame equivalent)."""
        rgb = export.annotate_frame(img, frame)
        from PIL import Image

        buf = io.BytesIO()
        Image.fromarray(rgb).save(buf, format="PNG")
        with self._cond:
            self._frame_png = buf.getvalue()

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def host_copy(x):
    """A copy of ``x`` on the host: every tensor of a map, a frame or any
    dataclass of tensors copied to the CPU, so later updates of ``x`` (in
    place or not, on any device) leave the copy as it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: host_copy(getattr(x, f.name))
                                         for f in dataclasses.fields(x) if f.init})
    return x
