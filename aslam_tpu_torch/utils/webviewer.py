"""Live web viewer: the interactive replacement for the reference's
Pangolin thread (Drawer/viewer.cpp:27-91, mapdrawer.cpp).

Port of `aslam_tpu/utils/webviewer.py`: the same page, routes and JSON.  It
needs numpy only; `update` takes the port's MapState and trajectory as
tensors on any device (or arrays) and reads each back once, with `.cpu()`.

The reference renders the map in an OpenGL window on the SLAM machine; a
GPU server is headless, so the viewer is a tiny stdlib HTTP server streaming
map snapshots as JSON to a single-file canvas page:

  GET /        -> HTML page (top-down map, trajectory, HUD counters)
  GET /state   -> {"landmarks": [[x,y,z]..], "kfs": [[x,y,z]..],
                   "traj": [[x,y,z]..], "stats": {...}, "seq": N}

The SLAM loop decides when to publish (`update(...)` copies the device's
tensors once, e.g. every `--viewer-every` frames), and browsers poll the
host-side snapshot without touching the device.  No third-party
dependencies.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor on any device (one copy to the host) or an array -> numpy."""
    return np.asarray(x.cpu()) if hasattr(x, "cpu") else np.asarray(x)

_PAGE = """<!DOCTYPE html>
<html><head><title>aslam_tpu live map</title><style>
 body{margin:0;background:#111;color:#ddd;font:13px monospace}
 #hud{position:fixed;top:8px;left:8px;white-space:pre;background:#000a;
      padding:8px;border-radius:4px}
 #help{position:fixed;bottom:8px;left:8px;color:#888;background:#000a;
      padding:4px 8px;border-radius:4px}
 canvas{display:block;width:100vw;height:100vh}
</style></head><body>
<canvas id=c></canvas><div id=hud>connecting...</div>
<div id=help>drag: orbit &middot; shift-drag: pan &middot; wheel: zoom
 &middot; key 2/3: top-down / orbit</div>
<script>
// Interactive 3-D orbit viewer (the Pangolin render-loop equivalent,
// Drawer/viewer.cpp:27-91): landmarks as points, keyframes with viewing
// directions, trajectory polyline. Pure canvas, no dependencies.
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let st=null,mode=3,yaw=0.7,pitch=0.45,dist=8,panX=0,panY=0,ctr=[0,0,0];
let drag=null;
cv.addEventListener('mousedown',e=>{drag=[e.clientX,e.clientY,e.shiftKey];});
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panX+=dx*dist/600;panY+=dy*dist/600;}
 else{yaw+=dx*0.008;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*0.008));}
 drag=[e.clientX,e.clientY,drag[2]];});
addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);});
addEventListener('keydown',e=>{if(e.key==='2')mode=2;if(e.key==='3')mode=3;});
function center(pts){if(!pts.length)return [0,0,0];
 let s=[0,0,0];for(const p of pts){s[0]+=p[0];s[1]+=p[1];s[2]+=p[2];}
 return s.map(v=>v/pts.length);}
function proj(p){
 // world -> orbit camera -> perspective screen
 let x=p[0]-ctr[0],y=p[1]-ctr[1],z=p[2]-ctr[2];
 if(mode===2){ // top-down orthographic
  const s=Math.min(cv.width,cv.height)/(dist*1.2);
  return [cv.width/2+(x+panX)*s,cv.height/2-(z-panY)*s,1];}
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 let x1=cy*x+sy*z, z1=-sy*x+cy*z;
 let y1=cp*y-sp*z1, z2=sp*y+cp*z1;
 z2+=dist; x1+=panX; y1+=panY;
 if(z2<0.1)return null;
 const f=0.9*Math.min(cv.width,cv.height);
 return [cv.width/2+f*x1/z2, cv.height/2-f*y1/z2, z2];}
function draw(){
 cv.width=innerWidth;cv.height=innerHeight;
 ctx.fillStyle='#111';ctx.fillRect(0,0,cv.width,cv.height);
 if(st){
  ctx.fillStyle='#6cf';
  for(const p of st.landmarks){const q=proj(p);
   if(q){const r=mode===2?2:Math.max(1,3.5-q[2]*0.15);
    ctx.fillRect(q[0],q[1],r,r);}}
  ctx.strokeStyle='#fc3';ctx.lineWidth=2;ctx.beginPath();let started=false;
  for(const p of st.traj){const q=proj(p);
   if(q){started?ctx.lineTo(q[0],q[1]):ctx.moveTo(q[0],q[1]);started=true;}}
  ctx.stroke();
  ctx.strokeStyle='#f66';ctx.fillStyle='#f44';
  const fwd=st.kf_fwd||[];
  st.kfs.forEach((p,i)=>{const q=proj(p);if(!q)return;
   ctx.fillRect(q[0]-2,q[1]-2,5,5);
   if(fwd[i]){const t=[p[0]+fwd[i][0]*0.25,p[1]+fwd[i][1]*0.25,
                      p[2]+fwd[i][2]*0.25];
    const qt=proj(t);if(qt){ctx.beginPath();ctx.moveTo(q[0],q[1]);
     ctx.lineTo(qt[0],qt[1]);ctx.stroke();}}});
  document.getElementById('hud').textContent=
   Object.entries(st.stats).map(([k,v])=>k+': '+v).join('\\n');}
 requestAnimationFrame(draw);}
async function tick(){
 try{const r=await fetch('/state');const s=await r.json();
  if(!st||s.seq!==st.seq){st=s;
   const all=st.landmarks.concat(st.traj).concat(st.kfs);
   ctr=center(all);
   if(all.length){let m=0;
    for(const p of all){m=Math.max(m,Math.hypot(
     p[0]-ctr[0],p[1]-ctr[1],p[2]-ctr[2]));}
    if(dist===8&&m>0)dist=m*2.2;}}
 }catch(e){document.getElementById('hud').textContent='disconnected';}
 setTimeout(tick,500);}
draw();tick();
</script></body></html>"""


class WebViewer:
    """Serve live map state over HTTP.  Thread-safe `update` from the SLAM
    loop; `url` for the page; `stop()` to shut down."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 max_landmarks: int = 20000):
        self._lock = threading.Lock()
        self._state = {"landmarks": [], "kfs": [], "traj": [],
                       "stats": {}, "seq": 0}
        self._max_landmarks = max_landmarks
        viewer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path == "/state":
                    with viewer._lock:
                        body = json.dumps(viewer._state).encode()
                    ctype = "application/json"
                elif self.path == "/":
                    body = _PAGE.encode()
                    ctype = "text/html"
                else:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence request logging
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        h, p = self._server.server_address[:2]
        return f"http://{h}:{p}/"

    def update(self, m=None, traj=None, stats: dict | None = None) -> None:
        """Publish a snapshot.  m: MapState (its tensors are read once
        here: publish at a cadence, not per frame); traj: [N,4,4] T_cw or
        [N,3] camera positions; stats: HUD counters."""
        new = {}
        if m is not None:
            lm = _host(m.lm_pos)[_host(m.lm_valid)]
            if len(lm) > self._max_landmarks:
                lm = lm[:: len(lm) // self._max_landmarks + 1]
            kf_T = _host(m.kf_T_cw)[_host(m.kf_valid)]
            # camera center = -R^T t; viewing direction = R^T @ z
            kf_pos = -np.einsum("kij,ki->kj", kf_T[:, :3, :3], kf_T[:, :3, 3])
            kf_fwd = kf_T[:, 2, :3]          # row 2 of R == R^T @ [0,0,1]
            new["landmarks"] = np.round(lm, 4).tolist()
            new["kfs"] = np.round(kf_pos, 4).tolist()
            new["kf_fwd"] = np.round(kf_fwd, 4).tolist()
        if traj is not None:
            traj = _host(traj)
            if traj.ndim == 3:  # [N,4,4] T_cw
                traj = -np.einsum("kij,ki->kj", traj[:, :3, :3], traj[:, :3, 3])
            new["traj"] = np.round(traj, 4).tolist()
        if stats is not None:
            new["stats"] = {k: (round(v, 3) if isinstance(v, float) else v)
                            for k, v in stats.items()}
        with self._lock:
            self._state.update(new)
            self._state["seq"] += 1

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
