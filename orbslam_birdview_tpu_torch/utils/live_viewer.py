"""Live interactive map viewer: an HTTP side-car with a browser canvas UI.

The JAX package's `utils/live_viewer.py` on the port: the reference's
Pangolin viewer thread (`src/Viewer.cc`) as a live 3D view of map points,
keyframe frusta, the covisibility graph and the current camera, with the
same menu surface — Follow Camera, Show Points / KeyFrames / Graph,
Localization Mode toggle, Reset — plus the `FrameDrawer::DrawFrame`
current-frame overlay (`src/FrameDrawer.cc`), encoded by the port's PNG
writer.

Design for this stack: the reference renders on a dedicated GL thread at
30 fps, mutex-reading tracker/map state. Here the render loop lives in the
BROWSER (a ~2 kB canvas app polling JSON snapshots at 10 Hz); the process
side is a stdlib `ThreadingHTTPServer` on a daemon thread that serializes
read-only numpy snapshots of the map store. Nothing touches the device or
drains the lag-N pipeline — state reads use `peek_tracking_state`-style
non-flushing access, so attaching the viewer does not perturb the
overlapped tracking/mapping pipeline it is observing.

Usage:
    viewer = LiveViewer(system)          # port=0 -> OS-assigned
    viewer.start()
    ...
    viewer.update_frame(gray_img, fd)    # optional per-frame overlay
    viewer.stop()

CLI: `run_slam.py --live-viewer PORT`.
"""
from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

MAX_POINTS = 20000     # per-snapshot point cap (browser payload bound)
MAX_EDGES = 4000       # covisibility edges cap
COVIS_MIN_W = 100      # reference draws the graph at weight>=100
                       # (src/MapDrawer.cc covisibility threshold)

_PAGE = """<!DOCTYPE html>
<html><head><title>orbslam_birdview_tpu — live map</title><style>
 body{margin:0;background:#101014;color:#ddd;font:12px sans-serif;
      display:flex;height:100vh;overflow:hidden}
 #side{width:220px;padding:10px;background:#191920;overflow-y:auto}
 #side label{display:block;margin:6px 0;cursor:pointer}
 #side button{margin:4px 2px;padding:4px 10px;background:#2a2a35;
      color:#ddd;border:1px solid #444;border-radius:3px;cursor:pointer}
 #c{flex:1;display:block}
 #frame{width:200px;margin-top:8px;border:1px solid #333}
 .stat{color:#8bc;margin:2px 0}
</style></head><body>
<div id="side">
 <h3 style="margin:4px 0">live map</h3>
 <div class="stat" id="state">state: —</div>
 <div class="stat" id="counts"></div>
 <label><input type="checkbox" id="follow" checked> Follow Camera</label>
 <label><input type="checkbox" id="showpts" checked> Show Points</label>
 <label><input type="checkbox" id="showkfs" checked> Show KeyFrames</label>
 <label><input type="checkbox" id="showgraph" checked> Show Graph</label>
 <label><input type="checkbox" id="showbird" checked> Show Bird Points</label>
 <label><input type="checkbox" id="loc"> Localization Mode</label>
 <button id="reset">Reset</button>
 <img id="frame" src="" alt="">
 <div style="color:#777;margin-top:6px">drag = orbit, wheel = zoom</div>
</div>
<canvas id="c"></canvas>
<script>
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let S=null,yaw=0.5,pitch=0.7,zoom=40,cx=0,cy=0,cz=0,drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-drag[0])*.01;
 pitch+=(e.clientY-drag[1])*.01;drag=[e.clientX,e.clientY];};
cv.onwheel=e=>{zoom*=Math.exp(-e.deltaY*.001);e.preventDefault();};
function P(x,y,z){ // world -> screen (orbit camera around (cx,cy,cz))
 x-=cx;y-=cy;z-=cz;
 let x1=x*Math.cos(yaw)+z*Math.sin(yaw),z1=-x*Math.sin(yaw)+z*Math.cos(yaw);
 let y1=y*Math.cos(pitch)-z1*Math.sin(pitch);
 return [cv.width/2+x1*zoom, cv.height/2+y1*zoom];}
function draw(){
 cv.width=cv.clientWidth;cv.height=cv.clientHeight;
 ctx.fillStyle='#101014';ctx.fillRect(0,0,cv.width,cv.height);
 if(!S)return;
 if(document.getElementById('follow').checked&&S.cam){
   cx=S.cam[0];cy=S.cam[1];cz=S.cam[2];}
 if(document.getElementById('showpts').checked&&S.pts){
  ctx.fillStyle='#aaa';
  for(let i=0;i<S.pts.length;i+=3){const s=P(S.pts[i],S.pts[i+1],S.pts[i+2]);
   ctx.fillRect(s[0],s[1],1.4,1.4);}}
 if(document.getElementById('showbird').checked&&S.bpts){
  ctx.fillStyle='#3c3';
  for(let i=0;i<S.bpts.length;i+=3){const s=P(S.bpts[i],S.bpts[i+1],
   S.bpts[i+2]);ctx.fillRect(s[0],s[1],2,2);}}
 if(document.getElementById('showgraph').checked&&S.edges&&S.kfs){
  ctx.strokeStyle='rgba(80,200,220,.35)';ctx.beginPath();
  for(let i=0;i<S.edges.length;i+=2){
   const a=S.edges[i]*3,b=S.edges[i+1]*3;
   const p=P(S.kfs[a],S.kfs[a+1],S.kfs[a+2]),
         q=P(S.kfs[b],S.kfs[b+1],S.kfs[b+2]);
   ctx.moveTo(p[0],p[1]);ctx.lineTo(q[0],q[1]);}
  ctx.stroke();}
 if(document.getElementById('showkfs').checked&&S.kfs){
  ctx.strokeStyle='#46f';ctx.beginPath();
  for(let i=0;i<S.kfs.length;i+=3){const s=P(S.kfs[i],S.kfs[i+1],S.kfs[i+2]);
   ctx.rect(s[0]-2,s[1]-2,4,4);}
  ctx.stroke();}
 if(S.cam){const s=P(S.cam[0],S.cam[1],S.cam[2]);
  ctx.strokeStyle='#f44';ctx.lineWidth=2;
  ctx.strokeRect(s[0]-4,s[1]-4,8,8);ctx.lineWidth=1;
  if(S.traj){ctx.strokeStyle='rgba(255,80,80,.6)';ctx.beginPath();
   for(let i=0;i<S.traj.length;i+=3){const t=P(S.traj[i],S.traj[i+1],
    S.traj[i+2]);i?ctx.lineTo(t[0],t[1]):ctx.moveTo(t[0],t[1]);}
   ctx.stroke();}}
}
async function tick(){
 try{
  const r=await fetch('/state');S=await r.json();
  document.getElementById('state').textContent=
   'state: '+(['NOT_INITIALIZED','OK','LOST'][S.state]||S.state);
  document.getElementById('counts').textContent=
   S.n_kf+' KFs, '+S.n_mp+' pts, '+S.n_bmp+' bird';
  const loc=document.getElementById('loc');
  if(document.activeElement!==loc)loc.checked=!!S.localization;
 }catch(e){}
 draw();}
setInterval(tick,100);tick();
setInterval(()=>{document.getElementById('frame').src=
 '/frame?'+Date.now();},500);
document.getElementById('loc').onchange=e=>fetch('/cmd?action='+
 (e.target.checked?'localization_on':'localization_off'),{method:'POST'});
document.getElementById('reset').onclick=()=>fetch('/cmd?action=reset',
 {method:'POST'});
window.onresize=draw;
</script></body></html>"""


def _host_keypoints(fd):
    """fd's keypoints as host arrays without a device transfer, else
    None."""
    if fd is None:
        return None
    kp = getattr(fd, "kp_host", None) or getattr(fd, "kp", None)
    xy = getattr(kp, "xy", None)
    if isinstance(xy, np.ndarray):
        return kp
    if getattr(getattr(xy, "device", None), "type", None) == "cpu":
        return kp
    return None


class LiveViewer:
    """HTTP side-car viewer. All handlers read numpy state snapshots; no
    device work, no pipeline drains (`Viewer::Run` parity, non-blocking)."""

    def __init__(self, system, host: str = "127.0.0.1", port: int = 0):
        self.system = system
        self._frame_png: Optional[bytes] = None
        self._frame_lock = threading.Lock()
        self._last_frame_req = 0.0   # wall time of the last /frame GET
        self._httpd = ThreadingHTTPServer((host, port), self._handler())
        self._httpd.daemon_threads = True
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "LiveViewer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            name="live-viewer")
        self._thread.start()
        return self

    def stop(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}/"

    # ---------------------------------------------------------- state
    def update_frame(self, gray_img: np.ndarray, fd=None):
        """Cache the latest frame overlay (FrameDrawer::Update parity).
        Called from the tracking loop; encodes only when a client fetched
        /frame recently (cheap no-op otherwise — PNG encoding on the frame
        path with no browser attached is pure added latency). Keypoints
        are drawn when they are on the host already (a keyframe's landed
        copy, or a CPU run); a frame whose keypoints live on the GPU shows
        the plain image, with no forced transfer."""
        if time.time() - self._last_frame_req > 5.0:
            return
        try:
            from . import imageio, viz
            kp = _host_keypoints(fd)
            if kp is not None:
                tracked = None
                kp_mp = getattr(fd, "kp_mp", None)
                if kp_mp is not None:
                    tracked = np.asarray(kp_mp) >= 0
                ov = viz.draw_frame(gray_img, np.asarray(kp.xy),
                                    np.asarray(kp.valid), tracked,
                                    state_text=f"frame {fd.frame_id}")
            else:
                ov = viz.gray_to_bgr(gray_img)
            png = imageio.encode_png(ov, level=1)
            with self._frame_lock:
                self._frame_png = png
        except Exception:
            pass  # viewer must never take down tracking

    def snapshot(self) -> dict:
        """JSON-ready read-only snapshot of the map + tracker state."""
        sys_ = self.system
        store = sys_.store
        # report the PENDING mode request if one exists so the menu
        # checkbox reflects the click immediately (the switch itself lands
        # at the next track_* call — deferred-flag protocol)
        loc = getattr(sys_, "_loc_mode_requested", None)
        if loc is None:
            loc = bool(getattr(sys_, "localization_only", False)
                       or getattr(sys_.tracker, "only_tracking", False))
        out = {"state": int(sys_.peek_tracking_state()),
               "localization": bool(loc),
               "n_kf": 0, "n_mp": 0, "n_bmp": 0}
        try:
            ids = store.valid_mp_ids()
            out["n_mp"] = int(len(ids))
            if len(ids) > MAX_POINTS:
                ids = ids[:: len(ids) // MAX_POINTS + 1]
            out["pts"] = np.round(store.mp_pos[ids], 3).ravel().tolist()
            bids = store.valid_bmp_ids()
            out["n_bmp"] = int(len(bids))
            if len(bids) > MAX_POINTS:
                bids = bids[:: len(bids) // MAX_POINTS + 1]
            out["bpts"] = np.round(store.bmp_pos[bids], 3).ravel().tolist()
            kfs = store.valid_kf_ids()
            out["n_kf"] = int(len(kfs))
            if len(kfs):
                centers = np.stack([store.kf_center(int(k)) for k in kfs])
                out["kfs"] = np.round(centers, 3).ravel().tolist()
                # covisibility graph at the reference's draw threshold
                sub = store.covis[np.ix_(kfs, kfs)]
                a, b = np.nonzero(np.triu(sub >= COVIS_MIN_W, 1))
                if len(a) > MAX_EDGES:
                    a, b = a[:MAX_EDGES], b[:MAX_EDGES]
                out["edges"] = np.stack([a, b], -1).ravel().tolist()
            lf = getattr(sys_.tracker, "last_frame", None)
            if lf is not None and getattr(lf, "R", None) is not None:
                R, t = np.asarray(lf.R), np.asarray(lf.t)
                out["cam"] = np.round(-R.T @ t, 3).tolist()
            # trajectory entries are ref-KF-relative (Tcw = T_rel·Tcw_ref,
            # the reference's relative-pose recovery, src/Tracking.cc:617)
            pts = []
            for e in getattr(sys_.tracker, "trajectory", [])[-500:]:
                if e.lost or not store.kf_valid[e.ref_kf]:
                    continue
                Tref = np.eye(4, dtype=np.float64)
                Tref[:3, :3] = store.kf_R[e.ref_kf]
                Tref[:3, 3] = store.kf_t[e.ref_kf]
                Tcw = e.T_rel @ Tref
                pts.append(-Tcw[:3, :3].T @ Tcw[:3, 3])
            if pts:
                out["traj"] = np.round(np.stack(pts), 3).ravel().tolist()
        except Exception:
            pass  # concurrent mutation: serve the fields built so far
        return out

    # ---------------------------------------------------------- http
    def _handler(self):
        viewer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):  # silent
                pass

            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                path = urlparse(self.path).path
                if path == "/":
                    self._send(200, _PAGE.encode(), "text/html")
                elif path == "/state":
                    self._send(200, json.dumps(viewer.snapshot()).encode(),
                               "application/json")
                elif path == "/frame":
                    viewer._last_frame_req = time.time()
                    with viewer._frame_lock:
                        png = viewer._frame_png
                    if png is None:
                        self._send(404, b"no frame yet", "text/plain")
                    else:
                        self._send(200, png, "image/png")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                q = urlparse(self.path)
                if q.path != "/cmd":
                    self._send(404, b"not found", "text/plain")
                    return
                action = parse_qs(q.query).get("action", [""])[0]
                ok = True
                # menu actions of Viewer::Run (src/Viewer.cc).
                # Handlers run on HTTP server threads and must NOT mutate
                # tracker state directly (reset/_flush concurrent with an
                # in-flight track_* call corrupts the lag pipeline) — they
                # only set request flags, consumed at the start of the
                # next track_* call on the tracking thread, exactly the
                # reference's mbReset/mbActivateLocalizationMode protocol
                if action == "localization_on":
                    viewer.system.request_localization_mode(True)
                elif action == "localization_off":
                    viewer.system.request_localization_mode(False)
                elif action == "reset":
                    viewer.system.request_reset()
                else:
                    ok = False
                self._send(200 if ok else 400,
                           json.dumps({"ok": ok}).encode(),
                           "application/json")

        return H
