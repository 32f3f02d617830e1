"""Browsable 3-D trajectory and map viewer: one self-contained HTML file.

Port of lvt_tpu/viz_html.py (numpy and json only). Per tracked frame (per
chunk in chunked mode) a small host snapshot is kept: the pose and the
valid map and staged points, read back from the VOSystem's device.
``write_viewer`` writes one HTML file with the data embedded and a canvas
renderer (no network, no external script): ground grid, map points
colored by age, staged points in green, the camera frustum trail, an
orbit camera with a follow mode, play / pause / scrub, and the reference
viewer's keys (space play/pause, f follow, r reset the view, q stop
playback; lvt_visualization.cpp:324-349).

From the CLI: ``--viz DIR`` (kitti, euroc, tum, synthetic); open
``DIR/viewer.html`` in a browser.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy()


class HtmlMapViewer:
    """Collects per-frame snapshots; writes a self-contained viewer.html."""

    def __init__(self, out_dir: str, max_points: int = 400, every: int = 1,
                 live_every: int = 25):
        """``live_every`` > 0 rewrites viewer.html every that many recorded
        snapshots, so opening the file DURING a long CLI run shows the
        trajectory so far (the viewer auto-reloads in live mode and
        preserves its camera/playback state across reloads) — the runtime
        equivalent of the reference's live viewer thread
        (lvt_visualization.cpp:137-349) without touching the hot path."""
        self.out_dir = out_dir
        self.max_points = max_points
        self.every = every
        self.live_every = live_every
        self.frames: list[dict] = []
        self._i = 0
        os.makedirs(out_dir, exist_ok=True)

    def update(self, vo) -> None:
        """Call after each tracked frame with the VOSystem (or any object
        with .state and .last_pose)."""
        if self._i % self.every:
            self._i += 1
            return
        self._i += 1
        st = vo.state
        from lvt_tpu_torch.geometry import quaternion as quat

        pose = vo.last_pose
        t = _host(pose.t).astype(np.float64)
        r = _host(quat.to_matrix(pose.q)).astype(np.float64)
        valid = _host(st.map.valid)
        pos = _host(st.map.pos)[valid]
        age = _host(st.map.age)[valid]
        if len(pos) > self.max_points:
            sel = np.linspace(0, len(pos) - 1, self.max_points).astype(int)
            pos, age = pos[sel], age[sel]
        spos = _host(st.staged.pos)[_host(st.staged.valid)]
        if len(spos) > self.max_points // 2:
            sel = np.linspace(0, len(spos) - 1,
                              self.max_points // 2).astype(int)
            spos = spos[sel]
        self.frames.append({
            "t": [round(float(v), 4) for v in t],
            "R": [[round(float(v), 5) for v in row] for row in r],
            "map": [[round(float(v), 3) for v in p] for p in pos],
            "age": [int(a) for a in age],
            "staged": [[round(float(v), 3) for v in p] for p in spos],
        })
        # live rewrite cadence backs off on long runs (the rewrite
        # serializes the full history, so a fixed interval would be
        # quadratic over tens of thousands of frames)
        n = len(self.frames)
        every = self.live_every if n < 100 * self.live_every \
            else 10 * self.live_every
        if self.live_every and n % every == 0:
            self.write_viewer()

    def write_viewer(self, filename: str = "viewer.html") -> str:
        # atomic replace: a live browser tab reloads this file every few
        # seconds, and must never observe a half-written page (which would
        # lose the reload timer and kill the live loop)
        path = os.path.join(self.out_dir, filename)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            f.write(_HTML.replace("__DATA__", json.dumps(self.frames)))
        os.replace(tmp, path)
        return path


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>lvt_tpu map viewer</title>
<style>
 body{margin:0;background:#101218;color:#cfd3dc;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;user-select:none}
 #bar{position:fixed;bottom:8px;left:10px;right:10px;display:flex;gap:8px;align-items:center}
 input[type=range]{flex:1}
 button{background:#2a2f3d;color:#cfd3dc;border:1px solid #444;border-radius:4px;padding:2px 10px}
</style></head><body>
<canvas id="c"></canvas>
<div id="hud"></div>
<div id="bar">
 <button id="play">play</button>
 <button id="follow">follow: on</button>
 <button id="live">live: off</button>
 <input id="seek" type="range" min="0" value="0" step="1">
</div>
<script>
const FRAMES=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function resize(){W=cv.width=innerWidth;H=cv.height=innerHeight;}
resize();addEventListener('resize',resize);
let fi=0,playing=false,follow=true,live=false;
let yaw=-0.6,pitch=0.45,dist=18,center=[0,0,0];
// live mode: the CLI rewrites this file during the run; restore the view
// state a reload saved, track the newest frame while live
try{const s=JSON.parse(localStorage.getItem('lvtview')||'null');
 if(s){yaw=s.yaw;pitch=s.pitch;dist=s.dist;center=s.center;follow=s.follow;
  live=!!s.live;fi=live?FRAMES.length-1:Math.min(s.fi,FRAMES.length-1);}
}catch(e){}
function saveView(){localStorage.setItem('lvtview',JSON.stringify(
 {yaw,pitch,dist,center,follow,fi,live}));}
setInterval(()=>{saveView();if(live)location.reload();},4000);
const seek=document.getElementById('seek');seek.max=FRAMES.length-1;
function rot(p){ // world -> view (y-down world like the camera frame)
 const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 let x=p[0]-center[0],y=p[1]-center[1],z=p[2]-center[2];
 let x1=cy*x+sy*z, z1=-sy*x+cy*z;
 let y1=cp*y-sp*z1, z2=sp*y+cp*z1;
 return [x1,y1,z2+dist];
}
function proj(p){const v=rot(p);if(v[2]<0.2)return null;
 const f=0.9*Math.min(W,H);return [W/2+f*v[0]/v[2],H/2+f*v[1]/v[2],v[2]];}
function ageColor(a){const t=Math.min(a,20)/20;
 return `rgb(${Math.round(60+180*t)},${Math.round(200-140*t)},90)`;}
function line(a,b,st,w){const pa=proj(a),pb=proj(b);if(!pa||!pb)return;
 ctx.strokeStyle=st;ctx.lineWidth=w||1;ctx.beginPath();
 ctx.moveTo(pa[0],pa[1]);ctx.lineTo(pb[0],pb[1]);ctx.stroke();}
function frustum(fr){ // small camera pyramid from R,t
 const t=fr.t,R=fr.R,s=0.6;
 const c=[[0,0,0],[-s,-0.4*s,s*1.2],[s,-0.4*s,s*1.2],[s,0.4*s,s*1.2],[-s,0.4*s,s*1.2]];
 const w=c.map(p=>[
  t[0]+R[0][0]*p[0]+R[0][1]*p[1]+R[0][2]*p[2],
  t[1]+R[1][0]*p[0]+R[1][1]*p[1]+R[1][2]*p[2],
  t[2]+R[2][0]*p[0]+R[2][1]*p[1]+R[2][2]*p[2]]);
 for(let i=1;i<=4;i++){line(w[0],w[i],'#e8b341',1.4);
  line(w[i],w[i%4+1],'#e8b341',1.4);}
}
function draw(){
 ctx.fillStyle='#101218';ctx.fillRect(0,0,W,H);
 const fr=FRAMES[fi];if(!fr)return;
 if(follow)center=fr.t.slice();
 // ground grid (y = +2 plane, world y-down)
 ctx.globalAlpha=0.35;
 for(let i=-10;i<=10;i++){
  line([center[0]+i*2,2,center[2]-20],[center[0]+i*2,2,center[2]+20],'#39415a');
  line([center[0]-20,2,center[2]+i*2],[center[0]+20,2,center[2]+i*2],'#39415a');}
 ctx.globalAlpha=1;
 // map + staged points
 for(let i=0;i<fr.map.length;i++){const p=proj(fr.map[i]);if(!p)continue;
  ctx.fillStyle=ageColor(fr.age[i]);
  const r2=Math.max(1.2,4.5/Math.sqrt(p[2]));ctx.fillRect(p[0]-r2/2,p[1]-r2/2,r2,r2);}
 ctx.fillStyle='#49d17c';
 for(const q of fr.staged){const p=proj(q);if(!p)continue;ctx.fillRect(p[0]-1,p[1]-1,2,2);}
 // trajectory + frusta trail
 for(let i=1;i<=fi;i++)line(FRAMES[i-1].t,FRAMES[i].t,'#7aa2ff',1.8);
 for(let i=Math.max(0,fi-40);i<=fi;i+=8)frustum(FRAMES[i]);
 frustum(fr);
 document.getElementById('hud').textContent=
  `frame ${fi+1}/${FRAMES.length}  map ${fr.map.length} pts  staged ${fr.staged.length}`+
  `  [drag] orbit  [wheel] zoom  [space] play  [f] follow  [l] live  [r] reset  [q] stop`;
 seek.value=fi;
}
function tick(){if(playing){fi=Math.min(fi+1,FRAMES.length-1);
 if(fi===FRAMES.length-1)playing=false;}draw();requestAnimationFrame(tick);}
tick();
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;
 yaw+=(e.clientX-drag[0])*0.008;pitch+=(e.clientY-drag[1])*0.008;
 pitch=Math.max(-1.4,Math.min(1.4,pitch));drag=[e.clientX,e.clientY];});
cv.addEventListener('wheel',e=>{dist*=Math.exp(e.deltaY*0.001);
 dist=Math.max(2,Math.min(200,dist));});
document.getElementById('play').onclick=()=>{playing=!playing;
 document.getElementById('play').textContent=playing?'pause':'play';};
document.getElementById('follow').onclick=()=>{follow=!follow;
 document.getElementById('follow').textContent='follow: '+(follow?'on':'off');};
function setLive(v){live=v;document.getElementById('live').textContent=
 'live: '+(live?'on':'off');if(live)fi=FRAMES.length-1;saveView();}
document.getElementById('live').onclick=()=>setLive(!live);
setLive(live);
seek.oninput=()=>{fi=+seek.value;};
addEventListener('keydown',e=>{
 if(e.key===' '){playing=!playing;e.preventDefault();}
 else if(e.key==='f')follow=!follow;
 else if(e.key==='l')setLive(!live);
 else if(e.key==='r'){yaw=-0.6;pitch=0.45;dist=18;}
 else if(e.key==='q')playing=false;});
</script></body></html>
"""
