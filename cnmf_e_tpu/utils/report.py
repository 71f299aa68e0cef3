"""Standalone interactive HTML report — the headless GUI.

The reference ships a MATLAB GUI (``GUI/cnmfe.m:18-32`` assembling panels
from ``GUI/modules/*``) and the interactive per-neuron QC loop
``viewNeurons`` / ``displayNeurons`` (keep / delete / inspect each neuron,
``@Sources2D/viewNeurons.m``). This module re-designs that capability for a
headless accelerator workflow: one self-contained HTML file (no server, no external
assets) with

  * the correlation image + clickable footprint contours,
  * a sortable neuron list (id / SNR / energy — ``orderROIs`` keys,
    ``Sources2D.m:573-653``),
  * per-neuron footprint thumbnail + raw/denoised traces + spikes,
  * keyboard QC (j/k navigate, x toggle reject — the ``viewNeurons``
    keep/delete decisions), exported as a JSON download that
    ``models.qc.delete_neurons`` / ``CNMFE.apply_decisions`` can consume.

Trace data is embedded as base64 ``Float32Array`` (decimated to
``max_points`` samples) so reports stay a few MB even for hours-long
recordings.
"""

from __future__ import annotations

import base64
import html as _html
import io
import json
from typing import Optional

import numpy as np


def _png_b64(img: np.ndarray, cmap: str = "gray") -> str:
    """Encode a 2D array as a base64 PNG data URI."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.cm as cm

    img = np.asarray(img, np.float64)
    lo, hi = np.nanmin(img), np.nanmax(img)
    norm = (img - lo) / max(hi - lo, 1e-12)
    rgba = (getattr(cm, cmap)(norm) * 255).astype(np.uint8)
    from PIL import Image  # pillow ships with matplotlib
    buf = io.BytesIO()
    Image.fromarray(rgba).save(buf, format="png")
    return "data:image/png;base64," + \
        base64.b64encode(buf.getvalue()).decode()


def _f32_b64(x: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(x, np.float32).tobytes()).decode()


def _decimate(x: np.ndarray, n: int) -> np.ndarray:
    """Peak-preserving decimation along the last axis to <= n points."""
    T = x.shape[-1]
    if T <= n:
        return x
    step = -(-T // (n // 2))
    pad = (-T) % step
    xp = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)], mode="edge")
    blocks = xp.reshape(x.shape[:-1] + (-1, step))
    # min/max per block interleaved keeps transients visible
    out = np.stack([blocks.min(-1), blocks.max(-1)], axis=-1)
    return out.reshape(x.shape[:-1] + (-1,))


def generate_html_report(path: str, Cn: np.ndarray, A: np.ndarray,
                         C: np.ndarray,
                         C_raw: Optional[np.ndarray] = None,
                         S: Optional[np.ndarray] = None,
                         snr: Optional[np.ndarray] = None,
                         ids: Optional[np.ndarray] = None,
                         tags: Optional[np.ndarray] = None,
                         fs: float = 10.0,
                         params: Optional[dict] = None,
                         title: str = "CNMF-E report",
                         max_points: int = 4000,
                         thumb: int = 40) -> str:
    """Write the self-contained interactive report to ``path``."""
    Cn = np.asarray(Cn)
    A = np.asarray(A)
    C = np.asarray(C)
    K, H, W = A.shape
    T = C.shape[1]

    # per-neuron geometry
    flat = A.reshape(K, -1)
    peak = np.argmax(flat, axis=1)
    cy, cx = peak // W, peak % W
    energy = np.sqrt((flat ** 2).sum(1)) * np.sqrt((C ** 2).sum(1))
    if snr is None:
        resid = (C_raw - C) if C_raw is not None else None
        noise = resid.std(-1) if resid is not None else np.ones(K)
        snr = C.std(-1) / np.maximum(noise, 1e-12)

    # contours (row, col) polylines
    from cnmf_e_tpu.utils.viz import footprint_contours
    conts = footprint_contours(A)

    # thumbnails around each peak
    thumbs = []
    hb = thumb // 2
    for k in range(K):
        y0 = int(np.clip(cy[k] - hb, 0, max(H - thumb, 0)))
        x0 = int(np.clip(cx[k] - hb, 0, max(W - thumb, 0)))
        thumbs.append(_png_b64(A[k, y0:y0 + thumb, x0:x0 + thumb],
                               cmap="hot"))

    Cd = _decimate(C, max_points)
    Crd = _decimate(C_raw, max_points) if C_raw is not None else None
    Sd = _decimate(S, max_points) if S is not None else None

    neurons = []
    for k in range(K):
        neurons.append({
            "id": int(ids[k]) if ids is not None else k,
            "cy": int(cy[k]), "cx": int(cx[k]),
            "snr": round(float(snr[k]), 3),
            "energy": round(float(energy[k]), 3),
            "tag": int(tags[k]) if tags is not None else 0,
            "contour": np.asarray(conts[k]).round(1).tolist(),
            "thumb": thumbs[k],
        })

    data = {
        "K": K, "H": H, "W": W, "T": T, "Td": int(Cd.shape[1]),
        "fs": fs, "title": title,
        "params": params or {},
        "cn_png": _png_b64(Cn, cmap="gray"),
        "neurons": neurons,
        "C": _f32_b64(Cd),
        "C_raw": _f32_b64(Crd) if Crd is not None else None,
        "S": _f32_b64(Sd) if Sd is not None else None,
    }

    page = _PAGE.replace("__TITLE__", _html.escape(title)) \
                .replace("__DATA__", json.dumps(data))
    with open(path, "w") as f:
        f.write(page)
    return path


_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{font-family:system-ui,sans-serif;margin:0;background:#111;color:#ddd;
      display:flex;height:100vh}
 #left{width:44%;padding:10px;overflow:auto}
 #right{flex:1;padding:10px;display:flex;flex-direction:column;min-width:0}
 #cnwrap{position:relative;width:100%}
 #cnimg{width:100%;image-rendering:pixelated;display:block}
 #overlay{position:absolute;left:0;top:0;width:100%;height:100%}
 #list{margin-top:8px;max-height:38vh;overflow:auto;font-size:12px;
       border-top:1px solid #333}
 .row{padding:2px 6px;cursor:pointer;display:flex;gap:10px}
 .row:hover{background:#222}.row.sel{background:#345}
 .row.rej{color:#777;text-decoration:line-through}
 #trace{width:100%;height:300px;background:#181818;border:1px solid #333}
 #thumb{height:140px;image-rendering:pixelated;border:1px solid #333}
 button,select{background:#333;color:#ddd;border:1px solid #555;
       padding:3px 10px;margin-right:6px;cursor:pointer}
 #meta{font-size:12px;color:#999;margin:6px 0}
 .kbd{background:#222;border:1px solid #444;border-radius:3px;
      padding:0 4px;font-family:monospace}
</style></head><body>
<div id="left">
 <h3 style="margin:4px 0">__TITLE__</h3>
 <div id="meta"></div>
 <div id="cnwrap"><img id="cnimg"><canvas id="overlay"></canvas></div>
 <div style="margin-top:6px">
  sort <select id="sort"><option value="id">id</option>
   <option value="snr">snr</option><option value="energy">energy</option>
  </select>
  <button id="export">download decisions.json</button>
  <span style="font-size:11px;color:#888"><span class="kbd">j</span>/<span
   class="kbd">k</span> navigate, <span class="kbd">x</span> reject,
   <span class="kbd">m</span> mark merge pair,
   <span class="kbd">u</span> unmark</span>
 </div>
 <div id="list"></div>
</div>
<div id="right">
 <div style="display:flex;gap:12px;align-items:flex-start">
  <img id="thumb"><div id="info" style="font-size:13px"></div>
 </div>
 <canvas id="trace"></canvas>
</div>
<script>
const D = __DATA__;
function f32(b64){if(!b64)return null;const s=atob(b64);
 const a=new Uint8Array(s.length);for(let i=0;i<s.length;i++)a[i]=
 s.charCodeAt(i);return new Float32Array(a.buffer);}
const C=f32(D.C), Craw=f32(D.C_raw), S=f32(D.S), Td=D.Td;
let order=D.neurons.map((n,i)=>i), sel=0, rej=new Set();
let mergeAnchor=null, merges=[];   // index pairs marked for manual merge
const inMerge=i=>merges.some(p=>p[0]===i||p[1]===i);
document.getElementById('meta').textContent =
 `${D.K} neurons | ${D.H}x${D.W} px | ${D.T} frames @ ${D.fs} Hz`;
const img=document.getElementById('cnimg'); img.src=D.cn_png;
const ov=document.getElementById('overlay');
function drawOverlay(){
 const r=img.getBoundingClientRect(); ov.width=r.width; ov.height=r.height;
 const sx=r.width/D.W, sy=r.height/D.H, g=ov.getContext('2d');
 g.clearRect(0,0,ov.width,ov.height);
 D.neurons.forEach((n,i)=>{
  g.strokeStyle=rej.has(i)?'#555':(i===mergeAnchor?'#0f0':
   (inMerge(i)?'#0cf':(i===order[sel]?'#ff0':'#e33')));
  g.lineWidth=i===order[sel]?2:1; g.beginPath();
  n.contour.forEach((p,j)=>{const x=p[1]*sx,y=p[0]*sy;
   j?g.lineTo(x,y):g.moveTo(x,y);}); g.stroke();});
}
img.onload=drawOverlay; window.onresize=drawOverlay;
ov.onclick=e=>{const r=ov.getBoundingClientRect();
 const px=(e.clientX-r.left)/r.width*D.W,
       py=(e.clientY-r.top)/r.height*D.H;
 let best=0,bd=1e9; D.neurons.forEach((n,i)=>{
  const d=(n.cx-px)**2+(n.cy-py)**2; if(d<bd){bd=d;best=i;}});
 sel=order.indexOf(best); render();};
function sortBy(key){
 order=D.neurons.map((n,i)=>i);
 if(key!=='id')order.sort((a,b)=>D.neurons[b][key]-D.neurons[a][key]);
 sel=0; render();}
document.getElementById('sort').onchange=e=>sortBy(e.target.value);
function render(){
 const list=document.getElementById('list'); list.innerHTML='';
 order.forEach((i,pos)=>{const n=D.neurons[i];
  const div=document.createElement('div');
  div.className='row'+(pos===sel?' sel':'')+(rej.has(i)?' rej':'');
  div.innerHTML=`<b>#${n.id}</b><span>snr ${n.snr}</span>`+
   `<span>E ${n.energy}</span><span>(${n.cy},${n.cx})</span>`+
   (n.tag?`<span style="color:#fa0">tag ${n.tag}</span>`:'')+
   (i===mergeAnchor?`<span style="color:#0f0">M?</span>`:
    (inMerge(i)?`<span style="color:#0cf">M</span>`:''));
  div.onclick=()=>{sel=pos;render();}; list.appendChild(div);});
 const i=order[sel], n=D.neurons[i];
 document.getElementById('thumb').src=n.thumb;
 document.getElementById('info').innerHTML=
  `<b>neuron #${n.id}</b> ${rej.has(i)?'<span style="color:#f55">'+
  '[rejected]</span>':''}<br>snr ${n.snr} | energy ${n.energy} | `+
  `center (${n.cy}, ${n.cx})${n.tag?' | QC tag '+n.tag:''}`;
 drawTrace(i); drawOverlay();
 const el=list.children[sel]; if(el)el.scrollIntoView({block:'nearest'});
}
function drawTrace(i){
 const cv=document.getElementById('trace');
 cv.width=cv.clientWidth; cv.height=cv.clientHeight;
 const g=cv.getContext('2d'), w=cv.width, h=cv.height;
 g.clearRect(0,0,w,h);
 const seg=(arr)=>arr.subarray(i*Td,(i+1)*Td);
 const c=seg(C); let lo=1e9,hi=-1e9;
 const cr=Craw?seg(Craw):null;
 [c,cr].forEach(a=>{if(a)for(const v of a){if(v<lo)lo=v;if(v>hi)hi=v;}});
 const Y=v=>h-8-(v-lo)/(hi-lo+1e-9)*(h-30);
 const plot=(a,color,lw)=>{g.strokeStyle=color;g.lineWidth=lw;g.beginPath();
  for(let t=0;t<Td;t++){const x=t/Td*w;t?g.lineTo(x,Y(a[t])):
   g.moveTo(x,Y(a[t]));} g.stroke();};
 if(cr)plot(cr,'#888',0.7); plot(c,'#f55',1.2);
 if(S){const s=seg(S);g.strokeStyle='#59f';g.lineWidth=1;
  for(let t=0;t<Td;t++)if(s[t]>0){const x=t/Td*w;g.beginPath();
   g.moveTo(x,h-2);g.lineTo(x,h-14);g.stroke();}}
}
document.onkeydown=e=>{
 if(e.key==='j'){sel=Math.min(sel+1,order.length-1);render();}
 if(e.key==='k'){sel=Math.max(sel-1,0);render();}
 if(e.key==='x'){const i=order[sel];
  rej.has(i)?rej.delete(i):rej.add(i);render();}
 if(e.key==='m'){const i=order[sel];
  if(mergeAnchor===null){mergeAnchor=i;}
  else{if(mergeAnchor!==i)merges.push([mergeAnchor,i]);mergeAnchor=null;}
  render();}
 if(e.key==='u'){const i=order[sel];mergeAnchor=null;
  merges=merges.filter(p=>p[0]!==i&&p[1]!==i);render();}};
document.getElementById('export').onclick=()=>{
 const out={rejected:[...rej].map(i=>D.neurons[i].id),
            kept:D.neurons.filter((n,i)=>!rej.has(i)).map(n=>n.id),
            merge:merges.map(p=>[D.neurons[p[0]].id,D.neurons[p[1]].id])};
 const a=document.createElement('a');
 a.href=URL.createObjectURL(new Blob([JSON.stringify(out,null,1)],
  {type:'application/json'}));
 a.download='decisions.json'; a.click();};
sortBy('id');
</script></body></html>
"""
