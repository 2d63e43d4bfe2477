"""Self-contained interactive 3-D HTML export (the port's copy of
``scream_tpu/utils/viz_html.py``; numpy, base64 and json only, so it runs
beside the card).

The reference's visualize flows open live Open3D windows with navigable
geometry and correspondence LineSets (reference
``visualize_3d_match.py:118-124,184-188``, ``train_3d_match.py:54-103``
``look()``). A headless host has no display server, so this module writes
ONE dependency-free ``.html`` file instead: point clouds and correspondence
lines embedded as base64 float32, rendered by ~150 lines of inline vanilla
JS on a 2-D canvas (painter-sorted perspective splats, drag-to-orbit, wheel
zoom, shift-drag pan, per-layer toggles, point-size slider). Opens in any
browser, no network, no WebGL requirement. The bytes it writes equal the
JAX package's for the same arrays.
"""

from __future__ import annotations

import base64
import json
from typing import Optional, Sequence, Tuple

import numpy as np

_PAGE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body { margin:0; background:#111; color:#ddd; font:13px sans-serif; }
 #hud { position:fixed; top:8px; left:8px; background:#000a; padding:8px 10px;
        border-radius:6px; user-select:none; }
 #hud label { display:block; margin:2px 0; cursor:pointer; }
 #hud .sw { display:inline-block; width:10px; height:10px; margin-right:6px;
            border-radius:2px; }
 canvas { display:block; }
 #help { position:fixed; bottom:8px; left:8px; color:#888; }
</style></head><body>
<div id="hud"><b>__TITLE__</b><div id="layers"></div>
 <label>size <input id="psize" type="range" min="0.5" max="5" step="0.5"
  value="1.5" style="width:90px"></label></div>
<div id="help">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<canvas id="c"></canvas>
<script>
const DATA = __DATA__;
function decode(b64) {
  const raw = atob(b64), n = raw.length / 4, a = new Float32Array(n);
  const dv = new DataView(new ArrayBuffer(raw.length));
  for (let i = 0; i < raw.length; i++) dv.setUint8(i, raw.charCodeAt(i));
  for (let i = 0; i < n; i++) a[i] = dv.getFloat32(4 * i, true);
  return a;
}
const layers = DATA.layers.map(l => ({...l, pts: decode(l.b64), on: true}));
const lines = (DATA.lines || []).map(l => ({...l, p: decode(l.p64),
                                            q: decode(l.q64), on: true}));
// center + scale
let lo = [1e9,1e9,1e9], hi = [-1e9,-1e9,-1e9];
for (const L of layers) for (let i = 0; i < L.pts.length; i += 3)
  for (let k = 0; k < 3; k++) {
    lo[k] = Math.min(lo[k], L.pts[i+k]); hi[k] = Math.max(hi[k], L.pts[i+k]);
  }
const ctr = [0,1,2].map(k => (lo[k]+hi[k])/2);
const span = Math.max(hi[0]-lo[0], hi[1]-lo[1], hi[2]-lo[2]) || 1;
let yaw = 0.6, pitch = 0.4, dist = 2.2, panX = 0, panY = 0, psize = 1.5;
const cv = document.getElementById('c'), ctx = cv.getContext('2d');
function project() {
  const W = cv.width = innerWidth, H = cv.height = innerHeight;
  ctx.fillStyle = '#111'; ctx.fillRect(0, 0, W, H);
  const cy = Math.cos(yaw), sy = Math.sin(yaw);
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const f = 1.2 * Math.min(W, H);
  const items = [];
  for (const L of layers) {
    if (!L.on) continue;
    const P = L.pts;
    for (let i = 0; i < P.length; i += 3) {
      const x0 = (P[i]-ctr[0])/span, y0 = (P[i+1]-ctr[1])/span,
            z0 = (P[i+2]-ctr[2])/span;
      const x1 = cy*x0 + sy*z0, z1 = -sy*x0 + cy*z0;
      const y2 = cp*y0 - sp*z1, z2 = sp*y0 + cp*z1 + dist;
      if (z2 < 0.05) continue;
      items.push([z2, W/2 + f*(x1/z2) + panX, H/2 - f*(y2/z2) + panY,
                  L.color, 0]);
    }
  }
  function proj1(P, i) {
    const x0 = (P[i]-ctr[0])/span, y0 = (P[i+1]-ctr[1])/span,
          z0 = (P[i+2]-ctr[2])/span;
    const x1 = cy*x0 + sy*z0, z1 = -sy*x0 + cy*z0;
    const y2 = cp*y0 - sp*z1, z2 = sp*y0 + cp*z1 + dist;
    return [W/2 + f*(x1/z2) + panX, H/2 - f*(y2/z2) + panY, z2];
  }
  items.sort((a, b) => b[0] - a[0]);
  for (const [z, x, y, col] of items) {
    const s = Math.max(psize * 0.9 / z, 0.5);
    ctx.fillStyle = col; ctx.fillRect(x - s/2, y - s/2, s, s);
  }
  ctx.globalAlpha = 0.55;
  for (const L of lines) {
    if (!L.on) continue;
    ctx.strokeStyle = L.color; ctx.beginPath();
    for (let i = 0; i < L.p.length; i += 3) {
      const a = proj1(L.p, i), b = proj1(L.q, i);
      if (a[2] < 0.05 || b[2] < 0.05) continue;
      ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]);
    }
    ctx.stroke();
  }
  ctx.globalAlpha = 1.0;
}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) { panX += dx; panY += dy; }
  else { yaw += dx * 0.008; pitch += dy * 0.008;
         pitch = Math.max(-1.55, Math.min(1.55, pitch)); }
  drag = [e.clientX, e.clientY, drag[2]]; project();
};
cv.onwheel = e => { dist *= Math.exp(e.deltaY * 0.001);
                    dist = Math.max(0.3, Math.min(20, dist));
                    e.preventDefault(); project(); };
onresize = project;
document.getElementById('psize').oninput = e => {
  psize = +e.target.value; project(); };
const lay = document.getElementById('layers');
for (const L of [...layers, ...lines]) {
  const lb = document.createElement('label');
  lb.innerHTML = `<input type="checkbox" checked>` +
    `<span class="sw" style="background:${L.color}"></span>${L.label}`;
  lb.firstChild.onchange = e => { L.on = e.target.checked; project(); };
  lay.appendChild(lb);
}
project();
</script></body></html>
"""


def _b64(pts: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(pts, dtype=np.float32).tobytes()).decode()


def export_scene_html(
    path: str,
    clouds: Sequence[Tuple[np.ndarray, str, str]],
    lines: Optional[Sequence[Tuple[np.ndarray, np.ndarray, str, str]]] = None,
    title: str = "scream_tpu",
    max_points: int = 60000,
) -> str:
    """Write an interactive scene: ``clouds`` = (points (N,3), css color,
    label); ``lines`` = (p (K,3), q (K,3), color, label) segment sets.
    Clouds above ``max_points`` are deterministically subsampled (the file
    stays a few MB and the canvas renderer interactive)."""
    layers = []
    for pts, color, label in clouds:
        pts = np.asarray(pts, np.float32).reshape(-1, 3)
        if len(pts) > max_points:
            r = np.random.default_rng(0)
            pts = pts[r.choice(len(pts), max_points, replace=False)]
        layers.append({"b64": _b64(pts), "color": color,
                       "label": f"{label} ({len(pts)})"})
    lns = []
    for p, q, color, label in (lines or []):
        p = np.asarray(p, np.float32).reshape(-1, 3)
        q = np.asarray(q, np.float32).reshape(-1, 3)
        lns.append({"p64": _b64(p), "q64": _b64(q), "color": color,
                    "label": f"{label} ({len(p)} lines)"})
    data = json.dumps({"layers": layers, "lines": lns})
    html = (_PAGE.replace("__TITLE__", title).replace("__DATA__", data))
    with open(path, "w") as f:
        f.write(html)
    return path


def export_registration_html(
    path: str,
    src: np.ndarray,
    tgt: np.ndarray,
    T_gt: Optional[np.ndarray] = None,
    T_est: Optional[np.ndarray] = None,
    src_pred: Optional[np.ndarray] = None,
    corr: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    title: str = "registration",
) -> str:
    """The registration inspection scene: target (blue), raw source (gray),
    source at GT (green), source at the estimated pose (red), predicted
    source (orange), optional correspondence lines — the interactive
    counterpart of the reference's draw_geometries windows
    (`/root/reference/visualize_3d_match.py:118-124,184-188`)."""
    src = np.asarray(src, np.float32)
    clouds = [(np.asarray(tgt, np.float32), "#4d9fff", "target"),
              (src, "#9a9a9a", "source (raw)")]
    if T_gt is not None:
        T_gt = np.asarray(T_gt)
        clouds.append((src @ T_gt[:3, :3].T + T_gt[:3, 3],
                       "#4ad04a", "source @ GT"))
    if T_est is not None:
        T_est = np.asarray(T_est)
        clouds.append((src @ T_est[:3, :3].T + T_est[:3, 3],
                       "#ff5c5c", "source @ estimate"))
    if src_pred is not None:
        clouds.append((np.asarray(src_pred, np.float32),
                       "#ffb24d", "predicted source"))
    lines = None
    if corr is not None:
        lines = [(corr[0], corr[1], "#d0d04a", "correspondences")]
    return export_scene_html(path, clouds, lines=lines, title=title)
