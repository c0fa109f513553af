"""Self-contained interactive HTML map viewer.

Port of structure_plp_slam_tpu/publish/html_viewer.py (the same page and
payload). Stand-in for the reference's node.js + socket.io + three.js web viewer
(viewer/app.js, viewer/public/). Two surfaces share one renderer:

* ``export_html`` writes ONE static HTML file with the point cloud, line
  segments, plane patches, keyframe frusta and trajectory embedded as
  JSON, rendered by a dependency-free canvas orbiter (drag to rotate,
  wheel to zoom). Works offline in any browser.
* ``publish.live_server.LiveViewerServer`` serves the same page with a
  polling loop fetching ``/map.json`` — the live-viewing role of the
  reference's socket.io stream, with zero external dependencies.
"""

from __future__ import annotations

import json

import numpy as np

_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>structure_plp_slam_tpu map</title>
<style>
 body {{ margin:0; background:#101014; color:#ddd; font:12px sans-serif; }}
 #hud {{ position:fixed; top:8px; left:10px; pointer-events:none; }}
 canvas {{ display:block; }}
</style></head>
<body>
<div id="hud">structure_plp_slam_tpu — drag: orbit, wheel: zoom, shift-drag: pan<br>{stats}</div>
<canvas id="c"></canvas>
<script>
let DATA = {data};
const cv = document.getElementById('c');
const ctx = cv.getContext('2d');
let W, H; function resize() {{ W = cv.width = innerWidth; H = cv.height = innerHeight; }}
resize(); addEventListener('resize', () => {{ resize(); draw(); }});
let yaw = -0.6, pitch = -0.4, dist = DATA.scale * 3.0, cx = DATA.center[0],
    cy = DATA.center[1], cz = DATA.center[2];
function project(p) {{
  const sy = Math.sin(yaw), cyw = Math.cos(yaw), sp = Math.sin(pitch), cp = Math.cos(pitch);
  let x = p[0]-cx, y = p[1]-cy, z = p[2]-cz;
  let x1 = cyw*x + sy*z, z1 = -sy*x + cyw*z;
  let y2 = cp*y - sp*z1, z2 = sp*y + cp*z1;
  z2 += dist;
  if (z2 < 0.05) return null;
  const f = 0.9 * Math.min(W, H);
  return [W/2 + f*x1/z2, H/2 + f*y2/z2, z2];
}}
function draw() {{
  ctx.fillStyle = '#101014'; ctx.fillRect(0, 0, W, H);
  for (const pl of DATA.planes) {{
    ctx.beginPath(); let first = true, ok = true;
    for (const v of pl.quad) {{ const q = project(v); if (!q) {{ ok=false; break; }}
      if (first) {{ ctx.moveTo(q[0], q[1]); first=false; }} else ctx.lineTo(q[0], q[1]); }}
    if (ok) {{ ctx.closePath(); ctx.fillStyle = pl.color + '30'; ctx.fill();
      ctx.strokeStyle = pl.color; ctx.stroke(); }}
  }}
  for (let i = 0; i < DATA.points.length; i++) {{
    const q = project(DATA.points[i]); if (!q) continue;
    ctx.fillStyle = DATA.point_colors[i];
    const s = Math.max(1, 3.0 / (q[2] / dist));
    ctx.fillRect(q[0], q[1], s, s);
  }}
  ctx.lineWidth = 1.5;
  for (const seg of DATA.lines) {{
    const a = project(seg[0]), b = project(seg[1]); if (!a || !b) continue;
    ctx.strokeStyle = '#ff66ff'; ctx.beginPath();
    ctx.moveTo(a[0], a[1]); ctx.lineTo(b[0], b[1]); ctx.stroke();
  }}
  ctx.strokeStyle = '#ff5544'; ctx.beginPath(); let started = false;
  for (const p of DATA.trajectory) {{
    const q = project(p); if (!q) {{ started = false; continue; }}
    if (!started) {{ ctx.moveTo(q[0], q[1]); started = true; }} else ctx.lineTo(q[0], q[1]);
  }}
  ctx.stroke();
  for (const fr of DATA.frusta) {{
    const q0 = project(fr[0]); if (!q0) continue;
    ctx.strokeStyle = '#44aaff'; ctx.beginPath();
    for (let k = 1; k < 5; k++) {{
      const q = project(fr[k]); if (!q) continue;
      ctx.moveTo(q0[0], q0[1]); ctx.lineTo(q[0], q[1]);
    }}
    ctx.stroke();
  }}
}}
let drag = null;
cv.onmousedown = e => drag = [e.clientX, e.clientY, e.shiftKey];
onmouseup = () => drag = null;
onmousemove = e => {{
  if (!drag) return;
  const dx = e.clientX - drag[0], dy = e.clientY - drag[1];
  if (drag[2]) {{
    const sy = Math.sin(yaw), cyw = Math.cos(yaw);
    cx -= (cyw * dx) * dist / 600; cz -= (-sy * dx) * dist / 600; cy -= dy * dist / 600;
  }} else {{ yaw += dx * 0.01; pitch += dy * 0.01; }}
  drag = [e.clientX, e.clientY, drag[2]]; draw();
}};
onwheel = e => {{ dist *= Math.exp(e.deltaY * 0.001); draw(); }};
{live_js}draw();
</script></body></html>
"""


_LIVE_JS = """
let inited = false;
async function poll() {
  try {
    const r = await fetch('/map.json');
    if (!r.ok) throw 0;  // keep the previous DATA on server errors
    const d = await r.json();
    DATA = d;
    document.getElementById('hud').innerHTML =
      'structure_plp_slam_tpu live &mdash; drag: orbit, wheel: zoom, ' +
      'shift-drag: pan<br>' + d.stats;
    if (!inited && d.points.length) {
      cx = d.center[0]; cy = d.center[1]; cz = d.center[2];
      dist = d.scale * 3.0; inited = true;
    }
    draw();
  } catch (e) {}
  setTimeout(poll, 500);
}
poll();
"""

_EMPTY_DATA = {
    "points": [], "point_colors": [], "trajectory": [], "frusta": [],
    "lines": [], "planes": [], "center": [0.0, 0.0, 0.0], "scale": 1.0,
}


def map_data(map_publisher, max_points: int = 20000) -> dict:
    """Assemble the viewer's JSON payload (points, colors, trajectory,
    frusta, line segments, plane quads, view framing). Shared by the
    static export and the live ``/map.json`` endpoint.

    All arrays derive from ONE ``MapPublisher.snapshot()`` — the HTTP
    handler thread races the tracking loop, and independent getter calls
    could mix two map versions (mismatched points/colors lengths)."""
    snap = map_publisher.snapshot()
    pts = snap.get_landmarks()
    cols = snap.get_landmark_colors()
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts, cols = pts[sel], cols[sel]
    # Dense RGB-D cloud (present when the System stores per-keyframe
    # strided depth images; reference: viewer.h:132-133 dense display).
    dpts, dgray = snap.get_dense_cloud()
    if len(dpts):
        if len(dpts) > max_points:
            sel = np.random.default_rng(1).choice(
                len(dpts), max_points, replace=False)
            dpts, dgray = dpts[sel], dgray[sel]
        dcols = np.stack([dgray, dgray, dgray], axis=1)
        pts = np.concatenate([pts, dpts]) if len(pts) else dpts
        cols = np.concatenate([cols, dcols]) if len(cols) else dcols
    kfs = snap.get_keyframe_poses()
    lines = snap.get_lines()
    planes = snap.get_planes()

    centers = (
        np.stack([-P[:, :3].T @ P[:, 3] for P in kfs]) if len(kfs) else np.zeros((0, 3))
    )
    all_pts = np.concatenate([pts, centers]) if len(pts) or len(centers) else np.zeros((1, 3))
    center = all_pts.mean(axis=0)
    scale = float(np.percentile(np.linalg.norm(all_pts - center, axis=1), 90) + 1e-3)

    frusta = []
    for P in kfs:
        R, t = P[:, :3], P[:, 3]
        C = -R.T @ t
        s = scale * 0.06
        corners = [
            C + R.T @ (np.array([x, y, 1.6]) * s)
            for x, y in ((-1, -0.75), (1, -0.75), (1, 0.75), (-1, 0.75))
        ]
        frusta.append([C.tolist()] + [c.tolist() for c in corners])

    palette = ["#ff6347", "#87cefa", "#ffd700", "#90ee90", "#dda0dd", "#ffa500"]
    plane_quads = []
    for i, coef in enumerate(planes):
        n, d = coef[:3], coef[3]
        n = n / (np.linalg.norm(n) + 1e-9)
        p0 = -d * n
        a = np.cross(n, [0, 0, 1.0])
        if np.linalg.norm(a) < 1e-3:
            a = np.cross(n, [0, 1.0, 0])
        a = a / np.linalg.norm(a)
        b = np.cross(n, a)
        s = scale * 0.5
        quad = [(p0 + sa * s * a + sb * s * b).tolist()
                for sa, sb in ((-1, -1), (1, -1), (1, 1), (-1, 1))]
        plane_quads.append({"quad": quad, "color": palette[i % len(palette)]})

    data = {
        "points": np.round(pts, 4).tolist(),
        "point_colors": [f"rgb({c[0]},{c[1]},{c[2]})" for c in cols],
        "trajectory": np.round(centers, 4).tolist(),
        "frusta": frusta,
        "lines": [
            [l[:3].tolist(), l[3:].tolist()] for l in np.round(lines, 4)
        ],
        "planes": plane_quads,
        "center": np.round(center, 4).tolist(),
        "scale": scale,
    }
    data["stats"] = (
        f"{len(pts)} points · {len(kfs)} keyframes · {len(lines)} lines · "
        f"{len(planes)} planes"
    )
    return data


def render_html(data: dict, live: bool = False) -> str:
    return _TEMPLATE.format(
        data=json.dumps(data),
        stats=data.get("stats", ""),
        live_js=_LIVE_JS if live else "",
    )


def export_html(path: str, map_publisher, max_points: int = 20000):
    """Write the interactive viewer for the current map."""
    with open(path, "w") as f:
        f.write(render_html(map_data(map_publisher, max_points)))
