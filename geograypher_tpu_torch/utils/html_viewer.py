"""Self-contained interactive 3D mesh viewer: one HTML file, WebGL.

Port of ``geograypher_tpu/utils/html_viewer.py`` (numpy, base64 and
json): the mesh's triangles, per-face colours and camera frustums are
embedded as base64 float32 buffers beside an inline WebGL renderer (orbit,
zoom, pan, headlight shading), with no external asset.  On the same mesh
and cameras the file's bytes are the JAX package's.
"""

from __future__ import annotations

import base64
import json
import typing

import numpy as np

from geograypher_tpu_torch.constants import PATH_TYPE

# 20-class categorical palette (matplotlib tab20 values, re-rolled as a
# plain table so no matplotlib import is needed at export time)
_PALETTE = np.array(
    [
        [0.12, 0.47, 0.71], [0.68, 0.78, 0.91], [1.00, 0.50, 0.05],
        [1.00, 0.73, 0.47], [0.17, 0.63, 0.17], [0.60, 0.87, 0.54],
        [0.84, 0.15, 0.16], [1.00, 0.60, 0.59], [0.58, 0.40, 0.74],
        [0.77, 0.69, 0.84], [0.55, 0.34, 0.29], [0.77, 0.61, 0.58],
        [0.89, 0.47, 0.76], [0.97, 0.71, 0.82], [0.50, 0.50, 0.50],
        [0.78, 0.78, 0.78], [0.74, 0.74, 0.13], [0.86, 0.86, 0.55],
        [0.09, 0.75, 0.81], [0.62, 0.85, 0.90],
    ]
)


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(
        np.ascontiguousarray(arr, dtype=np.float32).tobytes()
    ).decode("ascii")


def colors_for_values(values: np.ndarray) -> np.ndarray:
    """(N,) scalar values -> (N, 3) RGB: categorical palette for discrete
    data, a blue->yellow ramp for continuous; NaN -> grey."""
    values = np.asarray(values, dtype=np.float64).reshape(-1)
    out = np.full((values.shape[0], 3), 0.6)
    finite = np.isfinite(values)
    if not finite.any():
        return out
    v = values[finite]
    if np.allclose(v, np.round(v)) and np.unique(v).size <= 64:
        out[finite] = _PALETTE[np.round(v).astype(int) % len(_PALETTE)]
        return out
    lo, hi = np.percentile(v, [2, 98])
    t = np.clip((v - lo) / max(hi - lo, 1e-12), 0.0, 1.0)
    out[finite] = np.stack([t, 0.2 + 0.6 * t, 1.0 - t], axis=1)
    return out


def frustum_lines(
    cam_to_world: np.ndarray,
    f: float,
    image_width: int,
    image_height: int,
    scale: float = 1.0,
) -> np.ndarray:
    """(16, 2, 3) world-frame line segments of one camera frustum
    (pyramid + image-top marker, like reference cameras.py:479-560)."""
    hw = image_width / (2.0 * f) * scale
    hh = image_height / (2.0 * f) * scale
    c = np.array(
        [
            [0, 0, 0],
            [hw, hh, scale], [hw, -hh, scale],
            [-hw, -hh, scale], [-hw, hh, scale],
            [0, -hh * 1.4, scale],  # "up" apex marker (image top = -y)
        ]
    )
    hom = np.concatenate([c, np.ones((len(c), 1))], axis=1)
    w = (np.asarray(cam_to_world, np.float64) @ hom.T).T[:, :3]
    idx = [
        (0, 1), (0, 2), (0, 3), (0, 4),
        (1, 2), (2, 3), (3, 4), (4, 1),
        (2, 5), (3, 5),
    ]
    return np.array([[w[a], w[b]] for a, b in idx])


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>{title}</title>
<style>html,body{{margin:0;height:100%;overflow:hidden;background:#111}}
canvas{{width:100%;height:100%;display:block}}
#hud{{position:fixed;left:10px;top:8px;color:#ddd;font:12px sans-serif}}
</style></head><body>
<canvas id="c"></canvas><div id="hud">{title} — drag: rotate · wheel: zoom
 · shift-drag: pan · {nfaces} faces</div>
<script>
const MESH = {mesh_json};
function buf(b64) {{
  const s = atob(b64); const a = new Uint8Array(s.length);
  for (let i = 0; i < s.length; i++) a[i] = s.charCodeAt(i);
  return new Float32Array(a.buffer);
}}
const pos = buf(MESH.pos), col = buf(MESH.col), nrm = buf(MESH.nrm);
const lines = buf(MESH.lines);
const canvas = document.getElementById("c");
const gl = canvas.getContext("webgl");
function sh(type, src) {{
  const s = gl.createShader(type); gl.shaderSource(s, src);
  gl.compileShader(s); return s;
}}
function prog(vs, fs) {{
  const p = gl.createProgram();
  gl.attachShader(p, sh(gl.VERTEX_SHADER, vs));
  gl.attachShader(p, sh(gl.FRAGMENT_SHADER, fs));
  gl.linkProgram(p); return p;
}}
const meshProg = prog(
 `attribute vec3 p; attribute vec3 c; attribute vec3 n;
  uniform mat4 mvp; uniform mat4 mv; varying vec3 vc; varying vec3 vn;
  void main() {{ gl_Position = mvp*vec4(p,1.0);
    vn = mat3(mv)*n; vc = c; }}`,
 `precision mediump float; varying vec3 vc; varying vec3 vn;
  void main() {{ float d = 0.35 + 0.65*abs(normalize(vn).z);
    gl_FragColor = vec4(vc*d, 1.0); }}`);
const lineProg = prog(
 `attribute vec3 p; uniform mat4 mvp;
  void main() {{ gl_Position = mvp*vec4(p,1.0); }}`,
 `precision mediump float;
  void main() {{ gl_FragColor = vec4(1.0,0.3,0.3,1.0); }}`);
function vbo(data) {{
  const b = gl.createBuffer(); gl.bindBuffer(gl.ARRAY_BUFFER, b);
  gl.bufferData(gl.ARRAY_BUFFER, data, gl.STATIC_DRAW); return b;
}}
const posB = vbo(pos), colB = vbo(col), nrmB = vbo(nrm), linB = vbo(lines);
let yaw = 0.6, pitch = 0.9, dist = 2.6, panX = 0, panY = 0;
function mat(out) {{
  const aspect = canvas.width/canvas.height, fy = 1.2;
  const near = 0.01, far = 100.0;
  const cy=Math.cos(yaw), sy=Math.sin(yaw), cp=Math.cos(pitch),
        sp=Math.sin(pitch);
  // model rotate: yaw about z (up), pitch tilts toward viewer
  const r = [cy,sy*cp,sy*sp, -sy,cy*cp,cy*sp, 0,-sp,cp];
  const mv = new Float32Array([
    r[0],r[1],r[2],0, r[3],r[4],r[5],0, r[6],r[7],r[8],0,
    panX,panY,-dist,1]);
  const pm = [fy/aspect,0,0,0, 0,fy,0,0,
    0,0,(far+near)/(near-far),-1, 0,0,2*far*near/(near-far),0];
  const mvp = new Float32Array(16);
  for (let i=0;i<4;i++) for (let j=0;j<4;j++) {{
    let s=0; for (let k=0;k<4;k++) s += mv[i*4+k]*pm[k*4+j];
    mvp[i*4+j]=s; }}
  return [mv, mvp];
}}
function draw() {{
  canvas.width = canvas.clientWidth; canvas.height = canvas.clientHeight;
  gl.viewport(0,0,canvas.width,canvas.height);
  gl.enable(gl.DEPTH_TEST);
  gl.clearColor(0.07,0.07,0.07,1);
  gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
  const [mv, mvp] = mat();
  gl.useProgram(meshProg);
  gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"mvp"),false,mvp);
  gl.uniformMatrix4fv(gl.getUniformLocation(meshProg,"mv"),false,mv);
  for (const [name,b] of [["p",posB],["c",colB],["n",nrmB]]) {{
    const loc = gl.getAttribLocation(meshProg,name);
    gl.bindBuffer(gl.ARRAY_BUFFER,b); gl.enableVertexAttribArray(loc);
    gl.vertexAttribPointer(loc,3,gl.FLOAT,false,0,0); }}
  gl.drawArrays(gl.TRIANGLES,0,pos.length/3);
  if (lines.length) {{
    gl.useProgram(lineProg);
    gl.uniformMatrix4fv(gl.getUniformLocation(lineProg,"mvp"),false,mvp);
    const loc = gl.getAttribLocation(lineProg,"p");
    gl.bindBuffer(gl.ARRAY_BUFFER,linB); gl.enableVertexAttribArray(loc);
    gl.vertexAttribPointer(loc,3,gl.FLOAT,false,0,0);
    gl.drawArrays(gl.LINES,0,lines.length/3);
  }}
  requestAnimationFrame(draw);
}}
let drag=null;
canvas.addEventListener("mousedown",e=>{{drag=[e.clientX,e.clientY,e.shiftKey];}});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{{
  if(!drag) return;
  const dx=(e.clientX-drag[0])/200, dy=(e.clientY-drag[1])/200;
  if (drag[2]) {{ panX += dx; panY -= dy; }}
  else {{ yaw += dx; pitch = Math.min(3.1,Math.max(0.0,pitch+dy)); }}
  drag=[e.clientX,e.clientY,drag[2]];
}});
canvas.addEventListener("wheel",e=>{{
  dist *= Math.exp(e.deltaY*0.001); e.preventDefault(); }},
  {{passive:false}});
draw();
</script></body></html>
"""


def export_html_viewer(
    path: PATH_TYPE,
    verts: np.ndarray,
    faces: np.ndarray,
    face_values: typing.Optional[np.ndarray] = None,
    frustums: typing.Optional[typing.Sequence[np.ndarray]] = None,
    title: str = "geograypher-tpu mesh",
) -> None:
    """Write the interactive viewer HTML.

    Args:
        verts: (V, 3) float vertices (any frame; normalized for display).
        faces: (F, 3) int triangle indices.
        face_values: (F,) scalar per-face values colored via
            :func:`colors_for_values` (None = height coloring).
        frustums: iterable of (K, 2, 3) line-segment arrays in the same
            frame (see :func:`frustum_lines`).
    """
    verts = np.asarray(verts, np.float64)
    faces = np.asarray(faces, np.int64)
    center = verts.mean(axis=0)
    scale = float(np.abs(verts - center).max()) or 1.0
    vn = (verts - center) / scale
    tri = vn[faces]  # (F, 3, 3)
    if face_values is None:
        face_values = tri[:, :, 2].mean(axis=1)
    col = np.repeat(
        colors_for_values(face_values), 3, axis=0
    )  # (F*3, 3)
    e1 = tri[:, 1] - tri[:, 0]
    e2 = tri[:, 2] - tri[:, 0]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    nrm = np.repeat(n, 3, axis=0)
    pos = tri.reshape(-1, 3)
    if frustums:
        segs = np.concatenate([np.asarray(fr) for fr in frustums], axis=0)
        segs = (segs - center) / scale
        lines = segs.reshape(-1, 3)
    else:
        lines = np.zeros((0, 3))
    mesh_json = json.dumps(
        {
            "pos": _b64(pos),
            "col": _b64(col),
            "nrm": _b64(nrm),
            "lines": _b64(lines),
        }
    )
    html = _HTML.format(
        title=title, nfaces=faces.shape[0], mesh_json=mesh_json
    )
    with open(path, "w") as f:
        f.write(html)
