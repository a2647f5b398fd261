"use strict";
// WebGL scene viewer — the browser-side replacement for the reference's
// Bevy 3D viewport (libs/elodin-editor/src/object_3d.rs, ui/tiles.rs):
// object_3d GLB/sphere/box/cylinder meshes posed live from telemetry,
// line_3d trajectories, vector arrows, follow-entity camera.
//
// This file is a THIN RENDERER.  All scene logic — GLB parsing, unit
// geometry, scene -> draw-list assembly, camera framing — executes
// server-side in db/scenemath.py (the single, pytest-executed
// implementation) and arrives pre-digested from /api/drawlist, /api/glb
// and /api/geoms.  Only camera interaction math (S3D below) and WebGL
// upload/draw live here.

// ---------------------------------------------------------------------------
// S3D: camera math (no DOM access in this section)
// ---------------------------------------------------------------------------
const S3D = {};

// -- column-major mat4 (WebGL convention) --
S3D.m4ident = function () {
  return new Float32Array([1,0,0,0, 0,1,0,0, 0,0,1,0, 0,0,0,1]);
};

S3D.m4mul = function (a, b) {          // a*b (apply b first)
  const o = new Float32Array(16);
  for (let c = 0; c < 4; c++) {
    for (let r = 0; r < 4; r++) {
      o[c*4+r] = a[r] * b[c*4] + a[4+r] * b[c*4+1] +
                 a[8+r] * b[c*4+2] + a[12+r] * b[c*4+3];
    }
  }
  return o;
};

S3D.m4perspective = function (fovY, aspect, near, far) {
  const f = 1 / Math.tan(fovY / 2), nf = 1 / (near - far);
  const o = new Float32Array(16);
  o[0] = f / aspect; o[5] = f;
  o[10] = (far + near) * nf; o[11] = -1;
  o[14] = 2 * far * near * nf;
  return o;
};

// Z-up orbit camera: yaw around +z, pitch from the xy-plane.
S3D.m4orbitView = function (target, yaw, pitch, dist) {
  const cp = Math.cos(pitch), sp = Math.sin(pitch);
  const eye = [target[0] + dist * cp * Math.cos(yaw),
               target[1] + dist * cp * Math.sin(yaw),
               target[2] + dist * sp];
  // basis: fwd = target-eye, right = fwd x up, up2 = right x fwd  (up=+z)
  let f = [target[0]-eye[0], target[1]-eye[1], target[2]-eye[2]];
  const fl = Math.hypot(f[0], f[1], f[2]) || 1;
  f = [f[0]/fl, f[1]/fl, f[2]/fl];
  let r = [f[1], -f[0], 0];                       // f x (0,0,1)
  const rl = Math.hypot(r[0], r[1], r[2]) || 1;
  r = [r[0]/rl, r[1]/rl, r[2]/rl];
  const u = [r[1]*f[2] - r[2]*f[1], r[2]*f[0] - r[0]*f[2],
             r[0]*f[1] - r[1]*f[0]];
  const o = new Float32Array(16);
  o[0] = r[0]; o[4] = r[1]; o[8]  = r[2];
  o[1] = u[0]; o[5] = u[1]; o[9]  = u[2];
  o[2] = -f[0]; o[6] = -f[1]; o[10] = -f[2];
  o[12] = -(r[0]*eye[0] + r[1]*eye[1] + r[2]*eye[2]);
  o[13] = -(u[0]*eye[0] + u[1]*eye[1] + u[2]*eye[2]);
  o[14] = f[0]*eye[0] + f[1]*eye[1] + f[2]*eye[2];
  o[15] = 1;
  return o;
};

// -- base64 little-endian blobs -> typed arrays (scenemath's wire format) --
S3D.b64bytes = function (b64) {
  const raw = atob(b64);
  const out = new Uint8Array(raw.length);
  for (let i = 0; i < raw.length; i++) out[i] = raw.charCodeAt(i);
  return out.buffer;
};
S3D.decodeGeom = function (g) {
  const idxBuf = g.idx_b64 ? S3D.b64bytes(g.idx_b64) : null;
  return {
    pos: new Float32Array(S3D.b64bytes(g.pos_b64)),
    norm: new Float32Array(S3D.b64bytes(g.norm_b64)),
    idx: idxBuf ? (g.idx_u32 ? new Uint32Array(idxBuf)
                             : new Uint16Array(idxBuf)) : null,
  };
};

// ---------------------------------------------------------------------------
// Renderer + poll loop (DOM/WebGL from here on)
// ---------------------------------------------------------------------------
const VS = `
attribute vec3 aPos; attribute vec3 aNorm;
uniform mat4 uProj, uView, uModel;
varying vec3 vNorm; varying vec3 vView;
void main() {
  vec4 world = uModel * vec4(aPos, 1.0);
  gl_Position = uProj * uView * world;
  vNorm = mat3(uModel) * aNorm;
  vView = -(uView * world).xyz;
}`;
const FS = `
precision mediump float;
uniform vec4 uColor; uniform float uUnlit;
varying vec3 vNorm; varying vec3 vView;
void main() {
  if (uUnlit > 0.5) { gl_FragColor = uColor; return; }
  vec3 n = normalize(vNorm);
  float diff = abs(dot(n, normalize(vView)));
  float l = 0.35 + 0.65 * diff;
  gl_FragColor = vec4(uColor.rgb * l, uColor.a);
}`;

let sceneView = null;   // {card, canvas, gl, bufs, cam, drawList, ...}
const glbCache = {};    // url-key -> {prims:[...]} | {error} | {loading}

function compileProgram(gl) {
  const mk = (ty, src) => {
    const sh = gl.createShader(ty);
    gl.shaderSource(sh, src); gl.compileShader(sh);
    if (!gl.getShaderParameter(sh, gl.COMPILE_STATUS)) {
      throw new Error(gl.getShaderInfoLog(sh));
    }
    return sh;
  };
  const prog = gl.createProgram();
  gl.attachShader(prog, mk(gl.VERTEX_SHADER, VS));
  gl.attachShader(prog, mk(gl.FRAGMENT_SHADER, FS));
  gl.linkProgram(prog);
  if (!gl.getProgramParameter(prog, gl.LINK_STATUS)) {
    throw new Error(gl.getProgramInfoLog(prog));
  }
  return prog;
}

function uploadGeom(gl, g) {
  const pos = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, pos);
  gl.bufferData(gl.ARRAY_BUFFER, g.pos, gl.STATIC_DRAW);
  const norm = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, norm);
  gl.bufferData(gl.ARRAY_BUFFER, g.norm, gl.STATIC_DRAW);
  let idx = null, idxType = 0, count = g.pos.length / 3;
  if (g.idx) {
    idx = gl.createBuffer();
    gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, idx);
    gl.bufferData(gl.ELEMENT_ARRAY_BUFFER, g.idx, gl.STATIC_DRAW);
    idxType = g.idx instanceof Uint32Array ? 5125 : 5123;
    count = g.idx.length;
  }
  return {pos, norm, idx, idxType, count};
}

function gridGeom(extent, step) {
  const pts = [];
  for (let i = -extent; i <= extent; i += step) {
    pts.push(i, -extent, 0, i, extent, 0, -extent, i, 0, extent, i, 0);
  }
  return new Float32Array(pts);
}

function toggleScene3d() {
  if (sceneView) {
    sceneView.closed = true;
    sceneView.card.remove();
    sceneView = null;
    return;
  }
  const card = document.createElement("div");
  card.className = "card";
  card.style.gridColumn = "1 / -1";
  const h2 = document.createElement("h2");
  h2.textContent = "3D scene";
  const hint = document.createElement("span");
  hint.style.cssText = "font-size:11px;color:var(--ink-3);margin-left:8px";
  hint.textContent = "drag orbit · wheel zoom · shift-drag pan";
  h2.append(hint);
  const xbtn = document.createElement("button");
  xbtn.textContent = "close";
  xbtn.style.cssText = "float:right;font-size:11px";
  xbtn.onclick = toggleScene3d;
  h2.prepend(xbtn);
  const canvas = document.createElement("canvas");
  canvas.style.cssText =
    "width:100%;height:480px;touch-action:none;cursor:grab";
  const status = document.createElement("div");
  status.style.cssText = "font-size:11px;color:var(--ink-3)";
  card.append(h2, canvas, status);
  const cards = document.getElementById("cards");
  cards.prepend(card);

  const gl = canvas.getContext("webgl", {antialias: true});
  if (!gl) {
    status.textContent = "WebGL unavailable in this browser";
    return;
  }
  const prog = compileProgram(gl);
  gl.useProgram(prog);
  const loc = {
    aPos: gl.getAttribLocation(prog, "aPos"),
    aNorm: gl.getAttribLocation(prog, "aNorm"),
    uProj: gl.getUniformLocation(prog, "uProj"),
    uView: gl.getUniformLocation(prog, "uView"),
    uModel: gl.getUniformLocation(prog, "uModel"),
    uColor: gl.getUniformLocation(prog, "uColor"),
    uUnlit: gl.getUniformLocation(prog, "uUnlit"),
  };
  const gridPts = gridGeom(100, 10);
  const gridBuf = gl.createBuffer();
  gl.bindBuffer(gl.ARRAY_BUFFER, gridBuf);
  gl.bufferData(gl.ARRAY_BUFFER, gridPts, gl.STATIC_DRAW);

  sceneView = {
    card, canvas, gl, prog, loc, geoms: null, gridBuf,
    gridCount: gridPts.length / 3, status,
    cam: {yaw: 0.8, pitch: 0.5, dist: 40, target: [0, 0, 0]},
    drawList: {solids: [], lines: [], glbs: []},
    lineBufs: [], framed: false, closed: false,
  };
  const me = sceneView;
  // unit geometry comes pre-tessellated from the server (scenemath)
  fetch("/api/geoms").then((r) => r.json()).then((gj) => {
    if (sceneView !== me || me.closed) return;
    me.geoms = {};
    for (const k of Object.keys(gj)) {
      me.geoms[k] = uploadGeom(gl, S3D.decodeGeom(gj[k]));
    }
    drawScene3d();
  }).catch((e) => { status.textContent = `geoms fetch failed: ${e}`; });

  let drag = null;
  canvas.addEventListener("pointerdown", (e) => {
    drag = {x: e.clientX, y: e.clientY, pan: e.shiftKey};
    canvas.setPointerCapture(e.pointerId);
  });
  canvas.addEventListener("pointermove", (e) => {
    if (!drag || !sceneView) return;
    const dx = e.clientX - drag.x, dy = e.clientY - drag.y;
    const cam = sceneView.cam;
    if (drag.pan) {
      sceneView.userPanned = true;
      const s = cam.dist * 0.0022;
      cam.target[0] -= s * (Math.cos(cam.yaw + Math.PI/2) * dx);
      cam.target[1] -= s * (Math.sin(cam.yaw + Math.PI/2) * dx);
      cam.target[2] += s * dy;
    } else {
      cam.yaw -= dx * 0.008;
      cam.pitch = Math.max(-1.53, Math.min(1.53, cam.pitch + dy * 0.008));
    }
    drag = {x: e.clientX, y: e.clientY, pan: drag.pan};
    drawScene3d();
  });
  canvas.addEventListener("pointerup", () => { drag = null; });
  canvas.addEventListener("wheel", (e) => {
    e.preventDefault();
    if (!sceneView) return;
    sceneView.cam.dist *= Math.exp(e.deltaY * 0.001);
    drawScene3d();
  }, {passive: false});

  pollScene3d();
}

async function pollScene3d() {
  const me = sceneView;
  if (!me || me.closed) return;
  try {
    // honour the shared timeline: when the viewer is scrubbed off live,
    // render the scene at the scrub position (viewer.js owns live/scrubUs)
    let q = "";
    if (typeof live !== "undefined" && !live &&
        typeof scrubUs !== "undefined" && scrubUs != null) {
      q = "?ts_us=" + Math.round(scrubUs);
    }
    const r = await fetch("/api/drawlist" + q);
    const dl = await r.json();
    if (sceneView !== me || me.closed) return;  // closed/reopened mid-fetch
    for (const l of dl.lines) l.pts = new Float32Array(l.pts);
    me.drawList = dl;
    loadGlbs(me);
    if (!me.framed) {
      me.cam.target = dl.frame.center;
      me.cam.dist = Math.max(dl.frame.radius * 2.5, 5);
      me.framed = dl.solids.length + dl.glbs.length + dl.lines.length > 0;
    }
    // follow camera (editor parity): track the follow entity's frame
    // unless the user has panned away
    if (dl.follow && !me.userPanned) {
      me.cam.target = dl.follow;
    }
    me.status.textContent =
      `${dl.solids.length} solids · ${dl.glbs.length} ` +
      `models · ${dl.lines.length} lines` +
      (dl.warnings && dl.warnings.length ? ` · ${dl.warnings[0]}` : "") +
      (dl.error ? ` · ${dl.error}` : "");
    uploadLines(me);
    drawScene3d();
  } catch (e) {
    if (me.status) me.status.textContent = `scene fetch failed: ${e}`;
  }
  if (sceneView === me && !me.closed) setTimeout(pollScene3d, 400);
}

function glbKey(md) {
  return md.url || ("data:" + md.data.length + ":" + md.data.slice(0, 64));
}

function loadGlbs(me) {
  for (const md of me.drawList.glbs) {
    const key = glbKey(md);
    if (glbCache[key] || !md.url) continue;
    glbCache[key] = {loading: true};
    // parsed server-side (scenemath.parse_glb) — the client only uploads
    fetch("/api/glb?url=" + encodeURIComponent(md.url)).then((r) => {
      if (!r.ok) throw new Error(`HTTP ${r.status}`);
      return r.json();
    }).then((pj) => {
      const prims = pj.prims.map((p) => ({
        geom: uploadGeom(me.gl, S3D.decodeGeom(p)),
        color: p.color, matrix: new Float32Array(p.matrix),
      }));
      glbCache[key] = {prims};
      drawScene3d();
    }).catch((e) => { glbCache[key] = {error: String(e)}; });
  }
}

function uploadLines(me) {
  const gl = me.gl;
  for (const b of me.lineBufs) gl.deleteBuffer(b.buf);
  me.lineBufs = me.drawList.lines.map((l) => {
    const buf = gl.createBuffer();
    gl.bindBuffer(gl.ARRAY_BUFFER, buf);
    gl.bufferData(gl.ARRAY_BUFFER, l.pts, gl.STATIC_DRAW);
    return {buf, count: l.pts.length / 3, color: l.color, mat: l.mat};
  });
}

function drawScene3d() {
  const me = sceneView;
  if (!me || me.closed || !me.geoms) return;
  const {gl, canvas, loc, geoms} = me;
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth, h = canvas.clientHeight || 480;
  if (canvas.width !== w * dpr || canvas.height !== h * dpr) {
    canvas.width = w * dpr; canvas.height = h * dpr;
  }
  gl.viewport(0, 0, canvas.width, canvas.height);
  const dark = matchMedia("(prefers-color-scheme: dark)").matches;
  if (dark) gl.clearColor(0.051, 0.051, 0.051, 1);
  else gl.clearColor(0.976, 0.976, 0.968, 1);
  gl.enable(gl.DEPTH_TEST);
  gl.clear(gl.COLOR_BUFFER_BIT | gl.DEPTH_BUFFER_BIT);

  const cam = me.cam;
  const far = Math.max(cam.dist * 40, 4000);
  const proj = S3D.m4perspective(0.9, (w || 1) / (h || 1), 0.05, far);
  const view = S3D.m4orbitView(cam.target, cam.yaw, cam.pitch, cam.dist);
  gl.useProgram(me.prog);
  gl.uniformMatrix4fv(loc.uProj, false, proj);
  gl.uniformMatrix4fv(loc.uView, false, view);

  const bindGeom = (g) => {
    gl.bindBuffer(gl.ARRAY_BUFFER, g.pos);
    gl.enableVertexAttribArray(loc.aPos);
    gl.vertexAttribPointer(loc.aPos, 3, gl.FLOAT, false, 0, 0);
    gl.bindBuffer(gl.ARRAY_BUFFER, g.norm);
    gl.enableVertexAttribArray(loc.aNorm);
    gl.vertexAttribPointer(loc.aNorm, 3, gl.FLOAT, false, 0, 0);
    if (g.idx) gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER, g.idx);
  };
  const drawGeom = (g, mat, color, unlit) => {
    gl.uniformMatrix4fv(loc.uModel, false, mat);
    gl.uniform4f(loc.uColor, color.r !== undefined ? color.r : color[0],
      color.g !== undefined ? color.g : color[1],
      color.b !== undefined ? color.b : color[2],
      color.a !== undefined ? color.a : color[3]);
    gl.uniform1f(loc.uUnlit, unlit ? 1 : 0);
    if (g.idx) {
      gl.drawElements(gl.TRIANGLES, g.count,
        g.idxType === 5125 ? gl.UNSIGNED_INT : gl.UNSIGNED_SHORT, 0);
    } else {
      gl.drawArrays(gl.TRIANGLES, 0, g.count);
    }
  };
  if (!me._oesChecked) {
    me._oesChecked = true;
    gl.getExtension("OES_element_index_uint");
  }

  // grid floor (unlit hairlines)
  gl.bindBuffer(gl.ARRAY_BUFFER, me.gridBuf);
  gl.enableVertexAttribArray(loc.aPos);
  gl.vertexAttribPointer(loc.aPos, 3, gl.FLOAT, false, 0, 0);
  gl.disableVertexAttribArray(loc.aNorm);
  gl.vertexAttrib3f(loc.aNorm, 0, 0, 1);
  gl.uniformMatrix4fv(loc.uModel, false, S3D.m4ident());
  gl.uniform4f(loc.uColor, dark ? 0.17 : 0.88, dark ? 0.17 : 0.88,
    dark ? 0.16 : 0.85, 1);
  gl.uniform1f(loc.uUnlit, 1);
  gl.drawArrays(gl.LINES, 0, me.gridCount);

  for (const s of me.drawList.solids) {
    bindGeom(geoms[s.kind]);
    drawGeom(geoms[s.kind], s.mat, s.color, false);
  }
  for (const g of me.drawList.glbs) {
    const entry = glbCache[glbKey(g)];
    if (!entry || !entry.prims) {
      // placeholder while the GLB loads (or failed): a small cube
      bindGeom(geoms.cube);
      drawGeom(geoms.cube, g.mat, {r: 0.6, g: 0.6, b: 0.65, a: 1}, false);
      continue;
    }
    for (const p of entry.prims) {
      bindGeom(p.geom);
      drawGeom(p.geom, S3D.m4mul(g.mat, p.matrix),
        g.color || p.color, false);
    }
  }
  for (const l of me.lineBufs) {
    gl.bindBuffer(gl.ARRAY_BUFFER, l.buf);
    gl.enableVertexAttribArray(loc.aPos);
    gl.vertexAttribPointer(loc.aPos, 3, gl.FLOAT, false, 0, 0);
    gl.disableVertexAttribArray(loc.aNorm);
    gl.vertexAttrib3f(loc.aNorm, 0, 0, 1);
    gl.uniformMatrix4fv(loc.uModel, false, l.mat);
    gl.uniform4f(loc.uColor, l.color.r, l.color.g, l.color.b, l.color.a);
    gl.uniform1f(loc.uUnlit, 1);
    gl.drawArrays(gl.LINE_STRIP, 0, l.count);
  }
}

const sceneBtn = document.getElementById("scenebtn");
if (sceneBtn) sceneBtn.onclick = toggleScene3d;
