// elodin-db viewer logic. Served at /static/viewer.js by
// elodin_tpu/db/webui.py; extracted from the page so the logic is a
// reviewable, testable artifact (tests/test_webui.py checks its
// endpoint contract against the live route table).
"use strict";
const SERIES = ["--s1","--s2","--s3","--s4","--s5","--s6","--s7","--s8"]
  .map(v => getComputedStyle(document.documentElement).getPropertyValue(v).trim());
const css = v => getComputedStyle(document.documentElement).getPropertyValue(v).trim();
const RANGES = [["5s", 5e6], ["30s", 30e6], ["5m", 300e6], ["all", null]];
let windowUs = 30e6;
// timeline state: live follow vs scrubbed playback position
let live = true;
let scrubUs = null;      // absolute us when !live
let playing = false;
let dbSpan = [0, 0];     // [start_us, stop_us] from /api/info
function endUs() { return live || scrubUs == null ? dbSpan[1] : scrubUs; }
const open = new Map();   // name -> card state
let components = [];

function fmtTs(us) {
  if (us == null) return "";
  const d = new Date(us / 1000);
  if (us > 946684800000000) return d.toISOString().slice(11, 23);
  return (us / 1e6).toFixed(3) + "s";
}
function fmtVal(x) {
  if (!isFinite(x)) return String(x);
  const a = Math.abs(x);
  if (a !== 0 && (a >= 1e5 || a < 1e-3)) return x.toExponential(3);
  return x.toFixed(a >= 100 ? 1 : 4);
}

async function refreshComponents() {
  try {
    const [info, comps] = await Promise.all([
      fetch("/api/info").then(r => r.json()),
      fetch("/api/components").then(r => r.json()),
    ]);
    components = comps;
    dbSpan = [info.start_us, info.stop_us];
    updateTimeline();
    if (comps.length) applySchematic();
    document.getElementById("dbinfo").textContent =
      `${info.components} components · ${info.rows.toLocaleString()} rows` +
      (info.path ? ` · ${info.path}` : "");
    document.getElementById("dot").classList.add("live");
    document.getElementById("stext").textContent = "live";
    renderList();
  } catch (e) {
    document.getElementById("dot").classList.remove("live");
    document.getElementById("stext").textContent = "disconnected";
  }
}

function renderList() {
  const q = document.getElementById("search").value.toLowerCase();
  const list = document.getElementById("complist");
  list.replaceChildren();
  for (const c of components) {
    if (q && !c.name.toLowerCase().includes(q)) continue;
    const div = document.createElement("div");
    div.className = "comp" + (open.has(c.name) ? " on" : "");
    div.setAttribute("role", "button");
    div.tabIndex = 0;
    const n = document.createElement("span");
    n.textContent = c.name;
    const r = document.createElement("span");
    r.className = "rows";
    r.textContent = c.rows.toLocaleString();
    div.append(n, r);
    const toggle = () => { open.has(c.name) ? closeCard(c.name) : openCard(c); };
    div.onclick = toggle;
    div.onkeydown = e => { if (e.key === "Enter" || e.key === " ") toggle(); };
    list.append(div);
  }
}

function seriesNames(c, width) {
  if (c.element_names && c.element_names.length === width) return c.element_names;
  if (width === 1) return [c.name.split(".").pop()];
  return Array.from({length: width}, (_, i) => "[" + i + "]");
}

function openCard(c) {
  if (document.querySelector(".empty")) document.querySelector(".empty").remove();
  const card = document.createElement("div");
  card.className = "card";
  const head = document.createElement("div");
  head.className = "head";
  const h2 = document.createElement("h2");
  h2.textContent = c.name;
  const latest = document.createElement("span");
  latest.className = "latest";
  const tools = document.createElement("div");
  tools.className = "tools";
  const tbtn = document.createElement("button");
  tbtn.textContent = "table";
  const xbtn = document.createElement("button");
  xbtn.textContent = "close";
  xbtn.onclick = () => closeCard(c.name);
  tools.append(tbtn, xbtn);
  head.append(h2, latest, tools);
  const legend = document.createElement("div");
  legend.className = "legend";
  const wrap = document.createElement("div");
  wrap.className = "plotwrap";
  const canvas = document.createElement("canvas");
  const tip = document.createElement("div");
  tip.className = "tip";
  wrap.append(canvas, tip);
  const table = document.createElement("div");
  table.style.display = "none";
  tbtn.onclick = () => {
    const showing = table.style.display !== "none";
    table.style.display = showing ? "none" : "";
    wrap.style.display = showing ? "" : "none";
    tbtn.textContent = showing ? "table" : "plot";
    renderTable(st);
  };
  card.append(head, legend, wrap, table);
  document.getElementById("cards").append(card);
  const st = {c, card, canvas, tip, legend, latest, table, data: null, hoverX: null};
  canvas.addEventListener("pointermove", e => {
    const rect = canvas.getBoundingClientRect();
    st.hoverX = e.clientX - rect.left;
    draw(st);
  });
  canvas.addEventListener("pointerleave", () => { st.hoverX = null; tip.style.display = "none"; draw(st); });
  open.set(c.name, st);
  renderList();
  poll(st);
}

function closeCard(name) {
  const st = open.get(name);
  if (st) st.card.remove();
  open.delete(name);
  renderList();
  if (!open.size) {
    const d = document.createElement("div");
    d.className = "empty";
    d.textContent = "select components on the left to plot them";
    document.getElementById("cards").append(d);
  }
}

async function poll(st) {
  if (open.get(st.c.name) !== st) return;  // card closed (or replaced)
  try {
    const params = new URLSearchParams({name: st.c.name, max_points: 600});
    const stop = endUs();
    if (!live) params.set("stop_us", String(stop + 1));
    if (windowUs != null) params.set("start_us", String(stop - windowUs));
    const data = await fetch("/api/series?" + params).then(r => r.json());
    st.data = data;
    if (data.t.length) {
      const last = data.v[data.v.length - 1];
      st.latest.textContent = fmtTs(data.t[data.t.length - 1]) + "  [" +
        last.slice(0, 4).map(fmtVal).join(", ") + (last.length > 4 ? ", …" : "") + "]";
    }
    renderLegend(st);
    renderTable(st);
    draw(st);
  } catch (e) { /* transient; next poll retries */ }
  setTimeout(() => poll(st), 700);
}

function renderLegend(st) {
  const width = st.data && st.data.v.length ? st.data.v[0].length : 0;
  st.legend.replaceChildren();
  if (width < 2) return;  // single series: the title names it
  const names = seriesNames(st.data, width);
  const n = Math.min(width, 8);
  for (let i = 0; i < n; i++) {
    const item = document.createElement("span");
    const key = document.createElement("span");
    key.className = "key";
    key.style.borderTopColor = SERIES[i];
    item.append(key, document.createTextNode(names[i]));
    st.legend.append(item);
  }
  if (width > 8) {
    const more = document.createElement("span");
    more.textContent = "+" + (width - 8) + " more (table)";
    st.legend.append(more);
  }
}

function renderTable(st) {
  if (!st.data || st.table.style.display === "none") return;
  const width = st.data.v.length ? st.data.v[0].length : 0;
  const names = seriesNames(st.data, width);
  const tbl = document.createElement("table");
  tbl.className = "vals";
  const hr = document.createElement("tr");
  hr.append(Object.assign(document.createElement("th"), {textContent: "t"}));
  for (const nm of names)
    hr.append(Object.assign(document.createElement("th"), {textContent: nm}));
  tbl.append(hr);
  const rows = st.data.t.length;
  for (let i = Math.max(0, rows - 12); i < rows; i++) {
    const tr = document.createElement("tr");
    tr.append(Object.assign(document.createElement("td"),
      {textContent: fmtTs(st.data.t[i])}));
    for (const x of st.data.v[i])
      tr.append(Object.assign(document.createElement("td"),
        {textContent: fmtVal(x)}));
    tbl.append(tr);
  }
  st.table.replaceChildren(tbl);
}

function niceTicks(lo, hi, n) {
  if (!(hi > lo)) { hi = lo + 1; lo -= 1; }
  const span = hi - lo, step0 = span / n;
  const mag = Math.pow(10, Math.floor(Math.log10(step0)));
  const step = [1, 2, 5, 10].map(m => m * mag).find(s => span / s <= n) || 10 * mag;
  const ticks = [];
  for (let t = Math.ceil(lo / step) * step; t <= hi + 1e-12 * span; t += step)
    ticks.push(t);
  return ticks;
}

function draw(st) {
  const {canvas, data} = st;
  if (!data || !data.t.length) return;
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth, h = canvas.clientHeight;
  canvas.width = w * dpr; canvas.height = h * dpr;
  const ctx = canvas.getContext("2d");
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  ctx.clearRect(0, 0, w, h);
  const padL = 54, padR = 10, padT = 8, padB = 20;
  const t = data.t, v = data.v;
  const width = Math.min(v[0].length, 8);
  const t0 = t[0], t1 = t[t.length - 1] || t0 + 1;
  let lo = Infinity, hi = -Infinity;
  for (const row of v) for (let i = 0; i < width; i++) {
    if (isFinite(row[i])) { lo = Math.min(lo, row[i]); hi = Math.max(hi, row[i]); }
  }
  if (!isFinite(lo)) { lo = 0; hi = 1; }
  if (hi === lo) { hi += 1; lo -= 1; }
  const pad = (hi - lo) * 0.06;
  lo -= pad; hi += pad;
  const X = tt => padL + (w - padL - padR) * (tt - t0) / Math.max(1, t1 - t0);
  const Y = vv => padT + (h - padT - padB) * (1 - (vv - lo) / (hi - lo));
  // grid + y ticks
  ctx.strokeStyle = css("--grid"); ctx.lineWidth = 1;
  ctx.fillStyle = css("--ink-3");
  ctx.font = "11px system-ui"; ctx.textAlign = "right";
  for (const tick of niceTicks(lo, hi, 4)) {
    const y = Math.round(Y(tick)) + 0.5;
    ctx.beginPath(); ctx.moveTo(padL, y); ctx.lineTo(w - padR, y); ctx.stroke();
    ctx.fillText(fmtVal(tick), padL - 6, y + 3.5);
  }
  // baseline
  ctx.strokeStyle = css("--axis");
  ctx.beginPath();
  ctx.moveTo(padL, h - padB + 0.5); ctx.lineTo(w - padR, h - padB + 0.5);
  ctx.stroke();
  // x labels: start/end
  ctx.textAlign = "left";
  ctx.fillText(fmtTs(t0), padL, h - 6);
  ctx.textAlign = "right";
  ctx.fillText(fmtTs(t1), w - padR, h - 6);
  // series lines: 2px, round joins
  ctx.lineWidth = 2; ctx.lineJoin = "round"; ctx.lineCap = "round";
  for (let i = 0; i < width; i++) {
    ctx.strokeStyle = SERIES[i];
    ctx.beginPath();
    for (let k = 0; k < t.length; k++) {
      const x = X(t[k]), y = Y(v[k][i]);
      k ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
    }
    ctx.stroke();
  }
  // crosshair + tooltip
  if (st.hoverX != null && st.hoverX >= padL && st.hoverX <= w - padR) {
    let best = 0, bd = Infinity;
    for (let k = 0; k < t.length; k++) {
      const d = Math.abs(X(t[k]) - st.hoverX);
      if (d < bd) { bd = d; best = k; }
    }
    const hx = Math.round(X(t[best])) + 0.5;
    ctx.strokeStyle = css("--axis"); ctx.lineWidth = 1;
    ctx.beginPath(); ctx.moveTo(hx, padT); ctx.lineTo(hx, h - padB); ctx.stroke();
    // end-dots with surface ring
    for (let i = 0; i < width; i++) {
      const y = Y(v[best][i]);
      ctx.beginPath(); ctx.arc(X(t[best]), y, 5.5, 0, 7);
      ctx.fillStyle = css("--surface-1"); ctx.fill();
      ctx.beginPath(); ctx.arc(X(t[best]), y, 4, 0, 7);
      ctx.fillStyle = SERIES[i]; ctx.fill();
    }
    const names = seriesNames(data, v[0].length);
    const tip = st.tip;
    tip.replaceChildren();
    const tl = document.createElement("div");
    tl.className = "t"; tl.textContent = fmtTs(t[best]);
    tip.append(tl);
    for (let i = 0; i < width; i++) {
      const row = document.createElement("div");
      row.className = "row";
      const nm = document.createElement("span");
      nm.className = "n";
      const key = document.createElement("span");
      key.className = "key";
      key.style.borderTopColor = SERIES[i];
      nm.append(key, document.createTextNode(names[i]));
      const val = document.createElement("span");
      val.className = "v"; val.textContent = fmtVal(v[best][i]);
      row.append(nm, val);
      tip.append(row);
    }
    tip.style.display = "block";
    const left = hx + 12 + tip.offsetWidth < w ? hx + 12 : hx - tip.offsetWidth - 12;
    tip.style.left = left + "px";
    tip.style.top = padT + 6 + "px";
  } else {
    st.tip.style.display = "none";
  }
}

// -- timeline ---------------------------------------------------------------

function updateTimeline() {
  const scrub = document.getElementById("scrub");
  const label = document.getElementById("timelabel");
  const span = Math.max(1, dbSpan[1] - dbSpan[0]);
  if (live) {
    scrub.value = 1000;
    label.textContent = fmtTs(dbSpan[1]);
  } else {
    scrub.value = Math.round(1000 * (endUs() - dbSpan[0]) / span);
    label.textContent = fmtTs(endUs());
  }
}

function setLive(on) {
  live = on;
  if (on) { playing = false; updatePlayBtn(); }
  document.getElementById("livebtn").classList.toggle("on", on);
  updateTimeline();
}

function updatePlayBtn() {
  document.getElementById("playbtn").textContent = playing ? "❚❚" : "▶";
}

function initTimeline() {
  const scrub = document.getElementById("scrub");
  scrub.addEventListener("input", () => {
    live = false;
    document.getElementById("livebtn").classList.remove("on");
    scrubUs = dbSpan[0] + (dbSpan[1] - dbSpan[0]) * scrub.value / 1000;
    updateTimeline();
  });
  document.getElementById("livebtn").onclick = () => setLive(true);
  document.getElementById("playbtn").onclick = () => {
    if (live) { live = false; scrubUs = dbSpan[0]; }
    // restart from the beginning when play is pressed at the end —
    // otherwise the 100ms tick immediately re-clears `playing`
    if (scrubUs != null && scrubUs >= dbSpan[1]) scrubUs = dbSpan[0];
    document.getElementById("livebtn").classList.remove("on");
    playing = !playing;
    updatePlayBtn();
  };
  let lastStep = performance.now();
  setInterval(() => {
    const now = performance.now();
    const dt = (now - lastStep) * 1000;  // wall us
    lastStep = now;
    if (playing && !live) {
      scrubUs = Math.min(dbSpan[1], (scrubUs ?? dbSpan[0]) + dt);
      if (scrubUs >= dbSpan[1]) { playing = false; updatePlayBtn(); }
      updateTimeline();
    }
  }, 100);
  document.getElementById("view3d").onclick = toggle3d;
  document.getElementById("sqlbtn").onclick = toggleSql;
  document.getElementById("logsbtn").onclick = toggleLogs;
  document.getElementById("videobtn").onclick = toggleVideo;
}

// -- 3D viewport ------------------------------------------------------------

let view3d = null;  // {card, canvas, yaw, pitch, zoom, data}

function toggle3d() {
  if (view3d) { view3d.card.remove(); view3d = null; return; }
  if (document.querySelector(".empty")) document.querySelector(".empty").remove();
  const card = document.createElement("div");
  card.className = "card";
  const head = document.createElement("div");
  head.className = "head";
  const h2 = document.createElement("h2");
  h2.textContent = "3D trajectories";
  const hint = document.createElement("span");
  hint.className = "latest";
  hint.textContent = "drag to orbit · wheel to zoom";
  const tools = document.createElement("div");
  tools.className = "tools";
  const xbtn = document.createElement("button");
  xbtn.textContent = "close";
  xbtn.onclick = toggle3d;
  tools.append(xbtn);
  head.append(h2, hint, tools);
  const legend = document.createElement("div");
  legend.className = "legend";
  const canvas = document.createElement("canvas");
  canvas.style.height = "380px";
  canvas.style.cursor = "grab";
  card.append(head, legend, canvas);
  document.getElementById("cards").prepend(card);
  view3d = {card, canvas, legend, yaw: 0.7, pitch: 0.45, zoom: 1, data: []};
  let drag = null;
  canvas.addEventListener("pointerdown", e => {
    drag = [e.clientX, e.clientY];
    canvas.setPointerCapture(e.pointerId);
    canvas.style.cursor = "grabbing";
  });
  canvas.addEventListener("pointermove", e => {
    if (!drag) return;
    view3d.yaw += (e.clientX - drag[0]) * 0.008;
    view3d.pitch = Math.max(-1.5, Math.min(1.5,
      view3d.pitch + (e.clientY - drag[1]) * 0.008));
    drag = [e.clientX, e.clientY];
    draw3d();
  });
  canvas.addEventListener("pointerup", () => {
    drag = null; canvas.style.cursor = "grab";
  });
  canvas.addEventListener("wheel", e => {
    e.preventDefault();
    view3d.zoom *= Math.exp(-e.deltaY * 0.001);
    draw3d();
  }, {passive: false});
  poll3d();
}

async function poll3d() {
  const me = view3d;
  if (!me) return;
  try {
    const names = components.map(c => c.name)
      .filter(n => n.endsWith(".world_pos"));
    const stop = endUs();
    const reqs = names.slice(0, 8).map(n => {
      const params = new URLSearchParams({name: n, max_points: 400});
      if (!live) params.set("stop_us", String(stop + 1));
      if (windowUs != null) params.set("start_us", String(stop - windowUs));
      return fetch("/api/series?" + params).then(r => r.json());
    });
    const results = await Promise.all(reqs);
    if (view3d !== me) return;  // closed (or reopened) while fetching:
                                // never write stale data into a new panel
    me.data = results.filter(d => d.t.length);
    renderLegend3d();
    draw3d();
  } catch (e) { /* retry next poll */ }
  if (view3d === me) setTimeout(poll3d, 700);
}

function renderLegend3d() {
  const lg = view3d.legend;
  lg.replaceChildren();
  view3d.data.forEach((d, i) => {
    const item = document.createElement("span");
    const key = document.createElement("span");
    key.className = "key";
    key.style.borderTopColor = SERIES[i % 8];
    item.append(key,
      document.createTextNode(d.name.replace(/\.world_pos$/, "")));
    lg.append(item);
  });
}

function draw3d() {
  if (!view3d) return;
  const {canvas, data} = view3d;
  const dpr = window.devicePixelRatio || 1;
  const w = canvas.clientWidth, h = canvas.clientHeight;
  canvas.width = w * dpr; canvas.height = h * dpr;
  const ctx = canvas.getContext("2d");
  ctx.setTransform(dpr, 0, 0, dpr, 0, 0);
  ctx.clearRect(0, 0, w, h);
  // world_pos rows are [qx qy qz qw, x y z]; gather xyz extents
  let ext = 1e-9;
  const cen = [0, 0, 0];
  let npts = 0;
  for (const d of data) for (const row of d.v) {
    cen[0] += row[4]; cen[1] += row[5]; cen[2] += row[6]; npts++;
  }
  if (npts) { cen[0] /= npts; cen[1] /= npts; cen[2] /= npts; }
  for (const d of data) for (const row of d.v) {
    ext = Math.max(ext, Math.abs(row[4] - cen[0]),
      Math.abs(row[5] - cen[1]), Math.abs(row[6] - cen[2]));
  }
  const cy = Math.cos(view3d.yaw), sy = Math.sin(view3d.yaw);
  const cp = Math.cos(view3d.pitch), sp = Math.sin(view3d.pitch);
  const scale = 0.42 * Math.min(w, h) / ext * view3d.zoom;
  const P = (x, y, z) => {
    x -= cen[0]; y -= cen[1]; z -= cen[2];
    const x1 = x * cy + y * sy, y1 = -x * sy + y * cy;
    // pitch about the screen-x axis; canvas y grows downward
    return [w / 2 + x1 * scale, h / 2 + (y1 * sp - z * cp) * scale];
  };
  // axes triad
  ctx.lineWidth = 1;
  ctx.strokeStyle = css("--axis");
  ctx.fillStyle = css("--ink-3");
  ctx.font = "11px system-ui";
  const axisLen = ext * 0.5;
  const o = P(cen[0], cen[1], cen[2]);
  for (const [dx, dy, dz, nm] of [[axisLen, 0, 0, "x"], [0, axisLen, 0, "y"],
                                   [0, 0, axisLen, "z"]]) {
    const p = P(cen[0] + dx, cen[1] + dy, cen[2] + dz);
    ctx.beginPath(); ctx.moveTo(o[0], o[1]); ctx.lineTo(p[0], p[1]);
    ctx.stroke();
    ctx.fillText(nm, p[0] + 3, p[1] - 3);
  }
  // trajectories
  ctx.lineWidth = 2; ctx.lineJoin = "round"; ctx.lineCap = "round";
  data.forEach((d, i) => {
    ctx.strokeStyle = SERIES[i % 8];
    ctx.beginPath();
    d.v.forEach((row, k) => {
      const p = P(row[4], row[5], row[6]);
      k ? ctx.lineTo(p[0], p[1]) : ctx.moveTo(p[0], p[1]);
    });
    ctx.stroke();
    // current position: marker with surface ring + name label
    const last = d.v[d.v.length - 1];
    const p = P(last[4], last[5], last[6]);
    ctx.beginPath(); ctx.arc(p[0], p[1], 6.5, 0, 7);
    ctx.fillStyle = css("--surface-1"); ctx.fill();
    ctx.beginPath(); ctx.arc(p[0], p[1], 5, 0, 7);
    ctx.fillStyle = SERIES[i % 8]; ctx.fill();
    ctx.fillStyle = css("--ink-2");
    ctx.fillText(d.name.replace(/\.world_pos$/, ""), p[0] + 9, p[1] + 4);
  });
}

// -- schematic-driven layout -------------------------------------------------

let schematicApplied = false;

async function applySchematic() {
  if (schematicApplied) return;
  try {
    const sch = await fetch("/api/schematic").then(r => r.json());
    schematicApplied = true;  // latch only on success so a hiccup retries
    const have = new Set(components.map(c => c.name));
    const want = [...new Set(sch.components)].filter(n => have.has(n));
    for (const name of want.slice(0, 6)) {
      if (!open.has(name)) openCard(components.find(c => c.name === name));
    }
    if (schematicHasVideo(sch.panels) && !videoCard) toggleVideo();
  } catch (e) { /* no schematic: user picks manually */ }
}

// -- SQL console -------------------------------------------------------------

let sqlCard = null;

function toggleSql() {
  if (sqlCard) { sqlCard.remove(); sqlCard = null; return; }
  if (document.querySelector(".empty")) document.querySelector(".empty").remove();
  const card = document.createElement("div");
  card.className = "card";
  const head = document.createElement("div");
  head.className = "head";
  const h2 = document.createElement("h2");
  h2.textContent = "SQL";
  const tools = document.createElement("div");
  tools.className = "tools";
  const xbtn = document.createElement("button");
  xbtn.textContent = "close";
  xbtn.onclick = toggleSql;
  tools.append(xbtn);
  head.append(h2, tools);
  const row = document.createElement("div");
  row.style.cssText = "display:flex;gap:8px;margin:8px 0";
  const input = document.createElement("input");
  input.placeholder = "select * from …  (table names: python -m elodin_tpu.db list)";
  input.style.cssText = "flex:1;padding:6px 8px;border:1px solid var(--axis);" +
    "border-radius:6px;background:var(--page);color:var(--ink-1);font:12px ui-monospace,monospace";
  const run = document.createElement("button");
  run.textContent = "run";
  run.style.cssText = "font:12px system-ui;padding:4px 12px;border-radius:6px;" +
    "border:1px solid var(--axis);background:var(--surface-1);color:var(--ink-1);cursor:pointer";
  row.append(input, run);
  const out = document.createElement("div");
  out.style.cssText = "max-height:300px;overflow:auto";
  card.append(head, row, out);
  document.getElementById("cards").prepend(card);
  sqlCard = card;
  const exec = async () => {
    out.replaceChildren();
    try {
      const res = await fetch("/api/sql?q=" + encodeURIComponent(input.value));
      if (!res.ok) throw new Error(await res.text());
      const data = await res.json();
      const tbl = document.createElement("table");
      tbl.className = "vals";
      const hr = document.createElement("tr");
      for (const c of data.columns)
        hr.append(Object.assign(document.createElement("th"), {textContent: c}));
      tbl.append(hr);
      for (const r of data.rows) {
        const tr = document.createElement("tr");
        for (const v of r)
          tr.append(Object.assign(document.createElement("td"),
            {textContent: v == null ? "" : String(v)}));
        tbl.append(tr);
      }
      const note = document.createElement("div");
      note.style.cssText = "font-size:11px;color:var(--ink-3);margin:4px 0";
      note.textContent = `${data.rows.length} of ${data.total_rows} rows`;
      out.append(note, tbl);
    } catch (e) {
      const err = document.createElement("div");
      err.style.cssText = "color:var(--critical);font-size:12px;padding:6px";
      err.textContent = String(e.message || e);
      out.append(err);
    }
  };
  run.onclick = exec;
  input.onkeydown = e => { if (e.key === "Enter") exec(); };
  input.focus();
}

// -- msg-log pane ------------------------------------------------------------

let logsCard = null;

function toggleLogs() {
  if (logsCard) { logsCard.st.open = false; logsCard.remove(); logsCard = null; return; }
  if (document.querySelector(".empty")) document.querySelector(".empty").remove();
  const card = document.createElement("div");
  card.className = "card";
  const head = document.createElement("div");
  head.className = "head";
  const h2 = document.createElement("h2");
  h2.textContent = "message logs";
  const sel = document.createElement("select");
  sel.style.cssText = "font:12px system-ui;padding:3px 6px;border:1px solid " +
    "var(--axis);border-radius:5px;background:var(--page);color:var(--ink-1)";
  const tools = document.createElement("div");
  tools.className = "tools";
  const xbtn = document.createElement("button");
  xbtn.textContent = "close";
  xbtn.onclick = toggleLogs;
  tools.append(xbtn);
  head.append(h2, sel, tools);
  const out = document.createElement("div");
  out.style.cssText = "max-height:260px;overflow:auto;font:12px ui-monospace," +
    "monospace;color:var(--ink-2)";
  card.append(head, out);
  document.getElementById("cards").prepend(card);
  const st = {open: true};
  card.st = st;
  logsCard = card;
  const poll = async () => {
    if (!st.open) return;
    try {
      const logs = await fetch("/api/msg-logs").then(r => r.json());
      const cur = sel.value;
      sel.replaceChildren();
      for (const l of logs) {
        const o = document.createElement("option");
        o.value = l.id;
        o.textContent = `${l.name} (${l.entries})`;
        sel.append(o);
      }
      if ([...sel.options].some(o => o.value === cur)) sel.value = cur;
      if (sel.value) {
        const msgs = await fetch("/api/msgs?id=" + sel.value + "&limit=40")
          .then(r => r.json());
        out.replaceChildren();
        for (const m of msgs) {
          const line = document.createElement("div");
          line.textContent = `${fmtTs(m.t)}  ${m.text}`;
          out.append(line);
        }
        out.scrollTop = out.scrollHeight;
      }
    } catch (e) { /* retry */ }
    if (st.open) setTimeout(poll, 1000);
  };
  poll();
}

// -- video pane ---------------------------------------------------------------

let videoCard = null;

function toggleVideo() {
  if (videoCard) { videoCard.remove(); videoCard = null; return; }
  if (document.querySelector(".empty")) document.querySelector(".empty").remove();
  const card = document.createElement("div");
  card.className = "card";
  const head = document.createElement("div");
  head.className = "head";
  const h2 = document.createElement("h2");
  h2.textContent = "video";
  const sel = document.createElement("select");
  sel.style.cssText = "font:12px system-ui;padding:3px 6px;border:1px solid " +
    "var(--axis);border-radius:5px;background:var(--page);color:var(--ink-1)";
  const tools = document.createElement("div");
  tools.className = "tools";
  const xbtn = document.createElement("button");
  xbtn.textContent = "close";
  xbtn.onclick = toggleVideo;
  tools.append(xbtn);
  head.append(h2, sel, tools);
  const vid = document.createElement("video");
  vid.controls = true;
  vid.style.cssText = "width:100%;max-height:380px;background:#000;border-radius:6px";
  const note = document.createElement("div");
  note.style.cssText = "font-size:11px;color:var(--ink-3);margin:4px 0";
  card.append(head, vid, note);
  document.getElementById("cards").prepend(card);
  videoCard = card;
  const load = () => {
    // MP4 is muxed server-side on demand; the <video> element decodes
    if (sel.value) vid.src = "/api/video?id=" + sel.value;
  };
  sel.onchange = load;
  fetch("/api/videos").then(r => r.json()).then(vs => {
    if (videoCard !== card) return;  // closed while the fetch was in flight
    sel.replaceChildren();
    for (const v of vs) {
      const o = document.createElement("option");
      o.value = v.id;
      o.textContent = `${v.name} (${v.frames} frames)`;
      sel.append(o);
    }
    note.textContent = vs.length ? "" : "no H.264 message logs in this DB";
    load();
  }).catch(() => { note.textContent = "video list unavailable"; });
}

function schematicHasVideo(panels) {
  for (const p of panels || []) {
    if (p.kind === "video_stream" || schematicHasVideo(p.children)) return true;
  }
  return false;
}

function buildRanges() {
  const bar = document.getElementById("ranges");
  for (const [label, us] of RANGES) {
    const b = document.createElement("button");
    b.textContent = label;
    if (us === windowUs) b.className = "on";
    b.onclick = () => {
      windowUs = us;
      for (const btn of bar.querySelectorAll("button"))
        btn.classList.toggle("on", btn === b);
    };
    bar.append(b);
  }
}

document.getElementById("search").addEventListener("input", renderList);
buildRanges();
initTimeline();
refreshComponents();
setInterval(refreshComponents, 2000);
