/* Public Cluster dashboard — dependency-free browser client.
 *
 * Data flow: REST for snapshots (/v1/cluster, /v1/blocks), Server-Sent
 * Events for liveness. Admin sessions hold one cluster-wide stream;
 * plain users hold one stream per owned block (the gateway scopes the
 * feed to what the session may see). Every data call carries the bearer
 * token; EventSource cannot set headers, so streams pass it as
 * ?access_token= (the gateway accepts both).
 */
"use strict";

const $ = (id) => document.getElementById(id);
let TOKEN = localStorage.getItem("pc_token") || "";
let PROFILE = null;
let sources = [];          // open EventSource objects
let refreshTimer = null;   // debounce: many events -> one refresh

// lifecycle state -> status tone (the badge also always shows the name)
const TONES = {
  running: "good", active: "good", done: "good",
  queued: "warning", preempted: "warning",
  requested: "accent", approved: "accent", confirmed: "accent",
  expired: "serious",
  failed: "critical", denied: "critical",
};

async function api(method, path, body) {
  const res = await fetch(path, {
    method,
    headers: Object.assign(
      { "Authorization": "Bearer " + TOKEN },
      body !== undefined ? { "Content-Type": "application/json" } : {}),
    body: body !== undefined ? JSON.stringify(body) : undefined,
  });
  const data = await res.json().catch(() => ({}));
  if (!res.ok) throw new Error(data.error || res.status + " " + method + " " + path);
  return data;
}

// ------------------------------------------------------------ rendering
function renderCluster(rep) {
  $("free-chips").textContent = rep.free_chips;
  $("total-chips").textContent = rep.n_chips;
  $("queue-depth").textContent = rep.queue_depth;
  const util = rep.queue ? rep.queue.utilization_now : 0;
  $("util-value").textContent = Math.round(util * 100) + "%";
  $("util-meter").style.width = Math.min(100, util * 100) + "%";
  $("dl-hits").textContent = rep.deadlines.deadline_hits;
  $("dl-misses").textContent = rep.deadlines.deadline_misses;
  $("preempted").textContent = rep.preemption.preempted_total;
  $("resumed").textContent = rep.preemption.resumed_total;
  if (rep.compile) {
    const c = rep.compile;
    $("compile-cache").textContent =
      c.compile_hits_total + "/" +
      (c.compile_hits_total + c.compile_misses_total) + " (" +
      Math.round(100 * c.compile_hit_rate) + "%)";
  }
  if (rep.roofline) {
    $("mean-mfu").textContent = rep.roofline.n_modeled
      ? (100 * rep.roofline.mean_mfu).toFixed(1) + "%" : "—";
  }
  const pods = rep.pods || [];
  const live = pods.filter((p) => p.phase !== "dead");
  $("pods-live").textContent = live.length;
  $("migrations").textContent =
    rep.federation ? rep.federation.migrated_total : 0;
  $("pods-detail").textContent = pods.map(
    (p) => p.name + " " + p.free_chips + "/" + p.n_chips +
           (p.phase !== "ready" ? " (" + p.phase + ")" : "")).join(" · ");
  renderObs(rep.obs);
}

function sparkline(svg, points) {
  // points: [[t, v], ...] -> one polyline scaled to the 120x28 viewBox
  svg.replaceChildren();
  if (!points || points.length < 2) return;
  const vs = points.map((p) => p[1]);
  const vmax = Math.max(...vs, 1e-9);
  const step = 120 / (points.length - 1);
  const pts = points.map((p, i) =>
    (i * step).toFixed(1) + "," + (26 - 24 * p[1] / vmax).toFixed(1));
  const line = document.createElementNS("http://www.w3.org/2000/svg",
                                        "polyline");
  line.setAttribute("points", pts.join(" "));
  svg.appendChild(line);
}

function renderObs(obs) {
  if (!obs) return;
  $("pump-p90").textContent = obs.pump_tick && obs.pump_tick.count
    ? (obs.pump_tick.p90 * 1000).toFixed(1) + "ms" : "—";
  sparkline($("pump-spark"), (obs.series || {}).pump_tick_ms);
  $("http-429").textContent = obs.http_429;
  $("http-413").textContent = obs.http_413;
  $("sse-streams").textContent = obs.sse_streams;
  $("stragglers").textContent = (obs.stragglers || []).length;
  const pms = obs.postmortems || [];
  $("postmortems").textContent = pms.length;
  $("postmortem-detail").textContent = pms.length
    ? pms[0].reason + " · " + pms[0].name : "";
}

function fmtDeadline(b) {
  if (b.deadline_at == null) return "—";
  const left = b.deadline_at - Date.now() / 1000;
  if (left < 0) return "missed";
  return left > 120 ? Math.round(left / 60) + "m left"
                    : Math.round(left) + "s left";
}

function blockRow(b) {
  const tr = document.createElement("tr");
  const canAdmin = PROFILE && PROFILE.admin;
  const auto = b.autostep;
  const cells = [
    ["<span class=mono>" + b.app_id + "</span>"],
    [b.user],
    ["<span class=state data-tone=" + (TONES[b.state] || "") + ">" +
     b.state + "</span>" +
     (b.straggler ? "<span class=straggler-badge>straggler</span>" : "")],
    [b.pod == null ? "—" : "pod " + b.pod],
    [b.n_chips, "num"],
    [b.steps, "num"],
    [b.mfu == null ? "—" : (100 * b.mfu).toFixed(1) + "%", "num"],
    [b.priority, "num"],
    [fmtDeadline(b)],
    [auto ? "on · " + auto.steps_driven + " steps" +
            (auto.max_rate_hz ? " · " + auto.max_rate_hz + "/s" : "")
          : "off"],
  ];
  for (const [html, cls] of cells) {
    const td = document.createElement("td");
    if (cls) td.className = cls;
    td.innerHTML = html;
    tr.appendChild(td);
  }
  const td = document.createElement("td");
  td.className = "controls";
  const live = !["expired", "done", "failed", "denied"].includes(b.state);
  const mk = (label, fn, show) => {
    if (!show) return;
    const btn = document.createElement("button");
    btn.textContent = label;
    btn.onclick = () => fn().then(refreshSoon).catch((e) => alert(e.message));
    td.appendChild(btn);
  };
  mk(auto ? "autostep off" : "autostep on",
     () => api("POST", "/v1/blocks/" + b.app_id + "/autostep",
               { enabled: !auto }), live);
  mk("pace", () => {
    const v = prompt("max steps/s (empty = unpaced)", auto && auto.max_rate_hz || "");
    if (v === null) return Promise.resolve();
    return api("POST", "/v1/blocks/" + b.app_id + "/autostep",
               { max_rate_hz: v === "" ? null : Number(v) });
  }, live && !!auto);
  mk("preempt", () => api("POST", "/v1/blocks/" + b.app_id + "/preempt", {}),
     canAdmin && ["running", "active"].includes(b.state));
  mk("resume", () => api("POST", "/v1/blocks/" + b.app_id + "/resume", {}),
     canAdmin && b.state === "preempted");
  mk("expire", () => api("POST", "/v1/blocks/" + b.app_id + "/expire", {}),
     live);
  tr.appendChild(td);
  return tr;
}

async function refresh() {
  const [rep, blocks] = await Promise.all([
    api("GET", "/v1/cluster"), api("GET", "/v1/blocks")]);
  renderCluster(rep);
  const body = $("blocks-body");
  body.replaceChildren(...blocks.blocks.map(blockRow));
  $("no-blocks").hidden = blocks.blocks.length > 0;
  return blocks.blocks;
}

function refreshSoon() {
  if (refreshTimer) return;
  refreshTimer = setTimeout(() => { refreshTimer = null; refresh(); }, 250);
}

// ------------------------------------------------------------ live feed
function logEvent(ev) {
  const log = $("event-log");
  const li = document.createElement("li");
  const seq = document.createElement("span");
  seq.className = "seq";
  seq.textContent = ev.seq;
  const kind = document.createElement("span");
  kind.className = "kind";
  kind.textContent = ev.kind;
  const detail = document.createElement("span");
  detail.textContent = [
    ev.app_id, ev.state, ev.action, ev.reason,
    ev.kind === "step" ? (ev.step_s * 1000).toFixed(1) + "ms" : null,
    ev.kind === "utilization"
      ? Math.round(100 * ev.used_chips / ev.total_chips) + "%" : null,
    ev.kind === "pod" ? "pod " + ev.pod + " (" + ev.name + ")" : null,
    ev.kind === "migrated"
      ? "pod " + ev.from_pod + " → pod " + ev.to_pod : null,
    ev.kind === "postmortem" ? ev.name : null,
  ].filter(Boolean).join(" · ");
  li.append(seq, kind, detail);
  log.prepend(li);
  while (log.children.length > 200) log.lastChild.remove();
}

function openStream(path) {
  const es = new EventSource(
    path + (path.includes("?") ? "&" : "?") + "access_token=" +
    encodeURIComponent(TOKEN));
  es.onopen = () => {
    $("feed-state").textContent = "feed: live";
    $("feed-state").dataset.state = "live";
  };
  es.onmessage = null;      // typed events only (event: <kind>)
  for (const kind of ["state", "admitted", "enqueued", "dequeued",
                      "preempted", "resumed", "registered", "autostep",
                      "step", "compile", "utilization", "session",
                      "generate", "pod", "migrated", "postmortem"]) {
    es.addEventListener(kind, (msg) => {
      const ev = JSON.parse(msg.data);
      if (ev.kind !== "step" && ev.kind !== "utilization") refreshSoon();
      logEvent(ev);
    });
  }
  es.onerror = () => {
    $("feed-state").textContent = "feed: reconnecting";
    $("feed-state").dataset.state = "off";
  };
  sources.push(es);
  return es;
}

function closeStreams() {
  sources.forEach((es) => es.close());
  sources = [];
}

async function connectFeeds(blocks) {
  closeStreams();
  if (PROFILE.admin) {
    openStream("/v1/events/stream");
    return;
  }
  // plain users: one scoped stream per owned, still-interesting block
  for (const b of blocks) {
    if (!["expired", "done", "failed", "denied"].includes(b.state))
      openStream("/v1/blocks/" + b.app_id + "/events/stream");
  }
}

// ----------------------------------------------------------- bootstrap
async function connect() {
  PROFILE = (await api("GET", "/v1/profile")).profile;
  $("whoami").textContent = PROFILE.user + (PROFILE.admin ? " (admin)" : "");
  $("app").hidden = false;
  $("login-hint").hidden = true;
  const blocks = await refresh();
  await connectFeeds(blocks);
  // periodic safety net: SSE covers liveness, this covers clock-driven
  // fields (deadline countdowns) and any missed reconnect window
  setInterval(refreshSoon, 5000);
}

$("auth-form").addEventListener("submit", (e) => {
  e.preventDefault();
  TOKEN = $("token-input").value.trim();
  localStorage.setItem("pc_token", TOKEN);
  connect().catch((err) => {
    $("whoami").textContent = "auth failed: " + err.message;
    $("app").hidden = true;
    $("login-hint").hidden = false;
  });
});

if (TOKEN) {
  $("token-input").value = TOKEN;
  connect().catch(() => { /* stored token went stale: wait for input */ });
}
