"""Dashboard — HTTP observability endpoint.

Analog of the reference's dashboard head (``dashboard/head.py:81`` + feature
modules; SURVEY §1 L6) scoped to the API layer: JSON state endpoints (the
state API over HTTP), a Prometheus ``/metrics`` scrape (what the reference's
metrics agent exports), and a minimal HTML overview. Runs an aiohttp loop in
a daemon thread like the Serve proxy.
"""

from __future__ import annotations

import asyncio
import json
import threading
import time
from collections import deque
from typing import Dict, Optional


class _EvFeed:
    """Per-client incremental task-event state: the GCS cursor this client
    has consumed up to, plus the rolling cache serving its pane."""

    __slots__ = ("cursor", "cache", "last_seen")

    def __init__(self):
        self.cursor: Optional[int] = None
        self.cache: deque = deque(maxlen=500)
        self.last_seen = time.monotonic()


class Dashboard:
    #: per-client event-feed bounds: browsers don't announce disconnects,
    #: so a client is "gone" when it hasn't polled for the TTL (the UI
    #: polls every 2s); the cap bounds worst-case memory against id churn.
    _EV_CLIENT_CAP = 32
    _EV_CLIENT_TTL_S = 60.0

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self.host = host
        self.port = port
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()
        # Cursor'd task-event feed, PER CLIENT (each browser tab passes a
        # random ?client= id): each poll fetches only events past that
        # client's cursor. Bounded + stale-evicted — an id-churning or
        # vanished client must not pin cursor/cache entries forever.
        self._ev_lock = threading.Lock()
        self._ev_clients: Dict[str, _EvFeed] = {}

    def start(self) -> "Dashboard":
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        if not self._started.wait(10):
            raise RuntimeError("dashboard failed to start")
        return self

    def stop(self) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self._loop.stop)
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- server --------------------------------------------------------------
    def _serve(self) -> None:
        from aiohttp import web

        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        self._loop = loop

        app = web.Application()
        app.router.add_get("/", self._index)
        app.router.add_get("/api/cluster_summary", self._json(self._summary))
        app.router.add_get("/api/nodes", self._json(lambda: _state().list_nodes()))
        app.router.add_get("/api/actors", self._json(lambda: _state().list_actors()))
        app.router.add_get("/api/tasks", self._json(lambda: _state().list_tasks()))
        app.router.add_get("/api/jobs", self._json(lambda: _state().list_jobs()))
        app.router.add_get(
            "/api/placement_groups", self._json(lambda: _state().list_placement_groups())
        )
        app.router.add_get("/api/node_stats", self._json(_node_stats))
        # Log viewer + task-event feed (reference:
        # dashboard/modules/log/log_manager.py, modules/event/) over the
        # existing GCS log aggregation and task-event pipeline.
        app.router.add_get("/api/logs", self._logs)
        app.router.add_get("/api/events", self._events)
        app.router.add_get("/api/metrics_summary",
                           self._json(_metrics_summary))
        app.router.add_get("/metrics", self._metrics)
        app.router.add_get("/timeline", self._timeline)
        app.router.add_get("/api/trace/{trace_id}", self._trace)

        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, self.host, self.port)
        loop.run_until_complete(site.start())
        self._started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(runner.cleanup())
            from ray_tpu_torch.utils.eventloop import drain_and_close_loop

            drain_and_close_loop(loop, "dashboard")

    def _summary(self):
        return _state().cluster_summary()

    def _json(self, fn):
        from aiohttp import web

        async def handler(request):
            loop = asyncio.get_event_loop()
            data = await loop.run_in_executor(None, fn)
            return web.Response(
                text=json.dumps(data, default=str), content_type="application/json"
            )

        return handler

    async def _logs(self, request):
        """Aggregated worker logs from the GCS "logs" pubsub channel.

        ``?cursor=N`` resumes from an absolute message index (the client
        stores the returned ``cursor`` and polls); ``?node=<hex>`` and
        ``?worker=<name>`` filter; ``?timeout=S`` long-polls up to 25s.
        """
        from aiohttp import web

        cursor = int(request.query.get("cursor", 0))
        timeout = min(25.0, float(request.query.get("timeout", 0)))
        node = request.query.get("node")
        worker = request.query.get("worker")
        loop = asyncio.get_event_loop()

        def fetch():
            from ray_tpu_torch.core.runtime import get_runtime

            end, batches = get_runtime().gcs.poll_channel(
                "logs", cursor, timeout)
            out = []
            for batch in batches:
                for entry in batch:
                    if node and not entry.get("node_id", "").startswith(node):
                        continue
                    if worker and worker not in entry.get("worker", ""):
                        continue
                    out.append(entry)
            return {"cursor": end, "batches": out}

        data = await loop.run_in_executor(None, fetch)
        return web.Response(text=json.dumps(data),
                            content_type="application/json")

    async def _metrics(self, request):
        from aiohttp import web

        loop = asyncio.get_event_loop()
        text = await loop.run_in_executor(None, _cluster_metrics_text)
        return web.Response(text=text, content_type="text/plain")

    async def _timeline(self, request):
        """Chrome-trace dump. ``?trace_id=`` narrows to one trace (indexed
        GCS lookup + flow events); ``?client=`` names the caller's
        incremental cursor cache for the full-timeline path."""
        from aiohttp import web

        import ray_tpu_torch

        trace_id = request.query.get("trace_id")
        client = request.query.get("client", "dashboard")
        loop = asyncio.get_event_loop()
        trace = await loop.run_in_executor(
            None, lambda: ray_tpu_torch.timeline(trace_id=trace_id, client=client))
        return web.Response(text=json.dumps(trace), content_type="application/json")

    async def _trace(self, request):
        """One assembled trace's raw span/task events, oldest first — the
        ``gcs.trace(trace_id)`` side-table lookup over HTTP."""
        from aiohttp import web

        trace_id = request.match_info["trace_id"]
        loop = asyncio.get_event_loop()

        def fetch():
            from ray_tpu_torch.core.runtime import get_runtime

            return get_runtime().gcs.trace(trace_id)

        events = await loop.run_in_executor(None, fetch)
        return web.Response(text=json.dumps(events, default=str),
                            content_type="application/json")

    async def _index(self, request):
        from aiohttp import web

        return web.Response(text=_INDEX_HTML, content_type="text/html")


    async def _events(self, request):
        from aiohttp import web

        client = request.query.get("client", "")
        loop = asyncio.get_event_loop()
        data = await loop.run_in_executor(
            None, lambda: self._task_event_feed(client))
        return web.Response(text=json.dumps(data, default=str),
                            content_type="application/json")

    def _ev_state(self, client: str) -> _EvFeed:
        """Look up (or create) one client's feed state; evict the stale and
        the over-cap while here. Caller holds ``_ev_lock``."""
        now = time.monotonic()
        st = self._ev_clients.get(client)
        if st is None:
            st = self._ev_clients[client] = _EvFeed()
        st.last_seen = now
        dead = [k for k, v in self._ev_clients.items()
                if k != client and now - v.last_seen > self._EV_CLIENT_TTL_S]
        for k in dead:
            del self._ev_clients[k]
        while len(self._ev_clients) > self._EV_CLIENT_CAP:
            oldest = min((k for k in self._ev_clients if k != client),
                         key=lambda k: self._ev_clients[k].last_seen)
            del self._ev_clients[oldest]
        return st

    def _task_event_feed(self, client: str = "", limit: int = 500):
        """Most recent task/span events from the GCS task-event store
        (``gcs_task_manager.cc`` analog), newest first.

        Incremental PER CLIENT: each poll ships only events past that
        client's cursor (``task_events_since``) instead of re-copying the
        whole event log every 2s; the client's rolling cache serves its
        pane (two tabs no longer race one shared cursor)."""
        from ray_tpu_torch.core.runtime import get_runtime

        gcs = get_runtime().gcs
        with self._ev_lock:
            st = self._ev_state(client)
            cursor = st.cursor
        # RPC outside the lock: a hung/restarting GCS must not park every
        # poll (and the shared executor threads) behind one blocked reader.
        new_cursor, events = gcs.task_events_since(cursor, limit)
        with self._ev_lock:
            if st.cursor == cursor:
                st.cursor = new_cursor
                for e in events:
                    st.cache.append(_event_row(e))
            # else: a concurrent poll of the SAME client id already
            # advanced past us — its events are in the cache; appending
            # ours again would duplicate rows.
            return list(st.cache)[::-1]


def _state():
    from ray_tpu_torch.util import state

    return state


def _event_row(e: dict) -> dict:
    return {
        "ts": e.get("time") or e.get("ts") or "",
        "kind": e.get("state", e.get("kind", "event")),
        "name": e.get("name", ""),
        "task_id": str(e.get("task_id", ""))[-16:],
        "node": str(e.get("node_id", ""))[:12],
        "duration": e.get("duration"),
        "detail": {k: v for k, v in e.items()
                   if k not in ("time", "ts", "state", "kind", "name",
                                "task_id", "node_id", "duration")},
    }


def _flush_local_exporter() -> None:
    """The serving process's own exporter may be mid-interval — flush it so
    its series are fresh in the merged exposition."""
    from ray_tpu_torch.core.runtime import get_runtime

    exporter = getattr(get_runtime(), "_metrics_exporter", None)
    if exporter is not None:
        exporter.flush()


def _cluster_metrics_text() -> str:
    """Merged cluster-wide exposition from the GCS aggregator, falling back
    to this process's local registry when no runtime is initialized, the
    GCS is unreachable, or the export pipeline is disabled."""
    text = ""
    try:
        from ray_tpu_torch.core.runtime import get_runtime

        _flush_local_exporter()
        text = get_runtime().gcs.metrics_text()
    except Exception:  # noqa: BLE001 — no runtime / GCS unreachable
        from ray_tpu_torch.utils.logging import get_logger, log_swallowed

        log_swallowed(get_logger("dashboard"), "cluster metrics read")
    if text:
        return text
    from ray_tpu_torch.util.metrics import prometheus_text

    return prometheus_text()


def _metrics_summary() -> dict:
    from ray_tpu_torch.core.runtime import get_runtime

    _flush_local_exporter()
    return get_runtime().gcs.metrics_summary()


def _node_stats():
    """Fan out to every alive node daemon's reporter endpoint (the per-node
    dashboard-agent role, SURVEY §1 L6)."""
    from ray_tpu_torch.core.runtime import get_runtime

    rt = get_runtime()
    out = []
    daemons = getattr(rt, "_daemons", None)
    for n in rt.gcs.alive_nodes():
        entry = {"node_id": n.node_id.hex(), "address": n.address,
                 "resources": n.resources}
        if daemons is not None and n.address:
            try:
                entry.update(daemons.get(n.address).call("node_stats",
                                                         timeout=10.0))
            except Exception as e:  # noqa: BLE001 — daemon busy/dead
                entry["error"] = str(e)
        out.append(entry)
    return out


# Single-page UI: vanilla JS polling the JSON APIs — the reference ships a
# React app (dashboard/client); this covers the same panes (cluster summary,
# per-node utilization, actors, tasks, jobs, placement groups) without a
# build step.
_INDEX_HTML = """<!doctype html>
<html><head><title>ray_tpu_torch dashboard</title><style>
 body{font-family:system-ui,sans-serif;margin:0;background:#fafafa;color:#222}
 header{background:#1a237e;color:#fff;padding:10px 18px;font-size:18px}
 nav{background:#283593;padding:0 10px}
 nav button{background:none;border:none;color:#c5cae9;padding:10px 14px;
   cursor:pointer;font-size:14px}
 nav button.active{color:#fff;border-bottom:3px solid #ffca28}
 main{padding:16px;max-width:1200px}
 table{border-collapse:collapse;width:100%;background:#fff;font-size:13px}
 th,td{border:1px solid #ddd;padding:5px 8px;text-align:left}
 th{background:#e8eaf6}
 .bar{background:#e0e0e0;border-radius:3px;height:12px;width:120px;
   display:inline-block;vertical-align:middle}
 .bar>div{background:#3949ab;height:12px;border-radius:3px}
 .muted{color:#777;font-size:12px}
</style></head><body>
<header>ray_tpu_torch cluster</header>
<nav id="nav"></nav>
<main><div id="content">loading…</div>
<p class="muted">auto-refresh 2s · raw: <a href="/api/cluster_summary">summary</a>
 · <a href="/api/node_stats">node_stats</a> · <a href="/metrics">metrics</a>
 · <a href="/timeline">timeline</a></p></main>
<script>
const TABS = {
  Overview: renderOverview, Nodes: renderNodes, Actors: mkTable('/api/actors'),
  Tasks: mkTable('/api/tasks'), Jobs: mkTable('/api/jobs'),
  'Placement groups': mkTable('/api/placement_groups'),
  Logs: renderLogs, Events: renderEvents, Metrics: renderMetrics,
};
let logCursor = 0, logLines = [];
const clientId = Math.random().toString(36).slice(2);
let active = 'Overview';
const nav = document.getElementById('nav');
Object.keys(TABS).forEach(name => {
  const b = document.createElement('button');
  b.textContent = name;
  b.onclick = () => { active = name; refresh(); };
  nav.appendChild(b);
});
function setActive() {
  [...nav.children].forEach(b =>
    b.classList.toggle('active', b.textContent === active));
}
async function getJSON(u){ return (await fetch(u)).json(); }
function bar(frac){
  const pct = Math.round(Math.min(1, Math.max(0, frac)) * 100);
  return `<span class="bar"><div style="width:${pct}%"></div></span> ${pct}%`;
}
function escHtml(s){
  return String(s).replace(/&/g,'&amp;').replace(/</g,'&lt;')
    .replace(/>/g,'&gt;').replace(/"/g,'&quot;');
}
function table(rows){
  if (!rows || !rows.length) return '<p class="muted">none</p>';
  const cols = Object.keys(rows[0]);
  // Cell content is DATA (task names, event payloads, user metadata):
  // always escaped before it reaches innerHTML.
  return '<table><tr>' + cols.map(c=>`<th>${escHtml(c)}</th>`).join('') +
    '</tr>' + rows.map(r => '<tr>' + cols.map(c =>
      `<td>${escHtml(typeof r[c]==='object'?JSON.stringify(r[c]):r[c])}</td>`
    ).join('') + '</tr>').join('') + '</table>';
}
function mkTable(url){
  return async () => table(await getJSON(url));
}
async function renderOverview(){
  const s = await getJSON('/api/cluster_summary');
  return '<table>' + Object.entries(s).map(([k,v]) =>
    `<tr><th>${k}</th><td><pre style="margin:0">${JSON.stringify(v,null,1)}</pre></td></tr>`
  ).join('') + '</table>';
}
async function renderNodes(){
  const stats = await getJSON('/api/node_stats');
  return table(stats.map(n => ({
    node: (n.node_id||'').slice(0,12), address: n.address||'',
    workers: `${n.workers??'-'} (${n.idle??'-'} idle)`,
    cpu: n.cpu_percent!==undefined ? bar(n.cpu_percent/100) : '-',
    memory: n.mem_total ? bar(1 - n.mem_available/n.mem_total) : '-',
    'object store': n.store_capacity ?
      bar(n.shm_bytes/n.store_capacity) +
      ` <span class=muted>${(n.shm_bytes/1048576).toFixed(1)}MB</span>` : '-',
    spilled: n.spilled_objects??'-',
    resources: JSON.stringify(n.resources||{}),
  })));
}
async function renderLogs(){
  const d = await getJSON('/api/logs?cursor=' + logCursor);
  logCursor = d.cursor;
  for (const b of d.batches)
    for (const line of (b.lines||[]))
      logLines.push(`[${(b.node_id||'').slice(0,8)}/${b.worker||''}] ${line}`);
  if (logLines.length > 2000) logLines = logLines.slice(-2000);
  const esc = s => s.replace(/&/g,'&amp;').replace(/</g,'&lt;');
  return '<pre style="background:#111;color:#ddd;padding:10px;'+
    'max-height:70vh;overflow:auto;font-size:12px">' +
    (logLines.length ? logLines.map(esc).join('\\n')
                     : '(no worker log lines yet)') + '</pre>';
}
async function renderEvents(){
  const evs = await getJSON('/api/events?client=' + clientId);
  return table(evs.map(e => ({
    ts: e.ts, kind: e.kind, name: e.name, task: e.task_id,
    node: e.node,
    duration: e.duration != null ? e.duration.toFixed(4)+'s' : '-',
    detail: JSON.stringify(e.detail),
  })));
}
async function renderMetrics(){
  const s = await getJSON('/api/metrics_summary');
  const procs = table((s.processes||[]).map(p => ({
    node: (p.node_id||'').slice(0,12), component: p.component, pid: p.pid,
    'age (s)': p.age_s, metrics: p.metrics,
  })));
  const mets = table((s.metrics||[]).map(m => ({
    name: m.name, type: m.type, series: m.series,
    total: Math.round(m.total*1000)/1000,
  })));
  return '<h3>Reporting processes</h3>' + procs +
    '<h3>Cluster metrics</h3>' + mets +
    '<p class="muted">raw exposition: <a href="/metrics">/metrics</a></p>';
}
async function refresh(){
  setActive();
  try {
    document.getElementById('content').innerHTML = await TABS[active]();
  } catch (e) {
    document.getElementById('content').innerHTML =
      `<p class="muted">error: ${e}</p>`;
  }
}
refresh();
setInterval(refresh, 2000);
</script></body></html>
"""


def start_dashboard(host: str = "127.0.0.1", port: int = 8265) -> Dashboard:
    return Dashboard(host, port).start()
