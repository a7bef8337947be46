"""CLI — ``python -m ray_tpu_torch.scripts <cmd>`` (or the ``ray-tpu-torch``
entry point).

Analog of the reference's ``python/ray/scripts/scripts.py`` (``ray
status/list/summary/timeline``) for the in-runtime cluster model. argparse
only — no click dependency.
"""

from __future__ import annotations

import argparse
import json
import sys


def _init_from_args(args) -> None:
    import ray_tpu_torch

    ray_tpu_torch.init(
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        num_nodes=args.num_nodes,
    )


def _node_hex(node_id) -> str:
    return node_id.hex() if hasattr(node_id, "hex") else str(node_id)


def format_status(nodes, health, series, ingest) -> str:
    """One-screen cluster view from the existing metrics rollup — no new
    RPCs, just the exposition + the watchdog's states rendered together."""
    from ray_tpu_torch.devtools import postmortem

    lines = ["== nodes =="]
    for n in nodes:
        res = " ".join(f"{k}={v:g}" for k, v in sorted(
            (n.get("resources") or {}).items()))
        lines.append(f"  {_node_hex(n['node_id'])[:12]:<14} "
                     f"{'alive' if n.get('alive') else 'DEAD':<6} "
                     f"{n.get('address', '')}  {res}")
    lines.append("")
    lines.append("== component health ==")
    if not health:
        lines.append("  (watchdog has no subjects yet)")
    for s in health:
        key = s.get("key") or ()
        subject = ":".join(str(k) for k in key[1:])
        beacon = (f"  last ring write {s['beacon_ts']:.0f}"
                  if s.get("beacon_ts") else "")
        lines.append(f"  {s.get('kind', '?'):<10} {subject:<40} "
                     f"{str(s.get('state', '?')).upper()}{beacon}")
    sched = {s["tags"].get("counter"): s["value"]
             for s in postmortem.select(series, "ray_tpu_gcs_sched")}
    lines.append("")
    lines.append("== scheduler ==")
    for key in ("pending_demands", "leases", "capacity_blocks",
                "alive_nodes", "ingest_queued"):
        if key in sched:
            lines.append(f"  {key:<18}{sched[key]:g}")
    serve_names = sorted({s["name"] for s in series
                          if s["name"].startswith(("ray_tpu_serve",
                                                   "ray_tpu_llm",
                                                   "ray_tpu_paged",
                                                   "ray_tpu_kv"))})
    if serve_names:
        lines.append("")
        lines.append("== serve ==")
        for name in serve_names:
            if name.endswith(("_bucket", "_sum")):
                continue  # histogram internals; _count carries the rate
            total = sum(s["value"] for s in series if s["name"] == name)
            lines.append(f"  {name:<36}{total:g}")
    lines.append("")
    lines.append("== observability ingest ==")
    lines.append(f"  queued={ingest.get('queued', 0)} "
                 f"dropped={ingest.get('dropped', 0)} "
                 f"drained={ingest.get('drained', 0)}")
    return "\n".join(lines)


def cmd_status(args) -> int:
    if getattr(args, "gcs", None):
        # One-shot against a live cluster: everything below is served from
        # state the GCS already maintains for the dashboard.
        from ray_tpu_torch.core.rpc import RpcClient
        from ray_tpu_torch.devtools import postmortem

        client = RpcClient(args.gcs)
        try:
            nodes = client.call("list_nodes")
            health = client.call("health_states")
            series = postmortem.parse_prometheus(client.call("metrics_text"))
            ingest = client.call("ingest_stats")
        finally:
            client.close()
        if getattr(args, "json", False):
            print(json.dumps(
                {"nodes": nodes, "health": health, "series": series,
                 "ingest": ingest}, indent=2, default=str))
        else:
            print(format_status(nodes, health, series, ingest))
        return 0

    from ray_tpu_torch.util import state

    _init_from_args(args)
    print(json.dumps(state.cluster_summary(), indent=2, default=str))
    return 0


def cmd_debug(args) -> int:
    from ray_tpu_torch.devtools import postmortem

    gcs_events = None
    health = None
    if getattr(args, "gcs", None):
        from ray_tpu_torch.core.rpc import RpcClient

        client = RpcClient(args.gcs)
        try:
            gcs_events = client.call("task_events")
            health = client.call("health_states")
        finally:
            client.close()
    timeline = postmortem.build_timeline(
        session_dir=args.session, gcs_events=gcs_events,
        health_states=health)
    if getattr(args, "json", False):
        print(json.dumps(timeline, indent=2, default=str))
    else:
        print(postmortem.format_timeline(timeline, last_n=args.last))
    return 0 if timeline["processes"] else 1


def cmd_list(args) -> int:
    from ray_tpu_torch.util import state

    _init_from_args(args)
    fn = {
        "nodes": state.list_nodes,
        "actors": state.list_actors,
        "tasks": state.list_tasks,
        "objects": state.list_objects,
        "jobs": state.list_jobs,
        "placement-groups": state.list_placement_groups,
    }[args.resource]
    print(json.dumps(fn(), indent=2, default=str))
    return 0


def cmd_summary(args) -> int:
    from ray_tpu_torch.util import state

    _init_from_args(args)
    fn = {"tasks": state.summarize_tasks, "actors": state.summarize_actors}[args.resource]
    print(json.dumps(fn(), indent=2, default=str))
    return 0


def cmd_timeline(args) -> int:
    import ray_tpu_torch

    _init_from_args(args)
    trace = ray_tpu_torch.timeline(trace_id=args.trace_id)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    print(f"wrote {len(trace)} events to {args.output}")
    return 0


def _span_key(e: dict) -> str:
    # Spans carry their id in task_id; task events in span_id.
    return e.get("span_id") or str(e.get("task_id", ""))


def format_trace_tree(events) -> str:
    """Render one trace's events as an indented span tree with durations,
    plus the TTFT decomposition when the trace covers an LLM request."""
    if not events:
        return "(no events — unknown trace id, or the trace was unsampled)"
    by_id = {_span_key(e): e for e in events}
    children: dict = {}
    roots = []
    for e in events:
        parent = e.get("parent_span_id")
        if parent and parent in by_id:
            children.setdefault(parent, []).append(e)
        else:
            roots.append(e)
    start = lambda e: e.get("time", 0) - e.get("duration", 0)  # noqa: E731
    lines = [f"trace {events[0].get('trace_id', '?')}"]

    def walk(e, depth):
        dur = e.get("duration", 0)
        attrs = e.get("attrs") or {}
        extra = ("  " + " ".join(f"{k}={v}" for k, v in attrs.items())
                 if attrs else "")
        fail = "  FAILED" if e.get("state") == "FAILED" else ""
        lines.append(f"{'  ' * depth}{e.get('name', '?')}  "
                     f"{dur * 1e3:.2f}ms{fail}{extra}")
        for c in sorted(children.get(_span_key(e), []), key=start):
            walk(c, depth + 1)

    for r in sorted(roots, key=start):
        walk(r, 1)

    # TTFT decomposition: admission wait + prefill + first decode chunk.
    parts = []
    for name in ("llm.admission_wait", "llm.prefill"):
        found = [e for e in events if e.get("name") == name]
        if found:
            parts.append((name, min(found, key=start)["duration"]))
    decodes = [e for e in events if e.get("name") == "llm.decode_chunk"]
    if decodes:
        parts.append(("llm.decode_chunk[0]",
                      min(decodes, key=start)["duration"]))
    if parts:
        lines.append("")
        lines.append("TTFT breakdown:")
        for name, dur in parts:
            lines.append(f"  {name:<22}{dur * 1e3:.2f}ms")
        lines.append(f"  {'= TTFT':<22}"
                     f"{sum(d for _, d in parts) * 1e3:.2f}ms")
    return "\n".join(lines)


def cmd_trace(args) -> int:
    from ray_tpu_torch.core.runtime import get_runtime

    _init_from_args(args)
    events = get_runtime().gcs.trace(args.trace_id)
    if args.json:
        print(json.dumps(events, indent=2, default=str))
    else:
        print(format_trace_tree(events))
    return 0 if events else 1


def cmd_bench(args) -> int:
    # The repo's bench.py measures the JAX package, which this package never
    # imports; the port's own benchmark harness is not written yet.
    print("ray-tpu-torch bench: the port's benchmark is not written yet; "
          "nothing was run", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ray-tpu-torch",
                                     description="ray_tpu_torch CLI")
    parser.add_argument("--num-cpus", type=float, default=None)
    # --num-tpus is the alias init() also takes for num_gpus.
    parser.add_argument("--num-gpus", "--num-tpus", dest="num_gpus",
                        type=float, default=None)
    parser.add_argument("--num-nodes", type=int, default=1)
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_status = sub.add_parser("status", help="cluster summary")
    p_status.add_argument("--gcs", default=None, metavar="ADDR",
                          help="attach to a live cluster's GCS "
                               "(host:port) instead of starting one")
    p_status.add_argument("--json", action="store_true",
                          help="raw rollup instead of the rendered view")

    p_dbg = sub.add_parser(
        "debug", help="postmortem timeline from flight-recorder rings")
    p_dbg.add_argument("--session", default=None, metavar="DIR",
                       help="session dir holding *.ring files "
                            "(default: $RAY_TPU_SESSION_DIR)")
    p_dbg.add_argument("--gcs", default=None, metavar="ADDR",
                       help="also merge the GCS task-event/health tables")
    p_dbg.add_argument("--last", type=int, default=25,
                       help="events shown per timeline section")
    p_dbg.add_argument("--json", action="store_true",
                       help="machine-readable timeline")

    p_list = sub.add_parser("list", help="list cluster state")
    p_list.add_argument(
        "resource",
        choices=["nodes", "actors", "tasks", "objects", "jobs", "placement-groups"],
    )

    p_sum = sub.add_parser("summary", help="state counts")
    p_sum.add_argument("resource", choices=["tasks", "actors"])

    p_tl = sub.add_parser("timeline", help="dump chrome trace")
    p_tl.add_argument("-o", "--output", default="timeline.json")
    p_tl.add_argument("--trace-id", default=None,
                      help="dump only this trace (with flow events)")

    p_tr = sub.add_parser("trace", help="print one trace as a span tree")
    p_tr.add_argument("trace_id")
    p_tr.add_argument("--json", action="store_true",
                      help="raw events instead of the tree")

    sub.add_parser("bench", help="the port's benchmark (not written yet)")

    args = parser.parse_args(argv)
    return {
        "status": cmd_status,
        "list": cmd_list,
        "summary": cmd_summary,
        "timeline": cmd_timeline,
        "trace": cmd_trace,
        "bench": cmd_bench,
        "debug": cmd_debug,
    }[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
