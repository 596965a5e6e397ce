"""Exporters: Prometheus-style text, JSON-lines trace dump, and
perfetto-compatible (Chrome trace-event) JSON.

All three are pure functions of a registry/tracer snapshot — no I/O, no
global state — so tests assert exact output and callers pick their sink
(stdout, files, ``ui.perfetto.dev`` for the timeline).
"""
from __future__ import annotations

import json

from .metrics import qualified_name


def prometheus_text(registry) -> str:
    """The registry as Prometheus exposition text: one ``# TYPE`` comment
    per metric family, counters/gauges as single samples, histograms as
    cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count`` series."""
    lines = []
    seen_types = set()
    metrics = sorted(registry.metrics(), key=lambda m: (m.name, m.labels))
    for m in metrics:
        if m.name not in seen_types:
            seen_types.add(m.name)
            lines.append(f"# TYPE {m.name} {m.kind}")
        if m.kind == "histogram":
            snap = m.snap()
            base = dict(m.labels)
            for le, cum in snap["buckets"].items():
                labels = tuple(sorted({**base, "le": le}.items()))
                lines.append(
                    f"{qualified_name(m.name + '_bucket', labels)} {cum}")
            lines.append(
                f"{qualified_name(m.name + '_sum', m.labels)} "
                f"{snap['sum']}")
            lines.append(
                f"{qualified_name(m.name + '_count', m.labels)} "
                f"{snap['count']}")
        else:
            lines.append(f"{qualified_name(m.name, m.labels)} {m.snap()}")
    return "\n".join(lines) + ("\n" if lines else "")


def trace_jsonl(tracer) -> str:
    """Completed spans as JSON lines (one span per line, oldest first) —
    the grep/jq-friendly dump."""
    return "".join(json.dumps(r, sort_keys=True) + "\n"
                   for r in tracer.records())


def perfetto_trace(tracer, pid: int = 0) -> dict:
    """Spans as Chrome trace-event JSON (the format perfetto /
    chrome://tracing load directly): complete ("X") events with
    microsecond timestamps, one track per thread, thread names as "M"
    metadata events.  Clock origin is the tracer's clock (monotonic or
    fake) — relative placement is what the timeline shows."""
    records = tracer.records()
    tids: dict[str, int] = {}
    events = []
    for r in records:
        tid = tids.setdefault(r["thread"], len(tids) + 1)
        args = dict(r["attrs"])
        args["sid"] = r["sid"]
        if r["parent"] is not None:
            args["parent_sid"] = r["parent"]
        events.append({
            "name": r["name"], "cat": "repro_torch.obs", "ph": "X",
            "ts": r["t0"] * 1e6, "dur": max(0.0, (r["t1"] - r["t0"]) * 1e6),
            "pid": pid, "tid": tid, "args": args,
        })
    meta = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
             "args": {"name": tname}} for tname, tid in tids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def write_artifacts(obs, directory, prefix: str = "obs") -> dict:
    """Write the three exports for one Obs bundle into ``directory``:
    ``<prefix>_metrics.prom``, ``<prefix>_trace.jsonl``,
    ``<prefix>_trace.json`` (perfetto).  Returns {kind: path}."""
    import os

    os.makedirs(directory, exist_ok=True)
    paths = {}

    p = os.path.join(directory, f"{prefix}_metrics.prom")
    with open(p, "w") as fh:
        fh.write(prometheus_text(obs.registry))
    paths["prometheus"] = p

    p = os.path.join(directory, f"{prefix}_trace.jsonl")
    with open(p, "w") as fh:
        fh.write(trace_jsonl(obs.tracer))
    paths["jsonl"] = p

    p = os.path.join(directory, f"{prefix}_trace.json")
    with open(p, "w") as fh:
        json.dump(perfetto_trace(obs.tracer), fh, indent=1)
    paths["perfetto"] = p
    return paths
