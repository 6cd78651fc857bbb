#!/usr/bin/env python
"""trace_tool: render trace trees + critical paths from tracer JSONL.

Reads the Jaeger-compatible JSONL that `tracer_export_path` appends
(one span per line, ceph_tpu_torch.common.tracer), groups spans into traces,
prints each trace as an indented tree with per-span timing, and walks
the CRITICAL PATH — the chain of spans that actually bounds the op's
wall time — so "the write took 12 ms" decomposes into queue wait vs
EC encode vs journal commit vs replica RTT at a glance (the jaeger-ui
trace-view role, in a terminal).

Usage:
    python -m ceph_tpu_torch.tools.trace_tool trace.jsonl [--trace <id>] [--limit N]
    python -m ceph_tpu_torch.tools.trace_tool traces.json --critical-report

Also accepts `dump_tracing` admin output or a `ceph trace show <id>`
document (the mgr flight-recorder store's merged span tree) piped on
stdin with `-`.

`--critical-report` aggregates ACROSS traces instead of rendering each:
for every stage (service: span name) on any trace's critical path it
reports how much wall time that stage contributed (span self-time on
the path, i.e. duration minus the on-path child it was waiting on) at
p50/p99 — over a batch of tail-promoted traces this answers "when ops
are slow, WHERE are they slow" in one table.

Port of the reference package's `tools/trace_tool.py`; it reads files and
touches no device.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_spans(path: str) -> list[dict]:
    """Spans (normalized dicts, seconds) from a JSONL export file, a
    `dump_tracing` JSON dump, or stdin ("-")."""
    raw = (
        sys.stdin.read() if path == "-"
        else open(path, encoding="utf-8").read()
    )
    spans: list[dict] = []
    stripped = raw.lstrip()
    if stripped.startswith("{") and '"traces"' in stripped[:2000]:
        # dump_tracing admin output
        doc = json.loads(raw)
        for trace in doc.get("traces", []):
            spans.extend(trace.get("spans", []))
        return spans
    if stripped.startswith("{") and '"spans"' in stripped[:2000]:
        # `ceph trace show <id>` document: the mgr collector's merged
        # span tree — spans are already internal-shape dump dicts
        doc = json.loads(raw)
        return list(doc.get("spans", []))
    for line in raw.splitlines():
        line = line.strip()
        if not line:
            continue
        spans.append(_from_jaeger(json.loads(line)))
    return spans


def _from_jaeger(j: dict) -> dict:
    """Jaeger JSON (µs) -> the internal span dict (seconds)."""
    parent = None
    for ref in j.get("references", []):
        if ref.get("refType") == "CHILD_OF":
            parent = ref.get("spanID")
    return {
        "trace_id": j["traceID"],
        "span_id": j["spanID"],
        "parent_id": parent,
        "name": j.get("operationName", "?"),
        "service": (j.get("process") or {}).get("serviceName", "?"),
        "start": j.get("startTime", 0) / 1e6,
        "duration": j.get("duration", 0) / 1e6,
        "tags": {
            t["key"]: t.get("value") for t in j.get("tags", [])
        },
        "events": [
            {"ts": lg.get("timestamp", 0) / 1e6,
             "event": (lg.get("fields") or [{}])[0].get("value", "")}
            for lg in j.get("logs", [])
        ],
    }


def group_traces(spans: list[dict]) -> dict[str, list[dict]]:
    traces: dict[str, list[dict]] = {}
    for s in spans:
        traces.setdefault(s["trace_id"], []).append(s)
    return traces


def _children_of(spans: list[dict]) -> dict[str | None, list[dict]]:
    ids = {s["span_id"] for s in spans}
    kids: dict[str | None, list[dict]] = {}
    for s in spans:
        parent = s["parent_id"] if s["parent_id"] in ids else None
        kids.setdefault(parent, []).append(s)
    for v in kids.values():
        v.sort(key=lambda s: s["start"])
    return kids


def critical_path(spans: list[dict]) -> list[dict]:
    """The chain root -> ... -> leaf that bounds the trace's wall time:
    from each span, descend into the LATEST-FINISHING child (the one
    the parent was still waiting on when it completed). Everything off
    this chain overlapped something on it — shortening off-path spans
    cannot shorten the op."""
    kids = _children_of(spans)
    roots = kids.get(None, [])
    if not roots:
        return []
    node = max(roots, key=lambda s: s["start"] + s["duration"])
    path = [node]
    while True:
        ch = kids.get(node["span_id"])
        if not ch:
            return path
        node = max(ch, key=lambda s: s["start"] + s["duration"])
        path.append(node)


def path_contributions(spans: list[dict]) -> list[tuple[str, float]]:
    """(stage, seconds) self-time of every critical-path node: a node's
    contribution is its duration minus its on-path child's — the time
    the op spent IN that stage rather than waiting below it. The leaf
    keeps its full duration. Sums to roughly the root's wall time."""
    path = critical_path(spans)
    out: list[tuple[str, float]] = []
    for i, s in enumerate(path):
        stage = f"{s['service']}: {s['name']}"
        child_dur = path[i + 1]["duration"] if i + 1 < len(path) else 0.0
        out.append((stage, max(0.0, s["duration"] - child_dur)))
    return out


def _quantile(sorted_vals: list[float], q: float) -> float:
    """Nearest-rank quantile over an ascending list."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


def critical_report(traces: dict[str, list[dict]]) -> str:
    """Aggregate per-stage critical-path contributions across traces:
    p50/p99/max self-time plus each stage's share of the summed wall
    time — the "where do slow ops spend their time" table."""
    stages: dict[str, list[float]] = {}
    for spans in traces.values():
        for stage, secs in path_contributions(spans):
            stages.setdefault(stage, []).append(secs)
    grand = sum(sum(v) for v in stages.values())
    lines = [
        f"critical-path contribution over {len(traces)} trace(s) "
        f"({grand * 1e3:.3f}ms total on-path time)",
        f"{'STAGE':<40} {'N':>4} {'P50':>10} {'P99':>10} "
        f"{'MAX':>10} {'SHARE':>6}",
    ]
    rows = sorted(
        stages.items(), key=lambda kv: sum(kv[1]), reverse=True
    )
    for stage, vals in rows:
        vals.sort()
        share = 100.0 * sum(vals) / grand if grand > 0 else 0.0
        lines.append(
            f"{stage:<40} {len(vals):>4} "
            f"{_quantile(vals, 0.50) * 1e3:>8.3f}ms "
            f"{_quantile(vals, 0.99) * 1e3:>8.3f}ms "
            f"{max(vals) * 1e3:>8.3f}ms {share:>5.1f}%"
        )
    return "\n".join(lines)


def _fmt_ms(seconds: float) -> str:
    return f"{seconds * 1e3:8.3f}ms"


def render_trace(spans: list[dict], out=None) -> str:
    """One trace: indented span tree + the critical path summary."""
    lines: list[str] = []
    kids = _children_of(spans)
    t0 = min(s["start"] for s in spans)
    total = max(s["start"] + s["duration"] for s in spans) - t0
    lines.append(
        f"trace {spans[0]['trace_id']}  "
        f"({len(spans)} spans, {total * 1e3:.3f}ms)"
    )

    def walk(span: dict, depth: int) -> None:
        off = span["start"] - t0
        tags = "".join(
            f" {k}={v}" for k, v in sorted(span["tags"].items())
        )
        lines.append(
            f"  {_fmt_ms(span['duration'])}  "
            f"+{off * 1e3:9.3f}ms  "
            + "  " * depth
            + f"{span['service']}: {span['name']}{tags}"
        )
        for ev in span.get("events", []):
            lines.append(
                " " * 25 + "  " * depth
                + f"  . +{(ev['ts'] - t0) * 1e3:9.3f}ms {ev['event']}"
            )
        for child in kids.get(span["span_id"], []):
            walk(child, depth + 1)

    for root in kids.get(None, []):
        walk(root, 0)

    path = critical_path(spans)
    if path:
        lines.append("  critical path:")
        prev_end = None
        for s in path:
            gap = ""
            if prev_end is not None and s["start"] > prev_end:
                gap = f"  (+{(s['start'] - prev_end) * 1e3:.3f}ms gap)"
            pct = (
                100.0 * s["duration"] / total if total > 0 else 100.0
            )
            lines.append(
                f"    {_fmt_ms(s['duration'])} ({pct:5.1f}%)  "
                f"{s['service']}: {s['name']}{gap}"
            )
            prev_end = s["start"] + s["duration"]
    text = "\n".join(lines)
    if out is not None:
        print(text, file=out)
    return text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("path", help="tracer JSONL export, dump_tracing "
                                 "JSON, or - for stdin")
    ap.add_argument("--trace", default=None,
                    help="render only this trace id")
    ap.add_argument("--limit", type=int, default=10,
                    help="max traces rendered (newest first)")
    ap.add_argument("--critical-report", action="store_true",
                    help="aggregate per-stage critical-path p50/p99 "
                         "contributions across all traces")
    args = ap.parse_args(argv)
    traces = group_traces(load_spans(args.path))
    if args.critical_report:
        if not traces:
            print("no traces to aggregate", file=sys.stderr)
            return 1
        print(critical_report(traces))
        return 0
    if args.trace is not None:
        traces = {k: v for k, v in traces.items() if k == args.trace}
        if not traces:
            print(f"no trace {args.trace!r} in {args.path}",
                  file=sys.stderr)
            return 1
    ordered = sorted(
        traces.values(),
        key=lambda ss: min(s["start"] for s in ss),
        reverse=True,
    )
    for spans in ordered[: args.limit]:
        render_trace(spans, out=sys.stdout)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
