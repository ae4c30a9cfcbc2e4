"""JSONL span sink → Chrome trace event JSON (Perfetto-loadable).

``python -m repro_torch.obs.export --chrome-trace runs/dse.trace.jsonl``
writes ``runs/dse.trace.json`` with complete ("X") events: one slice
per span, placed on the pid/tid track it ran on, with the trace/span/
parent ids and correlation baggage in ``args`` so Perfetto's query/
flow UI can follow a campaign across the service process, the labeler
pool's worker processes, and fleet worker hosts.

Torn tails are expected (the sink is append-only and runs die): bad
lines are skipped and counted, never fatal.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, Iterable, List, Tuple

__all__ = ["load_jsonl", "to_chrome_trace", "main"]


def load_jsonl(path: str) -> Tuple[List[Dict], int]:
    """Parse a span sink file; returns (spans, skipped_lines)."""
    spans: List[Dict] = []
    skipped = 0
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                skipped += 1
                continue
            if isinstance(rec, dict) and "name" in rec and "t0" in rec:
                spans.append(rec)
            else:
                skipped += 1
    return spans, skipped


def to_chrome_trace(spans: Iterable[Dict]) -> Dict:
    """Chrome trace-event format: https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU"""
    events: List[Dict] = []
    procs: Dict[int, str] = {}
    for rec in spans:
        pid = int(rec.get("pid", 0))
        tid = int(rec.get("tid", 0))
        attrs = rec.get("attrs") or {}
        name = str(rec.get("name", "?"))
        events.append({
            "ph": "X",
            "name": name,
            "cat": name.split(".", 1)[0],
            "ts": float(rec["t0"]) * 1e6,          # µs epoch
            "dur": max(float(rec.get("dur", 0.0)) * 1e6, 1.0),
            "pid": pid,
            "tid": tid,
            "args": {
                "trace": rec.get("trace"),
                "span": rec.get("span"),
                "parent": rec.get("parent"),
                **attrs,
            },
        })
        if pid not in procs:
            w = attrs.get("worker")
            procs[pid] = f"fleet worker {w} (pid {pid})" if w else f"pid {pid}"
    for pid, label in procs.items():
        events.append({
            "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
            "args": {"name": label},
        })
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.export",
        description="Convert a --trace JSONL span sink for trace viewers.",
    )
    ap.add_argument("input", help="span sink file (JSONL, one span per line)")
    ap.add_argument(
        "--chrome-trace", action="store_true",
        help="emit Chrome trace event JSON (open in Perfetto / about:tracing)",
    )
    ap.add_argument(
        "-o", "--output", default=None,
        help="output path (default: <input minus .jsonl>.trace.json)",
    )
    args = ap.parse_args(argv)
    if not args.chrome_trace:
        ap.error("pick an output format (--chrome-trace)")
    spans, skipped = load_jsonl(args.input)
    out = args.output
    if out is None:
        base = args.input
        if base.endswith(".jsonl"):
            base = base[: -len(".jsonl")]
        if base.endswith(".trace"):
            base = base[: -len(".trace")]
        out = base + ".trace.json"
    doc = to_chrome_trace(spans)
    with open(out, "w", encoding="utf-8") as fh:
        json.dump(doc, fh)
    traces = {s.get("trace") for s in spans}
    print(
        f"[obs.export] {len(spans)} spans ({len(traces)} traces, "
        f"{skipped} bad lines skipped) -> {out}",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
