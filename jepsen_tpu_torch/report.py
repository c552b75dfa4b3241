"""Report helpers (the port of jepsen_tpu/report.py; reference:
jepsen/src/jepsen/report.clj — a
stdout-capturing macro writing a store file), plus the human-readable
telemetry summary folded into each run's store dir."""
from __future__ import annotations

import contextlib
import io

from jepsen_tpu_torch import store

# copied from jepsen_tpu/report.py:12-83 (whole)


@contextlib.contextmanager
def to(test: dict, filename: str):
    """Captures stdout within the block and writes it to the test's store
    dir (report.clj:7)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        yield buf
    store.path_mk(test, filename).write_text(buf.getvalue())


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in labels.items()) + "}"


def metrics_summary(snapshot: list[dict]) -> str:
    """Formats a registry snapshot (telemetry.Registry.snapshot rows)
    as the aligned text block written to metrics-summary.txt — counters
    and gauges one per line, histograms with count/mean/p50/p95/max."""
    counters, gauges, hists, events = [], [], [], []
    for row in snapshot:
        kind = row.get("type")
        if kind == "counter":
            counters.append(row)
        elif kind == "gauge":
            gauges.append(row)
        elif kind == "histogram":
            hists.append(row)
        elif kind == "event":
            events.append(row)
    lines: list[str] = []

    def section(title, rows, fmt):
        if not rows:
            return
        lines.append(title)
        for r in rows:
            lines.append("  " + fmt(r))
        lines.append("")

    section("counters", counters, lambda r: (
        f"{r['name']}{_fmt_labels(r['labels'])} = {r['value']:g}"))
    section("gauges", gauges, lambda r: (
        f"{r['name']}{_fmt_labels(r['labels'])} = {r['value']:g}"))

    def hist_line(r):
        mean = r["sum"] / r["count"] if r["count"] else 0.0
        qs = "".join(f" {q}={r[q]:.6g}" for q in ("p50", "p95")
                     if r.get(q) is not None)
        mx = f" max={r['max']:.6g}" if r.get("max") is not None else ""
        return (f"{r['name']}{_fmt_labels(r['labels'])} "
                f"count={r['count']} mean={mean:.6g}{qs}{mx}")

    section("histograms", hists, hist_line)
    section("events", events, lambda r: (
        f"t={r['time']:.3f} {r['name']} "
        + " ".join(f"{k}={v}" for k, v in (r.get("fields") or {}).items())))
    return "\n".join(lines)


def write_metrics_summary(test: dict, registry,
                          filename: str = "metrics-summary.txt") -> None:
    """metrics-summary.txt: the at-a-glance companion to metrics.prom /
    metrics.json (core.analyze calls this at export time)."""
    snapshot = registry.snapshot()
    if not snapshot:
        return
    with to(test, filename):
        print(f"telemetry summary — {test.get('name')} "
              f"{test.get('start_time')}\n")
        print(metrics_summary(snapshot))
