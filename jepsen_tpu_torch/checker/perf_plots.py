"""Performance plots: latency and throughput graphs over the history, with
shaded nemesis-activity regions (jepsen_tpu/checker/perf_plots.py, after
jepsen/src/jepsen/checker/perf.clj — gnuplot there; matplotlib here, no
subprocess).

The history is reduced once to numpy arrays (time, latency) and every
graph is a vectorized aggregation. Unlike the reference, each graph
draws on its own ``matplotlib.figure.Figure`` (rendered by the Agg
canvas that ``savefig`` picks for a PNG) instead of ``pyplot``: a
``Compose`` runs its checkers on threads, and pyplot's figure registry
and current-figure state are shared by every thread of the process. The
pixels are the reference's.
"""
from __future__ import annotations

import logging
from collections import defaultdict

import numpy as np

from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.utils import history_to_latencies, nemesis_intervals

logger = logging.getLogger("jepsen_tpu_torch.checker.perf_plots")

# copied from jepsen_tpu/checker/perf_plots.py:24-28
DEFAULT_QUANTILES = (0.0, 0.5, 0.95, 0.99, 1.0)
NS = 1e9

TYPE_COLORS = {"ok": "#81BFFC", "info": "#FFA400", "fail": "#FF1E90"}
NEMESIS_SHADE = "#dddddd"


# copied from jepsen_tpu/checker/perf_plots.py:31-35
def invokes_with_latency(history: list[dict]) -> list[dict]:
    h = history_to_latencies(history)
    return [op for op in h
            if op.get("type") == "invoke" and op.get("process") != "nemesis"
            and "latency" in op]


# copied from jepsen_tpu/checker/perf_plots.py:38-41
def bucket_points(times_s: np.ndarray, dt: float) -> np.ndarray:
    """Bucket index for each time; bucket centers at (i + .5) * dt
    (perf.clj:21-49)."""
    return np.floor(times_s / dt).astype(np.int64)


# copied from jepsen_tpu/checker/perf_plots.py:44-58
def latencies_to_quantiles(times_s, lats_ms, dt: float,
                           qs=DEFAULT_QUANTILES) -> dict[float, list[tuple]]:
    """{q: [(bucket-center-time, latency-ms)...]} (perf.clj:63-85)."""
    if len(times_s) == 0:
        return {q: [] for q in qs}
    buckets = bucket_points(np.asarray(times_s), dt)
    out: dict[float, list[tuple]] = {q: [] for q in qs}
    for b in np.unique(buckets):
        sel = np.sort(np.asarray(lats_ms)[buckets == b])
        center = (b + 0.5) * dt
        n = len(sel)
        for q in qs:
            idx = min(n - 1, int(np.ceil(q * n)) - 1) if q > 0 else 0
            out[q].append((center, float(sel[max(0, idx)])))
    return out


# copied from jepsen_tpu/checker/perf_plots.py:61-76
def rate(history: list[dict], dt: float) -> dict[tuple, list[tuple]]:
    """{(f, type): [(bucket-center, ops/sec)...]} (perf.clj:127-141)."""
    groups: dict[tuple, list[float]] = defaultdict(list)
    for op in history:
        if op.get("process") == "nemesis":
            continue
        if op.get("type") not in ("ok", "fail", "info"):
            continue
        groups[(op.get("f"), op.get("type"))].append(op.get("time", 0) / NS)
    out = {}
    for k, ts in groups.items():
        arr = np.asarray(ts)
        buckets = bucket_points(arr, dt)
        out[k] = [((b + 0.5) * dt, float((buckets == b).sum()) / dt)
                  for b in np.unique(buckets)]
    return out


# copied from jepsen_tpu/checker/perf_plots.py:79-87
def nemesis_activity(history: list[dict]) -> list[tuple[float, float]]:
    """[(start-s, stop-s)] shaded regions (perf.clj:184-270)."""
    end = max((op.get("time", 0) for op in history), default=0) / NS
    out = []
    for start, stop in nemesis_intervals(history):
        t0 = start.get("time", 0) / NS
        t1 = stop.get("time", 0) / NS if stop is not None else end
        out.append((t0, t1))
    return out


# copied from jepsen_tpu/checker/perf_plots.py:90-112, over the port's
# store and fault-registry reader
def registry_fault_windows(test, history) -> list[dict]:
    """Fault windows from the durable ``faults.jsonl`` registry
    (nemesis/faults.py), in history time: fault-specific ``:f`` names
    classified by kind, and heals that happened OUTSIDE the history,
    which history-derived ``nemesis_intervals`` cannot see. [] when the
    test can't address a store dir or the run has no registry."""
    if not test or not isinstance(test, dict) \
            or test.get("start_time") is None:
        return []
    try:
        from jepsen_tpu_torch.nemesis import faults as faults_mod
        rows = faults_mod.load_rows(
            store.path(test, faults_mod.FAULTS_NAME))
        if not rows:
            return []
        return faults_mod.history_windows(history, rows)
    except Exception:  # noqa: BLE001 — the overlay is best-effort
        logger.exception("registry fault-window overlay failed")
        return []


# copied from jepsen_tpu/checker/perf_plots.py:115
FAULT_SHADE = "#f7dcc4"


# copied from jepsen_tpu/checker/perf_plots.py:118-139
def _shade_nemesis(ax, history, test=None):
    for t0, t1 in nemesis_activity(history):
        ax.axvspan(t0, t1, color=NEMESIS_SHADE, zorder=0)
    # registry-derived windows layer on top in a warmer shade, labeled
    # by kind: heals outside the history appear here though no history
    # op closes them
    windows = [w for w in registry_fault_windows(test, history)
               if w.get("start_time") is not None]
    # the open-window end needs a full history max(); a fault-free run
    # must not pay that O(n) pass per plot
    end = (max((op.get("time", 0) for op in history), default=0) / NS
           if windows else 0.0)
    for w in windows:
        t0 = w["start_time"] / NS
        t1 = w["end_time"] / NS if w.get("end_time") is not None else end
        ax.axvspan(t0, t1, color=FAULT_SHADE, alpha=0.55, zorder=0)
        label = str(w.get("kind"))
        if w.get("healed") and w.get("end_time") is None:
            label += f" (healed via {w.get('via')})"
        ax.annotate(label, xy=(t0, 1.0), xycoords=("data", "axes fraction"),
                    fontsize=6, color="#a05010", rotation=90,
                    va="top", ha="left")


# jepsen_tpu/checker/perf_plots.py:142-147 on a Figure of its own, not
# pyplot's (the module docstring says why)
def _figure():
    from matplotlib.figure import Figure
    fig = Figure(figsize=(9, 5), dpi=100)
    return fig, fig.subplots()


# copied from jepsen_tpu/checker/perf_plots.py:150
POINT_LIMIT = 10_000  # per completion type; matches timeline.py's cap idea


# copied from jepsen_tpu/checker/perf_plots.py:153-188, on _figure's Figure
def point_graph(test: dict, history: list[dict], output) -> None:
    """Raw latency scatter, colored by completion type (perf.clj:484-513).
    Downsampled evenly past POINT_LIMIT points per type, so a 1M-op run
    renders in seconds."""
    fig, ax = _figure()
    _shade_nemesis(ax, history, test)
    by_type: dict[str, list[tuple]] = defaultdict(list)
    for op in invokes_with_latency(history):
        comp = op.get("completion") or {}
        by_type[comp.get("type", "info")].append(
            (op.get("time", 0) / NS, op["latency"] / 1e6))
    downsampled = False
    for typ, pts in sorted(by_type.items()):
        arr = np.asarray(pts)
        if len(arr) > POINT_LIMIT:
            # stride-sample the bulk but KEEP the slow tail — the
            # outliers are what the scatter exists to reveal
            lat = arr[:, 1]
            tail = lat >= np.quantile(lat, 0.999)
            idx = np.zeros(len(arr), bool)
            idx[np.linspace(0, len(arr) - 1,
                            POINT_LIMIT).astype(np.int64)] = True
            arr = arr[idx | tail]
            downsampled = True
        ax.plot(arr[:, 0], arr[:, 1], ".", ms=3,
                color=TYPE_COLORS.get(typ, "#888888"), label=typ)
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    suffix = (f" (raw, downsampled to {POINT_LIMIT}/type)" if downsampled
              else " (raw)")
    ax.set_title(f"{test.get('name', 'test')} latency{suffix}")
    if by_type:
        ax.legend(loc="upper right", fontsize=8)
    fig.savefig(output, bbox_inches="tight")


# copied from jepsen_tpu/checker/perf_plots.py:191-210, on _figure's Figure
def quantiles_graph(test: dict, history: list[dict], output,
                    dt: float = 10.0, qs=DEFAULT_QUANTILES) -> None:
    """Latency quantiles over time (perf.clj:513-559)."""
    fig, ax = _figure()
    _shade_nemesis(ax, history, test)
    ops = invokes_with_latency(history)
    times = np.asarray([o.get("time", 0) / NS for o in ops])
    lats = np.asarray([o["latency"] / 1e6 for o in ops])
    for q, pts in sorted(latencies_to_quantiles(times, lats, dt, qs).items()):
        if pts:
            arr = np.asarray(pts)
            ax.plot(arr[:, 0], arr[:, 1], "-o", ms=3, label=f"q={q}")
    ax.set_yscale("log")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("latency (ms)")
    ax.set_title(f"{test.get('name', 'test')} latency quantiles")
    if ax.get_legend_handles_labels()[0]:   # empty history: no artists
        ax.legend(loc="upper right", fontsize=8)
    fig.savefig(output, bbox_inches="tight")


# copied from jepsen_tpu/checker/perf_plots.py:213-229, on _figure's Figure
def rate_graph(test: dict, history: list[dict], output,
               dt: float = 10.0) -> None:
    """Throughput per (f, completion-type) (perf.clj:559-599)."""
    fig, ax = _figure()
    _shade_nemesis(ax, history, test)
    for (f, typ), pts in sorted(rate(history, dt).items(), key=str):
        arr = np.asarray(pts)
        ax.plot(arr[:, 0], arr[:, 1], "-",
                color=TYPE_COLORS.get(typ, "#888888"), alpha=0.9,
                label=f"{f} {typ}")
    ax.set_xlabel("time (s)")
    ax.set_ylabel("throughput (ops/s)")
    ax.set_title(f"{test.get('name', 'test')} rate")
    if ax.get_legend_handles_labels()[0]:   # empty history: no artists
        ax.legend(loc="upper right", fontsize=8)
    fig.savefig(output, bbox_inches="tight")


# copied from jepsen_tpu/checker/perf_plots.py:232-245
class LatencyGraph(Checker):
    """(checker.clj:797-811)"""

    def name(self):
        return "latency-graph"

    def check(self, test, history, opts):
        d = opts.get("subdirectory")
        point_graph(test, history,
                    store.path_mk(test, *filter(None, [d, "latency-raw.png"])))
        quantiles_graph(test, history,
                        store.path_mk(test, *filter(None,
                                                    [d, "latency-quantiles.png"])))
        return {"valid?": True}


# copied from jepsen_tpu/checker/perf_plots.py:248-258
class RateGraph(Checker):
    """(checker.clj:813-824)"""

    def name(self):
        return "rate-graph"

    def check(self, test, history, opts):
        d = opts.get("subdirectory")
        rate_graph(test, history,
                   store.path_mk(test, *filter(None, [d, "rate.png"])))
        return {"valid?": True}


# copied from jepsen_tpu/checker/perf_plots.py:261-273
def latency_graph() -> Checker:
    return LatencyGraph()


def rate_graph_checker() -> Checker:
    return RateGraph()


def perf() -> Checker:
    """latency + rate composed (checker.clj:826-829)."""
    from jepsen_tpu_torch.checker import compose
    return compose({"latency-graph": latency_graph(),
                    "rate-graph": rate_graph_checker()})
