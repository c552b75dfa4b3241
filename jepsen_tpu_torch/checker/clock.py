"""Clock-offset plot (jepsen_tpu/checker/clock.py, after jepsen/src/jepsen/
checker/clock.clj).

Nemesis ops may carry ``{"clock-offsets": {node: ms}}`` values (emitted by
the clock nemesis when it measures per-node wall-clock offsets); this
renders one line per node over test time, on a ``Figure`` of its own as
``perf_plots`` draws (not pyplot, which threads share).
"""
from __future__ import annotations

from collections import defaultdict

from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import Checker

# copied from jepsen_tpu/checker/clock.py:14
NS = 1e9


# copied from jepsen_tpu/checker/clock.py:17-33
def history_to_datasets(history: list[dict]) -> dict[str, list[tuple]]:
    """{node: [(time-s, offset-ms)...]} (clock.clj:13-34)."""
    out: dict[str, list[tuple]] = defaultdict(list)
    for op in history:
        v = op.get("value")
        offsets = None
        if isinstance(v, dict):
            offsets = v.get("clock-offsets")
        if op.get("f") == "check-offsets" and offsets is None \
                and isinstance(v, dict):
            offsets = v
        if not isinstance(offsets, dict):
            continue
        t = op.get("time", 0) / NS
        for node, ms in offsets.items():
            if isinstance(ms, (int, float)):
                out[str(node)].append((t, float(ms)))
    return dict(out)


# copied from jepsen_tpu/checker/clock.py:36-55, on a Figure of its own
def plot(test: dict, history: list[dict], output) -> bool:
    """Renders clock-skew.png; returns False when no data (clock.clj:47-75)."""
    data = history_to_datasets(history)
    if not data:
        return False
    from matplotlib.figure import Figure
    fig = Figure(figsize=(9, 4), dpi=100)
    ax = fig.subplots()
    for node, pts in sorted(data.items()):
        arr = sorted(pts)
        ax.plot([t for t, _ in arr], [o for _, o in arr], "-o", ms=3,
                label=node)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("clock offset (ms)")
    ax.set_title(f"{test.get('name', 'test')} clock offsets")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(output, bbox_inches="tight")
    return True


# copied from jepsen_tpu/checker/clock.py:58-66
class ClockPlot(Checker):
    def name(self):
        return "clock-plot"

    def check(self, test, history, opts):
        d = opts.get("subdirectory")
        plot(test, history,
             store.path_mk(test, *filter(None, [d, "clock-skew.png"])))
        return {"valid?": True}


# copied from jepsen_tpu/checker/clock.py:69-70
def clock_plot() -> Checker:
    return ClockPlot()
