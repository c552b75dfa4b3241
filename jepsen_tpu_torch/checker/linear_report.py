"""Linearizability failure rendering (jepsen_tpu/checker/linear_report.py).

On an invalid verdict the reference renders ``linear.svg`` via
knossos.linear.report (jepsen/src/jepsen/checker.clj:205-212): the ops
around the failure and the configurations the search was still holding
when the fatal return killed them. This is the matplotlib equivalent,
truncated to 10 configs / a 10-op window exactly like the reference
truncates ``:final-paths``/``:configs`` ("Writing these can take
*hours*", checker.clj:213-216).

The figure has two bands:

* a timeline of the ops overlapping the failing op — one lane per
  process, invoke→completion span bars, the fatal op in red;
* the surviving configurations just before death — one line each,
  ``state=... linearized={...} pending={...}`` referencing ops by their
  timeline labels.

The figure is a ``Figure`` of its own, not pyplot's, as in
``perf_plots``: checks run on threads.
"""
from __future__ import annotations

# copied from jepsen_tpu/checker/linear_report.py:25-26
WINDOW = 10         # ops drawn around the failure (reference's truncation)
MAX_CONFIGS = 10


# copied from jepsen_tpu/checker/linear_report.py:29-31
def _op_label(i: int, op: dict) -> str:
    f, v = op.get("f"), op.get("value")
    return f"{i}:{f} {v!r}" if v is not None else f"{i}:{f}"


# copied from jepsen_tpu/checker/linear_report.py:34-62
def _window_ops(history: list, failed_idx: int) -> list[tuple[int, dict, int]]:
    """The failing invocation plus the WINDOW-1 invocations nearest before
    it, as (history index of invoke, invoke op, completion index|-1)."""
    # pair invokes with completions by process
    completion: dict[int, int] = {}
    open_inv: dict = {}
    for i, op in enumerate(history):
        t = op.get("type")
        p = op.get("process")
        if t == "invoke":
            open_inv[p] = i
        elif t in ("ok", "fail", "info"):
            j = open_inv.pop(p, None)
            if j is not None:
                completion[j] = i
    # the failed index may be a completion: map back to its invocation
    fail_inv = failed_idx
    op = history[failed_idx] if failed_idx < len(history) else {}
    if op.get("type") != "invoke":
        for inv, comp in completion.items():
            if comp == failed_idx:
                fail_inv = inv
                break
    invs = [i for i, o in enumerate(history) if o.get("type") == "invoke"
            and i <= fail_inv]
    picked = invs[-WINDOW:]
    if fail_inv not in picked and fail_inv < len(history):
        picked.append(fail_inv)
    return [(i, history[i], completion.get(i, -1)) for i in picked]


# copied from jepsen_tpu/checker/linear_report.py:65-133, on a Figure of
# its own
def render_failure(history: list, result, path: str) -> str | None:
    """Writes the failure figure to ``path`` (PNG). Returns the path, or
    None when there is nothing to draw (valid result or empty history)."""
    if getattr(result, "valid", None) is not False or not history:
        return None
    from matplotlib.figure import Figure

    failed_idx = getattr(result, "failed_op_index", -1)
    if failed_idx < 0 or failed_idx >= len(history):
        return None
    ops = _window_ops(history, failed_idx)
    if not ops:
        return None
    fail_inv = ops[-1][0] if history[failed_idx].get("type") == "invoke" \
        else next((i for i, _, c in ops if c == failed_idx), ops[-1][0])

    procs = sorted({history[i].get("process") for i, _, _ in ops},
                   key=repr)
    lane = {p: k for k, p in enumerate(procs)}
    configs = (getattr(result, "final_configs", None) or [])[:MAX_CONFIGS]

    fig_h = 0.5 * len(procs) + 0.28 * max(1, len(configs)) + 1.6
    fig = Figure(figsize=(10, fig_h))
    ax, axc = fig.subplots(
        2, 1,
        gridspec_kw={"height_ratios": [max(1, len(procs)),
                                       max(1, len(configs)) * 0.6]})

    # --- timeline band ---------------------------------------------------
    lo = min(i for i, _, _ in ops)
    hi = max(max(c for _, _, c in ops), failed_idx, fail_inv) + 1
    for i, op, comp in ops:
        p = lane[op.get("process")]
        end = comp if comp >= 0 else hi  # crashed: open to the right edge
        fatal = i == fail_inv
        ax.barh(p, end - i, left=i, height=0.6,
                color="#d62728" if fatal else "#6baed6",
                edgecolor="black", linewidth=0.5, alpha=0.9)
        ax.text(i + 0.1, p, _op_label(i, op), va="center", fontsize=7)
    ax.set_yticks(range(len(procs)))
    ax.set_yticklabels([f"proc {p}" for p in procs], fontsize=8)
    ax.set_xlim(lo - 0.5, hi + 0.5)
    ax.set_xlabel("history index", fontsize=8)
    ax.set_title(
        f"Linearizability failure at op {failed_idx}: "
        f"{history[failed_idx].get('f')} "
        f"{history[failed_idx].get('value')!r} "
        f"(no surviving configuration)", fontsize=9)
    ax.invert_yaxis()

    # --- configuration band ----------------------------------------------
    axc.axis("off")
    if configs:
        lines = [
            f"state={c.get('state')!r}  "
            f"linearized={c.get('linearized')}  pending={c.get('pending')}"
            for c in configs]
        txt = "Configurations before the fatal return "
        txt += f"(showing {len(configs)}):\n" + "\n".join(lines)
    else:
        txt = "No configuration detail available (device verdict; re-run " \
              "with accelerator='cpu' for the exact dying frontier)."
    axc.text(0, 1, txt, va="top", ha="left", fontsize=7, family="monospace")

    fig.tight_layout()
    fig.savefig(path, dpi=120, bbox_inches="tight")
    return path
