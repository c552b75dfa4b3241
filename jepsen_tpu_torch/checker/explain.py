"""Anomaly forensics: the exact first anomaly of an invalid verdict and a
minimal witness (jepsen_tpu/checker/explain.py:54-398).

* **Localization.** In the transfer-matrix regime,
  :func:`jepsen_tpu_torch.ops.jitlin.matrix_localize` chains the frontier
  through the per-chunk operator products on the device
  (``prefix_alive.cu``) and rescans the first dead chunk on a frontier
  vector (``window_rescan.cu``); it lands on the event the exact CPU
  frontier rejects. Out of the regime, the CPU frontier's own rejection
  (``LinearResult.failed_event``) serves.
* **Witness shrink.** A bounded ddmin removes candidate op subsets from
  the guilty window and checks every candidate of a round in ONE
  ``window_rescan`` launch (``jitlin.matrix_window_rescan``), keeping
  only candidates that die at the *same* return. Ops already pending at
  the window's entry ride the carried frontier vector and are reported as
  context. Knobs: ``explain_shrink_budget`` (total candidate checks) and
  ``explain_max_witness_ops`` (stop shrinking below this), tolerantly
  coerced.

* **Artifacts.** :func:`write_artifacts` writes ``anomaly.json`` (the
  first anomaly's op, the witness's op indices with each op's process
  and timing, :func:`compose_anomaly`, and the fault windows of the
  run's ``faults.jsonl`` that overlap the witness) and
  ``witness-timeline.html`` (``checker/timeline.render_witness``) into
  the run's store dir, under ``independent/<k>`` for a key of a lifted
  history. Writing them never fails a check.

Not ported: ``explain_run`` and ``_explain_elle_run`` (explain.py:
538-618), the offline re-derivation of a stored run's forensics, whose
callers are the CLI and the append and wr workloads (ROADMAP Queue 1
item 11). With a live registry, :func:`explain_stream` exports ``explain_total{backend}``,
``explain_bisect_steps``, ``explain_latency_seconds`` and
``witness_ops`` (``_export_metrics``). Unlike the reference,
:func:`explain_stream` and :func:`first_failure` let an error of the
device localization propagate instead of settling on the CPU frontier;
the checkers' callers keep the reference's rule that forensics never
fail a check.
"""
from __future__ import annotations

import json
import logging
import time

import numpy as np

from jepsen_tpu_torch import telemetry

logger = logging.getLogger("jepsen_tpu_torch.checker.explain")

# copied from jepsen_tpu/checker/explain.py:56-64
ANOMALY_NAME = "anomaly.json"
WITNESS_TIMELINE_NAME = "witness-timeline.html"

DEFAULT_SHRINK_BUDGET = 128     # total ddmin candidate evaluations
DEFAULT_MAX_WITNESS_OPS = 16    # stop shrinking at this many ops

# anomaly.json caps detail lists so a pathological witness can't bloat
# the artifact past what a human would read
MAX_DETAIL_OPS = 200


# copied from jepsen_tpu/checker/explain.py:67-78
def enabled(test=None, opts=None) -> bool:
    """The ``explain`` knob (default ON), opts over the test map:
    tolerantly coerced — bools and 0/1 pass, yes/no strings work, garbage
    warns and reads as the default."""
    from jepsen_tpu_torch.parallel import coerce_flag
    v = None
    if isinstance(opts, dict) and "explain" in opts:
        v = opts.get("explain")
    elif isinstance(test, dict):
        v = test.get("explain")
    flag = coerce_flag(v, knob="explain")
    return True if flag is None else flag


# copied from jepsen_tpu/checker/explain.py:81-95
def _coerce_count(value, knob: str, default: int, lo: int = 0) -> int:
    """Tolerant positive-int knob coercion: numeric strings parse,
    garbage warns and falls back to the default, values below ``lo``
    clamp."""
    if value is None or value == "":
        return default
    try:
        if isinstance(value, bool):
            raise ValueError("bool is not a count")
        n = int(float(value))
    except (TypeError, ValueError):
        logger.warning("ignoring malformed %s=%r (want an int); using "
                       "default %r", knob, value, default)
        return default
    return max(lo, n)


# copied from jepsen_tpu/checker/explain.py:98-106
def shrink_budget(test=None) -> int:
    return _coerce_count((test or {}).get("explain_shrink_budget"),
                         "explain_shrink_budget", DEFAULT_SHRINK_BUDGET)


def max_witness_ops(test=None) -> int:
    return _coerce_count((test or {}).get("explain_max_witness_ops"),
                         "explain_max_witness_ops",
                         DEFAULT_MAX_WITNESS_OPS, lo=1)


# copied from jepsen_tpu/checker/explain.py:109-156
def ddmin(items: list, fails, budget: int = DEFAULT_SHRINK_BUDGET,
          min_items: int = 0) -> tuple[list, dict]:
    """Generic bounded delta-debugging minimization, the round structure
    of the witness shrink in :func:`_forensics_from_loc` over a plain
    predicate. ``fails(subset)`` returns True when the failure still
    reproduces with only ``subset`` kept; the caller has established
    ``fails(items)``. Returns ``(kept, info)``; ``info["minimal"]`` is True
    only when a full single-item round removed nothing (or nothing
    removable remains) — a loop cut short by the budget proved nothing
    about irreducibility."""
    kept = list(items)
    rounds = candidates_used = 0
    n = 2
    converged = not kept
    while kept and len(kept) > min_items and n <= len(kept) \
            and budget > 0:
        chunk = (len(kept) + n - 1) // n
        segs = [kept[i:i + chunk] for i in range(0, len(kept), chunk)]
        cands = [[x for j, seg in enumerate(segs) if j != i for x in seg]
                 for i in range(len(segs))]
        truncated = len(cands) > budget
        cands = cands[:budget]
        rounds += 1
        hit = None
        for i, cand in enumerate(cands):
            budget -= 1
            candidates_used += 1
            if fails(cand):
                hit = i
                break
        if hit is not None:
            kept = cands[hit]
            n = max(2, min(n - 1, max(1, len(kept))))
            if not kept:
                converged = True
                break
        else:
            if n >= len(kept):
                converged = not truncated and budget >= 0
                break
            n = min(len(kept), 2 * n)
    return kept, {"rounds": rounds, "candidates": candidates_used,
                  "minimal": converged}


# ---------------------------------------------------------------------------
# Core: forensics over an encoded stream
# ---------------------------------------------------------------------------

# copied from jepsen_tpu/checker/explain.py:162-201, with the device
def explain_stream(stream, step_ids=None, step_py=None, init_state: int = 0,
                   num_states: int | None = None, loc=None, failure=None,
                   shrink_budget: int | None = None,
                   max_witness_ops: int | None = None,
                   device=None) -> dict | None:
    """Forensics for one encoded history: localize the first anomaly and
    shrink a minimal witness window. ``loc`` reuses a
    :class:`~jepsen_tpu_torch.ops.jitlin.MatrixLocalization` a checker
    rung already computed; ``failure`` reuses an exact CPU
    :class:`~jepsen_tpu_torch.checker.linear_cpu.LinearResult` (no
    re-check). The localization runs on ``device`` (the card when None).
    Returns the forensics dict, or None when the stream is valid."""
    t0 = time.perf_counter()
    budget = _coerce_count(shrink_budget, "explain_shrink_budget",
                           DEFAULT_SHRINK_BUDGET)
    max_ops = _coerce_count(max_witness_ops, "explain_max_witness_ops",
                            DEFAULT_MAX_WITNESS_OPS, lo=1)
    from jepsen_tpu_torch.ops import jitlin
    if loc is None and _in_matrix_regime(stream, num_states):
        loc = jitlin.matrix_localize(stream, step_ids=step_ids,
                                     init_state=init_state,
                                     num_states=num_states, device=device)
    if loc is not None:
        out = _forensics_from_loc(stream, loc, budget, max_ops)
    else:
        out = _forensics_cpu(stream, step_py, init_state, failure)
    if out is None:
        return None
    out["explain_latency_seconds"] = round(time.perf_counter() - t0, 4)
    _export_metrics(out)
    return out


# copied from jepsen_tpu/checker/explain.py:401-420
def _export_metrics(forensics: dict) -> None:
    reg = telemetry.get_registry()
    if not reg.enabled:
        return
    try:
        backend = forensics.get("backend", "unknown")
        reg.counter("explain_total", "anomaly forensics derived, by "
                    "localization backend", labels=("backend",)
                    ).inc(backend=backend)
        reg.gauge("explain_bisect_steps",
                  "device combine steps of the last first-anomaly "
                  "bisection").set(forensics.get("bisect_steps", 0))
        reg.histogram("explain_latency_seconds",
                      "wall time of localize + witness shrink"
                      ).observe(forensics.get("explain_latency_seconds",
                                              0.0))
        reg.gauge("witness_ops", "ops in the last minimal witness").set(
            len((forensics.get("witness") or {}).get("op_indices") or ()))
    except Exception:  # noqa: BLE001 — telemetry never fails forensics
        logger.exception("explain telemetry recording failed")


def _in_matrix_regime(stream, num_states) -> bool:
    from jepsen_tpu_torch.ops import jitlin
    n_states = num_states if num_states is not None else len(stream.intern)
    n_returns = int((np.asarray(stream.kind) == jitlin.EV_RETURN).sum())
    return jitlin.matrix_ok(max(1, getattr(stream, "n_slots", 1)),
                            n_states, n_returns)


# copied from jepsen_tpu/checker/explain.py:204-230, with the device
def first_failure(stream, step_ids=None, step_py=None, init_state: int = 0,
                  num_states: int | None = None, device=None):
    """``(failed_event, failed_op_index)`` of a stream's first anomaly —
    device localization when in regime, exact CPU frontier otherwise — or
    None when the stream is valid."""
    from jepsen_tpu_torch.ops import jitlin
    if _in_matrix_regime(stream, num_states):
        loc = jitlin.matrix_localize(stream, step_ids=step_ids,
                                     init_state=init_state,
                                     num_states=num_states, device=device)
        if loc is not None:
            return loc.failed_event, loc.failed_op_index
    from jepsen_tpu_torch.checker.linear_cpu import (
        cas_register_step_py, check_stream)
    res = check_stream(stream, step=step_py or cas_register_step_py,
                       init_state=init_state)
    if res.valid is not False:
        return None
    return int(res.failed_event), int(res.failed_op_index)


# copied from jepsen_tpu/checker/explain.py:233-263
def _forensics_cpu(stream, step_py, init_state, failure=None) -> dict | None:
    """CPU-frontier forensics (out of the matrix regime, or the
    localization declined): the exact rejection point plus a
    frontier-derived witness (the ops pending when the frontier died; no
    ddmin)."""
    res = failure
    if res is None or res.valid is not False:
        from jepsen_tpu_torch.checker.linear_cpu import (
            cas_register_step_py, check_stream)
        res = check_stream(stream, step=step_py or cas_register_step_py,
                           init_state=init_state)
    if res.valid is not False:
        return None
    pend = sorted({int(i) for c in (res.final_configs or [])
                   for i in (c.get("pending") or [])})
    fatal = int(res.failed_op_index)
    return {
        "first_anomaly": {"event": int(res.failed_event),
                          "op_index": fatal},
        "backend": "frontier-cpu",
        "bisect_steps": 0,
        "witness": {
            "op_indices": sorted(set(pend + [fatal])),
            "context_op_indices": [],
            "window_op_count": len(pend) + 1,
            "shrunk_from": None,
            "rounds": 0,
            "candidates": 0,
            "minimal": False,
        },
    }


# copied from jepsen_tpu/checker/explain.py:266-398
def _forensics_from_loc(stream, loc, budget: int, max_ops: int) -> dict:
    """Witness shrink over a settled device localization: bounded ddmin
    on the guilty window's removable ops, every round's candidates
    checked in one ``matrix_window_rescan`` launch. A candidate counts
    only when it dies at the SAME return the full history died at."""
    from jepsen_tpu_torch.checker.linear_encode import EV_INVOKE
    from jepsen_tpu_torch.ops.jitlin import _bucket, matrix_window_rescan

    kind = np.asarray(stream.kind)
    slot = np.asarray(stream.slot)
    op_index = np.asarray(stream.op_index)
    T, t_star = loc.chunk_returns, loc.step
    ret_idx = loc.ret_idx
    base_r = loc.chunk * T

    # occupant lookup: which op (identified by its invoke EVENT) holds
    # slot s at event e — the last invoke on s at or before e
    inv_pos: dict[int, np.ndarray] = {}
    for s in np.unique(slot[kind == EV_INVOKE]):
        inv_pos[int(s)] = np.nonzero((kind == EV_INVOKE) & (slot == s))[0]

    def occupant(s: int, e: int) -> int:
        pos = inv_pos.get(int(s))
        if pos is None or len(pos) == 0:
            return -1
        j = int(np.searchsorted(pos, e, side="right")) - 1
        return int(pos[j]) if j >= 0 else -1

    window_events = [int(ret_idx[base_r + r]) for r in range(t_star + 1)]
    boundary_event = int(ret_idx[base_r - 1]) if base_r > 0 else -1
    S = loc.window_pend.shape[1]
    occ_grid = np.full((t_star + 1, S), -1, np.int64)
    ret_op = np.full((t_star + 1,), -1, np.int64)
    for r, e in enumerate(window_events):
        ret_op[r] = occupant(int(slot[e]), e)
        for s in np.nonzero(loc.window_pend[r])[0]:
            occ_grid[r, int(s)] = occupant(int(s), e)
    fatal_event = window_events[-1]
    fatal_op = int(ret_op[t_star])
    ops_in_window = sorted(
        {int(o) for o in occ_grid[occ_grid >= 0].ravel()}
        | {int(o) for o in ret_op[ret_op >= 0]})
    # ops invoked before the window boundary are context: their bits
    # already live in the carried frontier vector and cannot be removed
    context = [o for o in ops_in_window if o <= boundary_event]
    removable = [o for o in ops_in_window
                 if o > boundary_event and o != fatal_op]

    base_pend = np.asarray(loc.window_pend).copy()
    base_valid = np.asarray(loc.window_valid).copy()
    base_valid[t_star + 1:] = False  # past the fatal return: irrelevant

    def grids_for(keeps: list[list[int]]):
        K = len(keeps)
        pend = np.broadcast_to(base_pend, (K,) + base_pend.shape).copy()
        valid = np.broadcast_to(base_valid, (K,) + base_valid.shape).copy()
        for k, ks in enumerate(keeps):
            kept_ops = np.asarray(
                sorted(set(ks) | set(context) | {fatal_op}), np.int64)
            keep_grid = (occ_grid < 0) | np.isin(occ_grid, kept_ops)
            pend[k, :t_star + 1] &= keep_grid
            valid[k, :t_star + 1] &= np.isin(ret_op, kept_ops)
        return pend, valid

    def dies_at_fatal(cands: list[list[int]]) -> list[bool]:
        K = len(cands)
        # the reference buckets K so its vmapped program compiles at a
        # few batch shapes; the kernel has none to compile, but the
        # padding (keep-all rows, ignored) keeps the launches alike
        Kb = _bucket(K, floor=4)
        padded = cands + [list(kept)] * (Kb - K)
        pend, valid = grids_for(padded)
        first = matrix_window_rescan(loc, pend, valid)
        return [int(first[i]) == t_star for i in range(K)]

    kept = list(removable)
    rounds = candidates_used = 0
    n = 2
    # "minimal" is a PROOF, not a progress report: True only when ddmin
    # converged — no single op can be removed, or nothing removable
    # remains. A loop cut short by the candidate budget or the max_ops
    # early stop shrank the witness but proved nothing.
    converged = not removable
    while kept and len(kept) > max_ops and n <= len(kept) and budget > 0:
        segs = np.array_split(np.asarray(kept, np.int64), n)
        cands = []
        for i in range(len(segs)):
            rest = [int(x) for j, seg in enumerate(segs) if j != i
                    for x in seg]
            cands.append(rest)
        truncated = len(cands) > budget
        cands = cands[:budget]
        budget -= len(cands)
        candidates_used += len(cands)
        rounds += 1
        ok = dies_at_fatal(cands)
        hit = next((i for i, o in enumerate(ok) if o), None)
        if hit is not None:
            kept = cands[hit]
            n = max(2, min(n - 1, max(1, len(kept))))
            if not kept:
                converged = True
                break
        else:
            if n >= len(kept):
                converged = not truncated
                break
            n = min(len(kept), 2 * n)

    witness_events = sorted(set(kept) | {fatal_op})
    out = {
        "first_anomaly": {"event": fatal_event,
                          "op_index": int(op_index[fatal_event])},
        "backend": "matrix-bisect",
        "bisect_steps": int(loc.bisect_steps),
        "witness": {
            "op_indices": sorted({int(op_index[e]) for e in witness_events}),
            "context_op_indices": sorted({int(op_index[e])
                                          for e in context}),
            "window_op_count": len(ops_in_window),
            "shrunk_from": len(removable),
            "rounds": rounds,
            "candidates": candidates_used,
            "minimal": converged,
        },
    }
    if fatal_event != loc.failed_event:  # pragma: no cover — invariant
        logger.warning("witness window disagrees with localization "
                       "(%d != %d); reporting the localization",
                       fatal_event, loc.failed_event)
        out["first_anomaly"] = {"event": int(loc.failed_event),
                                "op_index": int(loc.failed_op_index)}
    return out


# copied from jepsen_tpu/checker/explain.py:427-498
def compose_anomaly(history, forensics: dict, registry_rows=None) -> dict:
    """The full anomaly.json payload: forensics enriched with per-op
    detail (process, f, value, invoke/completion times) and the fault
    windows from the durable registry that overlap the witness."""
    payload = {k: v for k, v in forensics.items()}
    hist = history or []
    completion_of: dict[int, dict] = {}
    invoke_of: dict[int, int] = {}   # completion index -> invoke index
    open_inv: dict = {}
    for i, op in enumerate(hist):
        p, typ = op.get("process"), op.get("type")
        if typ == "invoke":
            open_inv[p] = i
        elif typ in ("ok", "fail", "info"):
            j = open_inv.pop(p, None)
            if j is not None:
                completion_of[j] = op
                invoke_of[i] = j

    def op_detail(i: int) -> dict:
        """Per-op detail for either half of an op: witness indices are
        INVOKE indices, while first_anomaly's op_index is the fatal
        RETURN's (completion's) index — both resolve to the full
        invoke+completion pair."""
        if not (0 <= i < len(hist)):
            return {"index": int(i)}
        op = hist[i]
        inv, comp = op, completion_of.get(i)
        if comp is None and i in invoke_of:
            inv, comp = hist[invoke_of[i]], op
        d = {"index": int(i), "process": op.get("process"),
             "f": op.get("f"), "value": op.get("value"),
             "type": op.get("type"), "time": inv.get("time")}
        if comp is not None:
            d["completion_type"] = comp.get("type")
            d["completion_value"] = comp.get("value")
            if comp.get("time") is not None and inv.get("time") is not None:
                d["latency_ns"] = comp["time"] - inv["time"]
        return d

    fa = dict(payload.get("first_anomaly") or {})
    fa.update(op_detail(fa.get("op_index", -1)))
    payload["first_anomaly"] = fa
    wit = dict(payload.get("witness") or {})
    indices = list(wit.get("op_indices") or [])
    wit["ops"] = [op_detail(i) for i in indices[:MAX_DETAIL_OPS]]
    if len(indices) > MAX_DETAIL_OPS:
        wit["ops_truncated"] = len(indices) - MAX_DETAIL_OPS
    payload["witness"] = wit

    try:
        from jepsen_tpu_torch.nemesis import faults as faults_mod
        windows = faults_mod.history_windows(hist, registry_rows or [])
        times = [hist[i].get("time") for i in indices
                 if 0 <= i < len(hist) and hist[i].get("time") is not None]
        fa_t = fa.get("time")
        if fa_t is not None:
            times.append(fa_t)
        if times:
            lo, hi = min(times), max(times)
            for w in windows:
                w0, w1 = w.get("start_time"), w.get("end_time")
                if w0 is None:
                    w["overlaps_witness"] = False
                else:
                    w["overlaps_witness"] = (w1 is None or w1 >= lo) \
                        and w0 <= hi
        payload["fault_windows"] = windows
    except Exception:  # noqa: BLE001 — the overlay is best-effort
        logger.exception("fault-window overlay failed")
        payload.setdefault("fault_windows", [])
    return payload


# copied from jepsen_tpu/checker/explain.py:501-531, over the port's store,
# fault registry and timeline
def write_artifacts(test: dict, history, forensics: dict,
                    opts: dict | None = None) -> dict:
    """Writes ``anomaly.json`` + ``witness-timeline.html`` into the
    run's store dir (nested under ``subdirectory`` for independent's
    per-key lift). Returns {artifact-name: path}; empty on failure —
    artifact writing never masks a verdict."""
    out: dict = {}
    if not test:
        return out
    try:
        from jepsen_tpu_torch import store
        from jepsen_tpu_torch.nemesis import faults as faults_mod
        sub = (opts or {}).get("subdirectory")
        rows = faults_mod.load_rows(
            store.path(test, faults_mod.FAULTS_NAME))
        payload = compose_anomaly(history, forensics, registry_rows=rows)
        p = store.path_mk(test, *filter(None, [sub, ANOMALY_NAME]))
        p.write_text(json.dumps(payload, indent=2, default=repr) + "\n")
        out[ANOMALY_NAME] = p
        try:
            from jepsen_tpu_torch.checker import timeline
            html = timeline.render_witness(test, history or [], payload)
            tp = store.path_mk(test,
                               *filter(None, [sub, WITNESS_TIMELINE_NAME]))
            tp.write_text(html)
            out[WITNESS_TIMELINE_NAME] = tp
        except Exception:  # noqa: BLE001 — json evidence beats no evidence
            logger.exception("witness timeline rendering failed")
    except Exception:  # noqa: BLE001
        logger.exception("anomaly artifact write failed")
    return out
