"""Elle anomaly artifacts: human-readable per-anomaly files in the store
(the port of jepsen_tpu/elle/artifacts.py).

The reference wires elle's output directory into every txn test
(jepsen/src/jepsen/tests/cycle/append.clj:17-22 passes
``:directory (store/path! test ... "elle")``), and elle writes one file
per anomaly type there with cycle explanations a human can read without
parsing the results map. This module is that surface for the repo's
checkers: :func:`write_artifacts` takes a checker result (the
elle.result_map shape — ``anomalies`` holding rendered cycles or extra
findings) and writes ``<type>.txt`` files plus an ``index.txt`` summary
into the run's ``elle/`` directory. The reference's web UI links the
directory from a run's page (its ``web.py``, which waits for ROADMAP
Queue 1 item 11).

Explanations are in OP terms: each cycle step shows the txn's mops and
spells out what the edge type means (who wrote/read what before whom);
non-cycle findings (G1a, internal, ...) render their structured fields
with the same one-line gloss.
"""
from __future__ import annotations

import json
import logging
from pathlib import Path

# copied from jepsen_tpu/elle/artifacts.py:25-231
logger = logging.getLogger("jepsen_tpu_torch.elle.artifacts")

# one-paragraph gloss per anomaly type, written at the top of its file
ANOMALY_DOC = {
    "G0": "Write cycle: a cycle of write-write dependencies alone — two "
          "transactions each overwrote the other's write. Violates "
          "read-uncommitted.",
    "G1a": "Aborted read: a transaction observed a value written by a "
           "transaction that FAILED. Violates read-committed.",
    "G1b": "Intermediate read: a transaction observed a non-final write "
           "of another transaction. Violates read-committed.",
    "G1c": "Cyclic information flow: a cycle of write-write and "
           "write-read dependencies — information flowed in a loop. "
           "Violates read-committed.",
    "G-single": "Read skew: a dependency cycle with exactly one "
                "anti-dependency (read-write) edge. Violates "
                "snapshot isolation.",
    "G2": "Anti-dependency cycle: a dependency cycle with two or more "
          "anti-dependency edges. Violates serializability.",
    "internal": "Internal inconsistency: a transaction's own read "
                "contradicts its earlier operations in the same "
                "transaction.",
    "realtime-cycle": "Realtime cycle: a dependency cycle closed by a "
                      "realtime precedence edge (one transaction "
                      "completed before the other was invoked). "
                      "Violates strict serializability.",
    "process-cycle": "Process cycle: a dependency cycle closed by a "
                     "same-process succession edge. Violates sequential "
                     "consistency.",
    "duplicate-appends": "The same value was appended to a key more "
                         "than once.",
    "cyclic-versions": "The per-key version order derived from reads is "
                       "cyclic.",
    "unobserved-writer": "A read observed a value no known transaction "
                         "wrote (informational).",
}

_EDGE_GLOSS = {
    "ww": "wrote the key before",      # version order
    "wr": "wrote a value read by",     # information flow
    "rw": "read a state overwritten by",  # anti-dependency
    "realtime": "completed before (in real time)",
    "process": "preceded (same process) ",
}


def _fmt_txn(value) -> str:
    """One txn's mops, compactly: [append 5 1, r 5 [1]]."""
    if not isinstance(value, (list, tuple)):
        return json.dumps(value, default=str)
    mops = []
    for m in value:
        if isinstance(m, (list, tuple)):
            mops.append(" ".join(json.dumps(x, default=str) if not
                                 isinstance(x, str) else x for x in m))
        else:
            mops.append(json.dumps(m, default=str))
    return "[" + ", ".join(mops) + "]"


def _render_cycle(cycle: list) -> list[str]:
    """Lines for one rendered cycle ([{from, type, to}] — the
    elle.render_cycle shape)."""
    lines = []
    for step in cycle:
        t = step.get("type")
        gloss = _EDGE_GLOSS.get(t, "depends-on")
        lines.append(f"  {_fmt_txn(step.get('from'))}")
        lines.append(f"    --{t}--> ({gloss})")
    if cycle:
        # close the loop visually: the last edge's target is the first
        # txn again
        lines.append(f"  {_fmt_txn(cycle[-1].get('to'))}")
    return lines


def _render_finding(finding) -> list[str]:
    """Lines for one anomaly instance: a cycle (list of edge dicts) or
    a structured extra finding (plain dict)."""
    if isinstance(finding, list) and finding and \
            isinstance(finding[0], dict) and "type" in finding[0]:
        return _render_cycle(finding)
    return ["  " + json.dumps(finding, default=str)]


def write_artifacts(dirpath, result: dict) -> list[str]:
    """Writes one ``<anomaly-type>.txt`` per anomaly in ``result`` (the
    checker result map) plus an ``index.txt`` summary into ``dirpath``.
    Returns the filenames written (empty when the result has no
    anomalies). Never raises — artifact writing must not mask a
    verdict."""
    anomalies = result.get("anomalies") or {}
    if not anomalies:
        return []
    written: list[str] = []
    try:
        d = Path(dirpath)
        d.mkdir(parents=True, exist_ok=True)
        for name, findings in sorted(anomalies.items()):
            if not findings:
                continue
            lines = [f"{name}", "=" * len(name), ""]
            doc = ANOMALY_DOC.get(name)
            if doc:
                lines += [doc, ""]
            items = findings if isinstance(findings, list) else [findings]
            for i, finding in enumerate(items):
                lines.append(f"#{i + 1}:")
                lines += _render_finding(finding)
                lines.append("")
            fn = f"{name}.txt"
            (d / fn).write_text("\n".join(lines))
            written.append(fn)
        idx = ["Elle anomaly artifacts", "", f"valid?: {result.get('valid?')}",
               f"anomaly types: {', '.join(sorted(anomalies))}", ""]
        idx += [f"- {fn}" for fn in written]
        (d / "index.txt").write_text("\n".join(idx) + "\n")
        written.append("index.txt")
    except Exception:  # noqa: BLE001 — artifacts are best-effort
        logger.exception("elle artifact write failed at %s", dirpath)
    return written


def cited_op_indices(result: dict, history: list[dict]) -> list[int]:
    """History indices of every completion whose txn value a cycle or
    extra finding cites — the op set an anomaly's explanation is *about*
    (the witness the cycle renderings imply). Best-effort value
    matching, like the live first-anomaly surface."""
    cited: list = []
    for findings in (result.get("anomalies") or {}).values():
        for item in findings if isinstance(findings, list) else ():
            for hop in item if isinstance(item, list) else ():
                if isinstance(hop, dict):
                    cited.extend([hop.get("from"), hop.get("to"),
                                  hop.get("read"), hop.get("read-txn"),
                                  hop.get("writer")])
    out = []
    for i, op in enumerate(history or []):
        if op.get("type") not in ("ok", "info"):
            continue
        v = op.get("value")
        if v is None:
            continue
        if any(c is not None and c == v for c in cited):
            out.append(i)
    return out


def _write_witness_timeline(dirpath, test, result: dict,
                            history: list[dict]) -> str | None:
    """The cycle explanations' witness-window timeline + fault overlay
    (doc/observability.md "Anomaly forensics"): the cited txns rendered
    as a per-process gantt with the run's durable fault windows
    overlaid, next to the per-anomaly text files. Returns the filename
    written, or None."""
    indices = cited_op_indices(result, history)
    if not indices:
        return None
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.checker import explain as explain_mod
    from jepsen_tpu_torch.checker import timeline
    from jepsen_tpu_torch.nemesis import faults as faults_mod
    # cycles cite completions; the timeline draws invoke..completion
    # pairs, so hand the invokes over too (compose_anomaly enriches)
    forensics = {
        "first_anomaly": {"op_index": min(indices)},
        "backend": "elle",
        "bisect_steps": 0,
        "witness": {"op_indices": indices, "context_op_indices": []},
    }
    rows = faults_mod.load_rows(store.path(test, faults_mod.FAULTS_NAME)) \
        if test else []
    payload = explain_mod.compose_anomaly(history, forensics,
                                          registry_rows=rows)
    html = timeline.render_witness(test or {}, history, payload)
    fn = "witness-timeline.html"
    (Path(dirpath) / fn).write_text(html)
    return fn


def write_for_test(test, result: dict, opts: dict | None = None,
                   history: list[dict] | None = None) -> None:
    """Writes the artifacts into ``store/<test>/<ts>/[subdir/]elle/``
    when the result is invalid and the test map can address a store
    directory. The ``subdirectory`` opt (independent's per-key lift)
    nests the artifacts the same way other per-key artifacts nest.
    With ``history``, the cycle explanations additionally get a
    witness-window timeline with the durable fault-window overlay."""
    if not test or result.get("valid?") is True:
        return
    if not result.get("anomalies"):
        return
    try:
        from jepsen_tpu_torch import store
        parts = [p for p in [(opts or {}).get("subdirectory"), "elle"] if p]
        d = store.path_mk(test, *parts)
        written = write_artifacts(d, result)
        if history:
            try:
                fn = _write_witness_timeline(d, test, result, history)
                if fn and written:
                    with open(Path(d) / "index.txt", "a") as f:
                        f.write(f"- {fn}\n")
            except Exception:  # noqa: BLE001 — the timeline is additive
                logger.exception("elle witness timeline failed")
    except Exception:  # noqa: BLE001
        logger.exception("elle artifact store write failed")
