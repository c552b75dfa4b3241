"""Read-write-register workload checker (the port of
jepsen_tpu/elle/rw_register.py; capability-equivalent to elle.rw-register,
invoked from the reference at jepsen/src/jepsen/tests/cycle/wr.clj).

Txns are lists of ``["w", k, v]`` / ``["r", k, v]`` micro-ops with writes
unique per key (wr.clj:31-45 documents the anomaly surface: G0/G1a/G1b/
G1c/G-single/G2/internal). Unlike list-append, version order is not
directly observable; we infer it from:

* wr edges: reader of v depends on the (unique) writer of v.
* ww edges within a txn's own trace: if a txn reads v then writes v', then
  writer(v) ww-precedes this txn for that key.
* rw anti-dependencies through the trace-derived version-succession map
  (reader of v precedes writers of v's known successors) — longer
  write-follows-read chains compose through the txn graph, since each
  version-graph edge contributes its own ww/rw edges.
* initial-state ordering: a read of the initial None (on a key where no
  txn ever wrote a literal None) proves the reader serialized before
  EVERY writer of that key — a register never returns to its initial
  state — yielding rw edges to all writers, across processes.
* the per-key version graph itself is checked for cycles: a succession
  loop (v overwritten by v', v' overwritten by ... v) is impossible for
  uniquely-written registers and reported as ``cyclic-versions``.

All of these under-approximate elle's full inference soundly (never
false positives — fuzz-verified against a brute-force serializability
oracle).
"""
from __future__ import annotations

from collections import defaultdict

from jepsen_tpu_torch import elle
from jepsen_tpu_torch.elle import RW, WR, WW, Graph
from jepsen_tpu_torch.ops.scc import tarjan_scc
from jepsen_tpu_torch.txn import _hk, int_write_mops


# copied from jepsen_tpu/elle/rw_register.py:38-179, without the
# history-IR ``ir`` argument
def check(history: list[dict], accelerator: str = "auto",
          consistency_models=("strict-serializable",), device=None) -> dict:
    """The rw-register check. ``accelerator`` is "gpu", "cpu" or "auto"
    as for the list-append check; device work runs on ``device`` (the
    CUDA device by default)."""
    if accelerator not in elle.ACCELERATORS:
        raise ValueError(f"accelerator {accelerator!r} not in "
                         f"{elle.ACCELERATORS}")
    oks = [op for op in history if op.get("type") == "ok"
           and isinstance(op.get("process"), int)]
    fails = [op for op in history if op.get("type") == "fail"]
    infos = [op for op in history if op.get("type") == "info"
             and isinstance(op.get("process"), int)]
    txns = oks + infos
    n = len(txns)

    anomalies_extra: dict[str, list] = defaultdict(list)

    writer_of: dict[tuple, int] = {}
    failed_writes: dict[tuple, dict] = {}
    intermediate_writes: dict[tuple, int] = {}
    for op in fails:
        for m in op.get("value") or []:
            if m[0] == "w":
                failed_writes[(_hk(m[1]), m[2])] = op
    for i, op in enumerate(txns):
        for m in op.get("value") or []:
            if m[0] == "w":
                key = (_hk(m[1]), m[2])
                if key in writer_of:
                    anomalies_extra["duplicate-writes"].append(
                        {"key": m[1], "value": m[2]})
                writer_of[key] = i
        if op.get("type") == "ok":
            for f, k, v in int_write_mops(op.get("value") or []):
                intermediate_writes[(_hk(k), v)] = i

    # writers per key, for the single-write init-read inference below
    key_writers: dict = defaultdict(set)
    for (k, _v), w in writer_of.items():
        key_writers[k].add(w)

    graph = Graph(n)
    # One pass per txn builds: wr edges (reads of known writes), trace ww
    # edges and value-level succession (txn read v then wrote v' for the
    # same key => writer(v) precedes this txn), G1a, and internal checks.
    # The initial state None is a first-class version: a None-read then
    # write traces the succession init -> first value.
    _MISSING = object()
    succ: dict[tuple, set[int]] = defaultdict(set)
    vedges: dict = defaultdict(set)   # hk -> {(prev_value, new_value)}
    key_repr: dict = {}               # hk -> a representative original key
    for i, op in enumerate(txns):
        if op.get("type") != "ok":
            continue
        last_read: dict = {}
        written: dict = {}
        for m in op.get("value") or []:
            k = _hk(m[1])
            if m[0] == "r":
                v = m[2]
                if k in written and v != written[k]:
                    # internal: read contradicts own earlier write
                    anomalies_extra["internal"].append(
                        {"key": m[1], "expected": written[k], "got": v})
                if v is not None:
                    if (k, v) in failed_writes:
                        anomalies_extra["G1a"].append(
                            {"key": m[1], "value": v,
                             "read-txn": op.get("value")})
                    iw = intermediate_writes.get((k, v))
                    if iw is not None and iw != i:
                        # G1b: v was overwritten within its own txn — only
                        # an intermediate state could have exposed it
                        anomalies_extra["G1b"].append(
                            {"key": m[1], "value": v,
                             "writer": txns[iw].get("value")})
                    w = writer_of.get((k, v))
                    if w is not None and w != i:
                        graph.add(w, i, WR)
                last_read[k] = v
            elif m[0] == "w":
                prev = last_read.get(k, _MISSING)
                if prev is not _MISSING:
                    # prev None traces init -> m[2], but only when None
                    # is really the init state (never a written value)
                    if prev is not None or (k, None) not in writer_of:
                        succ[(k, prev)].add(i)
                        key_repr.setdefault(k, m[1])
                        vedges[k].add((prev, m[2]))
                    if prev is not None:
                        w = writer_of.get((k, prev))
                        if w is not None and w != i:
                            graph.add(w, i, WW)
                last_read[k] = m[2]
                written[k] = m[2]

    # the trace-derived version graph must be acyclic: versions of a
    # uniquely-written register install in one linear order, so a
    # succession loop can't come from any real execution (elle's
    # cyclic-version-order anomaly)
    for k, edges in vedges.items():
        cyc = _version_cycle(edges)
        if cyc is not None:
            anomalies_extra["cyclic-versions"].append(
                {"key": key_repr.get(k, k), "versions": cyc})

    # rw anti-dependencies: i read version v of k; known successor writers
    # (from the succession map) anti-depend on i. A read of the initial
    # state (None) additionally anti-depends on the key's writer when the
    # key has exactly ONE writing txn — init's immediate successor is then
    # unambiguous (elle's nil-version inference).
    for i, op in enumerate(txns):
        if op.get("type") != "ok":
            continue
        for m in op.get("value") or []:
            if m[0] != "r":
                continue
            k, v = _hk(m[1]), m[2]
            for w in succ.get((k, v), ()):
                if w != i:
                    graph.add(i, w, RW)
            if v is None and (k, None) not in writer_of:
                # a None read is the INITIAL state only if no txn ever
                # wrote a literal None to this key — and the register
                # never returns to it, so the reader serialized before
                # EVERY writer of the key, whichever installed first
                for w in key_writers.get(k, ()):
                    if w != i:
                        graph.add(i, w, RW)

    # realtime (invoke/complete interval order) + per-process succession
    # edges: close the strict-serializable / sequential anomaly surface
    elle.add_timing_edges(graph, history, txns)

    cyc = elle.check_cycles(graph, accelerator=accelerator, device=device)
    result = elle.result_map(cyc, txns, anomalies_extra,
                             consistency_models=consistency_models)
    result["txn-count"] = n
    result["edge-count"] = len(graph.edges)
    return result


# copied from jepsen_tpu/elle/rw_register.py:182-200
def _version_cycle(edges: set) -> list | None:
    """A cyclic strongly-connected component of one key's
    version-succession graph (its member values), or None. Reuses the
    exact host Tarjan from ops.scc over interned values; self-loops
    (read v, rewrote v) are duplicate-writes, already reported
    separately — skipped here."""
    ids: dict = {}
    for a, b in edges:
        for v in (a, b):
            if v not in ids:
                ids[v] = len(ids)
    int_edges = [(ids[a], ids[b]) for a, b in edges if a != b]
    sccs = tarjan_scc(len(ids), int_edges)
    if not sccs:
        return None
    values = list(ids)
    return [values[i] for i in sccs[0]]

