"""List-append workload checker (the port of jepsen_tpu/elle/list_append.py;
capability-equivalent to elle.list-append, invoked from the reference at
jepsen/src/jepsen/tests/cycle/append.clj).

Txns are lists of micro-ops ``["append", k, v]`` / ``["r", k, [v...]]``
(append.clj:29-55). Reads observe the whole list for a key, so version
order per key is directly observable: every read is a prefix of the key's
final order, appends extend it. From that we infer ww/wr/rw edges and feed
jepsen_tpu_torch.elle.check_cycles; non-cyclic anomalies (G1a aborted
read, G1b intermediate read, internal, duplicates, incompatible orders)
are data-parallel scans.

``accelerator`` is "gpu" (the device screen and trim wherever the
reference's "tpu" takes them), "cpu" (the Python builder and the host
trim + Tarjan oracle) or "auto"; device work runs on ``device`` (the CUDA
device by default). :func:`check_stored` re-checks a stored run from the
``elle_*`` columns of its ``history.npz`` sidecar.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any

import numpy as np

from jepsen_tpu_torch import elle
from jepsen_tpu_torch.elle import RW, WR, WW, Graph
from jepsen_tpu_torch.txn import _hk


# copied from jepsen_tpu/elle/list_append.py:30-158
def _scan_reads_fast(k, reads, longest, txns, writer_of, failed_writes,
                     appends_per_txn_key, multi_writers, anomalies_extra,
                     wr_pairs, fail_vals):
    """Columnar per-key read scan (prefix consistency, duplicates, G1a,
    unobserved writers, G1b) for integer value domains — the common
    workload shape, where per-element Python dict walks would dominate
    the whole Elle check at history scale. Returns False when the domain
    isn't integer-typed (caller falls back to the Python twin).

    Anomaly semantics are identical to _scan_reads_py; a differential
    test pins the two together."""
    from itertools import chain

    def int_col(values):
        """Exact signed-int column or None — np.asarray(x, int64) would
        silently TRUNCATE floats (2.7 -> 2), which must fall back to the
        Python twin instead of fabricating membership hits."""
        if not len(values):
            return np.zeros(0, np.int64)  # asarray([]) defaults to float64
        try:
            a = np.asarray(values)
        except (TypeError, ValueError):
            return None
        if a.ndim != 1 or a.dtype.kind != "i":
            return None
        return a.astype(np.int64)

    spine = int_col(longest)
    wvals = int_col([v for v, _ in wr_pairs])
    fvals = int_col(sorted(fail_vals))
    if spine is None or wvals is None or fvals is None:
        return False
    payloads = [r for _, r in reads]
    lens = np.fromiter((len(r) for r in payloads), np.int64,
                       count=len(payloads))
    total = int(lens.sum())
    try:
        # one C pass builds float64; the int view must round-trip exactly
        # (fromiter into int64 would silently truncate 2.7 -> 2). Ints at
        # or beyond 2^53 also fall back: float64 can't represent them
        # exactly, so the round-trip check below couldn't notice a value
        # that float conversion itself already corrupted.
        concat_f = np.fromiter(chain.from_iterable(payloads), np.float64,
                               count=total)
    except (TypeError, ValueError, OverflowError):
        return False
    if total and np.abs(concat_f).max() >= float(1 << 53):
        return False
    concat = concat_f.astype(np.int64)
    if not np.array_equal(concat.astype(np.float64), concat_f):
        return False
    order = np.argsort(wvals) if wvals.size else np.zeros(0, np.int64)
    wvals_sorted = wvals[order]
    wtxn_sorted = (np.asarray([wi for _, wi in wr_pairs], np.int64)[order]
                   if wr_pairs else np.zeros(0, np.int64))
    multi_arr = np.asarray(sorted(multi_writers), dtype=np.int64)

    def member(sorted_arr, vals):
        if sorted_arr.size == 0:
            return np.zeros(vals.shape, bool), np.zeros(vals.shape, np.int64)
        pos = np.clip(np.searchsorted(sorted_arr, vals), 0,
                      sorted_arr.size - 1)
        return sorted_arr[pos] == vals, pos

    ends = np.cumsum(lens)
    starts = ends - lens
    # row id per element; bincount-based segment reductions sidestep
    # reduceat's empty-segment pitfalls (a trailing empty read must not
    # steal elements from its neighbour)
    row_of_elem = np.repeat(np.arange(len(payloads)), lens)

    def read_of(elem_idx):  # global element position -> read row
        return int(np.searchsorted(ends, elem_idx, side="right"))

    def any_per_row(elem_mask):
        return np.bincount(row_of_elem, weights=elem_mask,
                           minlength=len(payloads)) > 0

    # prefix consistency, all reads at once: element p of read j must
    # equal spine[p - starts[j]]
    if total:
        within = np.arange(total) - starts[row_of_elem]
        seg_ok = ~any_per_row(concat != spine[within])
    else:
        seg_ok = np.ones(len(payloads), bool)
    spine_dup_free = np.unique(spine).size == spine.size

    # G1a / unobserved writers, element-level
    failed_hit, _ = member(fvals, concat)
    writer_hit, pos = member(wvals_sorted, concat)
    for idx in np.nonzero(failed_hit)[0].tolist():
        anomalies_extra["G1a"].append(
            {"key": k, "value": int(concat[idx]),
             "read-txn": txns[reads[read_of(idx)][0]].get("value")})
    for idx in np.nonzero(~writer_hit & ~failed_hit)[0].tolist():
        anomalies_extra["unobserved-writer"].append(
            {"key": k, "value": int(concat[idx])})

    # G1b candidates: reads touching a multi-append writer's values need
    # the per-writer grouping check (everything else can't be partial)
    g1b_rows = np.zeros(len(payloads), bool)
    if multi_arr.size and total:
        elem_w = np.where(writer_hit, wtxn_sorted[pos], -1)
        touched, _ = member(multi_arr, elem_w)
        g1b_rows = any_per_row(touched)

    # per-read scrutiny only where something is off: a clean prefix of a
    # duplicate-free spine can contain neither incompatibilities nor
    # duplicates, so the common case never re-enters Python
    for j in np.nonzero(~seg_ok)[0].tolist():
        i, r = reads[j]
        anomalies_extra["incompatible-order"].append(
            {"key": k, "read": r, "longest": longest})
    if spine_dup_free:
        scrutiny = ~seg_ok
    else:
        scrutiny = np.ones(len(payloads), bool)
    for j in np.nonzero(scrutiny)[0].tolist():
        i, r = reads[j]
        if len(set(r)) != len(r):
            anomalies_extra["duplicate-elements"].append(
                {"key": k, "read": r})
            g1b_rows[j] = True  # a doubled single-append value also
            #                     fails the subsequence test
    for j in np.nonzero(g1b_rows)[0].tolist():
        i, r = reads[j]
        _g1b_one_read(k, i, r, txns, writer_of, appends_per_txn_key,
                      anomalies_extra)
    return True


# copied from jepsen_tpu/elle/list_append.py:161-182
def _g1b_one_read(k, i, r, txns, writer_of, appends_per_txn_key,
                  anomalies_extra):
    """The per-writer observed-subsequence check for one read (G1b /
    incompatible-order): a committed txn's appends to k must be observed
    all-or-nothing, in order (append.clj intermediate-read semantics)."""
    observed: dict[int, list] = defaultdict(list)
    for v in r:
        w = writer_of.get((k, v))
        if w is not None:
            observed[w[0]].append(v)
    for wi, obs in observed.items():
        if wi == i or txns[wi].get("type") != "ok":
            continue  # own reads / indeterminate writers: not G1b
        txn_appends = appends_per_txn_key[(wi, k)]
        if obs == txn_appends:
            continue
        if obs == txn_appends[: len(obs)]:
            anomalies_extra["G1b"].append(
                {"key": k, "read": r, "writer": txns[wi].get("value")})
        else:
            anomalies_extra["incompatible-order"].append(
                {"key": k, "read": r, "writer-appends": txn_appends})


# copied from jepsen_tpu/elle/list_append.py:185-205
def _scan_reads_py(k, reads, longest, txns, writer_of, failed_writes,
                   appends_per_txn_key, anomalies_extra):
    """Pure-Python per-key read scan: the oracle twin of
    _scan_reads_fast, and the fallback for non-integer domains."""
    for i, r in reads:
        if r != longest[: len(r)]:
            anomalies_extra["incompatible-order"].append(
                {"key": k, "read": r, "longest": longest})
        if len(set(r)) != len(r):
            anomalies_extra["duplicate-elements"].append(
                {"key": k, "read": r})
        for v in r:
            if (k, v) in failed_writes:
                anomalies_extra["G1a"].append(
                    {"key": k, "value": v, "read-txn": txns[i].get("value")})
            elif (k, v) not in writer_of:
                # no known writer: future/phantom value
                anomalies_extra["unobserved-writer"].append(
                    {"key": k, "value": v})
        _g1b_one_read(k, i, r, txns, writer_of, appends_per_txn_key,
                      anomalies_extra)


# copied from jepsen_tpu/elle/list_append.py:208-237, with the device
# passed through
def check_stored(test_name: str, timestamp: str, store_dir: str = "store",
                 accelerator: str = "auto",
                 consistency_models=("strict-serializable",),
                 device=None) -> dict:
    """Re-checks a STORED run's list-append history, preferring the
    ``elle_*`` columns in its history.npz sidecar — a pure array
    pipeline with no jsonl parse and no PyObject history. Falls back to
    the jsonl history when the sidecar is missing, damaged or predates
    the columns, or when a finding needs to cite txn objects (anomalous
    histories). Device work runs on ``device`` (the CUDA device by
    default)."""
    from jepsen_tpu_torch import store
    from jepsen_tpu_torch.elle import columnar

    try:
        cols = store.load_elle_columns(test_name, timestamp, store_dir)
    except Exception as e:  # noqa: BLE001 - any sidecar damage (missing,
        #              truncated zip, wrong keys) means: use the jsonl
        store.note_sidecar_load_failure(
            f"{test_name}/{timestamp} (elle_*)", e)
        cols = None
    if cols is not None:
        try:
            return columnar.check_columns(
                cols, consistency_models=consistency_models,
                accelerator=accelerator, device=device)
        except columnar.NeedsObjects:
            pass
    history = store.load_history(test_name, timestamp, store_dir)
    return check(history, accelerator=accelerator,
                 consistency_models=consistency_models, device=device)


# copied from jepsen_tpu/elle/list_append.py:240-388
def check(history: list[dict], accelerator: str = "auto",
          consistency_models=("strict-serializable",), device=None,
          ir=None) -> dict:
    # Production path: the vectorized columnar builder (elle.columnar)
    # covers integer-valued histories — the universal workload shape —
    # and feeds the φ-cluster cycle path. The cpu oracle keeps the
    # Python builder below; the tests pin the two together. With an
    # ``ir`` (the run's shared history IR) the build product is the
    # memoized elle_build view: encode once per run.
    if accelerator not in elle.ACCELERATORS:
        raise ValueError(f"accelerator {accelerator!r} not in "
                         f"{elle.ACCELERATORS}")
    if accelerator != "cpu":
        from jepsen_tpu_torch.elle import columnar
        parts = None
        if ir is not None:
            from jepsen_tpu_torch.history_ir import views
            parts = views.elle_build(ir)
        r = (columnar.check_columnar(history, consistency_models,
                                     accelerator, device=device,
                                     parts=parts)
             if parts is not None or ir is None else None)
        if r is not None:
            return r
    # ok txns participate in the graph; failed txns matter for G1a;
    # info (indeterminate) txns' writes may be observed — treated like ok
    # when they are (elle does the same: info writes that appear are real)
    from jepsen_tpu_torch.history_ir import views
    oks, fails, infos = (views.txn_nodes(ir) if ir is not None
                         else views.txn_split(history))

    txns = oks + infos  # graph nodes; info txns included if observed
    n = len(txns)

    anomalies_extra: dict[str, list] = defaultdict(list)

    # ---- writer maps ----------------------------------------------------
    writer_of: dict[tuple, tuple[int, int, int]] = {}  # (k,v) -> (txn, mop_i, nth-append-of-key-in-txn)
    appends_per_txn_key: dict[tuple[int, Any], list] = defaultdict(list)
    failed_writes: dict[tuple, dict] = {}
    for op in fails:
        for m in op.get("value") or []:
            if m[0] == "append":
                failed_writes[(_hk(m[1]), m[2])] = op
    for i, op in enumerate(txns):
        for mi, m in enumerate(op.get("value") or []):
            if m[0] == "append":
                key = (_hk(m[1]), m[2])
                if key in writer_of:
                    anomalies_extra["duplicate-appends"].append(
                        {"key": m[1], "value": m[2]})
                    continue
                writer_of[key] = (i, mi, len(appends_per_txn_key[(i, _hk(m[1]))]))
                appends_per_txn_key[(i, _hk(m[1]))].append(m[2])

    # ---- version orders from reads -------------------------------------
    # longest read per key is the spine; every other read must be a prefix
    reads_by_key: dict[Any, list[tuple[int, list]]] = defaultdict(list)
    for i, op in enumerate(txns):
        if op.get("type") != "ok":
            continue  # info txns' reads are unreliable
        for m in op.get("value") or []:
            if m[0] == "r" and m[2] is not None:
                reads_by_key[_hk(m[1])].append((i, list(m[2])))

    # multi-append writers are the only possible G1b sources: a
    # single-append writer is always either fully observed or absent
    multi_by_key: dict[Any, set] = defaultdict(set)
    for (wi, kk), ap in appends_per_txn_key.items():
        if len(ap) > 1:
            multi_by_key[kk].add(wi)

    # per-key writer/failed-value columns, built once (not per key-scan)
    wv_by_key: dict[Any, list] = defaultdict(list)
    for (kk, v), wi in writer_of.items():
        wv_by_key[kk].append((v, wi[0]))
    fails_by_key: dict[Any, list] = defaultdict(list)
    for (kk, v) in failed_writes:
        fails_by_key[kk].append(v)

    version_order: dict[Any, list] = {}
    scan_counts = {"columnar": 0, "python": 0}
    for k, reads in reads_by_key.items():
        longest = max(reads, key=lambda t: len(t[1]))[1]
        version_order[k] = longest
        if _scan_reads_fast(k, reads, longest, txns, writer_of,
                            failed_writes, appends_per_txn_key,
                            multi_by_key.get(k, set()), anomalies_extra,
                            wv_by_key.get(k, []),
                            fails_by_key.get(k, [])):
            scan_counts["columnar"] += 1
        else:  # counted: a silently-falling-back fast path would make a
            #    multi-x perf regression invisible in identical results
            scan_counts["python"] += 1
            _scan_reads_py(k, reads, longest, txns, writer_of, failed_writes,
                           appends_per_txn_key, anomalies_extra)

    # internal: a txn's own read must reflect its earlier appends
    for i, op in enumerate(txns):
        seen_appends: dict[Any, list] = defaultdict(list)
        for m in op.get("value") or []:
            k = _hk(m[1])
            if m[0] == "append":
                seen_appends[k].append(m[2])
            elif m[0] == "r" and m[2] is not None:
                mine = seen_appends[k]
                if mine and list(m[2])[-len(mine):] != mine:
                    anomalies_extra["internal"].append(
                        {"key": m[1], "read": list(m[2]),
                         "expected-suffix": list(mine)})

    # ---- dependency edges ----------------------------------------------
    graph = Graph(n)
    for k, order in version_order.items():
        # ww: consecutive versions; also the unread appends that follow the
        # longest read can't be ordered — elle only orders observed versions
        writers = [writer_of.get((k, v), (None,))[0] for v in order]
        for a, b in zip(writers, writers[1:]):
            if a is not None and b is not None and a != b:
                graph.add(a, b, WW)
        for i, r in reads_by_key[k]:
            if r:
                w = writer_of.get((k, r[-1]))
                if w is not None and w[0] != i:
                    graph.add(w[0], i, WR)  # i read w's final state
            # rw: the version after the one i observed (for an empty read,
            # index 0 — the first version's writer)
            nxt_idx = len(r)
            if nxt_idx < len(order):
                w = writer_of.get((k, order[nxt_idx]))
                if w is not None and w[0] != i:
                    graph.add(i, w[0], RW)

    # realtime (invoke/complete interval order) + per-process succession
    # edges: close the strict-serializable / sequential anomaly surface
    elle.add_timing_edges(graph, history, txns)

    cyc = elle.check_cycles(graph, accelerator=accelerator, device=device)
    # drop informational-only extras from validity
    extras = {k: v for k, v in anomalies_extra.items()
              if k != "unobserved-writer"}
    result = elle.result_map(cyc, txns, extras,
                             consistency_models=consistency_models)
    result["txn-count"] = n
    result["edge-count"] = len(graph.edges)
    result["read-scan-keys"] = scan_counts
    return result
