"""Columnar list-append builder: the production path of the list-append
check, vectorized end to end (the port of jepsen_tpu/elle/columnar.py).

The reference's Elle (jepsen/src/jepsen/tests/cycle/append.clj via the
elle library) walks per-txn micro-ops with JVM map operations; at 50k+
txns the equivalent Python walk dominates the whole check. This module
derives the same dependency graph with a few C-speed passes instead:

* history parsing — event pairing, micro-op flattening, key interning,
  spine selection, prefix verification — runs in the vectorized numpy
  front (``_build_py``; the reference's C parser is not ported),
* writer maps, element-level scans (aborted reads, unobserved writers,
  intermediate reads), the internal (own-writes) check, ww/wr/rw edge
  derivation and the realtime/process timing edges are array joins over
  the ~n_appends spine/last-element columns: sorts, searchsorted,
  gathers (``_tail``).

The key economy: a read that verifies as a clean prefix of its key's
spine contains only spine elements, so element-level scans run over the
spine columns instead of the O(sum of read lengths) raw payloads. Rows
that fail verification (rare, and exactly the anomalous ones) get
per-row Python scrutiny with the oracle's semantics.

Applies when append/fail values are ints in [0, 2^32) (the universal
workload shape — elle's own generator emits dense int appends); anything
else returns None and the caller takes the Python builder. The
cpu-oracle path never comes here: the tests pin this builder to it.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from jepsen_tpu_torch import elle
from jepsen_tpu_torch.elle import Graph, PROCESS, REALTIME, RW, WR, WW, _TYPE_CODE
from jepsen_tpu_torch.txn import _hk

# copied from jepsen_tpu/elle/columnar.py:41-46
# composite-key bit budget: (txn << 32) | (kid << 12) | mi must be exact
# in int64, and (kid << 32) | value needs value in [0, 2^32)
_MAX_KIDS = 1 << 20
_I64 = 1 << 63
_MAX_MOPS = 1 << 12
_MAX_VAL = 1 << 32


# copied from jepsen_tpu/elle/columnar.py:49-52: phase timings of the
# most recent check_columnar call (seconds); build is the host-side numpy
# build, cycles the (possibly device) screen + search
LAST_PHASE_SECONDS: dict = {}


# copied from jepsen_tpu/elle/columnar.py:61-93, without the history-IR
# ``parts`` hand-off
def check_columnar(history: list, consistency_models, accelerator: str,
                   device=None):
    """Full list-append check on the columnar fast path, or None when the
    history falls outside the integer regime (the caller takes the Python
    builder). Device work runs on ``device`` (the CUDA device by
    default)."""
    import time as _time
    t0 = _time.perf_counter()
    try:
        parts = _build(history)
    except (TypeError, ValueError, OverflowError):
        return None
    if parts is None:
        return None
    graph, txns, extras, n_keys = parts
    t1 = _time.perf_counter()

    cyc = elle.check_cycles(graph, accelerator=accelerator, device=device)
    LAST_PHASE_SECONDS.update(build=round(t1 - t0, 3),
                              cycles=round(_time.perf_counter() - t1, 3))
    merged_extras = {k: v for k, v in extras.items()
                     if k != "unobserved-writer"}
    result = elle.result_map(cyc, txns, merged_extras,
                             consistency_models=consistency_models)
    result["txn-count"] = graph.n
    result["edge-count"] = graph.edge_count()
    result["read-scan-keys"] = {"columnar": n_keys, "python": 0}
    result["builder"] = "columnar"
    return result


# jepsen_tpu/elle/columnar.py:96-107 without the C parser, which is not
# ported: the numpy front alone, as the reference runs without it
def _build(history: list):
    """Dependency-graph build. Returns (graph, txns, extras, n_keys) or
    None (regime miss)."""
    return _build_py(history)


# copied from jepsen_tpu/elle/columnar.py:143-145
class NeedsObjects(Exception):
    """A finding requires op-object context (txn values) that stored
    columns don't carry — re-run the check from the jsonl history."""


# copied from jepsen_tpu/elle/columnar.py:296-364
def _flatten_mops_fast(txns):
    """Vectorized pass B for the all-int regime (every mop key a plain
    int, every append value a plain int): C-speed comprehensions +
    numpy replace the per-mop Python loop, which dominates the whole
    check on large histories. Returns the exact pass-B product —
    including kid ids in FIRST-ENCOUNTER order over appended/read mops,
    matching the general loop's interning bit-for-bit — or None to fall
    back to the general loop (exotic keys/values, over-long txns).
    Differentially pinned to the loop by the columnar-vs-python fuzz in
    tests/test_elle.py."""
    vals = [op.get("value") or () for op in txns]
    # only sized, re-iterable containers take the fast path — a one-shot
    # or unsized iterable (no len, or consumed by the flatten) must flow
    # to the general loop, which iterates each value exactly once
    if any(type(v) not in (list, tuple) for v in vals):
        return None
    counts = np.fromiter((len(v) for v in vals), np.int64, len(vals))
    total = int(counts.sum())
    if counts.size and int(counts.max()) > _MAX_MOPS:
        return None
    mops = [m for v in vals for m in v]
    if not mops:
        return None
    try:
        fs = [m[0] for m in mops]
        keys = [m[1] for m in mops]
        third = [m[2] for m in mops]
    except (ValueError, IndexError, TypeError):
        return None
    if any(type(k) is not int or k < -_I64 or k >= _I64 for k in keys):
        return None  # exotic/huge keys: the general loop interns anything

    flat_txn = np.repeat(np.arange(len(vals), dtype=np.int64), counts)
    flat_mi = (np.arange(total, dtype=np.int64)
               - np.repeat(np.cumsum(counts) - counts, counts))
    is_append = np.fromiter((f == "append" for f in fs), bool, total)
    is_read = np.fromiter(
        (f == "r" and t is not None for f, t in zip(fs, third)),
        bool, total)
    ai = np.nonzero(is_append)[0]
    ri = np.nonzero(is_read)[0]

    a_val = [third[j] for j in ai.tolist()]
    if any(type(v) is not int for v in a_val):
        return None
    payloads = [third[j] if type(third[j]) is list else list(third[j])
                for j in ri.tolist()]

    # interning: ids in first-encounter order over appended/read mops
    # (ignored mops' keys never intern — same as kid())
    karr = np.asarray(keys, np.int64)
    sel = np.sort(np.concatenate([ai, ri]))
    ksel = karr[sel]
    uniq, first_idx, inverse = np.unique(ksel, return_index=True,
                                         return_inverse=True)
    order = np.argsort(first_idx)
    rank = np.empty(order.size, np.int64)
    rank[order] = np.arange(order.size)
    kid_of_flat = np.full(total, -1, np.int64)
    kid_of_flat[sel] = rank[inverse]
    raw_key = uniq[order].tolist()
    kid_of = {k: i for i, k in enumerate(raw_key)}

    # a_* go straight back into np.asarray downstream: return arrays
    # (no copy on re-asarray); r_kid stays a python list — the prefix
    # loop indexes it per row and np scalar boxing would cost more
    return (flat_txn[ai], kid_of_flat[ai], a_val, flat_mi[ai],
            flat_txn[ri], kid_of_flat[ri].tolist(), flat_mi[ri],
            payloads, raw_key, kid_of)


# copied from jepsen_tpu/elle/columnar.py:367-467
def _build_py(history: list):
    # ---- pass A: event extraction + invocation pairing -----------------
    # Closed form of the pending-dict walk: a completion's invocation is
    # the previous event of the same process iff that event is an invoke
    # (a newer invoke overwrites, a completion consumes — both exactly
    # the "previous event" rule). Verified equivalent by differential
    # test against the dict semantics.
    nh = len(history)
    types = [op.get("type") for op in history]
    procs = [op.get("process") for op in history]
    _EV = {"invoke": 0, "ok": 1, "fail": 1, "info": 1}
    ev = [_EV.get(t, -1) for t in types]
    pid_of: dict = {}
    pid = [pid_of.setdefault(p, len(pid_of)) for p in procs]
    ev_a = np.asarray(ev, np.int64)
    pid_a = np.asarray(pid, np.int64)
    sel = np.nonzero(ev_a >= 0)[0]
    o = sel[np.argsort(pid_a[sel], kind="stable")]
    link = ((pid_a[o][1:] == pid_a[o][:-1]) & (ev_a[o][:-1] == 0)
            & (ev_a[o][1:] == 1)) if o.size > 1 else np.zeros(0, bool)
    inv_pos_of = np.full(nh, -1, np.int64)
    if o.size > 1:
        inv_pos_of[o[1:][link]] = o[:-1][link]

    # mask-select ok/info/fail positions at C speed (the per-event
    # conditional comprehensions dominated the whole build at 50k txns)
    pint = np.fromiter((isinstance(p, int) for p in procs), bool, nh)
    ok_m = np.fromiter((t == "ok" for t in types), bool, nh)
    info_m = np.fromiter((t == "info" for t in types), bool, nh)
    fail_m = np.fromiter((t == "fail" for t in types), bool, nh)
    ok_pos = np.nonzero(ok_m & pint)[0]
    info_pos = np.nonzero(info_m & pint)[0]
    fail_ops = [history[i] for i in np.nonzero(fail_m)[0].tolist()]

    n_ok = int(ok_pos.size)
    node_pos = np.concatenate([ok_pos, info_pos])
    txns = [history[i] for i in node_pos.tolist()]
    n = len(txns)
    if n == 0 or n >= (1 << 31):
        return None
    node_inv = inv_pos_of[node_pos]
    node_proc = np.asarray([procs[i] for i in node_pos.tolist()], np.int64)

    # ---- pass B: flatten micro-ops into columns ------------------------
    def kid(k):
        # interns into kid_of/raw_key (bound at call time): fresh on the
        # general loop, continuing the fast map for fail ops after it
        hk = _hk(k)
        i = kid_of.get(hk)
        if i is None:
            i = kid_of[hk] = len(raw_key)
            raw_key.append(k)
        return i

    fast = _flatten_mops_fast(txns)
    if fast is not None:
        (a_txn, a_kid, a_val, a_mi, r_txn, r_kid, r_mi, payloads,
         raw_key, kid_of) = fast
    else:
        kid_of = {}
        raw_key = []
        a_txn, a_kid, a_val, a_mi = [], [], [], []
        r_txn, r_kid, r_mi = [], [], []
        payloads = []
        for i, op in enumerate(txns):
            for mi, m in enumerate(op.get("value") or ()):
                if mi >= _MAX_MOPS:
                    return None
                f = m[0]
                if f == "append":
                    v = m[2]
                    if not isinstance(v, int) or isinstance(v, bool):
                        return None
                    a_txn.append(i)
                    a_kid.append(kid(m[1]))
                    a_val.append(v)
                    a_mi.append(mi)
                elif f == "r" and m[2] is not None:
                    r_txn.append(i)
                    r_kid.append(kid(m[1]))
                    r_mi.append(mi)
                    payloads.append(m[2] if type(m[2]) is list
                                    else list(m[2]))

    f_kid: list = []
    f_val: list = []
    for op in fail_ops:
        for m in op.get("value") or ():
            if m[0] == "append":
                v = m[2]
                if not isinstance(v, int) or isinstance(v, bool):
                    return None
                f_kid.append(kid(m[1]))
                f_val.append(v)

    return _assemble(txns=txns, n_ok=n_ok, raw_key=raw_key,
                     a_txn=a_txn, a_kid=a_kid, a_val=a_val, a_mi=a_mi,
                     r_txn=r_txn, r_kid=r_kid, r_mi=r_mi,
                     payloads=payloads, f_kid=f_kid, f_val=f_val,
                     node_pos=node_pos, node_inv=node_inv,
                     node_proc=node_proc)


# copied from jepsen_tpu/elle/columnar.py:470-573
def _assemble(*, txns, n_ok, raw_key, a_txn, a_kid, a_val, a_mi,
              r_txn, r_kid, r_mi, payloads, f_kid, f_val,
              node_pos, node_inv, node_proc):
    """Array build + spine selection + prefix verification over flattened
    micro-op columns, ending in the shared :func:`_tail` (in the
    reference the live checker's incremental builder reuses it). Returns
    the ``_build`` 4-tuple or None on a regime miss (the caller takes the
    Python builder)."""
    n = len(txns)
    nk = len(raw_key)
    if nk >= _MAX_KIDS:
        return None

    A_txn = np.asarray(a_txn, np.int64)
    A_kid = np.asarray(a_kid, np.int64)
    A_val = np.asarray(a_val, np.int64)
    A_mi = np.asarray(a_mi, np.int64)
    if A_val.size and (A_val.min() < 0 or A_val.max() >= _MAX_VAL):
        return None
    F_comp = np.asarray([], np.int64)
    if f_val:
        fv = np.asarray(f_val, np.int64)
        if fv.min() < 0 or fv.max() >= _MAX_VAL:
            return None
        F_comp = np.sort((np.asarray(f_kid, np.int64) << 32) | fv)

    n_reads = len(payloads)
    R_txn = np.asarray(r_txn, np.int64)
    R_kid = np.asarray(r_kid, np.int64)
    R_mi = np.asarray(r_mi, np.int64)
    lens = np.asarray([len(p) for p in payloads], np.int64)
    R_isok = R_txn < n_ok  # info txns' reads are unreliable (no spine use)

    # last element per read feeds composite joins (wr edges, internal):
    # must be exact ints; anything else punts to the Python builder
    last_list = [p[-1] if p else -1 for p in payloads]
    last_arr = np.asarray(last_list) if n_reads else np.zeros(0, np.int64)
    if last_arr.size and last_arr.dtype.kind != "i":
        return None
    last_arr = last_arr.astype(np.int64, copy=False)

    # ---- spines: longest ok read per key -------------------------------
    okr = np.nonzero(R_isok)[0]
    soff_of_kid = np.full(nk, -1, np.int64)
    slen_of_kid = np.zeros(nk, np.int64)
    spine_list_of_kid: list = [None] * nk
    if okr.size:
        # first maximal-length read per key (the oracle's max(reads,
        # key=len) picks the FIRST on length ties — order must match, a
        # different spine is a different version order)
        osort = okr[np.lexsort((okr, -lens[okr], R_kid[okr]))]
        kid_sorted = R_kid[osort]
        firstm = np.nonzero(np.r_[True, kid_sorted[1:] != kid_sorted[:-1]])[0]
        spine_rows = osort[firstm]
        spine_kids = R_kid[spine_rows]
        spine_lens = lens[spine_rows]
        spine_arrays = []
        for r, k in zip(spine_rows.tolist(), spine_kids.tolist()):
            spine_list_of_kid[k] = payloads[r]
            a = np.asarray(payloads[r])
            if a.dtype.kind != "i":
                if a.size == 0:
                    a = np.zeros(0, np.int64)
                else:
                    return None  # non-int observed values: python builder
            spine_arrays.append(a.astype(np.int64, copy=False))
        S_concat = (np.concatenate(spine_arrays) if spine_arrays
                    else np.zeros(0, np.int64))
        slen_of_kid[spine_kids] = spine_lens
        soff_of_kid[spine_kids] = np.cumsum(spine_lens) - spine_lens
        s_kid = np.repeat(spine_kids, spine_lens)
    else:
        S_concat = np.zeros(0, np.int64)
        s_kid = np.zeros(0, np.int64)
    if S_concat.size and (S_concat.min() < 0 or S_concat.max() >= _MAX_VAL):
        return None

    # ---- prefix verification: C-speed list compares --------------------
    rows_by_kid: dict = defaultdict(list)
    scrutiny: set = set()
    r_kid_l = r_kid if type(r_kid) is list else \
        R_kid.tolist()  # python list view, avoids 50k np scalar boxing
    for j in okr.tolist():
        k = r_kid_l[j]
        rows_by_kid[k].append(j)
        p = payloads[j]
        sp = spine_list_of_kid[k]
        if p is sp:
            continue  # the spine trivially prefixes itself
        if p != sp[: len(p)]:
            scrutiny.add(j)

    return _tail(
        txns=txns, n=n, n_ok=n_ok, nk=nk, raw_key=raw_key,
        A_txn=A_txn, A_kid=A_kid, A_val=A_val, A_mi=A_mi, F_comp=F_comp,
        R_txn=R_txn, R_kid=R_kid, R_mi=R_mi, lens=lens,
        last_arr=last_arr, R_isok=R_isok, payloads=payloads,
        S_concat=S_concat, s_kid=s_kid, soff_of_kid=soff_of_kid,
        slen_of_kid=slen_of_kid, spine_of=spine_list_of_kid.__getitem__,
        scrutiny=scrutiny, rows_by_kid=rows_by_kid,
        node_pos=node_pos, node_inv=node_inv, node_proc=node_proc)


# copied from jepsen_tpu/elle/columnar.py:576-860
def _tail(*, txns, n, n_ok, nk, raw_key,
          A_txn, A_kid, A_val, A_mi, F_comp,
          R_txn, R_kid, R_mi, lens, last_arr, R_isok, payloads,
          S_concat, s_kid, soff_of_kid, slen_of_kid, spine_of,
          scrutiny, rows_by_kid, node_pos, node_inv, node_proc):
    """Shared analysis tail over the columnar product (either front):
    writer maps, anomaly scans, edge derivation, timing edges."""
    extras: dict[str, list] = defaultdict(list)
    n_reads = len(payloads)

    # lazy rows_by_kid: the reference's C front doesn't build it (only
    # anomaly attribution needs it, which clean histories never reach)
    _rbk = [rows_by_kid]

    def get_rows_by_kid():
        if _rbk[0] is None:
            d: dict = defaultdict(list)
            okr = np.nonzero(R_isok)[0]
            for j, k in zip(okr.tolist(), R_kid[okr].tolist()):
                d[k].append(j)
            _rbk[0] = d
        return _rbk[0]

    # ---- writer map: first append of (key, value) wins -----------------
    A_comp = (A_kid << 32) | A_val
    a_order = np.argsort(A_comp, kind="stable")
    ac_sorted = A_comp[a_order]
    first = np.r_[True, ac_sorted[1:] != ac_sorted[:-1]] \
        if ac_sorted.size else np.zeros(0, bool)
    for j in a_order[~first].tolist():
        extras["duplicate-appends"].append(
            {"key": raw_key[int(A_kid[j])], "value": int(A_val[j])})
    W_comp = ac_sorted[first]
    W_txn = A_txn[a_order][first]

    def writer_lookup(comps):
        if W_comp.size == 0:
            return np.full(comps.shape, -1, np.int64)
        pos = np.clip(np.searchsorted(W_comp, comps), 0, W_comp.size - 1)
        return np.where(W_comp[pos] == comps, W_txn[pos], -1)

    def failed_lookup(comps):
        if F_comp.size == 0:
            return np.zeros(comps.shape, bool)
        pos = np.clip(np.searchsorted(F_comp, comps), 0, F_comp.size - 1)
        return F_comp[pos] == comps

    # keys whose spine repeats a value need per-row duplicate scrutiny
    if S_concat.size:
        comp_spine = (s_kid << 32) | S_concat
        sc = np.sort(comp_spine)
        dup_kids = set((sc[1:][sc[1:] == sc[:-1]] >> 32).tolist())
        if dup_kids:
            for k in dup_kids:
                scrutiny.update(get_rows_by_kid().get(int(k), ()))
    else:
        comp_spine = np.zeros(0, np.int64)

    # ---- spine-element membership: G1a / unobserved / G1b sources ------
    w_of_spine = writer_lookup(comp_spine)
    f_hit_spine = failed_lookup(comp_spine)
    # multi-append writers per (txn, key): the only possible G1b sources
    TK = (A_txn << 32) | A_kid
    tks = np.sort(TK)
    multi_tk = np.unique(tks[1:][tks[1:] == tks[:-1]]) if tks.size else \
        np.asarray([], np.int64)

    def spine_elem_hits(mask):
        """(kid, local position, global elem) for flagged spine elems."""
        idx = np.nonzero(mask)[0]
        return [(int(s_kid[e]), int(e - soff_of_kid[s_kid[e]]), int(e))
                for e in idx.tolist()]

    # lazy Python maps for the rare scrutiny / G1b paths. Keys are
    # (kid, value) tuples — same hash semantics as the oracle's dicts
    # (so a float read of an int append still matches, like the oracle)
    _maps: dict = {}

    def lazy_maps():
        if not _maps:
            writer_txn: dict = {}
            appends_ptk: dict = defaultdict(list)
            srt = np.argsort((A_txn << 32) | (A_kid << 12) | A_mi,
                             kind="stable")
            for j in srt.tolist():
                appends_ptk[(int(A_txn[j]), int(A_kid[j]))].append(
                    int(A_val[j]))
            for comp, w in zip(W_comp.tolist(), W_txn.tolist()):
                writer_txn[(comp >> 32, comp & 0xFFFFFFFF)] = w
            failed = {(c >> 32, c & 0xFFFFFFFF) for c in F_comp.tolist()}
            _maps.update(writer=writer_txn, aptk=appends_ptk, failed=failed)
        return _maps

    def g1b_row(j):
        """Per-writer observed-subsequence check for one read (oracle
        _g1b_one_read semantics: committed multi-append writers must be
        observed all-or-nothing, in order)."""
        m = lazy_maps()
        r = payloads[j]
        k = int(R_kid[j])
        observed: dict = defaultdict(list)
        for v in r:
            w = m["writer"].get((k, v))
            if w is not None:
                observed[w].append(v)
        for wi, obs in observed.items():
            if wi == int(R_txn[j]) or wi >= n_ok:
                continue  # own reads / indeterminate writers: not G1b
            txn_appends = m["aptk"].get((wi, k), [])
            if obs == txn_appends:
                continue
            if obs == txn_appends[: len(obs)]:
                extras["G1b"].append(
                    {"key": raw_key[k], "read": list(r),
                     "writer": txns[wi].get("value")})
            else:
                extras["incompatible-order"].append(
                    {"key": raw_key[k], "read": list(r),
                     "writer-appends": txn_appends})

    def scan_row(j):
        """Full per-row scrutiny (oracle _scan_reads_py semantics)."""
        m = lazy_maps()
        r = payloads[j]
        k = int(R_kid[j])
        sp = spine_of(k) or []
        if r != sp[: len(r)]:
            extras["incompatible-order"].append(
                {"key": raw_key[k], "read": list(r), "longest": list(sp)})
        if len(set(r)) != len(r):
            extras["duplicate-elements"].append(
                {"key": raw_key[k], "read": list(r)})
        for v in r:
            kv = (k, v)
            if kv in m["failed"]:
                extras["G1a"].append(
                    {"key": raw_key[k], "value": v,
                     "read-txn": txns[int(R_txn[j])].get("value")})
            elif kv not in m["writer"]:
                extras["unobserved-writer"].append(
                    {"key": raw_key[k], "value": v})
        g1b_row(j)

    for j in sorted(scrutiny):
        scan_row(j)

    # clean rows: element-level anomalies can only involve spine elements
    def clean_rows_of(k, q):
        return [j for j in get_rows_by_kid().get(k, ())
                if j not in scrutiny and lens[j] > q]

    for k, q, e in spine_elem_hits(f_hit_spine):
        for j in clean_rows_of(k, q):
            extras["G1a"].append(
                {"key": raw_key[k], "value": int(S_concat[e]),
                 "read-txn": txns[int(R_txn[j])].get("value")})
    unobserved = (w_of_spine < 0) & ~f_hit_spine
    for k, q, e in spine_elem_hits(unobserved):
        for j in clean_rows_of(k, q):
            extras["unobserved-writer"].append(
                {"key": raw_key[k], "value": int(S_concat[e])})
    if multi_tk.size and S_concat.size:
        elem_tk = (w_of_spine << 32) | s_kid
        pos = np.clip(np.searchsorted(multi_tk, elem_tk), 0,
                      multi_tk.size - 1)
        m_hit = (multi_tk[pos] == elem_tk) & (w_of_spine >= 0)
        g1b_rows: set = set()
        for k, q, _ in spine_elem_hits(m_hit):
            g1b_rows.update(clean_rows_of(k, q))
        for j in sorted(g1b_rows):
            g1b_row(j)

    # ---- internal: own reads must reflect own earlier appends ----------
    if A_mi.size and n_reads:
        a3_order = np.argsort((A_txn << 32) | (A_kid << 12) | A_mi,
                              kind="stable")
        a3 = ((A_txn << 32) | (A_kid << 12) | A_mi)[a3_order]
        a3_val = A_val[a3_order]
        base = (R_txn << 32) | (R_kid << 12)
        lo = np.searchsorted(a3, base)
        hi = np.searchsorted(a3, base | R_mi)
        cb = hi - lo
        one = np.nonzero(cb == 1)[0]
        if one.size:
            v1 = a3_val[lo[one]]
            bad = np.where(lens[one] > 0, last_arr[one], -1) != v1
            for j, v in zip(one[bad].tolist(), v1[bad].tolist()):
                extras["internal"].append(
                    {"key": raw_key[int(R_kid[j])],
                     "read": list(payloads[j]),
                     "expected-suffix": [int(v)]})
        for j in np.nonzero(cb >= 2)[0].tolist():
            mine = a3_val[lo[j]:hi[j]].tolist()
            r = payloads[j]
            if list(r[-len(mine):]) != mine:
                extras["internal"].append(
                    {"key": raw_key[int(R_kid[j])], "read": list(r),
                     "expected-suffix": mine})

    # ---- dependency edges ----------------------------------------------
    edge_codes: list = []
    edge_src: list = []
    edge_dst: list = []

    def add_edges(code, src, dst):
        if len(src):
            edge_codes.append(np.full(len(src), code, np.int64))
            edge_src.append(np.asarray(src, np.int64))
            edge_dst.append(np.asarray(dst, np.int64))

    if S_concat.size:
        same = s_kid[1:] == s_kid[:-1]
        a, b = w_of_spine[:-1], w_of_spine[1:]
        keep = same & (a >= 0) & (b >= 0) & (a != b)
        add_edges(_TYPE_CODE[WW], a[keep], b[keep])
    if n_reads:
        nz = np.nonzero(R_isok & (lens > 0))[0]
        if nz.size:
            # out-of-range last elements (possible in corrupt off-spine
            # reads) cannot have a writer — and would collide across
            # keys in the 32-bit composite if not masked out
            in_range = (last_arr[nz] >= 0) & (last_arr[nz] < _MAX_VAL)
            nz = nz[in_range]
        if nz.size:
            w = writer_lookup((R_kid[nz] << 32) | last_arr[nz])
            keep = (w >= 0) & (w != R_txn[nz])
            add_edges(_TYPE_CODE[WR], w[keep], R_txn[nz][keep])
        has_next = R_isok & (lens < slen_of_kid[R_kid]) & \
            (soff_of_kid[R_kid] >= 0)
        nz = np.nonzero(has_next)[0]
        if nz.size:
            w = w_of_spine[soff_of_kid[R_kid[nz]] + lens[nz]]
            keep = (w >= 0) & (w != R_txn[nz])
            add_edges(_TYPE_CODE[RW], R_txn[nz][keep], w[keep])

    # ---- timing edges (vectorized add_timing_edges twin) ---------------
    order = np.where(node_inv >= 0, node_inv, node_pos)

    sequential_ok = True
    if n > 1:
        po = np.lexsort((node_pos, node_proc))
        same_p = node_proc[po][1:] == node_proc[po][:-1]
        prev_n, next_n = po[:-1][same_p], po[1:][same_p]
        add_edges(_TYPE_CODE[PROCESS], prev_n, next_n)
        viol = (node_inv[next_n] >= 0) & \
            (node_inv[next_n] < node_pos[prev_n])
        if viol.any():
            sequential_ok = False

    # realtime: a completion a links to every invocation i with
    # pos(a) < t_i < killer(a), where killer(a) is the first completion
    # that both invoked after a completed and has itself completed — the
    # same frontier-domination rule as add_timing_edges, closed-form
    comp_mask = (np.arange(n) < n_ok) & (node_inv >= 0)
    inv_mask = node_inv >= 0
    c_nodes = np.nonzero(comp_mask)[0]
    i_nodes = np.nonzero(inv_mask)[0]
    if c_nodes.size and i_nodes.size:
        c_pos = node_pos[c_nodes]
        by_inv = np.argsort(node_inv[c_nodes])
        inv_sorted = node_inv[c_nodes][by_inv]
        pos_by_inv = c_pos[by_inv]
        suffix_min = np.minimum.accumulate(pos_by_inv[::-1])[::-1]
        j = np.searchsorted(inv_sorted, c_pos, side="right")
        killer = np.r_[suffix_min, np.iinfo(np.int64).max][j]
        ti_order = np.argsort(node_inv[i_nodes])
        ts = node_inv[i_nodes][ti_order]
        i_sorted = i_nodes[ti_order]
        lo_i = np.searchsorted(ts, c_pos, side="right")
        hi_i = np.searchsorted(ts, killer, side="left")
        counts = np.maximum(hi_i - lo_i, 0)
        total = int(counts.sum())
        if total:
            src = np.repeat(c_nodes, counts)
            offs = np.arange(total) - np.repeat(
                np.cumsum(counts) - counts, counts)
            dst = i_sorted[np.repeat(lo_i, counts) + offs]
            add_edges(_TYPE_CODE[REALTIME], src, dst)

    cols = (np.concatenate(edge_codes) if edge_codes else np.zeros(0, np.int64),
            np.concatenate(edge_src) if edge_src else np.zeros(0, np.int64),
            np.concatenate(edge_dst) if edge_dst else np.zeros(0, np.int64))
    graph = Graph(n, edges=[], time_order=order if sequential_ok else None,
                  cols=cols)
    return graph, txns, extras, nk
