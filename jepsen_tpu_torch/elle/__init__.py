"""Transactional-anomaly detection, the Elle check (the port of
jepsen_tpu/elle/__init__.py; capability-equivalent to Elle, invoked from
jepsen/src/jepsen/tests/cycle*.clj).

Builds ww/wr/rw dependency graphs from txn histories, detects cycles with
the device kernels of jepsen_tpu_torch.ops.scc (the per-cluster screen and
the trim), and classifies anomalies with Adya's taxonomy:

* G0 (write cycle): cycle of only ww edges
* G1a (aborted read): observed a failed txn's write
* G1b (intermediate read): observed a non-final write of a txn
* G1c (cyclic information flow): cycle of ww+wr edges
* G-single (read skew): cycle with exactly one rw anti-dependency
* G2 (anti-dependency cycle): cycle with >= 2 rw edges
* internal: a txn's reads contradict its own earlier ops
* realtime-cycle: dependency cycle closed by a realtime precedence edge
  (txn A completed before txn B was invoked) — strict-serializability only
* process-cycle: dependency cycle closed by a same-process succession
  edge — sequential consistency and stronger
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np

from jepsen_tpu_torch.ops import scc as scc_mod
from jepsen_tpu_torch.ops.jitlin import _bucket

ACCELERATORS = ("gpu", "cpu", "auto")

# copied from jepsen_tpu/elle/__init__.py:23-66
WW, WR, RW = "ww", "wr", "rw"
REALTIME, PROCESS = "realtime", "process"

# anomaly -> weakest consistency model it violates (loosely following
# elle's anomaly/model mapping)
ANOMALY_SEVERITY = {
    "G0": "read-uncommitted",
    "cyclic-versions": "read-uncommitted",
    "G1a": "read-committed",
    "G1b": "read-committed",
    "G1c": "read-committed",
    "internal": "read-atomic",
    "duplicate-elements": "read-atomic",
    "incompatible-order": "read-atomic",
    "G-single": "snapshot-isolation",
    "G2": "serializable",
    "process-cycle": "sequential",
    "realtime-cycle": "strict-serializable",
}

SERIALIZABLE_BLOCKERS = {"G0", "G1a", "G1b", "G1c", "G-single", "G2",
                         "internal", "duplicate-elements",
                         "incompatible-order"}

# anomalies proscribed by each consistency model (Adya's hierarchy, the
# shape of elle's consistency-model option)
_RU = {"G0", "duplicate-elements", "incompatible-order", "duplicate-appends",
       "duplicate-writes", "cyclic-versions"}
_RC = _RU | {"G1a", "G1b", "G1c", "internal"}
MODEL_ANOMALIES = {
    "read-uncommitted": _RU,
    "read-committed": _RC,
    "read-atomic": _RC,
    "repeatable-read": _RC | {"G-single"},
    "snapshot-isolation": _RC | {"G-single"},
    "serializable": _RC | {"G-single", "G2"},
    "sequential": _RC | {"G-single", "G2", "process-cycle"},
    "strict-serializable": _RC | {"G-single", "G2", "realtime-cycle",
                                  "process-cycle"},
}


# copied from jepsen_tpu/elle/__init__.py:69-73
def blocked_anomalies(consistency_models) -> set:
    out: set = set()
    for m in consistency_models or ("strict-serializable",):
        out |= MODEL_ANOMALIES.get(m, SERIALIZABLE_BLOCKERS)
    return out


# copied from jepsen_tpu/elle/__init__.py:76-124
@dataclass
class Graph:
    """Typed edge-list dependency graph over txn indices.

    Two storage forms: ``edges`` (list of (src, dst, type) tuples — the
    incremental builder API) or ``cols`` (columnar int64 arrays
    (type-codes, src, dst) — what the vectorized builder in
    elle.columnar produces). ``edge_list()`` materializes tuples from
    columns on demand so every consumer works with either form."""

    n: int
    edges: list = field(default_factory=list)  # (src, dst, type)
    # per-node history position (invocation when known), filled by
    # add_timing_edges; None when unavailable or per-process
    # sequentiality was violated
    time_order: np.ndarray | None = None
    cols: tuple | None = None  # (codes, src, dst) int64 arrays

    def add(self, src: int, dst: int, typ: str):
        if src != dst or typ == RW:
            self.edges.append((src, dst, typ))

    def edge_list(self) -> list:
        if self.cols is not None and not self.edges:
            codes, src, dst = self.cols
            self.edges = [(int(s), int(d), _CODE_TYPE[int(c)])
                          for c, s, d in zip(codes.tolist(), src.tolist(),
                                             dst.tolist())]
        return self.edges

    def arrays(self, types: set | None = None):
        if self.cols is not None and not self.edges:
            codes, src, dst = self.cols
            if types is None:
                keep = np.ones(len(codes), bool)
            else:
                tcodes = [_TYPE_CODE[t] for t in types]
                keep = np.isin(codes, tcodes)
            return src[keep].astype(np.int32), dst[keep].astype(np.int32)
        es = [(s, d) for s, d, t in self.edges
              if types is None or t in types]
        if not es:
            return np.zeros(0, np.int32), np.zeros(0, np.int32)
        a = np.asarray(es, dtype=np.int32)
        return a[:, 0], a[:, 1]

    def edge_count(self) -> int:
        return len(self.cols[0]) if (self.cols is not None
                                     and not self.edges) else len(self.edges)


# copied from jepsen_tpu/elle/__init__.py:127-194
def add_timing_edges(graph: Graph, history: list, txns: list,
                     realtime: bool = True, process: bool = True) -> None:
    """Adds realtime and process precedence edges to a dependency graph
    (the reference's strict-serializability surface: elle's realtime /
    process graphs behind jepsen/src/jepsen/tests/cycle/wr.clj:31-45).

    *Realtime*: txn A precedes txn B when A's completion appears before
    B's invocation in history order. Rather than the O(n^2) full order we
    add its transitive reduction with the frontier construction: a
    completed txn stays in the frontier until some later txn both invoked
    after it completed and has itself completed (dominating it), so every
    invocation links only from the O(concurrency) non-dominated txns and
    the closure of the added edges equals the full realtime order.
    Requires invocation events in the history; completion-only histories
    get no realtime edges (their intervals are unknown).

    *Process*: consecutive committed txns of one process, in history
    order — sound even for completion-only histories because a process is
    sequential by construction (the interpreter renumbers crashed
    processes rather than reusing them).

    ``info`` (indeterminate) txns never complete, so they may *receive*
    timing edges from their invocation point but never enter the frontier.
    """
    node_of = {id(op): i for i, op in enumerate(txns)}
    pending: dict = {}          # process -> history position of open invoke
    last_by_process: dict = {}  # process -> (last completed node, its pos)
    events: list = []           # (pos, 0=invoke|1=complete, node, invoke_pos)
    # Per-node event position (invocation when known, else completion):
    # every timing edge strictly increases it, so check_cycles can screen
    # the timing stages with a potential argument (see there). A history
    # that violates per-process sequentiality voids the screen.
    order = np.full(graph.n, -1, np.int64)
    sequential_ok = True
    for pos, op in enumerate(history):
        t = op.get("type")
        p = op.get("process")
        if t == "invoke":
            pending[p] = pos
            continue
        if t not in ("ok", "fail", "info"):
            continue
        inv = pending.pop(p, None)
        node = node_of.get(id(op))
        if node is None:
            continue
        order[node] = pos if inv is None else inv
        if process and isinstance(p, int):
            prev = last_by_process.get(p)
            if prev is not None:
                graph.add(prev[0], node, PROCESS)
                if inv is not None and inv < prev[1]:
                    sequential_ok = False  # overlapping ops in one process
            last_by_process[p] = (node, pos)
        if realtime and inv is not None:
            events.append((inv, 0, node, inv))
            if t != "info":
                events.append((pos, 1, node, inv))
    events.sort()
    frontier: list = []  # (complete_pos, node), none dominated
    for pos, kind, node, inv in events:
        if kind == 0:
            for _c, a in frontier:
                graph.add(a, node, REALTIME)
        else:
            frontier = [(c, a) for c, a in frontier if c >= inv]
            frontier.append((pos, node))
    graph.time_order = order if sequential_ok else None


# The three thresholds keep the reference's values; where the card's
# crossovers lie is not measured.
# copied from jepsen_tpu/elle/__init__.py:200: below this many edges,
# "auto" trims on the host (see residue() in _check_cycles_global)
TRIM_DEVICE_MIN_EDGES = 500_000

# copied from jepsen_tpu/elle/__init__.py:205: φ-interval clusters larger
# than this skip the screen and go straight to the exact typed search
# (the screen kernel holds at most a 1024-node cluster in shared memory)
MATRIX_CLUSTER_MAX = 1024

# copied from jepsen_tpu/elle/__init__.py:210: under "auto", clusters are
# settled by host Tarjan directly unless the batched work is at least
# this many elements (B·V²)
SCREEN_DEVICE_MIN_ELEMS = 1 << 16


# copied from jepsen_tpu/elle/__init__.py:213-253
def check_cycles(graph: Graph, accelerator: str = "auto",
                 device=None) -> dict:
    """Finds and classifies cycles (the structure of elle.core/check with
    typed searches, jepsen/src/jepsen/tests/cycle.clj).

    Production path (``auto``/``gpu``) is φ-interval localization:
    add_timing_edges records each node's event position φ, and all timing
    edges strictly increase φ by construction, so **every cycle must
    traverse a φ-decreasing dependency edge** ("back edge"). Forward
    paths visit φ-monotone node intervals, so every cycle — and therefore
    every SCC — lies entirely inside the merged φ-interval hull of its
    back edges (proof in _phi_clusters). Back-edge detection and interval
    merging are O(E) vectorized; each cluster is then settled EXACTLY by
    the per-cluster screen on the device
    (ops.scc.batch_cluster_screen — one launch for all clusters) and
    flagged clusters get the exact typed classification on their few
    nodes. No trim, no full-graph Tarjan, and the two timing stages ride
    the same clusters.

    ``cpu`` keeps the trim + global-Tarjan pipeline unchanged — it is the
    auditable oracle twin the differential tests pin the fast path to.
    Histories without a usable φ (no invocations recorded, or per-process
    sequentiality violated) take that pipeline too, with the trim on the
    device. ``accelerator="gpu"`` takes the device wherever the reference's
    "tpu" does; device work runs on ``device`` (the CUDA device by
    default)."""
    if accelerator not in ACCELERATORS:
        raise ValueError(f"accelerator {accelerator!r} not in "
                         f"{ACCELERATORS}")
    if accelerator == "cpu":
        return _check_cycles_global(graph, accelerator)

    codes, src, dst, order = _edge_columns(graph)
    if order is None:
        return _check_cycles_global(graph, accelerator, device)

    dep_mask = codes <= 2
    o_s, o_d = order[src], order[dst]
    if ((o_s < 0) | (o_d < 0)).any():
        # a node never matched to a history event: φ is unusable
        return _check_cycles_global(graph, accelerator, device)
    back = dep_mask & (o_d <= o_s)
    if not back.any():
        return {}  # all dependency edges increase φ: acyclic in every stage

    clusters = _phi_clusters(order[src[back]], order[dst[back]])
    return _check_cycles_clusters(codes, src, dst, order, clusters,
                                  accelerator, device)


# copied from jepsen_tpu/elle/__init__.py:256-257
_TYPE_CODE = {WW: 0, WR: 1, RW: 2, REALTIME: 3, PROCESS: 4}
_CODE_TYPE = {v: k for k, v in _TYPE_CODE.items()}


# copied from jepsen_tpu/elle/__init__.py:260-272
def _edge_columns(graph: Graph):
    """Columnar (type-code, src, dst, φ) view of the graph, built once
    (free when the columnar builder already produced ``cols``)."""
    if graph.time_order is None:
        return None, None, None, None
    if graph.cols is not None and not graph.edges:
        codes, src, dst = graph.cols
        return codes, src, dst, graph.time_order
    if not graph.edges:
        return None, None, None, None
    arr = np.asarray([(_TYPE_CODE[t], s, d) for s, d, t in graph.edges],
                     np.int64)
    return arr[:, 0], arr[:, 1], arr[:, 2], graph.time_order


# copied from jepsen_tpu/elle/__init__.py:275-301
def _phi_clusters(back_src_phi: np.ndarray, back_dst_phi: np.ndarray):
    """Merges back-edge φ-intervals into disjoint clusters [(lo, hi), ...].

    Soundness: a cycle alternates back edges with (possibly empty)
    forward paths. A forward path from a to b climbs φ monotonically, so
    its nodes lie in [φ(a), φ(b)]; hence every node of the cycle lies in
    the union of its back edges' intervals [φ(dst), φ(src)]. Consecutive
    intervals around the cycle overlap (the forward path from one back
    edge's dst ends at the next one's src, so φ(dst_i) <= φ(src_{i+1})
    and disjointness would contradict it), so the whole cycle sits inside
    ONE merged cluster. Clusters are therefore an exact localization: all
    cycles (and all nontrivial SCCs) of every stage's edge set live
    inside them, and none spans two."""
    lo = np.minimum(back_dst_phi, back_src_phi)
    hi = np.maximum(back_dst_phi, back_src_phi)
    order = np.argsort(lo, kind="stable")
    lo, hi = lo[order], hi[order]
    out = []
    cur_lo, cur_hi = int(lo[0]), int(hi[0])
    for l, h in zip(lo[1:].tolist(), hi[1:].tolist()):
        if l <= cur_hi:
            cur_hi = max(cur_hi, h)
        else:
            out.append((cur_lo, cur_hi))
            cur_lo, cur_hi = l, h
    out.append((cur_lo, cur_hi))
    return out


# copied from jepsen_tpu/elle/__init__.py:304-382
def _check_cycles_clusters(codes, src, dst, order, clusters,
                           accelerator: str, device=None) -> dict:
    """Classifies anomalies cluster by cluster. Every edge (any type) with
    both endpoint φs inside a cluster's interval joins that cluster's
    subgraph; the device screen proves most clusters acyclic in a few
    batched dispatches and the exact typed searches run only on the rest.

    Clusters are remapped to dense local ids ONCE, then grouped into
    size buckets for the screen — so a thousand 4-node clusters never
    pay a single big cluster's [V, V] matrix footprint."""
    los = np.asarray([c[0] for c in clusters], np.int64)
    his = np.asarray([c[1] for c in clusters], np.int64)
    o_s, o_d = order[src], order[dst]
    # cluster id per edge (-1 = none): both endpoints inside one interval
    cid_s = np.searchsorted(los, o_s, side="right") - 1
    in_s = (cid_s >= 0) & (o_s <= his[np.clip(cid_s, 0, len(his) - 1)])
    cid_d = np.searchsorted(los, o_d, side="right") - 1
    in_d = (cid_d >= 0) & (o_d <= his[np.clip(cid_d, 0, len(his) - 1)])
    member = in_s & in_d & (cid_s == cid_d)
    e_cid = np.where(member, cid_s, -1)

    # pack per-cluster edge lists (global node ids), remap once apiece
    sel = np.nonzero(member)[0]
    sel = sel[np.argsort(e_cid[sel], kind="stable")]
    bounds = np.searchsorted(e_cid[sel], np.arange(len(clusters) + 1))
    remapped: list = []  # (n_local, local_edges, to_global) per cluster
    for c in range(len(clusters)):
        idx = sel[bounds[c]:bounds[c + 1]]
        edges = [(int(src[i]), int(dst[i]), _CODE_TYPE[int(codes[i])])
                 for i in idx.tolist()]
        remapped.append(_remap_full(edges) if edges else None)

    # group screenable clusters into size buckets so each screen call's
    # [B, V, V] footprint matches its clusters
    big: list = []
    buckets: dict[int, list] = {}
    for c, rm in enumerate(remapped):
        if rm is None:
            continue
        if rm[0] > MATRIX_CLUSTER_MAX:
            big.append(c)
            continue
        buckets.setdefault(_bucket(rm[0], floor=8), []).append(c)

    live: list = []
    for vb, members in sorted(buckets.items()):
        use_device = accelerator == "gpu" or (
            accelerator == "auto"
            and len(members) * vb * vb >= SCREEN_DEVICE_MIN_ELEMS)
        if use_device:
            packed_cid: list = []
            packed_src: list = []
            packed_dst: list = []
            for b, c in enumerate(members):
                for s, d, _ in remapped[c][1]:
                    packed_cid.append(b)
                    packed_src.append(s)
                    packed_dst.append(d)
            flags = scc_mod.batch_cluster_screen(
                np.asarray(packed_cid, np.int32),
                np.asarray(packed_src, np.int32),
                np.asarray(packed_dst, np.int32), len(members), vb,
                device=device)
            live += [c for c, f in zip(members, flags.tolist()) if f]
        else:
            # host screen: no nontrivial SCC means no cycles
            live += [c for c in members
                     if scc_mod.tarjan_scc(
                         remapped[c][0],
                         [(s, d) for s, d, _ in remapped[c][1]])]
    live += big  # oversized clusters go straight to the exact pass

    anomalies: dict[str, list] = {}
    for c in sorted(live):
        n_local, local_edges, to_global = remapped[c]
        _classify_stages(n_local, local_edges, to_global, anomalies)
    return anomalies


# copied from jepsen_tpu/elle/__init__.py:385-390
def _remap_full(edges):
    nodes = sorted({v for s, d, _ in edges for v in (s, d)})
    local = {g: i for i, g in enumerate(nodes)}
    return (len(nodes),
            [(local[s], local[d], t) for s, d, t in edges],
            nodes)


# copied from jepsen_tpu/elle/__init__.py:393-459
def _run_stages(n: int, dep_edges: list, all_edges: list, emit) -> None:
    """The typed anomaly stages, shared verbatim by the global pipeline
    and the per-cluster classifier (one copy so the two cannot
    desynchronize — the differential tests pin them together).

    * G0: ww-only cycles.
    * G1c: ww+wr cycles through at least one wr edge. When G0 exists the
      same SCC may hold both a pure-ww and a mixed cycle, so the search
      goes through each wr edge specifically to avoid shadowing.
    * G-single / G2: per-SCC fewest-rw cycle over the dependency edges
      (n_rw == 0 cycles were already reported as G0/G1c).
    * realtime / process: cycles forced through a timing edge. A strict
      serialization must respect realtime AND process order, so the
      realtime search walks paths through process edges too; the process
      search stays dep+process only — exactly the sequential-consistency
      question.

    ``dep_edges`` may be a trimmed superset (global path) or a cluster's
    dependency subset; ``all_edges`` additionally carries the timing
    edges for the timing stages."""
    # G0: ww-only cycles
    ww_edges = [e for e in dep_edges if e[2] == WW]
    g0 = _exemplars(n, ww_edges) if ww_edges else []
    emit("G0", g0)

    # G1c: ww+wr cycles through at least one wr edge
    g1_edges = [e for e in dep_edges if e[2] in (WW, WR)]
    if g1_edges:
        if not g0:
            emit("G1c", _exemplars(n, g1_edges))
        else:
            emit("G1c", _cycles_through_type(n, g1_edges, WR))

    # dependency stage: G-single / G2 via per-SCC fewest-rw cycles
    if dep_edges:
        sccs = scc_mod.tarjan_scc(n, [(s, d) for s, d, _ in dep_edges])
        singles, g2s = [], []
        for scc in sccs:
            cycle = scc_mod.find_cycle_in_scc(scc, dep_edges,
                                              prefer_fewest=RW)
            if cycle is None:
                continue
            n_rw = sum(1 for _, _, t in cycle if t == RW)
            if n_rw == 1:
                singles.append(cycle)
            elif n_rw >= 2:
                g2s.append(cycle)
        emit("G-single", singles)
        emit("G2", g2s)

    # timing stages: cycles through a realtime/process edge
    for typ, path_types, name in (
            (REALTIME, (WW, WR, RW, REALTIME, PROCESS), "realtime-cycle"),
            (PROCESS, (WW, WR, RW, PROCESS), "process-cycle")):
        if not any(t == typ for _, _, t in all_edges):
            continue
        timed = [e for e in all_edges if e[2] in path_types]
        sccs = scc_mod.tarjan_scc(n, [(s, d) for s, d, _ in timed])
        if not sccs:
            continue
        keep = {v for scc in sccs for v in scc}
        scc_edges = [(s, d, t) for s, d, t in timed
                     if s in keep and d in keep]
        if any(t == typ for _, _, t in scc_edges):
            emit(name, _cycles_through_type(n, scc_edges, typ))


# copied from jepsen_tpu/elle/__init__.py:462-478
def _classify_stages(n: int, edges: list, to_global: list,
                     anomalies: dict, limit: int = 10) -> None:
    """Runs the typed anomaly stages on one cluster subgraph and merges
    renders (in GLOBAL node ids) into ``anomalies``. Restricting each
    search to the cluster loses nothing: closed walks, like cycles, sit
    φ-inside one cluster (_phi_clusters), so every path the global BFS
    could use is cluster-internal."""
    def emit(name, cycles):
        if cycles:
            room = limit - len(anomalies.get(name, []))
            if room > 0:
                anomalies.setdefault(name, []).extend(
                    [[(to_global[s], to_global[d], t) for s, d, t in cyc]
                     for cyc in cycles[:room]])

    dep_edges = [e for e in edges if e[2] in (WW, WR, RW)]
    _run_stages(n, dep_edges, edges, emit)


# copied from jepsen_tpu/elle/__init__.py:481-551
def _check_cycles_global(graph: Graph, accelerator: str = "auto",
                         device=None) -> dict:
    """Trim + global Tarjan pipeline: the oracle twin of the φ-cluster
    path, and the path taken when no usable φ exists. Device trim narrows
    the graph; exact host Tarjan + typed cycle search classify the
    residue."""
    anomalies: dict[str, list] = {}
    graph.edge_list()  # materialize tuples if the builder was columnar

    # Potential-function screen shared by every stage: add_timing_edges
    # records each node's event position φ, and all timing edges strictly
    # increase φ by construction. If every dependency edge also strictly
    # increases φ, no cycle can exist in ANY stage's edge set (a cycle
    # would strictly increase φ around a loop) — the common
    # valid-history case settles with two vectorized comparisons, no trim.
    order = graph.time_order
    dep_screen = False
    dep = np.asarray([(s, d) for s, d, t in graph.edges
                      if t in (WW, WR, RW)], np.int64)
    if order is not None:
        if dep.size == 0:
            dep_screen = True  # timing edges alone are acyclic
        else:
            o_s, o_d = order[dep[:, 0]], order[dep[:, 1]]
            dep_screen = bool((o_s >= 0).all() and (o_d >= 0).all()
                              and (o_d > o_s).all())
    if dep_screen:
        return anomalies

    def residue(types: set | None):
        src, dst = graph.arrays(types)
        if len(src) == 0:
            return []
        # "auto" takes the device trim only at scale: below this edge
        # count it peels on the host (the trim is O(diameter) sequential
        # sweeps either way)
        if accelerator == "cpu" or (
                accelerator == "auto"
                and len(src) < TRIM_DEVICE_MIN_EDGES):
            mask = _trim_cpu(graph.n, src, dst)
        else:
            mask = scc_mod.trim_to_cycles(graph.n, src, dst, device=device)
        if not mask.any():
            return []
        keep = set(np.nonzero(mask)[0].tolist())
        return [(s, d, t) for s, d, t in graph.edges
                if (types is None or t in types) and s in keep and d in keep]

    # The trim residue is a *superset* of the cycle nodes (and may be
    # loose when the peel hits its iteration cap on long-diameter graphs),
    # so only the exact host search's findings count as anomalies.
    #
    # One device trim serves every dependency stage: a cycle in any typed
    # subset (ww-only, ww+wr) is a cycle of the full dependency graph, so
    # its nodes are inside the full residue — the typed stages search the
    # residue-restricted subsets exactly instead of paying a trim each.
    #
    # The timing stages get the UNtrimmed edge set: the peel trim is
    # wrong for them (timing edges chain nearly the whole history, so
    # peeling needs O(diameter) ~ O(n) sweeps; linear-time Tarjan inside
    # _run_stages goes straight to the nontrivial SCCs instead).
    full_edges = residue({WW, WR, RW})

    def emit(name, cycles):
        if cycles:
            anomalies[name] = cycles

    _run_stages(graph.n, full_edges, graph.edges, emit)
    return anomalies


# copied from jepsen_tpu/elle/__init__.py:554-566
def _trim_cpu(n, src, dst, max_iters: int = 512):
    """Pure-numpy twin of the device trim kernel (oracle). Same iteration
    cap: the residue is a superset of the cycle nodes either way."""
    active = np.ones(n, dtype=bool)
    for _ in range(max_iters):
        ea = active[src] & active[dst]
        indeg = np.bincount(dst[ea], minlength=n) > 0
        outdeg = np.bincount(src[ea], minlength=n) > 0
        new = active & indeg & outdeg
        if (new == active).all():
            break
        active = new
    return active


# copied from jepsen_tpu/elle/__init__.py:569-577
def _exemplars(n, edges, limit: int = 10):
    sccs = scc_mod.tarjan_scc(n, [(s, d) for s, d, _ in edges])
    out = []
    for scc in sccs[:limit]:
        c = scc_mod.find_cycle_in_scc(scc, edges)
        if c is not None:
            out.append(c)
    return out


# copied from jepsen_tpu/elle/__init__.py:580-595
def _cycles_through_type(n, edges, typ, limit: int = 10):
    """Cycles guaranteed to traverse at least one edge of `typ`: for each
    such edge (s, d), a path d -> s through any edges closes the cycle."""
    adj: dict[int, list] = {}
    types = {t for _, _, t in edges}
    for s, d, t in edges:
        adj.setdefault(s, []).append((d, t))
    out = []
    for s, d, t in edges:
        if t != typ or len(out) >= limit:
            continue
        path = scc_mod._bfs_path(adj, d, s, types)
        if path is not None:
            out.append([(s, d, t)] + path)
    return out


# copied from jepsen_tpu/elle/__init__.py:598-604
def render_cycle(cycle, txns) -> list:
    """Makes a cycle human-readable: the txns along it."""
    out = []
    for s, d, t in cycle:
        out.append({"from": txns[s].get("value"), "type": t,
                    "to": txns[d].get("value")})
    return out


# copied from jepsen_tpu/elle/__init__.py:607-627
def result_map(anomalies: dict, txns, extra_anomalies: dict | None = None,
               consistency_models=("strict-serializable",)) -> dict:
    """Builds the checker result (elle.core/check shape: {:valid?
    :anomaly-types :anomalies}). Validity is judged against the anomalies
    proscribed by the requested consistency models."""
    merged: dict[str, Any] = {}
    for k, cycles in anomalies.items():
        if cycles:
            merged[k] = [render_cycle(c, txns) for c in cycles[:10]]
    for k, v in (extra_anomalies or {}).items():
        if v:
            merged[k] = v[:10] if isinstance(v, list) else v
    types = sorted(merged.keys())
    blocked = blocked_anomalies(consistency_models)
    invalid = [t for t in types if t in blocked]
    return {
        "valid?": not invalid,
        "anomaly-types": types,
        "not": sorted(invalid),
        "anomalies": merged,
    }
