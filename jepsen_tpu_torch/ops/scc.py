"""Cycle detection over dependency graphs: the Elle core (the port of
jepsen_tpu/ops/scc.py).

Two device programs narrow the search, both exact copies of the
reference's results (``ops/scc_kernels.py``):

* :func:`trim_to_cycles` — 2-core peeling of the whole graph. The
  residue holds every cycle (and, when the peel hits its step cap on a
  long-diameter graph, acyclic chains too); exact host Tarjan classifies
  it.
* :func:`batch_cluster_screen` — whether each small cluster of the
  φ-interval path holds a cycle, all clusters in one launch.

The rest is host code: iterative Tarjan (:func:`tarjan_scc`) and the
typed cycle searches (:func:`find_cycle_in_scc`). Edge lists travel to
the device as int32 columns; node and edge counts are bucketed to powers
of two as in the reference (padding edges carry a False validity bit),
which keeps the plain versions' shapes the reference's.
"""
from __future__ import annotations

import numpy as np
import torch

from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.ops import scc_kernels
from jepsen_tpu_torch.ops.jitlin import _bucket


def _padded(cols, n_real: int, floor: int = 64):
    """Columns padded with zeros to the edge bucket, and the validity
    mask (jepsen_tpu/ops/scc.py:87-93)."""
    eb = _bucket(n_real, floor=floor)
    pad = eb - n_real
    out = [np.concatenate([np.asarray(c, np.int32), np.zeros(pad, np.int32)])
           for c in cols]
    valid = np.concatenate([np.ones(n_real, bool), np.zeros(pad, bool)])
    return out, valid


def _check_ids(what: str, limit: int, *cols) -> None:
    for c in cols:
        if len(c) and (int(np.min(c)) < 0 or int(np.max(c)) >= limit):
            raise ValueError(f"{what}: an id outside [0, {limit})")


# copied from jepsen_tpu/ops/scc.py:71-97, on the port's trim kernel
def trim_to_cycles(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                   max_iters: int = 512, device=None) -> np.ndarray:
    """Device trim: returns a bool[n_nodes] mask of nodes surviving 2-core
    peeling (empty => acyclic; every cycle is inside the residue). Peeling
    removes one fringe layer per step, so a near-serial history (a
    ~n-long dependency chain) would need ~n steps to fully converge; the
    cap keeps device time bounded and leaves a conservative residue that
    the exact host pass classifies.

    Node and edge counts are bucketed to powers of two (padding nodes have
    no edges and peel away in the first step; padding edges carry a False
    validity bit). Runs on ``device`` (the CUDA device by default)."""
    if len(src) == 0 or n_nodes == 0:
        return np.zeros(n_nodes, dtype=bool)
    _check_ids("trim_to_cycles", n_nodes, src, dst)
    dev = resolve_device(device)
    nb = _bucket(n_nodes, floor=64)
    (src_p, dst_p), valid = _padded((src, dst), len(src))
    t = [torch.from_numpy(x).to(dev) for x in (src_p, dst_p, valid)]
    mask, _ = scc_kernels.scc_trim(*t, nb, max_iters)
    return mask[:n_nodes].cpu().numpy()


# copied from jepsen_tpu/ops/scc.py:100-111
def has_cycle(n_nodes: int, src, dst, device=None) -> bool:
    """Exact cycle test: device trim narrows, host Tarjan confirms (a
    capped trim's residue may contain acyclic chains)."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    mask = trim_to_cycles(n_nodes, src, dst, device=device)
    if not mask.any():
        return False
    kept = set(np.nonzero(mask)[0].tolist())
    edges = [(int(s), int(d)) for s, d in zip(src, dst)
             if s in kept and d in kept]
    return bool(tarjan_scc(n_nodes, edges))


# copied from jepsen_tpu/ops/scc.py:240-243: ceiling on one screen call's
# [B, V, V] element count (the plain version's float32 adjacency is
# 128 MB at this size); batches beyond it are chunked along the cluster
# axis
SCREEN_MAX_ELEMS = 1 << 25


# copied from jepsen_tpu/ops/scc.py:246-293, on the port's screen kernel
def batch_cluster_screen(cid: np.ndarray, src_l: np.ndarray,
                         dst_l: np.ndarray, n_clusters: int,
                         max_local: int, device=None) -> np.ndarray:
    """Exact per-cluster cycle screen on the device: returns
    bool[n_clusters], True iff cluster ``c`` (edges where ``cid == c``,
    node ids already LOCAL to the cluster) contains a directed cycle.

    This is the device half of the φ-interval Elle path (see
    jepsen_tpu_torch.elle.check_cycles): the host localizes all possible
    cycle nodes into small clusters, and one kernel launch per chunk
    settles every cluster's has-a-cycle question. Transfers are edge
    lists, not matrices. Runs on ``device`` (the CUDA device by
    default)."""
    if n_clusters == 0:
        return np.zeros(0, dtype=bool)
    if len(cid) == 0:
        return np.zeros(n_clusters, dtype=bool)

    vb = _bucket(max_local, floor=8)
    # element budget: chunk the cluster axis when B*V^2 would exceed it
    # (callers bucket clusters by size, so V is tight for every chunk)
    b_max = max(1, SCREEN_MAX_ELEMS // (vb * vb))
    if n_clusters > b_max:
        cid = np.asarray(cid, np.int64)
        out = np.zeros(n_clusters, dtype=bool)
        for b0 in range(0, n_clusters, b_max):
            b1 = min(b0 + b_max, n_clusters)
            m = (cid >= b0) & (cid < b1)
            out[b0:b1] = batch_cluster_screen(
                (cid[m] - b0).astype(np.int32), src_l[m], dst_l[m],
                b1 - b0, max_local, device=device)
        return out

    _check_ids("batch_cluster_screen", n_clusters, cid)
    _check_ids("batch_cluster_screen", vb, src_l, dst_l)
    dev = resolve_device(device)
    bb = _bucket(n_clusters, floor=8)
    (cid_p, src_p, dst_p), valid = _padded((cid, src_l, dst_l), len(cid))
    t = [torch.from_numpy(x).to(dev) for x in (cid_p, src_p, dst_p, valid)]
    flags = scc_kernels.cluster_screen(*t, bb, vb)
    return flags[:n_clusters].cpu().numpy()


# copied from jepsen_tpu/ops/scc.py:296-349
def tarjan_scc(n_nodes: int, edges: list[tuple[int, int]]) -> list[list[int]]:
    """Exact SCCs, iterative Tarjan (host-side; used on the trimmed
    residue). Returns SCCs with >1 node or a self-loop."""
    adj: list[list[int]] = [[] for _ in range(n_nodes)]
    self_loop = set()
    for s, d in edges:
        if s == d:
            self_loop.add(s)
        adj[s].append(d)
    index = [-1] * n_nodes
    low = [0] * n_nodes
    on_stack = [False] * n_nodes
    stack: list[int] = []
    sccs: list[list[int]] = []
    counter = [0]

    for root in range(n_nodes):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = counter[0]
                counter[0] += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for i in range(pi, len(adj[v])):
                w = adj[v][i]
                if index[w] == -1:
                    work[-1] = (v, i + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    scc.append(w)
                    if w == v:
                        break
                if len(scc) > 1 or v in self_loop:
                    sccs.append(scc)
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[v])
    return sccs


# copied from jepsen_tpu/ops/scc.py:352-415
def find_cycle_in_scc(scc: list[int], edges: list[tuple[int, int, str]],
                      prefer_fewest: str | None = None):
    """Finds one cycle within an SCC as [(src, dst, type), ...].
    With prefer_fewest='rw', tries to find a cycle using as few edges of
    that type as possible (distinguishes G-single from G2, mirroring
    Elle's typed cycle searches)."""
    in_scc = set(scc)
    adj: dict[int, list[tuple[int, str]]] = {v: [] for v in scc}
    for s, d, t in edges:
        if s in in_scc and d in in_scc:
            adj[s].append((d, t))

    def bfs_cycle(allowed):
        """Shortest cycle back to each start node in turn, using only
        allowed edge types (all types when None)."""
        for start in scc:
            prev: dict = {}
            frontier = [start]
            seen = {start}
            found = None
            while frontier and found is None:
                nxt = []
                for u in frontier:
                    for (w, t) in adj[u]:
                        if allowed is not None and t not in allowed:
                            continue
                        if w == start:
                            prev[("end",)] = (u, t)
                            found = True
                            break
                        if w not in seen:
                            seen.add(w)
                            prev[w] = (u, t)
                            nxt.append(w)
                    if found:
                        break
                frontier = nxt
            if found:
                cycle = []
                node, t = prev[("end",)]
                cycle.append((node, start, t))
                while node != start:
                    pnode, pt = prev[node]
                    cycle.append((pnode, node, pt))
                    node = pnode
                cycle.reverse()
                return cycle
        return None

    if prefer_fewest is not None:
        others = {t for _, _, t in edges if t != prefer_fewest}
        c = bfs_cycle(others)  # zero rw edges
        if c is not None:
            return c
        # allow exactly one rw: BFS where the rw edge is taken first
        for s, d, t in edges:
            if t != prefer_fewest or s not in in_scc or d not in in_scc:
                continue
            path = _bfs_path(adj, d, s, others)
            if path is not None:
                return [(s, d, t)] + path
    return bfs_cycle(None)


# copied from jepsen_tpu/ops/scc.py:418-443
def _bfs_path(adj, start, goal, allowed):
    """Shortest path start->goal using allowed edge types, as
    [(src, dst, type), ...]; None if unreachable."""
    if start == goal:
        return []
    prev: dict[int, tuple[int, str]] = {}
    frontier = [start]
    seen = {start}
    while frontier:
        nxt = []
        for u in frontier:
            for (w, t) in adj.get(u, []):
                if t not in allowed or w in seen:
                    continue
                seen.add(w)
                prev[w] = (u, t)
                if w == goal:
                    path = []
                    node = w
                    while node != start:
                        p, pt = prev[node]
                        path.append((p, node, pt))
                        node = p
                    path.reverse()
                    return path
                nxt.append(w)
        frontier = nxt
    return None
