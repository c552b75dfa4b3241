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


def _one_card(mesh) -> bool:
    """Whether every device of ``mesh`` is one card (or all the CPU)."""
    def card(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    first = card(mesh.devices[0])
    return all(card(d) == first for d in mesh.devices[1:])


# copied from jepsen_tpu/ops/scc.py:114-143
def trim_to_cycles_sharded(n_nodes: int, src: np.ndarray, dst: np.ndarray,
                           mesh, max_iters: int = 512) -> np.ndarray:
    """Edge-sharded trim: the reference's capped 2-core peeling in
    synchronous rounds (the same loose-superset residue; the exact host
    pass is authoritative), with the edge list split over the mesh's
    devices (``parallel.Mesh``) in contiguous blocks, padded with weight-0
    edges to a device multiple (:func:`run_sharded_trim`).

    When every device of the mesh is one card (or the CPU), the sum of the
    shards' partial degrees is the degree over all the edges, so the
    rounds are exactly :func:`scc_kernels.scc_trim`'s peel of the whole
    edge list, with the same mask and step count at every cap
    (tests/test_torch_trim_degrees.py holds the two equal): the edges go
    up unsharded and :func:`trim_to_cycles` peels them in one call (its
    padding nodes have no edges and change no real node's mask at any
    cap). Returns the bool [n_nodes] mask, the reference's bit for
    bit."""
    if len(src) == 0 or n_nodes == 0:
        return np.zeros(n_nodes, dtype=bool)
    if _one_card(mesh):
        return trim_to_cycles(n_nodes, src, dst, max_iters,
                              device=mesh.devices[0])
    _check_ids("trim_to_cycles_sharded", n_nodes, src, dst)
    from jepsen_tpu_torch.parallel import shard_leading
    E = len(src)
    pad = (-E) % mesh.size
    z = np.zeros(pad, np.int32)
    shards = shard_leading(
        mesh, np.concatenate([np.asarray(src, np.int32), z]),
        np.concatenate([np.asarray(dst, np.int32), z]),
        np.concatenate([np.ones(E, np.int32), z]))
    return trim_rounds(mesh, n_nodes, *shards,
                       max_iters=max_iters).cpu().numpy()


# copied from jepsen_tpu/ops/scc.py:146-186
def run_sharded_trim(mesh, n_nodes: int, sj, dj, wj, max_iters: int = 512,
                     reduce=None) -> torch.Tensor:
    """The sharded trim over edges already placed: ``sj``, ``dj``, ``wj``
    hold one int32 shard a mesh device (weight 0 pads; weights are 0 or
    positive). Without ``reduce`` on a mesh of one card, the shards are
    joined on it and one :func:`scc_kernels.scc_trim` call peels them
    (``valid = w != 0``, the same mask at every cap: see
    :func:`trim_to_cycles_sharded`); otherwise :func:`trim_rounds` runs
    the reference's rounds. Returns the bool [n_nodes] mask on the first
    device."""
    first = mesh.devices[0]
    if n_nodes == 0:
        return torch.zeros((0,), dtype=torch.bool, device=first)
    if reduce is None and _one_card(mesh):
        src = torch.cat([s.to(first) for s in sj])
        dst = torch.cat([d.to(first) for d in dj])
        valid = torch.cat([w.to(first) for w in wj]) != 0
        mask, _ = scc_kernels.scc_trim(src, dst, valid, n_nodes, max_iters)
        return mask
    return trim_rounds(mesh, n_nodes, sj, dj, wj, max_iters, reduce)


def trim_rounds(mesh, n_nodes: int, sj, dj, wj, max_iters: int = 512,
                reduce=None) -> torch.Tensor:
    """The reference's synchronous rounds of the sharded trim
    (jepsen_tpu/ops/scc.py:160-184) over placed shards, as
    :func:`run_sharded_trim` takes them. From every node active, while the
    last round changed something and fewer than ``max_iters`` ran: each
    shard adds its partial degrees into its device's row pair
    (``scc_kernels.trim_partial_degrees``; the shards on the first device
    into the sum itself, reading its mask), the other devices' pairs are
    copied to the first, ``reduce`` (when given: the multi-process sum,
    ``parallel.distributed``) sums the first device's pair in place across
    processes, and ``scc_kernels.trim_update`` applies ``active &= (in >
    0) & (out > 0)``, zeroes the sum for the next round and sets the
    round's flag, the one value read back a round. Only devices other
    than the first hold copies of the mask. Returns the bool [n_nodes]
    mask on the first device."""
    first = mesh.devices[0]
    others = list(dict.fromkeys(d for d in mesh.devices if d != first))
    active = torch.ones((n_nodes,), dtype=torch.bool, device=first)
    bits = scc_kernels.pack_mask(active)
    rows = {first: torch.zeros((2, n_nodes), dtype=torch.int32,
                               device=first)}
    masks = {first: (active, bits)}
    for d in others:
        rows[d] = torch.zeros((2, n_nodes), dtype=torch.int32, device=d)
        masks[d] = (active.to(d), bits.to(d))
    staged = (torch.empty((len(others), 2, n_nodes), dtype=torch.int32,
                          device=first) if others else None)
    flags = torch.zeros((2,), dtype=torch.int32, device=first)
    # the round's calls, checked once: every tensor keeps its storage
    partials = [scc_kernels.partial_degrees_launcher(s, d, w, *masks[dev],
                                                     rows[dev])
                for s, d, w, dev in zip(sj, dj, wj, mesh.devices)]
    update = scc_kernels.update_launcher(
        rows[first], staged if reduce is None else None, active, bits, flags)
    it, changed = 0, True
    while changed and it < max_iters:
        for partial in partials:
            partial()
        for j, dev in enumerate(others):
            staged[j].copy_(rows[dev])
            rows[dev].zero_()
        if reduce is not None:
            # the reduce sums one tensor across processes, so the other
            # devices' rows join the first's before it; without one the
            # update adds them itself, saving a sum and an add a round
            if staged is not None:
                rows[first] += staged.sum(0)
            reduce(rows[first])
        changed = bool(update(it % 2).item())
        for dev in others:
            masks[dev][0].copy_(active)
            masks[dev][1].copy_(bits)
        it += 1
    return active


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
    cycle nodes into small clusters, and one kernel call per chunk
    settles every cluster's has-a-cycle question. Transfers are edge
    lists, not matrices: on the card one upload, one C call and one
    read-back. Runs on ``device`` (the CUDA device by default)."""
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
    # the reference pads the edges and clusters to buckets for its
    # compiled shapes; the kernel takes any count, so nothing is padded
    return scc_kernels.cluster_screen_host(cid, src_l, dst_l, n_clusters,
                                           vb, resolve_device(device))


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
