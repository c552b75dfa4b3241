"""The Elle cycle check's two device programs: wrappers around the
hand-written Hopper kernels in ``csrc/``, and their plain torch versions.

* :func:`scc_trim` — 2-core peeling of one graph (jepsen_tpu/ops/scc.py
  ``_trim_kernel``): repeatedly drop every node without an active in-edge
  or an active out-edge, until nothing changes or ``max_iters`` steps ran.
  Every cycle lies inside what remains; a residue capped by ``max_iters``
  may also hold acyclic chains.
* :func:`cluster_screen` — per cluster, whether its edges close a directed
  cycle (jepsen_tpu/ops/scc.py ``_screen_kernel``). Exact.

Both match the reference bit for bit: their results are booleans (and the
trim's step count). A wrapper takes its plain version only for tensors
that lie on the CPU; for CUDA tensors it launches its kernel once, or
raises. Each wrapper counts its kernel launches in ``.launches``.
"""
from __future__ import annotations

import numpy as np
import torch

from jepsen_tpu_torch.ops.matrix_kernels import _check_launch, _ptr, _stream

# The screen kernel keeps a cluster's adjacency bit-packed in shared
# memory: V rows of V / 32 words, 128 KB at V = 1024
# (jepsen_tpu/elle/__init__.py:205 MATRIX_CLUSTER_MAX).
SCREEN_MAX_V = 1024


def _edges_on(device, *cols, dtype=torch.int32):
    return [torch.as_tensor(c).to(device=device, dtype=dtype).contiguous()
            for c in cols]


def _check_edges(src, dst, valid, what: str) -> None:
    if not (src.ndim == dst.ndim == valid.ndim == 1
            and src.shape == dst.shape == valid.shape):
        raise ValueError(f"{what}: edge columns must be [E] of one length, "
                         f"got {tuple(src.shape)}, {tuple(dst.shape)}, "
                         f"{tuple(valid.shape)}")


# ---------------------------------------------------------------------------
# trim
# ---------------------------------------------------------------------------

def scc_trim(src, dst, valid, n_nodes: int, max_iters: int = 512):
    """2-core peel of the graph on ``n_nodes`` nodes with edges
    ``src[e] -> dst[e]`` where ``valid[e]``.

    src, dst [E] int, valid [E] bool -> (active bool [n_nodes], steps
    int32 0-d): the nodes left after the loop of jepsen_tpu/ops/scc.py
    ``_trim_kernel`` (while something changed and fewer than
    ``max_iters`` steps ran: keep a node when an active edge enters it and
    one leaves it; an edge is active when valid and both ends are), and
    the steps it ran. Node ids must lie in ``[0, n_nodes)``. On the card
    one cooperative launch of ``csrc/scc_trim.cu`` runs every step."""
    if src.device.type == "cpu":
        return scc_trim_torch(src, dst, valid, n_nodes, max_iters)
    if src.device.type != "cuda":
        raise ValueError(f"scc_trim: unsupported device {src.device}")
    dev = src.device
    src, dst = _edges_on(dev, src, dst)
    valid = _edges_on(dev, valid, dtype=torch.bool)[0]
    _check_edges(src, dst, valid, "scc_trim")
    if n_nodes < 1 or max_iters < 0:
        raise ValueError(f"scc_trim: n_nodes={n_nodes}, "
                         f"max_iters={max_iters}")
    active = torch.empty((n_nodes,), dtype=torch.uint8, device=dev)
    stamps = torch.zeros((2 * n_nodes,), dtype=torch.int32, device=dev)
    flags = torch.zeros((8,), dtype=torch.int32, device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("scc_trim")
    with torch.cuda.device(dev):
        rc = lib.jt_scc_trim(_ptr(src), _ptr(dst), _ptr(valid),
                             _ptr(active), _ptr(stamps), _ptr(flags),
                             src.numel(), n_nodes, max_iters, _stream(dev))
    _check_launch(rc, "scc_trim")
    scc_trim.launches += 1
    return active.view(torch.bool), flags[3]


scc_trim.launches = 0


def scc_trim_torch(src, dst, valid, n_nodes: int, max_iters: int = 512):
    """Plain torch version of :func:`scc_trim`: the loop of
    jepsen_tpu/ops/scc.py:48-66 (``_trim_cpu``'s peel, with the
    reference kernel's step count) over tensors on ``src``'s device."""
    dev = src.device
    s = torch.as_tensor(src, device=dev).long()
    d = torch.as_tensor(dst, device=dev).long()
    ok = torch.as_tensor(valid, device=dev).bool()
    active = torch.ones((n_nodes,), dtype=torch.bool, device=dev)
    steps, changed = 0, True
    while changed and steps < max_iters:
        ea = ok & active[s] & active[d]
        has_in = torch.zeros_like(active)
        has_in[d[ea]] = True
        has_out = torch.zeros_like(active)
        has_out[s[ea]] = True
        new = active & has_in & has_out
        changed = bool((new != active).any())
        active = new
        steps += 1
    return active, torch.tensor(steps, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# cluster screen
# ---------------------------------------------------------------------------

def cluster_screen(cid, src_l, dst_l, valid, n_clusters: int,
                   n_local: int):
    """Whether each of ``n_clusters`` clusters holds a directed cycle.

    cid, src_l, dst_l [E] int, valid [E] bool -> bool [n_clusters]: edge
    e joins cluster ``cid[e]`` as ``src_l[e] -> dst_l[e]``, in the
    cluster's local node ids ``[0, n_local)``, when ``valid[e]``
    (jepsen_tpu/ops/scc.py ``_screen_kernel``). Ids must lie in range. On
    the card one launch of ``csrc/cluster_screen.cu`` settles every
    cluster, one CTA each; the edges need not be sorted by cluster."""
    if cid.device.type == "cpu":
        return cluster_screen_torch(cid, src_l, dst_l, valid, n_clusters,
                                    n_local)
    if cid.device.type != "cuda":
        raise ValueError(f"cluster_screen: unsupported device {cid.device}")
    if not 1 <= n_local <= SCREEN_MAX_V or n_clusters < 1:
        raise ValueError(f"cluster_screen: V={n_local} outside the kernel "
                         f"(1 <= V <= {SCREEN_MAX_V}), B={n_clusters}")
    dev = cid.device
    cid, src_l, dst_l = _edges_on(dev, cid, src_l, dst_l)
    valid = _edges_on(dev, valid, dtype=torch.bool)[0]
    _check_edges(src_l, dst_l, valid, "cluster_screen")
    if cid.shape != src_l.shape:
        raise ValueError("cluster_screen: cid and the edges differ in "
                         "length")
    # each CTA reads its cluster's edge range [offs[b], offs[b + 1])
    cid_s, order = torch.sort(cid, stable=True)
    src_s, dst_s = src_l[order].contiguous(), dst_l[order].contiguous()
    valid_s = valid[order].contiguous()
    offs = torch.searchsorted(
        cid_s, torch.arange(n_clusters + 1, dtype=torch.int32, device=dev)
    ).to(torch.int32)
    out = torch.empty((n_clusters,), dtype=torch.uint8, device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("cluster_screen")
    with torch.cuda.device(dev):
        rc = lib.jt_cluster_screen(_ptr(src_s), _ptr(dst_s), _ptr(valid_s),
                                   _ptr(offs), _ptr(out), n_clusters,
                                   n_local, _stream(dev))
    _check_launch(rc, "cluster_screen")
    cluster_screen.launches += 1
    return out.view(torch.bool)


cluster_screen.launches = 0


def cluster_screen_torch(cid, src_l, dst_l, valid, n_clusters: int,
                         n_local: int):
    """Plain torch version of :func:`cluster_screen`: what
    jepsen_tpu/ops/scc.py:220-236 computes, over tensors on ``cid``'s
    device. The edges scatter into a [B, V, V] float32 adjacency, which is
    squared ceil(log2 V) times (R := R or R.R > 0, exact: entries are 0/1
    and sums at most V); a cluster has a cycle iff its closure has a
    nonzero diagonal."""
    dev = cid.device
    B, V = n_clusters, n_local
    adj = torch.zeros((B, V, V), dtype=torch.float32, device=dev)
    idx = tuple(torch.as_tensor(x, device=dev).long()
                for x in (cid, src_l, dst_l))
    adj.index_put_(idx, torch.as_tensor(valid, device=dev).float(),
                   accumulate=True)
    r = (adj > 0).float()
    n_steps = max(1, int(np.ceil(np.log2(max(2, V)))))
    for _ in range(n_steps):
        r = torch.maximum(r, (torch.bmm(r, r) > 0).float())
    return (torch.diagonal(r, dim1=1, dim2=2) > 0).any(dim=1)
