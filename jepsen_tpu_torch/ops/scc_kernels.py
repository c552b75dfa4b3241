"""The Elle cycle check's two device programs: wrappers around the
hand-written Hopper kernels in ``csrc/``, and their plain torch versions.

* :func:`scc_trim` — 2-core peeling of one graph (jepsen_tpu/ops/scc.py
  ``_trim_kernel``): repeatedly drop every node without an active in-edge
  or an active out-edge, until nothing changes or ``max_iters`` steps ran.
  Every cycle lies inside what remains; a residue capped by ``max_iters``
  may also hold acyclic chains.
* :func:`cluster_screen` — per cluster, whether its edges close a directed
  cycle (jepsen_tpu/ops/scc.py ``_screen_kernel``). Exact.
* :func:`trim_partial_degrees` and :func:`trim_update` — one round of the
  edge-sharded trim (jepsen_tpu/ops/scc.py ``run_sharded_trim``): a
  shard's partial in/out degrees over its edges, added into a row pair
  kept across rounds, and the mask's update from the summed degrees,
  which zeroes the pair (``csrc/trim_degrees.cu``). Integer sums and
  booleans: exact.

All match the reference bit for bit: their results are booleans and
integers (and the trim's step count). A wrapper takes its plain version only for tensors
that lie on the CPU; for CUDA tensors it makes one C call, which enqueues
its kernel's launches, or raises. Each wrapper counts those C calls in
``.launches`` and keeps the kernel's own count of its work in ``.work``.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from jepsen_tpu_torch.ops.matrix_kernels import _check_launch, _ptr, _stream

# The screen kernel keeps a cluster's adjacency bit-packed in shared
# memory: V rows of V / 32 words, 128 KB at V = 1024
# (jepsen_tpu/elle/__init__.py:205 MATRIX_CLUSTER_MAX).
SCREEN_MAX_V = 1024


def _edges_on(device, *cols, dtype=torch.int32):
    return [c if isinstance(c, torch.Tensor) and c.device == device
            and c.dtype == dtype and c.is_contiguous()
            else torch.as_tensor(c).to(device=device, dtype=dtype)
            .contiguous() for c in cols]


def _on(dev):
    """The device context for a C call on ``dev``: none when ``dev`` is
    already the current device (entering one costs a host round of
    device queries in every call)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


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
    one C call of ``csrc/scc_trim.cu`` builds the rows and peels level by
    level from a worklist, and ``scc_trim.work`` becomes its [2]
    int32 tensor on the card: the worklist items processed (the removed
    nodes) and the row entries walked (their valid in- plus
    out-degrees), as :func:`scc_trim_torch` counts them."""
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
    E = src.numel()
    active = torch.empty((n_nodes,), dtype=torch.uint8, device=dev)
    # the records [4n], the degree words [2n], control words [8], the
    # row entries [2E], the queue [n]
    scratch = torch.empty((7 * n_nodes + 2 * E + 8,), dtype=torch.int32,
                          device=dev)
    flags = torch.empty((8,), dtype=torch.int32, device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("scc_trim")
    with _on(dev):
        rc = lib.jt_scc_trim(_ptr(src), _ptr(dst), _ptr(valid),
                             _ptr(active), _ptr(scratch), _ptr(flags), E,
                             n_nodes, max_iters, _stream(dev))
    _check_launch(rc, "scc_trim")
    scc_trim.launches += 1
    scc_trim.work = flags[4:6]
    return active.view(torch.bool), flags[3]


scc_trim.launches = 0
scc_trim.work = None


def scc_trim_torch(src, dst, valid, n_nodes: int, max_iters: int = 512,
                   work: dict | None = None):
    """Plain torch version of :func:`scc_trim`: the loop of
    jepsen_tpu/ops/scc.py:48-66 (``_trim_cpu``'s peel, with the
    reference kernel's step count) over tensors on ``src``'s device.

    With a ``work`` dict, fills in what the kernel's worklist processes
    for the same result: ``items``, the removed nodes, and ``walked``,
    their valid in- plus out-degrees (a self-loop counts in both)."""
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
    if work is not None:
        degree = (torch.bincount(s[ok], minlength=n_nodes)
                  + torch.bincount(d[ok], minlength=n_nodes))
        work["items"] = int((~active).sum())
        work["walked"] = int(degree[~active].sum())
    return active, torch.tensor(steps, dtype=torch.int32, device=dev)


# ---------------------------------------------------------------------------
# cluster screen
# ---------------------------------------------------------------------------

def _screen_launch(cid, src_l, dst_l, valid, n_clusters: int,
                   n_local: int):
    """One C call of ``csrc/cluster_screen.cu`` on int32 CUDA columns in
    any order (``valid`` a bool column or None for all valid): uint8
    [n_clusters] on the card. Sets ``cluster_screen.work``."""
    if not 1 <= n_local <= SCREEN_MAX_V or n_clusters < 1:
        raise ValueError(f"cluster_screen: V={n_local} outside the kernel "
                         f"(1 <= V <= {SCREEN_MAX_V}), B={n_clusters}")
    dev = cid.device
    E = cid.numel()
    out = torch.empty((n_clusters,), dtype=torch.uint8, device=dev)
    # the work [2], the offsets [B + 1], the cursors [B], the sorted
    # edges [E]
    scratch = torch.empty((2 * n_clusters + E + 3,), dtype=torch.int32,
                          device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("cluster_screen")
    with _on(dev):
        rc = lib.jt_cluster_screen(
            _ptr(cid), _ptr(src_l), _ptr(dst_l),
            None if valid is None else _ptr(valid), _ptr(out),
            _ptr(scratch), E, n_clusters, n_local, _stream(dev))
    _check_launch(rc, "cluster_screen")
    cluster_screen.launches += 1
    cluster_screen.work = scratch[:2]
    return out


def cluster_screen(cid, src_l, dst_l, valid, n_clusters: int,
                   n_local: int):
    """Whether each of ``n_clusters`` clusters holds a directed cycle.

    cid, src_l, dst_l [E] int, valid [E] bool -> bool [n_clusters]: edge
    e joins cluster ``cid[e]`` as ``src_l[e] -> dst_l[e]``, in the
    cluster's local node ids ``[0, n_local)``, when ``valid[e]``
    (jepsen_tpu/ops/scc.py ``_screen_kernel``). Ids must lie in range. On
    the card one C call of ``csrc/cluster_screen.cu`` sorts the edges by
    cluster and settles every cluster, one CTA each; the edges need not
    be sorted. ``cluster_screen.work`` becomes its [2] int32 tensor on the
    card: the nodes its peel removed over all clusters and the distinct
    edges their rows held, as :func:`cluster_screen_torch` counts them."""
    if cid.device.type == "cpu":
        return cluster_screen_torch(cid, src_l, dst_l, valid, n_clusters,
                                    n_local)
    if cid.device.type != "cuda":
        raise ValueError(f"cluster_screen: unsupported device {cid.device}")
    dev = cid.device
    cid, src_l, dst_l = _edges_on(dev, cid, src_l, dst_l)
    valid = _edges_on(dev, valid, dtype=torch.bool)[0]
    _check_edges(src_l, dst_l, valid, "cluster_screen")
    if cid.shape != src_l.shape:
        raise ValueError("cluster_screen: cid and the edges differ in "
                         "length")
    return _screen_launch(cid, src_l, dst_l, valid, n_clusters,
                          n_local).view(torch.bool)


cluster_screen.launches = 0
cluster_screen.work = None


def cluster_screen_host(cid, src_l, dst_l, n_clusters: int, n_local: int,
                        device) -> np.ndarray:
    """:func:`cluster_screen` on host int arrays whose every edge is valid,
    run on ``device``: bool numpy [n_clusters]. On the card the columns go
    up in one pinned buffer, one C call settles every cluster, and the
    flags come back in one read."""
    dev = torch.device(device)
    E = len(cid)
    if dev.type == "cpu":
        cols = [torch.from_numpy(np.asarray(x, np.int32))
                for x in (cid, src_l, dst_l)]
        return cluster_screen_torch(*cols, torch.ones(E, dtype=torch.bool),
                                    n_clusters, n_local).numpy()
    if dev.type != "cuda":
        raise ValueError(f"cluster_screen: unsupported device {dev}")
    on = pinned_upload((cid, src_l, dst_l), dev)
    out = _screen_launch(on[0], on[1], on[2], None, n_clusters, n_local)
    return out.cpu().numpy().astype(bool)


def pinned_upload(cols, dev) -> torch.Tensor:
    """Host int columns of one length packed into one pinned int32
    buffer and copied to ``dev`` in one transfer: int32 [len(cols), E]
    on ``dev`` (the copy is enqueued, not waited for)."""
    host = torch.empty((len(cols), len(cols[0])), dtype=torch.int32,
                       pin_memory=True)
    for row, x in zip(host.numpy(), cols):
        row[:] = x
    return host.to(dev, non_blocking=True)


def cluster_screen_torch(cid, src_l, dst_l, valid, n_clusters: int,
                         n_local: int, work: dict | None = None):
    """Plain torch version of :func:`cluster_screen`: what
    jepsen_tpu/ops/scc.py:220-236 computes, over tensors on ``cid``'s
    device. The edges scatter into a [B, V, V] float32 adjacency, which is
    squared ceil(log2 V) times (R := R or R.R > 0, exact: entries are 0/1
    and sums at most V); a cluster has a cycle iff its closure has a
    nonzero diagonal.

    With a ``work`` dict, fills in what the kernel's Kahn peel removes for
    the same result, read off the closure: ``removed``, the nodes no cycle
    reaches (a node stays iff it lies on a cycle or a node on one reaches
    it), and ``walked``, the distinct edges leaving them."""
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
    on_cycle = torch.diagonal(r, dim1=1, dim2=2) > 0
    if work is not None:
        kept = on_cycle | ((on_cycle.float()[:, :, None] * r).sum(1) > 0)
        work["removed"] = int((~kept).sum())
        work["walked"] = int(((adj > 0) & ~kept[:, :, None]).sum())
    return on_cycle.any(dim=1)


# ---------------------------------------------------------------------------
# the edge-sharded trim's round
# ---------------------------------------------------------------------------

def pack_mask(active):
    """The packed copy of a bool [n] mask that the round's kernels read:
    int32 [ceil(n / 32)], bit ``v & 31`` of word ``v >> 5`` set when
    ``active[v]`` (the bits past n are 0)."""
    n = active.numel()
    words = (n + 31) // 32
    a = torch.zeros((words * 32,), dtype=torch.int64, device=active.device)
    a[:n] = active
    shifts = torch.arange(32, dtype=torch.int64, device=active.device)
    packed = (a.view(words, 32) << shifts).sum(1)
    return torch.where(packed >= 1 << 31, packed - (1 << 32),
                       packed).to(torch.int32)


def _want(what, x, dtype, shape, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != shape \
            or not x.is_contiguous():
        raise ValueError(f"{what}: want contiguous {dtype} {list(shape)} "
                         f"on {dev}, got {x.dtype} {list(x.shape)} on "
                         f"{x.device}")


def trim_partial_degrees(src, dst, w, active, bits, deg):
    """One shard's partial degrees for a round of the sharded trim, added
    into ``deg``.

    src, dst [E] int32 (ids in ``[0, n)``), w [E] int32 (0 for a padding
    edge), active bool [n] and ``bits`` its :func:`pack_mask`, deg int32
    [2, n]: adds w over the edges entering each node whose two ends are
    active to row 0, over those leaving it to row 1
    (jepsen_tpu/ops/scc.py:164-167), and returns ``deg``. Nothing is
    zeroed: the shards of one device add into one row pair, which
    :func:`trim_update` zeroes. On the card one C call of
    ``csrc/trim_degrees.cu``'s ``jt_trim_partial_degrees`` (one launch, no
    memset), which reads the mask's packed copy ``bits``; every input on
    one card, as the caller placed it."""
    return partial_degrees_launcher(src, dst, w, active, bits, deg)()


def partial_degrees_launcher(src, dst, w, active, bits, deg):
    """:func:`trim_partial_degrees` on these tensors, checked once: a
    no-argument function that makes the call each time it is called (a
    round loop over tensors that keep their storage)."""
    if src.device.type == "cpu":
        return lambda: trim_partial_degrees_torch(src, dst, w, active, bits,
                                                  deg)
    if src.device.type != "cuda":
        raise ValueError(f"trim_partial_degrees: unsupported device "
                         f"{src.device}")
    dev = src.device
    E, n = src.numel(), active.numel()
    if n < 1:
        raise ValueError("trim_partial_degrees: no nodes")
    for x, dt, shape in ((src, torch.int32, (E,)), (dst, torch.int32, (E,)),
                         (w, torch.int32, (E,)), (active, torch.bool, (n,)),
                         (bits, torch.int32, ((n + 31) // 32,)),
                         (deg, torch.int32, (2, n))):
        _want("trim_partial_degrees", x, dt, shape, dev)
    from jepsen_tpu_torch.ops import _build
    fn = _build.library("trim_degrees").jt_trim_partial_degrees
    args = (_ptr(src), _ptr(dst), _ptr(w), _ptr(bits), E, n, _ptr(deg),
            _stream(dev))

    def launch():
        with _on(dev):
            rc = fn(*args)
        _check_launch(rc, "trim_partial_degrees")
        trim_partial_degrees.launches += 1
        return deg
    return launch


trim_partial_degrees.launches = 0


def trim_partial_degrees_torch(src, dst, w, active, bits, deg):
    """Plain torch version of :func:`trim_partial_degrees`: the masked
    weights, then ``index_add_`` into each row (``bits`` is not read)."""
    s, d = src.long(), dst.long()
    ew = w.to(torch.int32) * (active[s] & active[d]).to(torch.int32)
    deg[0].index_add_(0, d, ew)
    deg[1].index_add_(0, s, ew)
    return deg


def trim_update(deg, others, active, bits, flags, slot: int):
    """The sharded trim's mask update, in place: ``active &= (in > 0) &
    (out > 0)`` (jepsen_tpu/ops/scc.py:176-177), the degrees being
    ``deg`` (int32 [2, n]) plus, when ``others`` (int32 [k, 2, n] or
    None) is given, each of its row pairs (the other devices' partials,
    copied here). Also rewrites ``bits`` (:func:`pack_mask`), zeroes
    ``deg`` for the next round (an inactive node's rows must be 0, as the
    degree pass leaves them; ``others`` is left as it is), sets ``flags[
    slot]`` (int32 [2], that slot 0 on entry) to 1 when some node left and
    clears ``flags[1 - slot]`` for the next round. Returns ``flags[slot:
    slot + 1]``. On the card one C call of ``jt_trim_update`` (one launch,
    no memset)."""
    return update_launcher(deg, others, active, bits, flags)(slot)


def update_launcher(deg, others, active, bits, flags):
    """:func:`trim_update` on these tensors, checked once: a function of
    the slot that makes the call each time it is called."""
    if active.device.type == "cpu":
        return lambda slot: trim_update_torch(deg, others, active, bits,
                                              flags, slot)
    if active.device.type != "cuda":
        raise ValueError(f"trim_update: unsupported device {active.device}")
    dev = active.device
    n = active.numel()
    k = 0 if others is None else others.shape[0]
    for x, dt, shape in ((deg, torch.int32, (2, n)),
                         (active, torch.bool, (n,)),
                         (bits, torch.int32, ((n + 31) // 32,)),
                         (flags, torch.int32, (2,))) + (
            () if others is None else ((others, torch.int32, (k, 2, n)),)):
        _want("trim_update", x, dt, shape, dev)
    if n < 1:
        raise ValueError("trim_update: no nodes")
    from jepsen_tpu_torch.ops import _build
    fn = _build.library("trim_degrees").jt_trim_update
    head = (_ptr(deg), None if k == 0 else _ptr(others), k, _ptr(active),
            _ptr(bits), n, _ptr(flags))
    stream = _stream(dev)
    views = (flags[0:1], flags[1:2])

    def launch(slot: int):
        if slot not in (0, 1):
            raise ValueError(f"trim_update: slot={slot}")
        with _on(dev):
            rc = fn(*head, slot, stream)
        _check_launch(rc, "trim_update")
        trim_update.launches += 1
        return views[slot]
    return launch


trim_update.launches = 0


def trim_update_torch(deg, others, active, bits, flags, slot: int):
    """Plain torch version of :func:`trim_update`."""
    total = deg if others is None else deg + others.sum(0)
    new = active & (total[0] > 0) & (total[1] > 0)
    flags[slot] = int((new != active).any())
    flags[1 - slot] = 0
    active.copy_(new)
    bits.copy_(pack_mask(new))
    deg.zero_()
    return flags[slot:slot + 1]
