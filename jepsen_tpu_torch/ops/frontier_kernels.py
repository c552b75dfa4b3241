"""The frontier scans of the ``jitlin-device`` rung: wrappers around the
hand-written Hopper kernels in ``csrc/``, and their plain torch versions.

A *configuration* is (mask, state): ``mask`` the bitset of pending-op
slots already linearized, ``state`` the interned model state. Both scans
walk one history's events in order: an invoke opens its slot's op, a
return first closes the frontier under "linearize any pending op not yet
linearized" and then keeps only the configurations that linearized the
returning op, clearing its bit. The verdict is whether any configuration
survives the last return.

* :func:`frontier_dense` — the exact frontier as a dense ``[2^S, V]``
  boolean table (jepsen_tpu/ops/jitlin.py ``_build_dense_step``). It
  covers the whole configuration space, so it cannot overflow; a
  transition leaving ``[0, V)`` sets ``inexact``.
* :func:`frontier_sparse` — a capacity-K list of (uint32 mask, int32
  state) pairs kept sorted and distinct (jepsen_tpu/ops/jitlin.py
  ``_build_step``). Past K distinct configurations the K smallest are
  kept and ``overflow`` is set.

Both return the reference's ``run.resume`` results, the verdict and the
final frontier, and match it bit for bit. A wrapper takes its plain
version only for tensors that lie on the CPU; for CUDA tensors it
launches its kernel once for the whole history, or raises. Each wrapper
counts its kernel launches in ``.launches``. The kernels carry copies of
two transitions, the CAS register's and the multi-register map's, and
take the one a ``step_ids``'s ``kernel_model`` names (models.
kernel_model): on CUDA a wrapper raises for a ``step_ids`` without one.

:func:`frontier_dense_batch` and :func:`frontier_sparse_batch` scan B
keys' histories in one launch of the same kernels (one CTA a key), each
from the initial frontier, as the reference's vmapped scans do
(jitlin.py:2012, :2023): the events of all keys arrive in one upload
(:func:`batch_events`), and each key's (alive, died, overflow, peak)
comes back in a row of its own.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import numpy as np
import torch

from jepsen_tpu_torch.models import _cas_step_ids, kernel_model
from jepsen_tpu_torch.ops.matrix_kernels import _check_launch, _ptr, _stream

EV_INVOKE, EV_RETURN, EV_NOOP = 0, 1, 2
# copied from jepsen_tpu/ops/jitlin.py:110-111
SENTINEL_MASK = 0xFFFFFFFF
SENTINEL_STATE = 0x7FFFFFFF

# The dense kernel's tables: [2^S, V] bits, S <= 12 and V <= 512
# (jitlin.DENSE_MAX_SLOTS).
DENSE_MAX_SLOTS = 12
DENSE_MAX_V = 512
# Masks are uint32, as in the reference.
SPARSE_MAX_SLOTS = 32
# The sparse kernel sorts its candidates, the frontier and each entry's
# expansions, in shared memory: at most SPARSE_MAX_CANDIDATES pairs.
SPARSE_MAX_CANDIDATES = 1 << 14
# Where each kernel runs in one warp (kWarpList, kWarpCand and kWarpCost
# in csrc/, which alone decide it): a sparse closure pass whose sorted list
# holds at most 64 keys and which has at most 64 candidates; the whole
# dense scan when its rows are one word (V <= 32) and rows a lane (2^S /
# 32, at least 1) times nibbles a row (4 up to V = 16, else 8) is at most
# 16. The plain versions count their work at the same thresholds; each
# kernel reports the work it ran on its warp path and in all (``.paths``
# of its wrapper), and chip_smoke.py and the card tests hold the two
# counts equal.
SPARSE_WARP_LIST = 64
SPARSE_WARP_CANDIDATES = 64
DENSE_WARP_COST = 16


def dense_warp_path(S: int, V: int) -> bool:
    """Whether ``frontier_dense`` runs a [2^S, V] table on its warp path."""
    nibbles = 4 if V <= 16 else 8
    return V <= 32 and max(1, (1 << S) // 32) * nibbles <= DENSE_WARP_COST


def _host_events(kind, slot, f, a, b):
    """The event columns as host int64 numpy arrays."""
    return [np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                       dtype=np.int64) for x in (kind, slot, f, a, b)]


def _device_events(kind, slot, f, a, b, device):
    """The event columns as contiguous int32 tensors on ``device``."""
    return [torch.as_tensor(x).to(device=device, dtype=torch.int32)
            .contiguous() for x in (kind, slot, f, a, b)]


def _check_events(ev, S: int, what: str) -> None:
    kind, slot = ev[0], ev[1]
    if kind.numel() and bool((((kind < 0) | (kind > EV_NOOP)).any()
                              | ((kind != EV_NOOP)
                                 & ((slot < 0) | (slot >= S))).any()).item()):
        raise ValueError(f"{what}: an event kind or slot out of range "
                         f"(S={S})")


def _model_args(step_ids, what: str) -> tuple:
    """The kernels' (model, keys, values) for ``step_ids`` (None: the CAS
    register); raises for a transition they have no copy of. A shape the
    kernels do not take fails its launch (csrc/frontier_model.cuh)."""
    model = kernel_model(_cas_step_ids if step_ids is None else step_ids)
    if model is None:
        raise ValueError(f"{what}: the kernels have no copy of this "
                         "step_ids's transition (no kernel_model)")
    return model


_COUNT_LOCK = threading.Lock()


def _count_launch(fn) -> None:
    """One more launch on ``fn.launches``; checks on threads launch
    concurrently."""
    with _COUNT_LOCK:
        fn.launches += 1


# ---------------------------------------------------------------------------
# dense table
# ---------------------------------------------------------------------------

def init_table(S: int, V: int, init_state: int, device=None) -> torch.Tensor:
    """The dense scan's initial frontier: (mask 0, init_state) alone
    (jepsen_tpu/ops/jitlin.py:370-373)."""
    t = torch.zeros((1 << S, V), dtype=torch.bool, device=device)
    t[0, init_state] = True
    return t


def frontier_dense(kind, slot, f, a, b, table0, step_ids=None):
    """Dense-table frontier scan of one history from ``table0``.

    kind/slot/f/a/b [E] int (events), table0 [2^S, V] bool -> (alive,
    died, inexact, peak, table): 0-d tensors bool, int32, bool, int32 and
    the final [2^S, V] bool table, as jepsen_tpu/ops/jitlin.py
    ``_build_dense_step``'s ``run.resume`` returns them. ``died`` is the
    index of the return at which the frontier emptied (-1 when it
    survives), ``peak`` the largest closed table's population (at least
    1). On the card one launch of ``csrc/frontier_dense.cu`` runs the
    whole event loop, and ``frontier_dense.paths`` becomes its [2] int32
    tensor on the card: the returns it closed on the warp path, and in
    all."""
    if table0.device.type == "cpu":
        return frontier_dense_torch(kind, slot, f, a, b, table0, step_ids)
    if table0.device.type != "cuda":
        raise ValueError(f"frontier_dense: unsupported device "
                         f"{table0.device}")
    model = _model_args(step_ids, "frontier_dense")
    M, V = table0.shape
    S = M.bit_length() - 1
    if M != 1 << S or not 1 <= S <= DENSE_MAX_SLOTS \
            or not 1 <= V <= DENSE_MAX_V:
        raise ValueError(f"frontier_dense: table [{M}, {V}] outside the "
                         f"kernel ([2^S, V], 1 <= S <= {DENSE_MAX_SLOTS}, "
                         f"V <= {DENSE_MAX_V})")
    dev = table0.device
    ev = _device_events(kind, slot, f, a, b, dev)
    _check_events(ev, S, "frontier_dense")
    E = ev[0].numel()
    t_in = table0.to(torch.uint8).contiguous()
    t_out = torch.empty((M, V), dtype=torch.uint8, device=dev)
    out = torch.empty((6,), dtype=torch.int32, device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("frontier_dense")
    with torch.cuda.device(dev):
        rc = lib.jt_frontier_dense(*(_ptr(x) for x in ev), _ptr(t_in),
                                   _ptr(t_out), _ptr(out), E, S, V, *model,
                                   _stream(dev))
    _check_launch(rc, "frontier_dense")
    _count_launch(frontier_dense)
    frontier_dense.paths = out[4:]
    return (out[0] != 0, out[1], out[2] != 0, out[3], t_out.to(torch.bool))


frontier_dense.launches = 0
frontier_dense.paths = None


def frontier_dense_torch(kind, slot, f, a, b, table0, step_ids=None,
                         work: dict | None = None):
    """Plain torch version of :func:`frontier_dense`: the event loop of
    jepsen_tpu/ops/jitlin.py:287-347 in Python over tensors on
    ``table0``'s device. The closure is the reference's: S [M, V] x
    [V, V] products a pass, iterated to a fixpoint (at most S passes).
    The out-of-range flag of every invoke is computed up front: the
    reference ORs it in at each invoke, dead frontier or not. The loop
    stops at the return where the table empties: after it nothing
    changes. With a ``work`` dict it adds up there the ``returns`` it
    closed and ``warp_returns``, those the kernel closes on its warp path
    (all of them at a table shape :func:`dense_warp_path` takes)."""
    if step_ids is None:
        step_ids = _cas_step_ids
    dev = table0.device
    M, V = table0.shape
    S = M.bit_length() - 1
    kind, slot, f, a, b = _host_events(kind, slot, f, a, b)
    rows = torch.arange(M, device=dev)
    bits = 1 << torch.arange(S, device=dev)
    xor_idx = rows[None, :] ^ bits[:, None]             # [S, M]
    has_bit = (rows[None, :] & bits[:, None]) != 0      # [S, M]
    v_range = torch.arange(V, dtype=torch.int32, device=dev)
    inv = np.nonzero(kind == EV_INVOKE)[0]
    # per invoke: the slot's [V, V] transition and its out-of-range flag
    st2, ok = step_ids(v_range[None, :],
                       *(torch.as_tensor(x[inv, None], dtype=torch.int32,
                                         device=dev) for x in (f, a, b)))
    oob = (ok & ((st2 < 0) | (st2 >= V))).any(dim=1)
    inv_row = np.full(len(kind), -1)
    inv_row[inv] = np.arange(len(inv))
    mt = torch.zeros((S, V, V), dtype=torch.float32, device=dev)
    table = table0.to(torch.bool).clone()
    pend, died = 0, -1
    peak = torch.ones((), dtype=torch.int32, device=dev)
    for e in range(len(kind)):
        s = int(slot[e])
        if kind[e] == EV_INVOKE:
            i = inv_row[e]
            mt[s] = (ok[i, :, None]
                     & (st2[i, :, None] == v_range[None, :])).float()
            pend |= 1 << s
        elif kind[e] == EV_RETURN:
            tc = _dense_closure(table, pend, mt, xor_idx, has_bit, S)
            table = torch.where(~has_bit[s][:, None], tc[xor_idx[s]], False)
            peak = torch.maximum(peak, tc.sum(dtype=torch.int32))
            pend &= ~(1 << s)
            if work is not None:
                work["returns"] = work.get("returns", 0) + 1
                work["warp_returns"] = (work.get("warp_returns", 0)
                                        + dense_warp_path(S, V))
            if not bool(table.any()):
                # an empty table stays empty: nothing changes after this
                died = e
                break

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)
    return (scalar(died < 0, torch.bool), scalar(died, torch.int32),
            oob.any(), peak, table)


def _dense_closure(table, pend, mt, xor_idx, has_bit, S):
    """jepsen_tpu/ops/jitlin.py:287-306: OR into every row r with bit t of
    a pending slot t the image of row r ^ 2^t under t's transition,
    until nothing changes (at most S passes)."""
    pbits = torch.tensor([(pend >> t) & 1 for t in range(S)], dtype=torch.bool,
                         device=table.device)
    gate = (pbits[:, None] & has_bit)[:, :, None]       # [S, M, 1]
    for _ in range(S):
        donors = table[xor_idx].to(torch.float32)        # [S, M, V]
        contrib = torch.einsum("smv,svw->smw", donors, mt) > 0
        t2 = table | (contrib & gate).any(dim=0)
        changed = bool((t2 != table).any())
        table = t2
        if not changed:
            break
    return table


# ---------------------------------------------------------------------------
# sparse frontier
# ---------------------------------------------------------------------------

# A (uint32 mask, int32 state) pair as one int64 sort key, ordered as the
# reference's two-key lax.sort orders the pairs (mask unsigned, then
# state signed): (mask - 2^31) * 2^32 + (state + 2^31). The sentinel pair
# (0xFFFFFFFF, 0x7FFFFFFF) is the largest key, 2^63 - 1.
SENTINEL_KEY = (1 << 63) - 1


def _pack(mask, state):
    return ((mask.to(torch.int64) - (1 << 31)) << 32) \
        + (state.to(torch.int64) + (1 << 31))


def _unpack(keys):
    return (keys >> 32) + (1 << 31), (keys & 0xFFFFFFFF) - (1 << 31)


def init_frontier(K: int, init_state: int, device=None):
    """The sparse scan's initial frontier: (0, init_state) then K - 1
    sentinel pairs (jepsen_tpu/ops/jitlin.py:241-245), as (uint32 mask,
    int32 state) tensors."""
    mask = torch.full((K,), SENTINEL_MASK, dtype=torch.int64, device=device)
    state = torch.full((K,), SENTINEL_STATE, dtype=torch.int32, device=device)
    mask[0] = 0
    state[0] = init_state
    return mask.to(torch.uint32), state


def frontier_sparse(kind, slot, f, a, b, mask0, state0, n_slots: int,
                    step_ids=None):
    """Capacity-K sparse frontier scan of one history from ``(mask0,
    state0)`` with ``n_slots`` slots.

    kind/slot/f/a/b [E] int (events), mask0 [K] uint32, state0 [K] int32
    -> (alive, died, overflow, peak, mask, state): 0-d tensors bool,
    int32, bool, int32 and the final frontier, as jepsen_tpu/ops/jitlin.py
    ``_build_step``'s ``run.resume`` returns them. ``overflow`` is set
    when a closure pass found more than K distinct configurations;
    ``peak`` is the largest closed frontier kept (at least 1). On the
    card one launch of ``csrc/frontier_sparse.cu`` runs the whole event
    loop, and ``frontier_sparse.paths`` becomes its [2] int32 tensor on
    the card: the closure passes it ran on the warp path, and in all."""
    S, K = n_slots, mask0.shape[0]
    if not 1 <= S <= SPARSE_MAX_SLOTS:
        raise ValueError(f"frontier_sparse: S={S} outside 1 <= S <= "
                         f"{SPARSE_MAX_SLOTS} (masks are uint32)")
    if mask0.device.type == "cpu":
        return frontier_sparse_torch(kind, slot, f, a, b, mask0, state0,
                                     n_slots, step_ids)
    if mask0.device.type != "cuda":
        raise ValueError(f"frontier_sparse: unsupported device "
                         f"{mask0.device}")
    model = _model_args(step_ids, "frontier_sparse")
    if not 1 <= K or K * (S + 1) > SPARSE_MAX_CANDIDATES \
            or tuple(state0.shape) != (K,):
        raise ValueError(f"frontier_sparse: K={K} with S={S} outside the "
                         f"kernel (K * (S + 1) <= {SPARSE_MAX_CANDIDATES})")
    dev = mask0.device
    if state0.device != dev:
        raise ValueError("frontier_sparse: inputs on different devices")
    ev = _device_events(kind, slot, f, a, b, dev)
    _check_events(ev, S, "frontier_sparse")
    E = ev[0].numel()
    m_in = mask0.to(torch.uint32).contiguous()
    s_in = state0.to(torch.int32).contiguous()
    m_out = torch.empty((K,), dtype=torch.uint32, device=dev)
    s_out = torch.empty((K,), dtype=torch.int32, device=dev)
    out = torch.empty((6,), dtype=torch.int32, device=dev)
    from jepsen_tpu_torch.ops import _build
    lib = _build.library("frontier_sparse")
    with torch.cuda.device(dev):
        rc = lib.jt_frontier_sparse(*(_ptr(x) for x in ev), _ptr(m_in),
                                    _ptr(s_in), _ptr(m_out), _ptr(s_out),
                                    _ptr(out), E, S, K, *model,
                                    _stream(dev))
    _check_launch(rc, "frontier_sparse")
    _count_launch(frontier_sparse)
    frontier_sparse.paths = out[4:]
    return out[0] != 0, out[1], out[2] != 0, out[3], m_out, s_out


frontier_sparse.launches = 0
frontier_sparse.paths = None


def frontier_sparse_torch(kind, slot, f, a, b, mask0, state0, n_slots: int,
                          step_ids=None, work: dict | None = None):
    """Plain torch version of :func:`frontier_sparse`: the event loop of
    jepsen_tpu/ops/jitlin.py:126-218 in Python over tensors on
    ``mask0``'s device, with the pairs as int64 sort keys. With a
    ``work`` dict it adds up the closure's work there: ``returns``,
    ``passes``, ``candidates`` (the list's pairs and their expansions),
    ``compares`` (n log2 n for each pass's n candidates) and
    ``warp_passes``, the passes the kernel runs in one warp: those after
    the scan's first, from a list of at most SPARSE_WARP_LIST pairs, with
    at most SPARSE_WARP_CANDIDATES candidates."""
    if step_ids is None:
        step_ids = _cas_step_ids
    dev = mask0.device
    S, K = n_slots, mask0.shape[0]
    kind, slot, f, a, b = _host_events(kind, slot, f, a, b)
    slot_bits = 1 << torch.arange(S, dtype=torch.int64, device=dev)
    cur = torch.zeros((3, S), dtype=torch.int32, device=dev)
    keys = _pack(mask0, state0)
    pend = 0
    alive, died, overflow, peak = True, -1, False, 1
    returns = np.nonzero(kind == EV_RETURN)[0]
    first_return = int(returns[0]) if len(returns) else -1
    for e in range(len(kind)):
        s = int(slot[e])
        if kind[e] == EV_INVOKE:
            cur[:, s] = torch.tensor([f[e], a[e], b[e]], dtype=torch.int32)
            pend |= 1 << s
        elif kind[e] == EV_RETURN:
            if work is not None:
                work["returns"] = work.get("returns", 0) + 1
            keys, count, ovf = _sparse_closure(keys, pend, cur, slot_bits,
                                               K, S, step_ids, work,
                                               given=e == first_return)
            mask, state = _unpack(keys)
            has = (mask != SENTINEL_MASK) & ((mask & (1 << s)) != 0)
            k2 = torch.where(has, _pack(mask & ~(1 << s), state),
                             SENTINEL_KEY)
            keys, _ = _dedup_compact(k2, K)
            overflow = overflow or ovf
            peak = max(peak, count)
            pend &= ~(1 << s)
            if not bool((_unpack(keys)[0] != SENTINEL_MASK).any()):
                # an empty list stays empty: nothing changes after this
                alive, died = False, e
                break
    mask, state = _unpack(keys)

    def scalar(x, dtype):
        return torch.tensor(x, dtype=dtype, device=dev)
    return (scalar(alive, torch.bool), scalar(died, torch.int32),
            scalar(overflow, torch.bool), scalar(peak, torch.int32),
            mask.to(torch.uint32), state.to(torch.int32))


def _dedup_compact(keys, K: int):
    """jepsen_tpu/ops/jitlin.py:129-140: the K smallest distinct keys,
    padded with the sentinel, and whether a (K+1)-th distinct key with a
    valid mask existed."""
    u = torch.unique(keys, sorted=True)
    overflow = u.numel() > K and \
        int(_unpack(u[K])[0]) != SENTINEL_MASK
    kept = torch.full((K,), SENTINEL_KEY, dtype=torch.int64,
                      device=keys.device)
    n = min(K, u.numel())
    kept[:n] = u[:n]
    return kept, overflow


def _sparse_closure(keys, pend, cur, slot_bits, K, S, step_ids, work,
                    given=False):
    """jepsen_tpu/ops/jitlin.py:142-171: each pass expands every valid
    configuration by every pending slot it has not linearized, then
    keeps the K smallest distinct configurations; passes stop when the
    count of valid configurations does not grow, or after S. ``given``
    marks the scan's first closure, whose first pass starts from the list
    as given (the kernel's CTA path). Returns (keys, count, overflow)."""
    pbits = torch.tensor([(pend >> t) & 1 for t in range(S)], dtype=torch.bool,
                         device=keys.device)

    def count_valid(k):
        return int((_unpack(k)[0] != SENTINEL_MASK).sum())

    count, overflow = count_valid(keys), False
    for it in range(S):
        mask, state = _unpack(keys)
        valid = mask != SENTINEL_MASK
        can = (valid[:, None] & pbits[None, :]
               & ((mask[:, None] & slot_bits[None, :]) == 0))
        st2, ok = step_ids(state.to(torch.int32)[:, None], cur[0][None, :],
                           cur[1][None, :], cur[2][None, :])
        new = torch.where(can & ok, _pack(mask[:, None] | slot_bits[None, :],
                                          st2), SENTINEL_KEY)
        cand = torch.cat([keys, new.reshape(-1)])
        if work is not None:
            n = int((cand != SENTINEL_KEY).sum())
            work["passes"] = work.get("passes", 0) + 1
            work["candidates"] = work.get("candidates", 0) + n
            work["compares"] = work.get("compares", 0) + n * max(
                1, (n - 1).bit_length())
            length = int((keys != SENTINEL_KEY).sum())
            warp = (not given or it > 0) and length <= SPARSE_WARP_LIST \
                and n <= SPARSE_WARP_CANDIDATES
            work["warp_passes"] = work.get("warp_passes", 0) + warp
        keys, ovf = _dedup_compact(cand, K)
        c2 = count_valid(keys)
        overflow = overflow or ovf
        grew = c2 > count
        count = c2
        if not grew:
            break
    return keys, count, overflow


# ---------------------------------------------------------------------------
# key batches
# ---------------------------------------------------------------------------

class EventBatch(NamedTuple):
    """The events of B keys in one tensor: ``ev`` [5, N] int32 (kind,
    slot, f, a, b; key after key) and ``off`` [B + 1] int32 (key b's
    events are ``ev[:, off[b]:off[b + 1]]``), checked against ``S``
    slots on the host before the upload (:func:`batch_events`)."""
    ev: torch.Tensor
    off: torch.Tensor
    S: int


def batch_events(streams, S: int, device) -> EventBatch:
    """The event columns of ``streams`` (each with kind, slot, f, a, b)
    key after key, with their offsets, checked once against ``S`` slots
    on the host arrays and put on ``device`` in one copy (from pinned
    memory on the card)."""
    if not streams:
        raise ValueError("batch_events: no streams")
    lens = [len(s.kind) for s in streams]
    off = np.zeros(len(streams) + 1, np.int64)
    off[1:] = np.cumsum(lens)
    N = int(off[-1])
    if N >= 1 << 31:
        raise ValueError(f"batch_events: {N} events overflow int32 offsets")
    buf = np.empty(5 * N + len(off), np.int32)
    cols = buf[:5 * N].reshape(5, N)
    for j, name in enumerate(("kind", "slot", "f", "a", "b")):
        if N:
            cols[j] = np.concatenate([np.asarray(getattr(s, name))
                                      for s in streams])
    kind, slot = cols[0], cols[1]
    if (((kind < 0) | (kind > EV_NOOP)).any()
            or ((kind != EV_NOOP) & ((slot < 0) | (slot >= S))).any()):
        raise ValueError(f"batch_events: an event kind or slot out of "
                         f"range (S={S})")
    buf[5 * N:] = off
    t = torch.from_numpy(buf)
    dev = torch.device(device)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    else:
        t = t.to(dev)
    return EventBatch(t[:5 * N].view(5, N), t[5 * N:], S)


def _batch_launch(name: str, batch: EventBatch, cap: int, init_state: int,
                  step_ids):
    """Launches ``name``'s key-batched entry on ``batch`` (on the card);
    returns its [B, 6] int32 results there."""
    model = _model_args(step_ids, name)
    dev = batch.ev.device
    B = batch.off.numel() - 1
    out = torch.empty((B, 6), dtype=torch.int32, device=dev)
    from jepsen_tpu_torch.ops import _build
    entry = getattr(_build.library(name), f"jt_{name}_batch")
    ev = batch.ev
    with torch.cuda.device(dev):
        rc = entry(*(_ptr(ev[j]) for j in range(5)), _ptr(batch.off),
                   _ptr(out), B, batch.S, cap, init_state, *model,
                   _stream(dev))
    _check_launch(rc, f"{name}_batch")
    return out


def frontier_dense_batch(batch: EventBatch, V: int, init_state: int = 0,
                         step_ids=None):
    """Dense-table frontier scans of the B keys of ``batch``, each from
    (mask 0, ``init_state``) alone in a [2^S, V] table (S = batch.S).

    Returns (alive, died, inexact, peak), [B] tensors bool, int32, bool
    and int32 on the batch's device: each key's result of
    :func:`frontier_dense`, ``died`` an index in the key's own stream. On
    the card one launch of ``csrc/frontier_dense.cu``'s batched entry
    scans every key (one CTA a key), and ``frontier_dense_batch.paths``
    becomes its [B, 2] int32 tensor there: each key's returns closed on
    the warp path, and in all."""
    S = batch.S
    if batch.ev.device.type == "cpu":
        return frontier_dense_batch_torch(batch, V, init_state, step_ids)
    if batch.ev.device.type != "cuda":
        raise ValueError(f"frontier_dense_batch: unsupported device "
                         f"{batch.ev.device}")
    if not 1 <= S <= DENSE_MAX_SLOTS or not 1 <= V <= DENSE_MAX_V \
            or not 0 <= init_state < V:
        raise ValueError(f"frontier_dense_batch: S={S}, V={V}, init state "
                         f"{init_state} outside the kernel (1 <= S <= "
                         f"{DENSE_MAX_SLOTS}, V <= {DENSE_MAX_V})")
    out = _batch_launch("frontier_dense", batch, V, init_state, step_ids)
    _count_launch(frontier_dense_batch)
    frontier_dense_batch.paths = out[:, 4:]
    return out[:, 0] != 0, out[:, 1], out[:, 2] != 0, out[:, 3]


frontier_dense_batch.launches = 0
frontier_dense_batch.paths = None


def frontier_sparse_batch(batch: EventBatch, K: int, init_state: int = 0,
                          step_ids=None):
    """Capacity-K sparse frontier scans of the B keys of ``batch``, each
    from (0, ``init_state``) then K - 1 sentinel pairs, with S =
    batch.S slots.

    Returns (alive, died, overflow, peak), [B] tensors bool, int32, bool
    and int32 on the batch's device: each key's result of
    :func:`frontier_sparse`. On the card one launch of
    ``csrc/frontier_sparse.cu``'s batched entry scans every key (one CTA
    a key), and ``frontier_sparse_batch.paths`` becomes its [B, 2] int32
    tensor there: each key's closure passes on the warp path, and in
    all."""
    S = batch.S
    if not 1 <= S <= SPARSE_MAX_SLOTS:
        raise ValueError(f"frontier_sparse_batch: S={S} outside 1 <= S <= "
                         f"{SPARSE_MAX_SLOTS} (masks are uint32)")
    if batch.ev.device.type == "cpu":
        return frontier_sparse_batch_torch(batch, K, init_state, step_ids)
    if batch.ev.device.type != "cuda":
        raise ValueError(f"frontier_sparse_batch: unsupported device "
                         f"{batch.ev.device}")
    if not 1 <= K or K * (S + 1) > SPARSE_MAX_CANDIDATES:
        raise ValueError(f"frontier_sparse_batch: K={K} with S={S} outside "
                         f"the kernel (K * (S + 1) <= "
                         f"{SPARSE_MAX_CANDIDATES})")
    out = _batch_launch("frontier_sparse", batch, K, init_state, step_ids)
    _count_launch(frontier_sparse_batch)
    frontier_sparse_batch.paths = out[:, 4:]
    return out[:, 0] != 0, out[:, 1], out[:, 2] != 0, out[:, 3]


frontier_sparse_batch.launches = 0
frontier_sparse_batch.paths = None


def _stack_keys(results):
    """[(alive, died, flag, peak)] 0-d tensors -> four [B] tensors."""
    return tuple(torch.stack([r[i] for r in results]) for i in range(4))


def _key_events(batch: EventBatch, b: int, off: list):
    return batch.ev[:, off[b]:off[b + 1]]


def frontier_dense_batch_torch(batch: EventBatch, V: int,
                               init_state: int = 0, step_ids=None,
                               work: list | None = None):
    """Plain torch version of :func:`frontier_dense_batch`: the plain
    single scan, :func:`frontier_dense_torch`, key by key. With a
    ``work`` list it appends each key's work dict there."""
    off = batch.off.tolist()
    dev = batch.ev.device
    results = []
    for b in range(len(off) - 1):
        w = {}
        r = frontier_dense_torch(*_key_events(batch, b, off),
                                 init_table(batch.S, V, init_state, dev),
                                 step_ids, work=w)
        results.append(r[:4])
        if work is not None:
            work.append(w)
    return _stack_keys(results)


def frontier_sparse_batch_torch(batch: EventBatch, K: int,
                                init_state: int = 0, step_ids=None,
                                work: list | None = None):
    """Plain torch version of :func:`frontier_sparse_batch`: the plain
    single scan, :func:`frontier_sparse_torch`, key by key. With a
    ``work`` list it appends each key's work dict there."""
    off = batch.off.tolist()
    dev = batch.ev.device
    results = []
    for b in range(len(off) - 1):
        w = {}
        r = frontier_sparse_torch(*_key_events(batch, b, off),
                                  *init_frontier(K, init_state, dev),
                                  batch.S, step_ids, work=w)
        results.append(r[:4])
        if work is not None:
            work.append(w)
    return _stack_keys(results)
