"""Block-composed transfer-matrix linearizability check (the matrix
path of jepsen_tpu/ops/jitlin.py).

A *configuration* is (mask, state): ``mask`` is the bitset of pending-op
slots already linearized, ``state`` the interned model state. The whole
configuration space of one history is ``2^S masks x V states``, so the
frontier is a 0/1 vector of length MV = 2^S * V, and each return event is
a *linear* boolean operator on it: closure under "linearize any pending
op" is (I + L)^S with L = sum_t pend_t * (R_t (kron) M_t), reached in
ceil(log2 S) boolean squarings, and the kill of configurations that did
not linearize the returning op is a row gather + mask. Composing these
operators is associative, so the history's returns split into C chunks
of T returns whose products compute in parallel (one CUDA block per
chunk, ``matrix_kernels.chunk_product``) and then chain in time order
(``matrix_kernels.combine_product``). The verdict: is any configuration
reachable from the initial state alive at the end?

Routing is fixed: on a CUDA device both stages run their hand-written
kernels, on the CPU their plain torch versions. Above KERNEL_MAX_MV (the
kernels' shared-memory regime) both stages run the reference's XLA route
instead (``_scan_products``/``_scan_total``), as torch batched products:
bf16 with a > 0 threshold on the card, float32 on the CPU. Outside
``matrix_ok`` ``matrix_check`` returns None.

The frontier rung below it (:class:`JitLinKernel`) scans one history's
events with the dense-table or the sparse-frontier kernel
(``frontier_kernels``), chosen by ``_dense_ok``.

A stream longer than MATRIX_SEGMENT_EVENTS runs as a chain
(:func:`matrix_check_segmented`): segments cut at quiescent points
(:func:`quiescent_cuts`), each one ``matrix_check_resume`` dispatch from
the composed product of the ones before, with the carry offered to a
durable checkpoint (checker/checkpoint.py) after each.
:func:`segmented_check` is the frontier scan's own chain: one
``frontier_dense`` / ``frontier_sparse`` launch a segment, the frontier
carried between them.

:func:`matrix_localize` finds where an invalid matrix verdict died: the
chunk products again (stage 1 alone), the frontier chained through them
to the first dead chunk, and that chunk's returns rescanned on a frontier
vector (``forensics_kernels``: ``prefix_alive``, ``window_rescan``).
"""
from __future__ import annotations

import logging
import threading
import time
import types

import numpy as np
import torch

from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.models import cas_register_spec
from jepsen_tpu_torch.ops import frontier_kernels, matrix_kernels

EV_INVOKE, EV_RETURN, EV_NOOP = 0, 1, 2

logger = logging.getLogger("jepsen_tpu_torch.jitlin")

# Most recent dispatch routing of the calling thread.
_DISPATCH_INFO = threading.local()


def last_dispatch_info() -> dict:
    """{'products': 'cuda'|'torch'|'scan', 'combine': 'cuda'|'torch'|
    'scan'} of the calling thread's most recent matrix dispatch ('scan':
    the batched-product route above KERNEL_MAX_MV; empty before the
    first one)."""
    return dict(getattr(_DISPATCH_INFO, "value", {}))


# copied from jepsen_tpu/ops/jitlin.py:380-424
def _returns_prepass(kind, slot, f, a, b):
    """Host pre-pass for the matrix kernel: the per-slot op table and
    pending mask evolve deterministically from the event stream alone
    (invokes/returns), independent of the frontier — so each return's
    (pending set, op table, returning slot) is computable up front.

    Per slot t, the pending bit at event i is ``#invokes(t) <= i  >
    #returns(t) < i``, and the current op is the last invoke of t at or
    before i, found by searchsorted into t's invoke positions.

    Returns numpy arrays over the R return events."""
    kind = np.asarray(kind)
    slot = np.asarray(slot)
    fabs = np.stack([np.asarray(f, np.int64), np.asarray(a, np.int64),
                     np.asarray(b, np.int64)], axis=1)
    S = int(slot.max(initial=0)) + 1
    ret_idx = np.nonzero(kind == EV_RETURN)[0]
    R = ret_idx.shape[0]
    if R == 0:
        return (np.zeros((0,), np.int32), np.zeros((0, S), bool),
                np.zeros((0, S, 3), np.int64), S)
    r_slot = slot[ret_idx].astype(np.int32)
    r_pend = np.zeros((R, S), bool)
    r_ops = np.zeros((R, S, 3), np.int64)
    is_inv = kind == EV_INVOKE
    is_ret = kind == EV_RETURN
    for t in range(S):
        on_t = slot == t
        inv_pos = np.nonzero(is_inv & on_t)[0]
        # a return of slot t at i still sees t pending — it is the op
        # being linearized-and-killed
        n_inv = np.cumsum(is_inv & on_t)
        n_ret_before = np.cumsum(is_ret & on_t) - (is_ret & on_t)
        r_pend[:, t] = (n_inv > n_ret_before)[ret_idx]
        if inv_pos.size == 0:
            continue  # slot never invoked: never pending, op stays 0
        j = np.searchsorted(inv_pos, ret_idx, side="right") - 1
        has = j >= 0
        src = inv_pos[np.where(has, j, 0)]
        r_ops[:, t, :] = np.where(has[:, None], fabs[src], 0)
    return r_slot, r_pend, r_ops, S


# copied from jepsen_tpu/ops/jitlin.py:427-452
def receiver_kill_tables(S: int, V: int):
    """The transfer-matrix operators' static bit tables:

    - receiver [S, M, M] f32: R_t[r | bit_t, r] = 1 for slots t not in
      mask r (the mask-receiver map of linearizing pending op t)
    - kill_idx [S, MV] i32 / kill_mask [S, MV] f32: the
      closure-then-kill row gather+mask for a return on slot s
    """
    M = 1 << S
    MV = M * V
    r = np.arange(M)
    receiver = np.zeros((S, M, M), np.float32)
    for t in range(S):
        src = r[((r >> t) & 1) == 0]
        receiver[t, src | (1 << t), src] = 1.0
    rows = np.arange(MV)
    rr, ww = rows // V, rows % V
    kill_idx = np.zeros((S, MV), np.int32)
    kill_mask = np.zeros((S, MV), np.float32)
    for s in range(S):
        ok = ((rr >> s) & 1) == 0
        kill_idx[s] = np.where(ok, (rr | (1 << s)) * V + ww, 0)
        kill_mask[s] = ok.astype(np.float32)
    return receiver, kill_idx, kill_mask


def _n_squarings(S: int) -> int:
    n_sq = 0
    while (1 << n_sq) < S:
        n_sq += 1
    return n_sq


def _bmm(x, y):
    """Thresholded boolean product of 0/1 batches, in their dtype: exact
    in float32 (counts <= MV <= 2^12), and in bf16 too, where the card
    accumulates in float32 and a count >= 1 rounds to a value >= 1."""
    return (torch.matmul(x, y) > 0).to(x.dtype)


def _kernel_math(S: int, V: int, step_ids, G: int, device,
                 dtype=torch.float32):
    """The static tables, the per-return operator step and the
    chunk-product combiners of jepsen_tpu/ops/jitlin.py:455-583, in
    ``dtype`` torch with a > 0 threshold after every product (every
    intermediate is exactly 0/1, so any association of the boolean
    product yields the same matrix)."""
    M = 1 << S
    MV = M * V
    receiver, kill_idx, kill_mask = receiver_kill_tables(S, V)
    n_sq = _n_squarings(S)
    receiver_t = torch.as_tensor(receiver, dtype=dtype, device=device)
    kill_idx_t = torch.as_tensor(kill_idx, dtype=torch.int64, device=device)
    kill_mask_t = torch.as_tensor(kill_mask, dtype=dtype, device=device)
    eye = torch.eye(MV, dtype=dtype, device=device)
    v_range = torch.arange(V, dtype=torch.int32, device=device)

    def uop_tables(uops):
        """[U, 3] distinct-op table -> [U, V, V] transition matrices
        mt[u, v, w] (old state v -> new state w) + [U] oob flags."""
        st2, ok = step_ids(v_range[None, :], uops[:, 0:1], uops[:, 1:2],
                           uops[:, 2:3])
        # INVARIANT: transitions leaving [0, V) are DROPPED (the
        # equality below can't match), under-approximating
        # reachability — so alive=True with oob set proves nothing and
        # callers must treat it as unknown. The oob flag surfaces it.
        oob = (ok & ((st2 < 0) | (st2 >= V))).any(dim=1)
        mt = ok[:, :, None] & (st2[:, :, None] == v_range[None, None, :])
        return mt.to(dtype), oob

    def make_step(mt_tab, oob_tab):
        def step(carry, inp):
            P, inexact = carry
            pend_g, ids_g, s_g, val_g = inp
            ids_g = ids_g.long()
            mt = mt_tab[ids_g]                   # [G, S, V, V] gather
            oob = oob_tab[ids_g]                 # [G, S]
            gated = pend_g.to(dtype)
            # row = (receiver mask a, NEW state w); col = (source mask
            # b, OLD state v): L[(a,w),(b,v)] = Σ_t pend_t R_t[a,b] M_t[v,w]
            L = torch.einsum("gt,tab,gtvw->gawbv", gated, receiver_t, mt)
            Bm = ((L.reshape(G, MV, MV) + eye) > 0).to(dtype)
            for _ in range(n_sq):
                Bm = _bmm(Bm, Bm)                # (I+L)^(2^k) -> closure
            s_g = s_g.long()
            idx = kill_idx_t[s_g]                # [G, MV]
            A = (torch.gather(Bm, 1, idx[:, :, None].expand(G, MV, MV))
                 * kill_mask_t[s_g][:, :, None])
            val = val_g.to(torch.bool)
            A = torch.where(val[:, None, None], A, eye)
            return (_bmm(A, P),
                    inexact | (oob & pend_g.to(torch.bool)
                               & val[:, None]).any(dim=1))
        return step

    def chain_time(seq):
        """[n, MV, MV] time-ordered chunk products -> their composed
        product (later chunk on the LEFT), by the pairing tree of
        make_combine."""
        while seq.shape[0] > 1:
            odd = seq[-1:] if seq.shape[0] % 2 else None
            pairs = seq[:-1] if odd is not None else seq
            seq = _bmm(pairs[1::2], pairs[0::2])
            if odd is not None:
                seq = torch.cat([seq, odd], dim=0)
        return seq[0]

    def make_combine(B: int, C: int, init_state: int):
        def _combine(P, inexact, tot0):
            # total_b = P[b,C-1] @ ... @ P[b,0] @ tot0[b], tree-reduced
            # per level with the later chunk on the LEFT
            seq = P.reshape(B, C, MV, MV).to(dtype)
            while seq.shape[1] > 1:
                odd = seq[:, -1:] if seq.shape[1] % 2 else None
                pairs = seq[:, :-1] if odd is not None else seq
                seq = _bmm(pairs[:, 1::2], pairs[:, 0::2])
                if odd is not None:
                    seq = torch.cat([seq, odd], dim=1)
            total = _bmm(seq[:, 0], tot0.to(dtype)).to(torch.bfloat16)
            alive = (total[:, :, init_state] > 0).any(dim=1)
            return alive, inexact.reshape(B, C).any(dim=1), total
        return _combine

    return types.SimpleNamespace(
        M=M, MV=MV, n_sq=n_sq, eye=eye, v_range=v_range,
        receiver=receiver_t, kill_idx=kill_idx_t, kill_mask=kill_mask_t,
        uop_tables=uop_tables, make_step=make_step, chain_time=chain_time,
        make_combine=make_combine)


def _build_matrix_kernel(S: int, V: int, step_ids, init_state: int,
                         g_steps: int, n_chunks: int, n_keys: int, device):
    """The two-stage matrix dispatch for one static chunk layout
    (jepsen_tpu/ops/jitlin.py:586-821): chunk g = b * C + c holds key
    b's c-th slice of T = ``g_steps`` returns. Stage 1 computes every
    chunk's [MV, MV] product (``matrix_kernels.chunk_product``), stage 2
    chains each key's C products onto its carry ``tot0``
    (``matrix_kernels.combine_product``). Outside ``kernel_ok`` both
    stages are the reference's scan route instead (``_scan_products``
    and ``_kernel_math.make_combine``). ``run.products`` is stage 1 alone,
    for the forensics (``matrix_localize``)."""
    B, C, T = n_keys, n_chunks, g_steps
    scan = not kernel_ok(S, V)
    # the scan route's products: bf16 on the card, as the reference's
    # (jitlin.py:618-619), float32 on the CPU
    dtype = (torch.bfloat16 if scan and device.type == "cuda"
             else torch.float32)
    math = _kernel_math(S, V, step_ids, B * C, device, dtype)
    MV = math.MV
    route = "cuda" if device.type == "cuda" else "torch"

    def _scan_products(pend, op_ids, uops, slots, valid):
        """jepsen_tpu/ops/jitlin.py:644-663 without the combine: a
        [G, MV, MV] batched step per chunk row. No Pallas kernel computes
        this band in the reference, and here it is plain batched
        products."""
        mt_tab, oob_tab = math.uop_tables(uops)
        step = math.make_step(mt_tab, oob_tab)
        carry = (math.eye.expand(B * C, MV, MV),
                 torch.zeros((B * C,), dtype=torch.bool, device=device))
        for t in range(T):
            carry = step(carry, (pend[t], op_ids[t], slots[t], valid[t]))
        return carry

    def products(pend, op_ids, uops, slots, valid, tables=None):
        """Every chunk's composed operator product and inexact flag, (P
        [G, MV, MV], inexact [G]), without the combine: the chunk-product
        kernel, or the scan route's batched products outside
        ``kernel_ok``. ``tables``: ``uop_tables(uops)`` at float32 when the
        caller has them (the kernel route takes them)."""
        if scan:
            _DISPATCH_INFO.value = {"products": "scan"}
            return _scan_products(pend, op_ids, uops, slots, valid)
        mt_tab, oob_tab = (tables if tables is not None
                           else math.uop_tables(uops))
        mtT = mt_tab.transpose(1, 2).contiguous()
        # _matrix_grids checked the ids and slots on the host
        P = matrix_kernels.chunk_product(pend, op_ids, mtT, slots, valid,
                                         S, V, checked=True)
        # the oob -> inexact reduction runs on the small id grids
        # outside the kernel
        inexact = (oob_tab[op_ids.long()] & pend
                   & valid[..., None]).any(dim=2).any(dim=0)
        _DISPATCH_INFO.value = {"products": route}
        return P, inexact

    def _dispatch_total(pend, op_ids, uops, slots, valid, tot0):
        P, inexact = products(pend, op_ids, uops, slots, valid)
        if scan:
            _DISPATCH_INFO.value = {"products": "scan", "combine": "scan"}
            return math.make_combine(B, C, init_state)(P, inexact, tot0)
        total = matrix_kernels.combine_product(
            P.reshape(B, C, MV, MV), tot0.to(torch.bfloat16))
        _DISPATCH_INFO.value = {"products": route, "combine": route}
        alive = (total[:, :, init_state] > 0).any(dim=1)
        return alive, inexact.reshape(B, C).any(dim=1), total

    def init_total():
        return torch.eye(MV, dtype=torch.bfloat16, device=device).expand(
            B, MV, MV)

    def run(pend, op_ids, uops, slots, valid):
        """pend [T,G,S]; op_ids [T,G,S] (indices into uops [U,3]);
        slots [T,G]; valid [T,G], with chunk g = key * C + chunk.
        Returns (alive[B], inexact[B])."""
        alive, inexact, _ = _dispatch_total(pend, op_ids, uops, slots,
                                            valid, init_total())
        return alive, inexact

    def run_resume(pend, op_ids, uops, slots, valid, tot0):
        """Segmented variant: ``tot0`` [B, MV, MV] is the composed
        operator product of the previous segments. Returns (alive,
        inexact, total) with total staying on the device."""
        return _dispatch_total(pend, op_ids, uops, slots, valid, tot0)

    run.resume = run_resume
    run.init_total = init_total
    run.products = products
    return run


# copied from jepsen_tpu/ops/jitlin.py:949-951,976-979: matrix-path
# applicability — cost is quadratic in MV = 2^S * V, so the value domain
# must be small; below MIN_RETURNS composing matrices can't pay.
MATRIX_MAX_SLOTS = 8
MATRIX_MAX_STATES = 16
MATRIX_MIN_RETURNS = 2000
# per-step [G, MV, MV] intermediates: cap G * MV^2
MATRIX_MAX_ELEMS = 1 << 28
# copied from jepsen_tpu/ops/jitlin.py:959-964, without the environment
# override: keys per dispatch of a batch above MATRIX_SUB_KEYS keys, and
# of a batch of MATRIX_PIPELINE_KEYS + 1 to MATRIX_SUB_KEYS keys
MATRIX_SUB_KEYS = 128
MATRIX_PIPELINE_KEYS = 32
# copied from jepsen_tpu/ops/jitlin.py:968-973, without the environment
# override: events per segment of a resumable matrix chain
# (matrix_check_segmented), and the checker's routing threshold: a longer
# stream takes the chain, so that a check killed mid-way keeps its
# completed segments
MATRIX_SEGMENT_EVENTS = 1 << 20


def matrix_ok(S: int, num_states: int | None, n_returns: int) -> bool:
    return (num_states is not None and S <= MATRIX_MAX_SLOTS
            and num_states <= MATRIX_MAX_STATES
            and n_returns >= MATRIX_MIN_RETURNS)


def kernel_ok(S: int, V: int) -> bool:
    """Is the operator dimension within the matrix kernels' shared-memory
    regime (MV = 2^S * V <= KERNEL_MAX_MV, V <= KERNEL_MAX_V)? Outside it
    the matrix path takes the scan route."""
    return ((1 << S) * V <= matrix_kernels.KERNEL_MAX_MV
            and V <= matrix_kernels.KERNEL_MAX_V)


def matrix_check(stream, step_ids=None, init_state: int = 0,
                 num_states: int | None = None, force: bool = False,
                 device=None):
    """Exact aliveness check of ONE history via block-composed transfer
    matrices. Returns (alive, died, inexact, peak) with died=-1/peak=0
    placeholders, or None when the matrix regime doesn't apply
    (``force=True`` skips the ``matrix_ok`` size gate, for differential
    tests)."""
    if step_ids is None:
        step_ids = cas_register_spec().step_ids
    num_states = num_states if num_states is not None else len(stream.intern)
    kind, slot = np.asarray(stream.kind), np.asarray(stream.slot)
    S = int(slot.max(initial=0)) + 1
    R = int((kind == EV_RETURN).sum())
    if not force and not matrix_ok(S, num_states, R):
        return None
    return matrix_check_batch([stream], step_ids=step_ids,
                              init_state=init_state,
                              num_states=num_states, device=device)[0]


def matrix_check_resume(stream, tot0=None, step_ids=None,
                        init_state: int = 0, num_states: int | None = None,
                        n_slots: int | None = None, device=None):
    """Segmented transfer-matrix verification of one long history: checks
    a segment starting from the composed operator product ``tot0`` of the
    prior segments (None = identity) and returns ``(alive, inexact,
    total)`` with ``total`` staying on the device for the next segment.
    Segments must cut at quiescent points, share the slot dimension
    (``n_slots``) and share the state basis (``num_states``)."""
    if step_ids is None:
        step_ids = cas_register_spec().step_ids
    if num_states is None:
        num_states = len(stream.intern)
    V = _bucket(num_states, floor=8)
    prep = _returns_prepass(np.asarray(stream.kind), np.asarray(stream.slot),
                            np.asarray(stream.f), np.asarray(stream.a),
                            np.asarray(stream.b))
    S = max(n_slots or 1, prep[3])
    if tot0 is not None and tot0.shape[-1] != (1 << S) * V:
        raise ValueError(
            f"carry dimension {tot0.shape[-1]} != (1<<{S})*{V}: segments "
            f"must share n_slots and num_states")
    R_max = prep[0].shape[0]
    if R_max == 0:
        # no returns in this segment: the chain's aliveness is whatever
        # the carried product says (a dead chain must not revive)
        if tot0 is None:
            return True, False, tot0
        alive = (tot0[:, :, init_state] > 0).any(dim=1)
        return alive, False, tot0
    dev = resolve_device(device)
    return _matrix_dispatch([prep], S, R_max, V, step_ids, init_state, dev,
                            resume=True, tot0=tot0)


# copied from jepsen_tpu/ops/jitlin.py:1073-1089; this package has no
# ``variant`` or ``combine_fused`` knob, so both stay None
def matrix_segmented_config(S, V, init_state, num_states, max_segment,
                            step_ids=None) -> dict:
    """The knob and shape fingerprint a segmented-matrix checkpoint is
    valid under, one constructor for the writer (matrix_check_segmented)
    and the tests. ``step_ids`` stamps the model: the prefix hash covers
    only the encoded columns, so a model swap between interrupt and
    resume must discard on the config."""
    from jepsen_tpu_torch.checker.checkpoint import step_identity
    if step_ids is None:
        step_ids = cas_register_spec().step_ids
    return {"path": "matrix", "S": S, "V": V, "init_state": init_state,
            "num_states": num_states, "max_segment": max_segment,
            "variant": None, "combine_fused": None,
            "step": step_identity(step_ids)}


def _flags(alive, inexact) -> tuple[bool, bool]:
    """(all alive, any inexact) of a segment's verdict: device tensors,
    read back together, or the host values that a segment without returns
    gives (``matrix_check_resume`` returns the carry's alive tensor and a
    host False there)."""
    if isinstance(alive, torch.Tensor) and isinstance(inexact, torch.Tensor):
        a, i = torch.stack([alive.all(), inexact.any()]).tolist()
        return bool(a), bool(i)
    a = (alive.all().item() if isinstance(alive, torch.Tensor)
         else np.asarray(alive).all())
    return bool(a), bool(np.asarray(inexact).any())


_SEGMENT_PHASE = threading.local()


def last_segment_seconds() -> list:
    """The calling thread's last ``matrix_check_segmented`` chain, one
    entry a segment it ran: ``{"base", "end", "s"}``, host seconds from
    the slice to the read-back of the segment's verdict."""
    return list(getattr(_SEGMENT_PHASE, "value", []))


# copied from jepsen_tpu/ops/jitlin.py:1092-1223, without the mesh, the
# routing overrides and the trace span
def matrix_check_segmented(stream, step_ids=None, init_state: int = 0,
                           num_states: int | None = None,
                           n_slots: int | None = None,
                           max_segment: int | None = None,
                           ckpt=None, carry: dict | None = None,
                           carry_sink=None, device=None):
    """One long small-domain history through a resumable chain of
    :func:`matrix_check_resume` segments cut at quiescent points
    (:func:`quiescent_cuts`, at most ``max_segment`` =
    MATRIX_SEGMENT_EVENTS events apart). Returns the :func:`matrix_check`
    quad ``(alive, -1, inexact, 0)``.

    Resumable two ways:

    * ``ckpt`` — a :class:`~jepsen_tpu_torch.checker.checkpoint.CheckpointStore`:
      the composed ``tot0`` persists after each segment when the write
      interval elapses, and a valid ``matrix`` checkpoint (same S, V and
      knobs, matching prefix hash) resumes the chain at its cut. Boolean
      operator products are exact under any association, so a resumed
      chain composes the same total as an uninterrupted one.
    * ``carry``/``carry_sink`` — in process: after each exact, alive
      segment ``carry_sink`` receives ``{"rep": "matrix", "tot0",
      "events_done", "S", "V", "init_state"}`` (``tot0`` the bf16 total
      on ``device``), and a matching ``carry`` passed back in resumes
      mid-chain.

    An INEXACT segment aborts the chain at once without sinking or
    persisting its carry: an under-approximate product must never seed an
    exact resume. A dead segment returns at once; dead carries are never
    persisted."""
    if step_ids is None:
        step_ids = cas_register_spec().step_ids
    if num_states is None:
        num_states = len(stream.intern)
    V = _bucket(num_states, floor=8)
    kind = np.asarray(stream.kind)
    slot = np.asarray(stream.slot)
    S = max(n_slots or 1, int(slot.max(initial=0)) + 1)
    if max_segment is None:
        max_segment = MATRIX_SEGMENT_EVENTS
    dev = resolve_device(device)
    cuts = quiescent_cuts(kind, max_segment)
    cut_set = set(cuts)
    n = len(kind)
    base, seg_i = 0, 0
    tot = None
    config = ckpt_mod = None
    if ckpt is not None:
        from jepsen_tpu_torch.checker import checkpoint as ckpt_mod
        config = matrix_segmented_config(S, V, init_state, num_states,
                                         max_segment, step_ids=step_ids)
    # the in-process carry first: it is at least as fresh as the durable
    # checkpoint (the sink runs every segment, the store on an interval)
    if carry is not None:
        if (carry.get("rep") == "matrix" and carry.get("S") == S
                and carry.get("V") == V
                and carry.get("init_state") == init_state
                and carry.get("events_done") in cut_set):
            tot = carry["tot0"]
            base = int(carry["events_done"])
            seg_i = cuts.index(base) + 1
            from jepsen_tpu_torch.checker.checkpoint import count_resume
            count_resume("carry")
            logger.info("segmented matrix check resuming from in-process "
                        "carry at event %d/%d", base, n)
        else:
            logger.warning("matrix carry (S=%r V=%r events=%r) doesn't "
                           "fit this stream (S=%d V=%d); restarting",
                           carry.get("S"), carry.get("V"),
                           carry.get("events_done"), S, V)
    if tot is None and ckpt is not None:
        state = ckpt_mod.load_resume(ckpt, "matrix", config, stream)
        if state is not None and state["events_done"] in cut_set:
            from jepsen_tpu_torch.convert import carry_from_numpy
            tot = carry_from_numpy(
                ckpt_mod.decode_array(state["carry"]["tot0"]), device=dev)
            base = int(state["events_done"])
            seg_i = cuts.index(base) + 1
            ckpt_mod.count_resume("ckpt")
            logger.info("resuming segmented matrix check from %s at "
                        "event %d/%d", ckpt.path, base, n)
        elif state is not None:
            logger.warning("matrix checkpoint's cut %d is not a "
                           "quiescent cut of this stream; restarting",
                           state["events_done"])
    segments = _SEGMENT_PHASE.value = []
    for end in cuts:
        if end <= base:
            continue
        t0 = time.perf_counter()
        seg = _slice_stream(stream, base, end)
        alive, ix, tot = matrix_check_resume(
            seg, tot, step_ids=step_ids, init_state=init_state,
            num_states=num_states, n_slots=S, device=dev)
        alive_b, ix_b = _flags(alive, ix)
        segments.append({"base": base, "end": end,
                         "s": time.perf_counter() - t0})
        if ix_b:
            # an oob escape proves nothing, and its under-approximate
            # carry must never seed an exact resume: abort unsunk
            return alive_b, -1, True, 0
        if not alive_b:
            return False, -1, False, 0
        base = end
        seg_i += 1
        if carry_sink is not None:
            carry_sink({"rep": "matrix", "tot0": tot, "events_done": base,
                        "S": S, "V": V, "init_state": init_state})
        if ckpt is not None and base < n:
            def make_state(tot=tot, base=base, seg_i=seg_i):
                return {
                    "kind": "matrix", "config": config,
                    "events_done": base, "segment": seg_i,
                    "prefix_hash": ckpt_mod.stream_prefix_hash(stream,
                                                               base),
                    "carry": {"tot0": ckpt_mod.encode_array(tot)},
                }
            ckpt.maybe_save(make_state, base)
    return True, -1, False, 0


# copied from jepsen_tpu/ops/jitlin.py:1226-1330, without the mesh branch,
# the rate model and the routing overrides
def matrix_check_batch(streams, step_ids=None, init_state: int = 0,
                       num_states: int | None = None, device=None):
    """Batched transfer-matrix check over independent per-key histories:
    all keys' chunk products advance together, then each key's chunks
    chain separately. Returns [(alive, -1, inexact, 0)] per stream.
    Callers gate the regime (matrix_ok).

    A batch of more than MATRIX_SUB_KEYS keys runs in sub-batches of
    MATRIX_SUB_KEYS keys, one of MATRIX_PIPELINE_KEYS + 1 to
    MATRIX_SUB_KEYS keys in sub-batches of MATRIX_PIPELINE_KEYS, each
    planned at the batch's one (S, R_max, V) and the last padded with
    empty keys, so every sub-batch has one shape. Sub-batch k + 1's host
    prepass, grids and upload run while sub-batch k runs on the card:
    nothing reads back until every sub-batch is enqueued, and the
    results come back in one copy, in submission order. The host and
    dispatch seconds go to ``last_phase_seconds()``."""
    if step_ids is None:
        step_ids = cas_register_spec().step_ids
    if num_states is None:
        num_states = max(len(s.intern) for s in streams)
    V = _bucket(num_states, floor=8)
    B = len(streams)
    kinds = [np.asarray(s.kind) for s in streams]
    slots_np = [np.asarray(s.slot) for s in streams]
    S = max(int(sl.max(initial=0)) + 1 for sl in slots_np)
    R_max = max(int((k == EV_RETURN).sum()) for k in kinds)
    if R_max == 0:
        return [(True, -1, False, 0)] * B
    dev = resolve_device(device)

    def prep(i):
        s = streams[i]
        return _returns_prepass(kinds[i], slots_np[i], np.asarray(s.f),
                                np.asarray(s.a), np.asarray(s.b))

    sub = MATRIX_SUB_KEYS if B > MATRIX_SUB_KEYS else MATRIX_PIPELINE_KEYS
    if B <= sub:
        sub = B
    C, T = _matrix_plan(sub, S, R_max, V)
    run = _matrix_cache(S, V, step_ids, init_state, T, C, sub, dev)
    phases = {"prepass": 0.0, "grids": 0.0, "dispatch": 0.0,
              "sub_batches": 0}
    outs = []
    for lo in range(0, B, sub):
        t0 = time.perf_counter()
        preps = [prep(i) for i in range(lo, min(lo + sub, B))]
        # a short tail is padded with empty keys (R = 0: the identity,
        # trivially alive and exact) to the one shape
        preps += [_EMPTY_PREP] * (sub - len(preps))
        t1 = time.perf_counter()
        grids, uops = _matrix_grids(preps, S, V, sub, C, T, dev)
        t2 = time.perf_counter()
        outs.append(run(grids[0], grids[1], uops, grids[2], grids[3]))
        t3 = time.perf_counter()
        phases["prepass"] += t1 - t0
        phases["grids"] += t2 - t1
        phases["dispatch"] += t3 - t2
        phases["sub_batches"] += 1
    t0 = time.perf_counter()
    both = torch.stack([torch.cat([a for a, _ in outs]),
                        torch.cat([x for _, x in outs])]).cpu().numpy()
    phases["fetch"] = time.perf_counter() - t0
    _PHASE.value = phases
    return [(bool(both[0, b]), -1, bool(both[1, b]), 0) for b in range(B)]


_PHASE = threading.local()


def last_phase_seconds() -> dict:
    """The calling thread's last ``matrix_check_batch`` split: host
    seconds of the prepass, the grids (with their upload) and the
    dispatches (enqueue only), the seconds of the one read-back at the
    end (the card's remaining work), and the sub-batch count."""
    return dict(getattr(_PHASE, "value", {}))


# copied from jepsen_tpu/ops/jitlin.py:1473-1476: an empty key (R = 0):
# its chunks are all invalid, so its product is the identity
_EMPTY_PREP = (np.zeros(0, np.int32), np.zeros((0, 1), bool),
               np.zeros((0, 1, 3), np.int64), 1)


# copied from jepsen_tpu/ops/jitlin.py:1361-1405, without the mesh branch
def _matrix_plan(B, S, R_max, V):
    """(C, T) for one dispatch's chunk layout: per key, C chunks of T
    returns (padded with identity); chunk g = b*C + c. R is bucketed so
    nearby history lengths share a layout. The chunk count targets
    G = B*C ≈ 256 for one history and ≈ 2048 for key batches, with C
    capped at 256 and by the element budget."""
    MV = (1 << S) * V
    if B * MV * MV > MATRIX_MAX_ELEMS:
        raise ValueError(
            f"matrix_check_batch out of regime: keys * MV^2 = "
            f"{B * MV * MV} > {MATRIX_MAX_ELEMS}; split the key batch")
    rb = _bucket(R_max, floor=64)
    target_g = 256 if B == 1 else 2048
    C = int(np.clip(target_g // B, 1, 256))
    C = max(1, min(C, MATRIX_MAX_ELEMS // (B * MV * MV)))
    T = -(-rb // C)
    return C, T


# copied from jepsen_tpu/ops/jitlin.py:1408-1470, without the mesh branch;
# the grids land on ``device`` as int32/bool tensors
def _matrix_grids(preps, S, V, B, C, T, device, host=None):
    """Pads each key's return grids into the (T, G) chunk layout and
    interns the batch's distinct ops. Returns ([pend, ids, slots, valid]
    grids, uops) as tensors on ``device``; a dict ``host`` receives the
    same as numpy arrays (``grids``, ``uops``)."""

    def key_arrays(p):
        r_slot, r_pend, r_ops, s_k = p
        R = r_slot.shape[0]
        pad = C * T - R
        slot_p = np.concatenate([r_slot, np.zeros((pad,), np.int32)])
        pend_p = np.zeros((C * T, S), bool)
        pend_p[:R, :s_k] = r_pend
        ops_p = np.zeros((C * T, S, 3), np.int64)
        ops_p[:R, :s_k] = r_ops
        val_p = np.concatenate([np.ones((R,), bool), np.zeros((pad,), bool)])
        return slot_p, pend_p, ops_p, val_p

    slots, pends, opss, vals = zip(*[key_arrays(p) for p in preps])
    all_ops = np.concatenate([o.reshape(-1, 3) for o in opss])
    # interning via packed scalar keys when fields fit 21 bits
    if all_ops.size and 0 <= all_ops.min() and all_ops.max() < (1 << 21):
        packed = ((all_ops[:, 0] << 42) | (all_ops[:, 1] << 21)
                  | all_ops[:, 2])
        keys, inv = np.unique(packed, return_inverse=True)
        uops = np.stack([keys >> 42, (keys >> 21) & 0x1FFFFF,
                         keys & 0x1FFFFF], axis=1)
    else:
        uops, inv = np.unique(all_ops, axis=0, return_inverse=True)
    ids = inv.astype(np.int32).reshape(B, C * T, S)
    ub = _bucket(len(uops), floor=16)
    uops = np.concatenate(
        [uops, np.zeros((ub - len(uops), 3), uops.dtype)]).astype(np.int32)

    slots_all = np.stack(slots).astype(np.int32)
    # the chunk-product kernel indexes with the ids and slots unchecked,
    # and its wrapper leaves the check to this host copy
    if (slots_all < 0).any() or (slots_all >= S).any():
        raise ValueError(f"_matrix_grids: a returning slot out of range "
                         f"(S={S})")

    def as_tg(x):
        # [B, C*T, ...] → [B, C, T, ...] → [T, B, C, ...] → [T, B*C, ...]
        x = np.asarray(x).reshape((B, C, T) + x.shape[2:])
        x = np.moveaxis(x, 2, 0)
        return np.ascontiguousarray(x.reshape((T, B * C) + x.shape[3:]))

    grids = [as_tg(np.stack(pends)), as_tg(ids), as_tg(slots_all),
             as_tg(np.stack(vals))]
    if host is not None:
        host.update(grids=grids, uops=uops)
    return [_upload(g, device) for g in grids], _upload(uops, device)


def _upload(x: np.ndarray, device) -> torch.Tensor:
    """``x`` on ``device``; to the card from pinned memory, without
    waiting for the stream's earlier work."""
    t = torch.from_numpy(x)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _matrix_dispatch(preps, S, R_max, V, step_ids, init_state, device,
                     resume: bool = False, tot0=None):
    """Builds one dispatch's chunk grids and runs both stages, returning
    device tensors (alive[B], inexact[B]; plus the composed total
    [B, MV, MV] when ``resume``)."""
    B = len(preps)
    C, T = _matrix_plan(B, S, R_max, V)
    grids, uops = _matrix_grids(preps, S, V, B, C, T, device)
    run = _matrix_cache(S, V, step_ids, init_state, T, C, B, device)
    if resume:
        if tot0 is None:
            tot0 = run.init_total()
        return run.resume(grids[0], grids[1], uops, grids[2], grids[3],
                          tot0.to(device))
    return run(grids[0], grids[1], uops, grids[2], grids[3])


_MATRIX_CACHE: dict = {}


def _matrix_cache(S, V, step_ids, init_state, T, C, B, device):
    # keyed by the step itself, not its id: the key holds it, so a step
    # built after another was freed never takes that one's kernel (the
    # specs build one step per shape, so the cache holds one a shape)
    key = (S, V, step_ids, init_state, T, C, B, str(device))
    fn = _MATRIX_CACHE.get(key)
    if fn is None:
        fn = _build_matrix_kernel(S, V, step_ids, init_state, T, C, B,
                                  device)
        _MATRIX_CACHE[key] = fn
    return fn


# ---------------------------------------------------------------------------
# Anomaly forensics: the first anomaly of an invalid matrix verdict
# (jepsen_tpu/ops/jitlin.py:1578-1818; checker/explain.py drives these)
# ---------------------------------------------------------------------------

def _build_forensics_kernel(S: int, V: int, step_ids, T: int, C: int,
                            device):
    """The three device programs of jepsen_tpu/ops/jitlin.py:1584-1665
    for one chunk layout, built on the same operators as the check, so a
    localization cannot disagree with the verdict:

    * ``products`` — the chunk products without the combine (the check's
      stage 1, ``run.products``: the chunk-product kernel, or the scan
      route's batched products outside ``kernel_ok``), with the inexact
      flag a chunk;
    * ``prefix_alive`` — the frontier through the chain of products from
      ``v0`` (``forensics_kernels.prefix_alive``): alive [C] and the
      packed frontier at every chunk's entry;
    * ``vec_batch`` — each candidate's first dead return over one chunk
      on a frontier vector (``forensics_kernels.window_rescan_chunk``),
      over the chunk's operands that ``rescan_chunk`` derives once.
    """
    from jepsen_tpu_torch.ops import forensics_kernels

    run = _matrix_cache(S, V, step_ids, 0, T, C, 1, device)
    math = _kernel_math(S, V, step_ids, 1, device)

    def rescan_chunk(op_ids, tables, slots, v0, v0_words):
        """op_ids [T, S] and slots [T] (tensors on the device), the
        chunk's ``uop_tables`` (float32), v0 [MV] and its packed words ->
        the chunk's ``RescanChunk``."""
        mt, oob = tables
        return forensics_kernels.RescanChunk(op_ids, mt.transpose(1, 2),
                                             oob, slots, v0, v0_words)

    def vec_batch(pend, valid, chunk):
        """pend [K, T, S], valid [K, T] (numpy or tensors) over a
        ``rescan_chunk`` -> (first [K] int32, inexact [K] bool) on the
        device: the masks' upload and one launch."""
        return forensics_kernels.window_rescan_chunk(
            _to_device(pend, device), _to_device(valid, device), chunk)

    return types.SimpleNamespace(products=run.products,
                                 uop_tables=math.uop_tables,
                                 prefix_alive=forensics_kernels.prefix_alive,
                                 rescan_chunk=rescan_chunk,
                                 vec_batch=vec_batch)


def _to_device(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return _upload(np.ascontiguousarray(x), device)


_FORENSICS_CACHE: dict = {}


def _forensics_cache(S, V, step_ids, T, C, device):
    # keyed by the step itself, as _matrix_cache is
    key = (S, V, step_ids, T, C, str(device))
    fk = _FORENSICS_CACHE.get(key)
    if fk is None:
        fk = _build_forensics_kernel(S, V, step_ids, T, C, device)
        _FORENSICS_CACHE[key] = fk
    return fk


# copied from jepsen_tpu/ops/jitlin.py:1682-1707
class MatrixLocalization:
    """A settled device-side localization: WHERE the transfer-matrix
    frontier first died, plus the handles checker/explain.py needs to
    delta-debug a minimal witness over the guilty window (the chunk's
    host grids, the frontier vector at its entry on the device, and the
    chunk's rescan operands on the device, ``rescan``, so that a shrink
    round uploads only its masks)."""

    def __init__(self, failed_return, failed_event, failed_op_index,
                 bisect_steps, chunk, step, n_chunks, chunk_returns,
                 kernel, uops, window_pend, window_ids, window_slots,
                 window_valid, v_start, ret_idx, rescan):
        self.failed_return = failed_return      # global return index
        self.failed_event = failed_event        # stream event index
        self.failed_op_index = failed_op_index  # history op index
        self.bisect_steps = bisect_steps
        self.chunk = chunk                      # guilty chunk c*
        self.step = step                        # chunk-relative return t*
        self.n_chunks = n_chunks
        self.chunk_returns = chunk_returns      # T
        self.kernel = kernel                    # forensics kernel ns
        self.uops = uops
        self.window_pend = window_pend          # [T, S] guilty chunk grids
        self.window_ids = window_ids
        self.window_slots = window_slots
        self.window_valid = window_valid
        self.v_start = v_start                  # [MV] frontier at entry
        self.ret_idx = ret_idx                  # return -> event index map
        self.rescan = rescan                    # RescanChunk of chunk c*


# copied from jepsen_tpu/ops/jitlin.py:1710-1798, on ``device``
def matrix_localize(stream, tot0=None, step_ids=None, init_state: int = 0,
                    num_states: int | None = None, n_slots: int | None = None,
                    device=None):
    """Localizes the first anomaly of an INVALID matrix verdict on the
    device: re-derives the per-chunk operator products (one launch of the
    same cost as the check's stage 1), chains the frontier through them
    for the first dead chunk (``prefix_alive``), then finds the return
    within it by a [MV]-vector rescan (``window_rescan``). The result's
    ``failed_event`` is the exact CPU frontier's first rejection.

    ``tot0`` carries a segmented chain's composed prior product
    (``matrix_check_resume``'s total), so a failing segment localizes
    without rescanning the chain; event and op indices are then relative
    to THIS segment's stream.

    Returns a :class:`MatrixLocalization`, or None when the stream has no
    returns, is out of the plan's budget, is inexact (an oob transition
    proves nothing), is alive, or when the rescan disagrees with the
    chunk verdict (logged)."""
    t0 = time.perf_counter()
    if step_ids is None:
        step_ids = cas_register_spec().step_ids
    if num_states is None:
        num_states = len(stream.intern)
    V = _bucket(num_states, floor=8)
    kind = np.asarray(stream.kind)
    prep = _returns_prepass(kind, np.asarray(stream.slot),
                            np.asarray(stream.f), np.asarray(stream.a),
                            np.asarray(stream.b))
    S = max(n_slots or 1, prep[3])
    R = prep[0].shape[0]
    if R == 0:
        return None
    MV = (1 << S) * V
    if tot0 is not None and tot0.shape[-1] != MV:
        raise ValueError(
            f"carry dimension {tot0.shape[-1]} != {MV}: "
            f"segments must share n_slots and num_states")
    try:
        C, T = _matrix_plan(1, S, R, V)
    except ValueError:
        return None  # out of element budget: the CPU frontier settles it
    dev = resolve_device(device)
    host = {}
    grids, uops = _matrix_grids([prep], S, V, 1, C, T, dev, host=host)
    fk = _forensics_cache(S, V, step_ids, T, C, dev)
    t1 = time.perf_counter()
    # the op tables, once for the products and the rescan
    tables = fk.uop_tables(uops)
    P, inexact = fk.products(grids[0], grids[1], uops, grids[2], grids[3],
                             tables)
    oob = bool(inexact.any().item())
    t2 = time.perf_counter()
    _LOCALIZE_PHASE.value = {"grids": t1 - t0, "products": t2 - t1}
    if oob:
        return None  # oob transition: localization would prove nothing
    if tot0 is not None:
        v0 = tot0.to(dev).reshape(-1, MV, MV)[0][:, init_state] > 0
    else:
        v0 = torch.zeros((MV,), dtype=torch.bool, device=dev)
        v0[init_state] = True
    alive, w = fk.prefix_alive(P, v0)
    alive = alive.cpu().numpy()
    t3 = time.perf_counter()
    _LOCALIZE_PHASE.value["prefix"] = t3 - t2
    if alive.all():
        return None  # the (carried) history is alive: nothing to localize
    c_star = int(np.argmax(~alive))
    from jepsen_tpu_torch.ops.forensics_kernels import read_first, unpack_bits
    v_start = unpack_bits(w[c_star], MV)
    # the chunk's grids stay on the device for the rescan; explain.py
    # reads the host copies
    pend_c, ids_c, slots_c, valid_c = (np.ascontiguousarray(g[:, c_star])
                                       for g in host["grids"])
    chunk = fk.rescan_chunk(grids[1][:, c_star], tables,
                            grids[2][:, c_star], v_start, w[c_star])
    first, inexact2 = fk.vec_batch(grids[0][:, c_star][None],
                                   grids[3][:, c_star][None], chunk)
    # first and the inexact flag in one read-back
    t_star, inexact_any = read_first(torch.cat(
        (first, inexact2.to(torch.int32)))).tolist()
    _LOCALIZE_PHASE.value["rescan"] = time.perf_counter() - t3
    if t_star < 0 or inexact_any:
        # the chunk verdict and its per-return rescan disagree — a bug
        # or an oob escape; never report a guessed position
        logger.warning(
            "matrix localization inconsistency at chunk %d (first=%d); "
            "declining", c_star, t_star)
        return None
    r_star = c_star * T + t_star
    ret_idx = np.nonzero(kind == EV_RETURN)[0]
    event = int(ret_idx[r_star])
    op_index = int(np.asarray(stream.op_index)[event])
    bisect_steps = max(1, int(np.ceil(np.log2(max(C, 2))))) + 1
    return MatrixLocalization(
        failed_return=r_star, failed_event=event, failed_op_index=op_index,
        bisect_steps=bisect_steps, chunk=c_star, step=t_star, n_chunks=C,
        chunk_returns=T, kernel=fk, uops=host["uops"], window_pend=pend_c,
        window_ids=ids_c, window_slots=slots_c, window_valid=valid_c,
        v_start=v_start, ret_idx=ret_idx, rescan=chunk)


_LOCALIZE_PHASE = threading.local()


def last_localize_seconds() -> dict:
    """The calling thread's last ``matrix_localize`` split, host seconds
    each ending in a read-back: the prepass, grids and upload
    (``grids``), the chunk products and their inexact flag
    (``products``), the frontier chain and its alive flags (``prefix``),
    and the guilty chunk's rescan (``rescan``); a localization that
    declined early has fewer keys."""
    return dict(getattr(_LOCALIZE_PHASE, "value", {}))


# copied from jepsen_tpu/ops/jitlin.py:1801-1811
def matrix_window_rescan(loc: MatrixLocalization, pend_batch, valid_batch):
    """First dead return (chunk-relative; -1 = survives) for each
    candidate's masked (pend, valid) grids over the localized chunk, as
    ONE ``window_rescan`` launch over the chunk's device operands that
    the localization kept (the masks' upload is all a round adds) — the
    witness shrinker's inner loop (checker/explain.py). Returns a numpy
    int32 array."""
    from jepsen_tpu_torch.ops.forensics_kernels import read_first
    first, _ = loc.kernel.vec_batch(
        np.ascontiguousarray(pend_batch), np.ascontiguousarray(valid_batch),
        loc.rescan)
    return read_first(first)


# copied from jepsen_tpu/ops/jitlin.py:2040-2046
def _bucket(n: int, floor: int = 64) -> int:
    """Round counts up to a power of two >= floor."""
    b = floor
    while b < n:
        b *= 2
    return b


# copied from jepsen_tpu/ops/jitlin.py:1819-1829: the dense table's
# regime. Its closure holds an [S, 2^S, V] intermediate in the reference.
DENSE_MAX_SLOTS = 12
DENSE_MAX_STATES = 512
DENSE_MAX_ELEMS = 1 << 21


def _dense_ok(S: int, num_states: int | None) -> bool:
    if num_states is None:
        return False
    vb = _bucket(num_states, floor=16)
    return (S <= DENSE_MAX_SLOTS and num_states <= DENSE_MAX_STATES
            and S * (1 << S) * vb <= DENSE_MAX_ELEMS)


# copied from jepsen_tpu/ops/jitlin.py:2049-2054
def verdict(alive: bool, overflow: bool):
    """Soundness rules: a surviving (possibly truncated) frontier proves
    linearizability; an empty frontier after overflow proves nothing."""
    if alive:
        return True
    return "unknown" if overflow else False


# copied from jepsen_tpu/ops/jitlin.py:1844-1874
def quiescent_cuts(kind, max_segment: int) -> list[int]:
    """Cut positions for segmented verification: indices where no op is
    pending (every invoke has returned), at most ``max_segment`` events
    apart, as cumulative end positions including the final one. A window
    with no quiescent point extends to the next one (or the end): a raw
    cut would drop pending-op state and could convict a valid history."""
    kind = np.asarray(kind)
    delta = np.where(kind == EV_INVOKE, 1,
                     np.where(kind == EV_RETURN, -1, 0))
    pending = np.cumsum(delta)
    quiet = np.nonzero(pending == 0)[0] + 1  # cut AFTER these events
    cuts: list[int] = []
    pos = 0
    n = len(kind)
    while pos < n:
        limit = pos + max_segment
        if limit >= n:
            cuts.append(n)
            break
        j = np.searchsorted(quiet, limit, side="right") - 1
        if j >= 0 and quiet[j] > pos:
            nxt = int(quiet[j])
        else:
            k = np.searchsorted(quiet, limit, side="right")
            nxt = int(quiet[k]) if k < len(quiet) else n
        cuts.append(nxt)
        pos = nxt
    return cuts


# copied from jepsen_tpu/ops/jitlin.py:1877-1969, on the frontier kernels
def segmented_check(stream, max_segment: int = 1 << 21, kernel=None,
                    capacity: int = 256, num_states: int | None = None,
                    ckpt=None):
    """Checks one long history as a chain of bounded segments cut at
    quiescent points, carrying the frontier on the device between them:
    the dense table or the capacity-``capacity`` sparse list, as
    ``kernel`` (a :class:`JitLinKernel`, which names the device, the step
    and the initial state) routes it, one ``frontier_dense`` /
    ``frontier_sparse`` launch a segment from the frontier the last one
    left. Returns (alive, died_event, overflow, peak): ``died`` an index
    into the whole stream, ``overflow`` ORed over the segments (for the
    dense table, its out-of-range flag), ``peak`` their max.

    The reference pads each segment to a bucketed length with no-op
    events; the kernels here take the segment as it is, which changes
    nothing (a no-op event steps nothing).

    ``ckpt`` makes the chain resumable: the frontier persists after each
    segment when the write interval elapses, and a valid ``frontier``
    checkpoint (same cuts, same config, matching prefix hash) resumes the
    chain at its cut."""
    if kernel is None:
        kernel = JitLinKernel()
    if num_states is None and getattr(stream, "intern", None) is not None:
        num_states = len(stream.intern)
    S = max(1, stream.n_slots)
    dev = resolve_device(kernel.device)
    dense = kernel.route(S, num_states) == "dense"
    if dense:
        carry = (frontier_kernels.init_table(
            S, _bucket(num_states, floor=16), kernel.init_state, dev),)
    else:
        carry = frontier_kernels.init_frontier(capacity, kernel.init_state,
                                               dev)
    kind = np.asarray(stream.kind)
    cuts = quiescent_cuts(kind, max_segment)
    ovf, peak = False, 0
    base = 0
    config = ckpt_mod = None
    if ckpt is not None:
        from jepsen_tpu_torch.checker import checkpoint as ckpt_mod
        config = {"path": "segmented", "S": S, "capacity": capacity,
                  "num_states": num_states, "max_segment": max_segment,
                  "dense": dense,
                  "step": ckpt_mod.step_identity(kernel.step_ids)}
        state = ckpt_mod.load_resume(ckpt, "frontier", config, stream)
        if state is not None and state["events_done"] in set(cuts):
            from jepsen_tpu_torch.convert import frontier_from_numpy
            base = state["events_done"]
            arrays = [ckpt_mod.decode_array(a).astype(d.dtype)
                      for a, d in zip(state["carry"]["arrays"],
                                      (ckpt_mod.host_array(c)
                                       for c in carry))]
            carry = frontier_from_numpy(*arrays, device=dev)
            if dense:
                carry = (carry,)
            ovf = bool(state["carry"].get("overflow", False))
            peak = int(state["carry"].get("peak", 0))
            ckpt_mod.count_resume("ckpt")
            logger.info("resuming segmented check from %s at event %d/%d",
                        ckpt.path, base, len(kind))
        elif state is not None:
            logger.warning("segmented checkpoint's cut %d is not a "
                           "quiescent cut of this stream; restarting",
                           state["events_done"])
    for end in cuts:
        if end <= base:
            continue  # already covered by the resumed carry
        seg = _slice_stream(stream, base, end)
        events = (seg.kind, seg.slot, seg.f, seg.a, seg.b)
        if dense:
            out = frontier_kernels.frontier_dense(*events, *carry,
                                                  step_ids=kernel.step_ids)
        else:
            out = frontier_kernels.frontier_sparse(*events, *carry, S,
                                                   step_ids=kernel.step_ids)
        carry = out[4:]
        a, d, o, p = torch.stack([x.to(torch.int32) for x in out[:4]]
                                 ).cpu().tolist()
        ovf |= bool(o)
        peak = max(peak, p)
        if not a:
            return False, base + d if d >= 0 else -1, ovf, peak
        base = end
        if ckpt is not None and base < len(kind):
            def make_state(carry=carry, base=base, ovf=ovf, peak=peak):
                return {
                    "kind": "frontier", "config": config,
                    "events_done": base, "segment": cuts.index(base),
                    "prefix_hash": ckpt_mod.stream_prefix_hash(stream,
                                                               base),
                    "carry": {
                        "arrays": [ckpt_mod.encode_array(c) for c in carry],
                        "overflow": ovf, "peak": peak,
                    },
                }
            ckpt.maybe_save(make_state, base)
    return True, -1, ovf, peak


# copied from jepsen_tpu/ops/jitlin.py:1972-1982
def _slice_stream(stream, lo: int, hi: int):
    """A view-slice of an EventStream's arrays (shared intern and slot
    count). ``op_index`` slices too: a segment's diagnostics resolve
    through its own events."""
    import copy
    seg = copy.copy(stream)
    for field in ("kind", "slot", "f", "a", "b", "op_index"):
        setattr(seg, field, np.asarray(getattr(stream, field))[lo:hi])
    return seg


class JitLinKernel:
    """The frontier scan of one history (jepsen_tpu/ops/jitlin.py:1984-
    2031): the exact dense table when the configuration space is small
    enough (``_dense_ok``), else the capacity-K sparse frontier."""

    def __init__(self, step_ids=None, init_state: int = 0, device=None):
        self.step_ids = (step_ids if step_ids is not None
                         else cas_register_spec().step_ids)
        self.init_state = init_state
        # None = the CUDA device
        self.device = device

    def route(self, S: int, num_states: int | None) -> str:
        """"dense" or "sparse": the choice of the reference's
        ``JitLinKernel._get`` (jitlin.py:2002)."""
        return "dense" if _dense_ok(S, num_states) else "sparse"

    def check(self, stream, capacity: int = 256):
        """Single history. Returns (alive, died_event, overflow, peak).

        The reference's ``check`` goes through ``parallel.batch_check``,
        which re-runs the matrix screen on histories in its regime and
        scans only those it leaves undecided (not alive, or inexact).
        The checker reaches this rung only after its own matrix rung
        left the history undecided (or out of regime), so the direct
        scan gives the reference's result."""
        S = max(1, stream.n_slots)
        intern = getattr(stream, "intern", None)
        num_states = len(intern) if intern is not None else None
        dev = resolve_device(self.device)
        events = (stream.kind, stream.slot, stream.f, stream.a, stream.b)
        if self.route(S, num_states) == "dense":
            vb = _bucket(num_states, floor=16)
            out = frontier_kernels.frontier_dense(
                *events, frontier_kernels.init_table(S, vb, self.init_state,
                                                     dev),
                step_ids=self.step_ids)
        else:
            mask0, state0 = frontier_kernels.init_frontier(
                capacity, self.init_state, dev)
            out = frontier_kernels.frontier_sparse(
                *events, mask0, state0, S, step_ids=self.step_ids)
        alive, died, overflow, peak = (x.item() for x in out[:4])
        return bool(alive), int(died), bool(overflow), int(peak)

    def check_batch(self, streams, capacity: int = 256):
        """Independent per-key histories on the card
        (jepsen_tpu/ops/jitlin.py:2033): ``parallel.batch_check``'s
        matrix screen, then one key-batched frontier launch for the keys
        it leaves undecided. Returns [(alive, died, overflow, peak)] per
        stream."""
        from jepsen_tpu_torch.parallel import batch_check
        return batch_check(streams, capacity=capacity, kernel=self,
                           accelerator="gpu")
