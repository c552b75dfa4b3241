"""Checker views over the history IR (jepsen_tpu/history_ir/views.py):
encode once, consume everywhere.

Every checker's encoding is a view derived from one
:class:`~jepsen_tpu_torch.history_ir.ir.DeviceHistory` and memoized on it
(``dh.view``), so the checkers of one run (``history_ir.of``) pay each
encode once:

* :func:`register_stream` / :func:`multi_register_stream` — the
  linearizability EventStream (``checker.linear_encode``'s encoders);
* :func:`elle_build` / :func:`elle_columns` — the list-append build
  product and its storable columns (``elle.columnar``);
* :func:`txn_nodes` — the ok/fail/info split (:func:`txn_split`) the
  Python Elle builders start from;
* :func:`set_membership` — :func:`set_full_columns`, the set-full
  membership matrix the set-classify kernel reads;
* :func:`subhistories` — the per-key split of the independent checker.

:func:`register_stream` and :func:`elle_columns` are also what the
``history.npz`` sidecar persists and the stored re-checks read back.

One deliberate change from the reference in :func:`set_full_columns`:
the times come back as float64. Jepsen records times in nanoseconds since
the test began, and float32 cannot tell two times about 8 us apart near
100 s, which turns a read that began before an add was acknowledged into
a later one.
"""
from __future__ import annotations

import numpy as np

from jepsen_tpu_torch.history import Intern
from jepsen_tpu_torch.history_ir.ir import DeviceHistory


# copied from jepsen_tpu/history_ir/views.py:43-49
def _key_of(v) -> str:
    """A stable hashable memo-key fragment for an arbitrary value."""
    try:
        hash(v)
        return v
    except TypeError:
        return repr(v)


# copied from jepsen_tpu/history_ir/views.py:234-243, over the port's
# checker/linear_encode.encode_register_ops
def register_stream(dh: DeviceHistory, init_value=None):
    """The memoized register EventStream view. ``init_value`` (the
    model's initial register value) interns FIRST so its id is the
    kernel's init state — the memo is keyed on it."""
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops

    def build():
        intern = Intern()
        if init_value is not None:
            intern.id(init_value)
        return encode_register_ops(dh.ops, intern=intern)
    return dh.view(("register-stream", _key_of(init_value)), build)


# copied from jepsen_tpu/history_ir/views.py:246-259, over the port's
# checker/linear_encode.encode_multi_register_ops
def multi_register_stream(dh: DeviceHistory, n_keys: int, n_values: int):
    """The memoized multi-register EventStream view, or None when the
    history falls outside the packed encoding (the checker then runs
    ``wgl``)."""
    from jepsen_tpu_torch.checker.linear_encode import (
        encode_multi_register_ops)

    def build():
        try:
            return encode_multi_register_ops(dh.ops, n_keys, n_values)
        except ValueError:
            return None
    return dh.view(("multi-register-stream", n_keys, n_values), build)


# copied from jepsen_tpu/history_ir/views.py:262-272, over the port's
# elle.columnar._build
def elle_build(dh: DeviceHistory):
    """The memoized Elle dependency-graph build product
    ((graph, txns, extras, n_keys) — ``elle.columnar._build``), or None
    when the history is outside the integer columnar regime."""
    def build():
        from jepsen_tpu_torch.elle import columnar
        try:
            return columnar._build(dh.ops)
        except (TypeError, ValueError, OverflowError):
            return None
    return dh.view(("elle-build",), build)


# copied from jepsen_tpu/history_ir/views.py:275-281
def elle_columns(dh: DeviceHistory):
    """The memoized storable Elle builder columns
    (``elle.columnar.parse_columns``), or None when not storable."""
    def build():
        from jepsen_tpu_torch.elle import columnar
        return columnar.parse_columns(dh.ops)
    return dh.view(("elle-columns",), build)


def txn_split(history) -> tuple[list, list, list]:
    """(oks, fails, infos): the ok and info ops of an int process, and
    every failed op, in history order — one pass over the ops."""
    oks = [op for op in history if op.get("type") == "ok"
           and isinstance(op.get("process"), int)]
    fails = [op for op in history if op.get("type") == "fail"]
    infos = [op for op in history if op.get("type") == "info"
             and isinstance(op.get("process"), int)]
    return oks, fails, infos


# copied from jepsen_tpu/history_ir/views.py:284-298, through the type
# masks when the columns are built
def txn_nodes(dh: DeviceHistory) -> tuple[list, list, list]:
    """The memoized :func:`txn_split` every elle-style checker starts
    from (list-append's Python builder, rw-register). The type masks
    pick the ops when the IR's columns are already built; otherwise the
    one pass over the ops, which costs less than building them."""
    def build():
        if not dh.columns_built():
            return txn_split(dh.ops)
        ops = dh.ops

        def pick(mask, typ, int_process):
            return [ops[i] for i in np.flatnonzero(mask).tolist()
                    if ops[i].get("type") == typ
                    and (not int_process
                         or isinstance(ops[i].get("process"), int))]
        # an unknown type codes as info: the type test keeps it out
        return (pick(dh.is_ok, "ok", True), pick(dh.is_fail, "fail", False),
                pick(dh.is_info, "info", True))
    return dh.view(("txn-nodes",), build)


# copied from jepsen_tpu/history_ir/views.py:302-454, times in float64
def set_full_columns(history) -> dict:
    """The set-full checker's device encoding: every element's
    add-invoke/add-ok times plus the reads x elements membership matrix
    the setscan kernel classifies, reads sorted by their invoke times.

    Returns ``{"member", "read_t", "invoke_t", "ok_t", "has_ok",
    "els"}`` — or ``{"error": ...}`` when the set was never read."""
    intern = Intern()
    invoke_t: list[float] = []
    ok_t: list[float] = []
    has_ok: list[bool] = []
    has_invoke: list[bool] = []

    def el_slot(v):
        i = intern.id(v) - 1  # id 0 is the None sentinel
        while len(invoke_t) <= i:
            invoke_t.append(0.0)
            ok_t.append(0.0)
            has_ok.append(False)
            has_invoke.append(False)
        return i

    reads: list[tuple[float, object]] = []  # (invoke time, raw payload)
    pending_read_invokes: dict = {}

    # -- adds: vectorized first-invoke / last-ok per element --------
    # the per-event Python walk dominated the host side of this
    # checker at bench scale; for the universal all-int regime the
    # same semantics (invoke_t = first add event's time, ok_t =
    # last ok's — el_slot's exact behavior) fall out of masked
    # first/last-occurrence joins. Non-int elements keep the loop.
    nh = len(history)
    # cheap gate first: the columnar path serves only all-int add
    # values, and a non-int history must not pay for mask building
    fast = any(op.get("f") == "add" for op in history) and \
        all(type(op.get("value")) is int for op in history
            if op.get("f") == "add")
    scan = range(nh)
    if fast:
        fs = [op.get("f") for op in history]
        typs = [op.get("type") for op in history]
        add_m = np.fromiter((f == "add" for f in fs), bool, nh)
        inv_m = np.fromiter((t == "invoke" for t in typs), bool, nh)
        ok_m = np.fromiter((t == "ok" for t in typs), bool, nh)
        add_pos = np.nonzero(add_m & (inv_m | ok_m))[0]
        fast = add_pos.size > 0
    if fast:
        add_idx = add_pos.tolist()
        t_add = np.fromiter(
            (float(history[i].get("time", i)) for i in add_idx),
            np.float64, add_pos.size)
        va = np.asarray([history[i].get("value") for i in add_idx],
                        np.int64)
        uniq, first_idx, inverse = np.unique(
            va, return_index=True, return_inverse=True)
        order = np.argsort(first_idx)
        rank = np.empty(order.size, np.int64)
        rank[order] = np.arange(order.size)
        el_ids = rank[inverse]
        for v in uniq[order].tolist():
            intern.id(v)   # same table the read fallback consults
        E_fast = int(uniq.size)
        _, first_per_el = np.unique(el_ids, return_index=True)
        ok_arr = np.zeros(E_fast)
        has_ok_arr = np.zeros(E_fast, bool)
        ok_sel = np.nonzero(ok_m[add_pos])[0]
        if ok_sel.size:
            el_ok = el_ids[ok_sel][::-1]
            t_ok = t_add[ok_sel][::-1]
            u_ok, last_rev = np.unique(el_ok, return_index=True)
            ok_arr[u_ok] = t_ok[last_rev]
            has_ok_arr[u_ok] = True
        invoke_t = t_add[first_per_el].tolist()
        ok_t = ok_arr.tolist()
        has_ok = has_ok_arr.tolist()
        has_invoke = [True] * E_fast
        # only the (few) read events still walk in Python
        read_m = np.fromiter((f == "read" for f in fs), bool, nh)
        scan = np.nonzero(read_m & (inv_m | ok_m))[0].tolist()
    for i in scan:
        op = history[i]
        f, typ, v, p = (op.get("f"), op.get("type"), op.get("value"),
                        op.get("process"))
        if f == "add":
            t = float(op.get("time", i))
            j = el_slot(v)
            if typ == "invoke" and not has_invoke[j]:
                invoke_t[j] = t
                has_invoke[j] = True
            elif typ == "ok":
                ok_t[j] = t
                has_ok[j] = True
                if not has_invoke[j]:  # ok with no invoke (CPU parity)
                    invoke_t[j] = t
                    has_invoke[j] = True
        elif f == "read":
            t = float(op.get("time", i))
            if typ == "invoke":
                pending_read_invokes[p] = t
            elif typ == "ok":
                t0 = pending_read_invokes.pop(p, t)
                reads.append((t0, v))
    if not reads:
        return {"error": "Set was never read"}
    E = len(invoke_t)
    reads.sort(key=lambda rv: rv[0])
    member = np.zeros((len(reads), max(E, 1)), dtype=bool)
    # Columnar fast path for the common set workload (integer
    # elements): map each read payload to element columns with one
    # sorted-array searchsorted instead of a per-element dict walk —
    # the membership matrix build is the device path's host-side cost
    # and must not dominate the kernel it feeds. Elements a read
    # mentions that were never added are ignored on both paths.
    uv_sorted = uv_order = None
    vals = intern.table[1:E + 1]
    if E and all(type(x) is int for x in vals):
        uv = np.asarray(vals, np.int64)
        uv_order = np.argsort(uv)
        uv_sorted = uv[uv_order]
    for r, (_, vs) in enumerate(reads):
        if uv_sorted is not None:
            try:
                arr = np.asarray(vs if type(vs) is list else list(vs))
            except (TypeError, ValueError, OverflowError):
                arr = None
            # signed-int dtype only: asarray would silently coerce
            # floats ('2.5' -> 2) or parse digit strings, making a
            # read "contain" elements it never mentioned
            if arr is not None and arr.ndim == 1 \
                    and arr.dtype.kind == "i":
                arr = arr.astype(np.int64)
                pos = np.clip(np.searchsorted(uv_sorted, arr), 0, E - 1)
                hit = uv_sorted[pos] == arr
                member[r, uv_order[pos[hit]]] = True
                continue
        for v in set(vs):
            j = intern.id(v) - 1
            if 0 <= j < E:
                member[r, j] = True
    return {
        "member": member[:, :max(E, 1)],
        "read_t": np.array([t for t, _ in reads], dtype=np.float64),
        "invoke_t": np.array(invoke_t, dtype=np.float64),
        "ok_t": np.array(ok_t, dtype=np.float64),
        "has_ok": np.array(has_ok, dtype=bool),
        "els": [intern.value(j + 1) for j in range(E)],
    }


# copied from jepsen_tpu/history_ir/views.py:457-459
def set_membership(dh: DeviceHistory) -> dict:
    """The memoized set-full membership view."""
    return dh.view(("set-full",), lambda: set_full_columns(dh.ops))


# copied from jepsen_tpu/history_ir/views.py:467-477, through
# independent.split_history (one pass over the history)
def subhistories(dh: DeviceHistory) -> tuple[list, dict]:
    """The memoized ``(keys, {frozen_key: sub_history})`` split the
    independent checker fans out over — computed once per run even when
    several composed checkers lift the same history."""
    def build():
        from jepsen_tpu_torch import independent
        return independent.split_history(dh.ops)
    return dh.view(("subhistories",), build)
