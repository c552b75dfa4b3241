"""Seeded synthetic histories for smoke runs and tests: single-register
and multi-register (multi-key-acid) histories for the linearizability
check, list-append and rw-register txn histories for the Elle checks,
seeded graphs and clusters for the Elle kernels alone, set-add/read
histories for the set-full check, and a run's clock and nemesis for the
reports of a suite's composed check."""
from __future__ import annotations

import numpy as np


# copied from __graft_entry__.py:19-64
def register_history(n_ops: int, n_procs: int = 3, seed: int = 7,
                     n_values: int = 100) -> list[dict]:
    """A valid single-register r/w/cas history with real concurrency
    (linearization point at completion). ``n_values`` bounds the
    write/cas value domain — the reference's linearizable-register
    workload writes ``(rand-int 5)``, so small domains are the faithful
    regime."""
    rng = np.random.default_rng(seed)
    reg = None
    history: list[dict] = []
    pending: dict[int, dict] = {}
    invoked = 0
    while invoked < n_ops or pending:
        free = [p for p in range(n_procs) if p not in pending]
        do_invoke = invoked < n_ops and free and (not pending or rng.random() < 0.6)
        if do_invoke:
            p = int(rng.choice(free))
            f = ["read", "write", "cas"][int(rng.integers(3))]
            if f == "read":
                value = None
            elif f == "write":
                value = int(rng.integers(n_values))
            else:
                old = reg if (reg is not None and rng.random() < 0.7) else int(rng.integers(n_values))
                value = [old, int(rng.integers(n_values))]
            op = {"type": "invoke", "process": p, "f": f, "value": value}
            history.append(op)
            pending[p] = op
            invoked += 1
        else:
            p = int(rng.choice(list(pending)))
            inv = pending.pop(p)
            f, value = inv["f"], inv["value"]
            if f == "read":
                history.append({"type": "ok", "process": p, "f": f, "value": reg})
            elif f == "write":
                reg = value
                history.append({"type": "ok", "process": p, "f": f, "value": value})
            else:
                old, new = value
                if reg == old:
                    reg = new
                    history.append({"type": "ok", "process": p, "f": f, "value": value})
                else:
                    history.append({"type": "fail", "process": p, "f": f, "value": value})
    return history


def corrupt_reads(history: list[dict], n: int = 2, seed: int = 0,
                  value=999) -> list[dict]:
    """A copy of ``history`` with ``n`` seeded ok reads answering a value
    no write produced — an invalid history."""
    out = [dict(op) for op in history]
    reads = [i for i, op in enumerate(out)
             if op.get("f") == "read" and op.get("type") == "ok"]
    rng = np.random.default_rng(seed)
    for i in rng.choice(reads, size=min(n, len(reads)), replace=False):
        out[int(i)]["value"] = value
    return out


def independent_register_history(n_keys: int, n_ops: int = 1000,
                                 n_procs: int = 5, n_values: int = 5,
                                 seed: int = 1000) -> list[dict]:
    """A lifted history of ``n_keys`` independent registers (values
    [k, v]), BASELINE config 3 in bench.py's shape (``bench.py:438-440``:
    1k ops a key, 5 processes, 5 values, key k's history from seed
    1000 + k): key k's ops are ``register_history(n_ops, n_procs,
    seed + k, n_values)`` on processes k * n_procs .. k * n_procs +
    n_procs - 1 (a group of threads a key, as the reference's
    ConcurrentGenerator gives it), and the keys' ops interleave in a
    seeded random order that keeps each key's own order."""
    keyed = [register_history(n_ops, n_procs=n_procs, seed=seed + k,
                              n_values=n_values) for k in range(n_keys)]
    order = np.random.default_rng(seed).permutation(
        np.repeat(np.arange(n_keys), [len(h) for h in keyed]))
    at = [0] * n_keys
    out = []
    for k in order.tolist():
        op = keyed[k][at[k]]
        at[k] += 1
        out.append({**op, "process": k * n_procs + op["process"],
                    "value": [k, op["value"]]})
    return out


def corrupt_keys(history: list[dict], keys, n: int = 2, seed: int = 0,
                 value=999) -> list[dict]:
    """A copy of a lifted ``history`` in which each key of ``keys`` has
    ``n`` ok reads answering ``value``: :func:`corrupt_reads` on the
    key's own sub-history, with seed ``seed + k`` for an int key k (else
    ``seed``)."""
    out = [dict(op) for op in history]
    for k in keys:
        at = [i for i, op in enumerate(out)
              if isinstance(op.get("value"), list)
              and len(op["value"]) == 2 and op["value"][0] == k]
        sub = [{**out[i], "value": out[i]["value"][1]} for i in at]
        bad = corrupt_reads(sub, n=n,
                            seed=seed + k if isinstance(k, int) else seed,
                            value=value)
        for i, op, op2 in zip(at, sub, bad):
            if op2["value"] != op["value"]:
                out[i]["value"] = [k, op2["value"]]
    return out


def multi_register_history(n_txns: int, n_procs: int = 5, n_keys: int = 3,
                           n_values: int = 5, seed: int = 7,
                           crash_every: int = 0,
                           n_readers: int | None = None) -> list[dict]:
    """A valid multi-register txn history (f "txn") with real concurrency:
    each txn reads or writes a random nonempty subset of the ``n_keys``
    keys, as the multi-key-acid workload's r and w do
    (jepsen_tpu/workloads/multi_key_acid.py:31-42). A read
    ``[["r", k, None], ...]`` is answered with the register map's values
    at its completion, a write ``[["w", k, v], ...]`` (v below
    ``n_values``) takes effect at its completion. With ``n_readers``,
    worker i reads when i < n_readers and writes otherwise (the
    workload's ``gen.reserve``); else each txn reads or writes by a coin.
    With ``crash_every``, every ``crash_every``-th write crashes: its
    completion is ``info``, it takes effect or not by a coin, and its
    worker goes on as a fresh process, as Jepsen replaces a crashed
    process; each crashed write holds its slot for good."""
    rng = np.random.default_rng(seed)
    regs: dict = {}
    history: list[dict] = []
    pending: dict[int, dict] = {}
    procs = list(range(n_procs))  # worker i's current process
    next_proc = n_procs
    invoked = writes = 0
    while invoked < n_txns or pending:
        free = [i for i, p in enumerate(procs) if p not in pending]
        if invoked < n_txns and free and (not pending or rng.random() < 0.6):
            i = free[int(rng.integers(len(free)))]
            keys = sorted(rng.permutation(n_keys)[
                :int(rng.integers(1, n_keys + 1))].tolist())
            read = (rng.random() < 0.5 if n_readers is None
                    else i < n_readers)
            value = ([["r", k, None] for k in keys] if read
                     else [["w", k, int(rng.integers(n_values))]
                           for k in keys])
            op = {"type": "invoke", "process": procs[i], "f": "txn",
                  "value": value}
            history.append(op)
            pending[procs[i]] = op
            invoked += 1
            continue
        p = list(pending)[int(rng.integers(len(pending)))]
        mops = pending.pop(p)["value"]
        if mops[0][0] == "r":
            history.append({"type": "ok", "process": p, "f": "txn",
                            "value": [["r", k, regs.get(k)]
                                      for _, k, _ in mops]})
            continue
        writes += 1
        crash = bool(crash_every) and writes % crash_every == 0
        if not crash or rng.random() < 0.5:
            for _, k, v in mops:
                regs[k] = v
        history.append({"type": "info" if crash else "ok", "process": p,
                        "f": "txn", "value": mops})
        if crash:
            procs[procs.index(p)] = next_proc
            next_proc += 1
    return history


def multi_key_acid_history(n_groups: int, per_group: int = 20,
                           n_procs: int = 10, seed: int = 2000,
                           n_keys: int = 3, n_values: int = 5) -> list[dict]:
    """The multi-key-acid workload's lifted history
    (jepsen_tpu/workloads/multi_key_acid.py:45-60): one independent key a
    group, each group ``per_group`` txns on its own ``n_procs`` = 2n
    processes (multi_key_acid.clj:59), the first half reading and the
    rest writing (``gen.reserve``), over ``n_keys`` x ``n_values``
    (multi_key_acid.clj:40-41). Group g's txns are
    ``multi_register_history(per_group, n_procs, n_keys, n_values, seed +
    g, n_readers=n_procs // 2)`` on processes g * n_procs .. g * n_procs +
    n_procs - 1, their values lifted as [g, txn], and the groups'
    ops interleave in a seeded random order that keeps each group's own
    order."""
    groups = [multi_register_history(per_group, n_procs, n_keys, n_values,
                                     seed + g, n_readers=n_procs // 2)
              for g in range(n_groups)]
    order = np.random.default_rng(seed).permutation(
        np.repeat(np.arange(n_groups), [len(h) for h in groups]))
    at = [0] * n_groups
    out = []
    for g in order.tolist():
        op = groups[g][at[g]]
        at[g] += 1
        out.append({**op, "process": g * n_procs + op["process"],
                    "value": [g, op["value"]]})
    return out


def corrupt_txn_reads(history: list[dict], n: int = 2, seed: int = 0,
                      n_values: int = 5) -> list[dict]:
    """A copy of a multi-register ``history`` in which ``n`` seeded ok
    read txns each read one key as a value below ``n_values`` that no
    write could have left there, so the history is invalid and stays
    within the packed encoding. For read R of key k the values a
    linearization can show are those of the writes to k invoked before R
    completed and not followed, for certain, by another write to k that
    completed before R was invoked (a crashed write may take effect at
    any later point); a read whose keys all could show every value is
    left alone."""
    out = [dict(op) for op in history]
    done: dict = {}
    opened: dict = {}
    for i, op in enumerate(out):
        p = op.get("process")
        if op.get("type") == "invoke":
            opened[p] = i
        elif p in opened:
            done[opened.pop(p)] = (i, op.get("type"))
    inf = float("inf")
    writes: dict = {}   # key -> [(invoke, end, value)]
    reads = []          # (invoke, ok)
    for i, (j, typ) in sorted(done.items()):
        mops = out[j]["value"] or []
        if typ == "ok" and mops and mops[0][0] == "r":
            reads.append((i, j))
        elif typ in ("ok", "info"):
            for f, k, v in mops:
                if f == "w":
                    writes.setdefault(k, []).append(
                        (i, j if typ == "ok" else inf, v))
    rng = np.random.default_rng(seed)
    left = n
    for r in rng.permutation(len(reads)).tolist():
        if left == 0:
            break
        r0, r1 = reads[r]
        mops = [list(m) for m in out[r1]["value"]]
        for m in mops:
            ws = writes.get(m[1], [])
            # the latest invoke of a write to k certainly before R
            last = max((w0 for w0, w1, _ in ws if w1 < r0), default=-1)
            seen = {v for w0, w1, v in ws if w0 < r1 and w1 >= last}
            free = [v for v in range(n_values) if v not in seen]
            if free:
                m[2] = free[int(rng.integers(len(free)))]
                out[r1]["value"] = mops
                left -= 1
                break
    return out


def corrupt_txn_keys(history: list[dict], keys, n: int = 1, seed: int = 0,
                     n_values: int = 5) -> list[dict]:
    """A copy of a lifted multi-register ``history`` in which each key of
    ``keys`` has ``n`` impossible reads: :func:`corrupt_txn_reads` on the
    key's own sub-history, with seed ``seed + k`` for an int key k."""
    out = [dict(op) for op in history]
    for k in keys:
        at = [i for i, op in enumerate(out)
              if isinstance(op.get("value"), list)
              and len(op["value"]) == 2 and op["value"][0] == k]
        sub = [{**out[i], "value": out[i]["value"][1]} for i in at]
        bad = corrupt_txn_reads(sub, n=n,
                                seed=seed + k if isinstance(k, int) else seed,
                                n_values=n_values)
        for i, op, op2 in zip(at, sub, bad):
            if op2["value"] != op["value"]:
                out[i]["value"] = [k, op2["value"]]
    return out


def crash_late_writes(history: list[dict], n: int = 5,
                      spread: int = 50) -> list[dict]:
    """A copy of a multi-register ``history`` in which ``n`` of the last
    ``spread`` ok writes, evenly spaced, crash (``info``): a crashed
    write holds its slot for good, so the stream's slots grow by up to
    ``n``."""
    w = [i for i, op in enumerate(history)
         if op["type"] == "ok" and op["value"][0][0] == "w"]
    pick = set(w[-spread::spread // n][:n])
    return [dict(op, type="info") if i in pick else op
            for i, op in enumerate(history)]


def _txn_history(txns) -> list[dict]:
    """Runs (process, invoke micro-ops, ok micro-ops) txns one after the
    other: an invoke and its ok each, with times 2i and 2i + 1."""
    history: list[dict] = []
    for t, (proc, mops_inv, mops_ok) in enumerate(txns):
        history.append({"type": "invoke", "process": proc,
                        "value": mops_inv, "time": 2 * t})
        history.append({"type": "ok", "process": proc,
                        "value": mops_ok, "time": 2 * t + 1})
    return history


def _place_pairs(main: list, pairs: list, wide: bool) -> list:
    """``main`` with crossed pair q's two txns appended at the end (not
    ``wide``) or put at positions 1000q + 50 and 1000q + 950."""
    if not wide:
        return main + [t for pair in pairs for t in pair]
    n = len(main) + 2 * len(pairs)
    if pairs and 1000 * (len(pairs) - 1) + 950 >= n:
        raise ValueError(f"{len(pairs)} wide pairs need more than "
                         f"{1000 * (len(pairs) - 1) + 950} txns")
    at = {}
    for q, (a, b) in enumerate(pairs):
        at[1000 * q + 50], at[1000 * q + 950] = a, b
    rest = iter(main)
    return [at[i] if i in at else next(rest) for i in range(n)]


# copied from bench.py:551-580 (``_elle_history``), with ``wide``
def elle_history(n_txns: int, n_keys: int = 100, crossed_pairs: int = 0,
                 wide: bool = False) -> list[dict]:
    """Serializable list-append history (txn i appends i to key i %
    n_keys and reads the key back, on process i % 10); ``crossed_pairs``
    adds pairs of mutually-observing txns on fresh keys (wr edges both
    ways: G1c 2-cycles), which defeats the acyclicity screen and forces
    the cycle search. The pairs go at the end, as the benchmark has them;
    with ``wide`` pair q's txns sit at positions 1000q + 50 and
    1000q + 950, so each cycle spans a φ-interval of 900 txns and makes a
    cluster of about 900 nodes, with a realtime cycle too."""
    main = []
    for i in range(n_txns):
        k = i % n_keys
        seen = list(range(k, i + 1, n_keys))  # every append to k so far
        main.append((i % 10, [["append", k, i], ["r", k, None]],
                     [["append", k, i], ["r", k, seen]]))
    pairs = []
    for p in range(crossed_pairs):
        ka, kb = 10_000 + 2 * p, 10_001 + 2 * p
        va, vb = 2_000_000 + 2 * p, 2_000_001 + 2 * p
        # A observes B's append before B commits; B observes A's: a wr
        # cycle between the two on fresh keys
        pairs.append(((10, [["append", ka, va], ["r", kb, None]],
                       [["append", ka, va], ["r", kb, [vb]]]),
                      (11, [["append", kb, vb], ["r", ka, None]],
                       [["append", kb, vb], ["r", ka, [va]]])))
    return _txn_history(_place_pairs(main, pairs, wide))


def rw_register_history(n_txns: int, n_keys: int = 20, crossed_pairs: int = 0,
                        seed: int = 7) -> list[dict]:
    """Serial rw-register history: each txn runs one to three reads or
    writes of random keys on process i % 10, writes unique per key, reads
    answering the key's last write (None before any). ``crossed_pairs``
    adds pairs of txns on fresh keys that each read the other's write (a
    wr cycle: G1c), placed as :func:`elle_history` places them with
    ``wide``."""
    rng = np.random.default_rng(seed)
    state: dict = {}
    count: dict = {}
    main = []
    for i in range(n_txns):
        inv, ok = [], []
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(n_keys))
            if rng.random() < 0.5:
                inv.append(["r", k, None])
                ok.append(["r", k, state.get(k)])
            else:
                count[k] = count.get(k, 0) + 1
                state[k] = count[k]
                inv.append(["w", k, count[k]])
                ok.append(["w", k, count[k]])
        main.append((i % 10, inv, ok))
    pairs = []
    for p in range(crossed_pairs):
        ka, kb = 10_000 + 2 * p, 10_001 + 2 * p
        pairs.append(((10, [["w", ka, 1], ["r", kb, None]],
                       [["w", ka, 1], ["r", kb, 1]]),
                      (11, [["w", kb, 1], ["r", ka, None]],
                       [["w", kb, 1], ["r", ka, 1]])))
    return _txn_history(_place_pairs(main, pairs, wide=True))


def random_trim_graph(log_n: int, log_e: int, seed: int):
    """A seeded graph for the trim: (n, src, dst) with n = 2^log_n nodes
    and 2^log_e edges between random ends, 1 % of them pointing from the
    larger id to the smaller (cycles), the rest the other way."""
    rng = np.random.default_rng(seed)
    rs, rd = rng.integers(0, 1 << log_n, (2, 1 << log_e))
    fwd = rng.random(1 << log_e) >= 0.01
    return (1 << log_n, np.where(fwd, np.minimum(rs, rd), np.maximum(rs, rd)),
            np.where(fwd, np.maximum(rs, rd), np.minimum(rs, rd)))


def chain_clusters(n_clusters: int, n_local: int, seed: int, cyclic: bool):
    """Seeded clusters for the screen: (cid, src, dst) int32, each cluster
    the chain 0 -> 1 -> ... -> V-1 (a Kahn peel's longest) plus 3V random
    forward edges; with ``cyclic``, one backward edge from V-1 in every
    other cluster. Rows in random order."""
    B, V = n_clusters, n_local
    rng = np.random.default_rng(seed)
    a = rng.integers(0, V, (B, 3 * V))
    b = rng.integers(0, V, (B, 3 * V))
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    chain_s = np.broadcast_to(np.arange(V - 1), (B, V - 1))
    src = np.concatenate([lo, chain_s], axis=1)
    dst = np.concatenate([hi, chain_s + 1], axis=1)
    cid = np.broadcast_to(np.arange(B)[:, None], src.shape)
    keep = src != dst
    cid, src, dst = cid[keep], src[keep], dst[keep]
    if cyclic:
        back = np.arange(0, B, 2)
        cid = np.concatenate([cid, back])
        src = np.concatenate([src, np.full(len(back), V - 1)])
        dst = np.concatenate([dst, rng.integers(0, V - 1, len(back))])
    perm = rng.permutation(len(cid))
    return tuple(np.ascontiguousarray(x[perm]).astype(np.int32)
                 for x in (cid, src, dst))


# bench.py:493-513's shape (BASELINE config 4), with planted faults
def set_full_history(n_els: int = 20_000, read_every: int = 50,
                     n_lost: int = 0, n_stale: int = 0, seed: int = 0,
                     t0: int = 0) -> list[dict]:
    """Adds of 0 .. n_els - 1 from 5 processes, each acknowledged, and a
    read of the whole set by process 5 after every ``read_every`` adds;
    each op takes one tick of time from ``t0`` on. ``n_lost`` seeded
    elements vanish from every read after the first that saw them (lost);
    ``n_stale`` others are missing from the first read after their add
    only (stale: present again later)."""
    rng = np.random.default_rng(seed)
    picks = rng.choice(max(1, n_els - 2 * read_every), n_lost + n_stale,
                       replace=False).tolist()
    lost, stale = set(picks[:n_lost]), set(picks[n_lost:])
    history: list[dict] = []
    present: list[int] = []
    seen: set = set()
    t = t0
    for v in range(n_els):
        history.append({"type": "invoke", "process": v % 5, "f": "add",
                        "value": v, "time": t})
        history.append({"type": "ok", "process": v % 5, "f": "add",
                        "value": v, "time": t + 1})
        present.append(v)
        t += 2
        if (v + 1) % read_every == 0:
            fresh = present[-read_every:]
            drop = (lost & seen) | (stale & set(fresh))
            value = ([x for x in present if x not in drop] if drop
                     else list(present))
            seen.update(fresh)
            history.append({"type": "invoke", "process": 5, "f": "read",
                            "value": None, "time": t})
            history.append({"type": "ok", "process": 5, "f": "read",
                            "value": value, "time": t + 1})
            t += 2
    return history


# the nodes of a run's cluster: five, as the reference's suites default to
NODES = ("n1", "n2", "n3", "n4", "n5")


def stamp_times(history: list[dict], seed: int = 0,
                gap_ns: int = 1_000_000) -> list[dict]:
    """A copy of ``history`` whose ops carry a ``time`` in nanoseconds, as
    a run's relative clock records them: seeded steps between consecutive
    ops, uniform in [1, 2 * ``gap_ns``)."""
    steps = np.random.default_rng(seed).integers(1, 2 * gap_ns,
                                                 len(history))
    return [{**op, "time": t}
            for op, t in zip(history, np.cumsum(steps).tolist())]


def with_nemesis(history: list[dict], windows, offsets_at=(),
                 seed: int = 0) -> tuple[list[dict], list[dict]]:
    """A copy of a timed ``history`` with a nemesis's ops in it, and the
    ``faults.jsonl`` rows a run's fault registry would hold for them.
    Each ``(lo, hi, start_f, stop_f)`` of ``windows`` puts an info op
    ``start_f`` before op ``lo`` and ``stop_f`` before op ``hi`` (or last,
    past the end), each at the time of the op it precedes; a window
    whose ``start_f`` names a fault (``nemesis.faults.classify``) gets an
    inject row and a heal row, stamped in wall seconds. Each index of
    ``offsets_at`` puts a ``check-offsets`` op there, carrying seeded
    ``clock-offsets`` (ms) of every node of ``NODES``. Nemesis ops carry
    no [key, value] tuple, so a lifted history's split leaves them out."""
    from jepsen_tpu_torch.nemesis.faults import classify
    rng = np.random.default_rng(seed)
    end = history[-1].get("time", 0) if history else 0
    before: dict[int, list[dict]] = {}
    rows: list[dict] = []

    def put(i, f, value):
        t = history[i]["time"] if i < len(history) else end
        op = {"type": "info", "process": "nemesis", "f": f, "value": value,
              "time": t}
        before.setdefault(min(i, len(history)), []).append(op)
        return t

    for n, (lo, hi, start_f, stop_f) in enumerate(windows):
        t0 = put(lo, start_f, None)
        t1 = put(hi, stop_f, None)
        phase, kind = classify(start_f)
        if phase == "begin":
            rows.append({"op": "inject", "id": n, "kind": kind,
                         "f": start_f, "value": None,
                         "time": 1.7e9 + t0 / 1e9})
            rows.append({"op": "heal", "id": n, "via": "nemesis",
                         "time": 1.7e9 + t1 / 1e9})
    for i in offsets_at:
        put(i, "check-offsets", {"clock-offsets": {
            node: round(float(rng.normal(0.0, 50.0)), 3) for node in NODES}})
    out: list[dict] = []
    for i, op in enumerate(history):
        out += before.get(i, [])
        out.append(op)
    out += before.get(len(history), [])
    return out, rows
