"""Seeded synthetic histories for smoke runs and tests: single-register
histories for the linearizability check, list-append and rw-register txn
histories for the Elle checks."""
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
