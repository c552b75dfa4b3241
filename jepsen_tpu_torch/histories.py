"""Seeded synthetic register histories for smoke runs and tests."""
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
