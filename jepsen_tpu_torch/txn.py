"""Transaction micro-op helpers for the Elle checkers (reference:
txn/src/jepsen/txn.clj). A transactional op's value is a list of
micro-ops ``[f, k, v]``, e.g. ``[["r", "x", [1, 2]], ["append", "x", 3]]``.
"""
from __future__ import annotations

# copied from jepsen_tpu/txn.py:11-12
READ_FS = ("r", "read")
WRITE_FS = ("w", "write", "append")


# copied from jepsen_tpu/txn.py:42-54
def ext_reads(txn: list) -> dict:
    """External reads: keys read before any write in this txn
    (txn.clj:24-39). {k: value-read}"""
    out: dict = {}
    written: set = set()
    for f, k, v in txn:
        kk = _hk(k)
        if f in READ_FS:
            if kk not in written and kk not in out:
                out[kk] = v
        else:
            written.add(kk)
    return out


# copied from jepsen_tpu/txn.py:57-64
def ext_writes(txn: list) -> dict:
    """External writes: the final write to each key (txn.clj:41-53).
    {k: value-written} (for append, the appended element)."""
    out: dict = {}
    for f, k, v in txn:
        if f in WRITE_FS:
            out[_hk(k)] = v
    return out


# copied from jepsen_tpu/txn.py:67-78
def int_write_mops(txn: list) -> list:
    """Writes overwritten within their own txn (txn.clj:55-73). For
    append-only workloads this is empty (appends accumulate)."""
    out = []
    last_write: dict = {}
    for i, (f, k, v) in enumerate(txn):
        if f in ("w", "write"):
            kk = _hk(k)
            if kk in last_write:
                out.append(txn[last_write[kk]])
            last_write[kk] = i
    return out


# copied from jepsen_tpu/txn.py:81-82
def _hk(k):
    """A hashable form of key ``k`` (lists become tuples)."""
    return tuple(k) if isinstance(k, list) else k
