"""Long-fork anomaly workload (reference:
jepsen/src/jepsen/tests/long_fork.clj).

Forbidden under snapshot isolation, long fork is the "parallel snapshot
isolation" anomaly: writes w1, w2 to different keys, and two reads such
that one observes w1 but not w2 and the other observes w2 but not w1 —
the reads sit on incomparable forks of history.

Keys come in groups of ``group_size``; each key is written exactly once
(value 1) by a single-write txn; read txns read a whole group. The checker
compares every pair of reads in a group: presence vectors must be totally
ordered (reference read-compare, long_fork.clj:158+). The pairwise compare
is a data-parallel boolean-matrix scan; on large histories it runs as a
vectorized numpy comparison (device offload unnecessary at this size).

The port of jepsen_tpu/workloads/long_fork.py.
"""
from __future__ import annotations

from collections import defaultdict

import numpy as np

from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.txn import _hk


# copied from jepsen_tpu/workloads/long_fork.py:27-121
def group_of(k: int, group_size: int) -> int:
    return k // group_size


def group_keys(g: int, group_size: int) -> list[int]:
    return list(range(g * group_size, (g + 1) * group_size))


def generator(group_size: int = 3):
    """Writes each key once; reads a whole group as one txn
    (long_fork.clj:117-156)."""
    state = {"writes_left": [], "next_group": 0}

    def one(test, ctx):
        if not state["writes_left"] and ctx.rng.random() < 0.5:
            state["writes_left"] = group_keys(state["next_group"], group_size)
            state["next_group"] += 1
        if state["writes_left"] and ctx.rng.random() < 0.7:
            k = state["writes_left"].pop(0)
            return {"f": "txn", "value": [["w", k, 1]]}
        # read a group that has (at least partially) been written
        g = ctx.rng.randrange(max(1, state["next_group"]))
        return {"f": "txn",
                "value": [["r", k, None] for k in group_keys(g, group_size)]}

    return gen.Fn(one)


class LongForkChecker(Checker):
    """Pairwise read-comparability per group (long_fork.clj:311-325)."""

    def __init__(self, group_size: int = 3):
        self.group_size = group_size

    def name(self):
        return "long-fork"

    def check(self, test, history, opts):
        reads_by_group: dict[int, list[tuple[dict, tuple]]] = defaultdict(list)
        early_read_errors = []
        # early/late accounting (long_fork.clj:290-321): a read observing
        # nothing yet (all nil) or everything (all written) can't witness
        # a fork — report how much of the read budget was wasted on them
        reads_count = early_reads = late_reads = 0
        for op in history:
            if op.get("type") != "ok" or op.get("f") != "txn":
                continue
            mops = op.get("value") or []
            rs = [m for m in mops if m[0] == "r"]
            if not rs or len(rs) != len(mops):
                continue  # write txn
            reads_count += 1
            if all(m[2] is None for m in rs):
                early_reads += 1
            elif all(m[2] is not None for m in rs):
                late_reads += 1
            keys = sorted(_hk(m[1]) for m in rs)
            g = group_of(keys[0], self.group_size)
            if keys != group_keys(g, self.group_size):
                early_read_errors.append({"op": op, "error": "bad-key-group"})
                continue
            vec = tuple(m[2] if m[2] is not None else 0
                        for m in sorted(rs, key=lambda m: _hk(m[1])))
            reads_by_group[g].append((op, vec))

        forks = []
        for g, reads in reads_by_group.items():
            if len(reads) < 2:
                continue
            mat = np.asarray([v for _, v in reads], dtype=np.int8)
            # r_i <= r_j elementwise, as a [R, R] boolean matrix
            le = (mat[:, None, :] <= mat[None, :, :]).all(axis=2)
            incomparable = ~(le | le.T)
            ii, jj = np.nonzero(np.triu(incomparable, k=1))
            for i, j in zip(ii.tolist(), jj.tolist()):
                forks.append({"group": g,
                              "reads": [reads[i][0], reads[j][0]]})
        return {
            "valid?": not (forks or early_read_errors),
            "forks": forks[:10],
            "fork-count": len(forks),
            "read-errors": early_read_errors[:10],
            "reads-count": reads_count,
            "early-read-count": early_reads,
            "late-read-count": late_reads,
        }


def checker(group_size: int = 3) -> Checker:
    return LongForkChecker(group_size)


def workload(test: dict | None = None, group_size: int = 3, **_) -> dict:
    return {"generator": generator(group_size),
            "checker": checker(group_size)}
