"""Multi-key ACID workload (reference:
yugabyte/src/yugabyte/multi_key_acid.clj — transactional read/write
batches over a composite-key table, verified linearizable against a
multi-register model).

Per independent key group: read txns over a random nonempty subset of
the 3-key range, write txns assigning random values to a random subset.
The checker is the linearizability search against
models.MultiRegister — whose int encoding ((V+1)^K = 216 states at the
workload shape) rides the dense-table device kernel, so the per-key
histories batch onto the TPU like the register workload's.

The port of jepsen_tpu/workloads/multi_key_acid.py. ``device`` passes
through to the checker (None: the card; the tests pass "cpu").
"""
from __future__ import annotations

import itertools

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.models import MultiRegister

# copied from jepsen_tpu/workloads/multi_key_acid.py:23-69
KEY_RANGE = 3      # multi_key_acid.clj:40 key-range
VAL_RANGE = 5      # multi_key_acid.clj:41 rand-val


def _subset(rng):
    n = rng.randint(1, KEY_RANGE)
    return sorted(rng.sample(range(KEY_RANGE), n))


def r(test, ctx):
    """Read a random nonempty subset of keys (multi_key_acid.clj:43-48)."""
    return {"f": "txn",
            "value": [["r", k, None] for k in _subset(ctx.rng)]}


def w(test, ctx):
    """Write a random nonempty subset of keys (multi_key_acid.clj:50-54)."""
    return {"f": "txn",
            "value": [["w", k, ctx.rng.randint(0, VAL_RANGE - 1)]
                      for k in _subset(ctx.rng)]}


def workload(test: dict | None = None, per_key_limit: int = 20,
             process_limit: int | None = 20, accelerator: str = "auto",
             device=None, **_) -> dict:
    test = test or {}
    n = len(test.get("nodes") or []) or 5
    group = 2 * n  # multi_key_acid.clj:59 concurrent-generator (* 2 n)

    def key_gen(k):
        g = gen.reserve(n, gen.Fn(r), gen.Fn(w))
        g = gen.limit(per_key_limit, g)
        if process_limit is not None:
            g = gen.process_limit(process_limit, g)
        return g

    return {
        "txn-mode": "multi",  # fake-mode client dispatch marker
        "generator": independent.concurrent_generator(
            group, itertools.count(), key_gen),
        "checker": independent.checker(chk.compose({
            "linear": linearizable(model=MultiRegister(),
                                   accelerator=accelerator,
                                   multi_shape=(KEY_RANGE, VAL_RANGE),
                                   device=device),
            "timeline": chk.timeline_html(),
        })),
    }
