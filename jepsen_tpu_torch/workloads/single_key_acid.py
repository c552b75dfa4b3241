"""Single-key ACID workload (reference:
yugabyte/src/yugabyte/single_key_acid.clj — concurrent reads, writes and
UPDATE-IF (cas) against independent single rows, verified linearizable).

Per key group of 2N workers, the first N write/cas and the last N read
(gen.reserve), mirroring the reference's worker split. The model is a
CAS register initialized to 0 (single_key_acid.clj:40
model/cas-register 0), checked per key on the batched device kernel.

The port of jepsen_tpu/workloads/single_key_acid.py. ``device`` passes
through to the checker (None: the card; the tests pass "cpu").
"""
from __future__ import annotations

import itertools

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.models import CASRegister


# copied from jepsen_tpu/workloads/single_key_acid.py:21-58
def r(test, ctx):
    return {"f": "read", "value": None}


def w(test, ctx):
    return {"f": "write", "value": ctx.rng.randint(0, 4)}


def cas(test, ctx):
    return {"f": "cas",
            "value": [ctx.rng.randint(0, 4), ctx.rng.randint(0, 4)]}


def workload(test: dict | None = None, per_key_limit: int = 40,
             process_limit: int | None = 20, accelerator: str = "auto",
             device=None, **_) -> dict:
    test = test or {}
    n = len(test.get("nodes") or []) or 5
    group = 2 * n  # single_key_acid.clj:33 concurrent-generator (* 2 n)

    def key_gen(k):
        # first n workers write/cas (1:2 mix), the rest read
        g = gen.reserve(n, gen.mix([gen.Fn(w), gen.Fn(cas), gen.Fn(cas)]),
                        gen.Fn(r))
        g = gen.limit(per_key_limit, g)
        if process_limit is not None:
            g = gen.process_limit(process_limit, g)
        return g

    return {
        "generator": independent.concurrent_generator(
            group, itertools.count(), key_gen),
        "checker": independent.checker(chk.compose({
            "linear": linearizable(model=CASRegister(0),
                                   accelerator=accelerator, device=device),
            "timeline": chk.timeline_html(),
        })),
    }
