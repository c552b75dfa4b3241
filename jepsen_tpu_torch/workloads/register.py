"""Linearizable-register workload (the port of
jepsen_tpu/workloads/register.py; reference:
jepsen/src/jepsen/tests/linearizable_register.clj).

Per-key r/w/cas mix over an unbounded rotating key space via
jepsen_tpu.independent, checked per key with the linearizability checker —
the key-batched matrix screen on the card (BASELINE config 3). History-length
discipline mirrors the reference: per-key op limit (default 20) and
process limit keep each sub-history tractable for exact search, while the
batched device kernel handles far longer keys when selected.
"""
from __future__ import annotations

import itertools

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.models import CASRegister

# copied from jepsen_tpu/workloads/register.py:22-63, with a device
# argument for the checker


def r(test, ctx):
    return {"f": "read", "value": None}


def w(test, ctx):
    return {"f": "write", "value": ctx.rng.randint(0, 4)}


def cas(test, ctx):
    return {"f": "cas", "value": [ctx.rng.randint(0, 4), ctx.rng.randint(0, 4)]}


def workload(test: dict | None = None, per_key_limit: int = 20,
             process_limit: int | None = 20, accelerator: str = "auto",
             ops: tuple = ("r", "w", "cas"), device=None, **_) -> dict:
    """``ops`` selects the op mix — clients whose transport can't
    express CAS (hazelcast's REST map API) run the r/w subset against
    the same linearizable-register checker. ``device`` passes through to
    the checker (None: the card; the tests pass "cpu")."""
    test = test or {}
    n = test.get("concurrency", 5)
    group = max(2, min(10, n))
    fns = {"r": gen.Fn(r), "w": gen.Fn(w), "cas": gen.Fn(cas)}

    def key_gen(k):
        g = gen.mix([fns[o] for o in ops])
        g = gen.limit(per_key_limit, g)
        if process_limit is not None:
            g = gen.process_limit(process_limit, g)
        return g

    return {
        "generator": independent.concurrent_generator(
            group, itertools.count(), key_gen),
        # per-key linear + timeline composition, exactly the reference's
        # (independent/checker (checker/compose {:linear ... :timeline
        # (timeline/html)})) (linearizable_register.clj:30-41)
        "checker": independent.checker(chk.compose({
            "linear": linearizable(model=CASRegister(),
                                   accelerator=accelerator, device=device),
            "timeline": chk.timeline_html(),
        })),
    }
