"""CP-subsystem workload kits (reference: the hazelcast suite's
workloads map, hazelcast/src/jepsen/hazelcast.clj:668-775 — locks over
the CP FencedLock in four model strengths, a CP counting semaphore,
unique-id generation over AtomicLongs, and a CAS register over a CP
AtomicLong).

Generators mirror the reference's shapes: lock threads cycle
acquire→release (twice each for the reentrant variants,
hazelcast.clj:698-706), id threads emit ``generate`` ops, cas threads
mix read/write/cas. Ownership in the models is the op's process (see
models.OwnerMutex for why that replaces the reference's uid→client side
map); fenced clients return the fencing token as the ok-acquire value,
which the fence-aware models check for monotonicity.

The port of jepsen_tpu/workloads/cp_lock.py.
"""
from __future__ import annotations

import random

from jepsen_tpu_torch import checker as chk
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.models import (AcquiredPermits, CASRegister, FencedMutex,
# copied from jepsen_tpu/workloads/cp_lock.py:23-111
                               Mutex, OwnerMutex, ReentrantFencedMutex,
                               ReentrantMutex)

NUM_PERMITS = 2         # hazelcast.clj:55 num-permits
MAX_HOLDS = 2           # hazelcast.clj:53 reentrant-lock-acquire-count


def _lock_gen(acquires: int = 1, dt: float = 0.5):
    ops = ([{"f": "acquire", "value": None}] * acquires
           + [{"f": "release", "value": None}] * acquires)
    return gen.each_thread(gen.stagger(dt, gen.cycle(gen.Seq(ops))))


_MODELS = {
    "lock": lambda: Mutex(),
    "cp-lock": lambda: OwnerMutex(),
    "reentrant-cp-lock": lambda: ReentrantMutex(max_holds=MAX_HOLDS),
    "fenced-lock": lambda: FencedMutex(),
    "reentrant-fenced-lock":
        lambda: ReentrantFencedMutex(max_holds=MAX_HOLDS),
}


def lock_workload(test: dict | None = None, accelerator: str = "auto",
                  flavor: str = "cp-lock", **_) -> dict:
    """acquire/release against one named lock, checked linearizable
    against the flavor's mutex model (hazelcast.clj:668-733):

    - ``lock`` — plain knossos mutex (the AP lock test's model)
    - ``cp-lock`` — owner-aware, non-reentrant
    - ``reentrant-cp-lock`` — owner-aware, ≤2 holds (double
      acquire/release cycles)
    - ``fenced-lock`` / ``reentrant-fenced-lock`` — additionally check
      fencing-token monotonicity from the ok-acquire values
    """
    acquires = 2 if flavor.startswith("reentrant") else 1
    model = _MODELS[flavor]()
    return {
        "generator": _lock_gen(acquires),
        "checker": linearizable(model=model, accelerator=accelerator),
        "stats_ungated_fs": ("acquire",),   # busy-lock acquires fail
    }


def semaphore_workload(test: dict | None = None, accelerator: str = "auto",
                       **_) -> dict:
    """CP counting semaphore: concurrent acquire/release against
    NUM_PERMITS permits, checked against the acquired-permits model
    (hazelcast.clj:735-744)."""
    return {
        "generator": _lock_gen(1),
        "checker": linearizable(model=AcquiredPermits(permits=NUM_PERMITS),
                                accelerator=accelerator),
        "stats_ungated_fs": ("acquire",),
    }


def ids_workload(test: dict | None = None, accelerator: str = "auto",
                 **_) -> dict:
    """Unique-id generation (hazelcast.clj:745-752,766-775
    cp-id-gen-long / atomic-long-ids): every thread asks for fresh ids;
    the checker asserts global uniqueness of acknowledged ids."""
    return {
        "generator": gen.each_thread(gen.stagger(
            0.5, gen.cycle(gen.Seq([{"f": "generate", "value": None}])))),
        "checker": chk.unique_ids(),
    }


def cas_long_workload(test: dict | None = None, accelerator: str = "auto",
                      **_) -> dict:
    """CAS register over a CP AtomicLong (hazelcast.clj:753-765
    cp-cas-long): read / write / cas mix, linearizable against a CAS
    register that starts at 0 (a fresh AtomicLong reads 0)."""
    rng = random.Random()

    def w(test=None, ctx=None):
        return {"f": "write", "value": rng.randint(0, 4)}

    def c(test=None, ctx=None):
        return {"f": "cas", "value": [rng.randint(0, 4), rng.randint(0, 4)]}

    return {
        "generator": gen.each_thread(gen.stagger(0.5, gen.cycle(gen.mix([
            {"f": "read", "value": None}, gen.Fn(w), gen.Fn(c)])))),
        "checker": linearizable(model=CASRegister(0),
                                accelerator=accelerator),
        "stats_ungated_fs": ("cas",),
    }
