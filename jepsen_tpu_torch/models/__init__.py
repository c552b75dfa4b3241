"""Consistency models for the register linearizability check.

Two forms side by side, as in the JAX package: the object models
(:class:`CASRegister`, :class:`MultiRegister`, the mutexes, queues and
sets), which the CPU searches step, and :class:`IntSpec`, whose
``step_ids`` is int32 torch arithmetic over tensors of any shape — the
form the transfer-matrix path and the frontier scans consume.

A spec's ``step_ids`` carries ``kernel_model``: the code and shape of the
transition the frontier kernels compute on the card (``KERNEL_CAS``, or
``KERNEL_MULTI_REGISTER`` with its keys and values), or no such attribute
when the kernels have no copy of it.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable

import torch


# copied from jepsen_tpu/models/__init__.py:22-43
@dataclass(frozen=True)
class Inconsistent:
    msg: str

    def is_inconsistent(self) -> bool:
        return True


def inconsistent(msg: str) -> Inconsistent:
    return Inconsistent(msg)


def is_inconsistent(m) -> bool:
    return isinstance(m, Inconsistent)


class Model:
    """Immutable state machine. Subclasses must be hashable and implement
    step(op) -> Model | Inconsistent."""

    def step(self, op: dict) -> "Model | Inconsistent":
        raise NotImplementedError


# copied from jepsen_tpu/models/__init__.py:46-69
@dataclass(frozen=True)
class NoOp(Model):
    """Accepts every op."""

    def step(self, op):
        return self


@dataclass(frozen=True)
class Register(Model):
    """A read/write register (knossos.model/register)."""

    value: Any = None

    def step(self, op):
        f, v = op.get("f"), op.get("value")
        if f == "write":
            return Register(v)
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from register {self.value!r}")
        return inconsistent(f"unknown op f={f!r}")


# copied from jepsen_tpu/models/__init__.py:71-92
@dataclass(frozen=True)
class CASRegister(Model):
    """A register supporting read/write/cas (knossos.model/cas-register).
    cas value is a pair [old, new]."""

    value: Any = None

    def step(self, op):
        f, v = op.get("f"), op.get("value")
        if f == "write":
            return CASRegister(v)
        if f == "cas":
            old, new = v
            if old == self.value:
                return CASRegister(new)
            return inconsistent(f"can't CAS {self.value!r} from {old!r} to {new!r}")
        if f == "read":
            if v is None or v == self.value:
                return self
            return inconsistent(f"can't read {v!r} from register {self.value!r}")
        return inconsistent(f"unknown op f={f!r}")


# copied from jepsen_tpu/models/__init__.py:95-367
@dataclass(frozen=True)
class Mutex(Model):
    """A single mutex (knossos.model/mutex): acquire/release."""

    locked: bool = False

    def step(self, op):
        f = op.get("f")
        if f == "acquire":
            if self.locked:
                return inconsistent("already held")
            return Mutex(True)
        if f == "release":
            if not self.locked:
                return inconsistent("not held")
            return Mutex(False)
        return inconsistent(f"unknown op f={f!r}")


_INVALID_FENCE = 0


def _op_fence(op) -> int:
    """Fence token from an acquire completion (hazelcast.clj get-fence
    :564-566): ok acquires carry the fence as the op value; anything
    else (pending/indeterminate acquires, releases) is the invalid
    fence 0."""
    v = op.get("value")
    if isinstance(v, dict):
        v = v.get("fence")
    return v if isinstance(v, int) and not isinstance(v, bool) \
        else _INVALID_FENCE


def _op_client(op):
    """Lock-owner identity. The reference maps invocation uids to client
    names through a side map (hazelcast.clj:514-516) because its JVM
    clients multiplex threads; here each logical process IS one client
    session, so the process id is the owner."""
    v = op.get("value")
    if isinstance(v, dict) and v.get("client") is not None:
        return v.get("client")
    return op.get("process")


@dataclass(frozen=True)
class OwnerMutex(Model):
    """Owner-aware non-reentrant mutex (hazelcast.clj OwnerAwareMutex
    :539-555): acquire only when free, release only by the holder."""

    owner: Any = None

    def step(self, op):
        f, c = op.get("f"), _op_client(op)
        if c is None:
            return inconsistent("no owner!")
        if f == "acquire":
            if self.owner is None:
                return OwnerMutex(c)
            return inconsistent(f"{c!r} can't acquire: {self.owner!r} holds")
        if f == "release":
            if self.owner is None or self.owner != c:
                return inconsistent(f"{c!r} can't release: not holder")
            return OwnerMutex(None)
        return inconsistent(f"unknown op f={f!r}")


@dataclass(frozen=True)
class ReentrantMutex(Model):
    """Reentrant mutex with a bounded hold count (hazelcast.clj
    ReentrantMutex :516-533, reentrant-lock-acquire-count=2): the holder
    may re-acquire up to ``max_holds`` times; releases peel one hold."""

    owner: Any = None
    holds: int = 0
    max_holds: int = 2

    def step(self, op):
        f, c = op.get("f"), _op_client(op)
        if c is None:
            return inconsistent("no owner!")
        if f == "acquire":
            if self.holds < self.max_holds and \
                    (self.owner is None or self.owner == c):
                return ReentrantMutex(c, self.holds + 1, self.max_holds)
            return inconsistent(f"{c!r} can't acquire {self!r}")
        if f == "release":
            if self.owner is None or self.owner != c:
                return inconsistent(f"{c!r} can't release {self!r}")
            return ReentrantMutex(None if self.holds == 1 else self.owner,
                                  self.holds - 1, self.max_holds)
        return inconsistent(f"unknown op f={f!r}")


@dataclass(frozen=True)
class FencedMutex(Model):
    """Non-reentrant mutex checking fencing-token monotonicity
    (hazelcast.clj FencedMutex :569-589): an acquire may carry an
    unknown fence (0, e.g. a crashed acquire linearized late) or a
    fence strictly greater than every fence seen so far."""

    owner: Any = None
    fence: int = _INVALID_FENCE

    def step(self, op):
        f, c = op.get("f"), _op_client(op)
        if c is None:
            return inconsistent("no owner!")
        if f == "acquire":
            fence = _op_fence(op)
            if self.owner is not None:
                return inconsistent(f"{c!r} can't acquire {self!r}")
            if fence == _INVALID_FENCE:
                return FencedMutex(c, self.fence)
            if fence > self.fence:
                return FencedMutex(c, fence)
            return inconsistent(f"fence {fence} not above {self.fence}")
        if f == "release":
            if self.owner is None or self.owner != c:
                return inconsistent(f"{c!r} can't release {self!r}")
            return FencedMutex(None, self.fence)
        return inconsistent(f"unknown op f={f!r}")


@dataclass(frozen=True)
class ReentrantFencedMutex(Model):
    """Reentrant fenced mutex (hazelcast.clj ReentrantFencedMutex
    :597-625): bounded re-acquire, with fences monotone across lock
    ownership and constant within one held incarnation (re-acquiring
    while holding returns the same fence or none)."""

    owner: Any = None
    holds: int = 0
    fence: int = _INVALID_FENCE       # fence of the current incarnation
    highest: int = _INVALID_FENCE     # highest fence ever observed
    max_holds: int = 2

    def _with(self, **kw):
        d = dict(owner=self.owner, holds=self.holds, fence=self.fence,
                 highest=self.highest, max_holds=self.max_holds)
        d.update(kw)
        return ReentrantFencedMutex(**d)

    def step(self, op):
        f, c = op.get("f"), _op_client(op)
        if c is None:
            return inconsistent("no owner!")
        if f == "acquire":
            fence = _op_fence(op)
            fresh = fence == _INVALID_FENCE or fence > self.highest
            if self.owner is None:
                if fresh:
                    return self._with(owner=c, holds=1, fence=fence,
                                      highest=max(fence, self.highest))
                return inconsistent(f"fence {fence} ≤ {self.highest}")
            if self.owner != c or self.holds == self.max_holds:
                return inconsistent(f"{c!r} can't acquire {self!r}")
            if self.fence == _INVALID_FENCE:
                # held without a known fence: a re-acquire may reveal it
                if fresh:
                    return self._with(holds=self.holds + 1, fence=fence,
                                      highest=max(fence, self.highest))
                return inconsistent(f"fence {fence} ≤ {self.highest}")
            if fence == _INVALID_FENCE or fence == self.fence:
                return self._with(holds=self.holds + 1)
            return inconsistent(
                f"re-acquire fence {fence} ≠ held {self.fence}")
        if f == "release":
            if self.owner is None or self.owner != c:
                return inconsistent(f"{c!r} can't release {self!r}")
            if self.holds == 1:
                return self._with(owner=None, holds=0,
                                  fence=_INVALID_FENCE)
            return self._with(holds=self.holds - 1)
        return inconsistent(f"unknown op f={f!r}")


@dataclass(frozen=True)
class AcquiredPermits(Model):
    """Counting-semaphore permit model (hazelcast.clj
    AcquiredPermitsModel :631-650, num-permits=2): at most ``permits``
    acquired across clients; a client releases only what it holds."""

    acquired: tuple = ()   # sorted ((client, count>0), ...)
    permits: int = 2

    def step(self, op):
        f, c = op.get("f"), _op_client(op)
        if c is None:
            return inconsistent("no owner!")
        held = dict(self.acquired)
        if f == "acquire":
            if sum(held.values()) < self.permits:
                held[c] = held.get(c, 0) + 1
                return AcquiredPermits(tuple(sorted(held.items())),
                                       self.permits)
            return inconsistent(f"{c!r} can't acquire: no permits free")
        if f == "release":
            if held.get(c, 0) > 0:
                held[c] -= 1
                if not held[c]:
                    del held[c]
                return AcquiredPermits(tuple(sorted(held.items())),
                                       self.permits)
            return inconsistent(f"{c!r} releases nothing held")
        return inconsistent(f"unknown op f={f!r}")


@dataclass(frozen=True)
class FIFOQueue(Model):
    """A FIFO queue: enqueue/dequeue (knossos.model/fifo-queue)."""

    items: tuple = ()

    def step(self, op):
        f, v = op.get("f"), op.get("value")
        if f == "enqueue":
            return FIFOQueue(self.items + (v,))
        if f == "dequeue":
            if not self.items:
                return inconsistent("dequeue from empty queue")
            if self.items[0] != v:
                return inconsistent(f"dequeue {v!r} but head is {self.items[0]!r}")
            return FIFOQueue(self.items[1:])
        return inconsistent(f"unknown op f={f!r}")


@dataclass(frozen=True)
class UnorderedQueue(Model):
    """A queue where dequeue may return any enqueued element
    (knossos.model/unordered-queue); used by checker.queue
    (checker.clj:218-238)."""

    items: frozenset = frozenset()

    def step(self, op):
        f, v = op.get("f"), op.get("value")
        if f == "enqueue":
            # multiset via (value, seq) tags is overkill here; jepsen's
            # unordered-queue uses a multiset — emulate with counted tuples.
            items = dict(self.items)
            items[v] = items.get(v, 0) + 1
            return UnorderedQueue(frozenset(items.items()))
        if f == "dequeue":
            items = dict(self.items)
            if items.get(v, 0) <= 0:
                return inconsistent(f"dequeue {v!r} not present")
            items[v] -= 1
            if items[v] == 0:
                del items[v]
            return UnorderedQueue(frozenset(items.items()))
        return inconsistent(f"unknown op f={f!r}")


@dataclass(frozen=True)
class SetModel(Model):
    """A grow-only set: add/read."""

    items: frozenset = frozenset()

    def step(self, op):
        f, v = op.get("f"), op.get("value")
        if f == "add":
            return SetModel(self.items | {v})
        if f == "read":
            if v is None or frozenset(v) == self.items:
                return self
            return inconsistent("set read mismatch")
        return inconsistent(f"unknown op f={f!r}")


# ---------------------------------------------------------------------------


# copied from jepsen_tpu/models/__init__.py:370-418, with step_ids in torch
@dataclass(frozen=True)
class IntSpec:
    """A model whose state is a single int32 and whose ops are (f_code, a, b)
    int triples.

    step_ids(state, f_code, a, b) -> (new_state, ok_bool): int32/bool
    tensors, broadcast over any shape. ``init_state`` is the interned id
    of the initial model state.
    """

    name: str
    init_state: int
    num_f: int
    step_ids: Callable  # (state, f, a, b) -> (state', ok)


CAS_F_READ, CAS_F_WRITE, CAS_F_CAS = 0, 1, 2

# The transitions the frontier kernels carry a copy of: a step_ids's
# ``kernel_model`` is (code, keys, values), keys and values 0 for the CAS
# register.
KERNEL_CAS, KERNEL_MULTI_REGISTER = 0, 1


def kernel_model(step_ids) -> tuple | None:
    """The frontier kernels' (code, keys, values) for ``step_ids``, or
    None when they have no copy of its transition."""
    return getattr(step_ids, "kernel_model", None)


def _cas_step_ids(state, f, a, b):
    """CAS register transition: write v -> v, always ok; read v ok iff
    v == state (v == 0, i.e. None, reads anything); cas (a, b) ok iff
    state == a, -> b. Arguments broadcast; results are int32/bool."""
    state, f, a, b = torch.broadcast_tensors(
        *(torch.as_tensor(x, dtype=torch.int32) for x in (state, f, a, b)))
    is_read = f == CAS_F_READ
    is_write = f == CAS_F_WRITE
    is_cas = f == CAS_F_CAS
    ok = ((is_read & ((a == 0) | (a == state)))
          | is_write
          | (is_cas & (state == a)))
    new_state = torch.where(is_write, a, torch.where(is_cas & ok, b, state))
    return new_state, ok


_cas_step_ids.kernel_model = (KERNEL_CAS, 0, 0)


def cas_register_spec(init_state: int = 0) -> IntSpec:
    """Device-encodable CAS register. Ops encode as (f, a, b):
    read v -> (0, v_id, 0); write v -> (1, v_id, 0); cas [u,v] -> (2, u_id, v_id).
    A read of value-id 0 (None) matches any state — used for indeterminate
    reads."""
    return IntSpec("cas-register", init_state, 3, _cas_step_ids)


def register_spec(init_state: int = 0) -> IntSpec:
    """Read/write register (no cas) — same encoding minus cas."""
    return IntSpec("register", init_state, 2, _cas_step_ids)


# copied from jepsen_tpu/models/__init__.py:421-448
@dataclass(frozen=True)
class MultiRegister(Model):
    """A register map supporting transactional reads/writes over keys
    (yugabyte/src/yugabyte/multi_key_acid.clj:17-37 MultiRegister): one
    op f="txn" whose value is [[f, k, v], ...] with f "r"/"w"; a read of
    None is always legal, a read of v must match the key's current value
    (missing keys read as None)."""

    entries: tuple = ()  # sorted ((k, v), ...)

    def get(self, k):
        for kk, v in self.entries:
            if kk == k:
                return v
        return None

    def step(self, op):
        entries = dict(self.entries)
        for f, k, v in op.get("value") or ():
            if f == "r":
                if v is not None and v != entries.get(k):
                    return inconsistent(
                        f"{entries.get(k)!r} ≠ {v!r} at key {k!r}")
            elif f == "w":
                entries[k] = v
            else:
                return inconsistent(f"unknown txn micro-op {f!r}")
        return MultiRegister(tuple(sorted(entries.items())))




class _MultiRegisterStep:
    """jepsen_tpu/models/__init__.py:466-481's ``step_ids`` in int32 torch:
    per key k, action digit k of ``a`` (base 2V + 2) against state digit
    k (base V + 1), in a static loop over the keys; ``//`` and ``%`` floor
    as jnp's do. ``f`` and ``b`` are unused; the results broadcast
    ``state`` against ``a``."""

    def __init__(self, n_keys: int, n_values: int):
        self.n_keys, self.n_values = n_keys, n_values
        self.kernel_model = (KERNEL_MULTI_REGISTER, n_keys, n_values)

    def __call__(self, state, f, a, b):
        V, K = self.n_values, self.n_keys
        SB, AB = V + 1, 2 * V + 2
        state, acts = torch.broadcast_tensors(
            *(torch.as_tensor(x, dtype=torch.int32) for x in (state, a)))
        ok = torch.ones(state.shape, dtype=torch.bool, device=state.device)
        new_state = state
        for k in range(K):
            act = acts % AB
            acts = acts // AB
            digit = (new_state // (SB ** k)) % SB
            is_rv = (act >= 2) & (act < 2 + V)
            is_w = act >= 2 + V
            ok = ok & (~is_rv | (digit == act - 1))  # read v: digit == v+1
            wdigit = torch.where(is_w, act - (1 + V), digit)
            new_state = new_state + (wdigit - digit) * (SB ** k)
        return new_state, ok


# copied from jepsen_tpu/models/__init__.py:451-483, with step_ids in
# torch; one spec per shape, so the kernel caches keyed by the step see
# one step per shape
@functools.lru_cache(maxsize=None)
def multi_register_spec(n_keys: int = 3, n_values: int = 5) -> IntSpec:
    """Device-encodable multi-register (the multi-key-acid model).

    State interns the whole key→value map as base-(V+1) digits (digit 0
    = unset/None, 1..V = values), so K keys × V values is only (V+1)^K
    states — 216 at the workload's 3×5. A txn op packs per-key actions
    as base-(2V+2) digits of ``a``: 0 none, 1 read-None, 2+v read-v,
    2+V+v write-v. The frontier kernels carry a copy of the transition
    (``kernel_model`` (KERNEL_MULTI_REGISTER, K, V))."""
    V, K = n_values, n_keys
    AB = 2 * V + 2      # action digit base
    if AB ** K >= (1 << 31):
        raise ValueError(f"txn encoding overflows int32: ({AB})^{K}")
    return IntSpec(f"multi-register-{K}x{V}", 0, 1,
                   _MultiRegisterStep(K, V))


# copied from jepsen_tpu/models/__init__.py:486-492
@dataclass(frozen=True)
class Memo:
    """Wrapper marking a model as memoizable by (hash) — knossos.model/memo
    analog. Object models here are frozen dataclasses, hence hashable, so
    memoization is structural; this exists for API parity."""

    model: Model
