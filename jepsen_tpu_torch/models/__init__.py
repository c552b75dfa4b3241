"""Consistency models for the register linearizability check.

Two forms side by side, as in the JAX package: the object model
(:class:`CASRegister`, the CPU oracle's form) and :class:`IntSpec`, whose
``step_ids`` is int32 torch arithmetic over tensors of any shape — the
form the transfer-matrix path consumes.
"""
from __future__ import annotations

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


def cas_register_spec(init_state: int = 0) -> IntSpec:
    """Device-encodable CAS register. Ops encode as (f, a, b):
    read v -> (0, v_id, 0); write v -> (1, v_id, 0); cas [u,v] -> (2, u_id, v_id).
    A read of value-id 0 (None) matches any state — used for indeterminate
    reads."""
    return IntSpec("cas-register", init_state, 3, _cas_step_ids)


def register_spec(init_state: int = 0) -> IntSpec:
    """Read/write register (no cas) — same encoding minus cas."""
    return IntSpec("register", init_state, 2, _cas_step_ids)
