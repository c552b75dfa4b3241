"""The exact CPU twin of the transfer-matrix path: breadth-first
just-in-time linearization over the int-encoded EventStream. It is the
checker's terminal rung and the tests' oracle."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from jepsen_tpu_torch.checker.linear_encode import EV_INVOKE, EV_NOOP, EventStream
from jepsen_tpu_torch.models import CAS_F_CAS, CAS_F_READ, CAS_F_WRITE


# copied from jepsen_tpu/checker/linear_cpu.py:24-34
def cas_register_step_py(state: int, f: int, a: int, b: int) -> tuple[int, bool]:
    """Pure-python twin of models.cas_register_spec().step_ids."""
    if f == CAS_F_READ:
        return state, (a == 0 or a == state)
    if f == CAS_F_WRITE:
        return a, True
    if f == CAS_F_CAS:
        if state == a:
            return b, True
        return state, False
    return state, False


# copied from jepsen_tpu/checker/linear_cpu.py:63-75
@dataclass
class LinearResult:
    valid: Any                 # True | False | "unknown"
    failed_event: int = -1     # event index where the frontier died
    failed_op_index: int = -1  # history index of that event's op
    configs_max: int = 0       # peak frontier size
    algorithm: str = ""
    # on failure: the surviving configurations just before the fatal
    # return killed them, truncated to 10. Each is {"state": model-state
    # value-or-id, "linearized": [history op-index...], "pending":
    # [history op-index...]}.
    final_configs: list | None = None


# copied from jepsen_tpu/checker/linear_cpu.py:78-244 (the pure-Python
# step loop; no native frontier, snapshots or coverage probe)
class FrontierSession:
    """Resumable just-in-time linearization: the surviving
    configurations (linearized-pending bitmask, model state), the open
    ops per slot and the pending mask carry between absorbs. Once the
    frontier dies the session latches its failure LinearResult; further
    absorbs are no-ops."""

    def __init__(
        self,
        step: Callable[[int, int, int, int],
                       tuple[int, bool]] = cas_register_step_py,
        init_state: int = 0,
        algorithm: str = "jitlin-cpu",
    ):
        self.step = step
        self.algorithm = algorithm
        self.configs: set[tuple[int, int]] = {(0, init_state)}
        self.cur: dict[int, tuple[int, int, int]] = {}
        self.cur_idx: dict[int, int] = {}  # slot -> history index of open op
        self.pending_mask = 0
        self.configs_max = 1
        self.events_absorbed = 0
        self.failure: LinearResult | None = None

    def absorb(self, stream, start: int = 0,
               end: int | None = None) -> LinearResult:
        """Consumes events ``[start, end)`` of ``stream`` and returns the
        verdict so far. Event indices are absolute, so a failure reports
        the same ``failed_event`` a one-shot check would."""
        if self.failure is not None:
            return self.failure
        if end is None:
            end = len(stream.kind)
        step = self.step
        configs = self.configs
        cur = self.cur
        cur_idx = self.cur_idx
        pending_mask = self.pending_mask
        configs_max = self.configs_max
        kinds, slots = stream.kind, stream.slot
        fcol, acol, bcol, idxcol = stream.f, stream.a, stream.b, \
            stream.op_index
        for e in range(start, end):
            kind = kinds[e]
            if kind == EV_NOOP:
                continue
            s = int(slots[e])
            bit = 1 << s
            if kind == EV_INVOKE:
                cur[s] = (int(fcol[e]), int(acol[e]), int(bcol[e]))
                cur_idx[s] = int(idxcol[e])
                pending_mask |= bit
                continue
            # EV_RETURN: closure, then require this op linearized
            all_seen = set(configs)
            frontier = configs
            while frontier:
                new = set()
                for mask, state in frontier:
                    avail = pending_mask & ~mask
                    m = avail
                    while m:
                        low = m & (-m)
                        m ^= low
                        sl = low.bit_length() - 1
                        f, a, b2 = cur[sl]
                        st2, ok = step(state, f, a, b2)
                        if ok:
                            c2 = (mask | low, st2)
                            if c2 not in all_seen:
                                all_seen.add(c2)
                                new.add(c2)
                frontier = new
            configs_max = max(configs_max, len(all_seen))
            configs = {(mask & ~bit, state)
                       for (mask, state) in all_seen if mask & bit}
            pending_mask &= ~bit
            if not configs:
                def op_indices(mask):
                    return [cur_idx[t] for t in cur_idx if mask & (1 << t)]

                def state_val(st):
                    try:
                        return stream.intern.value(st)
                    except (IndexError, AttributeError):
                        return st

                # the fatal op WAS pending when these configs died — its
                # bit was cleared from pending_mask just above; restore it
                fatal_pending = pending_mask | bit
                finals = [{"state": state_val(state),
                           "linearized": sorted(op_indices(mask)),
                           "pending": sorted(
                               op_indices(fatal_pending & ~mask))}
                          for mask, state in sorted(all_seen)[:10]]
                self.configs_max = configs_max
                self.events_absorbed = e + 1
                self.failure = LinearResult(
                    valid=False, failed_event=e,
                    failed_op_index=int(stream.op_index[e]),
                    configs_max=configs_max, algorithm=self.algorithm,
                    final_configs=finals,
                )
                return self.failure
        self.configs = configs
        self.pending_mask = pending_mask
        self.configs_max = configs_max
        self.events_absorbed = end
        return self.result()

    def result(self) -> LinearResult:
        """The verdict over everything absorbed so far: valid-so-far, or
        the latched failure."""
        if self.failure is not None:
            return self.failure
        return LinearResult(valid=True, configs_max=self.configs_max,
                            algorithm=self.algorithm)


# copied from jepsen_tpu/checker/linear_cpu.py:310-319
def check_stream(
    stream: EventStream,
    step: Callable[[int, int, int, int], tuple[int, bool]] = cas_register_step_py,
    init_state: int = 0,
) -> LinearResult:
    """Breadth-first JIT linearization: configs are (linearized-pending
    bitmask, state) pairs; closure is computed lazily before each return
    event. One-shot absorb over a :class:`FrontierSession`."""
    return FrontierSession(step=step, init_state=init_state).absorb(stream)
