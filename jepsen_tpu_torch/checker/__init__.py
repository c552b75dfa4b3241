"""Checker protocol: ``check(test, history, opts) -> {"valid?": ...}``
where valid? is True, False, or "unknown"; the plumbing that merges and
composes checkers; and the set checkers (``SetChecker``, and
``SetFullChecker``, whose device path classifies every element on the
card through ops/setscan)."""
from __future__ import annotations

import logging
from typing import Any

from jepsen_tpu_torch.utils import bounded_pmap, quantile

logger = logging.getLogger("jepsen_tpu_torch.checker")

# copied from jepsen_tpu/checker/__init__.py:27
VALID_PRIORITY = {False: 0, "unknown": 1, True: 2}


# copied from jepsen_tpu/checker/__init__.py:29-36
def merge_valid(valids) -> Any:
    """false > unknown > true (checker.clj:29-50)."""
    result = True
    for v in valids:
        v = "unknown" if v == "unknown" else bool(v) if isinstance(v, bool) else v
        if VALID_PRIORITY.get(v, 1) < VALID_PRIORITY.get(result, 1):
            result = v
    return result


# copied from jepsen_tpu/checker/__init__.py:39-44
class Checker:
    def check(self, test: dict, history: list[dict], opts: dict) -> dict:
        raise NotImplementedError

    def name(self) -> str:
        return type(self).__name__


# copied from jepsen_tpu/checker/__init__.py:47-53
def check_safe(checker: Checker, test: dict, history: list[dict],
               opts: dict | None = None) -> dict:
    """Exceptions become {'valid?': 'unknown'} (checker.clj:74-85)."""
    try:
        return checker.check(test, history, opts or {})
    except Exception as e:  # noqa: BLE001
        logger.exception("checker %s crashed", checker.name())
        return {"valid?": "unknown", "error": repr(e)}


# copied from jepsen_tpu/checker/__init__.py:56-71
class Compose(Checker):
    """A map of named checkers run in parallel; overall valid? merges
    (checker.clj:87-99)."""

    def __init__(self, checkers: dict[str, Checker]):
        self.checkers = checkers

    def check(self, test, history, opts):
        names = list(self.checkers)
        results = bounded_pmap(
            lambda n: check_safe(self.checkers[n], test, history, opts), names
        )
        by_name = dict(zip(names, results))
        return {
            "valid?": merge_valid(r.get("valid?") for r in results),
            **by_name,
        }


# copied from jepsen_tpu/checker/__init__.py:74-75
def compose(checkers: dict[str, Checker]) -> Checker:
    return Compose(checkers)


# copied from jepsen_tpu/checker/__init__.py:184-222
class SetChecker(Checker):
    """Grow-only set: :add ops then a final :read of the full set
    (checker.clj:240-291)."""

    def check(self, test, history, opts):
        attempts, adds = set(), set()
        final_read = None
        for op in history:
            f, typ, v = op.get("f"), op.get("type"), op.get("value")
            if f == "add":
                if typ == "invoke":
                    attempts.add(v)
                elif typ == "ok":
                    adds.add(v)
            elif f == "read" and typ == "ok":
                final_read = set(v)
        if final_read is None:
            return {"valid?": "unknown", "error": "Set was never read"}
        # The OK set is every read value that we tried to add
        ok = final_read & attempts
        # Unexpected values are those we never tried to add
        unexpected = final_read - attempts
        # Lost records are those we acknowledged but weren't read
        lost = adds - final_read
        # Recovered records are those we weren't sure about and that showed up
        recovered = ok - adds
        return {
            "valid?": not lost and not unexpected,
            "attempt-count": len(attempts),
            "acknowledged-count": len(adds),
            "ok-count": len(ok),
            "lost-count": len(lost),
            "unexpected-count": len(unexpected),
            "recovered-count": len(recovered),
            "ok": sorted(ok, key=repr),
            "lost": sorted(lost, key=repr),
            "unexpected": sorted(unexpected, key=repr),
            "recovered": sorted(recovered, key=repr),
        }


# the set-full checker's accelerators, as the linearizable checker's
SET_FULL_ACCELERATORS = ("gpu", "cpu", "auto")


class SetFullChecker(Checker):
    """Full set analysis: every element's visibility lifecycle across *all*
    reads, not just the final one (checker.clj:294-592; jepsen_tpu/checker/
    __init__.py:225-384).

    Each added element ends up :stable (present in the final read and every
    read after it became known), :lost (known, then absent from some later
    read and never seen again), or :never-read. Stale reads (absent after
    known, but present again later) violate linearizability when the
    linearizable option is set. Also reports visibility latency quantiles.

    ``accelerator`` "gpu" or "auto" (the default) encodes the history as a
    reads x elements membership matrix (history_ir.views.set_full_columns,
    times in float64; the view ``set_membership`` of the run's shared IR
    when ``history_ir.of`` gives one) and classifies every element in one
    launch of the set-classify kernel on ``device`` (None: the CUDA
    device; "cpu": its plain version). "cpu" runs the reference's per-element walk, the
    oracle. A device failure raises: there is no fallback to the walk.
    """

    def __init__(self, linearizable: bool = False, accelerator: str = "auto",
                 device=None):
        if accelerator not in SET_FULL_ACCELERATORS:
            raise ValueError(f"accelerator {accelerator!r} not in "
                             f"{SET_FULL_ACCELERATORS}")
        self.linearizable = linearizable
        self.accelerator = accelerator
        self.device = device

    def check(self, test, history, opts):
        accelerator = opts.get("accelerator", self.accelerator)
        if accelerator not in SET_FULL_ACCELERATORS:
            raise ValueError(f"accelerator {accelerator!r} not in "
                             f"{SET_FULL_ACCELERATORS}")
        if accelerator == "cpu":
            return self._check_cpu(test, history, opts)
        return self._check_device(test, history, opts)

    # copied from jepsen_tpu/checker/__init__.py:265-309, on the port's
    # encode and kernel
    def _check_device(self, test, history, opts):
        from jepsen_tpu_torch import history_ir
        from jepsen_tpu_torch.history_ir import views
        from jepsen_tpu_torch.ops import setscan

        # the membership encode is an IR view, memoized on the run's
        # shared IR when the test map can carry one
        ir = history_ir.of(test, history)
        enc = (views.set_membership(ir) if ir is not None
               else views.set_full_columns(history))
        if "error" in enc:
            return {"valid?": "unknown", "error": enc["error"]}
        member = enc["member"]
        read_t, invoke_t = enc["read_t"], enc["invoke_t"]
        ok_t, has_ok, els = enc["ok_t"], enc["has_ok"], enc["els"]
        E = len(els)
        code, stale, latency = setscan.classify_elements(
            member, read_t, invoke_t, ok_t, has_ok, device=self.device)

        lost = [els[j] for j in range(E) if code[j] == setscan.LOST]
        never_read = [els[j] for j in range(E)
                      if code[j] == setscan.NEVER_READ]
        stale_els = [els[j] for j in range(E) if stale[j]]
        stable_lat = sorted(float(latency[j]) for j in range(E)
                            if code[j] == setscan.STABLE)
        latencies = ({q: quantile(stable_lat, q)
                      for q in (0.0, 0.5, 0.99, 1.0)} if stable_lat else {})
        valid = not lost
        if self.linearizable and stale_els:
            valid = False
        return {
            "valid?": valid,
            "attempt-count": E,
            "stable-count": sum(1 for j in range(E)
                                if code[j] == setscan.STABLE),
            "lost-count": len(lost),
            "lost": sorted(lost, key=repr)[:100],
            "never-read-count": len(never_read),
            "never-read": sorted(never_read, key=repr)[:100],
            "stale-count": len(stale_els),
            "stale": sorted(stale_els, key=repr)[:100],
            "stable-latencies": latencies,
        }

    # copied from jepsen_tpu/checker/__init__.py:311-384
    def _check_cpu(self, test, history, opts):
        adds: dict[Any, dict] = {}   # element -> {invoke_time, ok_time}
        reads: list[tuple[int, int, set]] = []  # (invoke_time, index, value-set)
        pending_read_invokes: dict[Any, int] = {}
        for i, op in enumerate(history):
            f, typ, v, p = op.get("f"), op.get("type"), op.get("value"), op.get("process")
            t = op.get("time", i)
            if f == "add":
                if typ == "invoke":
                    adds.setdefault(v, {"invoke_time": t, "ok_time": None})
                elif typ == "ok":
                    if v in adds:
                        adds[v]["ok_time"] = t
                    else:
                        adds[v] = {"invoke_time": t, "ok_time": t}
            elif f == "read":
                if typ == "invoke":
                    pending_read_invokes[p] = t
                elif typ == "ok":
                    t0 = pending_read_invokes.pop(p, t)
                    reads.append((t0, i, set(v)))
        if not reads:
            return {"valid?": "unknown", "error": "Set was never read"}
        reads.sort()
        results = {}
        stable_latencies = []
        lost, never_read, stale = [], [], []
        for el, info in adds.items():
            known_time = info["ok_time"]
            present = [(t0, el in vs) for (t0, _, vs) in reads]
            first_seen = next((t0 for (t0, _, vs) in reads if el in vs), None)
            if known_time is None:
                known_time = first_seen
            if known_time is None:
                never_read.append(el)
                results[el] = "never-read"
                continue
            later = [(t0, p) for (t0, p) in present if t0 >= known_time]
            if not later:
                never_read.append(el)
                results[el] = "never-read"
                continue
            # last absence and last presence among later reads
            last_present = max((t0 for (t0, p) in later if p), default=None)
            last_absent = max((t0 for (t0, p) in later if not p), default=None)
            if last_present is None or (last_absent is not None and last_absent > last_present):
                lost.append(el)
                results[el] = "lost"
                continue
            if last_absent is not None:
                # absent after known, but came back: stale read
                stale.append(el)
            results[el] = "stable"
            # stable latency: time from add-ok to start of uninterrupted presence
            stable_from = known_time if last_absent is None else last_absent
            stable_latencies.append(max(0, stable_from - info["invoke_time"]))
        stable_count = sum(1 for v in results.values() if v == "stable")
        sl = sorted(stable_latencies)
        latencies = {q: quantile(sl, q) for q in (0.0, 0.5, 0.99, 1.0)} if sl else {}
        valid = not lost
        if self.linearizable and stale:
            valid = False
        return {
            "valid?": valid,
            "attempt-count": len(adds),
            "stable-count": stable_count,
            "lost-count": len(lost),
            "lost": sorted(lost, key=repr)[:100],
            "never-read-count": len(never_read),
            "never-read": sorted(never_read, key=repr)[:100],
            "stale-count": len(stale),
            "stale": sorted(stale, key=repr)[:100],
            "stable-latencies": latencies,
        }


# copied from jepsen_tpu/checker/__init__.py:606-607
def set_checker() -> Checker:
    return SetChecker()


# jepsen_tpu/checker/__init__.py:610-611, with the port's default
# accelerator ("auto": the card) and device
def set_full(linearizable: bool = False, accelerator: str = "auto",
             device=None) -> Checker:
    return SetFullChecker(linearizable=linearizable, accelerator=accelerator,
                          device=device)
