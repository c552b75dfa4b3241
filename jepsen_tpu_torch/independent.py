"""Independent multi-key checking (jepsen.independent): a lifted history's
values are [key, value] tuples, and the checker splits the history by
key and checks each key's sub-history on its own (jepsen_tpu/
independent.py:221-480).

When the inner checker is a ``LinearizableChecker`` of the CAS register
(alone, or the one such checker in a ``Compose``), the device is wanted
and the algorithm is not "wgl", every key is encoded and the whole batch
runs through ``parallel.batch_check``: the key-batched matrix screen on
the card, then one key-batched frontier launch for the keys it leaves
undecided; a key whose frontier overflowed and died goes to the exact
Python twin. Otherwise (another model, ``algorithm="wgl"`` or
``accelerator="cpu"``), each key goes through the inner checker on
threads (``bounded_pmap``): a multi-register key takes its own frontier
launch, as in the reference.

With ``explain`` on (the default; ``checker/explain.py``), each invalid
key of the batched lane gets the reference's per-key forensics
(``_explain_key``): ``results[k]["explain"]`` names the first anomaly's
op, the size of its witness and the backend, and, when the test map has
a ``name``, the artifacts written under ``independent/<k>``
(``anomaly.json``, ``witness-timeline.html``). A key in the matrix
regime localizes on the card; a shorter key reruns the exact Python
twin, since the batched lane keeps no per-key failure. The other
checkers of a Compose (a ``timeline``, say) write under the same
``independent/<k>``.

The batched lane reads ``checker_sharded`` and ``mesh_devices``
(``parallel.sharding_knobs``): False keeps one device, True shards the
keys over ``parallel.auto_mesh(mesh_devices)``, unset lets
``batch_check`` ask the cost model; a sharded batch reports the backend
``jitlin-gpu-sharded``. When ``torch.distributed`` is initialized with a
world of more than one process, the invalid keys localize through
``parallel.distributed.localize_keys_distributed`` (each process its
slice; no witness), as in the reference.

The key split is the ``subhistories`` view of the run's shared history
IR (``history_ir.of``) when the test map can carry one. Every per-key
check, and the batched lane's other checkers of a Compose, see the test
map with ``ir_enabled: False``, so no sub-history's IR evicts the run's
(the reference passes that map to the per-key checks only).

Not ported: the key-lifting generators. An error in the batched lane propagates; the
reference catches it and checks key by key instead.
"""
from __future__ import annotations

import logging

from jepsen_tpu_torch.checker import (
    Checker, Compose, check_safe, merge_valid,
)
from jepsen_tpu_torch.utils import bounded_pmap

logger = logging.getLogger("jepsen_tpu_torch.independent")

# the batched lane's backend names, by batch_check's route (the
# reference's device and mesh routes are "jitlin-tpu" and
# "jitlin-tpu-sharded")
BACKENDS = {"cpu": "jitlin-cpu(routed)", "device": "jitlin-gpu",
            "mesh": "jitlin-gpu-sharded"}


# copied from jepsen_tpu/independent.py:29-37
def tuple_value(k, v) -> list:
    """An independent [key, value] pair (independent.clj:21-29). Plain
    lists so histories stay JSON-serializable."""
    return [k, v]


def is_tuple_value(v) -> bool:
    return isinstance(v, (list, tuple)) and len(v) == 2


# copied from jepsen_tpu/independent.py:221-250
def history_keys(history: list[dict]) -> list:
    """All keys in a lifted history (independent.clj:238-248)."""
    seen = {}
    for op in history:
        v = op.get("value")
        if is_tuple_value(v):
            seen.setdefault(_freeze_key(v[0]), v[0])
    return list(seen.values())


def _freeze_key(k):
    return tuple(k) if isinstance(k, list) else k


def subhistory(k, history: list[dict]) -> list[dict]:
    """The sub-history for key k, with inner values unwrapped
    (independent.clj:250-262)."""
    fk = _freeze_key(k)
    out = []
    for op in history:
        v = op.get("value")
        if is_tuple_value(v) and _freeze_key(v[0]) == fk:
            out.append({**op, "value": v[1]})
    return out


def split_history(history: list[dict]) -> tuple[list, dict]:
    """(``history_keys(history)``, {frozen key: ``subhistory(k,
    history)``}) in one pass over the history, not one a key."""
    keys, subs = [], {}
    for op in history:
        v = op.get("value")
        if not is_tuple_value(v):
            continue
        fk = _freeze_key(v[0])
        sub = subs.get(fk)
        if sub is None:
            keys.append(v[0])
            sub = subs[fk] = []
        sub.append({**op, "value": v[1]})
    return keys, subs


class IndependentChecker(Checker):
    """Lifts a checker over keys (independent.clj:264-315): splits the
    history, checks each key, merges validity and reports failures by
    key (jepsen_tpu/independent.py:247-480)."""

    def __init__(self, checker: Checker):
        self.checker = checker

    def name(self):
        return f"independent({self.checker.name()})"

    # copied from jepsen_tpu/independent.py:265-295
    @staticmethod
    def _explain_key(test, sub_history, stream, step_py, spec, failure,
                     result: dict, key_opts: dict, device) -> None:
        """Anomaly forensics for one invalid key of the batched lane:
        localize and shrink over the key's own stream, artifacts under
        independent/<k>. Never fails the batch."""
        from jepsen_tpu_torch.checker import explain as explain_mod
        try:
            tmap = test if isinstance(test, dict) else {}
            forensics = explain_mod.explain_stream(
                stream, step_ids=spec.step_ids, step_py=step_py,
                init_state=spec.init_state, failure=failure,
                shrink_budget=explain_mod.shrink_budget(tmap),
                max_witness_ops=explain_mod.max_witness_ops(tmap),
                device=device)
            if forensics is None:
                return
            result["explain"] = {
                "first-anomaly-op": forensics["first_anomaly"]["op_index"],
                "witness-ops": len(forensics["witness"]["op_indices"]),
                "backend": forensics["backend"],
            }
            if isinstance(test, dict) and test.get("name"):
                arts = explain_mod.write_artifacts(
                    test, sub_history, forensics, opts=key_opts)
                if arts:
                    result["explain"]["artifacts"] = sorted(
                        str(k) for k in arts)
        except Exception:  # noqa: BLE001 — forensics never mask a verdict
            logger.exception("per-key anomaly forensics failed")

    @staticmethod
    def _key_opts(opts, k):
        """Per-key opts: sub-checkers write under independent/<k> like
        the reference (independent.clj:287-292)."""
        d = opts.get("subdirectory")
        return {**opts,
                "subdirectory": "/".join(
                    filter(None, [d, "independent", str(k)])),
                "history-key": k}

    # copied from jepsen_tpu/independent.py:305-345
    def check(self, test, history, opts):
        # the per-key split rides the run's shared history IR when the
        # test map can carry one (the memoized subhistories view):
        # composed lifted checkers split the history once
        from jepsen_tpu_torch import history_ir
        ir = history_ir.of(test, history)
        if ir is not None:
            from jepsen_tpu_torch.history_ir import views
            keys, subs = views.subhistories(ir)
        else:
            keys, subs = split_history(history)
        if not keys:
            return {"valid?": True, "results": {}, "count": 0}
        # per-key sub-checks get ir_enabled: False — a sub-history is not
        # the run's history, so attaching its IR would evict the run's
        # ``_history_ir``; the per-key encode is what these small checks
        # should pay
        sub_test = ({**test, "ir_enabled": False}
                    if isinstance(test, dict) else test)
        results = self._try_batched(sub_test, subs, opts)
        if results is None:
            pairs = list(subs.items())
            rs = bounded_pmap(
                lambda kv: check_safe(self.checker, sub_test, kv[1],
                                      self._key_opts(opts, kv[0])), pairs)
            results = {k: r for (k, _), r in zip(pairs, rs)}
        valid = merge_valid(r.get("valid?") for r in results.values())
        failures = sorted((str(k) for k, r in results.items()
                           if r.get("valid?") is not True), key=str)
        return {
            "valid?": valid,
            "count": len(results),
            "failures": failures,
            "results": {str(k): r for k, r in results.items()},
        }

    def _try_batched(self, test, subs, opts):
        """The batched lane's {frozen key: result}, or None when it does
        not apply: the inner checker is not a LinearizableChecker (or a
        Compose holding exactly one) of the CAS register, the accelerator
        is "cpu", the algorithm is "wgl", or a key has more than
        FRONTIER_MAX_SLOTS slots (the single check skips its frontier
        rung there too)."""
        from jepsen_tpu_torch import parallel
        from jepsen_tpu_torch.checker.linear_cpu import check_stream
        from jepsen_tpu_torch.checker.linearizable import (
            FRONTIER_MAX_SLOTS, LinearizableChecker)
        from jepsen_tpu_torch.models import CASRegister
        from jepsen_tpu_torch.ops.jitlin import JitLinKernel, verdict

        # see through a Compose holding exactly one LinearizableChecker:
        # it takes the batched lane, the rest run per key, and the per-key
        # results merge as Compose would merge them
        chk, lin_name, others = self.checker, None, {}
        if isinstance(chk, Compose):
            lins = [(nm, c) for nm, c in chk.checkers.items()
                    if isinstance(c, LinearizableChecker)]
            if len(lins) != 1:
                return None
            lin_name, chk = lins[0]
            others = {nm: c for nm, c in self.checker.checkers.items()
                      if nm != lin_name}
        # copied from jepsen_tpu/independent.py:368-379: the lane batches
        # the CAS register alone, and an explicit "wgl" stands it aside
        if not isinstance(chk, LinearizableChecker) \
                or not isinstance(chk.model, CASRegister):
            return None
        accelerator = opts.get("accelerator", chk.accelerator)
        if accelerator == "cpu" \
                or opts.get("algorithm", chk.algorithm) == "wgl":
            return None
        fkeys = list(subs)
        # each key encoded by the checker's own encoding, so the initial
        # register value interns to the kernel's initial state
        encs = [chk._encoding(subs[fk]) for fk in fkeys]
        streams = [e[0] for e in encs]
        if any(s.n_slots > FRONTIER_MAX_SLOTS for s in streams):
            return None
        step_py, spec = encs[0][1], encs[0][2]
        kernel = JitLinKernel(step_ids=spec.step_ids,
                              init_state=spec.init_state, device=chk.device)
        # copied from jepsen_tpu/independent.py:395-405: False forces one
        # device, True shards past the cost gate, unset is cost-gated
        sharded, mesh_devices = parallel.sharding_knobs(test, opts)
        mesh = False if sharded is False else None
        if sharded is True:
            mesh = parallel.auto_mesh(mesh_devices)
        outcomes = parallel.batch_check(
            streams, capacity=chk.capacity, kernel=kernel,
            accelerator=accelerator, mesh=mesh, mesh_devices=mesh_devices)
        backend = BACKENDS[parallel.last_route()]
        from jepsen_tpu_torch.checker.explain import enabled
        explain_on = enabled(test, opts)
        results = {}
        invalid = []
        # copied from jepsen_tpu/independent.py:414-460: the invalid keys'
        # forensics, off the happy path
        for fk, stream, (alive, died, ovf, peak) in zip(fkeys, streams,
                                                         outcomes):
            v = verdict(alive, ovf)
            if v == "unknown":
                res = check_stream(stream, step=step_py,
                                   init_state=spec.init_state)
                results[fk] = {"valid?": res.valid,
                               "algorithm": "jitlin-cpu(fallback)"}
                v, failure = res.valid, res
            else:
                results[fk] = {"valid?": v, "algorithm": backend,
                               "configs-max": peak}
                failure = None
            if v is False and explain_on:
                invalid.append((fk, stream, failure))
        if invalid and _world_size() > 1:
            # several processes: each localizes its slice's invalid keys,
            # and only the positions gather (no witness)
            from jepsen_tpu_torch.parallel.distributed import (
                localize_keys_distributed)
            idx = {fk: i for i, fk in enumerate(fkeys)}
            found = localize_keys_distributed(
                streams, [idx[fk] for fk, _, _ in invalid],
                step_ids=spec.step_ids, step_py=step_py,
                init_state=spec.init_state, device=chk.device)
            for fk, _, _ in invalid:
                hit = found.get(idx[fk])
                if hit is not None:
                    results[fk]["explain"] = {
                        "first-anomaly-op": hit[1],
                        "backend": "matrix-bisect-distributed"}
        else:
            for fk, stream, failure in invalid:
                self._explain_key(test, subs[fk], stream, step_py, spec,
                                  failure, results[fk],
                                  self._key_opts(opts, fk), chk.device)
        if lin_name is None:
            return results
        pairs = list(subs.items())
        other_rs = bounded_pmap(
            lambda kv: {nm: check_safe(c, test, kv[1],
                                       self._key_opts(opts, kv[0]))
                        for nm, c in others.items()}, pairs)
        merged = {}
        for (fk, _), extra in zip(pairs, other_rs):
            sub = {lin_name: results[fk], **extra}
            merged[fk] = {
                "valid?": merge_valid(r.get("valid?") for r in sub.values()),
                **sub,
            }
        return merged


def _world_size() -> int:
    """The processes of the initialized ``torch.distributed`` world (1
    when it is not initialized)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size()


def checker(inner: Checker) -> Checker:
    return IndependentChecker(inner)
