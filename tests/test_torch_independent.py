"""jepsen_tpu_torch.independent against jepsen_tpu.independent on the CPU:
the key split, and the lifted checker's result maps at zero tolerance
(``opts={"explain": False}``; the port's backend ``jitlin-gpu`` where the
JAX package's device lane says ``jitlin-tpu``), for valid, invalid and
overflowed keys, on the device lane, the CPU lane and through a Compose.
Also the key-batched frontier scans' plain versions against their
per-key singles, and (``cuda``-marked, on the card) the batched kernels
against those plain versions, key by key with their path counts."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import (
    corrupt_keys, independent_register_history, register_history,
)

OPTS = {"explain": False}
# the reference's opts: the same, on one device
REF_OPTS = {"explain": False, "checker_sharded": False}


@pytest.fixture
def small_matrix_regime(monkeypatch):
    """Admits these short keys to both packages' matrix screen, the JAX
    package's Pallas kernels in interpret mode."""
    import jepsen_tpu.ops.jitlin as ref_jitlin
    import jepsen_tpu.ops.pallas_matrix as pm
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(pm, "FORCE_INTERPRET", True)
    for mod in (ref_jitlin, jitlin):
        monkeypatch.setattr(mod, "MATRIX_MIN_RETURNS", 10)


def _lifted(n_keys=5, n_ops=60, bad=(1, 3), n_values=4):
    h = independent_register_history(n_keys, n_ops, n_procs=3,
                                     n_values=n_values, seed=2000)
    return corrupt_keys(h, bad) if bad else h


def _port_map(ref: dict) -> dict:
    """The reference's map with its device lane's backend renamed to the
    port's."""
    out = dict(ref)
    out["results"] = {
        k: {**r, "algorithm": r["algorithm"].replace("jitlin-tpu",
                                                     "jitlin-gpu")}
        if "algorithm" in r else r
        for k, r in ref["results"].items()}
    return out


def test_keys_and_subhistories_match_jax():
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu_torch import independent

    h = _lifted(bad=(2,))
    h.insert(3, {"type": "invoke", "process": 99, "f": "read",
                 "value": None})
    h.append({"type": "invoke", "process": 98, "f": "read",
              "value": [[1, 2], None]})
    keys = independent.history_keys(h)
    assert keys == ref_ind.history_keys(h)
    assert len(keys) == 6
    for k in keys:
        assert independent.subhistory(k, h) == ref_ind.subhistory(k, h)
    split_keys, subs = independent.split_history(h)
    assert split_keys == keys
    assert subs == {independent._freeze_key(k): independent.subhistory(k, h)
                    for k in keys}
    assert independent.tuple_value(1, 2) == ref_ind.tuple_value(1, 2)
    assert independent.is_tuple_value((1, 2)) and \
        not independent.is_tuple_value([1, 2, 3])


@pytest.mark.parametrize("case", ["valid", "invalid"])
def test_device_lane_matches_jax(case, small_matrix_regime):
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = _lifted(bad=() if case == "valid" else (1, 3))
    ref = ref_ind.checker(ref_lin(accelerator="tpu")).check({}, h, REF_OPTS)
    got = independent.checker(linearizable(accelerator="gpu",
                                           device="cpu")).check({}, h, OPTS)
    assert got == _port_map(ref)
    assert got["valid?"] is (case == "valid")
    assert got["failures"] == ([] if case == "valid" else ["1", "3"])
    assert {r["algorithm"] for r in got["results"].values()} == {
        "jitlin-gpu"}


def test_overflowed_key_goes_to_the_twin():
    """A sparse key (past 512 states) whose capacity-2 frontier overflows
    and dies is "unknown" on the device lane: the Python twin settles it
    (``jitlin-cpu(fallback)``), in both packages."""
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = corrupt_keys(independent_register_history(
        2, 1300, n_procs=5, n_values=10 ** 9, seed=2100), [1])
    ref = ref_ind.checker(ref_lin(accelerator="tpu", capacity=2)).check(
        {}, h, REF_OPTS)
    got = independent.checker(linearizable(
        accelerator="gpu", device="cpu", capacity=2)).check({}, h, OPTS)
    assert got == _port_map(ref)
    assert got["results"]["1"] == {"valid?": False,
                                   "algorithm": "jitlin-cpu(fallback)"}


def test_cpu_lane_matches_jax():
    """``accelerator="cpu"``: each key through the inner checker (its
    native rung), whole per-key maps equal."""
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = _lifted()
    ref = ref_ind.checker(ref_lin(accelerator="cpu")).check({}, h, REF_OPTS)
    got = independent.checker(linearizable(accelerator="cpu")).check(
        {}, h, OPTS)
    assert got == ref
    assert got["results"]["1"]["algorithm"] == "jitlin-native"
    assert "failed-op" in got["results"]["1"]


def test_compose_sees_through_one_linearizable(small_matrix_regime):
    """A Compose of one LinearizableChecker and another checker: the
    linearizable one takes the batched lane, the other runs per key, and
    each key's map merges as Compose merges it."""
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker import Checker as RefChecker
    from jepsen_tpu.checker import compose as ref_compose
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker import Checker, compose
    from jepsen_tpu_torch.checker.linearizable import linearizable

    def counter(base):
        class Count(base):
            def check(self, test, history, opts):
                return {"valid?": len(history) % 2 == 0,
                        "n": len(history), "key": opts["history-key"]}
        return Count()

    h = _lifted()
    ref = ref_ind.checker(ref_compose({
        "linear": ref_lin(accelerator="tpu"),
        "count": counter(RefChecker)})).check({}, h, REF_OPTS)
    got = independent.checker(compose({
        "linear": linearizable(accelerator="gpu", device="cpu"),
        "count": counter(Checker)})).check({}, h, OPTS)
    for k, r in ref["results"].items():
        r["linear"]["algorithm"] = "jitlin-gpu"
    assert got == ref
    assert got["results"]["1"]["linear"]["algorithm"] == "jitlin-gpu"


def test_auto_matches_jax_verdicts(monkeypatch):
    """"auto", both packages' cost models given one 0.05 s round trip
    (the reference's through JEPSEN_TPU_RTT_S, the port's default model),
    rates reset: the small batch takes the CPU lane in both, with the
    same ``valid?``, ``failures`` and ``count``."""
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu.parallel import pipeline as ref_pipeline
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.parallel import pipeline

    monkeypatch.setenv("JEPSEN_TPU_RTT_S", "0.05")
    monkeypatch.setattr(pipeline, "_DEFAULT_MODEL",
                        pipeline.CostModel(roundtrip_s=0.05))
    for mod in (ref_pipeline, pipeline):
        monkeypatch.setattr(mod, "_CPU_RATE", {})

    h = _lifted(n_keys=3, n_ops=40)
    ref = ref_ind.checker(ref_lin(accelerator="auto")).check({}, h, REF_OPTS)
    got = independent.checker(linearizable(accelerator="auto",
                                           device="cpu")).check({}, h, OPTS)
    assert (got["valid?"], got["failures"], got["count"]) == (
        ref["valid?"], ref["failures"], ref["count"])
    assert got["results"]["0"]["algorithm"] == "jitlin-cpu(routed)"
    assert ref["results"]["0"]["algorithm"] == "jitlin-cpu(routed)"


def test_empty_and_unlifted_histories():
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    chk = independent.checker(linearizable(accelerator="gpu", device="cpu"))
    assert chk.check({}, [], OPTS) == {"valid?": True, "results": {},
                                       "count": 0}
    unlifted = [{"type": "invoke", "process": 0, "f": "write", "value": 3},
                {"type": "ok", "process": 0, "f": "write", "value": 3}]
    assert chk.check({}, unlifted, OPTS)["count"] == 0


def test_key_past_32_slots_takes_the_per_key_lane():
    """A key holding 33 slots open (crashed CAS ops that never apply) is
    past the sparse frontier's uint32 masks: the batched lane declines and
    every key goes through the inner checker, as a single check would."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable

    wide = ([{"type": "invoke", "process": 100 + p, "f": "cas",
              "value": [7, [999, 1]]} for p in range(33)]
            + [{"type": "info", "process": 100 + p, "f": "cas",
                "value": [7, [999, 1]]} for p in range(33)]
            + [{"type": "invoke", "process": 140, "f": "read",
                "value": [7, None]},
               {"type": "ok", "process": 140, "f": "read",
                "value": [7, None]}])
    h = _lifted(n_keys=2, bad=()) + wide
    got = independent.checker(linearizable(accelerator="gpu",
                                           device="cpu")).check({}, h, OPTS)
    assert got["valid?"] is True and got["count"] == 3
    assert got["results"]["7"]["algorithm"] == "jitlin-cpu"
    assert got["results"]["0"]["algorithm"] == "torch-frontier"


def test_generator_shape_and_corruption():
    """``independent_register_history``: key k's ops are
    ``register_history(n_ops, n_procs, seed + k)`` on its own block of
    processes, in order; ``corrupt_keys`` breaks only the keys named."""
    from jepsen_tpu_torch import independent

    h = independent_register_history(4, 50, n_procs=3, n_values=5, seed=7)
    keys, subs = independent.split_history(h)
    assert sorted(keys) == [0, 1, 2, 3]
    for k in keys:
        want = register_history(50, n_procs=3, seed=7 + k, n_values=5)
        got = subs[k]
        assert [op["process"] - 3 * k for op in got] == [
            op["process"] for op in want]
        assert [{**op, "process": 0} for op in got] == [
            {**op, "process": 0} for op in want]
    assert h[:8] != [op for k in range(4) for op in subs[k]][:8]
    bad = corrupt_keys(h, [2], n=2)
    diff = [i for i, (a, b) in enumerate(zip(h, bad)) if a != b]
    assert len(diff) == 2
    assert all(bad[i]["value"] == [2, 999] for i in diff)


# ---------------------------------------------------------------------------
# the key-batched frontier scans
# ---------------------------------------------------------------------------

def _batch_streams(kind="dense"):
    """Keys of very different lengths in one batch: one that dies within
    its first hundred events beside ones that run 1,000 and more."""
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.histories import corrupt_reads
    n_values = 5 if kind == "dense" else 10 ** 9
    n_ops = 500 if kind == "dense" else 1300
    hs = [register_history(n_ops, n_procs=4, seed=60 + k, n_values=n_values)
          for k in range(4)]
    early = register_history(n_ops, n_procs=4, seed=70, n_values=n_values)
    reads = [i for i, op in enumerate(early)
             if op["type"] == "ok" and op["f"] == "read"]
    early = [dict(op) for op in early]
    early[reads[2]]["value"] = 999
    hs.insert(1, early)
    hs[3] = corrupt_reads(hs[3], n=2, seed=9)
    hs.append(register_history(2, n_procs=1, seed=1))
    return [encode_register_ops(h) for h in hs]


def _batch_and_singles(kind, device, K=256):
    """(batched results, plain batched results, per-key single results,
    work) for ``_batch_streams(kind)`` on ``device``."""
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    from jepsen_tpu_torch.ops.jitlin import _bucket
    streams = _batch_streams(kind)
    S = max(s.n_slots for s in streams)
    V = _bucket(max(len(s.intern) for s in streams), floor=16)
    batch = fk.batch_events(streams, S, device)
    work = []
    if kind == "dense":
        got = fk.frontier_dense_batch(batch, V)
        plain = fk.frontier_dense_batch_torch(batch, V, work=work)
    else:
        got = fk.frontier_sparse_batch(batch, K)
        plain = fk.frontier_sparse_batch_torch(batch, K, work=work)
    singles = []
    for s in streams:
        ev = [torch.as_tensor(np.asarray(x, np.int32), device=device)
              for x in (s.kind, s.slot, s.f, s.a, s.b)]
        if kind == "dense":
            r = fk.frontier_dense(*ev, fk.init_table(S, V, 0, device))
        else:
            r = fk.frontier_sparse(*ev, *fk.init_frontier(K, 0, device), S)
        singles.append([int(x) for x in r[:4]])
    return got, plain, singles, work


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_batched_plain_versions_equal_singles(kind):
    got, plain, singles, work = _batch_and_singles(kind, "cpu")
    rows = [[int(x[b]) for x in got] for b in range(len(singles))]
    assert rows == singles
    assert all(torch.equal(x, y) for x, y in zip(got, plain))
    died = [r[1] for r in rows]
    assert died[1] < 100 and died[3] > 100 and rows[0][0] == 1
    assert len(work) == len(singles) and work[-1].get("returns") == 2


def test_batch_events_checks_once_on_the_host():
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    streams = _batch_streams()
    S = max(s.n_slots for s in streams)
    batch = fk.batch_events(streams, S, "cpu")
    assert batch.off.tolist() == [0] + list(
        np.cumsum([len(s) for s in streams]))
    assert torch.equal(batch.ev[1, batch.off[2]:batch.off[3]],
                       torch.from_numpy(streams[2].slot.astype(np.int32)))
    with pytest.raises(ValueError, match="out of range"):
        fk.batch_events(streams, S - 1, "cpu")
    with pytest.raises(ValueError, match="no streams"):
        fk.batch_events([], S, "cpu")


@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided here, never
    at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,K", [("dense", 256), ("sparse", 256),
                                    ("sparse", 4)])
def test_batched_kernels_match_plain_on_card(cuda_device, kind, K):
    """One launch for every key, each key's row equal to the plain
    version's and to the single-history kernel's, with its path counts;
    a key that dies early beside keys that run 1,000 events and more."""
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    wrapper = (fk.frontier_dense_batch if kind == "dense"
               else fk.frontier_sparse_batch)
    n = wrapper.launches
    got, plain, singles, work = _batch_and_singles(kind, cuda_device, K)
    assert wrapper.launches == n + 1
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    rows = [[int(x[b]) for x in got] for b in range(len(singles))]
    assert rows == singles
    if kind == "dense":
        want = [[w.get("warp_returns", 0), w.get("returns", 0)]
                for w in work]
    else:
        want = [[w.get("warp_passes", 0), w.get("passes", 0)] for w in work]
    assert wrapper.paths.tolist() == want


@pytest.mark.cuda
@pytest.mark.parametrize("V", [16, 32, 512])
def test_batched_dense_paths_on_card(cuda_device, V):
    """The dense batch on its warp path (V = 16, 32) and its CTA path
    (V = 512), from an initial state other than 0."""
    from jepsen_tpu_torch.ops import frontier_kernels as fk
    streams = _batch_streams()
    S = max(s.n_slots for s in streams)
    batch = fk.batch_events(streams, S, cuda_device)
    got = fk.frontier_dense_batch(batch, V, init_state=3)
    work = []
    plain = fk.frontier_dense_batch_torch(batch, V, init_state=3, work=work)
    for x, y in zip(got, plain):
        assert torch.equal(x, y)
    assert fk.frontier_dense_batch.paths.tolist() == [
        [w.get("warp_returns", 0), w.get("returns", 0)] for w in work]
