"""jepsen_tpu_torch.parallel.batch_check against jepsen_tpu.parallel.
batch_check on the CPU: the same (alive, died, overflow, peak) tuple for
every key, at zero tolerance (flags and integers), on the device lane
(the JAX package's Pallas kernels in interpret mode, single device) and
on the CPU lane. The batches hold valid and invalid keys, a key whose
sparse frontier overflows, keys of different slot and state counts (the
batch's S and V bind every key), sub-batches with a short tail, and a
batch one matrix dispatch could not hold."""
from __future__ import annotations

import pytest
import torch

from jepsen_tpu_torch.histories import corrupt_reads, register_history


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jepsen_tpu.ops.pallas_matrix as pm
    monkeypatch.setattr(pm, "FORCE_INTERPRET", True)


@pytest.fixture
def small_matrix_regime(monkeypatch, pallas_interpret):
    """Admits these short histories to both packages' matrix screen."""
    import jepsen_tpu.ops.jitlin as ref_jitlin
    from jepsen_tpu_torch.ops import jitlin
    for mod in (ref_jitlin, jitlin):
        monkeypatch.setattr(mod, "MATRIX_MIN_RETURNS", 10)
    return (ref_jitlin, jitlin)


def _streams(histories):
    from jepsen_tpu.checker.linear_encode import encode_register_ops as ref_enc
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    return ([ref_enc(h) for h in histories],
            [encode_register_ops(h) for h in histories])


def _both(histories, capacity=256):
    """(the JAX package's tuples on its device lane, the port's on its
    "gpu" lane on the CPU)."""
    from jepsen_tpu.parallel import batch_check as ref_batch_check
    from jepsen_tpu_torch.parallel import batch_check, last_route

    ref_st, st = _streams(histories)
    ref = ref_batch_check(ref_st, capacity=capacity, accelerator="device",
                          mesh=False)
    got = batch_check(st, capacity=capacity, accelerator="gpu",
                      device="cpu")
    assert last_route() == "device"
    return ref, got


def _keys(n, n_ops=60, n_procs=3, n_values=4, bad=(), seed=100):
    hs = [register_history(n_ops, n_procs=n_procs, seed=seed + k,
                           n_values=n_values) for k in range(n)]
    return [corrupt_reads(h, n=2, seed=k) if k in bad else h
            for k, h in enumerate(hs)]


def test_matrix_screen_then_scan(small_matrix_regime):
    """Valid keys settle on the matrix screen (died -1, peak 0); the
    invalid ones go to one dense scan of the undecided keys."""
    ref, got = _both(_keys(6, bad=(1, 4)))
    assert got == ref
    assert [r[0] for r in got] == [True, False, True, True, False, True]
    assert got[0] == (True, -1, False, 0)
    assert got[1][1] >= 0 and got[1][3] > 1


@pytest.mark.parametrize("case", ["dense", "sparse_overflow",
                                  "mixed_s_and_v"])
def test_scan_lane_matches_jax(case):
    """Below MATRIX_MIN_RETURNS the batch is one frontier scan: dense at
    the batch's largest S and V; the sparse list (past 512 states) with
    a capacity of 4, whose invalid key overflows and dies; and keys of 2
    to 6 slots and 4 to 40 values in one batch, each scanned at the
    batch's S = 6 and V."""
    if case == "dense":
        hs, cap = _keys(5, bad=(0, 3)), 256
    elif case == "sparse_overflow":
        hs = [register_history(1300, n_procs=5, seed=7, n_values=10 ** 9),
              corrupt_reads(register_history(1300, n_procs=5, seed=8,
                                             n_values=10 ** 9), n=2, seed=6)]
        cap = 4
    else:
        hs = [register_history(80, n_procs=p, seed=20 + p, n_values=v)
              for p, v in ((2, 4), (6, 3), (3, 40), (4, 5))]
        hs[2] = corrupt_reads(hs[2], n=1, seed=2)
        cap = 256
    ref, got = _both(hs, capacity=cap)
    assert got == ref
    if case == "sparse_overflow":
        assert got[1][0] is False and got[1][2] is True


@pytest.mark.parametrize("n_keys", [3, 7])
def test_sub_batches_with_short_tail(n_keys, small_matrix_regime,
                                     monkeypatch):
    """MATRIX_SUB_KEYS = 4 and MATRIX_PIPELINE_KEYS = 2 in both packages:
    7 keys run as sub-batches of 4 (the last padded with an empty key),
    3 keys as sub-batches of 2."""
    from jepsen_tpu_torch.ops import jitlin
    for mod in small_matrix_regime:
        monkeypatch.setattr(mod, "MATRIX_SUB_KEYS", 4)
        monkeypatch.setattr(mod, "MATRIX_PIPELINE_KEYS", 2)
    ref, got = _both(_keys(n_keys, bad=(n_keys - 1,)))
    assert got == ref
    assert jitlin.last_phase_seconds()["sub_batches"] == 2


def test_batch_past_one_dispatch_splits(small_matrix_regime, monkeypatch):
    """A budget of 4 keys' [MV, MV] a dispatch: 9 keys split into
    sub-batches of 4 (they raised as one dispatch before), with the same
    tuples as the JAX package's."""
    from jepsen_tpu_torch.ops import jitlin
    hs = _keys(9, bad=(2,))
    _, st = _streams(hs)
    mv = (1 << max(s.n_slots for s in st)) * jitlin._bucket(
        max(len(s.intern) for s in st), floor=8)
    for mod in small_matrix_regime:
        monkeypatch.setattr(mod, "MATRIX_SUB_KEYS", 4)
        monkeypatch.setattr(mod, "MATRIX_MAX_ELEMS", 4 * mv * mv)
    with pytest.raises(ValueError, match="out of regime"):
        jitlin._matrix_plan(9, max(s.n_slots for s in st), 64, 8)
    ref, got = _both(hs)
    assert got == ref
    assert jitlin.last_phase_seconds()["sub_batches"] == 3


def test_cpu_lane_matches_jax():
    """The CPU lane: the native search key by key (the Python twin for a
    key past 63 slots), the same tuples as the JAX package's CPU lane."""
    from jepsen_tpu.parallel import batch_check as ref_batch_check
    from jepsen_tpu_torch.parallel import batch_check, last_route

    wide = ([{"type": "invoke", "process": p, "f": "cas", "value": [1, 2]}
             for p in range(64)]
            + [{"type": "ok", "process": p, "f": "cas", "value": [1, 2]}
               for p in range(64)])
    hs = _keys(4, bad=(1,)) + [wide]
    ref_st, st = _streams(hs)
    ref = ref_batch_check(ref_st, accelerator="cpu", mesh=False)
    got = batch_check(st, accelerator="cpu")
    assert last_route() == "cpu"
    assert got == ref
    assert got[4][:3] == (False, 64, False)


def test_auto_lane_by_events(monkeypatch):
    """"auto" asks the cost model: with a 0.01 s round trip and 100k
    events/s the CPU lane wins below 2,000 events in all (its predicted
    time under the two round trips' floor) and the device lane from
    there; the same tuples on both."""
    from jepsen_tpu_torch.parallel import batch_check, last_route, pipeline

    monkeypatch.setattr(pipeline, "_DEFAULT_MODEL", pipeline.CostModel(
        roundtrip_s=0.01, cpu_events_per_sec_=100_000.0))
    _, st = _streams(_keys(3, bad=(1,)))
    assert sum(len(s.kind) for s in st) < 2000
    got = batch_check(st, accelerator="auto", device="cpu")
    assert last_route() == "cpu"
    monkeypatch.setattr(pipeline, "_DEFAULT_MODEL", pipeline.CostModel(
        roundtrip_s=0.001, cpu_events_per_sec_=100_000.0))
    again = batch_check(st, accelerator="auto", device="cpu")
    assert last_route() == "device"
    assert [r[:2] for r in again] == [r[:2] for r in got]


def test_check_batch_and_entry_points_need_cuda(monkeypatch):
    """``JitLinKernel.check_batch`` is the device lane; without a card the
    default device raises instead of running on the CPU."""
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel
    from jepsen_tpu_torch.parallel import batch_check

    _, st = _streams(_keys(2))
    got = JitLinKernel(device="cpu").check_batch(st)
    assert got == batch_check(st, accelerator="gpu", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        batch_check(st, accelerator="gpu")
    with pytest.raises(ValueError):
        batch_check(st, accelerator="tpu", device="cpu")


def test_matrix_batch_reads_back_once(small_matrix_regime, monkeypatch):
    """The split batch's sub-batches come back in submission order: the
    same tuples as one key at a time."""
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(jitlin, "MATRIX_SUB_KEYS", 2)
    monkeypatch.setattr(jitlin, "MATRIX_PIPELINE_KEYS", 2)
    _, st = _streams(_keys(5, bad=(0, 3)))
    got = jitlin.matrix_check_batch(st, device="cpu")
    assert jitlin.last_phase_seconds()["sub_batches"] == 3
    one = [jitlin.matrix_check_batch([s], device="cpu",
                                     num_states=max(len(x.intern)
                                                    for x in st))[0]
           for s in st]
    assert got == one
    assert [g[0] for g in got] == [False, True, True, False, True]


def test_matrix_grids_check_slots_on_the_host():
    """The matrix path's grids skip the chunk product's device-side range
    check, so ``_matrix_grids`` checks every returning slot on the host
    before the upload."""
    import numpy as np

    from jepsen_tpu_torch.ops import jitlin
    r_slot = np.array([0, 3], np.int32)
    prep = (r_slot, np.ones((2, 2), bool), np.zeros((2, 2, 3), np.int64), 2)
    with pytest.raises(ValueError, match="slot out of range"):
        jitlin._matrix_grids([prep], 2, 8, 1, 1, 2, torch.device("cpu"))
    grids, _ = jitlin._matrix_grids([(r_slot % 2, *prep[1:])], 2, 8, 1, 1,
                                    2, torch.device("cpu"))
    assert grids[2].tolist() == [[0], [1]]
