"""Resumable long checks in jepsen_tpu_torch against jepsen_tpu on the
CPU: durable ``check.ckpt`` checkpoints (checker/checkpoint.py) of the
segmented matrix chain, the segmented frontier scan and the exact CPU
frontier, their discard rules, the checker's store and a check killed by
SIGKILL that resumes. Every verdict, carry, checkpoint document and
snapshot is held equal to the JAX package's (tolerance zero), apart from
the differences by design: the algorithm names, the snapshot's
``configs_min`` and the config's ``step``.

The segment bound is lowered in both packages so that small seeded
histories cross cuts. ``python tests/test_torch_resume.py --worker STORE
NAME START_TIME`` is the SIGKILL case's worker: it checks
:func:`block_history` with a store and kills itself right after its first
durable checkpoint.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
N_PROCS, N_VALUES = 3, 5


# copied from tests/resume_worker.py:29-54
def block_history(n_blocks: int, seed: int = 11,
                  plant_anomaly_at: int | None = None) -> list[dict]:
    """A valid register history of write-then-read blocks, quiescent
    between blocks; ``plant_anomaly_at`` makes block b's read answer a
    value no write gave."""
    rng = np.random.default_rng(seed)
    ops: list[dict] = []
    for b in range(n_blocks):
        p = int(rng.integers(N_PROCS))
        v = int(rng.integers(N_VALUES))
        ops.append({"process": p, "type": "invoke", "f": "write",
                    "value": v})
        ops.append({"process": p, "type": "ok", "f": "write", "value": v})
        p2 = int(rng.integers(N_PROCS))
        rv = (v + 1) % N_VALUES if b == plant_anomaly_at else v
        ops.append({"process": p2, "type": "invoke", "f": "read",
                    "value": None})
        ops.append({"process": p2, "type": "ok", "f": "read", "value": rv})
    return ops


def _streams(history):
    """(the JAX package's stream, the port's) of one history."""
    from jepsen_tpu.checker.linear_encode import encode_register_ops as ref
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    return ref(history), encode_register_ops(history)


def _count_segments(monkeypatch):
    """Counts the port's matrix_check_resume calls (one a segment)."""
    from jepsen_tpu_torch.ops import jitlin
    calls = []
    real = jitlin.matrix_check_resume

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(jitlin, "matrix_check_resume", counting)
    return calls


def _count_slices(monkeypatch):
    """The (lo, hi) of each segment the port's chains slice."""
    from jepsen_tpu_torch.ops import jitlin
    sliced = []
    real = jitlin._slice_stream

    def counting(stream, lo, hi):
        sliced.append((lo, hi))
        return real(stream, lo, hi)

    monkeypatch.setattr(jitlin, "_slice_stream", counting)
    return sliced


def _same_doc(got: dict, ref: dict) -> None:
    """Two checkpoint documents equal but for the write time and the
    config's ``step`` (each package names its own step function)."""
    got, ref = dict(got), dict(ref)
    for d in (got, ref):
        d.pop("wrote_at")
        d["config"] = {k: v for k, v in d["config"].items() if k != "step"}
    assert got == ref


def _cpu_kernel(**kw):
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel
    return JitLinKernel(device="cpu", **kw)


# ---------------------------------------------------------------------------
# 4. a checkpointed chain resumes bit-identical, running fewer segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plant", [None, 560])
def test_matrix_chain_ckpt_resumes_bit_identical(tmp_path, monkeypatch,
                                                 plant):
    from jepsen_tpu.checker.checkpoint import CheckpointStore as RefStore
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.checkpoint import CheckpointStore
    from jepsen_tpu_torch.ops import jitlin

    ref_s, s = _streams(block_history(600, plant_anomaly_at=plant))
    n_cuts = len(jitlin.quiescent_cuts(s.kind, 512))
    path, ref_path = tmp_path / "check.ckpt", tmp_path / "ref.ckpt"
    full_carries = []
    full = jitlin.matrix_check_segmented(
        s, max_segment=512, device="cpu", carry_sink=full_carries.append,
        ckpt=CheckpointStore(path, interval_s=0.0, resume=False))
    ref = ref_jit.matrix_check_segmented(
        ref_s, max_segment=512,
        ckpt=RefStore(ref_path, interval_s=0.0, resume=False))
    assert full == ref
    assert path.exists(), "the chain wrote no checkpoint"
    _same_doc(json.loads(path.read_text()), json.loads(ref_path.read_text()))

    calls = _count_segments(monkeypatch)
    carries = []
    resumed = jitlin.matrix_check_segmented(
        s, max_segment=512, device="cpu", carry_sink=carries.append,
        ckpt=CheckpointStore(path, interval_s=None, resume=True))
    assert resumed == full
    assert 1 <= len(calls) < n_cuts
    # the resumed chain's carries are the uninterrupted chain's last ones
    for got, want in zip(carries, full_carries[-len(carries):]):
        assert got["events_done"] == want["events_done"]
        assert torch.equal(got["tot0"], want["tot0"])


@pytest.mark.parametrize("route,plant", [("dense", None), ("dense", 110),
                                         ("sparse", None), ("sparse", 1)])
def test_frontier_chain_ckpt_resumes_bit_identical(tmp_path, monkeypatch,
                                                   route, plant):
    from jepsen_tpu.checker.checkpoint import CheckpointStore as RefStore
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.checkpoint import CheckpointStore
    from jepsen_tpu_torch.histories import corrupt_reads, register_history
    from jepsen_tpu_torch.ops import jitlin

    if route == "dense":
        h, seg = block_history(128, plant_anomaly_at=plant), 128
    else:
        # every write a fresh value: past the dense table's 512 states
        h = register_history(1100, n_procs=3, seed=5, n_values=10 ** 9)
        h, seg = (corrupt_reads(h, n=1, seed=3) if plant else h), 512
    ref_s, s = _streams(h)
    assert jitlin._dense_ok(s.n_slots, len(s.intern)) is (route == "dense")
    path, ref_path = tmp_path / "check.ckpt", tmp_path / "ref.ckpt"
    full = jitlin.segmented_check(
        s, max_segment=seg, kernel=_cpu_kernel(),
        ckpt=CheckpointStore(path, interval_s=0.0, resume=False))
    ref = ref_jit.segmented_check(
        ref_s, max_segment=seg,
        ckpt=RefStore(ref_path, interval_s=0.0, resume=False))
    assert full == ref
    assert path.exists(), "the chain wrote no checkpoint"
    _same_doc(json.loads(path.read_text()), json.loads(ref_path.read_text()))

    sliced = _count_slices(monkeypatch)
    resumed = jitlin.segmented_check(
        s, max_segment=seg, kernel=_cpu_kernel(),
        ckpt=CheckpointStore(path, interval_s=None, resume=True))
    assert resumed == full
    assert sliced and sliced[0][0] > 0, "the resume re-ran the prefix"
    assert len(sliced) < len(jitlin.quiescent_cuts(s.kind, seg))


# ---------------------------------------------------------------------------
# 5. load_resume's discard rules
# ---------------------------------------------------------------------------

def _edit_doc(path, reason):
    doc = json.loads(path.read_text())
    if reason == "model_drift":
        doc["config"]["step"] = "some.other.model.step_ids"
    elif reason == "events_outside":
        doc["events_done"] = 10 ** 9
    elif reason == "version":
        doc["version"] = 2
    path.write_text(json.dumps(doc))


@pytest.mark.parametrize("reason", ["hash_mismatch", "knob_drift",
                                    "model_drift", "events_outside",
                                    "version", "resume_off", "jax_writer"])
def test_discarded_checkpoint_restarts(tmp_path, monkeypatch, reason):
    """Each invalid checkpoint is discarded and the file cleared; the
    chain re-runs every segment and gives the uninterrupted verdict."""
    from jepsen_tpu.checker.checkpoint import CheckpointStore as RefStore
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.checkpoint import CheckpointStore
    from jepsen_tpu_torch.ops import jitlin

    ref_s, s = _streams(block_history(600, seed=11))
    path = tmp_path / "check.ckpt"
    if reason == "jax_writer":
        # the JAX package's checkpoint of the same history names its own
        # step: discarded on the config
        ref_jit.matrix_check_segmented(
            ref_s, max_segment=512,
            ckpt=RefStore(path, interval_s=0.0, resume=False))
    else:
        writer = (_streams(block_history(600, seed=12))[1]
                  if reason == "hash_mismatch" else s)
        jitlin.matrix_check_segmented(
            writer, max_segment=512, device="cpu",
            ckpt=CheckpointStore(path, interval_s=0.0, resume=False))
        _edit_doc(path, reason)
    assert path.exists()
    seg = 1024 if reason == "knob_drift" else 512
    calls = _count_segments(monkeypatch)
    out = jitlin.matrix_check_segmented(
        s, max_segment=seg, device="cpu",
        ckpt=CheckpointStore(path, interval_s=None,
                             resume=reason != "resume_off"))
    assert out == (True, -1, False, 0)
    assert len(calls) == len(jitlin.quiescent_cuts(s.kind, seg))
    if reason == "resume_off":
        # not read, so not cleared here: the checker clears it when the
        # check settles (test_checker_resume_check_false)
        assert path.exists()
    else:
        assert not path.exists()


def test_checker_resume_check_false(tmp_path, monkeypatch):
    """``resume_check: False`` in the test map: a surviving checkpoint is
    not resumed, every segment runs, and the settled check clears it."""
    from jepsen_tpu_torch.checker import checkpoint as ckpt_mod
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import jitlin

    monkeypatch.setattr(jitlin, "MATRIX_SEGMENT_EVENTS", 1024)
    h = block_history(1100)
    s = _streams(h)[1]
    test = {"name": "r", "start_time": "t0", "store_dir": str(tmp_path),
            "resume_check": "false", "check_ckpt_interval": 1e-9}
    path = tmp_path / "r" / "t0" / ckpt_mod.CKPT_NAME
    jitlin.matrix_check_segmented(
        s, max_segment=1024, device="cpu",
        ckpt=ckpt_mod.CheckpointStore(path, interval_s=0.0, resume=False))
    assert path.exists()
    calls = _count_segments(monkeypatch)
    out = LinearizableChecker(accelerator="gpu", device="cpu").check(
        test, h, {})
    assert out["valid?"] is True and out["algorithm"] == "torch-matrix"
    assert len(calls) == len(jitlin.quiescent_cuts(s.kind, 1024))
    assert not path.exists()


# ---------------------------------------------------------------------------
# 6. CheckpointStore: interval gating and guard fencing
# ---------------------------------------------------------------------------

def test_store_interval_gating(tmp_path):
    from jepsen_tpu_torch.checker import checkpoint as ckpt_mod

    path = tmp_path / "d" / "check.ckpt"
    state = {"kind": "matrix", "carry": {}}
    never = ckpt_mod.CheckpointStore(path, interval_s=None)
    assert not never.due() and not never.maybe_save(lambda: state, 5)
    # the interval clock starts at construction
    gated = ckpt_mod.CheckpointStore(path, interval_s=3600.0)
    assert not gated.maybe_save(lambda: state, 5) and not path.exists()
    gated._last_save -= 3600.0
    assert gated.maybe_save(lambda: state, 7)
    assert gated.writes == 1 and gated._last_events == 7
    doc = json.loads(path.read_text())
    assert doc["version"] == ckpt_mod.VERSION and doc["kind"] == "matrix"
    # the clock restarts at the write
    assert not gated.maybe_save(lambda: state, 9) and gated.writes == 1
    # a state that cannot be built is logged and skipped, never raised
    gated._last_save -= 3600.0

    def broken():
        raise ValueError("no state")
    assert not gated.maybe_save(broken, 9) and gated.writes == 1
    assert gated.load()["kind"] == "matrix"
    gated.clear()
    assert not path.exists() and gated.load() is None
    gated.clear()   # clearing nothing is fine
    # a disabled interval through the test map: <= 0 turns writing off
    assert ckpt_mod.ckpt_interval({"check_ckpt_interval": 0}) is None


def test_store_guard_fences(tmp_path):
    from jepsen_tpu_torch.checker.checkpoint import CheckpointStore

    path = tmp_path / "check.ckpt"
    owner = [True]
    st = CheckpointStore(path, interval_s=0.0, guard=lambda: owner[0])
    assert st.save({"kind": "matrix"}, events_done=4)
    assert path.exists() and not st.fenced
    before = path.read_text()
    owner[0] = False
    assert not st.save({"kind": "frontier"}, events_done=8)
    assert st.fenced and path.read_text() == before and st.writes == 1


def test_store_write_failure_never_raises(tmp_path):
    from jepsen_tpu_torch.checker.checkpoint import CheckpointStore

    blocker = tmp_path / "file"
    blocker.write_text("x")
    st = CheckpointStore(blocker / "check.ckpt", interval_s=0.0)
    assert not st.save({"kind": "matrix"}) and st.writes == 0


def test_knobs_match_jax():
    from jepsen_tpu.checker import checkpoint as ref_ck
    from jepsen_tpu_torch.checker import checkpoint as ck

    for v in (None, "", 0, -1, "0", 2.5, "3", "garbage", True, [1]):
        t = {"check_ckpt_interval": v}
        assert ck.ckpt_interval(t) == ref_ck.ckpt_interval(t), v
    for v in (None, "", True, False, 0, 1, "yes", "off", "maybe"):
        t = {"resume_check": v}
        assert ck.resume_enabled(t) == ref_ck.resume_enabled(t), v
    assert ck.ckpt_interval(None) == ck.DEFAULT_CKPT_INTERVAL_S
    assert ck.resume_enabled(None) is True


def test_store_path_matches_jax(tmp_path):
    from jepsen_tpu import store as ref_store
    from jepsen_tpu_torch import store

    for test in ({"name": "n", "start_time": "t", "store_dir": tmp_path},
                 {"start_time": 5}, {"name": "x", "start_time": "t"}):
        assert store.path(test, "check.ckpt") == \
            ref_store.path(test, "check.ckpt")
        assert store.base_dir(test) == ref_store.base_dir(test)


# ---------------------------------------------------------------------------
# 7. codecs and the prefix hash
# ---------------------------------------------------------------------------

CODEC_ARRAYS = {
    "bool": lambda: np.array([[True, False, True], [False, False, True]]),
    "zero_one_f32": lambda: (np.random.default_rng(1).random((1, 16, 16))
                             > 0.7).astype(np.float32),
    "mask_u32": lambda: np.array([0, 5, 0xFFFFFFFF, 3], np.uint32),
    "state_i32": lambda: np.array([2, 0x7FFFFFFF, -4], np.int32),
    "all_zero_u32": lambda: np.zeros((4,), np.uint32),
    "empty": lambda: np.zeros((0, 3), np.float32),
    "scalar": lambda: np.float32(1.0),
}


@pytest.mark.parametrize("case", sorted(CODEC_ARRAYS))
def test_codecs_match_jax(case):
    from jepsen_tpu.checker import checkpoint as ref_ck
    from jepsen_tpu_torch.checker import checkpoint as ck

    a = CODEC_ARRAYS[case]()
    doc = ck.encode_array(a)
    assert doc == ref_ck.encode_array(a)
    back = ck.decode_array(json.loads(json.dumps(doc)))
    assert np.array_equal(back, ref_ck.decode_array(doc))
    assert np.array_equal(back, np.asarray(a).astype(back.dtype))
    # a tensor encodes as its numpy array does; a bf16 one as float32
    t = torch.from_numpy(np.array(a))
    assert ck.encode_array(t) == doc
    if t.is_floating_point():
        assert ck.encode_array(t.to(torch.bfloat16)) == doc


@pytest.mark.parametrize("which", ["blocks", "register", "crashed"])
def test_prefix_hash_matches_jax(which):
    from jepsen_tpu.checker import checkpoint as ref_ck
    from jepsen_tpu_torch.checker import checkpoint as ck
    from jepsen_tpu_torch.histories import register_history

    h = {"blocks": lambda: block_history(50),
         "register": lambda: register_history(200, n_procs=5, seed=2,
                                              n_values=5),
         "crashed": lambda: [dict(op, type="info")
                             if op["type"] == "ok" and op["f"] == "write"
                             and i % 9 == 0 else op
                             for i, op in enumerate(
                                 register_history(200, n_procs=4, seed=3,
                                                  n_values=5))]}[which]()
    ref_s, s = _streams(h)
    for col in ("kind", "slot", "f", "a", "b"):
        assert np.asarray(getattr(s, col)).dtype == \
            np.asarray(getattr(ref_s, col)).dtype, col
    for end in (0, 1, 17, len(s) // 2, len(s)):
        assert ck.stream_prefix_hash(s, end) == \
            ref_ck.stream_prefix_hash(ref_s, end)


# ---------------------------------------------------------------------------
# 8. FrontierSession snapshots
# ---------------------------------------------------------------------------

def _without_min(snap):
    return {k: v for k, v in snap.items() if k != "configs_min"}


@pytest.mark.parametrize("plant", [None, 90])
def test_session_snapshot_roundtrip(plant):
    """A snapshot at a mid-operation cut restores and finishes as one
    uninterrupted absorb, and equals the JAX package's snapshot at the
    same cut but for ``configs_min``."""
    from jepsen_tpu.checker.linear_cpu import FrontierSession as RefSession
    from jepsen_tpu_torch.checker.linear_cpu import (
        FrontierSession, check_stream)

    ref_s, s = _streams(block_history(120, plant_anomaly_at=plant))
    full = check_stream(s)
    for cut in (len(s) // 2 + 1, len(s) // 2 + 3, len(s)):
        fs, ref_fs = FrontierSession(), RefSession()
        fs.absorb(s, end=cut)
        ref_fs.absorb(ref_s, end=cut)
        snap = fs.snapshot()
        assert snap["configs_min"] is None
        assert _without_min(snap) == _without_min(ref_fs.snapshot())
        restored = FrontierSession.restore(json.loads(json.dumps(snap)))
        res = restored.absorb(s, start=restored.events_absorbed)
        assert (res.valid, res.failed_event, res.failed_op_index) == \
            (full.valid, full.failed_event, full.failed_op_index)
    assert FrontierSession.restore({"configs": "x"}) is None
    assert FrontierSession.restore({}) is None


@pytest.mark.parametrize("plant", [None, 90])
def test_jax_snapshot_restores_in_port(plant):
    """A snapshot the JAX package made (with its ``configs_min``)
    restores in the port and finishes with the JAX package's result."""
    from jepsen_tpu.checker.linear_cpu import FrontierSession as RefSession
    from jepsen_tpu_torch.checker.linear_cpu import FrontierSession

    ref_s, s = _streams(block_history(120, plant_anomaly_at=plant))
    ref_fs = RefSession()
    cut = len(ref_s) // 2 + 1
    ref_fs.absorb(ref_s, end=cut)
    snap = json.loads(json.dumps(ref_fs.snapshot()))
    assert snap["configs_min"] is not None
    fs = FrontierSession.restore(snap)
    assert (fs.configs, fs.cur, fs.cur_idx, fs.pending_mask) == \
        (ref_fs.configs, ref_fs.cur, ref_fs.cur_idx, ref_fs.pending_mask)
    got = fs.absorb(s, start=cut)
    want = ref_fs.absorb(ref_s, start=cut)
    assert (got.valid, got.failed_event, got.failed_op_index,
            got.configs_max, got.final_configs) == \
        (want.valid, want.failed_event, want.failed_op_index,
         want.configs_max, want.final_configs)


def test_session_snapshot_latches_failure():
    from jepsen_tpu_torch.checker.linear_cpu import FrontierSession

    s = _streams(block_history(60, plant_anomaly_at=20))[1]
    fs = FrontierSession()
    res = fs.absorb(s)
    assert res.valid is False
    restored = FrontierSession.restore(fs.snapshot())
    assert restored.result().valid is False
    assert restored.result().failed_event == res.failed_event
    assert restored.absorb(s, start=0) is restored.failure


# ---------------------------------------------------------------------------
# 10. the checkpointed exact CPU frontier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plant", [None, 230])
def test_checkpointed_check_stream_resumes(tmp_path, monkeypatch, plant):
    from jepsen_tpu.checker import checkpoint as ref_ck
    from jepsen_tpu.checker.linear_cpu import cas_register_step_py as ref_step
    from jepsen_tpu_torch.checker import checkpoint as ck
    from jepsen_tpu_torch.checker.linear_cpu import (
        FrontierSession, cas_register_step_py, check_stream)

    for mod in (ck, ref_ck):
        monkeypatch.setattr(mod, "FRONTIER_CHUNK_EVENTS", 200)
    ref_s, s = _streams(block_history(300, plant_anomaly_at=plant))
    full = check_stream(s)
    path, ref_path = tmp_path / "check.ckpt", tmp_path / "ref.ckpt"
    got = ck.checkpointed_check_stream(
        s, cas_register_step_py, 0,
        ck.CheckpointStore(path, interval_s=0.0, resume=False))
    ref_ck.checkpointed_check_stream(
        ref_s, ref_step, 0,
        ref_ck.CheckpointStore(ref_path, interval_s=0.0, resume=False))
    assert (got.valid, got.failed_event, got.failed_op_index,
            got.final_configs) == (full.valid, full.failed_event,
                                   full.failed_op_index, full.final_configs)
    doc, ref_doc = (json.loads(p.read_text()) for p in (path, ref_path))
    for d in (doc, ref_doc):
        d["carry"].pop("configs_min")
    _same_doc(doc, ref_doc)
    assert doc["kind"] == "frontier-session" and doc["events_done"] > 0

    starts = []
    real = FrontierSession.absorb

    def counting(self, stream, start=0, end=None):
        starts.append(start)
        return real(self, stream, start, end)

    monkeypatch.setattr(FrontierSession, "absorb", counting)
    resumed = ck.checkpointed_check_stream(
        s, cas_register_step_py, 0,
        ck.CheckpointStore(path, interval_s=None, resume=True))
    assert starts[0] == doc["events_done"] > 0
    assert (resumed.valid, resumed.failed_event, resumed.failed_op_index) \
        == (full.valid, full.failed_event, full.failed_op_index)


# ---------------------------------------------------------------------------
# 11. the checker with a store
# ---------------------------------------------------------------------------

ALGORITHMS = {"jitlin-tpu-matrix": "torch-matrix",
              "jitlin-tpu": "torch-frontier"}


@pytest.mark.parametrize("plant", [None, 900])
def test_checker_with_store_matches_jax(tmp_path, monkeypatch, plant):
    """A test map with store coordinates: the chain runs (the stream is
    past the lowered segment bound), the result map equals the JAX
    package's, and the settled check leaves no check.ckpt."""
    from jepsen_tpu.checker.linearizable import LinearizableChecker as Ref
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import jitlin

    for mod in (jitlin, ref_jit):
        monkeypatch.setattr(mod, "MATRIX_SEGMENT_EVENTS", 1024)
    h = block_history(1100, plant_anomaly_at=plant)
    calls = _count_segments(monkeypatch)

    def test_map(store_dir):
        return {"name": "lin", "start_time": "20261018T000000.000Z",
                "store_dir": str(store_dir), "check_ckpt_interval": 1e-9}

    got = LinearizableChecker(accelerator="gpu", device="cpu").check(
        test_map(tmp_path / "port"), h, {})
    ref = Ref(accelerator="tpu").check(test_map(tmp_path / "ref"), h,
                                       {"checker_sharded": False})
    assert got["algorithm"] == ALGORITHMS[ref["algorithm"]] == \
        "torch-matrix"
    # both write linear.png and the forensics artifacts into their own
    # store dirs and name them
    assert set(got) == set(ref)
    for key in got:
        if key == "plot" and ref[key] is not None:
            assert Path(got[key]).relative_to(tmp_path / "port") == \
                Path(ref[key]).relative_to(tmp_path / "ref")
        elif key != "algorithm":
            assert got[key] == ref[key], key
    if plant is not None:
        assert got["explain"]["artifacts"] == ["anomaly.json",
                                               "witness-timeline.html"]
    assert got["valid?"] is (plant is None)
    s = _streams(h)[1]
    n_cuts = len(jitlin.quiescent_cuts(s.kind, 1024))
    assert len(calls) == (n_cuts if plant is None else 900 * 4 // 1024 + 1)
    assert not list((tmp_path / "port").rglob("check.ckpt"))


@pytest.mark.parametrize("plant", [5, 900])
def test_checker_hands_matrix_carry_to_cpu_rung(tmp_path, monkeypatch,
                                                plant):
    """An invalid chain with ``explain`` off, whose frontier rung cannot
    settle: the CPU rung starts at the matrix chain's last cut (the
    carry's hand-off) and goes through the checkpointed session; the
    verdict and failing op are the twin's."""
    from jepsen_tpu_torch.checker.linear_cpu import FrontierSession
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import jitlin

    monkeypatch.setattr(jitlin, "MATRIX_SEGMENT_EVENTS", 1024)
    h = block_history(1100, plant_anomaly_at=plant)
    s = _streams(h)[1]
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    twin = check_stream(s)
    monkeypatch.setattr(jitlin.JitLinKernel, "check",
                        lambda self, stream, capacity=256:
                        (False, -1, True, 0))
    starts = []
    real = FrontierSession.absorb

    def counting(self, stream, start=0, end=None):
        starts.append(start)
        return real(self, stream, start, end)

    monkeypatch.setattr(FrontierSession, "absorb", counting)
    test = {"name": "lin", "start_time": "t", "store_dir": str(tmp_path)}
    got = LinearizableChecker(accelerator="gpu", device="cpu").check(
        test, h, {"explain": False})
    assert got["algorithm"] == "jitlin-cpu(fallback)"
    assert got["valid?"] is twin.valid is False
    cuts = [0] + jitlin.quiescent_cuts(s.kind, 1024)
    # the CPU rung starts at the last cut before the dead segment: the
    # stream's start when the first segment dies (no carry was sunk)
    dead = next(i for i, c in enumerate(cuts) if c > twin.failed_event)
    assert starts[0] == cuts[dead - 1]
    assert (starts[0] > 0) is (plant == 900)
    assert got["failed-op"] == h[twin.failed_op_index]
    assert not (tmp_path / "lin" / "t" / "check.ckpt").exists()


# ---------------------------------------------------------------------------
# 12. a check killed by SIGKILL resumes bit-identical
# ---------------------------------------------------------------------------

KILL_BLOCKS, KILL_SEGMENT = 4096, 2048


def _worker(store_dir: str, name: str, start_time: str) -> int:
    """Checks block_history(KILL_BLOCKS) with a store, writing a
    checkpoint after every segment, and sends itself SIGKILL right after
    the first one is durable."""
    from jepsen_tpu_torch.checker import checkpoint as ckpt_mod
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import jitlin

    jitlin.MATRIX_SEGMENT_EVENTS = KILL_SEGMENT
    real = ckpt_mod.CheckpointStore.save

    def save_then_die(self, state, events_done=None):
        ok = real(self, state, events_done=events_done)
        if ok:
            os.kill(os.getpid(), signal.SIGKILL)
        return ok

    ckpt_mod.CheckpointStore.save = save_then_die
    test = {"name": name, "start_time": start_time, "store_dir": store_dir,
            "check_ckpt_interval": 1e-9}
    LinearizableChecker(accelerator="gpu", device="cpu").check(
        test, block_history(KILL_BLOCKS), {})
    return 3  # not reached: the first durable checkpoint kills it


def test_sigkill_mid_check_resumes_bit_identical(tmp_path, monkeypatch):
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.ops import jitlin

    name, ts = "resume", "20261018T000000.000Z"
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker",
         str(tmp_path), name, ts], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == -signal.SIGKILL, proc.stderr[-4000:]
    ckpt = tmp_path / name / ts / "check.ckpt"
    assert ckpt.exists(), "no durable checkpoint before the kill"
    doc = json.loads(ckpt.read_text())
    assert doc["kind"] == "matrix" and doc["segment"] == 1

    monkeypatch.setattr(jitlin, "MATRIX_SEGMENT_EVENTS", KILL_SEGMENT)
    calls = _count_segments(monkeypatch)
    test = {"name": name, "start_time": ts, "store_dir": str(tmp_path)}
    history = block_history(KILL_BLOCKS)
    n_cuts = len(jitlin.quiescent_cuts(_streams(history)[1].kind,
                                       KILL_SEGMENT))
    out = LinearizableChecker(accelerator="gpu", device="cpu").check(
        test, history, {})
    assert out["valid?"] is True and out["algorithm"] == "torch-matrix"
    assert len(calls) == n_cuts - 1, \
        f"the resume ran {len(calls)} of {n_cuts} segments"
    assert not ckpt.exists(), "a settled check must clear check.ckpt"
    # an uninterrupted check from scratch gives the same map
    calls.clear()
    scratch = LinearizableChecker(accelerator="gpu", device="cpu").check(
        test, history, {})
    assert len(calls) == n_cuts and scratch == out


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.path.insert(0, str(ROOT))
        sys.exit(_worker(*sys.argv[2:5]))
