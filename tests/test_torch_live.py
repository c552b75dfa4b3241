"""The port's live sessions against jepsen_tpu's on the CPU, tolerance
zero: the incremental register encoder poll by poll, each session's
verdicts and ``finalize`` (register, multi-key, Elle), the register
screen through the plain kernels (``accelerator="gpu", device="cpu"``)
with its latched localization, snapshots and restores, the workload
sniffing, and the errors that must reach the caller. A ``cuda``-marked
twin runs the screen on the card. Histories are made from a seed with
numpy."""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import (
    corrupt_keys, corrupt_reads, elle_history, independent_register_history,
    register_history,
)
from jepsen_tpu_torch.live import (
    ElleSession, LinearLiveSession, MultiKeyLinearSession, UNSUPPORTED,
    restore_session, session_for_ops,
)
from jepsen_tpu_torch.live import sessions


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These tests run many small torch ops; the suite runs several
    workers on the machine's cores, where torch's thread pool would
    oversubscribe them (tens of times slower). One thread, restored
    after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def messy_register_history(n: int, seed: int) -> list[dict]:
    """Register ops on 5 processes with fails, infos (crashed reads
    among them), nemesis ops and invokes overwritten before they
    complete."""
    rng = np.random.default_rng(seed)
    h, open_p = [], {}
    for i in range(n):
        p = int(rng.integers(5))
        if p in open_p and rng.random() < 0.9:
            f, v = open_p.pop(p)
            typ = ["ok", "ok", "ok", "fail", "info"][int(rng.integers(5))]
            val = int(rng.integers(5)) if typ == "ok" and f == "read" else v
            h.append({"type": typ, "process": p, "f": f, "value": val,
                      "time": i})
        elif rng.random() < 0.1:
            h.append({"type": "info", "process": "nemesis", "f": "kill",
                      "value": None, "time": i})
        else:
            f = ["read", "write", "cas"][int(rng.integers(3))]
            v = (None if f == "read" else int(rng.integers(5))
                 if f == "write" else [int(rng.integers(5)),
                                       int(rng.integers(5))])
            open_p[p] = (f, v)
            h.append({"type": "invoke", "process": p, "f": f, "value": v,
                      "time": i})
    return h


def _chunks(h, size):
    return [h[i:i + size] for i in range(0, len(h), size)]


def _stream_lists(st) -> tuple:
    return (list(st.kind), list(st.slot), list(st.f), list(st.a),
            list(st.b), list(st.op_index), st.n_slots,
            list(st.intern.table))


@pytest.fixture
def small_matrix_regime(monkeypatch):
    """Admits these short histories to the port's matrix screen."""
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(jitlin, "MATRIX_MIN_RETURNS", 10)


# ---------------------------------------------------------------------------
# the incremental register encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,size", [(1, 1), (2, 7), (3, 40), (4, 200)])
def test_register_encoder_matches_jax_poll_by_poll(seed, size):
    from jepsen_tpu.history import Intern as RefIntern
    from jepsen_tpu.history_ir.builder import (
        LiveRegisterEncoder as RefEncoder)
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.history import Intern
    from jepsen_tpu_torch.history_ir.builder import LiveRegisterEncoder
    h = messy_register_history(300, seed)
    enc, ref = LiveRegisterEncoder(Intern()), RefEncoder(RefIntern())
    batch = encode_register_ops(h)
    for chunk in _chunks(h, size):
        enc.add_many(chunk)
        ref.add_many(chunk)
        assert enc.encode_resolved() == ref.encode_resolved()
        assert _stream_lists(enc.stream) == _stream_lists(ref.stream)
        # the checkable prefix is the batch stream's prefix, event for
        # event
        n = len(enc.stream)
        assert list(enc.stream.kind) == batch.kind[:n].tolist()
        assert list(enc.stream.op_index) == batch.op_index[:n].tolist()
        assert enc.snapshot() == ref.snapshot()
    assert enc.finalize() == ref.finalize() == len(h)
    got = enc.stream.to_event_stream()
    for name in ("kind", "slot", "f", "a", "b", "op_index"):
        assert np.array_equal(getattr(got, name), getattr(batch, name)), name
    assert (got.n_slots, got.n_ops) == (batch.n_slots, batch.n_ops)
    assert got.intern.table == batch.intern.table


def test_register_encoder_snapshot_restores_mid_run():
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.history import Intern
    from jepsen_tpu_torch.history_ir.builder import LiveRegisterEncoder
    h = messy_register_history(240, 8)
    enc = LiveRegisterEncoder(Intern())
    enc.add_many(h[:120])
    enc.encode_resolved()
    back = LiveRegisterEncoder.restore(json.loads(json.dumps(
        enc.snapshot())))
    back.add_many(h[120:])
    back.finalize()
    batch = encode_register_ops(h)
    for name in ("kind", "slot", "f", "a", "b", "op_index"):
        assert getattr(back.stream, name) == getattr(batch, name).tolist()
    assert back.stream.intern.table == batch.intern.table
    assert LiveRegisterEncoder.restore({"intern": []}) is None
    # a custom encode_args cannot be rebuilt: no snapshot
    assert LiveRegisterEncoder(Intern(), encode_args=lambda op: (0, 0, 0)) \
        .snapshot() is None


# ---------------------------------------------------------------------------
# sessions against the reference's
# ---------------------------------------------------------------------------

def _drive(sess, chunks):
    verdicts = []
    for c in chunks:
        sess.add_many(c)
        verdicts.append(sess.verdict())
    return verdicts, sess.finalize()


REGISTER_CASES = {
    "valid": lambda: register_history(600, n_procs=3, seed=2, n_values=4),
    "corrupted": lambda: corrupt_reads(
        register_history(600, n_procs=3, seed=2, n_values=4), n=1, seed=1),
    "messy": lambda: messy_register_history(400, 6),
}


@pytest.mark.parametrize("case", sorted(REGISTER_CASES))
def test_register_session_matches_jax(case):
    from jepsen_tpu.live.sessions import LinearLiveSession as RefSession
    h = REGISTER_CASES[case]()
    chunks = _chunks(h, 150)
    got = _drive(LinearLiveSession(accelerator="cpu"), chunks)
    want = _drive(RefSession(accelerator="cpu"), chunks)
    assert got == want
    if case == "corrupted":
        assert got[1]["valid?"] is False


def test_register_screen_on_the_plain_kernels(small_matrix_regime,
                                              monkeypatch):
    """``accelerator="gpu", device="cpu"``: the screen runs the plain
    versions of the kernels. Each poll's verdict equals the CPU twin's;
    the corrupted copy is localized once and then answered from the
    latch."""
    from jepsen_tpu_torch.ops import jitlin
    calls = {"check": 0, "localize": 0}
    real_check, real_loc = jitlin.matrix_check, jitlin.matrix_localize

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call
    monkeypatch.setattr(jitlin, "matrix_check", counted("check", real_check))
    monkeypatch.setattr(jitlin, "matrix_localize",
                        counted("localize", real_loc))
    h = REGISTER_CASES["corrupted"]()
    chunks = _chunks(h, 150)
    twin_verdicts, twin_final = _drive(LinearLiveSession(accelerator="cpu"),
                                       chunks)
    sess = LinearLiveSession(accelerator="gpu", device="cpu")
    verdicts, final = _drive(sess, chunks)
    assert final == twin_final
    for got, want in zip(verdicts, twin_verdicts):
        assert (got["valid_so_far"], got["first_anomaly_op"],
                got["checked_ops"]) == (want["valid_so_far"],
                                        want["first_anomaly_op"],
                                        want["checked_ops"])
        assert got["backend"] == "torch-matrix"
    bad = [i for i, v in enumerate(verdicts) if v["valid_so_far"] is False]
    assert bad and bad[-1] == len(verdicts) - 1
    # screened until the first invalid poll, then the latch answers
    assert calls == {"check": bad[0] + 1, "localize": 1}


def test_register_screen_out_of_regime_takes_the_frontier():
    """Below MATRIX_MIN_RETURNS the gpu session is the CPU twin."""
    h = REGISTER_CASES["valid"]()
    sess = LinearLiveSession(accelerator="gpu", device="cpu")
    verdicts, _ = _drive(sess, _chunks(h, 300))
    assert {v["backend"] for v in verdicts} == {"frontier-cpu"}
    auto = LinearLiveSession(accelerator="auto", device="cpu")
    assert {v["backend"] for v in _drive(auto, _chunks(h, 300))[0]} == {
        "frontier-cpu"}


def test_register_screen_on_a_mesh(small_matrix_regime, monkeypatch):
    """A cost model that asks for a mesh gets the same verdicts from the
    sharded screen, and a shard's error reaches the caller."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.parallel import Mesh
    mesh = Mesh(["cpu"] * 2)
    monkeypatch.setattr(parallel, "sharded_mesh_for", lambda n: mesh)
    h = REGISTER_CASES["corrupted"]()
    chunks = _chunks(h, 300)
    want = _drive(LinearLiveSession(accelerator="cpu"), chunks)
    got = _drive(LinearLiveSession(accelerator="gpu", device="cpu"), chunks)
    assert [(v["valid_so_far"], v["first_anomaly_op"]) for v in got[0]] \
        == [(v["valid_so_far"], v["first_anomaly_op"]) for v in want[0]]

    def broken(*a, **k):
        raise RuntimeError("shard failed")
    monkeypatch.setattr(parallel, "shard_chunked", broken)
    sess = LinearLiveSession(accelerator="gpu", device="cpu")
    sess.add_many(h)
    with pytest.raises(RuntimeError, match="shard failed"):
        sess.verdict()


@pytest.mark.parametrize("which", ["matrix_check", "matrix_localize"])
def test_screen_and_localization_errors_raise(which, small_matrix_regime,
                                             monkeypatch):
    from jepsen_tpu_torch.ops import jitlin

    def broken(*a, **k):
        raise RuntimeError(f"{which} failed")
    monkeypatch.setattr(jitlin, which, broken)
    sess = LinearLiveSession(accelerator="gpu", device="cpu")
    sess.add_many(REGISTER_CASES["corrupted"]())
    with pytest.raises(RuntimeError, match=f"{which} failed"):
        sess.verdict()


def test_a_bad_op_poisons_and_does_not_kill():
    from jepsen_tpu.live.sessions import LinearLiveSession as RefSession
    out = []
    for cls in (LinearLiveSession, RefSession):
        sess = cls(accelerator="cpu")
        sess.add({"type": "invoke", "process": 0, "f": "read"})
        sess.add(None)  # not a dict: unencodable
        sess.add({"type": "ok", "process": 0, "f": "read", "value": 1})
        v, f = sess.verdict(), sess.finalize()
        out.append((v["valid_so_far"], v["error"].split(":")[0],
                    f["valid?"], sess.snapshot()))
    assert out[0] == out[1] == ("unknown", "unencodable op", "unknown",
                                None)


def test_register_snapshot_round_trips(small_matrix_regime):
    from jepsen_tpu.live.sessions import LinearLiveSession as RefSession
    h = REGISTER_CASES["corrupted"]()
    chunks = _chunks(h, 150)
    sess, ref = LinearLiveSession(accelerator="cpu"), RefSession(
        accelerator="cpu")
    for c in chunks[:2]:
        for s in (sess, ref):
            s.add_many(c)
            s.verdict()
    snap, rsnap = sess.snapshot(), ref.snapshot()
    # the port's frontier keeps no coverage probe (configs_min)
    snap_cmp = json.loads(json.dumps(snap))
    rsnap_cmp = json.loads(json.dumps(rsnap))
    for s in (snap_cmp, rsnap_cmp):
        s["frontier"].pop("configs_min", None)
    assert snap_cmp == rsnap_cmp
    back = restore_session(json.loads(json.dumps(snap)), accelerator="gpu",
                           device="cpu")
    assert isinstance(back, LinearLiveSession)
    rest = _drive(back, chunks[2:])
    whole = _drive(LinearLiveSession(accelerator="gpu", device="cpu"),
                   chunks)
    assert rest[1] == whole[1]
    assert [(v["valid_so_far"], v["first_anomaly_op"]) for v in rest[0]] \
        == [(v["valid_so_far"], v["first_anomaly_op"])
            for v in whole[0][2:]]
    assert restore_session({"workload": "register"}) is None
    assert restore_session({"workload": "list-append"}) is None
    assert restore_session(None) is None


def test_multi_key_session_matches_jax():
    from jepsen_tpu.live.sessions import (
        MultiKeyLinearSession as RefSession)
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    h = corrupt_keys(independent_register_history(4, 80, n_procs=3,
                                                  seed=5), [1, 3])
    h.insert(7, {"type": "info", "process": "nemesis", "f": "kill",
                 "value": None})
    chunks = _chunks(h, 90)
    got = _drive(MultiKeyLinearSession(accelerator="cpu"), chunks)
    want = _drive(RefSession(accelerator="cpu"), chunks)
    assert got == want
    assert got[1]["failures"] == ["1", "3"]
    batch = independent.checker(linearizable(accelerator="gpu",
                                             device="cpu")).check(
        {}, h, {"explain": False})
    assert batch["failures"] == got[1]["failures"]
    # snapshot and restore, key by key
    sess = MultiKeyLinearSession(accelerator="cpu")
    sess.add_many(h[:200])
    sess.verdict()
    back = restore_session(json.loads(json.dumps(sess.snapshot())),
                           accelerator="cpu")
    assert isinstance(back, MultiKeyLinearSession)
    back.add_many(h[200:])
    assert back.finalize() == got[1]


@pytest.mark.parametrize("pairs", [0, 3])
def test_elle_session_matches_jax_and_batch(pairs):
    from jepsen_tpu.live.sessions import ElleSession as RefSession
    from jepsen_tpu_torch.elle import list_append
    h = elle_history(400, n_keys=12, crossed_pairs=pairs)
    chunks = _chunks(h, 200)
    got = _drive(ElleSession(accelerator="cpu"), chunks)
    want = _drive(RefSession(accelerator="cpu"), chunks)
    assert got == want
    on_card_route = _drive(ElleSession(accelerator="gpu", device="cpu"),
                           chunks)
    assert on_card_route == got
    batch = list_append.check(h, accelerator="gpu", device="cpu")

    def core(r):
        return {k: v for k, v in r.items()
                if k not in ("builder", "read-scan-keys")}
    assert core(got[1]) == core(batch)
    assert got[1]["builder"] == "columnar-incremental"
    assert got[1]["valid?"] is (pairs == 0)
    if pairs:
        assert got[0][-1]["first_anomaly_op"] is not None


def test_elle_session_falls_back_outside_the_regime():
    from jepsen_tpu.live.sessions import ElleSession as RefSession
    h = elle_history(60, n_keys=4)
    first_ok = next(i for i, op in enumerate(h) if op["type"] == "ok")
    h[first_ok] = {**h[first_ok], "value": [["append", 0, "x"]]}
    got = _drive(ElleSession(accelerator="cpu"), _chunks(h, 40))
    want = _drive(RefSession(accelerator="cpu"), _chunks(h, 40))
    assert got == want
    assert got[0][-1]["backend"] == "batch-fallback"


SNIFF_CASES = [
    [{"type": "invoke", "process": 0, "f": "read", "value": None}],
    [{"type": "invoke", "process": 0, "f": "read", "value": ["k", None]}],
    [{"type": "invoke", "process": 0, "f": "cas", "value": ["k", [1, 2]]}],
    [{"type": "invoke", "process": 0, "f": "cas", "value": [1, 2]}],
    [{"type": "invoke", "process": 0, "f": "cas", "value": None},
     {"type": "invoke", "process": 1, "f": "write", "value": 3}],
    [{"type": "invoke", "process": 0, "f": "txn",
      "value": [["append", 1, 2]]}],
    [{"type": "invoke", "process": 0, "f": "txn", "value": [["w", 1, 2]]}],
    [{"type": "invoke", "process": 0, "f": "txn", "value": []}],
    [{"type": "invoke", "process": 0, "f": "add", "value": 1}],
    [{"type": "invoke", "process": "nemesis", "f": "kill"}],
    [{"type": "invoke", "process": -1, "f": "read"}],
    [],
]


@pytest.mark.parametrize("ops", SNIFF_CASES, ids=range(len(SNIFF_CASES)))
def test_session_sniffing_matches_jax(ops):
    from jepsen_tpu.live import sessions as ref

    def kind(s, mod):
        if s is None:
            return None
        if s is mod.UNSUPPORTED:
            return "unsupported"
        return type(s).__name__
    got = session_for_ops(ops, accelerator="gpu", device="cpu")
    assert kind(got, sessions) == kind(ref.session_for_ops(ops), ref)
    if got is not None and got is not UNSUPPORTED:
        assert (got.accelerator, got.device) == ("gpu", "cpu")


def test_sessions_reject_an_unknown_accelerator():
    for cls in (LinearLiveSession, ElleSession, MultiKeyLinearSession):
        with pytest.raises(ValueError, match="accelerator"):
            cls(accelerator="tpu")


@pytest.mark.cuda
def test_register_screen_on_card():
    """The live screen on the card, poll by poll: every verdict equals
    the CPU twin's; the polls below MATRIX_MIN_RETURNS stay on the
    frontier and launch nothing; each screened poll launches one chunk
    product and one combine, the poll that latches one more chunk product
    (the localization) and each forensics kernel once, and the latched
    polls after it launch nothing."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jepsen_tpu_torch.ops import forensics_kernels as fx
    from jepsen_tpu_torch.ops import matrix_kernels as mk
    kernels = {"chunk_product": mk.chunk_product,
               "combine_product": mk.combine_product,
               "prefix_alive": fx.prefix_alive,
               "window_rescan": fx.window_rescan}
    h = corrupt_reads(register_history(8000, n_procs=5, seed=42,
                                       n_values=5), n=2, seed=0)
    chunks = _chunks(h, 2000)  # 8 polls, the first two under the screen
    twin = _drive(LinearLiveSession(accelerator="cpu"), chunks)
    sess = LinearLiveSession(accelerator="gpu")
    frontier = screened = latched = 0
    for i, c in enumerate(chunks):
        sess.add_many(c)
        for fn in kernels.values():
            fn.launches = 0
        v = sess.verdict()
        got = {k: fn.launches for k, fn in kernels.items()}
        w = twin[0][i]
        assert (v["valid_so_far"], v["first_anomaly_op"]) == (
            w["valid_so_far"], w["first_anomaly_op"]), i
        if v["backend"] == "frontier-cpu":
            assert not screened and not any(got.values()), (i, got)
            frontier += 1
            continue
        assert v["backend"] == "torch-matrix", (i, v)
        if latched:
            assert not any(got.values()), (i, got)
            continue
        screened += 1
        latched = v["valid_so_far"] is False
        assert got == {"chunk_product": 1 + latched, "combine_product": 1,
                       "prefix_alive": int(latched),
                       "window_rescan": int(latched)}, (i, got)
    assert sess.finalize() == twin[1] and twin[1]["valid?"] is False
    assert frontier >= 1 and screened >= 2 and latched
