"""The port's host ingest spine (``history_ir/ingest.py`` over the C of
``native/columnar_ext.c``) against jepsen_tpu's, tolerance zero: the WAL
chunk scanner on the whole buffer and split at every byte, the live
register encoder chunk by chunk (with a bail on an exotic op that the
Python twin resumes and raises from), and ``FrontierSession.absorb``
over a list-backed stream, alive and dying. Each case runs the port's C
path and its Python twins, against the JAX package's ingest with its
native path on and off (``JEPSEN_TPU_INGEST_NATIVE``, set for the
reference alone). WALs and histories are made from a seed with numpy;
``NASTY_WAL`` is the reference's canned probe WAL (torn lines,
surrogates, big ints, ``Infinity``, cas pairs, an unterminated tail)."""
from __future__ import annotations

import json

import numpy as np
import pytest

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.checker.linear_cpu import FrontierSession
from jepsen_tpu_torch.history import Intern
from jepsen_tpu_torch.history_ir import ingest
from jepsen_tpu_torch.history_ir.builder import LiveRegisterEncoder
from jepsen_tpu_torch.histories import corrupt_reads, register_history
from jepsen_tpu_torch.journal import WalTailer, parse_wal_chunk_py

# jepsen_tpu/history_ir/ingest.py:406-417 (_PROBE_WAL)
NASTY_WAL = (
    b'{"type":"invoke","f":"write","value":3,"process":0,"time":11}\n'
    b'{"type":"ok","f":"write","value":3,"process":0,"time":12}\n'
    b'{"type":"invoke","f":"cas","value":[3,1],"process":1,"time":13}\n'
    b'\n'
    b'{"torn": tr\n'
    b'{"type":"ok","f":"cas","value":[3,1],"process":1,"time":14}\n'
    b'{"u":"\\ud83d\\ude00 caf\\u00e9 \\ud800","big":123456789012345678901,'
    b'"neg":-0,"x":1.5e-3,"inf":Infinity}\n'
    b'{"type":"invoke","f":"read","value":null,"process":2,"time":15}\n'
    b'{"type":"ok","f":"read","value":1,"process":2,"time":16}\n'
    b'{"type":"invoke","f":"read","value":null,"process":0,"time":17'
)


def deep_eq(a, b) -> bool:
    """Equal values of the same types all the way down; floats by repr
    (-0.0, nan)."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return (list(a) == list(b)
                and all(deep_eq(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (len(a) == len(b)
                and all(deep_eq(x, y) for x, y in zip(a, b)))
    if isinstance(a, float):
        return repr(a) == repr(b)
    return a == b


@pytest.fixture(params=["native", "python"])
def ref_ingest(request, monkeypatch):
    """The JAX package's ingest with its native path on or off."""
    from jepsen_tpu.history_ir import ingest as ref
    monkeypatch.setenv("JEPSEN_TPU_INGEST_NATIVE",
                       "1" if request.param == "native" else "0")
    ref.reset()
    if request.param == "native":
        assert ref.native_mod() is not None
    yield ref
    ref.reset()


@pytest.fixture(params=["c", "twin"])
def port_path(request, monkeypatch):
    """The port's C path, or its Python twins alone (the C entries
    decline every call)."""
    if request.param == "twin":
        for name in ("encoder_add_encode", "encoder_encode",
                     "frontier_absorb"):
            monkeypatch.setattr(ingest, name, lambda *a, **k: False)
    return request.param


def nasty_wal(seed: int, n: int) -> bytes:
    """A WAL of ``n`` lines, seeded: register ops (some written with
    ``ensure_ascii=False``), blank and whitespace lines, torn lines,
    invalid UTF-8, escapes and lone surrogates, big ints, exponents,
    nested values, trailing garbage and an unterminated tail."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        r = rng.random()
        op = {"type": ["invoke", "ok", "fail", "info"][int(rng.integers(4))],
              "f": ["read", "write", "cas"][int(rng.integers(3))],
              "value": int(rng.integers(6)), "process": int(rng.integers(5)),
              "time": int(rng.integers(1 << 40))}
        if r < 0.55:
            lines.append(json.dumps(op).encode())
        elif r < 0.6:
            lines.append(b"" if rng.random() < 0.5 else b" \t ")
        elif r < 0.65:
            s = json.dumps(op).encode()
            lines.append(s[:int(rng.integers(1, len(s)))])
        elif r < 0.7:
            lines.append(b'{"type":"ok","value":"\xff\xfe caf\xc3\xa9"}')
        elif r < 0.75:
            lines.append(json.dumps({"s": "café ☃ \U0001f600",
                                     "k": i}, ensure_ascii=False).encode())
        elif r < 0.8:
            lines.append(b'{"u":"\\ud800\\udc00\\ud83d","e":"\\n\\t\\"\\\\",'
                         b'"big":-98765432109876543210987}')
        elif r < 0.85:
            lines.append(json.dumps({"x": float(rng.normal()) * 1e300,
                                     "y": -0.0, "z": 1e-320,
                                     "n": [[1, [2, None]], {"a": True}]}
                                    ).encode())
        elif r < 0.9:
            lines.append(b'{"nan": NaN, "inf": -Infinity, "v": [3, 1]}')
        elif r < 0.95:
            lines.append(json.dumps(op).encode() + b" }")
        else:
            lines.append(json.dumps({**op, "f": "cas", "value": [
                int(rng.integers(6)), int(rng.integers(6))]}).encode())
    return b"\n".join(lines) + (b"\n" if seed % 2 else b'{"type":"inv')


def same_parse(got, want) -> None:
    assert deep_eq(list(got[0]), list(want[0]))
    assert (got[1], got[2], bool(got[3])) == (want[1], want[2],
                                              bool(want[3]))


# ---------------------------------------------------------------------------
# the WAL chunk scanner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("final", [False, True])
@pytest.mark.parametrize("wal", ["nasty", "seed1", "seed2", "ops"])
def test_parse_wal_chunk_matches_jax(wal, final, ref_ingest):
    data = {"nasty": NASTY_WAL, "seed1": nasty_wal(1, 400),
            "seed2": nasty_wal(2, 400),
            "ops": "".join(json.dumps(op) + "\n" for op in register_history(
                300, n_procs=5, seed=3, n_values=5)).encode()}[wal]
    got = ingest.parse_wal_chunk(data, final=final)
    same_parse(got, ref_ingest.parse_wal_chunk(data, final=final))
    same_parse(got, parse_wal_chunk_py(data, final=final))


def test_parse_wal_chunk_split_at_every_byte(ref_ingest):
    """The WAL read in two polls cut at every byte offset: each poll's
    ops and cursor equal the reference's, and the ops of both polls are
    the whole buffer's."""
    data = NASTY_WAL + b"\n" + nasty_wal(3, 12)
    whole = ingest.parse_wal_chunk(data, final=True)
    for k in range(len(data) + 1):
        got1 = ingest.parse_wal_chunk(data[:k])
        same_parse(got1, ref_ingest.parse_wal_chunk(data[:k]))
        rest = data[got1[1]:]
        got2 = ingest.parse_wal_chunk(rest, final=True)
        same_parse(got2, ref_ingest.parse_wal_chunk(rest, final=True))
        assert deep_eq(got1[0] + got2[0], whole[0])
        assert got1[1] + got2[1] == len(data)
        assert got1[2] + got2[2] == whole[2]


def test_wal_tailer_polls_through_the_c_scanner(tmp_path, monkeypatch):
    calls = []
    real = ingest.parse_wal_chunk

    def spy(chunk, final=False):
        calls.append(final)
        return real(chunk, final=final)
    monkeypatch.setattr(ingest, "parse_wal_chunk", spy)
    path = tmp_path / "history.wal.jsonl"
    path.write_bytes(NASTY_WAL)
    tailer = WalTailer(path)
    ops = tailer.poll()
    assert (len(ops), tailer.torn_skipped, tailer.offset) == (
        7, 1, NASTY_WAL.rindex(b"\n") + 1)
    assert tailer.finalize() == [] and tailer.truncated_tail
    assert calls == [False, True]


# ---------------------------------------------------------------------------
# the live register encoder
# ---------------------------------------------------------------------------

def messy_register_history(n: int, seed: int) -> list[dict]:
    """Register ops on 5 processes with fails, infos (crashed reads
    among them), nemesis ops, overwritten invokes, tuple and list cas
    pairs, string and unhashable values."""
    rng = np.random.default_rng(seed)
    h, open_p = [], {}
    values = [0, 1, 2, "a", None, 3.5, [1, 2], {"k": 1}]
    for i in range(n):
        p = int(rng.integers(5))
        if p in open_p and rng.random() < 0.85:
            f, v = open_p.pop(p)
            typ = ["ok", "ok", "ok", "fail", "info"][int(rng.integers(5))]
            val = (values[int(rng.integers(len(values)))]
                   if typ == "ok" and f == "read" else v)
            h.append({"type": typ, "process": p, "f": f, "value": val,
                      "time": i})
        elif rng.random() < 0.08:
            h.append({"type": "info", "process": "nemesis", "f": "kill",
                      "value": None, "time": i})
        else:
            f = ["read", "write", "cas"][int(rng.integers(3))]
            u, w = (values[int(rng.integers(len(values)))] for _ in range(2))
            v = (None if f == "read" else u if f == "write"
                 else (u, w) if rng.random() < 0.3 else [u, w])
            open_p[p] = (f, v)
            h.append({"type": "invoke", "process": p, "f": f, "value": v,
                      "time": i})
    return h


def encoder_state(enc) -> tuple:
    st = enc.stream
    return (list(st.kind), list(st.slot), list(st.f), list(st.a),
            list(st.b), list(st.op_index), st.n_slots,
            list(enc.intern.table), enc._next, enc._next_slot,
            list(enc._free_slots), dict(enc._open_by_process),
            dict(enc._open_inv), dict(enc._outcome))


def _ref_encoder():
    from jepsen_tpu.history import Intern as RefIntern
    from jepsen_tpu.history_ir.builder import LiveRegisterEncoder as RefEnc
    return RefEnc(RefIntern())


@pytest.mark.parametrize("seed,size", [(1, 1), (2, 9), (3, 64), (4, 1000)])
def test_register_encoder_matches_jax_chunk_by_chunk(seed, size, ref_ingest,
                                                     port_path):
    h = messy_register_history(700, seed)
    enc, ref = LiveRegisterEncoder(Intern()), _ref_encoder()
    for lo in range(0, len(h), size):
        chunk = h[lo:lo + size]
        enc.add_many(chunk)
        ref.add_many(chunk)
        assert enc.encode_resolved() == ref.encode_resolved()
        assert encoder_state(enc) == encoder_state(ref)
    assert enc.finalize() == ref.finalize() == len(h)
    assert encoder_state(enc) == encoder_state(ref)


@pytest.mark.parametrize("bad", [
    {"type": "invoke", "process": 2, "f": "add", "value": 1},
    {"type": "invoke", "process": 2, "f": "cas", "value": [1, 2, 3]}])
def test_register_encoder_bail_resumes_in_python(bad, ref_ingest,
                                                 port_path):
    """An op the encoder cannot encode: the C stops AT it (its cursor
    there), counts an ``encode-bail``, and the Python twin raises from
    the same op with the same stream and slots before it. (A Python loop
    that raises keeps the cursor where its call began.)"""
    h = register_history(60, n_procs=3, seed=5, n_values=4)
    at = len(h) // 2
    h = h[:at] + [bad, {"type": "ok", "process": 2, "f": bad["f"],
                        "value": bad["value"]}] + h[at:]
    enc, ref = LiveRegisterEncoder(Intern()), _ref_encoder()
    reg = telemetry.Registry()
    with telemetry.use(reg):
        enc.add_many(h)
        ref.add_many(h)
        with pytest.raises(ValueError) as got:
            enc.encode_resolved()
    with pytest.raises(ValueError) as want:
        ref.encode_resolved()
    assert type(got.value) is type(want.value)
    cursor = 8  # encoder_state's _next
    assert encoder_state(enc)[:cursor] == encoder_state(ref)[:cursor]
    assert encoder_state(enc)[cursor + 1:] == encoder_state(ref)[cursor + 1:]
    assert len(enc.stream) > 0 and max(enc.stream.op_index) < at
    counts = {r["labels"]["reason"]: r["value"] for r in reg.snapshot()
              if r["name"] == "native_ingest_fallback_total"}
    if port_path == "c":
        assert enc._next == at
        # the add's eager encode and encode_resolved's retry
        assert counts == {"encode-bail": 2}
    else:
        assert counts == {}


def test_custom_encode_args_take_the_python_loops():
    """An encoder with its own ``encode_args`` is outside the C's regime:
    the per-op loops run, each miss counted ``regime``."""
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    h = register_history(50, n_procs=3, seed=6, n_values=4)
    default = LiveRegisterEncoder(Intern())
    custom = LiveRegisterEncoder(Intern(), encode_args=default.encode_args)
    reg = telemetry.Registry()
    with telemetry.use(reg):
        custom.add_many(h)
        custom.finalize()
    assert list(custom.stream.kind) == encode_register_ops(h).kind.tolist()
    counts = {r["labels"]["reason"]: r["value"] for r in reg.snapshot()
              if r["name"] == "native_ingest_fallback_total"}
    assert counts == {"regime": 2}


# ---------------------------------------------------------------------------
# the frontier closure
# ---------------------------------------------------------------------------

def frontier_state(fs) -> tuple:
    r = fs.result()
    return (fs.configs, fs.cur, fs.cur_idx, fs.pending_mask, fs.configs_max,
            fs.events_absorbed, r.valid, r.failed_event, r.failed_op_index,
            r.configs_max, r.final_configs)


def _stream(h):
    enc = LiveRegisterEncoder(Intern())
    enc.add_many(h)
    enc.finalize()
    return enc.stream


@pytest.mark.parametrize("case,chunk", [("valid", 97), ("valid", 10 ** 6),
                                        ("corrupt", 131), ("corrupt", 10 ** 6),
                                        ("crashed", 211)])
def test_frontier_absorb_matches_jax(case, chunk, ref_ingest, port_path):
    from jepsen_tpu.checker.linear_cpu import FrontierSession as RefSession
    h = register_history(600, n_procs=6, seed=7, n_values=5)
    if case == "corrupt":
        h = corrupt_reads(h, n=2, seed=3)
    elif case == "crashed":
        h = [dict(op, type="info") if op["type"] == "ok" and i % 37 == 0
             else op for i, op in enumerate(h)]
    st = _stream(h)
    fs, ref = FrontierSession(algorithm="a"), RefSession(algorithm="a")
    reg = telemetry.Registry()
    n = len(st.kind)
    with telemetry.use(reg):
        for lo in range(0, n, chunk):
            hi = min(n, lo + chunk)
            got = fs.absorb(st, lo, hi)
            want = ref.absorb(st, lo, hi)
            assert vars(got) == vars(want)
            assert frontier_state(fs) == frontier_state(ref)
    assert (fs.result().valid is True) == (case != "corrupt")
    counts = {r["labels"]["reason"]: r["value"] for r in reg.snapshot()
              if r["name"] == "native_ingest_fallback_total"}
    assert counts == ({"frontier-dead": 1} if case == "corrupt"
                      and port_path == "c" else {})


def test_frontier_past_63_slots_bails_to_python():
    """A write at slot 63, past 63 crashed cas ops that never apply: the
    C's masks hold slots 0-62, so it returns None, counts a
    ``frontier-bail``, and the Python loop absorbs."""
    from jepsen_tpu.checker.linear_cpu import FrontierSession as RefSession
    h = [{"type": "invoke", "process": p, "f": "cas", "value": [99, 1]}
         for p in range(63)]
    h += [dict(op, type="info") for op in h]
    h += [{"type": t, "process": 100, "f": "write", "value": 1}
          for t in ("invoke", "ok")]
    h += [{"type": t, "process": 101, "f": "read", "value": 1}
          for t in ("invoke", "ok")]
    st = _stream(h)
    assert st.n_slots == 64
    reg = telemetry.Registry()
    fs, ref = FrontierSession(), RefSession()
    with telemetry.use(reg):
        fs.absorb(st)
    ref.absorb(st)
    assert frontier_state(fs) == frontier_state(ref)
    assert fs.result().valid is True
    counts = {r["labels"]["reason"]: r["value"] for r in reg.snapshot()
              if r["name"] == "native_ingest_fallback_total"}
    assert counts == {"frontier-bail": 1}
