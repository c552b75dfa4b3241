"""jepsen_tpu_torch.native (the C++ search, built by g++ into the port's
own build directory) against jepsen_tpu.native and against the port's
Python twin ``check_stream``: the same verdict, failing event and op,
and peak, on valid, invalid, crashed and fresh-value histories, and the
same declines past 63 slots (-2) and past a small ``max_configs`` (-1).
Every result is an integer or a flag, so the tolerance is zero. The
``native-c`` rung of the port's checker reports ``jitlin-native`` with
the JAX package's result map."""
from __future__ import annotations

import pytest

from jepsen_tpu_torch.histories import corrupt_reads, register_history


def _crashed(history, every=40):
    out, n = [], 0
    for op in history:
        op = dict(op)
        if op["type"] == "ok" and op["f"] != "read":
            n += 1
            if n % every == 0:
                op["type"] = "info"
        out.append(op)
    return out


def _wide_cas(n_procs):
    """Every one of ``n_procs`` processes invokes a CAS from 1 (a value no
    write produced) before any returns: ``n_procs`` slots at once, and an
    invalid history that dies at its first return. No CAS applies, so the
    closure stays one configuration wide."""
    inv = [{"type": "invoke", "process": p, "f": "cas", "value": [1, 2]}
           for p in range(n_procs)]
    ok = [{"type": "ok", "process": p, "f": "cas", "value": [1, 2]}
          for p in range(n_procs)]
    return inv + ok


HISTORIES = {
    "valid": lambda: register_history(400, n_procs=4, seed=11, n_values=5),
    "invalid": lambda: corrupt_reads(
        register_history(400, n_procs=4, seed=12, n_values=5), n=2, seed=3),
    "crashed": lambda: _crashed(
        register_history(300, n_procs=5, seed=13, n_values=4)),
    "crashed_invalid": lambda: corrupt_reads(_crashed(
        register_history(300, n_procs=5, seed=14, n_values=4)), n=1, seed=4),
    "fresh_values": lambda: register_history(400, n_procs=5, seed=15,
                                             n_values=10 ** 9),
    "fresh_values_invalid": lambda: corrupt_reads(register_history(
        400, n_procs=5, seed=16, n_values=10 ** 9), n=2, seed=5),
    "wide_cas_invalid": lambda: _wide_cas(63),
}

FIELDS = ("valid", "failed_event", "failed_op_index", "configs_max",
          "algorithm")


def _encode(history):
    from jepsen_tpu.checker.linear_encode import encode_register_ops as ref_enc
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    return ref_enc(history), encode_register_ops(history)


def _fields(res):
    return {k: getattr(res, k) for k in FIELDS}


@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_native_matches_jax_and_python_twin(case):
    from jepsen_tpu.native import check_stream_native as ref_native
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.native import check_stream_native

    ref_st, st = _encode(HISTORIES[case]())
    got = check_stream_native(st)
    ref = ref_native(ref_st)
    assert got is not None and ref is not None
    assert _fields(got) == _fields(ref)
    assert got.algorithm == "jitlin-native"
    twin = check_stream(st)
    assert (got.valid, got.failed_event, got.failed_op_index,
            got.configs_max) == (twin.valid, twin.failed_event,
                                 twin.failed_op_index, twin.configs_max)
    assert got.valid is not case.endswith("invalid")


def test_native_declines_past_63_slots():
    """64 slots at once: both searches return None (-2), and the port's
    checker settles on its Python twin (with the failing op the JAX
    package reports)."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu.native import check_stream_native as ref_native
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.native import check_stream_native

    h = _wide_cas(64)
    ref_st, st = _encode(h)
    assert st.n_slots == 64
    assert check_stream_native(st) is None
    assert ref_native(ref_st) is None
    out = linearizable(accelerator="cpu").check({}, h, {})
    ref = ref_lin(accelerator="cpu").check({}, h, {"explain": False})
    assert (out["valid?"], out["algorithm"]) == (False, "jitlin-cpu")
    assert (ref["valid?"], ref["algorithm"]) == (False, "jitlin-cpu")
    assert out["failed-op"] == ref["failed-op"] == h[64]


@pytest.mark.parametrize("max_configs", [1, 4, 20])
def test_native_capacity_is_unknown(max_configs):
    """Past ``max_configs`` live configurations both searches answer
    "unknown" with the same peak; the checker's rung passes the history
    on to the Python twin."""
    from jepsen_tpu.native import check_stream_native as ref_native
    from jepsen_tpu_torch.native import check_stream_native

    ref_st, st = _encode(register_history(300, n_procs=5, seed=17,
                                          n_values=10 ** 9))
    got = check_stream_native(st, max_configs=max_configs)
    ref = ref_native(ref_st, max_configs=max_configs)
    assert got.valid == "unknown"
    assert _fields(got) == _fields(ref)


@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_linearizable_cpu_takes_native_rung(case):
    """``accelerator="cpu"``: the port's checker settles on the native
    rung with the JAX package's result map."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = HISTORIES[case]()
    ref = ref_lin(accelerator="cpu").check({}, h, {"explain": False})
    got = linearizable(accelerator="cpu").check({}, h, {"explain": False})
    assert got == ref
    assert got["algorithm"] == "jitlin-native"


def test_native_rung_not_after_device_rungs():
    """The native rung runs on the host regime only: under "gpu" an
    overflowed frontier goes to the Python twin, and "auto" from
    AUTO_TPU_THRESHOLD events up takes the device rungs."""
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = corrupt_reads(register_history(1300, n_procs=5, seed=18,
                                       n_values=10 ** 9), n=2, seed=6)
    got = linearizable(accelerator="gpu", device="cpu",
                       capacity=2).check({}, h, {})
    assert (got["valid?"], got["algorithm"]) == (False,
                                                 "jitlin-cpu(fallback)")
    got = linearizable(accelerator="auto", device="cpu").check({}, h, {})
    assert (got["valid?"], got["algorithm"]) == (False, "torch-frontier")


def test_native_build_raises_with_compiler_output(tmp_path, monkeypatch):
    """A source g++ refuses raises, with the compiler's message; nothing
    falls back to the Python search."""
    from jepsen_tpu_torch import native

    bad = tmp_path / "wgl.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_native_build_is_reused(tmp_path, monkeypatch):
    """A library built from the same source and flags is reused; another
    source gets another name."""
    from jepsen_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    so = native.build()
    assert so.parent == tmp_path and so.exists()
    mtime = so.stat().st_mtime_ns
    assert native.build() == so and so.stat().st_mtime_ns == mtime
    src = tmp_path / "wgl.cpp"
    src.write_text(native.SRC.read_text() + "\n// another source\n")
    monkeypatch.setattr(native, "SRC", src)
    assert native._so_path() != so
