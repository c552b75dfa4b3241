"""jepsen_tpu_torch.ops.jitlin against jepsen_tpu.ops.jitlin on the CPU:
``matrix_check`` and ``matrix_check_resume`` give the same (alive,
inexact) and the same carried ``total``, bit for bit (tolerance zero:
0/1 operators). The JAX side runs its Pallas kernels in interpret mode
(``FORCE_INTERPRET``, variant f32), as tests/test_pallas_matrix.py does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import corrupt_reads, register_history


def _crashed(history, every=7):
    """A copy in which every ``every``-th ok completion of a write/cas
    becomes info (a crashed op stays pending forever)."""
    out, n = [], 0
    for op in history:
        op = dict(op)
        if op["type"] == "ok" and op["f"] != "read":
            n += 1
            if n % every == 0:
                op["type"] = "info"
        out.append(op)
    return out


def _histories():
    ok = register_history(60, n_procs=3, seed=5, n_values=4)
    return {
        "valid": ok,
        "invalid": corrupt_reads(register_history(60, n_procs=3, seed=6,
                                                  n_values=4)),
        "crashed": _crashed(register_history(50, n_procs=3, seed=8,
                                             n_values=3)),
    }


@pytest.fixture
def pallas_interpret(monkeypatch):
    import jepsen_tpu.ops.pallas_matrix as pm
    monkeypatch.setattr(pm, "FORCE_INTERPRET", True)


def _streams(history):
    from jepsen_tpu.checker.linear_encode import encode_register_ops as ref_enc
    from jepsen_tpu.checker.linear_encode import stream_to_columns
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.convert import stream_from_columns

    ref = ref_enc(history)
    port = encode_register_ops(history)
    # the port's encoder and the column conversion agree with the JAX
    # encoder field for field
    conv = stream_from_columns(stream_to_columns(ref))
    for s in (port, conv):
        for k in ("kind", "slot", "f", "a", "b", "op_index"):
            assert np.array_equal(getattr(s, k), getattr(ref, k)), k
        assert (s.n_slots, s.n_ops) == (ref.n_slots, ref.n_ops)
        assert s.intern.table == ref.intern.table
    return ref, port


@pytest.mark.parametrize("case", ["valid", "invalid", "crashed"])
def test_matrix_check_matches_jax(case, pallas_interpret):
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.ops import jitlin

    ref_s, s = _streams(_histories()[case])
    ref = ref_jit.matrix_check(ref_s, force=True, variant="f32")
    got = jitlin.matrix_check(s, force=True, device="cpu")
    assert got == ref
    assert got[0] is (check_stream(s).valid is True)
    assert got[0] is {"valid": True, "invalid": False,
                      "crashed": True}[case]
    assert jitlin.last_dispatch_info() == {"products": "torch",
                                           "combine": "torch"}


def test_matrix_check_oob_is_inexact(pallas_interpret):
    """A state id escaping the [0, V) bucket (num_states understated)
    flags inexact in both packages, with the same verdict."""
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin

    h = register_history(60, n_procs=3, seed=9, n_values=12)
    ref_s, s = _streams(h)
    assert len(s.intern) > 8
    ref = ref_jit.matrix_check(ref_s, force=True, num_states=4,
                               variant="f32")
    got = jitlin.matrix_check(s, force=True, num_states=4, device="cpu")
    assert got == ref
    assert got[2] is True


@pytest.fixture
def small_matrix_budget(monkeypatch):
    """One chunk per history in both packages, so that the MV = 1024
    products of the scan route stay a few seconds on the CPU."""
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin
    for mod in (ref_jit, jitlin):
        monkeypatch.setattr(mod, "MATRIX_MAX_ELEMS", 1 << 20)


def test_matrix_check_gates(small_matrix_budget):
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin

    h = register_history(60, n_procs=3, seed=5, n_values=4)
    ref_s, s = _streams(h)
    # below MATRIX_MIN_RETURNS without force: out of regime
    assert jitlin.matrix_check(s, device="cpu") is None
    # MV = 2^S * V beyond the kernel's shared-memory regime: the scan
    # route gives the reference's verdict
    assert jitlin.kernel_ok(6, 8) and not jitlin.kernel_ok(6, 16)
    got = jitlin.matrix_check(s, force=True, num_states=100, device="cpu")
    assert got == ref_jit.matrix_check(ref_s, force=True, num_states=100)
    assert got == (True, -1, False, 0)
    assert jitlin.last_dispatch_info() == {"products": "scan",
                                           "combine": "scan"}


def _mv1024_history(case):
    """Six processes over 9-16 values: S = 6, V = 16, MV = 1024."""
    h = register_history(70, n_procs=6, seed=21, n_values=12)
    return corrupt_reads(h, n=1, seed=4) if case == "invalid" else h


@pytest.mark.parametrize("case", ["valid", "invalid"])
def test_scan_route_mv1024_matches_jax_scan_total(case,
                                                  small_matrix_budget):
    """Above KERNEL_MAX_MV the matrix path runs the reference's XLA
    route (``_scan_products``/``_scan_total``) as torch batched
    products: the same (alive, inexact) as the JAX package's scan."""
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin

    ref_s, s = _streams(_mv1024_history(case))
    S, V = s.n_slots, jitlin._bucket(len(s.intern), floor=8)
    assert (1 << S) * V == 1024
    ref = ref_jit.matrix_check(ref_s, force=True)
    assert ref_jit.last_dispatch_info()["variant"] == "scan"
    got = jitlin.matrix_check(s, force=True, device="cpu")
    assert got == ref
    assert got[0] is (case == "valid")
    assert jitlin.last_dispatch_info()["products"] == "scan"


def test_scan_route_resume_two_segments(small_matrix_budget):
    """``matrix_check_resume`` at MV = 1024 (where the CUDA kernels do
    not reach) over two quiescent segments: each segment's (alive,
    inexact, total) equals the JAX package's, and the chain equals the
    one-shot check."""
    from jepsen_tpu.checker.linear_encode import EventStream as RefStream
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.linear_encode import EventStream
    from jepsen_tpu_torch.ops import jitlin

    ref_s, s = _streams(_mv1024_history("valid"))
    cut = ref_jit.quiescent_cuts(ref_s.kind, len(ref_s) // 2 + 8)[0]
    assert 0 < cut < len(s)

    def seg(cls, st, lo, hi):
        return cls(kind=st.kind[lo:hi], slot=st.slot[lo:hi], f=st.f[lo:hi],
                   a=st.a[lo:hi], b=st.b[lo:hi],
                   op_index=st.op_index[lo:hi], n_slots=st.n_slots,
                   n_ops=st.n_ops, intern=st.intern)

    kw = dict(num_states=len(s.intern), n_slots=s.n_slots)
    a1, i1, t1 = ref_jit.matrix_check_resume(seg(RefStream, ref_s, 0, cut),
                                             **kw)
    pa1, pi1, pt1 = jitlin.matrix_check_resume(
        seg(EventStream, s, 0, cut), device="cpu", **kw)
    a2, i2, t2 = ref_jit.matrix_check_resume(
        seg(RefStream, ref_s, cut, len(ref_s)), tot0=t1, **kw)
    pa2, pi2, pt2 = jitlin.matrix_check_resume(
        seg(EventStream, s, cut, len(s)), tot0=pt1, device="cpu", **kw)
    for p, r in ((pt1, t1), (pa1, a1), (pi1, i1), (pt2, t2), (pa2, a2),
                 (pi2, i2)):
        assert np.array_equal(p.float().numpy(),
                              np.asarray(r, dtype=np.float32))
    assert pt2.shape == (1, 1024, 1024)
    assert bool(pa2[0]) is jitlin.matrix_check(s, force=True,
                                               device="cpu")[0] is True


def test_resume_two_segments_from_jax_carry(pallas_interpret):
    """Segment 1 in JAX, segment 2 resumed by the port from JAX's carry:
    the same (alive, inexact, total) as JAX resuming itself, and the
    port's own segment-1 carry equals JAX's."""
    from jepsen_tpu.checker.linear_encode import EventStream as RefStream
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.linear_encode import EventStream
    from jepsen_tpu_torch.convert import carry_from_numpy
    from jepsen_tpu_torch.ops import jitlin

    h = _crashed(register_history(80, n_procs=3, seed=11, n_values=4),
                 every=1000)
    ref_s, s = _streams(h)
    cut = ref_jit.quiescent_cuts(ref_s.kind, len(ref_s) // 2 + 8)[0]
    assert 0 < cut < len(s)

    def seg(cls, st, lo, hi):
        return cls(kind=st.kind[lo:hi], slot=st.slot[lo:hi], f=st.f[lo:hi],
                   a=st.a[lo:hi], b=st.b[lo:hi],
                   op_index=st.op_index[lo:hi], n_slots=st.n_slots,
                   n_ops=st.n_ops, intern=st.intern)

    S, nst = s.n_slots, len(s.intern)
    kw = dict(num_states=nst, n_slots=S)
    a1, i1, t1 = ref_jit.matrix_check_resume(
        seg(RefStream, ref_s, 0, cut), variant="f32", **kw)
    pa1, pi1, pt1 = jitlin.matrix_check_resume(
        seg(EventStream, s, 0, cut), device="cpu", **kw)
    t1_np = np.asarray(t1, dtype=np.float32)
    assert np.array_equal(pt1.float().numpy(), t1_np)
    assert np.array_equal(pa1.numpy(), np.asarray(a1))
    assert np.array_equal(pi1.numpy(), np.asarray(i1))

    a2, i2, t2 = ref_jit.matrix_check_resume(
        seg(RefStream, ref_s, cut, len(ref_s)), tot0=t1, variant="f32",
        **kw)
    pa2, pi2, pt2 = jitlin.matrix_check_resume(
        seg(EventStream, s, cut, len(s)),
        tot0=carry_from_numpy(t1_np, device="cpu"), device="cpu", **kw)
    assert pt2.dtype == torch.bfloat16
    assert np.array_equal(pt2.float().numpy(),
                          np.asarray(t2, dtype=np.float32))
    assert np.array_equal(pa2.numpy(), np.asarray(a2))
    assert np.array_equal(pi2.numpy(), np.asarray(i2))
    # the chain equals one monolithic check
    assert bool(pa2[0]) is jitlin.matrix_check(s, force=True,
                                               device="cpu")[0]


def test_resume_rejects_mismatched_carry():
    from jepsen_tpu_torch.ops import jitlin

    _, s = _streams(register_history(30, n_procs=2, seed=1, n_values=3))
    with pytest.raises(ValueError):
        jitlin.matrix_check_resume(s, tot0=torch.zeros(1, 8, 8),
                                   device="cpu")


def test_batch_matches_singles():
    """One dispatch over B keys gives each key's single verdict."""
    from jepsen_tpu_torch.ops import jitlin

    hs = list(_histories().values())
    streams = [_streams(h)[1] for h in hs]
    n = max(len(st.intern) for st in streams)
    batch = jitlin.matrix_check_batch(streams, num_states=n, device="cpu")
    singles = [jitlin.matrix_check(st, force=True, num_states=n,
                                   device="cpu") for st in streams]
    assert batch == singles


def test_entry_points_need_cuda_unless_cpu_is_asked(monkeypatch):
    from jepsen_tpu_torch.device import resolve_device
    from jepsen_tpu_torch.ops import jitlin

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    _, s = _streams(register_history(30, n_procs=2, seed=1, n_values=3))
    with pytest.raises(RuntimeError, match="CUDA"):
        jitlin.matrix_check(s, force=True)
    assert resolve_device("cpu").type == "cpu"
