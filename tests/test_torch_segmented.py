"""The segmented chains of jepsen_tpu_torch.ops.jitlin against
jepsen_tpu.ops.jitlin on the CPU: ``quiescent_cuts``, the matrix chain
``matrix_check_segmented`` (its verdict and the carry it sinks at every
cut), the frontier chain ``segmented_check`` on the dense table and the
sparse list, and the hand-off of a matrix carry to the exact CPU frontier
(``checkpoint.frontier_from_matrix_carry``), each equal to the JAX
package's at tolerance zero. The segment bound is lowered in both
packages so that small seeded histories cross cuts. The ``cuda``-marked
case holds the port's chains on the card against its own CPU run."""
from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import corrupt_reads, register_history

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_resume import _streams, block_history  # noqa: E402


def _crashed(history, every=5):
    """A copy whose every ``every``-th ok write crashes (info): the op
    stays pending forever, so no cut falls after it."""
    out, n = [], 0
    for op in history:
        op = dict(op)
        if op["type"] == "ok" and op["f"] == "write":
            n += 1
            if n == every:
                op["type"] = "info"
        out.append(op)
    return out


# ---------------------------------------------------------------------------
# 1. quiescent_cuts
# ---------------------------------------------------------------------------

KINDS = {
    "blocks": lambda: _streams(block_history(300))[1].kind,
    "five_procs": lambda: _streams(register_history(
        400, n_procs=5, seed=3, n_values=5))[1].kind,
    "crashed": lambda: _streams(_crashed(register_history(
        300, n_procs=3, seed=4, n_values=5)))[1].kind,
    # long windows with no quiescent point, a no-op tail, and an empty
    # stream
    "synthetic": lambda: np.array([0, 0, 1, 2, 1, 0, 0, 0, 1, 1, 1, 2, 2, 0,
                                   1, 2], np.int8),
    "empty": lambda: np.zeros((0,), np.int8),
}


@pytest.mark.parametrize("max_segment", [1, 3, 7, 64, 256, 1 << 20])
@pytest.mark.parametrize("which", sorted(KINDS))
def test_quiescent_cuts_match_jax(which, max_segment):
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin

    kind = KINDS[which]()
    got = jitlin.quiescent_cuts(kind, max_segment)
    assert got == ref_jit.quiescent_cuts(kind, max_segment)
    assert all(isinstance(c, int) for c in got)
    if len(kind):
        assert got[-1] == len(kind) and got == sorted(set(got))


# ---------------------------------------------------------------------------
# 2. the matrix chain
# ---------------------------------------------------------------------------

CHAINS = {
    "valid": lambda: block_history(600),
    "late_anomaly": lambda: block_history(600, plant_anomaly_at=500),
    "first_segment_anomaly": lambda: block_history(600, plant_anomaly_at=20),
    "four_procs": lambda: register_history(700, n_procs=4, seed=8,
                                           n_values=4),
    "four_procs_invalid": lambda: corrupt_reads(
        register_history(700, n_procs=4, seed=9, n_values=4), n=1, seed=5),
    "crashed": lambda: _crashed(register_history(500, n_procs=3, seed=10,
                                                 n_values=4), every=40),
}


@pytest.mark.parametrize("case", sorted(CHAINS))
def test_matrix_chain_matches_jax(case, monkeypatch):
    """The chain's verdict and every sunk carry equal the JAX package's;
    the last carry of a valid chain equals one ``matrix_check_resume`` of
    the whole stream, and its verdict the one-shot ``matrix_check``'s."""
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin

    for mod in (jitlin, ref_jit):
        monkeypatch.setattr(mod, "MATRIX_SEGMENT_EVENTS", 512)
    ref_s, s = _streams(CHAINS[case]())
    got_c, ref_c = [], []
    got = jitlin.matrix_check_segmented(s, carry_sink=got_c.append,
                                        device="cpu")
    ref = ref_jit.matrix_check_segmented(ref_s, carry_sink=ref_c.append)
    assert got == ref
    assert len(got_c) == len(ref_c)
    for g, r in zip(got_c, ref_c):
        assert {k: v for k, v in g.items() if k != "tot0"} == \
            {k: v for k, v in r.items() if k != "tot0"}
        assert g["tot0"].dtype == torch.bfloat16
        assert np.array_equal(g["tot0"].float().numpy(),
                              np.asarray(r["tot0"], dtype=np.float32))
    cuts = jitlin.quiescent_cuts(s.kind, 512)
    assert [c["events_done"] for c in got_c] == cuts[:len(got_c)]
    one = jitlin.matrix_check(s, force=True, device="cpu")
    assert got[0] == one[0]
    if got[0]:
        assert len(got_c) == len(cuts)
        _, _, total = jitlin.matrix_check_resume(
            s, num_states=len(s.intern), n_slots=s.n_slots, device="cpu")
        assert torch.equal(got_c[-1]["tot0"], total)
    assert [seg["end"] for seg in jitlin.last_segment_seconds()] == \
        cuts[:len(got_c) + (not got[0])]


def test_inexact_segment_aborts_unsunk():
    """A segment whose transition leaves [0, V) (the state count
    understated) aborts the chain as inexact without sinking its carry,
    in both packages."""
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin

    h = block_history(300) + register_history(60, n_procs=3, seed=9,
                                              n_values=12)
    ref_s, s = _streams(h)
    assert len(s.intern) > 8
    got_c, ref_c = [], []
    got = jitlin.matrix_check_segmented(s, num_states=4, max_segment=256,
                                        carry_sink=got_c.append,
                                        device="cpu")
    ref = ref_jit.matrix_check_segmented(ref_s, num_states=4,
                                         max_segment=256,
                                         carry_sink=ref_c.append)
    assert got == ref and got[2] is True
    assert len(got_c) == len(ref_c) > 0
    assert got_c[-1]["events_done"] < len(s)


def test_carry_resumes_in_process():
    """A sunk carry passed back in resumes the chain at its cut: the same
    verdict, and only the segments after the cut run."""
    from jepsen_tpu_torch.ops import jitlin

    s = _streams(block_history(600, plant_anomaly_at=500))[1]
    carries = []
    full = jitlin.matrix_check_segmented(s, max_segment=512, device="cpu",
                                         carry_sink=carries.append)
    got = jitlin.matrix_check_segmented(s, max_segment=512, device="cpu",
                                        carry=carries[1])
    assert got == full
    assert [seg["base"] for seg in jitlin.last_segment_seconds()][0] == \
        carries[1]["events_done"]
    # a carry that does not fit the stream restarts the chain
    bad = dict(carries[1], V=16)
    assert jitlin.matrix_check_segmented(s, max_segment=512, device="cpu",
                                         carry=bad) == full
    assert jitlin.last_segment_seconds()[0]["base"] == 0


# ---------------------------------------------------------------------------
# 3. the frontier chain
# ---------------------------------------------------------------------------

def _fresh(n_ops, seed, bad=False):
    h = register_history(n_ops, n_procs=3, seed=seed, n_values=10 ** 9)
    return corrupt_reads(h, n=1, seed=2) if bad else h


SCANS = {
    "dense_valid": (lambda: block_history(300), 256, 256),
    "dense_invalid": (lambda: block_history(300, plant_anomaly_at=200),
                      256, 256),
    "dense_five_procs": (lambda: corrupt_reads(register_history(
        500, n_procs=5, seed=12, n_values=5), n=1, seed=1), 300, 256),
    "sparse_valid": (lambda: _fresh(1100, 5), 512, 256),
    "sparse_invalid": (lambda: _fresh(1100, 6, bad=True), 512, 256),
    "sparse_overflow": (lambda: _fresh(1100, 7), 700, 2),
}


@pytest.mark.parametrize("case", sorted(SCANS))
def test_segmented_check_matches_jax(case):
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.ops import jitlin

    make, seg, K = SCANS[case]
    ref_s, s = _streams(make())
    route = "dense" if jitlin._dense_ok(s.n_slots, len(s.intern)) \
        else "sparse"
    assert case.startswith(route)
    got = jitlin.segmented_check(
        s, max_segment=seg, capacity=K,
        kernel=jitlin.JitLinKernel(device="cpu"))
    ref = ref_jit.segmented_check(ref_s, max_segment=seg, capacity=K)
    assert got == ref
    assert len(jitlin.quiescent_cuts(s.kind, seg)) > 1
    if case.endswith("_invalid") or case == "dense_five_procs":
        assert got[0] is False and got[1] > 0
    elif case.endswith("_valid"):
        assert got[0] is True and got[1] == -1
    else:
        assert got[2] is True
    # one segment: the kernel's one-shot scan gives the same verdict
    one = jitlin.JitLinKernel(device="cpu").check(s, capacity=K)
    assert one[:3] == got[:3]


# ---------------------------------------------------------------------------
# 9. the matrix carry's hand-off to the exact CPU frontier
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plant", [None, 560])
def test_frontier_from_matrix_carry_matches_jax(plant):
    from jepsen_tpu.checker.checkpoint import (
        frontier_from_matrix_carry as ref_handoff)
    from jepsen_tpu.checker.linear_cpu import check_stream as ref_check
    from jepsen_tpu.checker.linear_cpu import cas_register_step_py as ref_step
    from jepsen_tpu.ops import jitlin as ref_jit
    from jepsen_tpu_torch.checker.checkpoint import frontier_from_matrix_carry
    from jepsen_tpu_torch.checker.linear_cpu import cas_register_step_py
    from jepsen_tpu_torch.ops import jitlin

    ref_s, s = _streams(block_history(600, plant_anomaly_at=plant))
    cut = len(s) // 2
    cut -= cut % 4   # block-aligned: quiescent
    got_c, ref_c = [], []
    jitlin.matrix_check_segmented(jitlin._slice_stream(s, 0, cut),
                                  max_segment=512, device="cpu",
                                  carry_sink=got_c.append)
    ref_jit.matrix_check_segmented(ref_jit._slice_stream(ref_s, 0, cut),
                                   max_segment=512, carry_sink=ref_c.append)
    assert got_c[-1]["events_done"] == ref_c[-1]["events_done"] == cut
    fs = frontier_from_matrix_carry(got_c[-1], cas_register_step_py, 0)
    ref_fs = ref_handoff(ref_c[-1], ref_step, 0)
    assert fs.configs == ref_fs.configs and len(fs.configs) >= 1
    assert fs.events_absorbed == ref_fs.events_absorbed == cut
    got = fs.absorb(s, start=cut)
    want = ref_check(ref_s)
    assert (got.valid, got.failed_event, got.failed_op_index) == \
        (want.valid, want.failed_event, want.failed_op_index)
    # a numpy carry hands off the same frontier
    np_carry = dict(got_c[-1], tot0=got_c[-1]["tot0"].float().numpy())
    assert frontier_from_matrix_carry(np_carry, cas_register_step_py,
                                      0).configs == fs.configs


def test_dead_or_nonquiescent_carry_declined():
    from jepsen_tpu.checker.checkpoint import (
        frontier_from_matrix_carry as ref_handoff)
    from jepsen_tpu_torch.checker.checkpoint import frontier_from_matrix_carry
    from jepsen_tpu_torch.checker.linear_cpu import cas_register_step_py

    V = 8
    dead = {"tot0": np.zeros((1, 2 * V, 2 * V), np.float32),
            "events_done": 4, "S": 1, "V": V, "init_state": 0}
    t = np.zeros((1, 2 * V, 2 * V), np.float32)
    t[0, V + 3, 0] = 1.0  # a live row with mask bit 0 set
    bad = dict(dead, tot0=t)
    for carry in (dead, bad):
        for tot in (carry["tot0"],
                    torch.from_numpy(carry["tot0"]).to(torch.bfloat16)):
            assert frontier_from_matrix_carry(
                dict(carry, tot0=tot), cas_register_step_py, 0) is None
        assert ref_handoff(carry, cas_register_step_py, 0) is None
    assert frontier_from_matrix_carry({"tot0": None}, cas_register_step_py,
                                      0) is None


# ---------------------------------------------------------------------------
# 13. the chains on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_chains_on_card_match_cpu(tmp_path):
    """The matrix chain (its carries bit-equal), its checkpoint resume,
    and the frontier chain on both kernels, on the card against the
    port's own CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from jepsen_tpu_torch.checker.checkpoint import CheckpointStore
    from jepsen_tpu_torch.ops import jitlin

    s = _streams(block_history(2000, plant_anomaly_at=1700))[1]
    cpu_c, gpu_c = [], []
    cpu = jitlin.matrix_check_segmented(s, max_segment=1024, device="cpu",
                                        carry_sink=cpu_c.append)
    gpu = jitlin.matrix_check_segmented(s, max_segment=1024, device="cuda",
                                        carry_sink=gpu_c.append)
    assert gpu == cpu and len(gpu_c) == len(cpu_c) > 1
    for g, c in zip(gpu_c, cpu_c):
        assert g["tot0"].is_cuda
        assert torch.equal(g["tot0"].cpu(), c["tot0"])
    path = tmp_path / "check.ckpt"
    full = jitlin.matrix_check_segmented(
        s, max_segment=1024, device="cuda",
        ckpt=CheckpointStore(path, interval_s=0.0, resume=False))
    assert path.exists()
    resumed = jitlin.matrix_check_segmented(
        s, max_segment=1024, device="cuda",
        ckpt=CheckpointStore(path, interval_s=None, resume=True))
    assert resumed == full == cpu
    assert len(jitlin.last_segment_seconds()) < \
        len(jitlin.quiescent_cuts(s.kind, 1024))
    for case in ("dense_invalid", "sparse_invalid", "sparse_overflow"):
        make, seg, K = SCANS[case]
        st = _streams(make())[1]
        want = jitlin.segmented_check(
            st, max_segment=seg, capacity=K,
            kernel=jitlin.JitLinKernel(device="cpu"))
        got = jitlin.segmented_check(
            st, max_segment=seg, capacity=K,
            kernel=jitlin.JitLinKernel(device="cuda"))
        assert got == want, case
