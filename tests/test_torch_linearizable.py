"""jepsen_tpu_torch's LinearizableChecker against jepsen_tpu's on the
same histories: the same ``valid?`` and, for invalid histories, the same
``failed-op`` (and the same dying configurations)."""
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


HISTORIES = {
    "valid": lambda: register_history(200, n_procs=3, seed=3, n_values=5),
    "invalid": lambda: corrupt_reads(
        register_history(200, n_procs=3, seed=4, n_values=5), n=2, seed=1),
    "crashed": lambda: _crashed(
        register_history(150, n_procs=3, seed=5, n_values=4)),
    "crashed_invalid": lambda: corrupt_reads(_crashed(
        register_history(150, n_procs=4, seed=6, n_values=4)), n=1, seed=2),
}


@pytest.fixture
def small_matrix_regime(monkeypatch):
    """Admits these short histories to the port's matrix rung."""
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(jitlin, "MATRIX_MIN_RETURNS", 10)


@pytest.mark.parametrize("case", sorted(HISTORIES))
@pytest.mark.parametrize("accelerator", ["gpu", "cpu", "auto"])
def test_checker_matches_jax(case, accelerator, small_matrix_regime):
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = HISTORIES[case]()
    ref = ref_lin(accelerator="cpu").check({}, h, {"explain": False})
    got = linearizable(accelerator=accelerator, device="cpu").check(
        {}, h, {"explain": False})
    assert got["valid?"] == ref["valid?"]
    assert got["valid?"] is not case.endswith("invalid")
    if got["valid?"] is False:
        assert got["failed-op"] == ref["failed-op"]
        assert got["context"] == ref["context"]
        assert got["final-configs"] == ref["final-configs"]
    if accelerator == "gpu":
        # invalid histories pass the matrix rung on to the frontier rung,
        # which settles them with the failing event
        assert got["algorithm"] == ("torch-matrix" if got["valid?"]
                                    else "torch-frontier")
    else:   # cpu, and auto below AUTO_TPU_THRESHOLD events: the native rung
        assert got["algorithm"] == ref["algorithm"] == "jitlin-native"


@pytest.mark.parametrize("case", sorted(HISTORIES))
def test_frontier_rung_matches_jax_device_regime(case):
    """Below MATRIX_MIN_RETURNS both checkers settle on their frontier
    rung (the JAX package's ``jitlin-device``, its scan jitted on the CPU
    backend): the same verdict, ``configs-max`` (the frontier's peak),
    and for invalid histories the same failing op, context and final
    configurations."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = HISTORIES[case]()
    ref = ref_lin(accelerator="tpu").check({}, h, {"explain": False})
    got = linearizable(accelerator="gpu", device="cpu").check(
        {}, h, {"explain": False})
    assert (ref["algorithm"], got["algorithm"]) == ("jitlin-tpu",
                                                    "torch-frontier")
    assert got["valid?"] == ref["valid?"]
    assert got["configs-max"] == ref["configs-max"] > 1
    if got["valid?"] is False:
        for key in ("failed-op", "context", "final-configs"):
            assert got[key] == ref[key], key


def test_initial_value_interns_first(small_matrix_regime):
    """A non-None initial register value is the initial state on both
    rungs."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu.models import CASRegister as RefReg
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.models import CASRegister

    h = [{"type": "invoke", "process": 0, "f": "read", "value": None},
         {"type": "ok", "process": 0, "f": "read", "value": 3}] * 20
    for acc in ("gpu", "cpu"):
        got = linearizable(CASRegister(3), accelerator=acc,
                           device="cpu").check({}, h, {})
        assert got["valid?"] is True
        assert linearizable(accelerator=acc, device="cpu").check(
            {}, h, {})["valid?"] is False
    assert ref_lin(RefReg(3), accelerator="cpu").check(
        {}, h, {"explain": False})["valid?"] is True


def test_checker_rejects_unported_models_and_accelerators():
    """Every model is ported: a model without a transition (the bare
    ``Model``) is taken and its search raises, as the reference's does;
    an accelerator or algorithm the port does not have is refused."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu.models import Model as RefModel
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.models import Model

    h = register_history(10, n_procs=2, seed=1)
    chk = LinearizableChecker(model=Model())
    with pytest.raises(NotImplementedError):
        chk.check({}, h, {})
    with pytest.raises(NotImplementedError):
        ref_lin(RefModel()).check({}, h, {"explain": False})
    with pytest.raises(ValueError):
        LinearizableChecker(accelerator="tpu")
    with pytest.raises(ValueError):
        LinearizableChecker(algorithm="linear")


def _thirty_two_slots():
    """A valid history whose stream has exactly 32 slots: process 100
    writes 0, processes 0-30 each invoke ``cas [i, i+1]`` and crash, and
    process 200 reads 31 (all 31 cas ops linearized in turn)."""
    h = [{"type": "invoke", "process": 100, "f": "write", "value": 0},
         {"type": "ok", "process": 100, "f": "write", "value": 0}]
    h += [{"type": "invoke", "process": i, "f": "cas", "value": [i, i + 1]}
          for i in range(31)]
    h += [{"type": "info", "process": i, "f": "cas", "value": [i, i + 1]}
          for i in range(31)]
    h += [{"type": "invoke", "process": 200, "f": "read", "value": None},
          {"type": "ok", "process": 200, "f": "read", "value": 31}]
    return h


def _thirty_two_slot_checks(device):
    """The 32-slot history through the single-history checker and the
    independent checker's batched lane on ``device``: both valid, both
    past the frontier rung (FRONTIER_MAX_SLOTS) into the exact twin."""
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.checker.linearizable import (FRONTIER_MAX_SLOTS,
                                                       linearizable)

    h = _thirty_two_slots()
    assert encode_register_ops(h).n_slots == 32 > FRONTIER_MAX_SLOTS
    got = linearizable(accelerator="gpu", device=device).check(
        {}, h, {"explain": False})
    assert got["valid?"] is True
    assert got["algorithm"].startswith("jitlin-cpu")
    lifted = [dict(op, value=independent.tuple_value("k", op["value"]))
              for op in h]
    lifted += [dict(op, value=independent.tuple_value("j", op["value"]))
               for op in register_history(60, n_procs=3, seed=7,
                                          n_values=4)]
    out = independent.checker(linearizable(accelerator="gpu",
                                           device=device)).check(
        {}, lifted, {"explain": False})
    assert (out["valid?"], out["failures"], out["count"]) == (True, [], 2)
    assert out["results"]["k"]["algorithm"].startswith("jitlin-cpu")


def test_thirty_two_slots_settle_valid_in_the_twin():
    """The sparse frontier's empty entry is mask 0xFFFFFFFF, which a live
    configuration with all 32 slots linearized also has; so a 32-slot
    stream skips the frontier rung and the batched lane and settles in
    the exact twin, valid, as ``jepsen_tpu``'s ``check_stream`` says.

    The JAX package's own ``jitlin-tpu`` rung takes the stream and
    returns False: the fault is in the reference (recorded here), and
    the port does not copy it."""
    from jepsen_tpu.checker.linear_cpu import check_stream as ref_check
    from jepsen_tpu.checker.linear_encode import (
        encode_register_ops as ref_encode)
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin

    h = _thirty_two_slots()
    assert ref_check(ref_encode(h)).valid is True
    _thirty_two_slot_checks("cpu")
    ref = ref_lin(accelerator="tpu").check({}, h, {"explain": False})
    assert (ref["valid?"], ref["algorithm"]) == (False, "jitlin-tpu")


@pytest.mark.cuda
def test_thirty_two_slots_settle_valid_on_card():
    """The same 32-slot history through both checks on the card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _thirty_two_slot_checks("cuda")
