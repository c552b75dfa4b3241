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
    from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
    from jepsen_tpu_torch.models import Model

    with pytest.raises(TypeError):
        LinearizableChecker(model=Model())
    with pytest.raises(ValueError):
        LinearizableChecker(accelerator="tpu")
