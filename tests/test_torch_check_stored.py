"""The port's stored-run re-checks against the JAX package's: each case
writes a store with the JAX package (``store.save_1``) and runs both
packages' ``check_stored`` with ``accelerator="cpu"``. Verdicts,
``failed-op`` and the Elle result maps must be equal; the algorithm names
differ by design. Also: an error inside the stored lane propagates. The
JAX package
is imported inside the tests, so that the card's twin, which compares
with the port's CPU run, collects where JAX is missing."""
from __future__ import annotations

import pytest

from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import linearizable as lin
from jepsen_tpu_torch.elle import list_append
from jepsen_tpu_torch.histories import (corrupt_reads, elle_history,
                                        register_history)
from jepsen_tpu_torch.ops import jitlin

TS = "20260102T000000"


def _save(tmp_path, name, h, writer=None):
    """Writes ``h`` to a store under ``tmp_path`` with the JAX package's
    ``store.save_1`` (or ``writer``'s write_history and write_columnar);
    returns check_stored's (name, timestamp, store_dir)."""
    test = {"name": name, "start_time": TS, "store_dir": str(tmp_path),
            "history": h}
    if writer is None:
        from jepsen_tpu import store as ref_store
        ref_store.save_1(test)
    else:
        writer.write_history(test)
        writer.write_columnar(test)
    return name, TS, str(tmp_path)


def _damage(tmp_path, name, how):
    p = tmp_path / name / TS / "history.npz"
    if how == "missing":
        p.unlink()
    elif how == "corrupt":
        p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])
    elif how == "malformed":
        # a sidecar that loads, with one lin_* column missing
        import numpy as np
        with np.load(p, allow_pickle=True) as z:
            arrays = {k: z[k] for k in z.files if k != "lin_intern_table"}
        with open(p, "wb") as f:
            np.savez(f, **arrays)


REGISTER = {
    "valid": lambda: register_history(100, n_procs=3, seed=7, n_values=4),
    "invalid": lambda: corrupt_reads(
        register_history(100, n_procs=3, seed=7, n_values=4), n=2, seed=1),
}


@pytest.mark.parametrize("damage", [None, "missing", "corrupt",
                                    "malformed"])
@pytest.mark.parametrize("kind", sorted(REGISTER))
def test_linearizable_check_stored_matches_jax(kind, damage, tmp_path):
    args = _save(tmp_path, f"lin-{kind}", REGISTER[kind]())
    if damage:
        _damage(tmp_path, args[0], damage)
    from jepsen_tpu.checker import linearizable as ref_lin
    got = lin.check_stored(*args, accelerator="cpu")
    want = ref_lin.check_stored(*args, accelerator="cpu")
    assert got["valid?"] is want["valid?"] is (kind == "valid")
    assert got.get("failed-op") == want.get("failed-op")
    # the stored lane settles a valid run whose sidecar loads; everything
    # else goes to the jsonl and the normal check
    stored = kind == "valid" and damage is None
    assert got["algorithm"].endswith("(stored)") is stored
    assert want["algorithm"].endswith("(stored)") is stored
    if not stored:
        assert not (tmp_path / args[0] / TS / "check.ckpt").exists()


ELLE = {
    "valid": lambda: elle_history(300, n_keys=12),
    "anomalous": lambda: elle_history(300, n_keys=12, crossed_pairs=2),
}


@pytest.mark.parametrize("damage", [None, "missing", "corrupt"])
@pytest.mark.parametrize("kind", sorted(ELLE))
def test_list_append_check_stored_matches_jax(kind, damage, tmp_path):
    args = _save(tmp_path, f"elle-{kind}", ELLE[kind]())
    if damage:
        _damage(tmp_path, args[0], damage)
    from jepsen_tpu.elle import list_append as ref_la
    got = list_append.check_stored(*args, accelerator="cpu")
    assert got == ref_la.check_stored(*args, accelerator="cpu")
    assert got["valid?"] is (kind == "valid")
    # a valid run with its sidecar settles from the columns; an anomalous
    # one needs the txn objects (NeedsObjects) and re-checks the jsonl
    stored = kind == "valid" and damage is None
    assert (got.get("builder") == "columnar-store") is stored


def test_stored_lanes_on_the_device_route_match_jax(tmp_path):
    """``accelerator="gpu"`` on CPU tensors: the register lane through the
    matrix rung, the Elle lane through the φ screen."""
    from jepsen_tpu.elle import list_append as ref_la
    args = _save(tmp_path, "lin", REGISTER["valid"]())
    old = jitlin.MATRIX_MIN_RETURNS
    jitlin.MATRIX_MIN_RETURNS = 10
    try:
        got = lin.check_stored(*args, accelerator="gpu", device="cpu")
    finally:
        jitlin.MATRIX_MIN_RETURNS = old
    assert got["valid?"] is True
    assert got["algorithm"] == "torch-matrix(stored)"
    args = _save(tmp_path, "elle", ELLE["valid"]())
    got = list_append.check_stored(*args, accelerator="gpu", device="cpu")
    assert got == ref_la.check_stored(*args, accelerator="cpu")


def test_error_in_the_stored_lane_propagates(tmp_path, monkeypatch):
    """A failing matrix route inside the stored lane raises out of
    check_stored; it does not turn into a jsonl verdict."""
    args = _save(tmp_path, "lin-boom", REGISTER["valid"]())
    monkeypatch.setattr(jitlin, "MATRIX_MIN_RETURNS", 10)

    def boom(*a, **k):
        raise RuntimeError("matrix route failed")

    monkeypatch.setattr(jitlin, "matrix_check", boom)
    loaded = []
    monkeypatch.setattr(store, "load_history",
                        lambda *a, **k: loaded.append(a) or [])
    with pytest.raises(RuntimeError, match="matrix route failed"):
        lin.check_stored(*args, accelerator="gpu", device="cpu")
    assert not loaded


def test_elle_check_error_propagates(tmp_path, monkeypatch):
    args = _save(tmp_path, "elle-boom", ELLE["valid"]())
    from jepsen_tpu_torch import elle

    def boom(*a, **k):
        raise RuntimeError("cycle search failed")

    monkeypatch.setattr(elle, "check_cycles", boom)
    with pytest.raises(RuntimeError, match="cycle search failed"):
        list_append.check_stored(*args, accelerator="cpu")


@pytest.mark.cuda
def test_stored_lane_on_card_matches_cpu(tmp_path):
    """Both stored re-checks on the card (stores the port wrote) against
    the port's CPU run."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stored lane's kernels run on "
                    "the card")
    for kind in sorted(REGISTER):
        args = _save(tmp_path, f"lin-{kind}", REGISTER[kind](), store)
        got = lin.check_stored(*args, accelerator="gpu")
        want = lin.check_stored(*args, accelerator="cpu")
        assert got["valid?"] is want["valid?"]
        assert got.get("failed-op") == want.get("failed-op")
        assert got["algorithm"].endswith("(stored)") is (kind == "valid")
    for kind in sorted(ELLE):
        args = _save(tmp_path, f"elle-{kind}", ELLE[kind](), store)
        got = list_append.check_stored(*args, accelerator="gpu")
        want = list_append.check_stored(*args, accelerator="cpu")
        assert {k: v for k, v in got.items() if k != "builder"} == \
            {k: v for k, v in want.items() if k != "builder"}
