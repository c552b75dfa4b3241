"""jepsen_tpu_torch.models against jepsen_tpu.models: the torch
``step_ids`` is the jnp one, exhaustively over a small domain (tolerance
zero: int32 and bool results)."""
from __future__ import annotations

import numpy as np
import pytest
import torch


def _domain():
    st, f, a, b = np.meshgrid(np.arange(8), np.arange(3), np.arange(8),
                              np.arange(8), indexing="ij")
    return [x.astype(np.int32) for x in (st, f, a, b)]


@pytest.mark.parametrize("spec_name", ["cas_register_spec", "register_spec"])
def test_step_ids_matches_jnp_exhaustively(spec_name):
    import jax.numpy as jnp

    import jepsen_tpu.models as jm
    import jepsen_tpu_torch.models as tm

    ref_spec = getattr(jm, spec_name)(init_state=2)
    port_spec = getattr(tm, spec_name)(init_state=2)
    assert (port_spec.name, port_spec.init_state, port_spec.num_f) == (
        ref_spec.name, ref_spec.init_state, ref_spec.num_f)
    dom = _domain()
    ref_st, ref_ok = ref_spec.step_ids(*(jnp.asarray(x) for x in dom))
    st, ok = port_spec.step_ids(*(torch.from_numpy(x) for x in dom))
    assert st.dtype == torch.int32 and ok.dtype == torch.bool
    assert np.array_equal(st.numpy(), np.asarray(ref_st))
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))


def test_step_ids_broadcasts_scalars_against_tensors():
    """The [U, V] broadcast the uop tables use: a state row against
    per-op columns, scalars mixed in."""
    from jepsen_tpu_torch.models import CAS_F_CAS, cas_register_spec

    step = cas_register_spec().step_ids
    states = torch.arange(5, dtype=torch.int32)[None, :]
    st, ok = step(states, CAS_F_CAS, torch.tensor([[1], [3]]), 4)
    assert st.shape == (2, 5)
    assert ok.tolist() == [[False, True, False, False, False],
                           [False, False, False, True, False]]
    assert st.tolist() == [[0, 4, 2, 3, 4], [0, 1, 2, 4, 4]]


def test_cas_register_object_model_matches_reference():
    from jepsen_tpu.models import CASRegister as RefReg
    from jepsen_tpu_torch.models import CASRegister, is_inconsistent

    ops = [{"f": "write", "value": 3}, {"f": "read", "value": 3},
           {"f": "cas", "value": [3, 4]}, {"f": "cas", "value": [3, 5]},
           {"f": "read", "value": None}, {"f": "read", "value": 9}]
    m, r = CASRegister(), RefReg()
    for op in ops:
        m2, r2 = m.step(op), r.step(op)
        assert is_inconsistent(m2) == (type(r2).__name__ == "Inconsistent")
        if not is_inconsistent(m2):
            assert m2.value == r2.value
            m, r = m2, r2
