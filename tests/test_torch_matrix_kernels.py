"""jepsen_tpu_torch.ops.matrix_kernels on the CPU: the plain versions
of the chunk product and the combine against the JAX package's Pallas
kernels (interpret mode) and the numpy oracles. Boolean operators, so
the tolerance is zero: every comparison is exact equality.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
them against these plain versions there."""
from __future__ import annotations

import numpy as np
import pytest
import torch


def _inputs(S, V, T, U, G, seed=0, live=False):
    """Seeded inputs as tests/test_pallas_matrix.py makes them; with
    ``live`` the returning slot is pending, as in a real history, so the
    products keep ones instead of emptying at the first kill."""
    rng = np.random.default_rng(seed)
    pend = (rng.random((T, G, S)) < 0.5).astype(np.float32)
    ids = rng.integers(0, U, (T, G, S)).astype(np.int32)
    mtT = (rng.random((U, V, V)) < 0.3).astype(np.float32)
    slots = rng.integers(0, S, (T, G)).astype(np.int32)
    valid = (rng.random((T, G)) < 0.8).astype(np.float32)
    if live:
        np.put_along_axis(pend, slots[..., None], 1.0, axis=2)
    return pend, ids, mtT, slots, valid


@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided here, never
    at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _port(S, V, args):
    from jepsen_tpu_torch.ops.matrix_kernels import chunk_product
    out = chunk_product(*(torch.from_numpy(a) for a in args), S, V)
    assert out.dtype == torch.bfloat16
    return out.float().numpy()


@pytest.mark.parametrize("S,V,T,U,G", [(3, 8, 5, 16, 4), (2, 8, 7, 16, 3)])
def test_chunk_product_matches_pallas_interpret(S, V, T, U, G):
    from jepsen_tpu.ops.pallas_matrix import _build

    args = _inputs(S, V, T, U, G)
    ref = np.asarray(_build(S, V, T, U, interpret=True, variant="f32")(
        *args)).astype(np.float32)
    assert np.array_equal(_port(S, V, args), ref)


@pytest.mark.parametrize("S,V,T,U,G,seed,live", [
    (3, 8, 5, 16, 4, 0, False), (2, 8, 7, 16, 3, 0, False),
    (1, 8, 6, 4, 2, 1, True), (4, 4, 3, 8, 2, 2, True),
    (3, 2, 9, 8, 3, 3, True), (3, 8, 12, 16, 4, 5, True)])
def test_chunk_product_matches_numpy_oracle(S, V, T, U, G, seed, live):
    from jepsen_tpu.ops.pallas_matrix import _oracle_product
    from jepsen_tpu_torch.ops import matrix_kernels as mk

    args = _inputs(S, V, T, U, G, seed, live)
    ref = _oracle_product(S, V, *args)
    if live:
        assert ref.sum() > 0
    assert np.array_equal(_port(S, V, args), ref)
    # the port's copy of the oracle is the reference's
    assert np.array_equal(mk._oracle_product(S, V, *args), ref)


def test_static_tables_copy_matches_reference():
    from jepsen_tpu.ops.pallas_matrix import _static_tables as ref_tables
    from jepsen_tpu_torch.ops.matrix_kernels import _static_tables

    for S, V in [(1, 8), (3, 4), (4, 8)]:
        for got, ref in zip(_static_tables(S, V), ref_tables(S, V)):
            assert np.array_equal(got, ref)


@pytest.mark.parametrize("B,C,MV,eye,density", [
    pytest.param(2, 5, 64, True, 0.2, id="2-5-64-True"),
    pytest.param(2, 5, 64, False, 0.2, id="2-5-64-False"),
    pytest.param(1, 3, 16, False, 0.2, id="1-3-16-False"),
    pytest.param(1, 1, 32, False, 0.2, id="c1"),
    pytest.param(1, 9, 32, False, 0.5, id="odd-c9-dense"),
    pytest.param(3, 4, 16, False, 0.2, id="b3-random-tot0")])
def test_combine_matches_pallas_interpret_and_oracle(B, C, MV, eye, density):
    import jax.numpy as jnp
    from jepsen_tpu.ops.pallas_matrix import _build_combine, _combine_oracle
    from jepsen_tpu_torch.ops import matrix_kernels as mk

    rng = np.random.default_rng(1)
    P = (rng.random((B, C, MV, MV)) < density).astype(np.float32)
    tot0 = (np.broadcast_to(np.eye(MV, dtype=np.float32), (B, MV, MV)).copy()
            if eye else (rng.random((B, MV, MV)) < 0.1).astype(np.float32))
    ref = _combine_oracle(P, tot0)
    pallas = np.asarray(_build_combine(B, C, MV, interpret=True)(
        jnp.asarray(P, jnp.bfloat16), jnp.asarray(tot0, jnp.bfloat16)),
        dtype=np.float32)
    got = mk.combine_product(torch.from_numpy(P).to(torch.bfloat16),
                             torch.from_numpy(tot0).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and got.shape == (B, MV, MV)
    assert np.array_equal(pallas, ref)
    assert np.array_equal(got.float().numpy(), ref)
    assert np.array_equal(mk._combine_oracle(P, tot0), ref)


def test_combine_tree_matches_reference_tree():
    """The port's make_combine tree and chain_time equal the JAX
    package's tree and the sequential chain."""
    import jax.numpy as jnp
    from jepsen_tpu.ops.jitlin import _kernel_math as ref_math
    from jepsen_tpu_torch.ops.jitlin import _kernel_math
    from jepsen_tpu_torch.ops.matrix_kernels import _combine_oracle

    B, C, S, V = 2, 7, 2, 8
    MV = (1 << S) * V
    rng = np.random.default_rng(4)
    P = (rng.random((B, C, MV, MV)) < 0.15).astype(np.float32)
    tot0 = np.broadcast_to(np.eye(MV, dtype=np.float32), (B, MV, MV)).copy()

    def step_ids(st, f, a, b):   # unused by the combine; shape only
        return st, jnp.ones_like(st, dtype=bool)

    alive_r, _, total_r = ref_math(S, V, step_ids, B * C).make_combine(
        B, C, init_state=0)(jnp.asarray(P.reshape(B * C, MV, MV),
                                        jnp.bfloat16),
                            jnp.zeros((B * C,), bool),
                            jnp.asarray(tot0, jnp.bfloat16))
    math = _kernel_math(S, V, None, B * C, torch.device("cpu"))
    alive, _, total = math.make_combine(B, C, init_state=0)(
        torch.from_numpy(P.reshape(B * C, MV, MV)),
        torch.zeros(B * C, dtype=torch.bool), torch.from_numpy(tot0))
    assert np.array_equal(total.float().numpy(),
                          np.asarray(total_r, dtype=np.float32))
    assert np.array_equal(total.float().numpy(), _combine_oracle(P, tot0))
    assert np.array_equal(alive.numpy(), np.asarray(alive_r))
    chain = math.chain_time(torch.from_numpy(P[0]))
    ref_chain = ref_math(S, V, step_ids, C).chain_time(
        jnp.asarray(P[0], jnp.bfloat16))
    assert np.array_equal(chain.numpy(), np.asarray(ref_chain, np.float32))


def test_wrappers_count_only_kernel_launches():
    """On CPU tensors the wrappers run the plain versions, which are not
    launches."""
    from jepsen_tpu_torch.ops import matrix_kernels as mk

    before = (mk.chunk_product.launches, mk.combine_product.launches)
    args = _inputs(2, 8, 3, 4, 2)
    _port(2, 8, args)
    mk.combine_product(torch.zeros(1, 2, 32, 32), torch.zeros(1, 32, 32))
    assert (mk.chunk_product.launches, mk.combine_product.launches) == before


def test_wrappers_run_plain_on_cpu_and_reject_other_devices():
    """CPU tensors take the plain version; a tensor on any device other
    than the CPU or CUDA raises instead of falling back."""
    from jepsen_tpu_torch.ops import matrix_kernels as mk

    assert mk.KERNEL_MAX_MV == 512
    args = [torch.from_numpy(a) for a in _inputs(1, 8, 2, 4, 1)]
    out = mk.chunk_product(*args, 1, 8)
    assert out.shape == (1, 16, 16)
    with pytest.raises(ValueError):
        mk.chunk_product(*(a.to("meta") for a in args), 1, 8)


# (B, C, MV, density of P, P holds the identity, tot0 is the identity,
# seed): the combine cases of chip_smoke.py — C = 0, 1, 2, odd C, B > 1,
# MV 16 to 512, saturating and all-zero P
CARD_COMBINE_CASES = [
    (1, 256, 256, 0.02, True, True, 5), (4, 8, 512, 0.02, True, False, 6),
    (2, 0, 64, 0.02, True, False, 7), (1, 1, 256, 0.02, True, False, 8),
    (1, 2, 256, 0.006, False, True, 9), (1, 37, 256, 0.006, False, False, 10),
    (1, 255, 256, 0.006, False, False, 11),
    (3, 16, 128, 0.012, False, False, 12), (2, 7, 16, 0.1, False, False, 13),
    (1, 9, 64, 0.025, False, False, 14), (2, 33, 128, 0.012, False, True, 15),
    (1, 37, 512, 0.003, False, True, 16), (1, 37, 256, 0.5, False, False, 17),
    (2, 8, 256, 0.0, False, False, 18)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,MV,density,p_eye,eye_start,seed",
                         CARD_COMBINE_CASES)
def test_kernels_match_plain_on_card(cuda_device, B, C, MV, density, p_eye,
                                     eye_start, seed):
    """On the card: both kernels bit-equal to their plain versions."""
    from jepsen_tpu_torch.ops import matrix_kernels as mk

    S, V, T, U, G = 3, 8, 16, 16, 8
    args = [torch.from_numpy(a).to(cuda_device)
            for a in _inputs(S, V, T, U, G, live=True)]
    assert torch.equal(mk.chunk_product(*args, S, V),
                       mk.chunk_product_torch(*args, S, V))
    rng = np.random.default_rng(seed)
    P = rng.random((B, C, MV, MV)) < density
    if p_eye:
        P = P | np.eye(MV, dtype=bool)
    tot0 = (np.broadcast_to(np.eye(MV, dtype=bool), (B, MV, MV))
            if eye_start else rng.random((B, MV, MV)) < 0.05)
    P, tot0 = (torch.from_numpy(np.array(x)).to(
        cuda_device, torch.bfloat16) for x in (P, tot0))
    assert torch.equal(mk.combine_product(P, tot0),
                       mk.combine_product_torch(P, tot0))
