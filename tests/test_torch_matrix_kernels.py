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


def _level_order_replay(S, V, pend, ids, mtT, slots, valid):
    """Numpy replay of csrc/chunk_product.cu over dense 0/1 rows: per
    valid return, P's rows are rewritten in place level by level (level
    = number of pending bits of the mask a),
        X(a, w) = P(a, w) | OR_{s in pm & a} OR_{v in mt_s[w]} X(a^2^s, v)
    then the kill moves row block a | 2^slot into block a and zeroes it,
    for each a with bit slot clear."""
    M = 1 << S
    T, G = slots.shape
    out = np.zeros((G, M * V, M * V), np.float32)
    for g in range(G):
        P = np.eye(M * V, dtype=bool)
        for t in range(T):
            if not valid[t, g]:
                continue
            pm = sum(1 << s for s in range(S) if pend[t, g, s])
            for p in range(1, bin(pm).count("1") + 1):
                for a in range(M):
                    if bin(a & pm).count("1") != p:
                        continue
                    for s in range(S):
                        if (a & pm) >> s & 1:
                            b = a ^ (1 << s)
                            mt = mtT[ids[t, g, s]] > 0     # [w, v]
                            P[a * V:(a + 1) * V] |= (
                                mt.astype(np.int64)
                                @ P[b * V:(b + 1) * V].astype(np.int64)) > 0
            s = slots[t, g]
            for a in range(M):
                if not a >> s & 1:
                    hi = (a | (1 << s)) * V
                    P[a * V:(a + 1) * V] = P[hi:hi + V]
                    P[hi:hi + V] = False
        out[g] = P
    return out


def _corner_inputs(kind, S, V, T, U, G, seed):
    """`_inputs` with live returns, reshaped by ``kind`` to exercise one
    corner of the chunk-product kernel."""
    pend, ids, mtT, slots, valid = _inputs(S, V, T, U, G, seed, live=True)
    if kind == "all_pending_write":
        # a write moves every old state to its value: one all-ones row
        pend[:] = 1.0
        mtT[:] = 0.0
        for u in range(U):
            mtT[u, u % V, :] = 1.0
    elif kind == "one_state":
        mtT[:] = 1.0           # V = 1: every op keeps the one state
    elif kind == "padding_chunk":
        valid[:, 1 % G] = 0.0
    elif kind == "slot_not_pending":
        # step 1 returns a slot that is not pending, in every chunk
        np.put_along_axis(pend[1], slots[1, :, None], 0.0, axis=1)
        valid[1] = 1.0
    return pend, ids, mtT, slots, valid


# case: (kind, S, V, T, U, G, seed)
REPLAY_CASES = {
    "all_pending_write": ("all_pending_write", 3, 4, 5, 4, 2, 11),
    "s1": ("live", 1, 8, 6, 4, 2, 12),
    "v1_s4": ("one_state", 4, 1, 6, 2, 2, 13),
    "v32_s2": ("live", 2, 32, 3, 4, 2, 14),
    "v16_s3": ("live", 3, 16, 4, 8, 2, 16),
    "padding_chunk": ("padding_chunk", 3, 8, 5, 8, 3, 15),
    "slot_not_pending": ("slot_not_pending", 3, 4, 8, 4, 3, 17),
    "live_s5_v8": ("live", 5, 8, 4, 16, 2, 17)}


@pytest.mark.parametrize("case", list(REPLAY_CASES))
def test_level_order_replay_matches_oracle_and_pallas(case):
    """The chunk-product kernel's algorithm (level-order closure, kill by
    row pairs) equals the reference's squarings-then-products, exactly."""
    from jepsen_tpu.ops.pallas_matrix import _build, _oracle_product

    kind, S, V, *shape = REPLAY_CASES[case]
    args = _corner_inputs(kind, S, V, *shape)
    got = _level_order_replay(S, V, *args)
    ref = _oracle_product(S, V, *args)
    assert ref.sum() > 0
    assert np.array_equal(got, ref)
    pallas = np.asarray(_build(S, V, args[0].shape[0], args[2].shape[0],
                               interpret=True, variant="f32")(*args))
    assert np.array_equal(got, pallas.astype(np.float32))
    assert np.array_equal(_port(S, V, args), ref)
    if case == "padding_chunk":
        assert np.array_equal(got[1], np.eye(got.shape[1]))
    if case == "slot_not_pending":
        assert (ref.sum(axis=(1, 2)) > 0).all()


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


# chunk-product cases on the card, (kind, S, V, T, U, G, seed): the
# shapes of chip_smoke.py's — dense write rows with every slot pending,
# S = 1, V = 1 at MV = 256, V = 32 at MV = 512, a padding chunk, G = T = 1,
# and V = 16 (the main path's V for 9-16 values) and V = 4, so that every
# V the kernel is instantiated for (1 to 32) runs
CARD_CHUNK_CASES = {
    "live_s3_v8": ("live", 3, 8, 16, 16, 8, 0),
    "all_pending_write": ("all_pending_write", 5, 8, 32, 8, 64, 21),
    "s1": ("live", 1, 8, 64, 4, 32, 22),
    "v1_s8": ("one_state", 8, 1, 16, 8, 16, 23),
    "v32_s4": ("live", 4, 32, 8, 16, 16, 24),
    "padding_chunk": ("padding_chunk", 5, 8, 32, 16, 16, 25),
    "g1_t1": ("live", 5, 8, 1, 8, 1, 26),
    "v16_s5": ("live", 5, 16, 16, 32, 32, 27),
    "v4_s6": ("live", 6, 4, 32, 16, 32, 28),
    "v2_s7": ("live", 7, 2, 16, 8, 16, 29)}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,case", [
    *(pytest.param("combine", c, id="-".join(map(str, c)))
      for c in CARD_COMBINE_CASES),
    *(pytest.param("chunk", c, id=name)
      for name, c in CARD_CHUNK_CASES.items())])
def test_kernels_match_plain_on_card(cuda_device, kernel, case):
    """On the card: both kernels bit-equal to their plain versions."""
    from jepsen_tpu_torch.ops import matrix_kernels as mk

    if kernel == "chunk":
        kind, S, V, *shape = case
        args = [torch.from_numpy(a).to(cuda_device)
                for a in _corner_inputs(kind, S, V, *shape)]
        ref = mk.chunk_product_torch(*args, S, V)
        assert ref.float().sum() > 0
        assert torch.equal(mk.chunk_product(*args, S, V), ref)
        return
    B, C, MV, density, p_eye, eye_start, seed = case
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
