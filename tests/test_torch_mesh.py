"""The port's mesh paths on ``Mesh(["cpu"] * 4)`` against the JAX
package's on ``jepsen_tpu.parallel.get_mesh(4)`` (four of conftest's
eight virtual CPU devices), at zero tolerance: verdicts, integers and the
0/1 carry operators bit for bit.

- ``jitlin.matrix_check``, ``matrix_check_resume`` (the carry, chained
  through sharded and single-device segments) and
  ``matrix_check_segmented`` with a mesh, also with a chunk count that
  is not a device multiple (the plan pads it);
- ``parallel.batch_check`` with a mesh: invalid keys, B = 6 keys on 4
  devices (padded keys), the matrix screen and the frontier scan;
- ``ops.scc.trim_to_cycles_sharded`` with E not a multiple of 4, capped
  and not; its one-card route (``scc_trim``'s peel) against the JAX
  package's sharded rounds at every cap up to the uncapped count; its
  rounds on a mesh of distinct devices, with and without a reduce; and
  the plain degree pass and update over rounds against
  ``jax.ops.segment_sum``;
- the checker's sharded rung (``torch-sharded-matrix`` against
  ``jitlin-tpu-matrix-sharded``) and ``independent``'s
  ``jitlin-gpu-sharded`` against ``jitlin-tpu-sharded``, with
  ``checker_sharded: True`` and ``mesh_devices: 4`` in both packages (the
  port's ``auto_mesh`` given four CPU devices).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import (
    corrupt_keys, corrupt_reads, independent_register_history,
    register_history)
from test_torch_trim_degrees import GRAPHS, caps_of, trim_graph

pytestmark = pytest.mark.mesh

CPU4 = ["cpu"] * 4


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs on every core at once: one torch thread a test keeps
    these small products from crowding the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _meshes():
    import jax

    from jepsen_tpu.parallel import get_mesh
    from jepsen_tpu_torch.parallel import Mesh
    assert len(jax.devices()) >= 4, "conftest forces 8 virtual devices"
    return get_mesh(4), Mesh(CPU4)


@pytest.fixture
def small_matrix_regime(monkeypatch):
    """Admits these short histories to both packages' matrix screen."""
    import jepsen_tpu.ops.jitlin as ref_jitlin
    import jepsen_tpu.ops.pallas_matrix as pm
    from jepsen_tpu_torch.ops import jitlin
    monkeypatch.setattr(pm, "FORCE_INTERPRET", True)
    for mod in (ref_jitlin, jitlin):
        monkeypatch.setattr(mod, "MATRIX_MIN_RETURNS", 10)
    return ref_jitlin, jitlin


def _pair(history):
    from jepsen_tpu.checker.linear_encode import encode_register_ops as ref
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    return ref(history), encode_register_ops(history)


def _hist(n_ops=200, seed=3, bad=False):
    h = register_history(n_ops, n_procs=3, seed=seed, n_values=4)
    return corrupt_reads(h, n=1, seed=seed) if bad else h


@pytest.mark.parametrize("case", ["valid", "invalid", "c_not_multiple"])
def test_matrix_check_on_a_mesh_matches_jax(case, small_matrix_regime,
                                            monkeypatch):
    """One history's chunk axis sharded: the verdict equals the JAX mesh
    twin's and the port's single-device one. ``c_not_multiple``: an
    element budget of 6 chunks (C = 6 on one device, padded to 8 on 4)."""
    ref_jitlin, jitlin = small_matrix_regime
    ref_mesh, mesh = _meshes()
    ref_st, st = _pair(_hist(bad=case == "invalid"))
    if case == "c_not_multiple":
        mv = (1 << st.n_slots) * jitlin._bucket(len(st.intern), floor=8)
        for mod in small_matrix_regime:
            monkeypatch.setattr(mod, "MATRIX_MAX_ELEMS", 6 * mv * mv)
        assert jitlin._matrix_plan(1, st.n_slots, 200, 8)[0] == 6
        assert jitlin._matrix_plan(1, st.n_slots, 200, 8, mesh)[0] == 8
    ref = ref_jitlin.matrix_check(ref_st, mesh=ref_mesh)
    got = jitlin.matrix_check(st, mesh=mesh)
    info = jitlin.last_dispatch_info()
    assert got == tuple(ref) == jitlin.matrix_check(st, device="cpu")
    assert got[0] is (case != "invalid")
    # the identity chunks C = 8 adds shorten T (256 returns: 6 x 43 ->
    # 8 x 32 chunk steps), so no step is padding
    assert info["mesh"] == 4 and info["mesh_padding_frac"] == 0.0


def test_resume_carry_on_a_mesh_matches_jax(small_matrix_regime):
    """Three segments chained sharded, single-device, sharded: every
    segment's alive flag and carry equal the JAX mesh twin's chain, and
    the chain's final carry equals one unsharded dispatch of the whole
    stream."""
    ref_jitlin, jitlin = small_matrix_regime
    ref_mesh, mesh = _meshes()
    ref_st, st = _pair(_hist(600, seed=9))
    cuts = jitlin.quiescent_cuts(st.kind, 400)
    assert len(cuts) >= 3, cuts
    kw = dict(num_states=len(st.intern), n_slots=st.n_slots)
    tot = ref_tot = None
    lo = 0
    for i, hi in enumerate(cuts[:3]):
        m, rm = (mesh, ref_mesh) if i != 1 else (None, None)
        a, ix, tot = jitlin.matrix_check_resume(
            jitlin._slice_stream(st, lo, hi), tot, mesh=m,
            device="cpu", **kw)
        ra, rix, ref_tot = ref_jitlin.matrix_check_resume(
            ref_jitlin._slice_stream(ref_st, lo, hi), ref_tot, mesh=rm, **kw)
        assert a.tolist() == np.asarray(ra).tolist()
        assert bool(ix.any()) is bool(np.asarray(rix).any()) is False
        np.testing.assert_array_equal(tot.float().numpy(),
                                      np.asarray(ref_tot, np.float32))
        lo = hi
    one = jitlin.matrix_check_resume(jitlin._slice_stream(st, 0, lo),
                                     device="cpu", **kw)[2]
    assert torch.equal(one, tot)


@pytest.mark.parametrize("bad", [False, True])
def test_segmented_chain_on_a_mesh_matches_jax(bad, small_matrix_regime):
    ref_jitlin, jitlin = small_matrix_regime
    ref_mesh, mesh = _meshes()
    ref_st, st = _pair(_hist(500, seed=4, bad=bad))
    sunk = []
    got = jitlin.matrix_check_segmented(st, mesh=mesh, max_segment=300,
                                        carry_sink=sunk.append)
    ref = ref_jitlin.matrix_check_segmented(ref_st, mesh=ref_mesh,
                                            max_segment=300)
    assert got == tuple(ref)
    assert got[0] is not bad
    if not bad:
        assert len(sunk) >= 2
        assert all(c["tot0"].device == torch.device("cpu") for c in sunk)


def _keys(n, bad=(), n_ops=60):
    hs = [register_history(n_ops, n_procs=3, seed=100 + k, n_values=4)
          for k in range(n)]
    return [corrupt_reads(h, n=2, seed=k) if k in bad else h
            for k, h in enumerate(hs)]


@pytest.mark.parametrize("lane", ["matrix", "scan"])
def test_batch_check_on_a_mesh_matches_jax(lane, small_matrix_regime,
                                           monkeypatch):
    """B = 6 keys on 4 devices (two padding keys), two invalid: the
    matrix screen then the frontier scan of the undecided keys, or the
    scan alone (below the screen's returns); the JAX mesh twin's tuples,
    and the port's single-device ones."""
    from jepsen_tpu.parallel import batch_check as ref_batch_check
    from jepsen_tpu_torch.parallel import batch_check, last_route

    if lane == "scan":
        for mod in small_matrix_regime:
            monkeypatch.setattr(mod, "MATRIX_MIN_RETURNS", 10 ** 6)
    ref_mesh, mesh = _meshes()
    hs = _keys(6, bad=(1, 4))
    ref_st, st = zip(*[_pair(h) for h in hs])
    ref = ref_batch_check(list(ref_st), mesh=ref_mesh, accelerator="device")
    got = batch_check(list(st), mesh=mesh, accelerator="gpu")
    assert last_route() == "mesh"
    if lane == "matrix":
        # 2 of the 8 keys are padding, each C = 256 chunks of T = 1
        assert small_matrix_regime[1].last_dispatch_info()[
            "mesh_padding_frac"] == 0.25
    assert got == ref
    assert got == batch_check(list(st), device="cpu", mesh=False)
    assert [r[0] for r in got] == [k not in (1, 4) for k in range(6)]


@pytest.mark.parametrize("max_iters", [512, 3])
def test_sharded_trim_matches_jax(max_iters):
    """E = 1,001 edges (not a multiple of 4) with planted cycles, on 400
    nodes: the mask bit for bit, uncapped and capped at 3 rounds."""
    from jepsen_tpu.ops.scc import trim_to_cycles_sharded as ref_trim
    from jepsen_tpu_torch.ops.scc import trim_to_cycles_sharded

    ref_mesh, mesh = _meshes()
    rng = np.random.default_rng(11)
    n = 400
    src = np.concatenate([rng.integers(0, n, 995), [5, 6, 7, 50, 60, 70]])
    dst = np.concatenate([rng.integers(0, n, 995), [6, 7, 5, 60, 70, 50]])
    ref = np.asarray(ref_trim(n, src, dst, ref_mesh, max_iters=max_iters))
    got = trim_to_cycles_sharded(n, src, dst, mesh, max_iters=max_iters)
    np.testing.assert_array_equal(got, ref)
    assert got[[5, 6, 7, 50, 60, 70]].all() and not got.all()
    assert trim_to_cycles_sharded(n, src[:0], dst[:0], mesh).sum() == 0


def test_degree_pass_and_update_match_segment_sum():
    """The plain degree pass (``index_add_``) against the reference's
    ``jax.ops.segment_sum`` pair, with weight-0 padding edges, over three
    rounds: two shards accumulate into one row pair, the update applies
    ``active & (in > 0) & (out > 0)``, zeroes the pair and sets the
    round's flag slot (clearing the other)."""
    import jax
    import jax.numpy as jnp

    from jepsen_tpu_torch.ops import scc_kernels
    rng = np.random.default_rng(2)
    n, E = 97, 513
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n, E).astype(np.int32)
    w = (rng.random(E) < 0.9).astype(np.int32)
    active = rng.random(n) < 0.8
    act = torch.from_numpy(active.copy())
    bits = scc_kernels.pack_mask(act)
    deg = torch.zeros((2, n), dtype=torch.int32)
    flags = torch.zeros(2, dtype=torch.int32)
    for r in range(3):
        ew = w * (active[src] & active[dst]).astype(np.int32)
        ref_in = np.asarray(jax.ops.segment_sum(jnp.asarray(ew), dst,
                                                num_segments=n))
        ref_out = np.asarray(jax.ops.segment_sum(jnp.asarray(ew), src,
                                                 num_segments=n))
        for lo, hi in ((0, 200), (200, E)):
            scc_kernels.trim_partial_degrees(
                *(torch.from_numpy(x[lo:hi].copy()) for x in (src, dst, w)),
                act, bits, deg)
        np.testing.assert_array_equal(deg.numpy(),
                                      np.stack([ref_in, ref_out]))
        slot = r % 2
        flag = scc_kernels.trim_update(deg, None, act, bits, flags, slot)
        want = active & (ref_in > 0) & (ref_out > 0)
        np.testing.assert_array_equal(act.numpy(), want)
        assert flag.tolist() == [int((want != active).any())]
        assert flags[1 - slot] == 0 and not deg.any()
        np.testing.assert_array_equal(bits.numpy(),
                                      scc_kernels.pack_mask(act).numpy())
        flags[slot] = 0
        active = want


@pytest.mark.parametrize("graph", GRAPHS[:4])
def test_one_call_peel_matches_jax_sharded_at_every_cap(graph):
    """The identity behind the one-card route: ``scc_trim``'s plain
    version on the whole edge list against the JAX package's
    ``trim_to_cycles_sharded`` on four virtual devices (weight-0 padding
    for E % 4 != 0), at every cap from 0 to the uncapped round count and
    at 512, on graphs with long chains, a self-loop and duplicate edges:
    the same mask at every cap."""
    from jepsen_tpu.ops.scc import trim_to_cycles_sharded as ref_trim
    from jepsen_tpu_torch.ops import scc_kernels

    ref_mesh, _ = _meshes()
    n, src, dst = trim_graph(*graph)
    cols = [torch.from_numpy(x) for x in (src, dst)]
    valid = torch.ones(len(src), dtype=torch.bool)
    for cap in caps_of((n, src, dst)):
        ref = np.asarray(ref_trim(n, src, dst, ref_mesh, max_iters=cap))
        got, _ = scc_kernels.scc_trim_torch(*cols, valid, n, cap)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(cap))


@pytest.mark.parametrize("width", [1, 4])
def test_one_card_route_matches_jax(width):
    """``trim_to_cycles_sharded`` and ``run_sharded_trim`` on
    ``Mesh(["cpu"] * width)`` (the one-card route: one ``scc_trim`` call)
    against the JAX package's sharded trim on four virtual devices, at
    caps 0, 1, 3, 7 and 512."""
    from jepsen_tpu.ops.scc import trim_to_cycles_sharded as ref_trim
    from jepsen_tpu_torch.ops.scc import (run_sharded_trim,
                                          trim_to_cycles_sharded)
    from jepsen_tpu_torch.parallel import Mesh, shard_leading

    ref_mesh, _ = _meshes()
    mesh = Mesh(["cpu"] * width)
    n, src, dst = trim_graph(*GRAPHS[3])
    E = len(src)
    z = np.zeros((-E) % width, np.int32)
    shards = shard_leading(mesh, np.concatenate([src, z]),
                           np.concatenate([dst, z]),
                           np.concatenate([np.ones(E, np.int32), z]))
    for cap in (0, 1, 3, 7, 512):
        ref = np.asarray(ref_trim(n, src, dst, ref_mesh, max_iters=cap))
        np.testing.assert_array_equal(
            trim_to_cycles_sharded(n, src, dst, mesh, max_iters=cap), ref)
        np.testing.assert_array_equal(
            run_sharded_trim(mesh, n, *shards, max_iters=cap).numpy(), ref)


@pytest.mark.parametrize("reduce", [False, True])
@pytest.mark.parametrize("graph", GRAPHS[:2])
def test_distinct_device_rounds_match_jax(graph, reduce):
    """The rounds on a mesh of distinct devices, ``Mesh(["cpu", "cpu:0"] *
    2)`` (``cpu:0`` is another device than ``cpu`` to the mesh, so no
    one-card route): the ``cpu:0`` shards' rows staged on the first device
    and added by the update, or, with a ``reduce``, added before it;
    ``trim_to_cycles_sharded`` and ``run_sharded_trim`` against the JAX
    package's sharded trim on four virtual devices, at caps 0, 1, 2, 5,
    13 and 512 (E a multiple of 4 and not)."""
    from jepsen_tpu.ops.scc import trim_to_cycles_sharded as ref_trim
    from jepsen_tpu_torch.ops.scc import (run_sharded_trim,
                                          trim_to_cycles_sharded)
    from jepsen_tpu_torch.parallel import Mesh, shard_leading

    ref_mesh, _ = _meshes()
    mesh = Mesh(["cpu", "cpu:0"] * 2)
    n, src, dst = trim_graph(*graph)
    E = len(src)
    z = np.zeros((-E) % 4, np.int32)
    shards = shard_leading(mesh, np.concatenate([src, z]),
                           np.concatenate([dst, z]),
                           np.concatenate([np.ones(E, np.int32), z]))
    seen = []
    for cap in (0, 1, 2, 5, 13, 512):
        ref = np.asarray(ref_trim(n, src, dst, ref_mesh, max_iters=cap))
        got = run_sharded_trim(mesh, n, *shards, max_iters=cap,
                               reduce=seen.append if reduce else None)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str(cap))
        if not reduce:
            np.testing.assert_array_equal(
                trim_to_cycles_sharded(n, src, dst, mesh, max_iters=cap),
                ref, err_msg=str(cap))
    assert bool(seen) == reduce


@pytest.fixture
def four_cpu_devices(monkeypatch):
    """The port's auto_mesh over four CPU devices, as the JAX package's
    over conftest's virtual ones."""
    from jepsen_tpu_torch import parallel
    monkeypatch.setattr(parallel, "devices",
                        lambda: [torch.device("cpu")] * 4)


@pytest.mark.parametrize("bad", [False, True])
def test_checker_sharded_rung_matches_jax(bad, small_matrix_regime,
                                          four_cpu_devices):
    """``checker_sharded: True``: the verdict and failed op of
    ``torch-sharded-matrix`` equal ``jitlin-tpu-matrix-sharded``'s (an
    invalid verdict localizes on one device, explain on), and
    ``checker_sharded: False`` turns the rung off."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = _hist(300, seed=6, bad=bad)
    opts = {"checker_sharded": True, "mesh_devices": 4}
    ref = ref_lin(accelerator="tpu").check({}, h, opts)
    got = linearizable(accelerator="gpu", device="cpu").check({}, h, opts)
    assert ref["algorithm"] == "jitlin-tpu-matrix-sharded"
    assert got["algorithm"] == "torch-sharded-matrix"
    assert got["valid?"] is ref["valid?"] is (not bad)
    assert got.get("failed-op") == ref.get("failed-op")
    off = linearizable(accelerator="gpu", device="cpu").check(
        {"checker_sharded": False}, h, {})
    assert off["algorithm"] == "torch-matrix"


def test_independent_sharded_backend_matches_jax(small_matrix_regime,
                                                 four_cpu_devices):
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable

    h = corrupt_keys(independent_register_history(6, 60, n_procs=3,
                                                  n_values=4, seed=700),
                     [2])
    opts = {"checker_sharded": True, "mesh_devices": 4, "explain": False}
    ref = ref_ind.checker(ref_lin(accelerator="tpu")).check({}, h, opts)
    got = independent.checker(linearizable(accelerator="gpu",
                                           device="cpu")).check({}, h, opts)
    assert got["failures"] == ref["failures"] == ["2"]
    assert got["valid?"] is ref["valid?"] is False
    for k, r in ref["results"].items():
        want = r["algorithm"].replace("jitlin-tpu-sharded",
                                      "jitlin-gpu-sharded")
        assert got["results"][k]["algorithm"] == want
        assert got["results"][k]["valid?"] == r["valid?"]
    assert got["results"]["0"]["algorithm"] == "jitlin-gpu-sharded"


@pytest.mark.parametrize("bad", [False, True])
def test_sharded_rung_chain_keeps_its_checkpoint(bad, small_matrix_regime,
                                                 four_cpu_devices,
                                                 monkeypatch, tmp_path):
    """A stream past the (lowered) segment bound on the sharded rung:
    the mesh chain writes ``check.ckpt`` after its segments, the settled
    check removes it, and the verdict, failed op and rung equal the JAX
    package's sharded chain's."""
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu_torch.checker import checkpoint
    from jepsen_tpu_torch.checker.linearizable import linearizable

    for mod in small_matrix_regime:
        monkeypatch.setattr(mod, "MATRIX_SEGMENT_EVENTS", 256)
    saves = []
    real = checkpoint.CheckpointStore.save
    monkeypatch.setattr(checkpoint.CheckpointStore, "save",
                        lambda self, *a, **k: (saves.append(1),
                                               real(self, *a, **k))[1])
    h = _hist(400, seed=8, bad=bad)

    def test_map(d):
        return {"name": "mesh", "start_time": "t0", "store_dir": str(d),
                "check_ckpt_interval": 1e-9, "checker_sharded": True,
                "mesh_devices": 4}

    got = linearizable(accelerator="gpu", device="cpu").check(
        test_map(tmp_path / "port"), h, {})
    ref = ref_lin(accelerator="tpu").check(test_map(tmp_path / "ref"), h,
                                           {})
    assert ref["algorithm"] == "jitlin-tpu-matrix-sharded"
    assert got["algorithm"] == "torch-sharded-matrix"
    assert got["valid?"] is ref["valid?"] is (not bad)
    assert got.get("failed-op") == ref.get("failed-op")
    assert saves
    assert not list((tmp_path / "port").rglob("check.ckpt"))


def test_an_error_of_a_shard_propagates(small_matrix_regime,
                                        four_cpu_devices, monkeypatch):
    """No shrink ladder: a shard whose chunk product raises fails the
    sharded check, and nothing falls back to one device."""
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.ops import matrix_kernels

    calls = []
    real = matrix_kernels.chunk_product_torch

    def third_fails(*a, **k):
        calls.append(1)
        if len(calls) == 3:
            raise RuntimeError("shard 2 lost")
        return real(*a, **k)

    monkeypatch.setattr(matrix_kernels, "chunk_product_torch", third_fails)
    with pytest.raises(RuntimeError, match="shard 2 lost"):
        linearizable(accelerator="gpu", device="cpu").check(
            {}, _hist(), {"checker_sharded": True})
    assert len(calls) == 3
