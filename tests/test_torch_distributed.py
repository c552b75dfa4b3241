"""jepsen_tpu_torch.parallel.distributed in a world of 2 gloo processes on
the CPU, against the JAX package's single-process results computed here:
``batch_check_distributed`` equal to ``jepsen_tpu.parallel.batch_check``
key for key (the tuples, at zero tolerance), ``trim_to_cycles_distributed``
on edges split between the processes equal to
``jepsen_tpu.ops.scc.trim_to_cycles_sharded`` on the whole graph (bit for
bit), each invalid key localized at the JAX package's CPU frontier's
failing event and op, and ``independent.checker`` in the world giving the
single process's verdicts with the distributed localization's backend.
The children (``tests/torch_distributed_worker.py``) import neither jax
nor jepsen_tpu, meet through a ``file://`` init method in the test's
temporary directory, and are killed past the test's own 120 s limit."""
from __future__ import annotations

import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np

from jepsen_tpu_torch.histories import (
    corrupt_keys, independent_register_history)

WORLD = 2
TIMEOUT_S = 120
BAD = (1, 4)


def _graph(seed: int = 5):
    """A seeded graph of 300 nodes: random edges plus two planted cycles,
    E = 911 (odd, so neither half divides evenly by anything)."""
    rng = np.random.default_rng(seed)
    n = 300
    src = list(rng.integers(0, n, 900))
    dst = list(rng.integers(0, n, 900))
    for cyc in ((3, 7, 11, 3), (100, 200, 150, 120, 100)):
        src += list(cyc[:-1])
        dst += list(cyc[1:])
    return n, np.asarray(src[:911], np.int32), np.asarray(dst[:911], np.int32)


def _run_world(tmp_path: Path, job: dict) -> list:
    path = tmp_path / "job.pkl"
    job = {**job, "init": f"file://{tmp_path / 'rendezvous'}",
           "world": WORLD}
    path.write_bytes(pickle.dumps(job))
    worker = Path(__file__).resolve().parent / "torch_distributed_worker.py"
    procs = [subprocess.Popen([sys.executable, str(worker), str(path),
                               str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return [pickle.loads((tmp_path / f"job.pkl.{r}.out").read_bytes())
            for r in range(WORLD)]


def test_two_gloo_processes_match_single_process_jax(tmp_path):
    from jepsen_tpu import independent as ref_ind
    from jepsen_tpu.checker.linear_cpu import check_stream as ref_check
    from jepsen_tpu.checker.linear_encode import encode_register_ops as ref_enc
    from jepsen_tpu.checker.linearizable import linearizable as ref_lin
    from jepsen_tpu.ops.scc import trim_to_cycles_sharded as ref_trim
    from jepsen_tpu.parallel import batch_check as ref_batch, get_mesh
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.independent import split_history

    h = corrupt_keys(independent_register_history(5, 60, n_procs=3,
                                                  n_values=4, seed=300), BAD)
    keys, subs = split_history(h)
    ref_streams = [ref_enc(subs[k]) for k in keys]
    streams = [encode_register_ops(subs[k]) for k in keys]
    n, src, dst = _graph()
    half = len(src) // 2 + 1
    edges = [(src[:half], dst[:half]), (src[half:], dst[half:])]

    outs = _run_world(tmp_path, {
        "streams": streams, "invalid": list(BAD), "history": h,
        "n_nodes": n, "edges": edges})

    ref_batch_out = ref_batch(ref_streams, accelerator="device", mesh=False)
    ref_mask = np.asarray(ref_trim(n, src, dst, get_mesh(4)))
    ref_map = ref_ind.checker(ref_lin()).check(
        {}, h, {"explain": False, "checker_sharded": False})
    assert ref_mask.any() and not ref_mask.all()
    for out in outs:
        assert out["backend"] == "gloo" and out["leaked"] == []
        assert out["batch"] == ref_batch_out
        assert [r[0] for r in out["batch"]] == [k not in BAD
                                                for k in range(5)]
        np.testing.assert_array_equal(out["trim"], ref_mask)
        for i in BAD:
            res = ref_check(ref_streams[i])
            assert out["localized"][i] == (res.failed_event,
                                           res.failed_op_index)
        assert sorted(out["localized"]) == list(BAD)
        got = out["independent"]
        assert (got["valid?"], got["failures"], got["count"]) == (
            ref_map["valid?"], ref_map["failures"], ref_map["count"])
        for i in BAD:
            assert got["results"][str(i)]["explain"] == {
                "first-anomaly-op": out["localized"][i][1],
                "backend": "matrix-bisect-distributed"}
