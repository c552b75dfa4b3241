"""One process of tests/test_torch_distributed.py's world: joins a gloo
world of ``torch.distributed`` on the CPU and runs the port's multi-process
checks on the job the test wrote. It imports neither ``jax`` nor
``jepsen_tpu``. Run by the test:

    python tests/torch_distributed_worker.py JOB RANK

JOB is a pickle the test wrote: ``init`` (a ``file://`` init method),
``world``, ``streams`` (the port's encoded keys), ``invalid`` (the
invalid keys' indices), ``history`` (the lifted history of those keys),
``n_nodes`` and ``edges`` (one (src, dst) pair of arrays a rank). The
worker writes its results to ``JOB.<RANK>.out`` (a pickle) and exits 0.
"""
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(job_path: str, rank: int) -> int:
    import torch

    from jepsen_tpu_torch import independent
    from jepsen_tpu_torch.checker.linearizable import linearizable
    from jepsen_tpu_torch.parallel import distributed

    # the test suite runs beside this world on every core: one thread a
    # rank keeps the two ranks from crowding it
    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    backend = distributed.initialize(job["init"], job["world"], rank)
    try:
        src, dst = job["edges"][rank]
        out = {
            "backend": backend,
            "batch": distributed.batch_check_distributed(job["streams"],
                                                         device="cpu"),
            "trim": distributed.trim_to_cycles_distributed(
                job["n_nodes"], src, dst, device="cpu"),
            "localized": distributed.localize_keys_distributed(
                job["streams"], job["invalid"], device="cpu"),
            "independent": independent.checker(linearizable(
                accelerator="gpu", device="cpu")).check(
                    {}, job["history"], {}),
            "leaked": sorted(m for m in sys.modules
                             if m.split(".")[0] in ("jax", "jaxlib",
                                                    "jepsen_tpu")),
        }
    finally:
        distributed.dist.destroy_process_group()
    with open(f"{job_path}.{rank}.out", "wb") as f:
        pickle.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1], int(sys.argv[2])))
