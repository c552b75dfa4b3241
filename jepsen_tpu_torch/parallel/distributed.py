"""Checks across processes over ``torch.distributed`` (the port of
jepsen_tpu/parallel/distributed.py:25-217).

A world of N processes, each started by the caller and joined with
:func:`initialize`. Independent keys split by process: each process
checks its contiguous slice on its own devices, and only the fixed-size
row blocks of verdicts (or of localized positions) gather
(:func:`batch_check_distributed`, :func:`localize_keys_distributed`). The
trim shards edges by process: each contributes its local edge list, and
every round the partial degrees ``all_reduce`` across the world before
the mask's update (:func:`trim_to_cycles_distributed`), so every process
ends with the same mask.

The backend is NCCL when each process has a card of its own, gloo
otherwise: on the CPU, and when processes share one card (NCCL refuses
two ranks on one GPU). gloo reduces and gathers host tensors, so under
it the degree rows and row blocks travel through the host. Devices are
this process's share of one host's cards (:func:`local_devices`).
"""
from __future__ import annotations

import logging

import numpy as np
import torch
import torch.distributed as dist

from jepsen_tpu_torch.device import resolve_device
from jepsen_tpu_torch.parallel import Mesh

logger = logging.getLogger("jepsen_tpu_torch.parallel.distributed")


def initialize(init_method: str, world_size: int, rank: int,
               backend: str | None = None) -> str:
    """Joins the world (``torch.distributed.init_process_group``) at
    ``init_method`` (``tcp://host:port`` or ``file:///path``). The
    backend defaults to NCCL when this host's cards number at least
    ``world_size`` (a card a process), else gloo. Returns it."""
    if backend is None:
        own_card = (torch.cuda.is_available()
                    and torch.cuda.device_count() >= world_size)
        backend = "nccl" if own_card else "gloo"
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return backend


def local_devices() -> list:
    """This process's share of the host's cards: card i goes to the rank
    i mod world; with fewer cards than processes, each process takes card
    rank mod cards, shared. [] without a card."""
    if not torch.cuda.is_available():
        return []
    n = torch.cuda.device_count()
    rank, world = dist.get_rank(), dist.get_world_size()
    if n < world:
        return [torch.device("cuda", rank % n)]
    return [torch.device("cuda", i) for i in range(n) if i % world == rank]


def _device(device=None) -> torch.device:
    """``device``, or this process's first card (raising without one)."""
    if device is not None:
        return resolve_device(device)
    devs = local_devices()
    return devs[0] if devs else resolve_device(None)


def global_mesh(axis: str = "edges", device=None) -> Mesh:
    """This process's part of the world's mesh: a one-device Mesh on
    ``device`` (by default its first card). The other processes hold the
    rest; this module's reductions join them."""
    return Mesh([_device(device)], axis)


# copied from jepsen_tpu/parallel/distributed.py:64-82
def local_mesh(axis: str = "keys", max_devices: int | None = None):
    """A mesh over THIS process's cards only (:func:`local_devices`), or
    None with fewer than two; ``max_devices`` caps it (pass
    ``parallel.mesh_devices_limit()``). The intra-host half: keys split by
    process, then each process's slice may shard over its own cards."""
    devs = local_devices()
    if max_devices is not None:
        devs = devs[:max_devices]
    if len(devs) < 2:
        return None
    return Mesh(devs, axis)


def _host_collectives(t: torch.Tensor) -> bool:
    return t.device.type != "cpu" and dist.get_backend() == "gloo"


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sums ``t`` over the world in place (through the host under gloo)
    and returns it."""
    if _host_collectives(t):
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
        return t
    dist.all_reduce(t)
    return t


def _all_gather_rows(block: np.ndarray, device) -> np.ndarray:
    """Every process's int64 row block of one shape, stacked in rank
    order: [world, *block.shape]. On the host under gloo, else on
    ``device``."""
    t = torch.from_numpy(np.ascontiguousarray(block))
    dev = torch.device(device)
    if dev.type != "cpu" and dist.get_backend() != "gloo":
        t = t.to(dev)
    outs = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, t)
    return torch.stack(outs).cpu().numpy()


def _my_slice(n: int) -> tuple[int, int, int]:
    """(lo, hi, rows a process) of this rank's contiguous slice of n."""
    pid, n_proc = dist.get_rank(), dist.get_world_size()
    return pid * n // n_proc, (pid + 1) * n // n_proc, -(-n // n_proc)


# copied from jepsen_tpu/parallel/distributed.py:85-113
def trim_to_cycles_distributed(n_nodes: int, local_src, local_dst,
                               mesh: Mesh | None = None,
                               max_iters: int = 512,
                               device=None) -> np.ndarray:
    """Multi-process twin of ``ops.scc.trim_to_cycles_sharded``: every
    process passes its LOCAL edge list (the graph's edges are their
    union; any sizes) and the same ``n_nodes``; each round the local
    shards' partial degrees sum on this process's first device, then
    ``all_reduce`` over the world, then the mask updates
    (``ops.scc.run_sharded_trim``, which keeps these rounds whenever a
    ``reduce`` is given: ``ops.scc.trim_rounds``). Every process returns
    the same bool [n_nodes] mask, the reference's bit for bit. ``mesh``:
    this process's devices (default :func:`global_mesh` on ``device``);
    the local edges are padded with weight-0 edges to a multiple of its
    width."""
    from jepsen_tpu_torch.ops.scc import _check_ids, run_sharded_trim
    from jepsen_tpu_torch.parallel import shard_leading

    if mesh is None:
        mesh = global_mesh(device=device)
    src = np.asarray(local_src, np.int32)
    dst = np.asarray(local_dst, np.int32)
    _check_ids("trim_to_cycles_distributed", n_nodes, src, dst)
    E = len(src)
    z = np.zeros((-E) % mesh.size, np.int32)
    shards = shard_leading(mesh, np.concatenate([src, z]),
                           np.concatenate([dst, z]),
                           np.concatenate([np.ones(E, np.int32), z]))
    return run_sharded_trim(mesh, n_nodes, *shards, max_iters=max_iters,
                            reduce=_all_reduce).cpu().numpy()


# copied from jepsen_tpu/parallel/distributed.py:116-150
def localize_keys_distributed(streams, invalid_indices, step_ids=None,
                              step_py=None, init_state: int = 0,
                              device=None) -> dict:
    """Localizes the invalid keys of an independent batch across the
    world: each process the ones in ITS contiguous slice
    (``checker.explain.first_failure``: the matrix localization when in
    regime, the exact CPU frontier otherwise), then the per-key positions
    gather, so every process returns ``{key_index: (failed_event,
    failed_op_index)}``. A key whose localization raises is logged and
    left out (the forensics never fail the batch)."""
    from jepsen_tpu_torch.checker.explain import first_failure

    dev = _device(device)
    streams = list(streams)
    wanted = {int(i) for i in invalid_indices}
    lo, hi, per = _my_slice(len(streams))
    block = np.full((per, 3), -1, np.int64)
    for row, i in enumerate(range(lo, hi)):
        if i not in wanted:
            continue
        try:
            found = first_failure(streams[i], step_ids=step_ids,
                                  step_py=step_py, init_state=init_state,
                                  device=dev)
        except Exception:  # noqa: BLE001 — forensics never fail the batch
            # (and a rank that raised here would leave the others waiting
            # in the gather)
            logger.exception("localization of key %d failed", i)
            found = None
        if found is not None:
            block[row] = (i, found[0], found[1])
    out: dict = {}
    for rows in _all_gather_rows(block, dev):
        for key, ev, op in rows:
            if key >= 0:
                out[int(key)] = (int(ev), int(op))
    return out


# copied from jepsen_tpu/parallel/distributed.py:153-217
def batch_check_distributed(streams, capacity: int = 256, kernel=None,
                            device=None) -> list:
    """Independent keys across the world: every process checks its
    contiguous slice (``parallel.batch_check`` on its own devices: the
    local mesh only where ``pipeline.mesh_route`` says so, else one
    device), then the fixed-size row blocks gather, so every process
    returns the full [(alive, died, overflow, peak)] list, the contract
    of ``batch_check``."""
    from jepsen_tpu_torch import parallel
    from jepsen_tpu_torch.ops.jitlin import JitLinKernel
    from jepsen_tpu_torch.parallel import pipeline

    dev = _device(device if kernel is None else kernel.device)
    if kernel is None:
        kernel = JitLinKernel(device=dev)
    streams = list(streams)
    n = len(streams)
    lo, hi, per = _my_slice(n)
    local = []
    if hi > lo:
        mesh = False
        lm = (local_mesh(max_devices=parallel.mesh_devices_limit())
              if parallel.sharded_enabled() else None)
        if lm is not None and pipeline.mesh_route(
                sum(len(s.kind) for s in streams[lo:hi]), lm.size,
                lm.devices[0]):
            mesh = lm
        local = parallel.batch_check(streams[lo:hi], capacity=capacity,
                                     kernel=kernel, mesh=mesh)
    # one row a key of the slice, padded with sentinel rows (keys need
    # not divide by the processes); column 0 marks a real row
    block = np.full((per, 5), -1, np.int64)
    for i, (alive, died, ovf, peak) in enumerate(local):
        block[i] = (1, int(bool(alive)), int(died), int(bool(ovf)),
                    int(peak))
    out = [(bool(r[1]), int(r[2]), bool(r[3]), int(r[4]))
           for rows in _all_gather_rows(block, dev) for r in rows
           if r[0] == 1]
    if len(out) != n:
        raise RuntimeError(f"batch_check_distributed: gathered {len(out)} "
                           f"of {n} keys")
    return out
