"""State carried across from the JAX package, given as numpy arrays.

* :func:`stream_from_columns` — the ``lin_*`` column dict that
  jepsen_tpu's ``stream_to_columns`` writes into ``history.npz`` ->
  the port's EventStream.
* :func:`carry_from_numpy` — a ``[B, MV, MV]`` segment carry of the
  matrix chain (``matrix_check_resume``'s ``total``) -> the port's bf16
  carry on the device.
* :func:`frontier_from_numpy` — a frontier scan's carry (the dense
  builder's ``[2^S, V]`` table, or the sparse builder's ``(mask,
  state)`` pair) -> the port's tensors on the device, ready for
  ``frontier_kernels.frontier_dense`` / ``frontier_sparse``.
"""
from __future__ import annotations

import numpy as np
import torch

from jepsen_tpu_torch.checker.linear_encode import stream_from_columns
from jepsen_tpu_torch.device import resolve_device

__all__ = ["stream_from_columns", "carry_from_numpy", "frontier_from_numpy"]


def carry_from_numpy(tot0, device=None) -> torch.Tensor:
    """A [B, MV, MV] 0/1 operator-product carry as a bf16 tensor on
    ``device`` (the CUDA device by default)."""
    arr = np.asarray(tot0, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[1] != arr.shape[2]:
        raise ValueError(f"carry must be [B, MV, MV], got {arr.shape}")
    return torch.from_numpy(arr).to(resolve_device(device),
                                    dtype=torch.bfloat16)


def frontier_from_numpy(*carry, device=None):
    """A frontier carry of jepsen_tpu/ops/jitlin.py's scans on ``device``
    (the CUDA device by default): one ``[2^S, V]`` array -> the dense
    table as a bool tensor; a ``(mask [K], state [K])`` pair -> a uint32
    and an int32 tensor."""
    dev = resolve_device(device)
    if len(carry) == 1:
        table = np.asarray(carry[0])
        M = table.shape[0] if table.ndim == 2 else 0
        if table.ndim != 2 or M < 2 or M & (M - 1):
            raise ValueError(f"dense carry must be [2^S, V], got "
                             f"{table.shape}")
        return torch.from_numpy(table.astype(bool)).to(dev)
    if len(carry) == 2:
        mask = np.asarray(carry[0], dtype=np.uint32)
        state = np.asarray(carry[1], dtype=np.int32)
        if mask.ndim != 1 or mask.shape != state.shape:
            raise ValueError(f"sparse carry must be two [K] arrays, got "
                             f"{mask.shape} and {state.shape}")
        return (torch.from_numpy(mask.astype(np.int64)).to(dev).to(
            torch.uint32), torch.from_numpy(state.copy()).to(dev))
    raise ValueError(f"a frontier carry has 1 or 2 arrays, got {len(carry)}")
