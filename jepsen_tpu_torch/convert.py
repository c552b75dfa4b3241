"""State carried across from the JAX package, given as numpy arrays.

* :func:`stream_from_columns` — the ``lin_*`` column dict that
  jepsen_tpu's ``stream_to_columns`` writes into ``history.npz`` ->
  the port's EventStream.
* :func:`carry_from_numpy` — a ``[B, MV, MV]`` segment carry of the
  matrix chain (``matrix_check_resume``'s ``total``) -> the port's bf16
  carry on the device.
"""
from __future__ import annotations

import numpy as np
import torch

from jepsen_tpu_torch.checker.linear_encode import stream_from_columns
from jepsen_tpu_torch.device import resolve_device

__all__ = ["stream_from_columns", "carry_from_numpy"]


def carry_from_numpy(tot0, device=None) -> torch.Tensor:
    """A [B, MV, MV] 0/1 operator-product carry as a bf16 tensor on
    ``device`` (the CUDA device by default)."""
    arr = np.asarray(tot0, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[1] != arr.shape[2]:
        raise ValueError(f"carry must be [B, MV, MV], got {arr.shape}")
    return torch.from_numpy(arr).to(resolve_device(device),
                                    dtype=torch.bfloat16)
