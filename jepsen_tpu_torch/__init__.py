"""jepsen_tpu_torch: the PyTorch/CUDA port of jepsen_tpu.

The register linearizability check runs through hand-written Hopper
kernels (``ops/csrc/*.cu``): the per-chunk transfer-matrix product and
the chunk combine. Everything else on that path is numpy host code or
plain torch. The package imports neither ``jax`` nor ``jepsen_tpu``;
what it needs from the host-only modules of the JAX package is copied
here, each copy naming its origin.

Entry points run on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`jepsen_tpu_torch.device`).
"""
