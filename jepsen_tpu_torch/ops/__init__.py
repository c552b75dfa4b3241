"""Device operators: the transfer-matrix path (jitlin) and its Hopper
kernels (matrix_kernels, built from csrc/ by _build)."""
