"""Columnar views of a history for the device paths.

The JAX package keeps these in its history IR (jepsen_tpu/history_ir),
memoized per run. The port has no IR yet, so :mod:`.views` holds the
views as plain functions of a history.
"""
