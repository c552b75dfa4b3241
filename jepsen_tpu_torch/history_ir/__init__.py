"""The columnar history IR (jepsen_tpu/history_ir): one encoding of a
run's history, persisted as the ``history.npz`` sidecar.

:class:`DeviceHistory` holds the canonical columns and memoizes the
checkers' encodings as views (:mod:`.views`); :mod:`.sidecar` saves and
loads it. The store builds one per run when it writes the sidecar. Not
ported: the IR shared by a run's checkers through the test map
(``history_ir.of`` and the ``ir_enabled`` knob) and the WAL streamer.
"""
from jepsen_tpu_torch.history_ir.ir import CANONICAL_COLUMNS, DeviceHistory

__all__ = ["DeviceHistory", "CANONICAL_COLUMNS"]
