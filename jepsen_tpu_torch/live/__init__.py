"""Online consistency checking (jepsen_tpu/live): verdicts while a run
runs. A run's ``history.wal.jsonl`` is tailed poll by poll
(:class:`jepsen_tpu_torch.journal.WalTailer`) into per-run incremental
checker sessions (:mod:`jepsen_tpu_torch.live.sessions`): a resumable
register check whose matrix screen runs on the card, a multi-key one,
and an incrementally built Elle graph. Each poll answers "valid so far"
or "first anomaly at op N". Not ported: the daemon that discovers runs
under a store root and publishes their status (``live/daemon.py``).
"""
from jepsen_tpu_torch.live.sessions import (  # noqa: F401
    ElleSession, LinearLiveSession, MultiKeyLinearSession, UNSUPPORTED,
    restore_session, session_for_ops,
)
