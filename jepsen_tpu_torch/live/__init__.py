"""Online consistency checking (jepsen_tpu/live): verdicts while a run
runs. A run's ``history.wal.jsonl`` is tailed poll by poll
(:class:`jepsen_tpu_torch.journal.WalTailer`, through the C chunk
scanner) into per-run incremental checker sessions
(:mod:`jepsen_tpu_torch.live.sessions`): a resumable register check
whose matrix screen runs on the card, a multi-key one, and an
incrementally built Elle graph. Each poll answers "valid so far" or
"first anomaly at op N". :class:`LiveDaemon`
(:mod:`jepsen_tpu_torch.live.daemon`) discovers the runs under a store
root, tails and checks them, and publishes each run's
``live-status.json`` and the ``live-metrics`` export.
"""
from jepsen_tpu_torch.live.sessions import (  # noqa: F401
    ElleSession, LinearLiveSession, MultiKeyLinearSession, UNSUPPORTED,
    restore_session, session_for_ops,
)
from jepsen_tpu_torch.live.daemon import (  # noqa: F401
    LIVE_BREAKER_THRESHOLD, LiveDaemon, RunTracker, load_live_status, serve,
)
