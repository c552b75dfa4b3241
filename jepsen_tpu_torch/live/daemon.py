"""The online checker daemon: discovery, polling, admission, status
(jepsen_tpu/live/daemon.py).

:class:`LiveDaemon` runs a single poller thread (or is polled by its
caller, :meth:`LiveDaemon.poll_once`) that:

1. **discovers** active runs — run directories holding a
   ``history.wal.jsonl`` with no final live verdict yet;
2. **tails** each run's WAL via :class:`jepsen_tpu_torch.journal.WalTailer`
   (offset-tracking, torn-line tolerant, the C chunk scanner);
3. **checks** each run incrementally through its
   :mod:`~jepsen_tpu_torch.live.sessions` session (on ``device`` under
   ``accelerator``: the register session's matrix screen launches the
   chunk-product and combine kernels on the card), under
   **cost-model-driven admission**: one poll's verdict work is budgeted
   by the measured checking rate
   (:class:`jepsen_tpu_torch.parallel.pipeline.CostModel`), the
   most-lagged runs are served first, and a hot run consumes at most
   its fair share — the rest defer with a counted metric instead of
   starving;
4. **publishes** per-run ``live-status.json`` (atomic) plus ``live_*``
   gauges/histograms into its metrics registry, exported as
   ``live-metrics.prom`` / ``live-metrics.json`` under the store root;
5. **finalizes** a run when its authoritative ``history.jsonl``
   appears: any tail the discarded WAL didn't deliver is absorbed from
   the history file, the session settles its exact final verdict, and
   the final state is left in ``live-status.json``.

Shutdown is wedge-proof: ``stop()`` signals the poller and joins it
with :func:`jepsen_tpu_torch.utils.join_noisy` (bounded waits +
heartbeat logging; the thread itself is a daemon thread, so a hung
check can never hold the process hostage). Per-run circuit breakers
stop re-dispatching a session that failed ``LIVE_BREAKER_THRESHOLD``
consecutive polls.

Changes from the reference: the top-K of per-run metric series is the
module constant ``DEFAULT_RUN_SERIES_TOPK`` (the reference reads
``JEPSEN_TPU_LIVE_RUN_SERIES``; the port reads no environment
variable); the cadence and budgets are plain numbers, with no tolerant
parsing of config strings (the port has no test map to read them
from); ``accelerator`` and ``device`` pass through to the sessions.
Not ported: the fleet's run leases and write fencing (``lease_store``,
``fence``, ``lease``) and the ``on_final`` hook of the schedule fuzzer;
they come with those modules. The CLI (``jepsen-tpu live``) comes with
the port's CLI.
"""
from __future__ import annotations

import json
import logging
import threading
import time
from pathlib import Path

from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.journal import WAL_NAME, WalTailer
from jepsen_tpu_torch.live import sessions as sessions_mod
from jepsen_tpu_torch.utils import join_noisy

logger = logging.getLogger("jepsen_tpu_torch.live")

# copied from jepsen_tpu/live/daemon.py:48-76
LIVE_STATUS_NAME = "live-status.json"
# per-run restart snapshot: session carry + WAL byte offset, so a daemon
# restart resumes tailing where it left off instead of re-ingesting the
# whole WAL
LIVE_CKPT_NAME = "live-session.ckpt"
# at most one snapshot write per tracked run per this many seconds
SNAPSHOT_MIN_INTERVAL_S = 5.0

DEFAULT_POLL_S = 1.0
DEFAULT_LAG_BUDGET_OPS = 50_000
DEFAULT_MAX_RUNS = 16
DEFAULT_CHECK_BUDGET_S = 0.5
LIVE_BREAKER_THRESHOLD = 3

# Cap on distinct {run} label values in the per-run metric export: at
# fleet scale (100+ concurrent runs) one series per run per gauge is a
# cardinality explosion every scrape pays for. The top-K runs by lag
# keep their own series; the rest fold into one run="other" aggregate.
# Read at each use, so a test can monkeypatch it.
DEFAULT_RUN_SERIES_TOPK = 8


# copied from jepsen_tpu/live/daemon.py:102-108
def load_live_status(run_dir) -> dict | None:
    """The run's live-status.json as a dict, or None."""
    try:
        with open(Path(run_dir) / LIVE_STATUS_NAME) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


# copied from jepsen_tpu/live/daemon.py:111-458, without the lease fence
class RunTracker:
    """One tracked run: tailer + session + status/metric publication.
    Durable artifacts (the restart snapshot, live-status.json) go
    through atomic tmp+fsync+rename writers only."""

    def __init__(self, run_dir, accelerator: str = "auto", device=None):
        self.run_dir = Path(run_dir)
        self.name = self.run_dir.parent.name
        self.timestamp = self.run_dir.name
        self.accelerator = accelerator
        self.device = device
        self.tailer = WalTailer(self.run_dir / WAL_NAME)
        self.session = None
        self._sniff_buf: list[dict] = []
        self.unsupported = False
        self.final = False
        self.broken: str | None = None
        self._consecutive_failures = 0
        self.ops_absorbed = 0
        self.polls = 0
        self._caught_up_t = time.monotonic()
        # valid_so_far stays None (-> live_verdict -1, "unknown") until
        # a session actually verdicts: an untracked workload or a run
        # the breaker broke before its first check must never read as
        # "valid"
        self.last_verdict: dict = {"valid_so_far": None,
                                   "first_anomaly_op": None,
                                   "backend": None, "checked_ops": 0}
        # restart adoption: True resumed from a snapshot, False rejected
        # one (divergence / unrestorable), None = no snapshot found
        self.resumed: bool | None = None
        self._last_snapshot = 0.0
        self._snapshot_ops = 0
        self._adopt_snapshot()

    # -- restart snapshots ----------------------------------------------

    @property
    def _ckpt_path(self) -> Path:
        return self.run_dir / LIVE_CKPT_NAME

    def _adopt_snapshot(self) -> None:
        """Divergence-checked adoption of a previous daemon's snapshot:
        the tailer only seeks to the saved offset when the WAL's first
        ``offset`` bytes hash to what the writer consumed, and the
        session payload must restore whole. Anything else discards the
        snapshot and re-ingests from zero — a restart may cost a
        re-read, never a diverged verdict."""
        try:
            with open(self._ckpt_path, encoding="utf-8") as f:
                snap = json.load(f)
        except (OSError, ValueError):
            return
        if snap.get("version") != 1:
            self.resumed = False
            return
        session = None
        if snap.get("session") is not None:
            session = sessions_mod.restore_session(
                snap["session"], accelerator=self.accelerator,
                device=self.device)
            if session is None:
                logger.warning("live: %s snapshot's session payload "
                               "didn't restore; re-ingesting", self.label)
                self.resumed = False
                return
        elif not snap.get("unsupported"):
            # a sessionless, not-unsupported snapshot would drop the
            # sniff buffer's ops — re-ingest instead
            self.resumed = False
            return
        if not self.tailer.seek(snap.get("offset", 0),
                                lines_read=snap.get("lines_read", 0),
                                torn_skipped=snap.get("torn_skipped", 0),
                                prefix_sha=snap.get("prefix_sha")):
            logger.warning("live: %s WAL diverged from its restart "
                           "snapshot (hash mismatch); re-ingesting",
                           self.label)
            self.resumed = False
            return
        self.session = session
        self.unsupported = bool(snap.get("unsupported"))
        self.ops_absorbed = int(snap.get("ops_absorbed", 0))
        last = snap.get("last_verdict")
        if isinstance(last, dict):
            self.last_verdict = last
        self.resumed = True
        logger.info("live: %s resumed from snapshot at WAL offset %d "
                    "(%d ops absorbed)", self.label, self.tailer.offset,
                    self.ops_absorbed)

    def maybe_snapshot(self) -> bool:
        """Persists the restart snapshot when the interval elapsed and
        something new was absorbed. Unsnapshotable sessions (Elle's
        retained-history state) skip — their restart path is the
        re-ingest."""
        if self.final or self.broken:
            return False
        if self.session is None and not self.unsupported:
            return False  # still sniffing: the buffer isn't durable
        now = time.monotonic()
        if now - self._last_snapshot < SNAPSHOT_MIN_INTERVAL_S:
            return False
        if self.ops_absorbed == self._snapshot_ops:
            return False
        sess_snap = None
        if self.session is not None:
            sess_snap = self.session.snapshot()
            if sess_snap is None:
                return False
        payload = {
            "version": 1,
            "offset": self.tailer.offset,
            "lines_read": self.tailer.lines_read,
            "torn_skipped": self.tailer.torn_skipped,
            "prefix_sha": self.tailer.prefix_sha(),
            "ops_absorbed": self.ops_absorbed,
            "unsupported": self.unsupported,
            "session": sess_snap,
            "last_verdict": dict(self.last_verdict),
            "wrote_at": time.time(),
        }
        try:
            from jepsen_tpu_torch.utils import atomic_write_json
            atomic_write_json(self._ckpt_path, payload)
        except Exception:  # noqa: BLE001 — snapshots never kill a poll
            logger.exception("live: snapshot write failed for %s",
                             self.label)
            return False
        self._last_snapshot = now
        self._snapshot_ops = self.ops_absorbed
        return True

    def clear_snapshot(self) -> None:
        try:
            self._ckpt_path.unlink(missing_ok=True)
        except OSError:
            logger.exception("couldn't clear %s", self._ckpt_path)

    @property
    def label(self) -> str:
        return f"{self.name}/{self.timestamp}"

    # -- ingestion ------------------------------------------------------

    def _absorb(self, ops: list[dict]) -> None:
        if not ops:
            return
        self.ops_absorbed += len(ops)
        if self.unsupported:
            return
        if self.session is None:
            self._sniff_buf.extend(ops)
            sniffed = sessions_mod.session_for_ops(
                self._sniff_buf, accelerator=self.accelerator,
                device=self.device)
            if sniffed is sessions_mod.UNSUPPORTED:
                # this workload has no live checker — keep tailing for
                # lag/liveness, never verdicts
                self.unsupported = True
                self._sniff_buf = []
            elif sniffed is not None:
                self.session = sniffed
                self.session.add_many(self._sniff_buf)
                self._sniff_buf = []
            return
        # chunked ingest: one native call a poll (history_ir.ingest)
        self.session.add_many(ops)

    def tail(self) -> int:
        """One tailer poll; returns the number of new ops."""
        ops = self.tailer.poll()
        self._absorb(ops)
        return len(ops)

    def completed(self) -> bool:
        return (self.run_dir / "history.jsonl").exists()

    # -- checking -------------------------------------------------------

    @property
    def pending_ops(self) -> int:
        checked = (self.session.checked_ops if self.session is not None
                   else self.ops_absorbed)
        return max(0, self.ops_absorbed - checked)

    def lag_seconds(self, now: float) -> float:
        return 0.0 if self.pending_ops == 0 else now - self._caught_up_t

    def check(self) -> dict:
        """One verdict dispatch over everything absorbed so far."""
        if self.session is None or self.broken:
            return dict(self.last_verdict)
        try:
            v = self.session.verdict()
            self._consecutive_failures = 0
        except Exception as e:  # noqa: BLE001 — one bad run can't kill the daemon
            self._consecutive_failures += 1
            logger.exception("live check failed for %s", self.label)
            if self._consecutive_failures >= LIVE_BREAKER_THRESHOLD:
                self.broken = f"checker breaker open: {e!r}"
                logger.warning("live breaker open for %s after %d "
                               "consecutive failures", self.label,
                               self._consecutive_failures)
            return dict(self.last_verdict)
        self.last_verdict = v
        if self.pending_ops == 0:
            self._caught_up_t = time.monotonic()
        return dict(v)

    def finalize(self) -> dict | None:
        """End-of-run: absorb any ops the discarded WAL never delivered
        (from the authoritative history.jsonl), settle the exact final
        verdict, and return the final results map (None when the run
        has no live checker)."""
        from jepsen_tpu_torch.journal import read_jsonl_tolerant
        self.tail()
        try:
            ops, _ = read_jsonl_tolerant(self.run_dir / "history.jsonl")
        except OSError:
            ops = []
        if self.tailer.torn_skipped or self.tailer.truncated_tail:
            # a torn WAL line means what we absorbed is NOT a strict
            # prefix of the authoritative history — a count-based
            # back-fill would misalign the session (skip the torn op,
            # double the tail). Rebuild from history.jsonl: slower,
            # exact, and the final verdict stays safe to reuse.
            logger.warning(
                "live: %s WAL had %d torn line(s); rebuilding the "
                "session from history.jsonl for the final verdict",
                self.label, self.tailer.torn_skipped)
            self.session = None
            self._sniff_buf = []
            self.unsupported = False
            self.ops_absorbed = 0
            self._absorb(ops)
        elif len(ops) > self.ops_absorbed:
            self._absorb(ops[self.ops_absorbed:])
        self.final = True
        if self.session is None or self.broken:
            return None
        try:
            results = self.session.finalize()
            self.last_verdict = self.session.last()
            return results
        except Exception:  # noqa: BLE001
            logger.exception("live finalize failed for %s", self.label)
            self.broken = "finalize failed"
            return None

    # -- status ---------------------------------------------------------

    def status(self, lag_budget_ops: float, results: dict | None = None,
               now: float | None = None) -> dict:
        now = time.monotonic() if now is None else now
        state = ("error" if self.broken
                 else "final" if self.final
                 else "untracked" if self.unsupported or self.session is None
                 else "tailing")
        out = {
            "name": self.name,
            "timestamp": self.timestamp,
            "state": state,
            "workload": (self.session.workload
                         if self.session is not None else None),
            "valid_so_far": self.last_verdict.get("valid_so_far"),
            "first_anomaly_op": self.last_verdict.get("first_anomaly_op"),
            "backend": self.last_verdict.get("backend"),
            "ops_absorbed": self.ops_absorbed,
            "checked_ops": (self.session.checked_ops
                            if self.session is not None else 0),
            "lag_ops": self.pending_ops,
            "lag_s": round(self.lag_seconds(now), 3),
            "lag_budget_ops": lag_budget_ops,
            "over_lag_budget": self.pending_ops > lag_budget_ops,
            "torn_skipped": self.tailer.torn_skipped,
            "polls": self.polls,
            "updated": time.time(),
        }
        if self.broken:
            out["error"] = self.broken
        if results is not None:
            out["results"] = results
        return out

    def write_status(self, status: dict) -> None:
        try:
            telemetry._atomic_write(
                self.run_dir / LIVE_STATUS_NAME,
                json.dumps(status, default=repr) + "\n")
        except Exception:  # noqa: BLE001 — status publication never kills polls
            logger.exception("couldn't write %s for %s",
                             LIVE_STATUS_NAME, self.label)


# copied from jepsen_tpu/live/daemon.py:461-960, without the lease store
# and the on_final hook
class LiveDaemon:
    """Multiplexes live checking over every active run under a store
    root (and/or explicitly named run directories). ``accelerator`` and
    ``device`` are the sessions' (the CUDA device by default)."""

    def __init__(self, store_root: str | None = None, run_dirs=(),
                 poll_s=DEFAULT_POLL_S,
                 lag_budget_ops=DEFAULT_LAG_BUDGET_OPS,
                 max_runs=DEFAULT_MAX_RUNS,
                 check_budget_s=DEFAULT_CHECK_BUDGET_S,
                 accelerator: str = "auto", device=None,
                 registry: telemetry.Registry | None = None,
                 cost_model=None):
        self.store_root = Path(store_root) if store_root else None
        self.run_dirs = [Path(d) for d in run_dirs]
        self.poll_s = poll_s
        self.lag_budget_ops = lag_budget_ops
        self.max_runs = max_runs
        self.check_budget_s = check_budget_s
        self.accelerator = accelerator
        self.device = device
        self.registry = registry if registry is not None \
            else telemetry.Registry()
        if cost_model is None:
            from jepsen_tpu_torch.parallel.pipeline import CostModel
            cost_model = CostModel()
        self.cost_model = cost_model
        self.trackers: dict[str, RunTracker] = {}
        self.polls = 0
        # discovery cache: {name_dir: (mtime_ns, [run_dirs])} — a name
        # dir's run list is reused between polls while its mtime holds
        self._scan_cache: dict | None = None
        # candidates examined and rejected, keyed by run-dir mtime_ns:
        # skipped with ONE stat per poll until something changes inside
        self._settled: dict[str, int] = {}
        # stable {run} label interning for per-run counters (bounded
        # at DEFAULT_RUN_SERIES_TOPK exact labels; later runs share
        # "other")
        self._run_labels: dict[str, str] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._lock = threading.Lock()  # guards trackers vs. stop/inspect

    # -- discovery ------------------------------------------------------

    def _candidate_dirs(self) -> list[Path]:
        """Run-dir candidates under the store root, via a per-name-dir
        cached scan with an mtime fast-path: run dirs are created and
        removed *inside* name dirs, so an unchanged name-dir mtime
        proves its cached run-dir list is still complete. A poll over
        an unchanged tree costs one root listing plus one stat per
        name dir, not an O(runs) listing. (The root's own mtime is
        deliberately not part of the key: the metrics export writes
        files there every poll.)"""
        out = list(self.run_dirs)
        root = self.store_root
        if root is None or not root.is_dir():
            return out
        cache = self._scan_cache
        fresh: dict[Path, tuple[int, list[Path]]] = {}
        all_hit = cache is not None
        for name_dir in root.iterdir():
            if not name_dir.is_dir() or name_dir.name == "current" \
                    or name_dir.is_symlink():
                continue
            try:
                m = name_dir.stat().st_mtime_ns
            except OSError:
                continue
            got = cache.get(name_dir) if cache is not None else None
            if got is not None and got[0] == m:
                fresh[name_dir] = got
                out.extend(got[1])
                continue
            all_hit = False
            runs = [run_dir for run_dir in name_dir.iterdir()
                    if run_dir.is_dir() and not run_dir.is_symlink()
                    and run_dir.name != "latest"]
            fresh[name_dir] = (m, runs)
            out.extend(runs)
        self._scan_cache = fresh
        if all_hit:
            self.registry.counter(
                "live_scan_cache_hits_total",
                "discovery polls answered entirely from the cached "
                "store scan (name-dir mtime fast-path)").inc()
        return out

    def discover(self) -> int:
        """Adds trackers for active runs (WAL present, not yet final),
        newest first, bounded by ``max_runs``. Returns the number
        of newly-admitted runs. Candidates rejected once are skipped
        with a single run-dir stat until their mtime changes (a WAL or
        status file appearing bumps it), so settled runs cost O(1) per
        poll instead of a WAL stat + a status-JSON parse each."""
        added = 0
        cands = []
        for d in self._candidate_dirs():
            key = str(d)
            if key in self.trackers:
                continue
            try:
                d_m = d.stat().st_mtime_ns
            except OSError:
                continue
            if self._settled.get(key) == d_m:
                continue  # rejected before; nothing changed inside since
            if not (d / WAL_NAME).exists():
                self._settled[key] = d_m
                continue
            status = load_live_status(d)
            if status is not None and status.get("state") == "final":
                # a previous daemon already settled this run
                self._settled[key] = d_m
                continue
            if (d / "history.jsonl").exists() and status is None \
                    and d not in self.run_dirs:
                # completed before we ever saw it: post-hoc territory
                self._settled[key] = d_m
                continue
            try:
                mtime = (d / WAL_NAME).stat().st_mtime
            except OSError:
                continue
            cands.append((mtime, d))
        cands.sort(reverse=True)
        for _mtime, d in cands:
            with self._lock:
                full = len(self.trackers) >= self.max_runs
            if full:
                self.registry.counter(
                    "live_admission_rejected_total",
                    "runs not admitted because max_runs "
                    "trackers are active").inc()
                break
            # construct OUTSIDE the lock: snapshot adoption re-hashes
            # the consumed WAL prefix (seconds on a big run), and
            # stop()/poll must not block behind it
            tracker = RunTracker(d, accelerator=self.accelerator,
                                 device=self.device)
            with self._lock:
                self.trackers[str(d)] = tracker
            if tracker.resumed is True:
                self.registry.counter(
                    "live_session_resumes_total",
                    "trackers resumed from a restart snapshot instead "
                    "of re-ingesting the WAL").inc()
            elif tracker.resumed is False:
                self.registry.counter(
                    "live_session_resume_rejected_total",
                    "restart snapshots discarded (divergence or "
                    "unrestorable payload); the tracker re-ingested"
                ).inc()
            added += 1
            logger.info("live: tracking %s", d)
        return added

    # -- polling --------------------------------------------------------

    def poll_once(self) -> dict:
        """One full poll: discover, tail everything, verdict within the
        admission budget (most-lagged first), publish status + metrics.
        Returns a {label: status} snapshot."""
        t0 = time.perf_counter()
        self.polls += 1
        from jepsen_tpu_torch import trace as trace_mod
        tracer = trace_mod.get_tracer()
        poll_t0 = trace_mod.now_us() if tracer.enabled else 0
        self.discover()
        reg = self.registry
        now = time.monotonic()
        with self._lock:
            trackers = list(self.trackers.values())
        statuses: dict[str, dict] = {}
        rows: list[tuple[RunTracker, dict]] = []
        done: list[str] = []

        for tr in trackers:
            n = tr.tail()
            if n:
                reg.counter("live_ops_tailed_total",
                            "ops read from run WALs", labels=("run",)
                            ).inc(n, run=self._run_label(tr.label))

        # admission: serve the most-lagged runs first; a poll spends at
        # most check_budget_s of predicted checking time, so one
        # hot run defers instead of starving its neighbours
        budget_ops = self.cost_model.admission_budget_ops(
            self.check_budget_s)
        spent_ops = 0.0
        order = sorted(trackers, key=lambda t: t.pending_ops,
                       reverse=True)
        for tr in order:
            tr.polls += 1
            results = None
            pending = tr.pending_ops
            if tr.completed() and not tr.final:
                t_chk = time.perf_counter()
                chk_t0 = trace_mod.now_us() if tracer.enabled else 0
                results = tr.finalize()
                if tracer.enabled:
                    tracer.complete(trace_mod.TRACK_LIVE, "finalize",
                                    chk_t0, trace_mod.now_us() - chk_t0,
                                    args={"run": tr.label,
                                          "ops": pending})
                self._observe_check(tr, pending,
                                    time.perf_counter() - t_chk)
                # the run is over: the restart snapshot has nothing
                # left to resume (live-status.json holds the final)
                tr.clear_snapshot()
                done.append(str(tr.run_dir))
            elif tr.final:
                done.append(str(tr.run_dir))
            elif pending > 0 and tr.session is not None \
                    and not tr.broken:
                if spent_ops > 0 and spent_ops + pending > budget_ops:
                    reg.counter(
                        "live_admission_deferred_total",
                        "verdicts deferred to a later poll by the "
                        "admission budget", labels=("run",)
                        ).inc(run=self._run_label(tr.label))
                else:
                    t_chk = time.perf_counter()
                    chk_t0 = trace_mod.now_us() if tracer.enabled else 0
                    tr.check()
                    dt = time.perf_counter() - t_chk
                    if tracer.enabled:
                        tracer.complete(trace_mod.TRACK_LIVE, "check",
                                        chk_t0,
                                        trace_mod.now_us() - chk_t0,
                                        args={"run": tr.label,
                                              "ops": pending})
                    self._observe_check(tr, pending, dt)
                    spent_ops += pending
            if not tr.final and tr.maybe_snapshot():
                reg.counter("live_session_ckpt_writes_total",
                            "restart-snapshot persists (session carry "
                            "+ WAL offset)").inc()
            status = tr.status(self.lag_budget_ops, results=results,
                               now=now)
            tr.write_status(status)
            statuses[tr.label] = status
            rows.append((tr, status))
        self._publish_run_series(rows)

        with self._lock:
            for key in done:
                self.trackers.pop(key, None)
            active = len(self.trackers)
        reg.gauge("live_runs_active",
                  "runs currently tracked by the live checker"
                  ).set(active)
        reg.counter("live_polls_total", "daemon poll loops").inc()
        reg.histogram("live_poll_seconds",
                      "wall time of one full daemon poll"
                      ).observe(time.perf_counter() - t0)
        if tracer.enabled:
            tracer.complete(trace_mod.TRACK_LIVE, "poll", poll_t0,
                            trace_mod.now_us() - poll_t0,
                            args={"runs": len(trackers)})
        self._export()
        return statuses

    def _observe_check(self, tr: RunTracker, n_ops: int,
                       seconds: float) -> None:
        reg = self.registry
        workload = (tr.session.workload if tr.session is not None
                    else "none")
        reg.histogram("live_check_seconds",
                      "incremental verdict dispatch wall time",
                      labels=("workload",)).observe(seconds,
                                                    workload=workload)
        if n_ops > 0 and seconds > 0:
            # feed the shared cost model so admission budgets track the
            # measured host instead of the built-in default
            from jepsen_tpu_torch.parallel.pipeline import observe_cpu_rate
            observe_cpu_rate(n_ops, seconds)

    def _run_label(self, label: str) -> str:
        """Bounded {run} label interning for per-run counters: the first
        ``DEFAULT_RUN_SERIES_TOPK`` distinct runs keep their exact label;
        every later run shares ``"other"`` so a fleet-scale store can't
        blow up prom series cardinality. Counters can't be re-labeled after
        the fact (their value is cumulative), so the mapping is sticky
        for the daemon's lifetime."""
        got = self._run_labels.get(label)
        if got is not None:
            return got
        if len(self._run_labels) < DEFAULT_RUN_SERIES_TOPK:
            self._run_labels[label] = label
            return label
        return "other"

    def _publish_run_series(self, rows: list) -> None:
        """Rebuilds the {run}-labeled gauges from this poll's statuses:
        exact series for the top-K most-lagged runs, one ``run="other"``
        aggregate for the rest (worst lag / worst verdict / summed open
        breakers), and the unlabeled fleet rollups. Gauges are cleared
        first so runs that finished or fell out of the top K don't
        linger as stale series."""
        reg = self.registry
        lag_g = reg.gauge("live_checker_lag_ops",
                          "ops absorbed but not yet covered by a verdict",
                          labels=("run",))
        lag_s_g = reg.gauge("live_checker_lag_s",
                            "seconds since this run's checker last "
                            "caught up", labels=("run",))
        verdict_g = reg.gauge("live_verdict",
                              "1 valid-so-far, 0 invalid, -1 "
                              "unknown/untracked", labels=("run",))
        first_g = reg.gauge("live_first_anomaly_op",
                            "history index of the first anomaly "
                            "(-1: none found)", labels=("run",))
        breaker_g = reg.gauge("live_run_breaker_open",
                              "1 while a run's checker circuit breaker "
                              "is open (other: open-breaker count)",
                              labels=("run",))
        for g in (lag_g, lag_s_g, verdict_g, first_g, breaker_g):
            g.clear()

        ranked = sorted(rows, key=lambda r: r[1]["lag_ops"],
                        reverse=True)
        exact, other = ranked[:DEFAULT_RUN_SERIES_TOPK], \
            ranked[DEFAULT_RUN_SERIES_TOPK:]
        for tr, st in exact:
            run = tr.label
            lag_g.set(st["lag_ops"], run=run)
            lag_s_g.set(st["lag_s"], run=run)
            valid = st.get("valid_so_far")
            verdict_g.set(
                1.0 if valid is True else
                0.0 if valid is False else -1.0, run=run)
            first = st.get("first_anomaly_op")
            first_g.set(-1.0 if first is None else float(first),
                        run=run)
            if tr.broken:
                breaker_g.set(1.0, run=run)
        if other:
            sts = [st for _, st in other]
            lag_g.set(max(st["lag_ops"] for st in sts), run="other")
            lag_s_g.set(max(st["lag_s"] for st in sts), run="other")
            valids = [st.get("valid_so_far") for st in sts]
            # worst-case ordering: any invalid beats any unknown beats
            # all-valid (a plain min() would rank unknown below invalid)
            verdict_g.set(
                0.0 if any(v is False for v in valids) else
                -1.0 if any(v is None for v in valids) else 1.0,
                run="other")
            broken = sum(1 for tr, _ in other if tr.broken)
            if broken:
                breaker_g.set(float(broken), run="other")

        # unlabeled fleet rollups: always cheap to scrape no matter how
        # many runs the pool holds
        all_sts = [st for _, st in rows]
        reg.gauge("fleet_runs_active",
                  "runs tracked by this pool that are not yet final"
                  ).set(sum(1 for st in all_sts
                            if st.get("state") != "final"))
        reg.gauge("fleet_worst_lag_ops",
                  "largest per-run checker lag across the pool"
                  ).set(max((st["lag_ops"] for st in all_sts),
                            default=0))
        reg.gauge("fleet_invalid_runs",
                  "runs whose live verdict is invalid-so-far"
                  ).set(sum(1 for st in all_sts
                            if st.get("valid_so_far") is False))

    def _export(self) -> None:
        d = self.store_root
        if d is None:
            d = (self.run_dirs[0].parent.parent if self.run_dirs
                 else None)
        if d is None:
            return
        try:
            self.registry.export(d, prefix="live-metrics")
        except Exception:  # noqa: BLE001 — export never stops the poller
            logger.exception("live metrics export failed")

    # -- lifecycle ------------------------------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            t0 = time.monotonic()
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the poller must survive anything
                logger.exception("live poll failed")
            rest = self.poll_s - (time.monotonic() - t0)
            if rest > 0:
                self._stop.wait(rest)

    def start(self) -> "LiveDaemon":
        if self._thread is not None:
            return self
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="jepsen-live-poller")
        self._thread.start()
        return self

    def stop(self) -> None:
        """Wedge-proof shutdown: signal, then join with bounded-wait
        heartbeats (utils.join_noisy); one final metrics export."""
        self._stop.set()
        t = self._thread
        if t is not None:
            join_noisy(t, "live daemon poller", heartbeat_s=5.0)
            self._thread = None
        self._export()

    def run_until_idle(self, timeout_s: float = 60.0) -> dict:
        """Foreground helper (tests, ``--once``): polls until every
        tracked run has finalized (or ``timeout_s`` elapses); returns
        the last status snapshot."""
        deadline = time.monotonic() + timeout_s
        statuses: dict = {}
        while time.monotonic() < deadline:
            statuses = self.poll_once()
            with self._lock:
                active = len(self.trackers)
            if not active:
                break
            # honor the configured cadence (--poll): a foreground --once
            # over long-running tests must not re-scan/re-export at 20 Hz
            time.sleep(min(self.poll_s,
                           max(0.0, deadline - time.monotonic())))
        return statuses


# copied from jepsen_tpu/live/daemon.py:962-974
def serve(store_root: str | None, run_dirs=(), **kw) -> None:
    """Runs the daemon in the foreground until interrupted; ``kw`` are
    :class:`LiveDaemon`'s arguments."""
    daemon = LiveDaemon(store_root=store_root, run_dirs=run_dirs, **kw)
    daemon.start()
    logger.info("live checker daemon polling every %.3gs (ctrl-C stops)",
                daemon.poll_s)
    try:
        while True:
            time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        daemon.stop()
