"""Orchestrator: the full test lifecycle (the port of jepsen_tpu/core.py,
after jepsen/src/jepsen/core.clj).

``run(test)``: prepare -> logging -> node sessions -> OS setup -> DB cycle ->
client+nemesis setup -> generator interpreter -> log snarfing -> teardown ->
save-1 -> analyze -> save-2 -> results (core.clj:326-397). A *test is a map*
(core.clj:326-352): plain dict keys name/nodes/concurrency/ssh/os/db/client/
nemesis/generator/checker/... merged over fakes.noop_test defaults.

The port runs the loop over the dummy remote (``ssh: {"dummy": True}``)
and ends in the checker, which reaches the card. Not ported yet (ROADMAP
Queue 1 item 11): the preflight gate, so a run behaves as the
reference's does under ``preflight: False``; the WAL streamer of the
history IR; the client span tracer of a ``trace`` run (its Perfetto
``trace.json`` is written); and the live-verdict reuse of the append
workload.
"""
from __future__ import annotations

import contextlib
import logging
import threading
from typing import Any

from jepsen_tpu_torch import client as client_mod
from jepsen_tpu_torch import control, db as db_mod, history as history_mod, store
from jepsen_tpu_torch import journal as journal_mod
from jepsen_tpu_torch import telemetry
from jepsen_tpu_torch.checker import check_safe
from jepsen_tpu_torch.generator import interpreter
from jepsen_tpu_torch.nemesis import faults as faults_mod
from jepsen_tpu_torch.utils import (
    join_noisy, parse_concurrency, real_pmap, retry_with_backoff,
    with_relative_time, with_thread_name,
)

logger = logging.getLogger("jepsen_tpu_torch.core")

# copied from jepsen_tpu/core.py:31-558, without the preflight gate, the
# WAL streamer, the ingest knob and the client span tracer


def synchronize(test: dict, timeout_s: float = 60.0) -> None:
    """A barrier across all db nodes' setup threads (core.clj:44-57).
    DB implementations call this between setup phases. A broken barrier
    (another node failed or timed out) surfaces as SetupFailed so
    db.cycle retries the whole cycle."""
    barrier = test.get("barrier")
    if barrier is not None:
        try:
            barrier.wait(timeout=timeout_s)
        except threading.BrokenBarrierError as e:
            raise db_mod.SetupFailed("setup barrier broken") from e


def prepare_test(test: dict) -> dict:
    """Fills start-time, concurrency, and the setup barrier
    (core.clj:310-324)."""
    test = dict(test)
    test.setdefault("start_time", store.start_time())
    n_nodes = len(test.get("nodes") or [])
    test["concurrency"] = parse_concurrency(test.get("concurrency", 1), n_nodes)
    if n_nodes:
        test.setdefault("barrier", threading.Barrier(n_nodes))
    if test.get("net") is None and not (test.get("ssh") or {}).get("dummy"):
        raise NotImplementedError(
            "no net given, and the port has no IPTables net for a real "
            "transport (ROADMAP Queue 1 item 11)")
    elif test.get("net") is None:
        from jepsen_tpu_torch.net import NoopNet
        test["net"] = NoopNet()
    return test


def log_test_start(test: dict) -> None:
    """Records run provenance (core.clj:253-272)."""
    import subprocess
    import sys
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"], capture_output=True,
                             text=True, timeout=5).stdout.strip()
    except Exception:  # noqa: BLE001
        sha = "unknown"
    logger.info("Test %s starting; argv=%r git=%s", test.get("name"),
                sys.argv, sha)


@contextlib.contextmanager
def with_os(test: dict):  # owner: scheduler
    """OS setup on all nodes; teardown after (core.clj:93-100)."""
    os_ = test.get("os")
    if os_ is not None:
        control.on_nodes(test, lambda n: os_.setup(test, n))
    try:
        yield
    finally:
        if os_ is not None and not test.get("leave_db_running"):
            try:
                control.on_nodes(test, lambda n: os_.teardown(test, n))
            except Exception:  # noqa: BLE001
                logger.exception("OS teardown failed")


@contextlib.contextmanager
def with_db(test: dict):  # owner: scheduler
    """DB cycle (teardown->setup, retried), teardown after unless
    leave_db_running (core.clj:172-181, db.clj:121-158)."""
    db = test.get("db")
    if db is not None:
        db_mod.cycle(test, db)
    try:
        yield
    finally:
        if db is not None and not test.get("leave_db_running"):
            try:
                # teardown is idempotent by contract (db.clj:121-158);
                # capped-exponential-jitter retries ride out transport
                # flakes a chaotic run leaves behind
                retry_with_backoff(lambda: db_mod.teardown_all(test, db),
                                   tries=3, desc="db teardown")
            except Exception:  # noqa: BLE001
                logger.exception("DB teardown failed")


def snarf_logs(test: dict) -> None:  # owner: scheduler
    """Downloads db log files from each node into the store dir
    (core.clj:102-136)."""
    db = test.get("db")
    if not isinstance(db, db_mod.LogFiles):
        return

    def snarf(node):
        files = db.log_files(test, node)
        if not files:
            return
        dest = store.path_mk(test, node, "x").parent
        dest.mkdir(parents=True, exist_ok=True)
        for f in files:
            try:
                control.on(node, test, lambda: control.download(f, str(dest)))
            except Exception:  # noqa: BLE001
                logger.warning("couldn't download %s from %s", f, node)

    try:
        real_pmap(snarf, list(test.get("nodes") or []))
    except Exception:  # noqa: BLE001
        logger.exception("log snarfing failed")


@contextlib.contextmanager
def with_client_and_nemesis(test: dict):  # owner: scheduler
    """Nemesis setup (concurrently) + one client open+setup per node;
    teardown both after (core.clj:183-212). Rebinds test['client'] /
    test['nemesis'] to the set-up instances."""
    proto_client = test.get("client")
    proto_nemesis = test.get("nemesis")
    setup_clients: list = []
    clients_lock = threading.Lock()

    nemesis_box: list = [None]
    nemesis_err: list = []

    def setup_nemesis():
        try:
            if proto_nemesis is not None:
                nemesis_box[0] = proto_nemesis.setup(test)
        except Exception as e:  # noqa: BLE001
            nemesis_err.append(e)

    nt = threading.Thread(target=setup_nemesis, daemon=True)
    nt.start()
    try:
        if proto_client is not None:
            def open_and_setup(node):
                c = proto_client.open(test, node)
                # record immediately so a failure on another node still
                # tears this one down
                with clients_lock:
                    setup_clients.append(c)
                c.setup(test)
            real_pmap(open_and_setup, list(test.get("nodes") or []))
        join_noisy(nt, "nemesis setup")
        if nemesis_err:
            raise nemesis_err[0]
        if nemesis_box[0] is not None:
            test["nemesis"] = nemesis_box[0]
        yield
    finally:
        # never tear down a nemesis that's still setting up
        join_noisy(nt, "nemesis setup (teardown wait)")
        for c in setup_clients:
            try:
                c.teardown(test)
                c.close(test)
            except Exception:  # noqa: BLE001
                logger.exception("client teardown failed")
        try:
            if nemesis_box[0] is not None:
                # idempotent by contract (heal/reset/restart); retried
                # with capped-exponential full-jitter backoff because
                # this teardown IS the cluster's heal path
                retry_with_backoff(lambda: nemesis_box[0].teardown(test),
                                   tries=4, desc="nemesis teardown")
                faults = test.get("_faults")
                if faults is not None:
                    # teardown restores normal operation (nemesis.clj
                    # contract) — except file damage, which nothing can
                    # undo: those entries stay on the books
                    healed = faults.mark_healed(
                        kinds=faults_mod.TEARDOWN_HEALS, via="teardown")
                    if healed:
                        logger.info("nemesis teardown healed fault(s) %s",
                                    healed)
        except Exception:  # noqa: BLE001
            logger.exception("nemesis teardown failed")
        test["nemesis"] = proto_nemesis


def run_case(test: dict) -> list[dict]:  # owner: scheduler
    """Client+nemesis setup then the interpreter (core.clj:214-219)."""
    with with_client_and_nemesis(test):
        return interpreter.run(test)


@contextlib.contextmanager
def _maybe_profile(test: dict):
    """--profile: a jax.profiler device trace of the checker phase into
    the store dir's profile/ (telemetry.profiler_trace degrades to a
    no-op when the profiler is unavailable)."""
    if not test.get("profile"):
        yield
        return
    with telemetry.profiler_trace(store.path(test, "profile")):
        yield


def _live_final_results(test: dict, checker) -> dict | None:
    """The live daemon's final incremental verdict for this run, when it
    is *fresh* (final state covering exactly this history) and the
    checker is one whose live session computes the same result shape —
    a bare LinearizableChecker (the append workload's AppendChecker
    branch waits with workloads/append.py). Anything else (composed
    checkers, stats/timeline bundles, recovered histories) re-checks
    from scratch; reuse must never lose a sub-result."""
    if not test.get("live_reuse") or test.get("wal_recovered"):
        return None
    try:
        from jepsen_tpu_torch.checker.linearizable import LinearizableChecker
        from jepsen_tpu_torch.live.daemon import load_live_status
        if not isinstance(checker, LinearizableChecker):
            return None
        status = load_live_status(store.test_dir(test))
        if not status or status.get("state") != "final":
            return None
        results = status.get("results")
        if not isinstance(results, dict) or "valid?" not in results:
            return None
        if status.get("ops_absorbed") != len(test.get("history") or []):
            return None  # stale: the history grew/shrank since finalize
        workload = status.get("workload")
        # NOT register-independent: a bare LinearizableChecker on a
        # key-lifted history computes something else entirely (the
        # supported lifted config is IndependentChecker, which fails
        # the isinstance gate above) — reuse must not diverge from
        # what --no-live-reuse would compute
        if workload != "register":
            return None
        logger.info("reusing live daemon's final incremental verdict "
                    "(live-status.json, %d ops); --no-live-reuse "
                    "re-checks from scratch", status.get("ops_absorbed"))
        return {**results, "live-reused": True}
    except Exception:  # noqa: BLE001 — reuse is an optimization, never a risk
        logger.exception("live-verdict reuse probe failed; re-checking")
        return None


def analyze(test: dict) -> dict:
    """Indexes the history, runs the checker, persists results
    (core.clj:221-236), and exports the telemetry snapshot
    (metrics.prom + metrics.json + metrics-summary.txt) into the store
    dir. Standalone re-analysis (cli analyze) gets its own registry so
    checker metrics are captured there too. A run the live daemon
    tracked to completion can skip the re-check entirely:
    ``live_reuse`` (cli analyze's default) adopts the daemon's final
    incremental verdict when it exactly covers this history."""
    logger.info("Analyzing...")
    history = history_mod.index(test.get("history") or [])
    test["history"] = history
    checker = test.get("checker")
    reg = telemetry.get_registry()
    prev = None
    if not reg.enabled and test.get("metrics", True) is not False:
        reg = telemetry.Registry()
        prev = telemetry.install(reg)
    try:
        reused = _live_final_results(test, checker)
        if reused is not None:
            test["results"] = reused
        elif checker is not None:
            with _maybe_profile(test):
                test["results"] = check_safe(checker, test, history, {})
        else:
            test["results"] = {"valid?": True}
        if test.get("wal_recovered"):
            # verdict over a crash-recovered partial history: sound for
            # the ops that were journaled, but the run never finished —
            # badge it so nobody mistakes it for a complete run
            # (cli analyze --recover, doc/robustness.md)
            test["results"]["incomplete"] = True
        if reg.enabled:
            reg.gauge("run_history_ops",
                      "ops in the final history").set(len(history))
            # standalone re-analysis (prev installed here) exports under
            # metrics-analyze.* — the live run's interpreter/control/
            # nemesis measurements are unreproducible and must survive
            # any number of re-checks
            prefix = "metrics" if prev is None else "metrics-analyze"
            try:
                reg.export(store.test_dir(test), prefix=prefix)
                from jepsen_tpu_torch import report
                report.write_metrics_summary(test, reg,
                                             filename=f"{prefix}-summary.txt")
            except Exception:  # noqa: BLE001 — export never masks a verdict
                logger.exception("telemetry export failed")
        store.save_2(test)
    finally:
        if prev is not None:
            telemetry.install(prev)
    logger.info("Analysis complete")
    return test


def log_results(test: dict) -> None:
    """(core.clj:238-251)"""
    results = test.get("results") or {}
    valid = results.get("valid?")
    if valid is True:
        logger.info("Everything looks good! ヽ('ー`)ノ")
    elif valid == "unknown":
        logger.info("Errors occurred during analysis, but no anomalies found. ಠ~ಠ")
    else:
        logger.info("Analysis invalid! (ﾉಥ益ಥ）ﾉ ┻━┻")


def _telemetry_setup(test: dict):
    """Installs a live metrics registry (unless ``metrics: False``) with
    a periodic background flusher into the store dir, the run's causal
    tracer (Perfetto ``trace.json`` sink at ``--trace`` verbosity, the
    always-on flight recorder unless ``flight_recorder_events`` is 0 —
    doc/observability.md "Causal trace"). The client span tracer of a
    ``trace`` run (``tracing.py``) is not ported; a tracer a suite put in
    ``test['tracer']`` is closed by the teardown. Returns a teardown
    closure."""
    from jepsen_tpu_torch import trace as trace_mod
    prev_reg = None
    flusher = None
    if test.get("metrics", True) is not False:
        reg = telemetry.Registry()
        prev_reg = telemetry.install(reg)
        interval = test.get("metrics_interval", 10.0)
        flusher = telemetry.Flusher(reg, store.test_dir(test),
                                    interval_s=interval or 0).start()
    run_tracer = trace_mod.for_test(test)
    prev_tracer = trace_mod.install(run_tracer)
    if run_tracer.flight is not None:
        try:
            run_tracer.arm_crash_dump(
                store.path(test, trace_mod.FLIGHT_NAME))
        except Exception:  # noqa: BLE001 — bare test map, no store coords
            logger.debug("no store dir for crash-dump hook", exc_info=True)
    def teardown():
        tracer = test.get("tracer")
        if tracer is not None:
            try:
                tracer.close()
            except Exception:  # noqa: BLE001
                logger.exception("tracer close failed")
        try:
            run_tracer.close()
        except Exception:  # noqa: BLE001
            logger.exception("run tracer close failed")
        trace_mod.install(prev_tracer)
        if flusher is not None:
            flusher.stop(final_export=True)
        if prev_reg is not None:
            telemetry.install(prev_reg)

    return teardown


def _crash_safety_setup(test: dict):
    """Installs the write-ahead history journal and the durable fault
    registry into the store dir (doc/robustness.md). ``wal: False``
    turns the journal off; ``fault_registry: False`` the registry.
    Either failing to open degrades to the pre-crash-safe behavior
    rather than failing the run.

    Also writes an early ``test.json`` snapshot: ``analyze --recover``
    and ``cli heal`` need the test map (nodes, ssh opts) even when the
    run never reached save_1 — it is rewritten with the final state at
    save time."""
    journal = faults = late = None
    try:
        store.write_test(test)
    except Exception:  # noqa: BLE001
        logger.exception("early test.json write failed")
    # pre-register the ingest spine's fallback counter so run metrics
    # export it even when the native path never falls back (absence must
    # mean "zero fallbacks", not "counter unknown")
    try:
        telemetry.get_registry().counter(
            "native_ingest_fallback_total",
            "ingest work that fell back to the Python path",
            labels=("reason",))
    except Exception:  # noqa: BLE001 — telemetry never blocks a run
        logger.exception("ingest counter registration failed")
    if test.get("wal", True) is not False:
        try:
            journal = journal_mod.Journal(
                store.path_mk(test, journal_mod.WAL_NAME),
                fsync_interval_s=test.get(
                    "wal_fsync_interval",
                    journal_mod.DEFAULT_FSYNC_INTERVAL_S))
            test["_journal"] = journal
        except OSError:
            logger.exception("couldn't open history WAL; journaling off")
    if test.get("fault_registry", True) is not False:
        try:
            faults = faults_mod.FaultRegistry(
                store.path_mk(test, faults_mod.FAULTS_NAME))
            test["_faults"] = faults
        except OSError:
            logger.exception("couldn't open fault registry")
    # the quarantine log for late completions from reaped zombie workers
    # (doc/robustness.md); lazily opened, so clean runs leave no file
    try:
        late = journal_mod.ForensicLog(
            store.path(test, journal_mod.LATE_NAME))
        test["_late"] = late
    except Exception:  # noqa: BLE001
        logger.exception("couldn't set up late-completion log")
    return journal, faults, late


def _preflight_gate(test: dict) -> None:
    """The reference validates the test map here before any node or db
    contact (``analysis/preflight.py``), unless ``preflight: False``. The
    gate is not ported yet (ROADMAP Queue 1 item 11): every run takes
    the reference's ``preflight: False`` branch, which only counts the
    skip."""
    reg = telemetry.get_registry()
    if reg.enabled:
        reg.counter("preflight_skipped_total",
                    "runs that opted out of preflight validation").inc()


def _fatal_flight_dump(test: dict, exc: BaseException) -> None:
    """The fatal-path flight-recorder dump (doc/observability.md
    "Causal trace"): a run dying on an exception leaves its last ~N
    trace events next to the store artifacts."""
    from jepsen_tpu_torch import trace as trace_mod
    try:
        trace_mod.get_tracer().dump_flight(
            store.path(test, trace_mod.FLIGHT_NAME), reason="fatal")
    except Exception:  # noqa: BLE001 — a crash dump must never mask the crash
        logger.exception("fatal-path flight dump failed")


def run(test: dict) -> dict:  # owner: scheduler
    """The whole enchilada (core.clj:326-397)."""
    test = prepare_test(test)
    store.start_logging(test)
    telemetry_teardown = _telemetry_setup(test)
    journal = faults = late = None
    try:
        _preflight_gate(test)
        journal, faults, late = _crash_safety_setup(test)
        with with_thread_name(f"jepsen-{test.get('name')}"):
            log_test_start(test)
            with control.with_test_nodes(test):
                with with_os(test):
                    with with_db(test):
                        with with_relative_time():
                            history = run_case(test)
                        test["history"] = history
                        snarf_logs(test)
                        store.save_1(test)
                        if journal is not None:
                            # history.jsonl is authoritative now; a
                            # surviving WAL marks a crashed run
                            journal.close(discard=True)
            test = analyze(test)
            log_results(test)
            return test
    except BaseException as e:
        _fatal_flight_dump(test, e)
        raise
    finally:
        test.pop("_journal", None)
        if journal is not None:
            journal.close()  # no-op when already discarded
        test.pop("_late", None)
        if late is not None:
            late.close()
        test.pop("_faults", None)
        if faults is not None:
            # crash-path heal replay: a run that died mid-fault (or
            # whose nemesis teardown failed, or whose fault-closing op
            # outlived its deadline) still restores the cluster
            try:
                actionable, evidence = faults_mod.actionable_unhealed(faults)
                if actionable:
                    logger.warning("run left %d unhealed fault(s); "
                                   "replaying heals", len(actionable))
                    summary = faults_mod.replay_unhealed(test, faults)
                    logger.info("crash-path heal replay: %s", summary)
                elif evidence:
                    # file damage: evidence, not a heal target
                    logger.info("%d unhealable fault record(s) (file "
                                "damage) remain on the books",
                                len(evidence))
            except Exception:  # noqa: BLE001
                logger.exception("crash-path fault heal replay failed")
            faults.close()
        telemetry_teardown()
        store.stop_logging()
