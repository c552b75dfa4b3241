"""jepsen_tpu_torch, chip_smoke.py and combine_sweep.py stand alone: none
of their lines imports ``jax`` or ``jepsen_tpu``, and a CPU check through
the port leaves neither in ``sys.modules``."""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "jepsen_tpu")


def _sources():
    return sorted((ROOT / "jepsen_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "combine_sweep.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name, node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", node.lineno


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [(name, line) for name, line in _imported_roots(path)
           if name.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_sources_exist():
    names = {p.name for p in _sources()}
    assert {"jitlin.py", "matrix_kernels.py", "frontier_kernels.py",
            "linearizable.py", "chip_smoke.py", "scc.py", "scc_kernels.py",
            "txn.py", "columnar.py", "list_append.py",
            "rw_register.py", "independent.py", "pipeline.py",
            "distributed.py", "utils.py", "setscan.py", "views.py", "explain.py",
            "forensics_kernels.py", "checkpoint.py", "store.py",
            "codec.py", "journal.py", "ir.py", "sidecar.py",
            "columnar_c.py", "builder.py", "sessions.py", "telemetry.py",
            "perfetto.py", "flight.py", "ingest.py", "daemon.py",
            "timeline.py", "perf_plots.py", "clock.py", "linear_report.py",
            "faults.py"} <= names
    assert (ROOT / "jepsen_tpu_torch/live/__init__.py") in _sources()
    assert (ROOT / "jepsen_tpu_torch/nemesis/__init__.py") in _sources()
    assert (ROOT / "jepsen_tpu_torch/native/__init__.py") in _sources()
    assert (ROOT / "jepsen_tpu_torch/parallel/__init__.py") in _sources()
    assert (ROOT / "jepsen_tpu_torch/trace/__init__.py") in _sources()
    assert (ROOT / "jepsen_tpu_torch/native/wgl.cpp").exists()
    assert (ROOT / "jepsen_tpu_torch/native/columnar_ext.c").exists()
    assert (ROOT / "jepsen_tpu_torch/elle/__init__.py") in _sources()
    assert sorted(p.name for p in
                  (ROOT / "jepsen_tpu_torch/ops/csrc").glob("*.cu")) == [
        "chunk_combine.cu", "chunk_product.cu", "cluster_screen.cu",
        "frontier_dense.cu", "frontier_sparse.cu", "prefix_alive.cu",
        "scc_trim.cu", "set_classify.cu", "trim_degrees.cu",
        "window_rescan.cu"]


def _leaked_modules(code: str) -> str:
    """Runs ``code`` in a fresh interpreter, which prints the jax and
    jepsen_tpu modules it ended up importing; returns its output."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_cpu_check_loads_neither_jax_nor_reference():
    code = """
import sys
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.histories import register_history
from jepsen_tpu_torch.ops import jitlin
jitlin.MATRIX_MIN_RETURNS = 10
out = linearizable(accelerator="gpu", device="cpu").check(
    {}, register_history(120, n_procs=3, seed=2, n_values=4), {})
assert out["valid?"] is True and out["algorithm"] == "torch-matrix", out
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_elle_cpu_check_loads_neither_jax_nor_reference():
    code = """
import sys
from jepsen_tpu_torch.elle import list_append, rw_register
from jepsen_tpu_torch.histories import elle_history, rw_register_history
out = list_append.check(elle_history(300, crossed_pairs=2),
                        accelerator="gpu", device="cpu")
assert out["anomaly-types"] == ["G1c", "realtime-cycle"], out
out = rw_register.check(rw_register_history(300, crossed_pairs=0),
                        accelerator="gpu", device="cpu")
assert out["valid?"] is True, out
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_independent_cpu_check_loads_neither_jax_nor_reference():
    code = """
import sys
from jepsen_tpu_torch import independent
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.histories import (corrupt_keys,
                                        independent_register_history)
from jepsen_tpu_torch.parallel import batch_check
h = corrupt_keys(independent_register_history(4, 60, n_procs=3), [2])
for acc in ("gpu", "cpu"):
    out = independent.checker(linearizable(accelerator=acc,
                                           device="cpu")).check({}, h, {})
    assert out["failures"] == ["2"], out
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_set_full_cpu_check_loads_neither_jax_nor_reference():
    code = """
import sys
from jepsen_tpu_torch.checker import set_full
from jepsen_tpu_torch.histories import set_full_history
h = set_full_history(300, 20, n_lost=2, n_stale=2, seed=1)
out = set_full(True, "gpu", device="cpu").check({}, h, {})
assert (out["lost-count"], out["stale-count"]) == (2, 2), out
assert out == set_full(True, "cpu").check({}, h, {})
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_checkpointed_cpu_check_loads_neither_jax_nor_reference():
    """A check with store coordinates: the matrix chain writes check.ckpt
    through checker/checkpoint.py and store.py, and the settled check
    removes it."""
    code = """
import sys, tempfile
from pathlib import Path
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.histories import corrupt_reads, register_history
from jepsen_tpu_torch.ops import jitlin
jitlin.MATRIX_MIN_RETURNS = 10
jitlin.MATRIX_SEGMENT_EVENTS = 128
writes = []
from jepsen_tpu_torch.checker import checkpoint
real = checkpoint.CheckpointStore.save
checkpoint.CheckpointStore.save = lambda self, *a, **k: (
    writes.append(1), real(self, *a, **k))[1]
with tempfile.TemporaryDirectory() as d:
    test = {"name": "iso", "start_time": "t0", "store_dir": d,
            "check_ckpt_interval": 1e-9}
    h = corrupt_reads(register_history(300, n_procs=3, seed=2, n_values=4),
                      n=1, seed=1)
    for acc in ("gpu", "cpu"):
        out = linearizable(accelerator=acc, device="cpu").check(test, h, {})
        assert out["valid?"] is False, out
        assert not (Path(d) / "iso" / "t0" / "check.ckpt").exists()
assert writes, "no checkpoint was written"
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_telemetry_cpu_check_loads_neither_jax_nor_reference():
    """A CPU check with a live registry and a run tracer (Perfetto sink
    and flight recorder): an invalid one, which localizes and explains,
    and a segmented one through check.ckpt, resumed. The registry
    exports, the trace loads as strict JSON, and nothing of the JAX
    package is loaded."""
    code = """
import json, sys, tempfile
from pathlib import Path
import torch
torch.set_num_threads(1)  # small ops: one thread beside the other workers
from jepsen_tpu_torch import telemetry, trace
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.histories import corrupt_reads, register_history
from jepsen_tpu_torch.ops import jitlin
from jepsen_tpu_torch.trace.flight import FlightRecorder
from jepsen_tpu_torch.trace.perfetto import PerfettoSink
jitlin.MATRIX_MIN_RETURNS = 10
jitlin.MATRIX_SEGMENT_EVENTS = 128
with tempfile.TemporaryDirectory() as d:
    reg = telemetry.Registry()
    tracer = trace.RunTracer(perfetto=PerfettoSink(Path(d) / "trace.json"),
                             flight=FlightRecorder(64))
    test = {"name": "iso", "start_time": "t0", "store_dir": d,
            "check_ckpt_interval": 1e-9}
    h = register_history(300, n_procs=3, seed=2, n_values=4)
    with telemetry.use(reg), trace.use(tracer):
        bad = linearizable(accelerator="gpu", device="cpu").check(
            {}, corrupt_reads(h, n=1, seed=1), {})
        ok = linearizable(accelerator="gpu", device="cpu").check(test, h, {})
    tracer.close()
    reg.export(d)
    assert bad["valid?"] is False and ok["valid?"] is True
    names = {e["name"] for e in json.loads(
        (Path(d) / "trace.json").read_text())}
    assert {"rung", "explain", "segment", "ckpt-write"} <= names, names
    assert "explain_total" in (Path(d) / "metrics.prom").read_text()
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_stored_recheck_loads_neither_jax_nor_reference():
    """Both lanes of both stored re-checks through the port: the stored
    columns (valid runs) and the jsonl fallback (invalid runs), with the
    C parser writing the elle_* columns."""
    code = """
import sys, tempfile
from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker.linearizable import check_stored as lin_stored
from jepsen_tpu_torch.elle.list_append import check_stored as la_stored
from jepsen_tpu_torch.histories import (corrupt_reads, elle_history,
                                        register_history)
with tempfile.TemporaryDirectory() as d:
    h = register_history(120, n_procs=3, seed=2, n_values=4)
    cases = [("lin-ok", h, lin_stored, True),
             ("lin-bad", corrupt_reads(h, n=1, seed=1), lin_stored, False),
             ("la-ok", elle_history(200), la_stored, True),
             ("la-bad", elle_history(200, crossed_pairs=2), la_stored,
              False)]
    for name, hh, fn, valid in cases:
        test = {"name": name, "start_time": "t0", "store_dir": d,
                "history": hh}
        store.write_history(test)
        store.write_columnar(test)
        for acc in ("gpu", "cpu"):
            out = fn(name, "t0", d, accelerator=acc, device="cpu")
            assert out["valid?"] is valid, out
            stored = (out.get("builder") == "columnar-store"
                      or out.get("algorithm", "").endswith("(stored)"))
            assert stored is valid, out
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_live_sessions_load_neither_jax_nor_reference():
    """A WAL tailed into the live register session, whose screen runs
    the plain kernels on the CPU, and the batch check of the same ops
    through the run's shared IR."""
    code = """
import json, sys, tempfile
from pathlib import Path
import torch
torch.set_num_threads(1)  # small ops: one thread beside the other workers
from jepsen_tpu_torch import history_ir
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.histories import corrupt_reads, register_history
from jepsen_tpu_torch.journal import WalTailer
from jepsen_tpu_torch.live import session_for_ops
from jepsen_tpu_torch.ops import jitlin
jitlin.MATRIX_MIN_RETURNS = 10
h = corrupt_reads(register_history(300, n_procs=3, seed=2, n_values=4),
                  n=1, seed=1)
with tempfile.TemporaryDirectory() as d:
    wal = Path(d) / "history.wal.jsonl"
    wal.write_text("".join(json.dumps(op) + "\\n" for op in h))
    ops = WalTailer(wal).poll()
    sess = session_for_ops(ops, accelerator="gpu", device="cpu")
    sess.add_many(ops)
    v = sess.verdict()
    assert v["backend"] == "torch-matrix" and v["valid_so_far"] is False, v
    test = {}
    out = linearizable(accelerator="gpu", device="cpu").check(
        test, ops, {"explain": False})
    assert out["valid?"] is False, out
    assert history_ir.of(test, ops) is test["_history_ir"]
    assert test["_history_ir"].ops is ops
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_live_daemon_loads_neither_jax_nor_reference():
    """A run's WAL tailed by the live daemon through the C ingest spine
    to its final verdict."""
    code = """
import json, sys, tempfile
from pathlib import Path
import torch
torch.set_num_threads(1)
from jepsen_tpu_torch.histories import corrupt_reads, register_history
from jepsen_tpu_torch.live import LiveDaemon, load_live_status
h = corrupt_reads(register_history(200, n_procs=3, seed=2, n_values=4),
                  n=1, seed=1)
with tempfile.TemporaryDirectory() as d:
    run = Path(d) / "reg" / "20260803T000000.000"
    run.mkdir(parents=True)
    lines = "".join(json.dumps(op) + "\\n" for op in h)
    (run / "history.wal.jsonl").write_text(lines)
    daemon = LiveDaemon(store_root=d, accelerator="cpu", device="cpu")
    daemon.poll_once()
    (run / "history.jsonl").write_text(lines)
    daemon.run_until_idle(timeout_s=60)
    status = load_live_status(run)
    assert status["state"] == "final", status
    assert status["results"]["valid?"] is False, status
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out


def test_composed_suite_check_loads_neither_jax_nor_reference():
    """A suite's composed check on the CPU (stats, exceptions, the lifted
    register workload with its timeline, perf, clock) over a run with a
    nemesis and a fault registry: the reports and the artifacts land in
    the store dir, and nothing of the JAX package is loaded."""
    code = """
import json, sys, tempfile
from pathlib import Path
import torch
torch.set_num_threads(1)
from jepsen_tpu_torch import checker as c, independent
from jepsen_tpu_torch.checker.linearizable import linearizable
from jepsen_tpu_torch.histories import (
    corrupt_keys, independent_register_history, stamp_times, with_nemesis)
h = corrupt_keys(independent_register_history(3, 40, n_procs=3), [1])
h, rows = with_nemesis(stamp_times(h), [(10, 90, "partition", "heal")],
                       offsets_at=(5,))
suite = c.compose({
    "stats": c.stats(), "exceptions": c.unhandled_exceptions(),
    "workload": independent.checker(c.compose({
        "linear": linearizable(accelerator="gpu", device="cpu"),
        "timeline": c.timeline_html()})),
    "perf": c.perf(), "clock": c.clock_plot()})
with tempfile.TemporaryDirectory() as d:
    run = Path(d) / "suite" / "t0"
    run.mkdir(parents=True)
    (run / "faults.jsonl").write_text(
        "".join(json.dumps(r) + "\\n" for r in rows))
    out = suite.check({"name": "suite", "start_time": "t0",
                       "store_dir": d}, h, {})
    assert out["workload"]["failures"] == ["1"], out
    names = {p.name for p in run.rglob("*")}
    assert {"anomaly.json", "witness-timeline.html", "timeline.html",
            "rate.png", "clock-skew.png"} <= names, names
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "jepsen_tpu"))
print("LEAKED", leaked)
"""
    out = _leaked_modules(code)
    assert "LEAKED []" in out, out
