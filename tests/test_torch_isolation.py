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
            "rw_register.py", "independent.py", "parallel.py",
            "utils.py", "setscan.py", "views.py", "explain.py",
            "forensics_kernels.py", "checkpoint.py", "store.py"} <= names
    assert (ROOT / "jepsen_tpu_torch/native/__init__.py") in _sources()
    assert (ROOT / "jepsen_tpu_torch/native/wgl.cpp").exists()
    assert (ROOT / "jepsen_tpu_torch/elle/__init__.py") in _sources()
    assert sorted(p.name for p in
                  (ROOT / "jepsen_tpu_torch/ops/csrc").glob("*.cu")) == [
        "chunk_combine.cu", "chunk_product.cu", "cluster_screen.cu",
        "frontier_dense.cu", "frontier_sparse.cu", "prefix_alive.cu",
        "scc_trim.cu", "set_classify.cu", "window_rescan.cu"]


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
