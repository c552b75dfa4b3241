"""The sanitizer lane of the port's native code: the ASan+UBSan builds of
``columnar_ext.c`` (the ingest spine) and ``wgl.cpp`` (the search).

Slow lane (``-m native_san``). The ingest spine's and the search's
differential cases run in a CHILD process with the ASan runtime
LD_PRELOADed (``native.san_env()``) that calls ``native.configure(
san=True)`` and ``columnar_c.configure(san=True)`` before its tests: the
port reads no environment variable for the variant. This process, which
has no ASan runtime mapped, must refuse to load either sanitizer build.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytestmark = [pytest.mark.native_san, pytest.mark.slow]

_REPO = Path(__file__).resolve().parent.parent

# the child: both variants configured, pytest over the given files, then
# the files the loaded libraries came from
_CHILD = """
import sys
from jepsen_tpu_torch import native
from jepsen_tpu_torch.native import columnar_c
native.configure(san=True)
columnar_c.configure(san=True)
import pytest
rc = pytest.main(sys.argv[1:])
print("LOADED", native.lib()._name, columnar_c.mod().__file__)
sys.exit(rc)
"""


@pytest.fixture(scope="module")
def san_lane():
    """A sanitizer-capable child's environment, or skip/exit."""
    from jepsen_tpu_torch import native
    from jepsen_tpu_torch.native import columnar_c
    if shutil.which("g++") is None:
        pytest.skip("no g++: sanitizer lane unavailable")
    env = native.san_env()
    if env is None:
        pytest.skip("no libasan/libubsan runtime next to g++")
    try:
        native.build(san=True)
        columnar_c.build(san=True)
    except Exception as e:  # noqa: BLE001
        pytest.exit("sanitizer toolchain present but an ASan+UBSan build "
                    f"failed: {e!r}; the san lane must not silently skip",
                    returncode=3)
    env["PYTHONPATH"] = str(_REPO)
    env["JAX_PLATFORMS"] = "cpu"
    return env


def _run_child(env, *args, timeout=900):
    return subprocess.run(
        [sys.executable, "-c", _CHILD, "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-m", "not cuda", *args],
        env=env, cwd=str(_REPO), capture_output=True, text=True,
        timeout=timeout)


def _assert_clean(proc):
    blob = proc.stdout + proc.stderr
    assert proc.returncode == 0, blob[-6000:]
    assert "ERROR: AddressSanitizer" not in blob, blob[-4000:]
    assert "runtime error:" not in blob, blob[-4000:]  # UBSan
    loaded = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("LOADED ")]
    assert loaded, proc.stdout[-2000:]
    assert "libwgl-san-" in loaded[-1] \
        and "_columnar_c_torch-san-" in loaded[-1], loaded


def test_san_builds_are_distinct_artifacts():
    from jepsen_tpu_torch import native
    from jepsen_tpu_torch.native import columnar_c
    assert native._so_path(san=True) != native._so_path(san=False)
    assert "libwgl-san-" in native._so_path(san=True).name
    assert columnar_c._so_path(san=True) != columnar_c._so_path(san=False)
    assert "_columnar_c_torch-san-" in columnar_c._so_path(san=True).name


def test_ingest_spine_differentials_under_asan(san_lane):
    """The ingest spine's differential cases (the C WAL scan, the live
    register encode and the frontier absorb against the reference and
    the Python twins) with the instrumented module doing the work."""
    _assert_clean(_run_child(san_lane, "tests/test_torch_ingest.py",
                             "tests/test_torch_columnar_c.py"))


def test_search_differentials_under_asan(san_lane):
    """The native search's differential cases against the reference and
    the Python twin, on the instrumented ``wgl.cpp``."""
    _assert_clean(_run_child(san_lane, "tests/test_torch_native.py"))


def test_san_variant_refuses_to_load_without_the_runtime(monkeypatch):
    """This process has no ASan runtime mapped: both sanitizer variants
    refuse to load (never the plain build in their place)."""
    from jepsen_tpu_torch import native
    from jepsen_tpu_torch.native import columnar_c
    assert not native.asan_mapped()
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SAN", True)
    with pytest.raises(RuntimeError, match="not preloaded"):
        native.lib()
    monkeypatch.setattr(columnar_c, "_MOD", None)
    monkeypatch.setattr(columnar_c, "_SAN", True)
    with pytest.raises(RuntimeError, match="not preloaded"):
        columnar_c.mod()
