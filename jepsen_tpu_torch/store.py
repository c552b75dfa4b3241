"""Where a run's files live: ``store_dir/name/start_time/``.

The four names of jepsen_tpu/store.py that place a run's ``check.ckpt``
(checker/checkpoint.py), so that the port's checkpoint lands where the
reference's does. The rest of the store (history, results, the latest
links) is harness and not ported."""
from __future__ import annotations

from pathlib import Path

# copied from jepsen_tpu/store.py:22
BASE_DIR = "store"


# copied from jepsen_tpu/store.py:91-100
def base_dir(test: dict) -> Path:
    return Path(test.get("store_dir", BASE_DIR))


def test_dir(test: dict) -> Path:
    return base_dir(test) / str(test.get("name", "noop")) / str(test["start_time"])


def path(test: dict, *components) -> Path:
    return test_dir(test).joinpath(*[str(c) for c in components])
