"""jepsen_tpu_torch's set-full check (BASELINE config 4) against
jepsen_tpu's on the CPU: the classify's plain version against the JAX
package's device program (jepsen_tpu.ops.setscan, a plain ``jax.jit``),
the membership columns, and whole result maps against both of the JAX
package's paths, at zero tolerance unless stated. Also the float32 time
fault of the JAX device path, which the port does not copy, and
(``cuda``-marked, on the card) the set-classify kernel against its plain
version."""
from __future__ import annotations

import random

import numpy as np
import pytest
import torch

from jepsen_tpu_torch.histories import set_full_history

KEYS = ("valid?", "attempt-count", "stable-count", "lost-count", "lost",
        "never-read-count", "never-read", "stale-count", "stale",
        "stable-latencies")


# copied from tests/test_setscan.py:9-52
def gen_set_history(rng: random.Random, n_adds=60, n_reads=8,
                    lose=0, stale=0, crash=0):
    """A set history with optional injected loss (acked adds that never
    appear) and staleness (elements that vanish from one mid read)."""
    t = [0]

    def tick():
        t[0] += 1
        return t[0]

    history = []
    acked, lost_els, stale_els, crashed = [], [], [], []
    for v in range(n_adds):
        history.append({"type": "invoke", "process": v % 5, "f": "add",
                        "value": v, "time": tick()})
        r = rng.random()
        if crash and len(crashed) < crash and r < 0.15:
            history.append({"type": "info", "process": v % 5, "f": "add",
                            "value": v, "time": tick()})
            crashed.append(v)
        else:
            history.append({"type": "ok", "process": v % 5, "f": "add",
                            "value": v, "time": tick()})
            if lose and len(lost_els) < lose and r > 0.8:
                lost_els.append(v)
            else:
                acked.append(v)
                if stale and len(stale_els) < stale and 0.4 < r < 0.6:
                    stale_els.append(v)

    visible = set(acked) | set(x for x in crashed if rng.random() < 0.5)
    for i in range(n_reads):
        t0 = tick()
        vs = set(visible)
        if 0 < i < n_reads - 1:
            # a mid-run read that misses the stale elements
            vs -= set(stale_els)
        history.append({"type": "invoke", "process": 7, "f": "read",
                        "value": None, "time": t0})
        history.append({"type": "ok", "process": 7, "f": "read",
                        "value": sorted(vs), "time": tick()})
    return history, lost_els, stale_els


def _ops(*rows):
    """Ops from (type, process, f, value, time) rows."""
    return [{"type": ty, "process": p, "f": f, "value": v, "time": t}
            for ty, p, f, v, t in rows]


def _adds(values, t=0):
    return _ops(*[r for i, v in enumerate(values)
                  for r in (("invoke", 0, "add", v, t + 2 * i),
                            ("ok", 0, "add", v, t + 2 * i + 1))])


SPECIAL = {
    # strings: the per-op walk, not the all-int columnar path
    "strings": lambda: _adds(["a", "b", "c", "d"]) + _ops(
        ("invoke", 1, "read", None, 20), ("ok", 1, "read", ["a", "c"], 21),
        ("invoke", 1, "read", None, 22),
        ("ok", 1, "read", ["a", "b", "c"], 23)),
    # a read carrying 2.5 must not count as holding element 2
    # (tests/test_setscan.py:95-115)
    "float_in_read": lambda: _adds(range(4)) + _ops(
        ("invoke", 1, "read", None, 100),
        ("ok", 1, "read", [0, 1, 2.5, 3], 101)),
    # an add-ok with no invoke takes its own time as the invoke's
    "ok_without_invoke": lambda: _adds([0, 1]) + _ops(
        ("ok", 3, "add", 7, 9), ("invoke", 1, "read", None, 10),
        ("ok", 1, "read", [0, 1, 7], 11), ("invoke", 1, "read", None, 12),
        ("ok", 1, "read", [1, 7], 13)),
    # reads that mention elements never added: ignored by both paths
    "unknown_elements": lambda: _adds([3, 5, 8]) + _ops(
        ("invoke", 1, "read", None, 10), ("ok", 1, "read", [3, 4, 5], 11),
        ("invoke", 2, "read", None, 12),
        ("ok", 2, "read", [3, 5, 8, 99], 13)),
    # an add that crashed and is never read, an add never acknowledged
    # but seen, and a read that began before an add was acknowledged
    "never_read_and_unacked": lambda: _ops(
        ("invoke", 0, "add", 1, 0), ("invoke", 1, "add", 2, 1),
        ("invoke", 2, "read", None, 2), ("ok", 0, "add", 1, 3),
        ("ok", 2, "read", [], 4), ("info", 1, "add", 2, 5),
        ("invoke", 3, "add", 3, 6), ("invoke", 2, "read", None, 7),
        ("ok", 2, "read", [1, 3], 8), ("info", 3, "add", 3, 9)),
    # no time field: op indices stand in for times on both paths
    "no_times": lambda: [{k: v for k, v in op.items() if k != "time"}
                         for op in gen_set_history(random.Random(3), 20, 4,
                                                   lose=1, stale=1)[0]],
    "config4_small": lambda: set_full_history(600, 25, n_lost=3, n_stale=4,
                                              seed=1),
}


def _random_cases():
    rng = random.Random(5)
    out = {}
    for trial in range(12):
        h, _, _ = gen_set_history(rng, n_adds=50, n_reads=6,
                                  lose=trial % 3, stale=trial % 2,
                                  crash=trial % 4)
        out[f"random_{trial}"] = h
    return out


RANDOM = _random_cases()


def _history(case):
    return RANDOM[case] if case in RANDOM else SPECIAL[case]()


ALL_CASES = sorted(RANDOM) + sorted(SPECIAL)


# ---------------------------------------------------------------------------
# the classify: plain version against the JAX device program
# ---------------------------------------------------------------------------

def _classify_inputs(R, E, seed):
    """Seeded membership and times: integer times below 2^24 (exact in
    float32), ties among them, about a third of the elements without an
    add-ok, and some elements no read holds."""
    rng = np.random.default_rng(seed)
    member = rng.random((R, E)) < rng.uniform(0.2, 0.9)
    member[:, rng.random(E) < 0.1] = False
    t_read = rng.integers(0, 1 << 12, R).astype(np.float64)
    invoke_t = rng.integers(0, 1 << 12, E).astype(np.float64)
    ok_t = invoke_t + rng.integers(0, 64, E)
    has_ok = rng.random(E) < 0.7
    return member, t_read, invoke_t, ok_t, has_ok


CLASSIFY_SHAPES = [(1, 1, 0), (1, 33, 1), (7, 33, 2), (5, 13, 3),
                   (40, 257, 4), (64, 1000, 5), (3, 7, 6), (200, 96, 7),
                   (17, 1025, 8)]


@pytest.mark.parametrize("R,E,seed", CLASSIFY_SHAPES)
def test_classify_plain_matches_jax(R, E, seed):
    from jepsen_tpu.ops import setscan as ref
    from jepsen_tpu_torch.ops import setscan

    member, t_read, invoke_t, ok_t, has_ok = _classify_inputs(R, E, seed)
    want = ref.classify_elements(member, t_read.astype(np.float32),
                                 invoke_t.astype(np.float32),
                                 ok_t.astype(np.float32), has_ok)
    words = torch.from_numpy(setscan.pack_member(member))
    cols = [torch.from_numpy(x) for x in (t_read, invoke_t, ok_t)]
    got = setscan.classify_plain(words, *cols, torch.from_numpy(has_ok), E)
    code, stale, latency = (x.numpy() for x in got)
    assert np.array_equal(code, want[0])
    assert np.array_equal(stale, want[1])
    stable = code == setscan.STABLE
    assert np.array_equal(latency[stable], want[2][stable].astype(np.float64))
    assert code.shape == (E,) and latency.dtype == np.float64
    # the public entries give the same: the tensor wrapper on the CPU,
    # and the host entry with device="cpu"
    for x, y in zip(setscan.set_classify(words, *cols,
                                         torch.from_numpy(has_ok), E), got):
        assert torch.equal(x, y)
    for x, y in zip(setscan.classify_elements(member, t_read, invoke_t,
                                              ok_t, has_ok, device="cpu"),
                    (code, stale, latency)):
        assert np.array_equal(x, y)


def test_classify_cases_cover_every_code():
    from jepsen_tpu_torch.ops import setscan
    codes, stale = set(), False
    for R, E, seed in CLASSIFY_SHAPES:
        c, s, _ = setscan.classify_elements(*_classify_inputs(R, E, seed),
                                            device="cpu")
        codes |= set(c.tolist())
        stale |= bool(s.any())
    assert codes == {setscan.STABLE, setscan.LOST, setscan.NEVER_READ}
    assert stale


@pytest.mark.parametrize("R,E,seed", [(7, 33, 2), (40, 257, 4),
                                      (64, 1000, 5)])
def test_classify_plain_chunks_agree(R, E, seed):
    """The plain version's column chunks (one word at a time) give what
    one pass over the whole matrix gives."""
    from jepsen_tpu_torch.ops import setscan
    member, *cols, has_ok = _classify_inputs(R, E, seed)
    args = (torch.from_numpy(setscan.pack_member(member)),
            *(torch.from_numpy(c) for c in cols), torch.from_numpy(has_ok),
            E)
    for x, y in zip(setscan.classify_plain(*args, max_cells=32 * R),
                    setscan.classify_plain(*args)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("E", [1, 7, 8, 31, 32, 33, 64, 100])
def test_pack_member_bit_layout(E):
    """Bit j of word w is element 32 w + j; padding bits are 0."""
    from jepsen_tpu_torch.ops import setscan
    rng = np.random.default_rng(E)
    member = rng.random((3, E)) < 0.5
    words = setscan.pack_member(member)
    assert words.dtype == np.int32 and words.shape == (3, -(-E // 32))
    u = words.view(np.uint32).astype(np.int64)
    bits = (u[:, :, None] >> np.arange(32)) & 1
    flat = bits.reshape(3, -1).astype(bool)
    assert np.array_equal(flat[:, :E], member)
    assert not flat[:, E:].any()


def test_set_classify_rejects_bad_shapes():
    from jepsen_tpu_torch.ops import setscan
    w = torch.zeros((2, 1), dtype=torch.int32)
    t = torch.zeros(2, dtype=torch.float64)
    e = torch.zeros(33, dtype=torch.float64)
    hok = torch.zeros(33, dtype=torch.bool)
    with pytest.raises(ValueError):
        setscan.set_classify(w, t, e, e, hok, 33)   # one word for 33
    with pytest.raises(ValueError):
        setscan.set_classify(w[:0], t[:0], e[:1], e[:1], hok[:1], 1)


# ---------------------------------------------------------------------------
# the membership columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ALL_CASES)
def test_set_full_columns_match_jax(case):
    from jepsen_tpu.history_ir.views import set_full_columns as ref_cols
    from jepsen_tpu_torch.history_ir.views import set_full_columns

    h = _history(case)
    want, got = ref_cols(h), set_full_columns(h)
    assert set(got) == set(want)
    assert np.array_equal(got["member"], want["member"])
    assert got["els"] == want["els"]
    assert np.array_equal(got["has_ok"], want["has_ok"])
    for k in ("read_t", "invoke_t", "ok_t"):
        assert got[k].dtype == np.float64
        assert np.array_equal(got[k].astype(np.float32), want[k]), k


def test_set_full_columns_never_read():
    from jepsen_tpu_torch.history_ir.views import set_full_columns
    assert set_full_columns(_adds([1, 2])) == {"error": "Set was never read"}


# ---------------------------------------------------------------------------
# whole result maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("linearizable", [False, True])
@pytest.mark.parametrize("case", ALL_CASES)
def test_set_full_matches_jax(case, linearizable):
    """The port's device path (on the CPU) against both of the JAX
    package's paths: every key equal to its ``"cpu"`` walk, and to its
    device path with ``stable-latencies`` within 1e-3 (float32); the
    port's own ``"cpu"`` walk equal to the JAX package's."""
    from jepsen_tpu.checker import SetFullChecker as Ref
    from jepsen_tpu_torch.checker import SetFullChecker

    h = _history(case)
    cpu = Ref(linearizable=linearizable, accelerator="cpu").check({}, h, {})
    dev = Ref(linearizable=linearizable, accelerator="auto").check({}, h, {})
    got = SetFullChecker(linearizable=linearizable, accelerator="gpu",
                         device="cpu").check({}, h, {})
    walk = SetFullChecker(linearizable=linearizable,
                          accelerator="cpu").check({}, h, {})
    assert "device-fallback" not in dev
    assert got == cpu
    assert walk == cpu
    assert set(got) == set(KEYS)
    for k in KEYS[:-1]:
        assert got[k] == dev[k], k
    lat, dlat = got["stable-latencies"], dev["stable-latencies"]
    assert set(lat) == set(dlat)
    for q in lat:
        assert abs(lat[q] - dlat[q]) < 1e-3


def test_set_full_random_cases_find_faults():
    """The random histories plant loss and staleness the checks find."""
    from jepsen_tpu_torch.checker import SetFullChecker
    seen = {"lost": 0, "stale": 0, "never-read": 0}
    for case in RANDOM:
        r = SetFullChecker(linearizable=True, accelerator="gpu",
                           device="cpu").check({}, RANDOM[case], {})
        for k in seen:
            seen[k] += r[f"{k}-count"]
    assert all(seen.values()), seen


def test_set_full_never_read_is_unknown():
    from jepsen_tpu.checker import SetFullChecker as Ref
    from jepsen_tpu_torch.checker import SetFullChecker
    h = _adds([1])
    want = Ref(accelerator="auto").check({}, h, {})
    for acc in ("gpu", "cpu"):
        got = SetFullChecker(accelerator=acc, device="cpu").check({}, h, {})
        assert got == want == {"valid?": "unknown",
                               "error": "Set was never read"}


def test_set_full_planted_faults_counted():
    """config 4's shape with planted loss and staleness: every lost and
    stale element found, on both paths."""
    from jepsen_tpu_torch.checker import set_full
    h = set_full_history(1000, 50, n_lost=5, n_stale=6, seed=2)
    for lin, valid in ((False, False), (True, False)):
        got = set_full(lin, "gpu", device="cpu").check({}, h, {})
        assert got == set_full(lin, "cpu").check({}, h, {})
        assert (got["valid?"], got["lost-count"], got["stale-count"]) == (
            valid, 5, 6)
    h = set_full_history(1000, 50, n_stale=6, seed=2)
    got = set_full(False, "gpu", device="cpu").check({}, h, {})
    assert (got["valid?"], got["stale-count"]) == (True, 6)
    assert set_full(True, "gpu", device="cpu").check(
        {}, h, {})["valid?"] is False


# ---------------------------------------------------------------------------
# the float32 fault of the JAX device path
# ---------------------------------------------------------------------------

B = 100_000_000_000


def _float32_history():
    """An add invoked at B - 10 ns, a read invoked at B (before the add's
    ok at B + 1) that sees nothing, and a read at 2B that sees it."""
    return _ops(("invoke", 0, "add", 0, B - 10),
                ("invoke", 1, "read", None, B),
                ("ok", 0, "add", 0, B + 1), ("ok", 1, "read", [], B + 2),
                ("invoke", 1, "read", None, 2 * B),
                ("ok", 1, "read", [0], 2 * B + 1))


@pytest.mark.parametrize("linearizable", [False, True])
def test_nanosecond_times_stay_exact(linearizable):
    """The port keeps set-full times in float64 and equals the JAX
    package's ``"cpu"`` walk: valid, nothing stale, every latency 11.

    The JAX package's device path (jepsen_tpu/ops/setscan.py:72,
    history_ir/views.py:449-451) carries the times in float32, which
    rounds B and B + 1 together: it counts the read at B as later than
    the ok, calls the element stale, gives latencies of 0.0, and with
    ``linearizable`` returns invalid. That fault is the reference's."""
    from jepsen_tpu.checker import SetFullChecker as Ref
    from jepsen_tpu_torch.checker import SetFullChecker

    h = _float32_history()
    cpu = Ref(linearizable=linearizable, accelerator="cpu").check({}, h, {})
    got = SetFullChecker(linearizable=linearizable, accelerator="gpu",
                         device="cpu").check({}, h, {})
    assert got == cpu
    assert (got["valid?"], got["stale-count"]) == (True, 0)
    assert got["stable-latencies"] == {0.0: 11, 0.5: 11, 0.99: 11, 1.0: 11}
    dev = Ref(linearizable=linearizable, accelerator="tpu").check({}, h, {})
    assert (dev["valid?"], dev["stale-count"]) == (not linearizable, 1)
    assert dev["stable-latencies"] == {0.0: 0.0, 0.5: 0.0, 0.99: 0.0,
                                       1.0: 0.0}


def test_shifted_config4_history_equals_walk():
    """config 4's shape with its times moved past 10^11 ns, one tick
    apart: the port's device path equals its walk and the unshifted
    check."""
    from jepsen_tpu_torch.checker import set_full
    kw = dict(n_els=600, read_every=25, n_lost=2, n_stale=3, seed=5)
    h = set_full_history(**kw, t0=10 ** 11)
    got = set_full(True, "gpu", device="cpu").check({}, h, {})
    assert got == set_full(True, "cpu").check({}, h, {})
    assert got == set_full(True, "gpu", device="cpu").check(
        {}, set_full_history(**kw), {})
    assert (got["lost-count"], got["stale-count"]) == (2, 3)


# ---------------------------------------------------------------------------
# the checker's surface
# ---------------------------------------------------------------------------

def test_set_full_defaults_and_accelerators():
    from jepsen_tpu_torch.checker import SetFullChecker, set_full
    assert SetFullChecker().accelerator == "auto"
    assert set_full().accelerator == "auto"
    with pytest.raises(ValueError):
        SetFullChecker(accelerator="tpu")
    with pytest.raises(ValueError):
        set_full(device="cpu").check({}, _float32_history(),
                                     {"accelerator": "tpu"})
    got = set_full(device="cpu").check({}, _float32_history(),
                                       {"accelerator": "cpu"})
    assert got["stable-latencies"][0.5] == 11


def test_set_full_device_failure_raises(monkeypatch):
    """A failure on the device path raises: no fallback to the walk."""
    from jepsen_tpu_torch.checker import SetFullChecker
    from jepsen_tpu_torch.ops import setscan

    def boom(*a, **k):
        raise RuntimeError("device path failed")
    monkeypatch.setattr(setscan, "classify_elements", boom)
    for acc in ("gpu", "auto"):
        with pytest.raises(RuntimeError, match="device path failed"):
            SetFullChecker(accelerator=acc, device="cpu").check(
                {}, _float32_history(), {})


@pytest.mark.parametrize("seed", range(6))
def test_set_checker_matches_jax(seed):
    from jepsen_tpu.checker import SetChecker as Ref
    from jepsen_tpu_torch.checker import SetChecker, set_checker

    rng = random.Random(seed)
    h, _, _ = gen_set_history(rng, n_adds=40, n_reads=3, lose=seed % 3,
                              crash=seed % 4)
    if seed % 2:
        # a final read that holds an element never attempted
        h[-1] = dict(h[-1], value=h[-1]["value"] + [999])
    assert SetChecker().check({}, h, {}) == Ref().check({}, h, {})
    assert set_checker().check({}, h, {}) == Ref().check({}, h, {})
    no_read = [op for op in h if op["f"] != "read"]
    assert SetChecker().check({}, no_read, {}) == Ref().check({}, no_read,
                                                                {})


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    """The CUDA device; skips where there is none (decided here, never
    at import, so every test worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("R,E,seed", CLASSIFY_SHAPES + [(400, 20000, 9)])
def test_classify_kernel_matches_plain_on_card(cuda_device, R, E, seed):
    """The kernel against its plain version on the card: code and stale
    bit for bit, latency exactly, one launch; and the host entry's one
    upload and read-back gives the same."""
    from jepsen_tpu_torch.ops import setscan
    member, t_read, invoke_t, ok_t, has_ok = _classify_inputs(R, E, seed)
    args = (torch.from_numpy(setscan.pack_member(member)).to(cuda_device),
            *(torch.from_numpy(c).to(cuda_device)
              for c in (t_read, invoke_t, ok_t)),
            torch.from_numpy(has_ok).to(cuda_device), E)
    n = setscan.set_classify.launches
    got = setscan.set_classify(*args)
    assert setscan.set_classify.launches == n + 1
    want = setscan.classify_plain(*args)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    host = setscan.classify_elements(member, t_read, invoke_t, ok_t, has_ok)
    for x, y in zip(host, want):
        assert np.array_equal(x, y.cpu().numpy())


@pytest.mark.cuda
def test_set_full_on_card_matches_walk(cuda_device):
    """The device path on the card: one launch a check, each map equal to
    the walk's, the float32 history included."""
    from jepsen_tpu_torch.checker import set_full
    from jepsen_tpu_torch.ops import setscan
    for h in (set_full_history(2000, 50, n_lost=4, n_stale=4, seed=3),
              set_full_history(2000, 50, n_lost=4, n_stale=4, seed=3,
                               t0=10 ** 11),
              _float32_history(), *RANDOM.values()):
        n = setscan.set_classify.launches
        got = set_full(True, "gpu").check({}, h, {})
        assert setscan.set_classify.launches == n + 1
        assert got == set_full(True, "cpu").check({}, h, {})


@pytest.mark.cuda
def test_set_full_kernel_failure_raises_on_card(cuda_device, monkeypatch):
    """A launch that fails raises through the checker: no fallback."""
    from jepsen_tpu_torch.checker import set_full
    from jepsen_tpu_torch.ops import _build

    class Failing:
        @staticmethod
        def jt_set_classify(*args):
            return 1
    monkeypatch.setattr(_build, "library", lambda name: Failing)
    with pytest.raises(RuntimeError, match="set_classify"):
        set_full(accelerator="gpu").check({}, _float32_history(), {})
