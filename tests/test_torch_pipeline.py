"""jepsen_tpu_torch.parallel.pipeline against jepsen_tpu.parallel.pipeline
on the CPU, at zero tolerance: the cost model's routes, mesh gate (its
probe counter included) and admission budget over a grid of events,
round trips and rates; the EWMA of the observed rates; the dispatch
pipeline's submission order, delayed blocking and stats keys (with fakes
and with CPU tensors); and the lane ``batch_check(accelerator="auto")``
takes under the same fixed model (the reference's round trip through
``JEPSEN_TPU_RTT_S``, the port's through its module default model). Every
test starts both packages from empty rate tables and a zero probe
count."""
from __future__ import annotations

import itertools

import pytest
import torch

from jepsen_tpu_torch.histories import corrupt_reads, register_history


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The suite runs on every core at once: one torch thread a test keeps
    these small products from crowding the other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def both(monkeypatch):
    """(the reference's pipeline module, the port's), their rate tables
    and probe counters reset."""
    from jepsen_tpu.parallel import pipeline as ref
    from jepsen_tpu_torch.parallel import pipeline
    for mod in (ref, pipeline):
        monkeypatch.setattr(mod, "_CPU_RATE", {})
        monkeypatch.setattr(mod, "_DEVICE_RATE", {})
        monkeypatch.setattr(mod, "_MESH_PROBE_COUNT", 0)
    return ref, pipeline


EVENTS = (1, 999, 20_000, 20_001, 1 << 14, 1 << 16, 10 ** 7)
RTTS = (0.0, 1e-4, 0.1)
RATES = (1.0, 100_000.0, 3.7e6)


def test_route_and_budget_match_reference(both):
    ref, pipeline = both
    for rtt, rate in itertools.product(RTTS, RATES):
        r = ref.CostModel(roundtrip_s=rtt, cpu_events_per_sec_=rate)
        m = pipeline.CostModel(roundtrip_s=rtt, cpu_events_per_sec_=rate)
        for ev in EVENTS:
            assert m.route(ev) == r.route(ev), (rtt, rate, ev)
            assert m.cpu_seconds(ev) == r.cpu_seconds(ev)
        assert m.device_floor_seconds() == r.device_floor_seconds()
        for s in (-1.0, 0.0, 0.25, 3.0):
            assert m.admission_budget_ops(s) == r.admission_budget_ops(s)


@pytest.mark.parametrize("rates", ["none", "single", "both"])
def test_mesh_route_and_probe_counter_match_reference(both, rates):
    """The gate over widths 1, 2 and 8 and the events grid, called in the
    same order in both packages: with no rates (the MESH_MIN_EVENTS gate
    and every 16th eligible batch a probe), a single-device rate only,
    and rates at both widths (the predicted times)."""
    ref, pipeline = both
    if rates != "none":
        for mod in (ref, pipeline):
            mod.observe_device_rate(1, 1 << 20, 2.0)
            if rates == "both":
                mod.observe_device_rate(8, 1 << 20, 0.5)
    r = ref.CostModel(roundtrip_s=0.01, cpu_events_per_sec_=1e5)
    m = pipeline.CostModel(roundtrip_s=0.01, cpu_events_per_sec_=1e5)
    got, want = [], []
    for _ in range(6):
        for n, ev in itertools.product((1, 2, 8), EVENTS):
            got.append(m.mesh_route(ev, n))
            want.append(r.mesh_route(ev, n))
    assert got == want
    assert pipeline._MESH_PROBE_COUNT == ref._MESH_PROBE_COUNT
    if rates == "none":
        assert pipeline._MESH_PROBE_COUNT > 16 and not all(got)


def test_observed_rates_match_reference(both):
    ref, pipeline = both
    assert pipeline.cpu_events_per_sec() == ref.cpu_events_per_sec() \
        == pipeline.DEFAULT_CPU_EVENTS_PER_SEC
    samples = [(100_000, 1.0), (200_000, 1.0), (0, 0.0), (5, -1.0),
               (3_333, 0.01)]
    for n, s in samples:
        pipeline.observe_cpu_rate(n, s)
        ref.observe_cpu_rate(n, s)
        assert pipeline.cpu_events_per_sec() == ref.cpu_events_per_sec()
    for width, n, s in [(1, 1 << 20, 2.0), (1, 10, 1.0), (4, 1 << 18, 0.3),
                        (1, 1 << 16, 0.1), (0, 1 << 20, 1.0),
                        (4, 1 << 20, 0.0)]:
        pipeline.observe_device_rate(width, n, s)
        ref.observe_device_rate(width, n, s)
    for width in (0, 1, 2, 4):
        assert pipeline.device_events_per_sec(width) == \
            ref.device_events_per_sec(width)
    assert pipeline._DEVICE_RATE == ref._DEVICE_RATE


def test_no_round_trip_on_a_cpu_device(both):
    """The model never times a round trip for a CPU device: the default
    model reads it as 0 (the device lane), and measuring one raises."""
    _, pipeline = both
    assert pipeline.CostModel().rtt("cpu") == 0.0
    assert pipeline.CostModel(cpu_events_per_sec_=1.0).route(
        10 ** 9, "cpu") == "device"
    with pytest.raises(ValueError, match="not a card"):
        pipeline.measured_roundtrip_s("cpu")


class FakeHandle:
    """A dispatch handle recording when it was blocked on."""

    def __init__(self, name, log):
        self.name = name
        self.log = log

    def block_until_ready(self):
        self.log.append(("block", self.name))


def _run(mod, depth, log):
    pipe = mod.DispatchPipeline(depth=depth, name="t")

    def prep(i):
        def f():
            log.append(("prep", i))
            return (i,)
        return f

    def dispatch(i):
        log.append(("dispatch", i))
        return FakeHandle(i, log)

    for i in range(4):
        pipe.submit(prep(i), dispatch)
    return pipe, pipe.results()


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipeline_order_and_blocking_match_reference(both, depth):
    """The same prep, dispatch and block order as the reference's, the
    handles in submission order, and the same stats keys and counts."""
    ref, pipeline = both
    log, ref_log = [], []
    pipe, out = _run(pipeline, depth, log)
    ref_pipe, ref_out = _run(ref, depth, ref_log)
    assert log == ref_log
    assert [h.name for h in out] == [h.name for h in ref_out] == [0, 1, 2, 3]
    stats, ref_stats = pipe.stats(), ref_pipe.stats()
    assert set(stats) == set(ref_stats)
    for k in ("queue", "batches", "inflight_peak"):
        assert stats[k] == ref_stats[k]
    assert stats == pipeline.last_stats()


def test_pipeline_over_cpu_tensors():
    """CPU tensors: done when they exist (no overlap counted, nothing to
    block on), staged as they are, and handed back in submission order."""
    from jepsen_tpu_torch.parallel.pipeline import DispatchPipeline
    pipe = DispatchPipeline(depth=2, name="cpu", device="cpu")
    for i in range(5):
        pipe.submit(lambda i=i: tuple(pipe.stage(torch.arange(3) + i)),
                    lambda x: (x * 2, (x > 2, x.sum())))
    out = pipe.results()
    assert [o[0].tolist() for o in out] == [[2 * (j + i) for j in range(3)]
                                            for i in range(5)]
    assert [int(o[1][1]) for o in out] == [3 + 3 * i for i in range(5)]
    stats = pipe.stats()
    assert stats["batches"] == 5 and stats["inflight_peak"] == 2
    assert stats["overlap_frac"] == 0.0


def _streams(n_keys, n_ops):
    from jepsen_tpu.checker.linear_encode import encode_register_ops as ref
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    hs = [register_history(n_ops, n_procs=3, seed=40 + k, n_values=4)
          for k in range(n_keys)]
    hs[1] = corrupt_reads(hs[1], n=1, seed=1)
    return [ref(h) for h in hs], [encode_register_ops(h) for h in hs]


@pytest.mark.parametrize("rtt", ["0.05", "1e-9"])
def test_auto_lane_matches_reference(both, monkeypatch, rtt):
    """One fixed model in both packages (round trip ``rtt``, the default
    CPU rate): a 3-key batch of ~360 events takes the CPU lane exactly
    when the reference's does, with the same tuples, and the measured CPU
    rate lands in both rate tables."""
    from jepsen_tpu.parallel import batch_check as ref_batch_check
    from jepsen_tpu.parallel import last_route as ref_last_route
    from jepsen_tpu_torch.parallel import batch_check, last_route

    ref, pipeline = both
    monkeypatch.setenv("JEPSEN_TPU_RTT_S", rtt)
    monkeypatch.setattr(pipeline, "_DEFAULT_MODEL",
                        pipeline.CostModel(roundtrip_s=float(rtt)))
    ref_st, st = _streams(3, 60)
    want = ref_batch_check(ref_st, accelerator="auto", mesh=False)
    got = batch_check(st, accelerator="auto", device="cpu", mesh=False)
    assert last_route() == ref_last_route()
    assert last_route() == ("cpu" if rtt == "0.05" else "device")
    assert [r[:2] for r in got] == [r[:2] for r in want]
    assert ("events_per_sec" in pipeline._CPU_RATE) is (rtt == "0.05")
    assert ("events_per_sec" in ref._CPU_RATE) is (rtt == "0.05")
