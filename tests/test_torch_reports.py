"""jepsen_tpu_torch's reports against jepsen_tpu's on the CPU: the HTML
timeline (``render``, windowed past its cap, and ``render_witness`` with
fault bands) byte for byte; the perf graphs, the clock plot and
``linear.png`` pixel for pixel (``matplotlib.image.imread``); the perf
aggregations (``latencies_to_quantiles``, ``rate``, ``nemesis_activity``,
``registry_fault_windows``) and the fault registry's reader
(``nemesis.faults``: ``classify``, ``load_rows`` on a torn file,
``pair_rows``, ``history_windows`` on torn and unmatched rows) equal.
Each case feeds both packages one seeded numpy-made run: tolerance
zero."""
from __future__ import annotations

import json

import numpy as np
import pytest

from jepsen_tpu_torch.histories import (
    corrupt_reads, register_history, stamp_times, with_nemesis,
)

# the faults a run's registry holds: a partition healed in the history, a
# clock bump healed outside it (teardown), a kill never healed, and a
# registry row whose injection never reached the history
WINDOWS = [(40, 160, "start", "stop"),
           (120, 260, "start-partition", "stop-partition"),
           (300, 10_000, "bump", "reset-clock")]


def _run(n_ops=300, seed=11, bad=0):
    """A timed register run with the nemesis of WINDOWS and three
    check-offsets ops, and its registry's rows: the bump healed by the
    teardown, outside the history, and a kill injected that never
    reached it."""
    h = register_history(n_ops, n_procs=5, seed=seed, n_values=5)
    if bad:
        h = corrupt_reads(h, n=bad, seed=seed)
    h = stamp_times(h, seed=seed, gap_ns=3_000_000)
    h, rows = with_nemesis(h, WINDOWS, offsets_at=(5, 250, 500), seed=seed)
    rows = [r for r in rows if not (r["op"] == "heal" and r["id"] == 2)]
    rows += [{"op": "heal", "id": 2, "via": "teardown", "time": 1.8e9},
             {"op": "inject", "id": 3, "kind": "process", "f": "kill",
              "value": ["n2"], "time": 1.75e9}]
    return h, rows


def _store(tmp_path, name, rows, torn=False):
    """A run's test map whose store dir holds ``rows`` as faults.jsonl
    (with a torn last line when ``torn``)."""
    test = {"name": name, "start_time": "20261018T000000.000",
            "store_dir": str(tmp_path)}
    d = tmp_path / name / "20261018T000000.000"
    d.mkdir(parents=True)
    text = "".join(json.dumps(r) + "\n" for r in rows)
    if torn:
        text += '{"op": "inject", "id": 9, "ki'
    (d / "faults.jsonl").write_text(text)
    return test, d


def _same_pixels(a, b):
    import matplotlib.image as mpimg
    x, y = mpimg.imread(a), mpimg.imread(b)
    return x.shape == y.shape and np.array_equal(x, y)


# ---------------------------------------------------------------------------
# the timeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_ops", [None, 50, 7])
def test_timeline_render_is_byte_equal(max_ops):
    from jepsen_tpu.checker import timeline as ref
    from jepsen_tpu_torch.checker import timeline
    h, _ = _run(bad=2)
    test = {"name": "tl"}
    got = timeline.render(test, h, max_ops=max_ops)
    assert got == ref.render(test, h, max_ops=max_ops)
    assert ("truncated" in got) is (max_ops is not None)


def test_timeline_render_windows_past_its_cap(monkeypatch):
    """Past OP_LIMIT a page shows every ⌈M/cap⌉-th op: both packages with
    the same cap."""
    from jepsen_tpu.checker import timeline as ref
    from jepsen_tpu_torch.checker import timeline
    h, _ = _run(n_ops=200)
    for mod in (ref, timeline):
        monkeypatch.setattr(mod, "OP_LIMIT", 64)
    got = timeline.render({}, h)
    assert got == ref.render({}, h)
    assert "every 4th" in got


def _anomaly(h, windows):
    """An anomaly.json-shaped payload: the first corrupted read's op as
    the first anomaly, a witness of the ops around it, the windows."""
    first = next(i for i, op in enumerate(h) if op.get("value") == 999)
    return {"first_anomaly": {"op_index": first, "f": h[first]["f"],
                              "value": 999,
                              "process": h[first]["process"]},
            "witness": {"op_indices": [first - 6, first - 2],
                        "context_op_indices": [first - 9]},
            "fault_windows": windows}


@pytest.mark.parametrize("which", ["registry", "none", "open"])
def test_render_witness_is_byte_equal(which):
    from jepsen_tpu.checker import timeline as ref
    from jepsen_tpu.nemesis import faults as ref_faults
    from jepsen_tpu_torch.checker import timeline
    h, rows = _run(bad=2)
    windows = {"registry": ref_faults.history_windows(h, rows),
               "none": [],
               "open": [{"kind": "net", "f": "partition",
                         "start_time": h[100]["time"], "end_time": None,
                         "healed": True, "via": "teardown"},
                        {"kind": "clock", "start_time": None},
                        {"kind": "pause", "f": "pause",
                         "start_time": h[-1]["time"] + 10 ** 12,
                         "end_time": None}]}[which]
    a = _anomaly(h, windows)
    got = timeline.render_witness({"name": "w"}, h, a)
    assert got == ref.render_witness({"name": "w"}, h, a)
    assert "first anomaly at op" in got


def test_timeline_checker_writes_the_same_page(tmp_path):
    from jepsen_tpu.checker import timeline_html as ref_tl
    from jepsen_tpu_torch.checker import timeline_html
    h, _ = _run()
    for name, chk in (("ref", ref_tl()), ("port", timeline_html())):
        test = {"name": name, "start_time": "t0", "store_dir": str(tmp_path)}
        assert chk.check(test, h, {"subdirectory": "independent/3"}) == {
            "valid?": True}
    pages = [(tmp_path / n / "t0" / "independent" / "3" / "timeline.html"
              ).read_bytes() for n in ("ref", "port")]
    assert pages[0].replace(b"ref timeline", b"port timeline") == pages[1]


# ---------------------------------------------------------------------------
# the perf aggregations and graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dt", [0.1, 1.0, 10.0])
def test_perf_aggregations_match_jax(dt):
    from jepsen_tpu.checker import perf_plots as ref
    from jepsen_tpu_torch.checker import perf_plots
    h, _ = _run(bad=1)
    ops = perf_plots.invokes_with_latency(h)
    assert ops == ref.invokes_with_latency(h)
    times = np.asarray([o["time"] / 1e9 for o in ops])
    lats = np.asarray([o["latency"] / 1e6 for o in ops])
    assert perf_plots.latencies_to_quantiles(times, lats, dt) == \
        ref.latencies_to_quantiles(times, lats, dt)
    assert perf_plots.latencies_to_quantiles([], [], dt) == \
        ref.latencies_to_quantiles([], [], dt)
    assert perf_plots.rate(h, dt) == ref.rate(h, dt)
    assert perf_plots.nemesis_activity(h) == ref.nemesis_activity(h)
    open_ = h[:100]                     # "start" without its "stop"
    assert [op["f"] for op in open_ if op["process"] == "nemesis"] == [
        "check-offsets", "start"]
    assert perf_plots.nemesis_activity(open_) == \
        ref.nemesis_activity(open_)
    assert perf_plots.nemesis_activity([]) == ref.nemesis_activity([]) == []


def test_registry_fault_windows_match_jax(tmp_path):
    from jepsen_tpu.checker import perf_plots as ref
    from jepsen_tpu_torch.checker import perf_plots
    h, rows = _run()
    test, _ = _store(tmp_path, "reg", rows, torn=True)
    got = perf_plots.registry_fault_windows(test, h)
    assert got == ref.registry_fault_windows(test, h)
    assert [w["kind"] for w in got] == ["net", "clock"]
    for t in ({}, None, {"name": "x"}, {**test, "name": "absent"}):
        assert perf_plots.registry_fault_windows(t, h) == \
            ref.registry_fault_windows(t, h) == []


@pytest.mark.parametrize("case", ["run", "faults", "empty", "one-type"])
def test_perf_graphs_have_the_same_pixels(tmp_path, case):
    from jepsen_tpu.checker import perf_plots as ref
    from jepsen_tpu_torch.checker import perf_plots
    h, rows = _run(bad=1)
    if case == "empty":
        h = []
    elif case == "one-type":
        h = [op for op in h if op["type"] in ("invoke", "ok")]
    files = {}
    for name, mod in (("ref", ref), ("port", perf_plots)):
        test, d = _store(tmp_path, "p" + name, rows if case == "faults"
                         else [])
        test["name"] = "perf"
        for fn, out in ((mod.point_graph, "latency-raw.png"),
                        (mod.quantiles_graph, "latency-quantiles.png"),
                        (mod.rate_graph, "rate.png")):
            fn(test, h, d / out)
        files[name] = d
    for out in ("latency-raw.png", "latency-quantiles.png", "rate.png"):
        assert _same_pixels(files["ref"] / out, files["port"] / out), out


def test_point_graph_downsamples_as_jax(tmp_path, monkeypatch):
    """Past POINT_LIMIT points a type the scatter strides and keeps the
    slow tail: both packages at the same small limit."""
    from jepsen_tpu.checker import perf_plots as ref
    from jepsen_tpu_torch.checker import perf_plots
    h, _ = _run()
    for mod in (ref, perf_plots):
        monkeypatch.setattr(mod, "POINT_LIMIT", 40)
    ref.point_graph({"name": "d"}, h, tmp_path / "ref.png")
    perf_plots.point_graph({"name": "d"}, h, tmp_path / "port.png")
    assert _same_pixels(tmp_path / "ref.png", tmp_path / "port.png")


def test_perf_checkers_write_the_same_files(tmp_path):
    from jepsen_tpu.checker import perf as ref_perf
    from jepsen_tpu_torch.checker import perf
    h, rows = _run()
    results = {}
    for name, chk in (("ref", ref_perf()), ("port", perf())):
        test, _ = _store(tmp_path / name, "perf", rows)
        results[name] = chk.check(test, h, {"subdirectory": "k"})
    assert results["ref"] == results["port"] == {
        "valid?": True, "latency-graph": {"valid?": True},
        "rate-graph": {"valid?": True}}
    for out in ("latency-raw.png", "latency-quantiles.png", "rate.png"):
        got = [tmp_path / n / "perf" / "20261018T000000.000" / "k" / out
               for n in ("ref", "port")]
        assert _same_pixels(*got), out


# ---------------------------------------------------------------------------
# the clock plot and linear.png
# ---------------------------------------------------------------------------

def test_clock_plot_matches_jax(tmp_path):
    from jepsen_tpu.checker import clock as ref
    from jepsen_tpu_torch.checker import clock
    h, _ = _run()
    # a bare check-offsets map and a malformed offset, as the reference
    # reads them
    h.append({"type": "info", "process": "nemesis", "f": "check-offsets",
              "value": {"n1": 3.5, "n2": "?"}, "time": h[-1]["time"] + 1})
    assert clock.history_to_datasets(h) == ref.history_to_datasets(h)
    assert clock.plot({"name": "c"}, h, tmp_path / "port.png") is True
    assert ref.plot({"name": "c"}, h, tmp_path / "ref.png") is True
    assert _same_pixels(tmp_path / "ref.png", tmp_path / "port.png")
    plain = [op for op in h if op["process"] != "nemesis"]
    assert clock.plot({}, plain, tmp_path / "none.png") is \
        ref.plot({}, plain, tmp_path / "none.png") is False
    assert not (tmp_path / "none.png").exists()
    for name, chk in (("r", ref.clock_plot()), ("p", clock.clock_plot())):
        test = {"name": name, "start_time": "t", "store_dir": str(tmp_path)}
        assert chk.check(test, plain, {}) == {"valid?": True}
        assert not (tmp_path / name / "t" / "clock-skew.png").exists()


@pytest.mark.parametrize("seed,bad", [(3, 1), (8, 2)])
def test_linear_png_has_the_same_pixels(tmp_path, seed, bad):
    from jepsen_tpu.checker.linear_cpu import check_stream as ref_check
    from jepsen_tpu.checker.linear_encode import (
        encode_register_ops as ref_enc)
    from jepsen_tpu.checker.linear_report import render_failure as ref_render
    from jepsen_tpu_torch.checker.linear_cpu import check_stream
    from jepsen_tpu_torch.checker.linear_encode import encode_register_ops
    from jepsen_tpu_torch.checker.linear_report import render_failure
    h = corrupt_reads(register_history(80, n_procs=4, seed=seed,
                                       n_values=4), n=bad, seed=seed)
    got_res = check_stream(encode_register_ops(h))
    want_res = ref_check(ref_enc(h))
    assert got_res.valid is False and want_res.valid is False
    assert render_failure(h, got_res, str(tmp_path / "port.png")) == str(
        tmp_path / "port.png")
    ref_render(h, want_res, str(tmp_path / "ref.png"))
    assert _same_pixels(tmp_path / "ref.png", tmp_path / "port.png")
    # no configurations: the device verdict's note
    got_res.final_configs = want_res.final_configs = None
    render_failure(h, got_res, str(tmp_path / "port2.png"))
    ref_render(h, want_res, str(tmp_path / "ref2.png"))
    assert _same_pixels(tmp_path / "ref2.png", tmp_path / "port2.png")
    got_res.valid = True
    assert render_failure(h, got_res, str(tmp_path / "x.png")) is None


# ---------------------------------------------------------------------------
# the fault registry's reader
# ---------------------------------------------------------------------------

def test_classify_matches_jax():
    from jepsen_tpu.nemesis import faults as ref
    from jepsen_tpu_torch.nemesis import faults
    names = ["start", "stop", None, 3, "start_partition", "heal",
             "start-partition-replica", "stop-master", "start-netem",
             "stop-clock-rate", "start-pause", "grow", "kill", "reset",
             "start-file", "stop-membership", "bitflip", "snub", "fast"]
    assert [faults.classify(f) for f in names] == \
        [ref.classify(f) for f in names]
    assert faults.KINDS == ref.KINDS and faults.FAULTS_NAME == \
        ref.FAULTS_NAME == "faults.jsonl"


@pytest.mark.parametrize("torn", [False, True])
def test_history_windows_match_jax(tmp_path, torn):
    from jepsen_tpu.nemesis import faults as ref
    from jepsen_tpu_torch.nemesis import faults
    h, rows = _run()
    # an unmatched inject row (no history op) and a heal for no inject
    rows += [{"op": "inject", "id": 7, "kind": "net", "f": "partition",
              "time": 1.76e9},
             {"op": "heal", "id": 42, "via": "cli", "time": 1.9e9}, 5]
    test, d = _store(tmp_path, "fw", rows, torn=torn)
    got_rows = faults.load_rows(d / "faults.jsonl")
    assert got_rows == ref.load_rows(d / "faults.jsonl")
    assert len(got_rows) == len(rows) - 1       # the non-dict row
    assert faults.pair_rows(got_rows) == ref.pair_rows(got_rows)
    got = faults.history_windows(h, got_rows)
    assert got == ref.history_windows(h, got_rows)
    assert [(w["kind"], w["in_registry"], w["end_time"] is None)
            for w in got] == [("net", True, False), ("clock", True, True)]
    assert faults.history_windows(None, got_rows) == []
    assert faults.load_rows(d / "absent.jsonl") == \
        ref.load_rows(d / "absent.jsonl") == []
