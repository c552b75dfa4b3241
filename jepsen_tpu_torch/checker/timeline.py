"""HTML timeline: a per-process gantt of operations (jepsen_tpu/checker/
timeline.py, after jepsen/src/jepsen/checker/timeline.clj — hiccup there;
direct HTML string assembly here, no dependency). Its pages are
byte-equal to the reference's for the same test map and history.

Each op is a positioned block in its process's column; height spans
invoke→completion, color encodes the completion type. Histories past
``OP_LIMIT`` render *windowed*: evenly sampled across the WHOLE run with
a visible "truncated — N of M ops" banner, instead of the reference's
silent first-N clip (timeline.clj:12-14) — witness windows from huge
histories must render, not vanish.

:func:`render_witness` is the anomaly-forensics view (doc/observability
"Anomaly forensics"): just the witness ops of an ``anomaly.json``, the
fatal op highlighted, with the run's nemesis/fault windows overlaid as
horizontal bands.
"""
from __future__ import annotations

import html as html_mod

from jepsen_tpu_torch import store
from jepsen_tpu_torch.checker import Checker
from jepsen_tpu_torch.utils import history_to_latencies, nanos_to_ms

# copied from jepsen_tpu/checker/timeline.py:26-50, without the unused NS
OP_LIMIT = 10_000

COLORS = {"ok": "#6DB6FE", "info": "#FFAA26", "fail": "#FEB5DA"}
HSCALE = 1e-6 / 10.0  # nanos -> px (1 ms = 0.1 px)
MIN_HEIGHT = 14
COL_WIDTH = 100
GUTTER = 4

STYLE = """
body { font-family: sans-serif; font-size: 11px; }
.ops { position: absolute; }
.op { position: absolute; padding: 2px; border-radius: 2px;
      overflow: hidden; box-sizing: border-box; }
.op:hover { overflow: visible; z-index: 10; min-width: 250px; }
.op.fatal { border: 2px solid #d00; z-index: 5; }
.proc-header { position: absolute; top: 0; font-weight: bold; }
.banner { background: #fff3cd; border: 1px solid #e0c060;
          padding: 0.4em 0.8em; margin-bottom: 0.5em; display: inline-block; }
.fault-band { position: absolute; left: 0; right: 0;
              background: rgba(255, 160, 60, 0.18);
              border-top: 1px dashed #d08030; z-index: 0; }
.fault-band span { color: #a05010; font-size: 10px; }
"""


# copied from jepsen_tpu/checker/timeline.py:52-60
def pairs(history: list[dict]) -> list[tuple[dict, dict | None]]:
    """(invoke, completion|None) pairs, client ops only
    (timeline.clj:37-57)."""
    out = []
    for op in history_to_latencies(history):
        if op.get("type") != "invoke" or op.get("process") == "nemesis":
            continue
        out.append((op, op.get("completion")))
    return out


# copied from jepsen_tpu/checker/timeline.py:63-91
def _op_blocks(ps, col, hscale=HSCALE, t_base: float = 0.0,
               fatal_indices=frozenset()):
    """Positioned op divs + the max y they reach."""
    blocks = []
    max_y = 0.0
    for iv, comp in ps:
        t0 = iv.get("time", 0)
        t1 = comp.get("time", t0) if comp else t0 + MIN_HEIGHT / hscale
        y = 20 + (t0 - t_base) * hscale
        h = max(MIN_HEIGHT, (t1 - t0) * hscale)
        max_y = max(max_y, y + h)
        x = col[iv.get("process")] * (COL_WIDTH + GUTTER)
        typ = comp.get("type", "info") if comp else "info"
        color = COLORS.get(typ, "#dddddd")
        label = f"{iv.get('f')} {iv.get('value')!r}"
        if comp is not None and comp.get("value") != iv.get("value"):
            label += f" → {comp.get('value')!r}"
        title = (f"process {iv.get('process')} {typ} "
                 f"t={nanos_to_ms(t0):.1f}ms "
                 f"lat={nanos_to_ms(iv.get('latency', 0)):.1f}ms")
        fatal = iv.get("index") in fatal_indices or \
            (comp is not None and comp.get("index") in fatal_indices)
        cls = "op fatal" if fatal else "op"
        blocks.append(
            f'<div class="{cls}" title="{html_mod.escape(title)}" '
            f'style="left:{x}px;top:{y:.1f}px;width:{COL_WIDTH}px;'
            f'height:{h:.1f}px;background:{color}">'
            f'{html_mod.escape(label)}</div>')
    return blocks, max_y


# copied from jepsen_tpu/checker/timeline.py:94-100
def _page(title: str, banner: str, blocks: list[str], max_y: float) -> str:
    return (
        "<!DOCTYPE html><html><head><meta charset='utf-8'>"
        f"<title>{html_mod.escape(title)}</title>"
        f"<style>{STYLE}</style></head><body>{banner}"
        f"<div class='ops' style='height:{max_y + 40:.0f}px'>"
        + "".join(blocks) + "</div></body></html>")


# copied from jepsen_tpu/checker/timeline.py:103-132
def render(test: dict, history: list[dict],
           max_ops: int | None = None) -> str:
    """The run timeline. Histories over the cap render a WINDOWED view —
    every ⌈M/cap⌉-th op across the whole run — with a visible truncation
    banner, so a 1M-op run still shows its full time span instead of
    silently clipping to the first 10k ops."""
    all_ps = pairs(history)
    total = len(all_ps)
    cap = OP_LIMIT if max_ops is None else max_ops
    banner = ""
    if cap and total > cap:
        step = -(-total // cap)
        ps = all_ps[::step]
        banner = (f"<div class='banner'>truncated — showing {len(ps)} of "
                  f"{total} ops (every {step}th, whole run "
                  "windowed)</div>")
    else:
        ps = all_ps
    processes = sorted({iv.get("process") for iv, _ in ps},
                       key=lambda p: (str(type(p)), p))
    col = {p: i for i, p in enumerate(processes)}
    blocks = []
    for p in processes:
        x = col[p] * (COL_WIDTH + GUTTER)
        blocks.append(f'<div class="proc-header" style="left:{x}px">'
                      f'process {html_mod.escape(str(p))}</div>')
    op_blocks, max_y = _op_blocks(ps, col)
    blocks += op_blocks
    return _page(f"{test.get('name', 'test')} timeline", banner, blocks,
                 max_y)


# copied from jepsen_tpu/checker/timeline.py:135-203
def render_witness(test: dict, history: list[dict], anomaly: dict) -> str:
    """The witness window of an anomaly.json payload as a per-process
    gantt: only the witness (and context) ops, time-zoomed to the
    window, the fatal op outlined, and the run's fault windows overlaid
    as labeled horizontal bands (doc/observability.md "Anomaly
    forensics")."""
    wit = anomaly.get("witness") or {}
    fa = anomaly.get("first_anomaly") or {}
    indices = set(wit.get("op_indices") or [])
    indices |= set(wit.get("context_op_indices") or [])
    if fa.get("op_index") is not None:
        indices.add(fa["op_index"])
    fatal = {i for i in (fa.get("op_index"),) if i is not None}

    # index ops (history_to_latencies preserves dict contents; stored
    # histories already carry "index", fresh ones get one here)
    hist = [op if "index" in op else {**op, "index": i}
            for i, op in enumerate(history)]
    ps = [(iv, comp) for iv, comp in pairs(hist)
          if iv.get("index") in indices
          or (comp is not None and comp.get("index") in indices)]
    times = [iv.get("time", 0) for iv, _ in ps] or [0]
    t_base = min(times)
    t_span = max(max(times) - t_base, 1)
    # zoom the window to ~800px regardless of absolute duration
    hscale = min(800.0 / t_span, 2.0) if t_span else HSCALE

    processes = sorted({iv.get("process") for iv, _ in ps},
                       key=lambda p: (str(type(p)), p))
    col = {p: i for i, p in enumerate(processes)}
    width = max(1, len(processes)) * (COL_WIDTH + GUTTER)
    blocks = []
    for p in processes:
        x = col[p] * (COL_WIDTH + GUTTER)
        blocks.append(f'<div class="proc-header" style="left:{x}px">'
                      f'process {html_mod.escape(str(p))}</div>')
    op_blocks, max_y = _op_blocks(ps, col, hscale=hscale, t_base=t_base,
                                  fatal_indices=fatal)
    blocks += op_blocks

    # fault windows overlapping the witness span, as horizontal bands
    for w in anomaly.get("fault_windows") or ():
        t0 = w.get("start_time")
        if t0 is None:
            continue
        t1 = w.get("end_time")
        # out-of-span windows are omitted — an open (end_time None)
        # window starting past the span must not stretch the page
        if t0 > t_base + t_span or (t1 is not None and t1 < t_base):
            continue
        y0 = 20 + max(0.0, (t0 - t_base)) * hscale
        y1 = (20 + (t1 - t_base) * hscale if t1 is not None
              else max_y + 20)
        label = f"{w.get('kind')} ({w.get('f')})"
        if w.get("healed") and w.get("end_time") is None:
            label += f" — healed via {w.get('via')} (outside history)"
        max_y = max(max_y, y1)
        blocks.append(
            f'<div class="fault-band" style="top:{y0:.1f}px;'
            f'height:{max(2.0, y1 - y0):.1f}px;min-width:{width}px">'
            f'<span>{html_mod.escape(label)}</span></div>')

    summary = (f"first anomaly at op {fa.get('op_index')} "
               f"({fa.get('f')} {fa.get('value')!r}, process "
               f"{fa.get('process')}) — witness of "
               f"{len(wit.get('op_indices') or [])} op(s)")
    banner = f"<div class='banner'>{html_mod.escape(summary)}</div>"
    return _page(f"{test.get('name', 'test')} witness", banner, blocks,
                 max_y)


# copied from jepsen_tpu/checker/timeline.py:206-214
class Timeline(Checker):
    def name(self):
        return "timeline"

    def check(self, test, history, opts):
        d = opts.get("subdirectory")
        out = store.path_mk(test, *filter(None, [d, "timeline.html"]))
        out.write_text(render(test, history))
        return {"valid?": True}


# copied from jepsen_tpu/checker/timeline.py:217-218
def html() -> Checker:
    return Timeline()
