"""The set-classify kernel's design (``jepsen_tpu_torch/ops/csrc/
set_classify.cu`` and ``set_classify.cuh``) on the CPU.

The kernel computes the classify with no ``t >= known`` filter inside
its reductions: first_seen, P (the latest read holding an element) and A
(the latest lacking it) are first hits over the reads in time order,
found by ranges of ranks that each win the bits no range above (below,
for first_seen) holds or lacks, and

    known = has_ok ? ok_t : first_seen     any_later = max t >= known
    lp = P >= known ? P : -inf             la = A >= known ? A : -inf.

Held here: a numpy replay of that algorithm against the JAX package's
classify (``jepsen_tpu.ops.setscan.classify_elements``, times that
float32 holds exactly); the header itself, built with ``g++``, walking
the ranges as the kernel's threads do, against the port's plain version
bit for bit (padding bits set past E, rows split at several points);
the wrapper's row order; and, on the card (``cuda``), the kernel against
its plain version on reversed and tied reads and a tall, narrow shape.
Codes and flags are integers and latencies float64 differences of the
same operands: tolerance zero."""
from __future__ import annotations

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

HEADER = (Path(__file__).resolve().parents[1] / "jepsen_tpu_torch" / "ops"
          / "csrc" / "set_classify.cuh")


def _inputs(R, E, seed, ok_share=0.7, ties=0, unseen=0.1, t_hi=1 << 12):
    """Seeded membership and times: integer times below ``t_hi``
    (unsorted; drawn from ``ties`` values when ties > 0), a share
    ``ok_share`` of the elements with an add-ok, and a share ``unseen``
    that no read holds."""
    rng = np.random.default_rng(seed)
    member = rng.random((R, E)) < rng.uniform(0.2, 0.9)
    member[:, rng.random(E) < unseen] = False
    if ties:
        t_read = (rng.integers(0, ties, R) * (t_hi // ties)).astype(
            np.float64)
    else:
        t_read = rng.integers(0, t_hi, R).astype(np.float64)
    invoke_t = rng.integers(0, t_hi, E).astype(np.float64)
    ok_t = invoke_t + rng.integers(0, 64, E)
    has_ok = rng.random(E) < ok_share
    return member, t_read, invoke_t, ok_t, has_ok


def _bounds(R: int, n_groups: int) -> list:
    """The kernel's split of R ranks into n_groups contiguous ranges:
    ceil(R / n_groups) ranks each, the last ones possibly empty."""
    L = -(-R // n_groups)
    return [min(R, g * L) for g in range(n_groups + 1)]


def _first_hit_classify(member, t_read, invoke_t, ok_t, has_ok, bounds):
    """numpy replay of the kernel: the reads in time order, split at
    ``bounds``; each range's held and lacked bits; the bits each range
    wins; each winner's first hit; the finish."""
    order = np.argsort(t_read, kind="stable")
    m, t = member[order], t_read[order]
    E = member.shape[1]
    ranges = list(zip(bounds[:-1], bounds[1:]))
    held = np.array([m[a:b].any(0) for a, b in ranges]).reshape(-1, E)
    lacked = np.array([(~m[a:b]).any(0) for a, b in ranges]).reshape(-1, E)
    first = np.full(E, np.inf)
    p, a_t = np.full(E, -np.inf), np.full(E, -np.inf)
    for g, (a, b) in enumerate(ranges):
        hi_h, hi_l = held[g + 1:].any(0), lacked[g + 1:].any(0)
        win_p, win_a = held[g] & ~hi_h, lacked[g] & ~hi_l
        win_f = held[g] & ~has_ok & ~held[:g].any(0)
        seg = m[a:b]
        if a == b:
            continue
        last_in = b - 1 - np.argmax(seg[::-1], axis=0)
        last_out = b - 1 - np.argmax(~seg[::-1], axis=0)
        first_in = a + np.argmax(seg, axis=0)
        p[win_p] = t[last_in[win_p]]
        a_t[win_a] = t[last_out[win_a]]
        first[win_f] = t[first_in[win_f]]
    known = np.where(has_ok, ok_t, first)
    any_later = t.max() >= known
    lp = np.where(p >= known, p, -np.inf)
    la = np.where(a_t >= known, a_t, -np.inf)
    has_present, has_absent = lp > -np.inf, la > -np.inf
    lost = has_absent & (~has_present | (la > lp))
    never_read = (known >= np.inf) | ~any_later
    code = np.where(never_read, 2, np.where(lost, 1, 0)).astype(np.int32)
    d = np.where(has_absent, la, known) - invoke_t
    return code, (code == 0) & has_absent, np.where(d > 0, d, 0.0)


# (R, E, seed, kwargs): ties, R = 1, none / some / all add-oks, elements
# no read holds
IDENTITY_CASES = [
    (1, 1, 0, {}), (1, 40, 1, {"ok_share": 0.0}), (7, 33, 2, {"ties": 3}),
    (40, 257, 3, {"ok_share": 1.0}), (64, 1000, 4, {"ties": 5}),
    (200, 96, 5, {"ok_share": 0.0, "unseen": 0.3}),
    (17, 1025, 6, {"ok_share": 0.5, "ties": 2}), (3, 7, 7, {"unseen": 0.5}),
]


@pytest.mark.parametrize("R,E,seed,kw", IDENTITY_CASES,
                         ids=[f"{c[0]}x{c[1]}" for c in IDENTITY_CASES])
def test_first_hit_identity_matches_jax(R, E, seed, kw):
    """The kernel's algorithm, at several splits of the reads, gives the
    JAX package's classify (its device program, plain ``jax.jit``)."""
    from jepsen_tpu.ops import setscan as ref
    member, t_read, invoke_t, ok_t, has_ok = _inputs(R, E, seed, **kw)
    want = ref.classify_elements(member, t_read.astype(np.float32),
                                 invoke_t.astype(np.float32),
                                 ok_t.astype(np.float32), has_ok)
    stable = want[0] == 0
    splits = {tuple(_bounds(R, g)) for g in (1, 2, 3, 64, R)}
    splits.add((0, 0, R // 2, R, R))
    for bounds in sorted(splits):
        code, stale, latency = _first_hit_classify(
            member, t_read, invoke_t, ok_t, has_ok, list(bounds))
        assert np.array_equal(code, want[0]), bounds
        assert np.array_equal(stale, want[1]), bounds
        assert np.array_equal(latency[stable],
                              want[2][stable].astype(np.float64)), bounds


def test_identity_cases_cover_every_code():
    codes, stale = set(), False
    for R, E, seed, kw in IDENTITY_CASES:
        member, *cols = _inputs(R, E, seed, **kw)
        c, s, _ = _first_hit_classify(member, *cols, _bounds(R, 1))
        codes |= set(c.tolist())
        stale |= bool(s.any())
    assert codes == {0, 1, 2} and stale


# ---------------------------------------------------------------------------
# the header, built with g++
# ---------------------------------------------------------------------------

HARNESS_CPP = r"""
#include <cstdio>
#include <cstdlib>
#include <vector>
#include "set_classify.cuh"

// stdin: R W E G, the words, t_read (hex floats), order, has_ok, ok_t,
// invoke_t, the G + 1 range bounds. Each word's ranges run as the
// kernel's threads do: group_or, the bits each range wins, the
// winners' scans into each word's hit lists; then finish for each
// element from its hits' times.
// stdout: code stale latency (hex float) an element.
static double hexf() {
  char buf[64];
  if (std::scanf("%63s", buf) != 1) std::exit(2);
  return std::strtod(buf, nullptr);
}
static long long num() {
  long long v;
  if (std::scanf("%lld", &v) != 1) std::exit(2);
  return v;
}
int main() {
  const int R = num(), W = num(), E = num(), G = num();
  std::vector<uint32_t> words((size_t)R * W);
  for (auto& x : words) x = (uint32_t)num();
  std::vector<double> t(R), ok(E), inv(E);
  std::vector<int32_t> order(R);
  std::vector<int> hok(E), bounds(G + 1);
  for (auto& x : t) x = hexf();
  for (auto& x : order) x = (int32_t)num();
  for (auto& x : hok) x = (int)num();
  for (auto& x : ok) x = hexf();
  for (auto& x : inv) x = hexf();
  for (auto& x : bounds) x = (int)num();
  // each word's hit lists: (bits, rank) entries of q = first_seen, P, A
  std::vector<std::vector<uint32_t>> bits(3 * W);
  std::vector<std::vector<int32_t>> ranks(3 * W);
  for (int w = 0; w < W; ++w) {
    const uint32_t live = live_bits(w, E);
    uint32_t need = 0;
    for (int j = 0; j < 32; ++j)
      if (32 * w + j < E && !hok[32 * w + j]) need |= 1u << j;
    std::vector<uint32_t> held(G, 0), lacked(G, 0);
    for (int g = 0; g < G; ++g)
      if (live)
        group_or(words.data(), order.data(), W, w, bounds[g], bounds[g + 1],
                 live, &held[g], &lacked[g]);
    for (int g = 0; g < G; ++g) {
      uint32_t hi_h = 0, hi_l = 0, lo_h = 0;
      for (int h = g + 1; h < G; ++h) {
        hi_h |= held[h];
        hi_l |= lacked[h];
      }
      for (int h = 0; h < g; ++h) lo_h |= held[h];
      const uint32_t win_p = held[g] & ~hi_h, win_a = lacked[g] & ~hi_l;
      const uint32_t win_f = held[g] & need & ~lo_h;
      const auto hit = [&](int q, uint32_t b, int k) {
        bits[3 * w + q].push_back(b);
        ranks[3 * w + q].push_back(k);
      };
      if (win_p | win_a)
        scan_down(words.data(), order.data(), W, w, bounds[g],
                  bounds[g + 1], win_p, win_a, hit);
      if (win_f)
        scan_up(words.data(), order.data(), W, w, bounds[g], bounds[g + 1],
                win_f, hit);
    }
  }
  const double t_max = t[order[R - 1]];
  for (int e = 0; e < E; ++e) {
    int32_t code;
    uint8_t stale;
    double lat;
    int k[3];
    for (int q = 0; q < 3; ++q) {
      const auto& b = bits[3 * (e / 32) + q];
      k[q] = hit_rank(b.data(), ranks[3 * (e / 32) + q].data(),
                      (int)b.size(), e % 32, q == 0 ? R : -1);
    }
    finish(rank_time(t.data(), order.data(), k[0], R, INFINITY),
           rank_time(t.data(), order.data(), k[1], R, -INFINITY),
           rank_time(t.data(), order.data(), k[2], R, -INFINITY), t_max,
           hok[e] != 0, ok[e], inv[e], &code, &stale, &lat);
    std::printf("%d %d %a\n", code, stale, lat);
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def header_harness(tmp_path_factory):
    """The header built by g++ (CUDA's qualifiers defined away) into a
    program that classifies the inputs it reads."""
    if shutil.which("g++") is None:
        pytest.skip("no g++")
    d = tmp_path_factory.mktemp("set_classify")
    (d / "harness.cpp").write_text(HARNESS_CPP)
    exe = d / "harness"
    subprocess.run(["g++", "-std=c++17", "-O2", "-D__device__=",
                    "-D__forceinline__=inline", "-I", str(HEADER.parent),
                    "-o", str(exe), str(d / "harness.cpp")], check=True,
                   capture_output=True, text=True)
    return exe


def _run_harness(exe, words, t_read, order, invoke_t, ok_t, has_ok,
                 bounds):
    R, W = words.shape
    E = len(invoke_t)
    parts = [f"{R} {W} {E} {len(bounds) - 1}",
             " ".join(map(str, words.view(np.uint32).ravel().tolist())),
             " ".join(float(x).hex() for x in t_read),
             " ".join(map(str, order.tolist())),
             " ".join(str(int(x)) for x in has_ok),
             " ".join(float(x).hex() for x in ok_t),
             " ".join(float(x).hex() for x in invoke_t),
             " ".join(map(str, bounds))]
    out = subprocess.run([str(exe)], input="\n".join(parts) + "\n",
                         capture_output=True, text=True, check=True)
    rows = [ln.split() for ln in out.stdout.splitlines()]
    return (np.array([int(r[0]) for r in rows], np.int32),
            np.array([r[1] == "1" for r in rows]),
            np.array([float.fromhex(r[2]) for r in rows]))


def _padded_words(member, seed):
    """pack_member's words with random bits set past E in the last
    word: the kernel masks them out."""
    from jepsen_tpu_torch.ops import setscan
    words = setscan.pack_member(member).view(np.uint32).copy()
    E = member.shape[1]
    if E % 32:
        rng = np.random.default_rng(seed)
        pad = (~np.uint32((1 << (E % 32)) - 1)) & rng.integers(
            0, 1 << 32, len(words), dtype=np.uint32)
        words[:, -1] |= pad
    return words.view(np.int32)


# (R, E, seed, kwargs, splits): ranges as the kernel splits them (an
# int: that many) or explicit bounds; nanosecond-size times past 10^11
HEADER_CASES = [
    (1, 1, 10, {}, [1, 4]),
    (1, 70, 11, {"ok_share": 0.0}, [1, 3]),
    (7, 33, 12, {"ties": 3}, [1, 2, 7, 16]),
    (40, 257, 13, {}, [1, 3, 8, 40, [0, 1, 20, 39, 40]]),
    (64, 1000, 14, {"ok_share": 0.0, "ties": 5}, [1, 8, 512]),
    (200, 96, 15, {"ok_share": 0.5}, [1, 64, 512, [0, 0, 100, 100, 200]]),
    (300, 40, 16, {"ok_share": 1.0}, [2, 37]),
]


@pytest.mark.parametrize("R,E,seed,kw,splits", HEADER_CASES,
                         ids=[f"{c[0]}x{c[1]}" for c in HEADER_CASES])
def test_header_scans_match_plain(header_harness, R, E, seed, kw, splits):
    """set_classify.cuh's scans, built with g++ and walked range by range
    as the kernel's threads walk them, equal the plain version bit for
    bit: at every split, with padding bits set past E."""
    from jepsen_tpu_torch.ops import setscan
    member, t_read, invoke_t, ok_t, has_ok = _inputs(
        R, E, seed, t_hi=1 << 30, **kw)
    t_read, invoke_t, ok_t = (10.0 ** 11 + x for x in (t_read, invoke_t,
                                                         ok_t))
    words = _padded_words(member, seed)
    want = [x.numpy() for x in setscan.classify_plain(
        torch.from_numpy(words), *(torch.from_numpy(c) for c in (
            t_read, invoke_t, ok_t)), torch.from_numpy(has_ok), E)]
    order = setscan.read_order(t_read)
    for split in splits:
        bounds = _bounds(R, split) if isinstance(split, int) else split
        got = _run_harness(header_harness, words, t_read, order, invoke_t,
                           ok_t, has_ok, bounds)
        for x, y in zip(got, want):
            assert np.array_equal(x, y), bounds


def test_header_reversed_history_matches_plain(header_harness):
    """A set-full history's columns (reads that hold ever more elements,
    planted loss and staleness) with the reads listed last first."""
    from jepsen_tpu_torch.histories import set_full_history
    from jepsen_tpu_torch.history_ir import views
    from jepsen_tpu_torch.ops import setscan
    enc = views.set_full_columns(set_full_history(600, 25, n_lost=3,
                                                  n_stale=4, seed=1))
    member = np.ascontiguousarray(enc["member"][::-1])
    t_read = np.ascontiguousarray(enc["read_t"][::-1])
    E = len(enc["els"])
    cols = (t_read, enc["invoke_t"], enc["ok_t"])
    for has_ok in (enc["has_ok"], enc["has_ok"] & (np.arange(E) % 3 > 0)):
        words = setscan.pack_member(member)
        want = [x.numpy() for x in setscan.classify_plain(
            torch.from_numpy(words), *(torch.from_numpy(c) for c in cols),
            torch.from_numpy(has_ok), E)]
        for split in (1, 5, 512):
            got = _run_harness(header_harness, words, t_read,
                               setscan.read_order(t_read), *cols[1:],
                               has_ok, _bounds(len(t_read), split))
            for x, y in zip(got, want):
                assert np.array_equal(x, y), split


# ---------------------------------------------------------------------------
# the wrapper's row order
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,ties", [(0, 0), (1, 3), (2, 1)])
def test_read_order_is_stable_with_ties(seed, ties):
    """read_order sorts the rows by read time and keeps tied rows in
    their order, for numpy arrays and tensors alike."""
    from jepsen_tpu_torch.ops import setscan
    rng = np.random.default_rng(seed)
    t = (rng.integers(0, ties, 300) if ties else rng.random(300) * 1e11)
    t = t.astype(np.float64)
    order = setscan.read_order(t)
    assert order.dtype == np.int32
    assert np.array_equal(order, np.lexsort((np.arange(300), t)))
    got = setscan.read_order(torch.from_numpy(t))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), order)


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
@pytest.mark.parametrize("case", ["reversed", "tied", "tall_narrow",
                                  "wide"])
def test_kernel_orders_and_shapes_on_card(cuda_device, case):
    """The kernel against its plain version on the card, bit for bit:
    reads last first, read times drawn from 3 values, a tall, narrow
    4,096 x 96 (a tile of one word), 400 x 40,000 (tiles of 8 words)."""
    from jepsen_tpu_torch.ops import setscan
    R, E, kw = {"reversed": (400, 5000, {}), "tied": (300, 3000,
                                                      {"ties": 3}),
                "tall_narrow": (4096, 96, {"ok_share": 0.5}),
                "wide": (400, 40_000, {})}[case]
    member, t_read, invoke_t, ok_t, has_ok = _inputs(R, E, 20, **kw)
    if case == "reversed":
        t_read = np.sort(t_read)[::-1].copy()
    args = (torch.from_numpy(_padded_words(member, 3)).to(cuda_device),
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
