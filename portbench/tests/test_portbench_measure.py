"""The metric arithmetic: the mean over the window's calls, the plan lag
and its 95th percentile with the drain, the rooflines from shapes, and
the device timeline's busy share and breakdown."""

import pytest

from portbench import bounds
from portbench.measure import Call, in_window, mean_s, p95, plan_lags
from portbench.metrics import TraceData, idle_pct, layer_mean_ms
from portbench.trace import CLOSE_MARK, OPEN_MARK, Timeline, breakdown, rooflines
from portbench.traffic import DESIRED, DONE, DONE_FAILED, KUBELET, TAINT
from portbench.writer import Write


def scan(begin, end, nf=(), fl=(), fa=()):
    return Call(begin, end, begin, end, 0, 0,
                {"needs_flip": list(nf), "flipping": list(fl),
                 "failed": list(fa)}, None, {})


def write(node, kind, due, end=None):
    return Write(0, node, kind, due, due, due if end is None else end, 0, {})


def test_mean_counts_calls_begun_in_the_window():
    calls = [scan(0.5, 1.5), scan(1.5, 3.5), scan(3.5, 4.0), scan(9.0, 12.0)]
    w = in_window(calls, 1.0, 10.0)
    assert [c.begin for c in w] == [1.5, 3.5, 9.0]
    assert mean_s(w) == pytest.approx((2.0 + 0.5 + 3.0) / 3)
    assert mean_s([]) is None


def test_plan_lag_follows_each_write_to_the_first_scan_showing_it():
    names = ["a", "b"]
    writes = [write(0, DESIRED, 1.0), write(0, TAINT, 2.0),
              write(0, DONE, 6.0), write(1, DESIRED, 1.0),
              write(1, TAINT, 2.0), write(1, DONE_FAILED, 6.0),
              write(0, KUBELET, 1.5)]
    scans = [
        scan(0.0, 1.2),                                   # before a write
        scan(1.2, 2.5, nf=["a", "b"]),                    # desired shown
        scan(2.5, 4.0, nf=["a"], fl=["a"]),               # b's taint lost
        scan(4.0, 6.5, nf=["a", "b"], fl=["a", "b"]),
        scan(6.5, 8.0, nf=["b"], fa=["b"]),               # both done
    ]
    lags, unseen = plan_lags(scans, writes, names, 0.0, 10.0)
    assert unseen == 0
    # a: 2.5-1, 4.0-2, 8.0-6; b: 2.5-1, 6.5-2 (its taint shows only in
    # the fourth scan), 8.0-6
    assert sorted(lags) == sorted([1.5, 2.0, 2.0, 1.5, 4.5, 2.0])
    assert p95(lags) == pytest.approx(3.875)


def test_a_later_write_of_the_flip_shows_an_earlier_one():
    # the scan never sees the taint alone: the flip's done state shows
    # both the taint write and the desired write
    scans = [scan(0.0, 0.5), scan(0.5, 7.0)]
    writes = [write(0, DESIRED, 1.0), write(0, TAINT, 2.0),
              write(0, DONE, 6.0)]
    lags, unseen = plan_lags(scans, writes, ["a"], 0.0, 10.0)
    assert unseen == 0 and sorted(lags) == [1.0, 5.0, 6.0]


def test_a_write_no_scan_shows_counts_unseen():
    scans = [scan(0.0, 1.0), scan(1.0, 3.0)]
    writes = [write(0, DESIRED, 1.5)]
    assert plan_lags(scans, writes, ["a"], 0.0, 10.0) == ([], 1)
    # a write due after the window is not counted at all
    assert plan_lags(scans, writes, ["a"], 0.0, 1.0) == ([], 0)


def test_bounds_from_shapes():
    # K1 at 65 536 rows: 32 B read and 7 B written a row, bytes-bound
    ms = bounds.k1_bound_ms(65536, 8, 65536)
    read = 4 * 8 * 65536 + 4 * 8
    written = 7 * 65536 + 2 * 65536 + 4 * (12 + 48)
    assert ms == pytest.approx(1e3 * (read + written) / 3.35e12)
    assert ms > 1e3 * 65536 * 64 / 67e12
    assert bounds.k2_bound_ms(512, 300) == pytest.approx(
        1e3 * (4 * 512 + 64 * 300) / 3.35e12)


def timeline():
    marks = {OPEN_MARK: 100.0, CLOSE_MARK: 110.0}
    ev = [
        {"ph": "X", "name": OPEN_MARK, "ts": 0.0, "dur": 1.0},
        {"ph": "X", "name": CLOSE_MARK, "ts": 10e6, "dur": 1.0},
        {"ph": "X", "cat": "kernel", "name": "tick_init(int*)",
         "ts": 1e6, "dur": 1.0},
        {"ph": "X", "cat": "kernel",
         "name": "(anonymous namespace)::tick_rows(int const*, int)",
         "ts": 1e6 + 2, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "name": "tick_epilogue(int*)",
         "ts": 1e6 + 20, "dur": 1.0},
        {"ph": "X", "cat": "kernel",
         "name": "void delta_scatter_kernel<8>(ShardBlocks, int)",
         "ts": 5e6, "dur": 4.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 5e6 + 2, "dur": 4.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 5e6,
         "dur": 100.0},
    ]
    return Timeline(ev, marks)


def test_timeline_busy_rooflines_and_breakdown():
    tl = timeline()
    assert tl.aligned
    busy, merged = tl.busy(100.0, 110.0)
    assert busy == pytest.approx(18e-6)
    assert len(merged) == 4
    launches = [("k1", 101.0, 65536, 8, 65536), ("k2", 105.0, 65536, 512, 300)]
    roof = rooflines(tl, launches, 100.0, 110.0)
    assert roof["k1"] == pytest.approx(
        100 * bounds.k1_bound_ms(65536, 8, 65536) / 12e-3)
    assert roof["k2"] == pytest.approx(
        100 * bounds.k2_bound_ms(512, 300) / 4e-3)
    assert rooflines(tl, launches, 106.0, 110.0) == {"k1": None, "k2": None}
    spans = [("list", 100.5, 103.0), ("audit", 103.0, 104.9)]
    bd = breakdown(tl, spans, [(100.2, 105.5)], 100.0, 110.0)
    assert bd["device_ops"][0][0] == "tick_rows"
    gaps = bd["idle_gaps"]
    assert gaps[0][0] == "between calls" and gaps[0][1] == pytest.approx(
        110.0 - 105.000006, abs=1e-5)
    assert [g[0] for g in gaps[1:3]] == ["list", "list"]
    tr = TraceData("scan", [{"list": 10.0}, {"list": 30.0, "tick": 1.0}],
                   roof, busy, 10.0)
    assert layer_mean_ms(tr, "scan", "list") == 20.0
    assert layer_mean_ms(tr, "scan", "tick") == 0.5
    assert layer_mean_ms(tr, "preflight", "list") is None
    assert idle_pct(tr, "scan") == pytest.approx(100 * (1 - 18e-7))
