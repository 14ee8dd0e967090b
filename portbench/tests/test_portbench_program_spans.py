"""The program's own spans in a traced preflight run: the four metrics
that read them, ``spans.jsonl``, and the program's ``discover``,
``encode``, ``tick`` and ``report`` against the benchmark's wrappers
``list``, ``encode``, ``tick`` and ``report``, nested call by call and
agreeing over the window."""

import json
import os

import pytest

import tinyroot
from portbench import program_spans
from portbench.harness import run_cell

NEW = {"groups_ms.preflight", "evidence_ms.preflight",
       "snapshot_ms.preflight", "unspanned_ms.preflight"}
#: program span -> the wrapper that times the same call
PAIRS = (("discover", "list"), ("encode", "encode"), ("tick", "tick"),
         ("report", "report"))


@pytest.fixture
def root(tmp_path, monkeypatch, cpu_planner, sync_repaired):
    root = tinyroot.make(str(tmp_path))
    monkeypatch.chdir(root)
    return root


def test_a_traced_run_reads_the_program_spans(root, monkeypatch):
    seen = []
    real = program_spans.collect

    def spy(tr):
        seen.append(tr)
        return real(tr)

    monkeypatch.setattr(program_spans, "collect", spy)
    r = run_cell(root, "k8s5k.preflight", 2 ** 33 + 17, 3.0, True,
                 require_cuda=False)
    assert r["correct"], r["notes"]
    assert NEW <= set(r["metrics"])
    assert all(r["metrics"][m]["value"] >= 0 for m in NEW)
    tr = seen[0]
    traces = real(tr)
    assert 2 <= len(traces) <= len(tr.calls)
    path = os.path.join(root, ".portbench_runs", "spans.jsonl")
    with open(path) as f:
        lines = [json.loads(line) for line in f]
    assert len(lines) == sum(len(t) for t in traces)
    assert {d["name"] for d in lines} == {
        "preflight", "discover", "analyze_fleet", "encode", "snapshot",
        "tick", "report", "groups"}
    assert program_spans.load(path) == traces
    calls = tr.calls[-len(traces):]
    progs = [program_spans.per_call_ms(t) for t in traces]
    for call, ms in zip(calls, progs):
        # call by call, each pair nests: the program's discover, tick
        # and report spans hold the wrapped call, and the wrapper's
        # encode (analyze_fleet's start to analyze_encoding's) holds the
        # program's encode span
        for prog, wrapper in PAIRS:
            if prog == "encode":
                assert ms[prog] <= call[wrapper], (prog, ms, call)
            else:
                assert ms[prog] >= call[wrapper], (prog, ms, call)
    # and agree: a single call can lose the processor between a
    # wrapper's edge and the span's for longer than the tolerance, the
    # window's mean only by that pause's share
    for prog, wrapper in PAIRS:
        p = sum(ms[prog] for ms in progs) / len(progs)
        w = sum(c[wrapper] for c in calls) / len(calls)
        assert abs(p - w) <= max(1.0, 0.05 * w), (prog, p, w)


def test_an_untraced_run_attaches_no_sink(root):
    from tpu_cc_manager_torch import trace

    before = list(trace.get_tracer()._sinks)
    r = run_cell(root, "k8s5k.preflight", 2 ** 33 + 19, 2.0, False,
                 require_cuda=False)
    assert r["correct"], r["notes"]
    assert list(trace.get_tracer()._sinks) == before
    assert not os.path.exists(os.path.join(root, ".portbench_runs",
                                           "spans.jsonl"))


def test_the_readers_find_nothing_on_a_program_without_t0(monkeypatch):
    """A program whose spans keep no monotonic start (the parent of the
    spans' change) gives no metric, and no reader raises."""
    from portbench.metrics import TraceData

    monkeypatch.setattr(program_spans, "ring_records", lambda: ([], False))
    tr = TraceData("preflight", [{"list": 1.0}] * 3, {}, None, None)
    traces = program_spans.collect(tr)
    assert traces is None
    assert program_spans.span_ms(traces, "groups") is None
    assert program_spans.evidence_ms(traces) is None
    assert program_spans.unspanned_ms(traces) is None


def test_unspanned_time_is_the_period_outside_every_span():
    def rec(name, t0, t1, tid, parent=None, **attrs):
        return (name, t0, t1, tid, name + tid, parent, attrs)

    traces = [
        [rec("discover", 0.0, 1.0, "a", "preflighta"),
         rec("preflight", 0.0, 3.0, "a"),
         rec("groups", 3.5, 4.0, "a", "preflighta", evidence_s=0.25)],
        [rec("preflight", 5.0, 6.0, "b"),
         rec("groups", 6.0, 9.0, "b", "preflightb", evidence_s=0.5)],
        [rec("preflight", 9.5, 10.0, "c")],
    ]
    # 1.5 s and 0.5 s outside every span, in the two whole periods
    assert program_spans.unspanned_ms(traces) == pytest.approx(1000.0)
    assert program_spans.span_ms(traces, "groups") == pytest.approx(
        1e3 * 3.5 / 3)
    assert program_spans.evidence_ms(traces) == pytest.approx(250.0)
    assert program_spans.span_ms(traces, "snapshot") is None
