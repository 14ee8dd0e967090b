"""The program's own spans over a traced preflight window.

The port opens its spans on its process tracer
(``tpu_cc_manager_torch.trace.get_tracer()``). Each ``Rollout.run()``
opens a ``preflight`` root with ``discover`` and ``analyze_fleet``
(``encode``, ``snapshot``, ``tick``, ``report``) under it, and then
``groups``, re-seated under the same root after it closed. Each span
keeps its monotonic start ``t0``, the clock the profiler's timeline is
tied to, so its interval there is ``[t0, t0 + dur_s]``.

No sink is attached: after the window the readers take the tracer's
ring of completed spans (its last 2048) and keep the traces of the last
``len(tr.calls)`` preflight roots, which are the calls begun in the
window (the closed loop begins no call after it). The first read writes
them to ``.portbench_runs/spans.jsonl`` under the working directory, one
span per line. On a program whose spans keep no ``t0``, or that opens no
``preflight`` root, every reader finds nothing and returns None.

    python3 -m portbench.program_spans .portbench_runs/spans.jsonl

prints each span's mean ms per preflight, the time no span covers, and
the counters' means.
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

#: one completed span: (name, t0, t0 + dur_s, trace id, span id, parent
#: id, attrs), on the monotonic clock
Rec = Tuple[str, float, float, str, str, Optional[str], dict]
#: the spans of one preflight's trace, in the order they closed
Trace = List[Rec]

#: the counters a summary gives means of: (span, attribute)
COUNTERS = (("encode", "grows"), ("encode", "rows_written"),
            ("groups", "evidence_docs"), ("tick", "bytes_up"),
            ("tick", "bytes_down"))

_memo: Optional[Tuple[object, Optional[List[Trace]]]] = None


def ring_records() -> Tuple[List[Rec], bool]:
    """The process tracer's completed spans that keep a monotonic
    start, oldest first, and whether its ring is full (older spans have
    left it)."""
    from tpu_cc_manager_torch import trace

    tracer = trace.get_tracer()
    with tracer._lock:
        items = list(tracer._ring)
        full = len(tracer._ring) == tracer._ring.maxlen
    out = []
    for s in items:
        t0 = getattr(s, "t0", None)
        if t0:
            out.append((s.name, t0, t0 + s.dur_s, s.trace_id, s.span_id,
                        s.parent_id, dict(s.attrs)))
    return out, full


def preflights(recs: Sequence[Rec], n: int, full: bool) -> List[Trace]:
    """The traces of the last ``n`` preflight roots in ``recs``, oldest
    first. In a full ring the oldest root's children may have left it,
    so that root is not taken."""
    roots = [r for r in recs if r[0] == "preflight" and r[5] is None]
    if full:
        roots = roots[1:]
    by_trace: Dict[str, Trace] = {}
    for r in recs:
        by_trace.setdefault(r[3], []).append(r)
    return [by_trace[r[3]] for r in roots[-n:]] if n > 0 else []


def collect(tr) -> Optional[List[Trace]]:
    """The window's preflight traces for the traced run ``tr`` (a
    :class:`portbench.metrics.TraceData`), None where there are none.
    Read once per run; the first read writes them out."""
    global _memo
    if _memo is not None and _memo[0] is tr:
        return _memo[1]
    traces = None
    if getattr(tr, "kind", None) == "preflight" and tr.calls:
        recs, full = ring_records()
        traces = preflights(recs, len(tr.calls), full) or None
        if traces:
            write(traces, os.path.join(os.getcwd(), ".portbench_runs",
                                       "spans.jsonl"))
    _memo = (tr, traces)
    return traces


def write(traces: Sequence[Trace], path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        for t in traces:
            for name, t0, t1, tid, sid, pid, attrs in t:
                f.write(json.dumps({"name": name, "t0": t0, "t1": t1,
                                    "trace": tid, "span": sid,
                                    "parent": pid, "attrs": attrs}) + "\n")


def load(path: str) -> List[Trace]:
    """The traces a :func:`write` kept, oldest first."""
    recs = []
    with open(path) as f:
        for line in f:
            d = json.loads(line)
            recs.append((d["name"], d["t0"], d["t1"], d["trace"], d["span"],
                         d["parent"], d["attrs"]))
    return preflights(recs, len(recs), False)


def per_call_ms(t: Trace) -> Dict[str, float]:
    """Host ms of one preflight in each span name."""
    out: Dict[str, float] = {}
    for name, t0, t1, *_ in t:
        out[name] = out.get(name, 0.0) + 1e3 * (t1 - t0)
    return out


def span_ms(traces: Optional[Sequence[Trace]], name: str
            ) -> Optional[float]:
    """Mean ms per preflight in the spans named ``name``; None where no
    preflight opened one."""
    if not traces or not any(r[0] == name for t in traces for r in t):
        return None
    return sum(per_call_ms(t).get(name, 0.0) for t in traces) / len(traces)


def attr_mean(traces: Optional[Sequence[Trace]], name: str, key: str
              ) -> Optional[float]:
    """Mean per preflight of attribute ``key`` summed over the spans
    named ``name``; None where no such span has it."""
    if not traces:
        return None
    vals = [[r[6][key] for r in t if r[0] == name and key in r[6]]
            for t in traces]
    if not any(vals):
        return None
    return sum(sum(v) for v in vals) / len(traces)


def _covered(spans: Sequence[Tuple[float, float]], lo: float,
             hi: float) -> float:
    """Seconds of ``[lo, hi)`` inside the union of ``spans``."""
    total, at = 0.0, lo
    for a, b in sorted(spans):
        a, b = max(a, at), min(b, hi)
        if b > a:
            total += b - a
            at = b
    return total


def unspanned_ms(traces: Optional[Sequence[Trace]]) -> Optional[float]:
    """Mean ms per preflight of the closed loop's period (one root's
    start to the next's) that no span of the preflight's trace covers:
    the call's work outside every program span, and the loop's own
    between calls. The window's last call has no next root, so the mean
    is over the others; None with fewer than two."""
    if not traces or len(traces) < 2:
        return None
    vals = []
    for cur, nxt in zip(traces, traces[1:]):
        lo, hi = _root(cur)[1], _root(nxt)[1]
        vals.append(hi - lo - _covered([(r[1], r[2]) for r in cur], lo, hi))
    return 1e3 * sum(vals) / len(vals)


def _root(t: Trace) -> Rec:
    return next(r for r in t if r[0] == "preflight" and r[5] is None)


def summary(traces: Sequence[Trace]) -> Dict[str, Optional[float]]:
    """Each span's mean ms per preflight, the time no span covers, the
    closed loop's mean period, and each counter's mean per preflight."""
    names = sorted({r[0] for t in traces for r in t})
    out: Dict[str, Optional[float]] = {
        f"{n}_ms": span_ms(traces, n) for n in names}
    out["unspanned_ms"] = unspanned_ms(traces)
    starts = [_root(t)[1] for t in traces]
    out["period_ms"] = (1e3 * (starts[-1] - starts[0]) / (len(starts) - 1)
                        if len(starts) > 1 else None)
    out["evidence_ms"] = evidence_ms(traces)
    for name, key in COUNTERS:
        out[key] = attr_mean(traces, name, key)
    out["preflights"] = float(len(traces))
    return out


def evidence_ms(traces: Optional[Sequence[Trace]]) -> Optional[float]:
    """Mean ms per preflight in the group plan's evidence checks."""
    s = attr_mean(traces, "groups", "evidence_s")
    return None if s is None else 1e3 * s


def main(argv: Optional[List[str]] = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) != 1:
        print("usage: python3 -m portbench.program_spans SPANS_JSONL",
              file=sys.stderr)
        return 2
    print(json.dumps(summary(load(args[0])), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
