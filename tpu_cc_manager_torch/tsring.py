"""In-process time-series ring over a metric set (ISSUE 9 part 1).

``/metrics`` is a point-in-time snapshot: an operator (or the SLO
engine) asking "how many flips per minute RIGHT NOW" or "what was the
reconcile p99 over the last minute" has to scrape twice and diff by
hand — and after a crash the history is gone entirely. This module
keeps that history *inside* the process: a bounded ring of periodic
metric-set snapshots (every registered metric, via
:func:`obs.registered_metrics` reflection — a metric you can construct
is a metric the ring samples), plus the windowed-delta math that turns
two snapshots into answers:

- counter families become per-minute **rates** (flips/min, publish
  drops/min), clamped to 0 across a counter reset (a restarted process
  must read as "no events yet", never as a negative rate);
- histogram families become windowed **quantile estimates**
  (reconcile p50/p99 over the last window) interpolated from the
  cumulative-bucket deltas, exactly the ``histogram_quantile`` shape;
- gauges carry their current value and windowed delta.

Surfaces: ``GET /debug/timeseries`` on every process's route server
(agent HealthServer, fleet/policy controllers) serves
:meth:`TimeSeriesRing.to_doc` with the raw ring points; the flight
recorder embeds the same document (points elided — dumps stay small)
so a black box carries the minutes *leading up to* the crash, not just
the instant of it. The fleet observatory (fleetobs.py) reuses the
snapshot shape and window math for its fleet-merged series.

Everything here is observability: ``tick()`` never raises into the
process it samples, and the sampling thread is a daemon.
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from tpu_cc_manager_torch.obs import (
    Counter, Gauge, Histogram, HistogramVec, registered_metrics,
)

log = logging.getLogger("tpu-cc-manager.tsring")

#: /debug/timeseries + flight-recorder embed schema version
SCHEMA_VERSION = 1

#: one snapshot of one metric set: family name -> family dict
#: ({"type": "counter"|"gauge", "series": {labelkey: value}} or
#:  {"type": "histogram", "hist": {labelkey:
#:      {"buckets": {le_str: cum}, "sum": s, "count": n}}})
Snapshot = Dict[str, Dict[str, Any]]

#: one ring entry
Sample = Tuple[float, Snapshot]


def _labelkey(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    """Canonical labelset key: ``k="v",k2="v2"`` sorted by key (empty
    string for the unlabeled series) — the join key snapshots, merges,
    and the SLO engine all index series by."""
    return ",".join(
        f'{n}="{v}"' for n, v in sorted(zip(names, values))
    )


def snapshot_metric_set(obj: object, seen: Optional[Snapshot] = None) -> Snapshot:
    """Snapshot every metric-primitive attribute of ``obj`` (the
    :func:`obs.registered_metrics` reflection — the same walk the
    exposition render uses, so the ring can never drift from
    /metrics). Pass a prior dict as ``seen`` to merge several metric
    sets into one snapshot."""
    snap: Snapshot = seen if seen is not None else {}
    for m in registered_metrics(obj):
        if isinstance(m, Counter):
            fam = snap.setdefault(
                m.name, {"type": "counter", "series": {}}
            )
            with m._lock:
                for key, v in m._values.items():
                    fam["series"][_labelkey(m.label_names, key)] = v
        elif isinstance(m, Gauge):
            fam = snap.setdefault(m.name, {"type": "gauge", "series": {}})
            with m._lock:
                for key, v in m._values.items():
                    fam["series"][_labelkey(m.label_names, key)] = v
        elif isinstance(m, Histogram):
            fam = snap.setdefault(m.name, {"type": "histogram", "hist": {}})
            fam["hist"][""] = m.snapshot()
        elif isinstance(m, HistogramVec):
            fam = snap.setdefault(m.name, {"type": "histogram", "hist": {}})
            with m._lock:
                children = list(m._children.items())
            for value, h in children:
                fam["hist"][f'{m.label_name}="{value}"'] = h.snapshot()
    return snap


# ----------------------------------------------------------- window math


def counter_delta(old: Optional[float], new: Optional[float]) -> float:
    """Windowed counter increase, clamped at 0: a counter reset (the
    process restarted inside the window) must read as a zero rate,
    never a negative one."""
    if new is None:
        return 0.0
    if old is None:
        return max(new, 0.0)
    return max(new - old, 0.0)


def _le_value(le: str) -> float:
    return math.inf if le == "+Inf" else float(le)


def bucket_deltas(
    old_hist: Optional[Dict[str, Any]],
    new_hist: Dict[str, Any],
) -> List[Tuple[float, float]]:
    """Per-bucket (NON-cumulative) observation counts inside the window
    between two histogram snapshots, sorted by ``le``. Negative deltas
    (counter reset mid-window) clamp to 0 per bucket — same posture as
    :func:`counter_delta`."""
    new_buckets = new_hist.get("buckets") or {}
    old_buckets = (old_hist or {}).get("buckets") or {}
    out: List[Tuple[float, float]] = []
    prev_cum_delta = 0.0
    for le in sorted(new_buckets, key=_le_value):
        cum_delta = counter_delta(old_buckets.get(le), new_buckets[le])
        out.append((_le_value(le), max(cum_delta - prev_cum_delta, 0.0)))
        prev_cum_delta = max(cum_delta, prev_cum_delta)
    return out


def quantile_from_buckets(
    deltas: List[Tuple[float, float]], q: float
) -> Optional[float]:
    """``histogram_quantile``-style estimate from per-bucket counts.

    Edge contract (pinned by tests/test_tsring.py):

    - empty window (no observations) -> None;
    - a single populated bucket interpolates inside that bucket from
      its lower bound (0 for the first);
    - all observations in ``+Inf`` -> the highest *finite* bucket bound
      (the estimate saturates; with no finite bound at all -> None);
    - q clamps into [0, 1].
    """
    total = sum(n for _, n in deltas)
    if total <= 0:
        return None
    q = min(max(q, 0.0), 1.0)
    rank = q * total
    cum = 0.0
    finite_bounds = [le for le, _ in deltas if le != math.inf]
    for i, (le, n) in enumerate(deltas):
        if n <= 0:
            continue
        if cum + n >= rank:
            if le == math.inf:
                # saturate at the highest finite bound — an unbounded
                # estimate would be a lie with more digits
                return finite_bounds[-1] if finite_bounds else None
            lower = 0.0
            for ple, _ in reversed(deltas[:i]):
                if ple != math.inf:
                    lower = ple
                    break
            frac = (rank - cum) / n
            return lower + (le - lower) * min(max(frac, 0.0), 1.0)
        cum += n
    # numerically rank == total landed past the loop: highest bucket
    last_finite = finite_bounds[-1] if finite_bounds else None
    return last_finite


def derive_window(
    old: Optional[Sample], new: Sample,
    quantiles: Tuple[float, ...] = (0.5, 0.99),
) -> Dict[str, Any]:
    """Everything the window between two samples answers: counter
    rates/min, gauge values + deltas, histogram windowed count/rates
    and quantile estimates. ``old=None`` degrades to "since process
    start" semantics (the cumulative totals ARE the window)."""
    new_ts, new_snap = new
    old_ts, old_snap = old if old is not None else (None, {})
    dt = max(new_ts - old_ts, 1e-9) if old_ts is not None else None
    doc: Dict[str, Any] = {
        "window_s": round(dt, 3) if dt is not None else None,
        "counters": {}, "gauges": {}, "histograms": {},
    }
    for name, fam in sorted(new_snap.items()):
        old_fam = old_snap.get(name) or {}
        if fam["type"] in ("counter", "gauge"):
            old_series = old_fam.get("series") or {}
            out: Dict[str, Any] = {}
            for key, value in sorted(fam["series"].items()):
                entry: Dict[str, Any] = {"value": round(value, 6)}
                if fam["type"] == "counter":
                    d = counter_delta(old_series.get(key), value)
                    entry["window_delta"] = round(d, 6)
                    if dt is not None:
                        entry["per_min"] = round(d / dt * 60.0, 3)
                else:
                    prev = old_series.get(key)
                    if prev is not None:
                        entry["window_delta"] = round(value - prev, 6)
                out[key] = entry
            doc["counters" if fam["type"] == "counter" else "gauges"][
                name] = out
        else:
            old_hists = old_fam.get("hist") or {}
            hout: Dict[str, Any] = {}
            for key, hist in sorted(fam["hist"].items()):
                deltas = bucket_deltas(old_hists.get(key), hist)
                wcount = sum(n for _, n in deltas)
                entry = {
                    "count": hist.get("count", 0),
                    "window_count": round(wcount, 6),
                }
                if dt is not None:
                    entry["per_min"] = round(wcount / dt * 60.0, 3)
                for q in quantiles:
                    qv = quantile_from_buckets(deltas, q)
                    entry[f"p{int(q * 100)}"] = (
                        round(qv, 6) if qv is not None else None
                    )
                hout[key] = entry
            doc["histograms"][name] = hout
    return doc


def window_pair(
    samples: List[Sample], window_s: float,
    now: Optional[float] = None,
) -> Optional[Tuple[Sample, Sample]]:
    """(old, new) bracketing the last ``window_s`` seconds: new is the
    latest sample, old the latest one at-or-before the window start
    (so the pair spans at least the window) — or the whole ring when
    it is younger than the window: a short-lived process still answers
    with what it has. None with fewer than 2 samples."""
    if len(samples) < 2:
        return None
    new = samples[-1]
    cutoff = (now if now is not None else new[0]) - window_s
    old = samples[0]
    for s in samples[:-1]:
        if s[0] <= cutoff:
            old = s
        else:
            break
    return old, new


class TimeSeriesRing:
    """Bounded periodic snapshot ring over one metric-set object (or a
    callable returning a :data:`Snapshot` — the fleet observatory's
    merged series ride the same machinery)."""

    DEFAULT_INTERVAL_S = 10.0
    DEFAULT_CAPACITY = 64

    def __init__(
        self,
        source: Union[object, Callable[[], Snapshot]],
        *,
        interval_s: Optional[float] = None,
        capacity: int = DEFAULT_CAPACITY,
        name: str = "",
        window_s: Optional[float] = None,
    ):
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    "TPU_CC_TSRING_INTERVAL_S", "") or 0)
            except ValueError:
                interval_s = 0.0
            if interval_s <= 0:
                interval_s = self.DEFAULT_INTERVAL_S
        self.name = name
        self.interval_s = interval_s
        #: default derivation window: a handful of intervals, so the
        #: rates smooth single-tick noise but still move in minutes
        self.window_s = window_s or interval_s * 6
        self._source = source
        self._samples: "deque[Sample]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: post-sample listeners (the anomaly watchdog, ISSUE 15):
        #: fn(samples) called after every appended tick, exceptions
        #: contained — a broken listener costs itself, not the sampler
        self._listeners: List[Callable[[List[Sample]], Any]] = []

    def add_listener(
        self, fn: Callable[[List[Sample]], Any],
    ) -> "TimeSeriesRing":
        """Register a post-tick listener: called with the full sample
        list after each successful snapshot — how the watchdog sees
        every new window without owning a second sampling thread."""
        self._listeners.append(fn)
        return self

    # ------------------------------------------------------------ sampling
    def _snapshot(self) -> Snapshot:
        if callable(self._source):
            return self._source()
        return snapshot_metric_set(self._source)

    def tick(self, now: Optional[float] = None) -> Optional[Sample]:
        """Take one snapshot now. Never raises into the caller — a
        broken metric set degrades to a skipped sample (logged)."""
        try:
            sample = (now if now is not None else time.time(),
                      self._snapshot())
        except Exception:  # ccaudit: allow-swallow(observability sampler: a metric set that fails to snapshot must cost one missing sample, never the process that owns it; the warning is the signal)
            log.warning("tsring %s snapshot failed", self.name,
                        exc_info=True)
            return None
        with self._lock:
            self._samples.append(sample)
            samples = list(self._samples)
        for fn in self._listeners:
            try:
                fn(samples)
            except Exception:  # ccaudit: allow-swallow(a broken listener must cost itself, never the sampling loop; the warning names it)
                log.warning("tsring %s listener failed", self.name,
                            exc_info=True)
        return sample

    def start(self) -> "TimeSeriesRing":
        """Start the periodic sampling thread (daemon; idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"tsring-{self.name or 'metrics'}",
            daemon=True,
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        self.tick()
        while not self._stop.wait(self.interval_s):
            self.tick()

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)

    # ------------------------------------------------------------- reading
    def samples(self) -> List[Sample]:
        with self._lock:
            return list(self._samples)

    def route(
        self, metric_prefix: Optional[str] = None,
    ) -> Tuple[int, bytes, str]:
        """The ``GET /debug/timeseries`` handler body — one shared
        implementation for every route server (agent HealthServer,
        fleet + policy controllers). ``metric_prefix`` (the
        ``?metric=<prefix>`` query, ISSUE 15 satellite) narrows the
        document to metric families whose name starts with it."""
        import json

        body = json.dumps(
            self.to_doc(metric_prefix=metric_prefix),
            indent=1, sort_keys=True,
        ).encode()
        return 200, body, "application/json"

    def to_doc(
        self,
        window_s: Optional[float] = None,
        include_points: bool = True,
        metric_prefix: Optional[str] = None,
    ) -> Dict[str, Any]:
        """The ``/debug/timeseries`` response body (and, with
        ``include_points=False``, the flight-recorder embed): ring
        metadata, the windowed derivation over the newest samples, and
        optionally the raw ring as per-series point lists.
        ``metric_prefix`` filters families by name prefix BEFORE the
        derivation, so a filtered pull costs proportionally less, not
        just ships less."""
        samples = self.samples()
        if metric_prefix:
            samples = [
                (ts, {
                    name: fam for name, fam in snap.items()
                    if name.startswith(metric_prefix)
                })
                for ts, snap in samples
            ]
        window = window_s or self.window_s
        doc: Dict[str, Any] = {
            "tsring_version": SCHEMA_VERSION,
            "name": self.name,
            "interval_s": self.interval_s,
            "window_s": window,
            "samples": len(samples),
            "span_s": (
                round(samples[-1][0] - samples[0][0], 3)
                if len(samples) > 1 else 0.0
            ),
        }
        if metric_prefix:
            doc["metric_prefix"] = metric_prefix
        if samples:
            pair = window_pair(samples, window)
            doc["derived"] = derive_window(
                pair[0] if pair else None, samples[-1]
            )
        if include_points and samples:
            points: Dict[str, Dict[str, List[List[float]]]] = {}
            for ts, snap in samples:
                rel = round(ts, 3)
                for fam_name, fam in snap.items():
                    famp = points.setdefault(fam_name, {})
                    if fam["type"] in ("counter", "gauge"):
                        for key, v in fam["series"].items():
                            famp.setdefault(key, []).append(
                                [rel, round(v, 6)]
                            )
                    else:
                        for key, hist in fam["hist"].items():
                            famp.setdefault(key, []).append(
                                [rel, hist.get("count", 0)]
                            )
            doc["points"] = points
        return doc
