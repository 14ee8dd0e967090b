"""Online anomaly watchdog — metrics → anomaly → exemplar → profile →
dump, while the slow flip is still on the stack (ISSUE 15).

Until now a latency excursion was chased OFFLINE: wait for the bench
round to land, run ``scripts/bench_attr.py``, hope the phase data was
committed (the r05 4.43 s real-chip flip sat formally unattributed for
five rounds exactly this way). All the raw signals already live
in-process — tsring's windowed rates/quantiles, the histograms' trace
exemplars, the flight recorder's rings — but nothing *watched* them.
This module is the missing correlation layer:

- it consumes the time-series ring's window pairs (adjacent snapshot
  samples through :func:`tsring.derive_window`) for a small set of
  **declared series** (:data:`DEFAULT_SERIES`: flip-phase p99s, the
  reconcile-duration p99, publish-retry rate, watch-pump lag p99 —
  every ``metric`` name must exist as a real declaration, enforced by
  ccaudit's metric-name cross-check);
- each window's value updates a **robust baseline** (EWMA of the value
  + EWMA of absolute deviation, the online MAD stand-in) and is scored
  as a robust z: ``(x - ewma) / max(1.4826·mad, 0.1·ewma,
  min_scale)``. The ``min_scale`` floor is the false-positive guard —
  with a near-constant baseline the MAD collapses toward 0 and any
  jitter would otherwise read as infinite z;
- firing is **one-sided** (latency/rate going UP), needs
  ``min_windows`` prior baseline windows (a cold ring stays silent),
  and is per-series cooldown-throttled;
- a firing assembles an **incident packet**: the anomalous series +
  window stats + baseline, the exemplar trace ids harvested from the
  offending histogram objects, a profile captured synchronously while
  the anomaly is live (:meth:`profiler.SamplingProfiler.capture`), and
  a throttled flight-recorder dump. Served at ``GET
  /debug/incidents``; simlab collects packets into run artifacts and
  resolves their exemplar trace ids against the fleet-wide stitched
  timeline (``flightrec.stitch_by_trace``).

Counter-rate series are restart-proof by construction: the window
deltas come through :func:`tsring.counter_delta`, which clamps a
mid-window counter reset to 0 — a process restart can never fire an
anomaly on its own (pinned by tests/test_watchdog.py).

Everything here is observability: ``consume`` never raises into the
sampling loop that calls it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_cc_manager_torch.obs import Histogram, HistogramVec, registered_metrics
from tpu_cc_manager_torch.tsring import Sample, derive_window

log = logging.getLogger("tpu-cc-manager.watchdog")

#: incident packet schema version (docs/observability.md §6)
SCHEMA_VERSION = 1


@dataclasses.dataclass(frozen=True)
class WatchSeries:
    """One declared series the watchdog scores every window.

    ``metric`` must name a declared Counter/Histogram family (ccaudit's
    metric-name cross-check fails a typo here — an anomaly detector
    over a metric nobody emits can never fire, the worst kind of
    monitoring). ``stat`` picks the windowed statistic: ``p99`` for
    histogram families, ``rate`` (per-minute) for counters.
    ``min_scale`` is the robust-z scale floor in the series' own units
    (seconds for latency, events/min for rates)."""

    metric: str
    stat: str = "p99"  #: "p99" | "rate"
    min_scale: float = 0.05
    description: str = ""


#: The flip/reconcile-path series every deployment watches by default.
#: Each metric below is a real declaration (obs.Metrics or the shared
#: obs factory histograms); ccaudit cross-checks the set against the
#: declaration registry (analysis/slo.py, the metric-name rule).
DEFAULT_SERIES: Tuple[WatchSeries, ...] = (
    WatchSeries("tpu_cc_phase_duration_seconds", "p99",
                description="per-phase flip latency (stage/reset/"
                            "wait_ready/verify/...)"),
    WatchSeries("tpu_cc_reconcile_duration_seconds", "p99",
                description="end-to-end reconcile duration"),
    WatchSeries("tpu_cc_publish_retries_total", "rate",
                min_scale=30.0,
                description="coalescing-publish retry pressure"),
    WatchSeries("tpu_cc_watch_pump_lag_seconds", "p99",
                description="watch-pump delivery lag"),
)


class _SeriesState:
    """Online robust baseline for one (metric, labelset, stat)."""

    __slots__ = ("n", "ewma", "mad")

    def __init__(self) -> None:
        self.n = 0
        self.ewma = 0.0
        self.mad = 0.0

    def score(self, x: float, min_scale: float) -> float:
        scale = max(1.4826 * self.mad, 0.1 * abs(self.ewma), min_scale)
        return (x - self.ewma) / scale

    def update(self, x: float, alpha: float) -> None:
        if self.n == 0:
            self.ewma = x
            self.mad = 0.0
        else:
            dev = abs(x - self.ewma)
            self.ewma += alpha * (x - self.ewma)
            self.mad += alpha * (dev - self.mad)
        self.n += 1


class Watchdog:
    """Score declared series on every ring sample; fire incidents."""

    Z_THRESHOLD = 6.0
    MIN_WINDOWS = 4
    EWMA_ALPHA = 0.3
    #: synchronous profile burst length on fire
    CAPTURE_S = 0.25
    #: per-series re-fire throttle
    COOLDOWN_S = 10.0
    MAX_INCIDENTS = 32
    MAX_EXEMPLARS = 4

    def __init__(
        self,
        *,
        series: Tuple[WatchSeries, ...] = DEFAULT_SERIES,
        sources: Optional[List[Any]] = None,
        profiler: Optional[Any] = None,
        recorder: Optional[Any] = None,
        name: str = "",
        z_threshold: float = Z_THRESHOLD,
        min_windows: int = MIN_WINDOWS,
        capture_s: float = CAPTURE_S,
        cooldown_s: float = COOLDOWN_S,
        on_incident: Optional[Callable[[Dict[str, Any]], None]] = None,
    ):
        self.name = name
        self.series = tuple(series)
        #: metric-set objects whose live Histogram/HistogramVec
        #: attributes are walked for exemplar trace ids on fire (only
        #: on fire — a 256-replica source list costs nothing steady
        #: state)
        self.sources: List[Any] = list(sources or [])
        self.profiler = profiler
        self.recorder = recorder
        self.z_threshold = z_threshold
        self.min_windows = min_windows
        self.capture_s = capture_s
        self.cooldown_s = cooldown_s
        self.on_incident = on_incident
        self._state: Dict[Tuple[str, str, str], _SeriesState] = {}
        self._last_fire: Dict[Tuple[str, str, str], float] = {}
        self._incidents: "deque[Dict[str, Any]]" = deque(
            maxlen=self.MAX_INCIDENTS)
        self.incidents_total = 0
        self.last_capture_s: Optional[float] = None
        self._lock = threading.Lock()

    # ----------------------------------------------------------- consuming
    def consume(self, samples: List[Sample],
                now: Optional[float] = None) -> List[Dict[str, Any]]:
        """Evaluate the newest adjacent window pair of ``samples`` (a
        tsring/fleetobs sample list) and return the incident packets
        fired (usually empty). Never raises into the caller."""
        try:
            return self._consume(samples, now)
        except Exception:  # ccaudit: allow-swallow(the watchdog must never take down the sampling loop it observes; a broken evaluation costs one window and the warning names it)
            log.warning("watchdog %s consume failed", self.name,
                        exc_info=True)
            return []

    def _consume(self, samples: List[Sample],
                 now: Optional[float]) -> List[Dict[str, Any]]:
        if len(samples) < 2:
            return []  # a cold ring stays silent by construction
        ts = now if now is not None else samples[-1][0]
        doc = derive_window(samples[-2], samples[-1])
        fired: List[Dict[str, Any]] = []
        for ws in self.series:
            for labelkey, value, window in self._series_values(ws, doc):
                key = (ws.metric, labelkey, ws.stat)
                state = self._state.setdefault(key, _SeriesState())
                if value is None:
                    continue  # empty window: no evidence either way
                z = state.score(value, ws.min_scale)
                ready = state.n >= self.min_windows
                anomalous = (ready and value > state.ewma
                             and z >= self.z_threshold)
                baseline = {
                    "ewma": round(state.ewma, 6),
                    "mad": round(state.mad, 6),
                    "windows": state.n,
                }
                # the anomalous window still feeds the baseline (a
                # sustained shift adapts instead of firing forever;
                # the cooldown bounds the burst either way)
                state.update(value, self.EWMA_ALPHA)
                if not anomalous:
                    continue
                last = self._last_fire.get(key, 0.0)
                if time.monotonic() - last < self.cooldown_s:
                    continue
                self._last_fire[key] = time.monotonic()
                fired.append(self._fire(
                    ws, labelkey, value, z, baseline, window, ts
                ))
        return fired

    def _series_values(
        self, ws: WatchSeries, doc: Dict[str, Any],
    ) -> List[Tuple[str, Optional[float], Dict[str, Any]]]:
        """(labelkey, windowed value, window-stats entry) per series of
        the declared family present in this window document."""
        out: List[Tuple[str, Optional[float], Dict[str, Any]]] = []
        if ws.stat == "rate":
            fam = doc.get("counters", {}).get(ws.metric) or {}
            for labelkey, entry in sorted(fam.items()):
                out.append((labelkey, entry.get("per_min"), entry))
        else:
            fam = doc.get("histograms", {}).get(ws.metric) or {}
            for labelkey, entry in sorted(fam.items()):
                # derive_window names its quantile keys "p50"/"p99" —
                # the stat IS the key
                out.append((labelkey, entry.get(ws.stat), entry))
        return out

    # -------------------------------------------------------------- firing
    def _fire(
        self,
        ws: WatchSeries,
        labelkey: str,
        value: float,
        z: float,
        baseline: Dict[str, Any],
        window: Dict[str, Any],
        ts: float,
    ) -> Dict[str, Any]:
        t0 = time.monotonic()
        packet: Dict[str, Any] = {
            "incident_version": SCHEMA_VERSION,
            "at": round(ts, 3),
            "name": self.name,
            "series": {
                "metric": ws.metric,
                "labels": labelkey,
                "stat": ws.stat,
                "description": ws.description,
            },
            "value": round(value, 6),
            "z": round(z, 2),
            "baseline": baseline,
            "window": window,
            "exemplars": self._exemplars_for(ws.metric),
        }
        log.warning(
            "watchdog %s: ANOMALY %s{%s} %s=%.6g (baseline %.6g, "
            "z=%.1f >= %.1f) — assembling incident packet",
            self.name, ws.metric, labelkey, ws.stat, value,
            baseline["ewma"], z, self.z_threshold,
        )
        if self.profiler is not None:
            if getattr(self.profiler, "armed", False):
                # an operator's continuous session (TPU_CC_PROFILER=1)
                # is already sampling and its aggregate COVERS the
                # anomaly window — snapshot it, never reset it (the
                # operator's accumulated profile must survive an
                # incident)
                packet["profile"] = self.profiler.summary()
            else:
                # auto-arm: a synchronous burst on THIS thread via a
                # private clone, taken while the anomalous work is
                # still running somewhere — the shared instance's
                # aggregate (an earlier arm an operator means to read
                # later) stays untouched
                from tpu_cc_manager_torch.profiler import SamplingProfiler

                burst = SamplingProfiler(
                    self.profiler.hz,
                    name=self.profiler.name or self.name,
                )
                packet["profile"] = burst.capture(self.capture_s)
        if self.recorder is not None:
            self.recorder.note(
                "incident", metric=ws.metric, labels=labelkey,
                stat=ws.stat, value=round(value, 6), z=round(z, 2),
            )
            # throttled: a flapping series must not fill the disk —
            # the PACKET always exists, the dump is best-effort extra
            packet["flightrec_dump"] = self.recorder.maybe_dump(
                "incident")
        capture_s = round(time.monotonic() - t0, 4)
        packet["capture_s"] = capture_s
        with self._lock:
            self._incidents.append(packet)
            self.incidents_total += 1
            self.last_capture_s = capture_s
        if self.on_incident is not None:
            try:
                self.on_incident(packet)
            except Exception:  # ccaudit: allow-swallow(a broken incident hook must not break the watchdog that called it; the warning names it)
                log.warning("watchdog incident hook failed",
                            exc_info=True)
        return packet

    def _exemplars_for(self, metric: str) -> List[Dict[str, Any]]:
        """Harvest exemplar trace ids for ``metric`` from the live
        metric-set objects — newest first, bounded. The join key the
        incident hands the fleet stitch."""
        found: List[Dict[str, Any]] = []
        for obj in self.sources:
            try:
                for m in registered_metrics(obj):
                    if getattr(m, "name", None) != metric:
                        continue
                    if isinstance(m, Histogram):
                        found.extend(m.exemplars())
                    elif isinstance(m, HistogramVec):
                        for label_value, exs in m.exemplars().items():
                            for ex in exs:
                                entry = dict(ex)
                                entry["series"] = (
                                    f'{m.label_name}="{label_value}"'
                                )
                                found.append(entry)
            except Exception:  # ccaudit: allow-swallow(one broken exemplar source must not cost the packet its other sources; harvesting is best-effort by contract)
                log.warning("exemplar harvest failed", exc_info=True)
        found.sort(key=lambda e: -(e.get("ts") or 0.0))
        return found[: self.MAX_EXEMPLARS]

    # ------------------------------------------------------------- reading
    def incidents(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._incidents)

    def to_doc(self) -> Dict[str, Any]:
        """The ``GET /debug/incidents`` body."""
        with self._lock:
            incidents = list(self._incidents)
            total = self.incidents_total
        return {
            "watchdog_version": SCHEMA_VERSION,
            "name": self.name,
            "series": [dataclasses.asdict(ws) for ws in self.series],
            "z_threshold": self.z_threshold,
            "min_windows": self.min_windows,
            "incidents_total": total,
            "incidents": incidents,
        }

    def route(self) -> Tuple[int, bytes, str]:
        body = json.dumps(
            self.to_doc(), indent=1, sort_keys=True,
        ).encode()
        return 200, body, "application/json"
