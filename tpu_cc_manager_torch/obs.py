"""Observability: structured logging, metrics, /healthz — what the
reference lacks entirely (SURVEY.md §5.5: "no metrics endpoint, no
/healthz") and BASELINE measures us on (reconcile-latency histogram).

Prometheus text exposition implemented directly (no client library —
nothing to vendor), plus a tiny stdlib HTTP server serving:

- ``/healthz`` — liveness: 200 while the agent's watch loop is alive;
- ``/readyz``  — readiness: 200 once the initial reconcile completed
  (same condition as the readiness file, reference main.py:67-79);
- ``/metrics`` — Prometheus text format.
"""

from __future__ import annotations

import json
import logging
import os
import re
import sys
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from tpu_cc_manager_torch.modes import STATE_FAILED, VALID_MODES

#: Every value the observed-mode gauge can take — derived from the
#: canonical vocabulary so new modes can't drift out of the metrics.
OBSERVED_MODE_VALUES = VALID_MODES + (STATE_FAILED, "unknown")

#: Content type for exemplar-capable metric surfaces (ISSUE 15):
#: exemplar suffixes are ILLEGAL in the classic
#: ``text/plain; version=0.0.4`` exposition — a strict classic parser
#: fails the whole scrape on the first mid-line ``#`` — so every route
#: whose render may carry them advertises the OpenMetrics type instead
#: (scrapers negotiate by content type; OpenMetrics parsers accept the
#: exemplar syntax natively).
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8"
)


class JsonLogFormatter(logging.Formatter):
    """One JSON object per log record, carrying the ACTIVE trace/span
    ids (trace.current_trace_ids) so logs and traces join on one key —
    a reconcile's log lines and its span tree share a trace_id whether
    the trace was minted locally or adopted from a controller's
    desired-write annotation."""

    # the "Z" suffix below claims UTC — render in UTC (the Formatter
    # default is localtime, which would lie by the host's TZ offset)
    converter = time.gmtime

    def format(self, record: logging.LogRecord) -> str:
        from tpu_cc_manager_torch import trace as _trace

        out: Dict[str, object] = {
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S")
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        trace_id, span_id = _trace.current_trace_ids()
        if trace_id is not None:
            out["trace_id"] = trace_id
            out["span_id"] = span_id
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def setup_logging(debug: bool = False, fmt: Optional[str] = None) -> None:
    """Timestamped structured-ish logs (reference main.py:54-59 format,
    --debug escalation main.py:726-734). ``fmt="json"``
    (``TPU_CC_LOG_FORMAT=json``) switches every record to one JSON
    object carrying the current trace_id/span_id — the opt-in that
    makes logs greppable by the same key the trace sinks and the
    flight recorder index on."""
    if fmt is None:
        fmt = os.environ.get("TPU_CC_LOG_FORMAT", "text")
    if fmt == "json":
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(JsonLogFormatter())
        root = logging.getLogger()
        for old in list(root.handlers):
            root.removeHandler(old)
        root.addHandler(handler)
        root.setLevel(logging.DEBUG if debug else logging.INFO)
        return
    logging.basicConfig(
        level=logging.DEBUG if debug else logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
        force=True,
    )


# --------------------------------------------------------------------------
# metrics primitives
# --------------------------------------------------------------------------


class Counter:
    def __init__(self, name: str, help_: str, label_names: Tuple[str, ...] = ()):
        self.name, self.help = name, help_
        self.label_names = label_names
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def inc(self, *label_values: str, amount: float = 1.0) -> None:
        key = tuple(label_values)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def set_total(self, value: float, *label_values: str) -> None:
        """Mirror an EXTERNAL monotonic total into this counter (the
        planner's retrace/compile-cache counts are owned by plan.py's
        module counters; the scrape-side Counter just republishes
        them). The source must be monotonic — that is what keeps the
        exposition honest as TYPE counter."""
        with self._lock:
            self._values[tuple(label_values)] = float(value)

    def value(self, *label_values: str) -> float:
        return self._values.get(tuple(label_values), 0.0)

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            if not self._values and not self.label_names:
                out.append(f"{self.name} 0")
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_labels(self.label_names, key)} {_fmt(v)}")
        return out


class Gauge:
    def __init__(self, name: str, help_: str, label_names: Tuple[str, ...] = ()):
        self.name, self.help = name, help_
        self.label_names = label_names
        self._values: Dict[Tuple[str, ...], float] = {}
        self._lock = threading.Lock()

    def set(self, value: float, *label_values: str) -> None:
        with self._lock:
            self._values[tuple(label_values)] = value

    def value(self, *label_values: str) -> Optional[float]:
        return self._values.get(tuple(label_values))

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            for key, v in sorted(self._values.items()):
                out.append(f"{self.name}{_labels(self.label_names, key)} {_fmt(v)}")
        return out


class Histogram:
    """Fixed-bucket histogram; default buckets span label-patch latencies
    (ms) through full drain+flip reconciles (minutes).

    Bucket counts/sum/count are cumulative for the process lifetime (the
    Prometheus contract). ``quantile()`` is answered from an exact sliding
    window of the most recent ``WINDOW`` observations — on a long-running
    agent it is "the pXX over the last 10k reconciles", never a mix of
    arbitrary retention epochs.

    **Trace exemplars** (ISSUE 15): ``observe(value, trace_id=...)``
    retains the LAST exemplified observation per bucket — (trace id,
    value, unix ts) — and the render appends it to that bucket's series
    line in OpenMetrics-style ``# {trace_id="..."} value ts`` syntax, so
    any latency bucket on ``/metrics`` points at one concrete trace a
    collector (or ``flightrec.stitch_by_trace``) can resolve. Bounded by
    construction: one exemplar per bucket, newest wins.
    """

    DEFAULT_BUCKETS = (0.01, 0.05, 0.1, 0.5, 1, 2.5, 5, 10, 30, 60, 120, 300, 600)
    WINDOW = 10000

    def __init__(self, name: str, help_: str, buckets=DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._sum = 0.0
        self._total = 0
        self._lock = threading.Lock()
        # exact sliding window for quantile queries (deque drops oldest)
        self._samples = deque(maxlen=self.WINDOW)
        #: bucket index -> (trace_id, observed value, unix ts); the +Inf
        #: bucket is index len(self.buckets)
        self._exemplars: Dict[int, Tuple[str, float, float]] = {}

    def observe(self, value: float, trace_id: Optional[str] = None) -> None:
        with self._lock:
            self._sum += value
            self._total += 1
            self._samples.append(value)
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    if trace_id:
                        self._exemplars[i] = (trace_id, value, time.time())
                    return
            self._counts[-1] += 1
            if trace_id:
                self._exemplars[len(self.buckets)] = (
                    trace_id, value, time.time()
                )

    def exemplars(self) -> List[Dict[str, object]]:
        """The retained per-bucket exemplars, ``le`` order — what the
        incident packet builder (watchdog.py) harvests when this
        histogram's windowed stats go anomalous."""
        with self._lock:
            items = sorted(self._exemplars.items())
        out: List[Dict[str, object]] = []
        for i, (tid, value, ts) in items:
            le = ("+Inf" if i == len(self.buckets)
                  else _fmt(self.buckets[i]))
            out.append({"le": le, "trace_id": tid,
                        "value": value, "ts": ts})
        return out

    def quantile(self, q: float) -> Optional[float]:
        """q-quantile over the last ``WINDOW`` observations (exact)."""
        with self._lock:
            if not self._samples:
                return None
            s = sorted(self._samples)
            idx = min(len(s) - 1, max(0, int(q * len(s))))
            return s[idx]

    @property
    def count(self) -> int:
        return self._total

    def snapshot(self) -> dict:
        """Cumulative buckets + sum/count as plain data — for JSON
        artifacts (simlab's throttle/lag deltas) where scraping the
        text exposition back out of render() would be silly."""
        with self._lock:
            cum = 0
            buckets = {}
            for i, b in enumerate(self.buckets):
                cum += self._counts[i]
                buckets[_fmt(b)] = cum
            cum += self._counts[-1]
            buckets["+Inf"] = cum
            return {
                "buckets": buckets,
                "sum": round(self._sum, 6),
                "count": self._total,
            }

    def render_series(self, name: str, label_prefix: str = "") -> List[str]:
        """Exposition series lines only (no HELP/TYPE). ``label_prefix`` is
        a ``key="value",``-style fragment prepended inside every brace set
        (used by HistogramVec for its family label). Bucket lines carry
        their retained exemplar as an OpenMetrics-style
        ``# {trace_id="..."} value ts`` suffix."""
        suffix = "{" + label_prefix.rstrip(",") + "}" if label_prefix else ""
        out = []
        with self._lock:
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[i]
                out.append(
                    f'{name}_bucket{{{label_prefix}le="{_fmt(b)}"}} {cum}'
                    + _render_exemplar(self._exemplars.get(i))
                )
            cum += self._counts[-1]
            out.append(
                f'{name}_bucket{{{label_prefix}le="+Inf"}} {cum}'
                + _render_exemplar(
                    self._exemplars.get(len(self.buckets)))
            )
            out.append(f"{name}_sum{suffix} {_fmt(self._sum)}")
            out.append(f"{name}_count{suffix} {self._total}")
        return out

    def render(self) -> List[str]:
        return [
            f"# HELP {self.name} {self.help}",
            f"# TYPE {self.name} histogram",
        ] + self.render_series(self.name)


def kube_throttle_wait_histogram() -> Histogram:
    """The one definition of ``tpu_cc_kube_throttle_wait_seconds``
    (client-side flow-control wait per API request). Both controllers
    expose this series; a shared factory keeps name/help/buckets
    identical by construction — two differently-bucketed expositions
    under one metric name would corrupt aggregation."""
    return Histogram(
        "tpu_cc_kube_throttle_wait_seconds",
        "Client-side flow-control wait per API request (QPS token "
        "bucket; zero = no throttling)",
        buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5, 30),
    )


def watch_pump_lag_histogram() -> Histogram:
    """The one definition of ``tpu_cc_watch_pump_lag_seconds`` — the
    delay between a desired-label write landing on the API server and
    a watch pump delivering it to the consumer's mailbox. simlab's
    fleet-scale artifact reports this distribution; any future live
    pump exposing it on /metrics must build the histogram here so the
    name/buckets stay identical by construction (the
    kube_throttle_wait_histogram rule)."""
    return Histogram(
        "tpu_cc_watch_pump_lag_seconds",
        "Watch-pump delivery lag: desired-label commit to mailbox "
        "delivery (one shared stream fanning out to N consumers)",
        buckets=(0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 15),
    )


def wire_throttle_observer(kube, hist: Histogram) -> None:
    """Attach ``hist`` to the client's flow-control waits when the
    client supports it (HttpKubeClient does; fakes don't need to)."""
    if hasattr(kube, "add_throttle_observer"):
        kube.add_throttle_observer(hist.observe)


def kube_queue_rejected_counter() -> Counter:
    """The one definition of ``tpu_cc_kube_queue_rejected_total`` —
    writes refused at the aio core's backlog admission gate
    (``TPU_CC_KUBE_QUEUE``, docs/io.md). A nonzero rate is the honest
    overload signal the unbounded backlog used to hide: the control
    plane is saturated and callers are being told so with a 429
    instead of an ever-growing queue (ROADMAP item 3)."""
    return Counter(
        "tpu_cc_kube_queue_rejected_total",
        "Kube writes rejected at the backlog admission gate "
        "(TPU_CC_KUBE_QUEUE bound reached, or the queue wait outlived "
        "the request deadline)",
    )


def wire_queue_reject_observer(kube, counter: Counter) -> None:
    """Attach ``counter`` to the client's admission-gate rejections
    when the client supports it (the aio core and its sync facade do;
    the sync client and fakes have no admission queue)."""
    if hasattr(kube, "add_queue_reject_observer"):
        kube.add_queue_reject_observer(counter.inc)


def registered_metrics(obj: object) -> List[object]:
    """Every metric-primitive attribute of a metric-set object, in
    definition (``__init__`` assignment) order — the registry
    :func:`render_metric_set` renders. Reflection, not a hand list:
    a metric you can construct is a metric you expose; forgetting to
    add it to a render list is no longer a possible bug
    (tests/test_config_obs.py pins this for every metric set)."""
    return [
        v for v in vars(obj).values()
        if isinstance(v, (Counter, Gauge, Histogram, HistogramVec))
    ]


def render_metric_set(obj: object) -> str:
    """Full Prometheus text exposition of every metric attribute of
    ``obj`` — the one render path shared by the agent's Metrics and
    both controllers' metric sets."""
    lines: List[str] = []
    for m in registered_metrics(obj):
        lines.extend(m.render())  # type: ignore[attr-defined]
    return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


def _render_exemplar(
    ex: "Optional[Tuple[str, float, float]]",
) -> str:
    """One bucket line's exemplar suffix: `` # {trace_id="..."} value
    ts`` (empty string when the bucket holds none)."""
    if ex is None:
        return ""
    tid, value, ts = ex
    return f' # {{trace_id="{tid}"}} {_fmt(value)} {ts:.3f}'


def _labels(names: Tuple[str, ...], values: Tuple[str, ...]) -> str:
    if not names:
        return ""
    pairs = ",".join(f'{n}="{v}"' for n, v in zip(names, values))
    return "{" + pairs + "}"


class HistogramVec:
    """A histogram family keyed by one label (bounded cardinality: callers
    must pass values from a closed vocabulary, e.g. trace.PHASES)."""

    def __init__(self, name: str, help_: str, label_name: str,
                 buckets=Histogram.DEFAULT_BUCKETS):
        self.name, self.help = name, help_
        self.label_name = label_name
        self.buckets = buckets
        self._children: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def labels(self, value: str) -> Histogram:
        with self._lock:
            h = self._children.get(value)
            if h is None:
                # bare family name: the vec's render attaches the label
                h = self._children[value] = Histogram(
                    self.name, self.help, self.buckets
                )
            return h

    def observe(self, label_value: str, value: float,
                trace_id: Optional[str] = None) -> None:
        self.labels(label_value).observe(value, trace_id=trace_id)

    def exemplars(self) -> Dict[str, List[Dict[str, object]]]:
        """Per-child exemplars keyed by the family label's value."""
        with self._lock:
            children = sorted(self._children.items())
        out: Dict[str, List[Dict[str, object]]] = {}
        for label_value, h in children:
            ex = h.exemplars()
            if ex:
                out[label_value] = ex
        return out

    def render(self) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        with self._lock:
            children = sorted(self._children.items())
        for label_value, h in children:
            out.extend(
                h.render_series(self.name, f'{self.label_name}="{label_value}",')
            )
        return out


class Metrics:
    """The agent's metric set (the BASELINE reconcile-latency histogram is
    ``reconcile_duration_seconds``)."""

    def __init__(self):
        self.reconciles_total = Counter(
            "tpu_cc_reconciles_total",
            "Mode reconciles attempted, by outcome",
            ("outcome",),
        )
        self.reconcile_duration = Histogram(
            "tpu_cc_reconcile_duration_seconds",
            "Wall-clock duration of one mode reconcile",
        )
        self.watch_errors_total = Counter(
            "tpu_cc_watch_errors_total", "Node watch stream errors"
        )
        self.current_mode = Gauge(
            "tpu_cc_mode_info", "Current observed CC mode (1 = active)", ("mode",)
        )
        self.coalesced_total = Counter(
            "tpu_cc_coalesced_updates_total",
            "Label updates absorbed by coalescing without a reconcile",
        )
        self.events_emitted_total = Counter(
            "tpu_cc_events_emitted_total",
            "Reconcile-outcome Events delivered to the API server",
        )
        self.events_dropped_total = Counter(
            "tpu_cc_events_dropped_total",
            "Reconcile-outcome Events dropped on recorder-queue overflow",
        )
        self.repairs_total = Counter(
            "tpu_cc_repairs_total",
            "Self-repair retries of a failed reconcile (half-flipped-slice "
            "healing included)",
        )
        self.phase_duration = HistogramVec(
            "tpu_cc_phase_duration_seconds",
            "Wall-clock duration of one reconcile phase (trace span)",
            "phase",
        )
        # coalescing publish core (k8s.batch, ISSUE 6): the loss
        # accounting that keeps "only the newest generation is sent"
        # honest — every superseded, retried, and dropped publication
        # is visible here, never silent
        self.publications_coalesced_total = Counter(
            "tpu_cc_publications_coalesced_total",
            "Evidence/doctor publications superseded by a newer "
            "generation before being sent (coalescing by design)",
            ("kind",),
        )
        self.publish_retries_total = Counter(
            "tpu_cc_publish_retries_total",
            "Failed coalescing-publish flush attempts awaiting backoff "
            "retry",
        )
        self.publications_dropped_total = Counter(
            "tpu_cc_publications_dropped_total",
            "Publications dropped after exhausting the flush retry "
            "budget (the owner's generation bookkeeping republishes)",
            ("kind",),
        )

    def observe_span(self, span) -> None:
        """Trace sink: fold completed spans into the per-phase histogram
        — the span's trace id rides along as the bucket's exemplar, so
        a slow phase on /metrics names a concrete trace."""
        self.phase_duration.observe(span.name, span.dur_s,
                                    trace_id=span.trace_id)

    def set_current_mode(self, mode: str) -> None:
        for m in OBSERVED_MODE_VALUES:
            self.current_mode.set(1.0 if m == mode else 0.0, m)

    def render(self) -> str:
        # reflection over every metric attribute (registered_metrics):
        # a forgotten hand-list entry used to make a metric vanish
        # silently from /metrics
        return render_metric_set(self)


# --------------------------------------------------------------------------
# exposition-format validation
# --------------------------------------------------------------------------

_METRIC_NAME_RE = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>.*)\})?"
    r" (?P<value>[^ ]+)$"
)
_LABEL_RE = re.compile(
    r'(?P<key>[a-zA-Z_][a-zA-Z0-9_]*)="(?P<value>(?:[^"\\]|\\["\\n])*)"'
)
#: OpenMetrics-style exemplar suffix on a series line:
#: `` # {labels} value [ts]``. Anchored at end of line; anything
#: ``# {``-shaped that does NOT match falls through to the sample
#: regex, which rejects the whole line (malformed exemplar = invalid).
_EXEMPLAR_RE = re.compile(
    r" # \{(?P<labels>[^{}]*)\} (?P<value>[^ ]+)(?: (?P<ts>[^ ]+))?$"
)


def split_exemplar(line: str) -> "Tuple[str, Optional[re.Match]]":
    """Split a series line into (sample part, exemplar match or None).
    The one splitter shared by the validator and the fleet-observatory
    parse path, so both always agree on where a sample ends."""
    m = _EXEMPLAR_RE.search(line)
    if m is None:
        return line, None
    return line[: m.start()], m


def _base_name(name: str) -> str:
    """Histogram series collapse onto their family name."""
    for suffix in ("_bucket", "_sum", "_count"):
        if name.endswith(suffix):
            return name[: -len(suffix)]
    return name


def validate_exposition(text: str) -> List[str]:
    """Strict structural check of a Prometheus text-format exposition;
    returns the list of problems (empty = valid). The bug classes it
    exists for: duplicate HELP/TYPE (two metric sets both declaring a
    shared family), broken label escaping (a raw quote/newline in a
    label value splits the line), duplicate series (same name+labels
    twice — undefined scrape behavior), and non-monotone histogram
    buckets (cumulative counts must never decrease with rising ``le``
    and ``+Inf`` must equal ``_count``). CI runs this against every
    live /metrics surface in the process smoke; the unit tests run it
    against each metric set's render.

    **Exemplar grammar** (ISSUE 15 satellite): a histogram bucket line
    may carry one OpenMetrics-style ``# {trace_id="..."} value ts``
    suffix. Accepted only there — an exemplar on any non-bucket line
    is a problem, as are malformed/unescaped exemplar labels, a
    non-numeric exemplar value/timestamp, an exemplar whose value
    exceeds its bucket's ``le`` bound, and an exemplar on a bucket
    whose cumulative count is 0 (it claims an observation that never
    happened)."""
    problems: List[str] = []
    helps: Dict[str, int] = {}
    types: Dict[str, str] = {}
    series_seen: Dict[Tuple[str, str], int] = {}
    # (family, non-le labelset) -> [(le, cumulative)]
    buckets: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
    counts: Dict[Tuple[str, str], float] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line:
            continue
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            kind = line[2:6]
            rest = line[7:]
            name = rest.split(" ", 1)[0]
            if not _METRIC_NAME_RE.fullmatch(name):
                problems.append(f"line {i}: bad metric name {name!r}")
                continue
            if kind == "HELP":
                if name in helps:
                    problems.append(
                        f"line {i}: duplicate HELP for {name} "
                        f"(first at line {helps[name]})"
                    )
                helps[name] = i
            else:
                mtype = rest.split(" ", 1)[1] if " " in rest else ""
                if name in types:
                    problems.append(f"line {i}: duplicate TYPE for {name}")
                if mtype not in ("counter", "gauge", "histogram",
                                 "summary", "untyped"):
                    problems.append(
                        f"line {i}: unknown TYPE {mtype!r} for {name}")
                types[name] = mtype
            continue
        if line.startswith("#"):
            continue  # plain comment
        sample_part, exemplar = split_exemplar(line)
        m = _SAMPLE_RE.match(sample_part)
        if m is None:
            problems.append(f"line {i}: unparseable sample {line!r}")
            continue
        name, raw_labels = m.group("name"), m.group("labels")
        try:
            value_f: Optional[float] = float(m.group("value"))
        except ValueError:
            value_f = None
            problems.append(f"line {i}: non-numeric value in {line!r}")
        labels: Dict[str, str] = {}
        if raw_labels:
            for lm in _LABEL_RE.finditer(raw_labels):
                labels[lm.group("key")] = lm.group("value")
            # whatever the pair regex didn't consume must be separators
            leftover = _LABEL_RE.sub(
                "", raw_labels).replace(",", "").strip()
            if leftover or (not labels and raw_labels):
                problems.append(
                    f"line {i}: malformed/unescaped labels {raw_labels!r}"
                )
        family = _base_name(name)
        declared = types.get(family) or types.get(name)
        if declared is None:
            problems.append(
                f"line {i}: sample {name} precedes/lacks its TYPE")
        non_le = ",".join(
            f"{k}={v}" for k, v in sorted(labels.items()) if k != "le"
        )
        key = (name, ",".join(
            f"{k}={v}" for k, v in sorted(labels.items())))
        if key in series_seen:
            problems.append(
                f"line {i}: duplicate series {name}{{{key[1]}}} "
                f"(first at line {series_seen[key]})"
            )
        series_seen[key] = i
        if exemplar is not None:
            if not (name.endswith("_bucket") and "le" in labels):
                problems.append(
                    f"line {i}: exemplar on a non-bucket line ({name})"
                )
            else:
                raw_ex = exemplar.group("labels")
                ex_labels: Dict[str, str] = {}
                for lm in _LABEL_RE.finditer(raw_ex):
                    ex_labels[lm.group("key")] = lm.group("value")
                leftover = _LABEL_RE.sub(
                    "", raw_ex).replace(",", "").strip()
                if leftover or (raw_ex and not ex_labels):
                    problems.append(
                        f"line {i}: malformed/unescaped exemplar "
                        f"labels {raw_ex!r}"
                    )
                try:
                    ex_value: Optional[float] = float(
                        exemplar.group("value"))
                except ValueError:
                    ex_value = None
                    problems.append(
                        f"line {i}: non-numeric exemplar value "
                        f"{exemplar.group('value')!r}"
                    )
                ts_raw = exemplar.group("ts")
                if ts_raw is not None:
                    try:
                        float(ts_raw)
                    except ValueError:
                        problems.append(
                            f"line {i}: non-numeric exemplar "
                            f"timestamp {ts_raw!r}"
                        )
                if value_f == 0:
                    problems.append(
                        f"line {i}: exemplar on an empty bucket "
                        "(cumulative count 0 — no observation to "
                        "exemplify)"
                    )
                if ex_value is not None and labels["le"] != "+Inf":
                    try:
                        le_bound: Optional[float] = float(labels["le"])
                    except ValueError:
                        le_bound = None  # reported by the bucket pass
                    if le_bound is not None and ex_value > le_bound:
                        problems.append(
                            f"line {i}: exemplar value {ex_value} "
                            f"above its bucket bound le={labels['le']}"
                        )
        if value_f is None:
            continue  # already reported; nothing numeric to account
        if name.endswith("_bucket") and "le" in labels:
            # hostile input by definition here — a bad le is a problem
            # entry, never a crash (the validator's whole contract)
            if labels["le"] == "+Inf":
                le = float("inf")
            else:
                try:
                    le = float(labels["le"])
                except ValueError:
                    problems.append(
                        f"line {i}: non-numeric le {labels['le']!r}")
                    continue
            buckets.setdefault((family, non_le), []).append((le, value_f))
        elif name.endswith("_count") and types.get(family) == "histogram":
            counts[(family, non_le)] = value_f
    for (family, labelset), seq in buckets.items():
        cum = None
        for le, value in seq:  # render order == le order by contract
            if cum is not None and value < cum:
                problems.append(
                    f"{family}{{{labelset}}}: bucket counts decrease "
                    f"at le={le} ({value} < {cum})"
                )
            cum = value
        if seq and seq[-1][0] != float("inf"):
            problems.append(f"{family}{{{labelset}}}: no +Inf bucket")
        total = counts.get((family, labelset))
        if seq and total is not None and seq[-1][1] != total:
            problems.append(
                f"{family}{{{labelset}}}: +Inf bucket {seq[-1][1]} != "
                f"_count {total}"
            )
    return problems


# --------------------------------------------------------------------------
# health/metrics HTTP server
# --------------------------------------------------------------------------


#: A route handler: () -> (status_code, body_bytes, content_type).
RouteHandler = "Callable[[], Tuple[int, bytes, str]]"


class RouteServer:
    """Minimal threaded HTTP GET server over a route table — the one
    serving scaffold shared by the agent's HealthServer and the fleet
    controller (exact-path match, HTTP/1.1 + Content-Length, silent
    access log, idempotent stop).

    Query strings: the path is matched WITHOUT its ``?query`` part; a
    handler that declares a parameter (``def h(query)``) receives the
    parsed query as a ``{key: last value}`` dict, zero-arg handlers are
    called as before — existing routes need no change to coexist with
    filtered ones like ``/debug/timeseries?metric=<prefix>``."""

    def __init__(self, port: int = 0, name: str = "http-server"):
        #: path -> (handler, wants_query)
        self._routes: Dict[str, Tuple[object, bool]] = {}
        self._name = name
        self._port = port
        self.httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self._stop_lock = threading.Lock()  # stop() may race from 2 threads

    def add_route(self, path: str, fn) -> None:
        import inspect

        try:
            wants_query = bool(inspect.signature(fn).parameters)
        except (TypeError, ValueError):
            wants_query = False
        self._routes[path] = (fn, wants_query)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1] if self.httpd else self._port

    def start(self):
        """Bind and serve. Binding is deferred to here so constructing a
        server object never takes the port (raises OSError if taken)."""
        outer = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # pragma: no cover
                pass

            def do_GET(self):
                path, _, rawq = self.path.partition("?")
                route = outer._routes.get(path)
                if route is None:
                    code, body, ctype = 404, b"not found", "text/plain"
                else:
                    fn, wants_query = route
                    try:
                        if wants_query:
                            from urllib.parse import parse_qs

                            query = {
                                k: v[-1]
                                for k, v in parse_qs(rawq).items()
                            }
                            code, body, ctype = fn(query)
                        else:
                            code, body, ctype = fn()
                    except Exception:  # degrade to 500, not a dropped socket
                        logging.getLogger(outer._name).exception(
                            "route handler %s failed", self.path
                        )
                        # generic body: the server is unauthenticated on
                        # 0.0.0.0 — exception detail stays in the log
                        code, body, ctype = 500, b"internal error", "text/plain"
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("0.0.0.0", self._port), Handler)
        self.httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name=self._name, daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        with self._stop_lock:
            httpd, self.httpd = self.httpd, None
            thread, self._thread = self._thread, None
        if httpd is not None:
            httpd.shutdown()
            httpd.server_close()
        if thread is not None:
            thread.join(timeout=5)


class HealthServer(RouteServer):
    def __init__(self, metrics: Metrics, port: int = 0, tracer=None,
                 flightrec=None, tsring=None, watchdog=None):
        super().__init__(port, name="health-server")
        self.metrics = metrics
        self.tracer = tracer
        self.flightrec = flightrec
        self.tsring = tsring
        self.watchdog = watchdog
        self.live = True
        self.ready = False
        self.add_route("/healthz", self._healthz)
        self.add_route("/readyz", self._readyz)
        self.add_route("/metrics", self._metrics)
        self.add_route("/debug/traces", self._traces)
        self.add_route("/debug/flightrec", self._flightrec)
        self.add_route("/debug/timeseries", self._timeseries)
        self.add_route("/debug/incidents", self._incidents)

    def _healthz(self):
        return ((200, b"ok", "text/plain") if self.live
                else (503, b"unhealthy", "text/plain"))

    def _readyz(self):
        return ((200, b"ready", "text/plain") if self.ready
                else (503, b"not ready", "text/plain"))

    def _metrics(self):
        # exemplar-capable exposition: OpenMetrics content type (the
        # classic text/plain format has no exemplar grammar)
        return (200, self.metrics.render().encode(),
                OPENMETRICS_CONTENT_TYPE)

    def _traces(self):
        if self.tracer is None:
            return 404, b"tracing not wired", "text/plain"
        body = json.dumps(self.tracer.recent(), indent=1).encode()
        return 200, body, "application/json"

    def _flightrec(self):
        """On-demand black-box snapshot (no file written): the live
        equivalent of the failure/SIGTERM dump, for a stuck-but-alive
        agent an operator is staring at."""
        if self.flightrec is None:
            return 404, b"flight recorder not wired", "text/plain"
        body = json.dumps(
            self.flightrec.snapshot("debug_get"), indent=1,
            sort_keys=True,
        ).encode()
        return 200, body, "application/json"

    def _timeseries(self, query=None):
        """The in-process time-series ring (tsring.py, ISSUE 9): the
        windowed rates/quantiles plus the raw ring points — what two
        hand-diffed /metrics scrapes used to approximate.
        ``?metric=<prefix>`` (ISSUE 15 satellite) narrows the document
        to matching metric families, so an operator — or the incident
        packet builder — pulls one series without the whole ring."""
        if self.tsring is None:
            return 404, b"timeseries ring not wired", "text/plain"
        return self.tsring.route(
            metric_prefix=(query or {}).get("metric"))

    def _incidents(self):
        """The anomaly watchdog's incident packets (watchdog.py, ISSUE
        15): the autopsy artifacts an operator reads AFTER the page —
        anomalous series + window stats, exemplar trace ids, a profile
        captured while the anomaly was live, and the flight-recorder
        dump path."""
        if self.watchdog is None:
            return 404, b"watchdog not wired", "text/plain"
        return self.watchdog.route()


def create_readiness_file(path: str) -> None:
    """Touch the readiness file after the initial reconcile (reference
    main.py:67-79); the validation framework keys off its presence."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(str(time.time()) + "\n")


def remove_readiness_file(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass
