"""Fleet observatory — scrape, validate, merge, and judge (ISSUE 9).

Every process exposes ``/metrics``; nobody *watches* the fleet. This
module is the controller-side layer that does: it scrapes N replica
expositions (in-process render callables in simlab, HTTP URLs in the
kind smoke), validates each scrape with :func:`obs.validate_exposition`
(an invalid exposition is counted and skipped, never merged), merges
the series fleet-wide (counters/gauges sum; histogram buckets merge
cumulatively with per-input carry-forward, so the aggregate stays
monotone even across bucket-layout drift), re-validates the *merged*
exposition (a merge bug — duplicate series, non-monotone buckets —
must fail as loudly as a replica bug), and feeds a declarative **SLO
engine**.

Objectives live in ``deployments/slo.yaml`` (schema:
:func:`validate_slo_doc`, enforced in the lint tier by ccaudit's
slo pass). Two kinds:

- ``error_ratio``: bad events / total events from counter families
  (e.g. failed reconciles per reconcile, dropped publications per
  reconcile);
- ``latency``: the fraction of histogram observations above
  ``threshold_s`` (good = cumulative count at the largest bucket bound
  <= threshold).

Each objective is judged by **multi-window burn rates** (the
fast/slow-window pattern): ``burn = (bad/total over window) / (1 -
target)``. A burn of 1.0 consumes budget exactly at the sustainable
rate; the alert fires only when BOTH the fast and the slow window
exceed ``burn_threshold`` — fast alone is a blip, slow alone is old
news. Firing emits ``tpu_cc_slo_burn_rate`` / budget gauges, a fleet
``problems`` line, and a flight-recorder ``slo_burn`` event — the
degradation is visible while the convergence gate would still pass.

Budget remaining is computed over the observer's whole retained span:
1 - (observed bad ratio / allowed bad ratio), clamped to [0, 1].
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time
import urllib.request
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from tpu_cc_manager_torch.obs import (
    Counter, Gauge, _LABEL_RE, _SAMPLE_RE, _fmt as _num,
    split_exemplar, validate_exposition,
)
from tpu_cc_manager_torch.tsring import (
    Sample, Snapshot, _le_value, counter_delta, window_pair,
)

log = logging.getLogger("tpu-cc-manager.fleetobs")

#: where the objectives live, relative to the repo root
SLO_RELPATH = "deployments/slo.yaml"

#: objective kinds the schema accepts
SLO_KINDS = ("error_ratio", "latency")

#: a scrape source: a callable returning exposition text (in-process)
#: or an http(s) URL string
Source = Union[str, Callable[[], str]]


class SloError(ValueError):
    """An SLO document failed validation."""


# --------------------------------------------------------------- parsing


def parse_exposition(
    text: str,
) -> Tuple[Snapshot, Dict[str, str]]:
    """Parse a (pre-validated) Prometheus text exposition into the
    tsring :data:`Snapshot` shape plus the HELP text per family (the
    merged render re-emits it). Histogram families are reassembled
    from their ``_bucket``/``_sum``/``_count`` series keyed by the
    non-``le`` labelset.

    **Exemplars are STRIPPED here, deterministically** (ISSUE 15
    satellite, the pinned merge policy): a per-replica exemplar names
    ONE process's trace — summing N replicas' buckets has no honest
    single exemplar to carry, and forwarding an arbitrary replica's
    would point a fleet-level bucket at a non-representative trace.
    The merged ``/fleet/metrics`` therefore never emits exemplar
    suffixes; per-trace evidence stays on the replica surfaces (their
    own ``/metrics``) and in the watchdog's incident packets, which
    harvest exemplars from the live per-replica histograms."""
    snap: Snapshot = {}
    helps: Dict[str, str] = {}
    types: Dict[str, str] = {}
    for line in text.splitlines():
        if line.startswith("# HELP "):
            name, _, help_ = line[7:].partition(" ")
            helps[name] = help_
            continue
        if line.startswith("# TYPE "):
            name, _, mtype = line[7:].partition(" ")
            types[name] = mtype
            continue
        if not line or line.startswith("#"):
            continue
        line, _exemplar = split_exemplar(line)  # strip: merge policy
        m = _SAMPLE_RE.match(line)
        if m is None:
            continue  # validate_exposition already reported it
        name, raw_labels = m.group("name"), m.group("labels")
        try:
            value = float(m.group("value"))
        except ValueError:
            continue
        labels: Dict[str, str] = {}
        if raw_labels:
            for lm in _LABEL_RE.finditer(raw_labels):
                labels[lm.group("key")] = lm.group("value")
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and types.get(
                    name[: -len(suffix)]) == "histogram":
                family = name[: -len(suffix)]
                break
        mtype = types.get(family, "untyped")
        if mtype == "histogram":
            fam = snap.setdefault(family, {"type": "histogram", "hist": {}})
            key = ",".join(
                f'{k}="{v}"' for k, v in sorted(labels.items())
                if k != "le"
            )
            hist = fam["hist"].setdefault(
                key, {"buckets": {}, "sum": 0.0, "count": 0}
            )
            if name.endswith("_bucket") and "le" in labels:
                hist["buckets"][labels["le"]] = value
            elif name.endswith("_sum"):
                hist["sum"] = value
            elif name.endswith("_count"):
                hist["count"] = value
        else:
            kind = "counter" if mtype == "counter" else "gauge"
            fam = snap.setdefault(family, {"type": kind, "series": {}})
            key = ",".join(
                f'{k}="{v}"' for k, v in sorted(labels.items())
            )
            fam["series"][key] = value
    return snap, helps


def merge_snapshots(snaps: List[Snapshot]) -> Snapshot:
    """Merge N per-replica snapshots into one fleet snapshot: series
    values sum (counters: fleet totals; gauges: fleet-wide counts);
    histogram buckets merge by ``le`` union with per-input
    carry-forward (an input missing a bound contributes its cumulative
    count at its next-lower bound), which keeps the merged cumulative
    sequence monotone by construction."""
    out: Snapshot = {}
    for snap in snaps:
        for name, fam in snap.items():
            if fam["type"] == "histogram":
                ofam = out.setdefault(
                    name, {"type": "histogram", "hist": {}})
                if "hist" not in ofam:
                    # type drift across replicas (one exposes a
                    # counter, another a histogram, under one name):
                    # first seen wins, the drifted input is skipped —
                    # a mixed merge would be meaningless either way
                    continue
                for key, hist in fam["hist"].items():
                    ohist = ofam["hist"].setdefault(
                        key, {"buckets": {}, "sum": 0.0, "count": 0,
                              "_inputs": []},
                    )
                    ohist["sum"] += hist.get("sum", 0.0)
                    ohist["count"] += hist.get("count", 0)
                    ohist["_inputs"].append(hist.get("buckets") or {})
            else:
                ofam = out.setdefault(
                    name, {"type": fam["type"], "series": {}})
                if "series" not in ofam:
                    continue  # type drift: first seen wins (above)
                for key, v in fam["series"].items():
                    ofam["series"][key] = (
                        ofam["series"].get(key, 0.0) + v
                    )
    # second pass: fold each histogram's inputs over the le union
    for fam in out.values():
        if fam["type"] != "histogram":
            continue
        for hist in fam["hist"].values():
            inputs = hist.pop("_inputs", [])
            les = sorted(
                {le for b in inputs for le in b}, key=_le_value
            )
            merged: Dict[str, float] = {}
            carry = [0.0] * len(inputs)
            for le in les:
                total = 0.0
                for i, b in enumerate(inputs):
                    if le in b:
                        carry[i] = max(b[le], carry[i])
                    total += carry[i]
                merged[le] = total
            hist["buckets"] = merged
    return out


def render_snapshot(
    snap: Snapshot, helps: Optional[Dict[str, str]] = None,
) -> str:
    """Render a (merged) snapshot back to Prometheus text format —
    one HELP/TYPE per family, series sorted, buckets in ``le`` order.
    The output must itself pass :func:`obs.validate_exposition`; the
    observer re-checks that on every merge (ISSUE 9 satellite: a
    256-replica merge must not emit duplicate series or non-monotone
    buckets)."""
    helps = helps or {}
    lines: List[str] = []
    for name in sorted(snap):
        fam = snap[name]
        help_ = helps.get(name, "aggregated across fleet replicas")
        if fam["type"] == "histogram":
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} histogram")
            for key in sorted(fam["hist"]):
                hist = fam["hist"][key]
                prefix = key + "," if key else ""
                for le in sorted(hist["buckets"], key=_le_value):
                    lines.append(
                        f'{name}_bucket{{{prefix}le="{le}"}} '
                        f'{_num(hist["buckets"][le])}'
                    )
                suffix = "{" + key + "}" if key else ""
                lines.append(f"{name}_sum{suffix} {_num(hist['sum'])}")
                lines.append(
                    f"{name}_count{suffix} {_num(hist['count'])}"
                )
        else:
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {fam['type']}")
            for key in sorted(fam["series"]):
                braces = "{" + key + "}" if key else ""
                lines.append(
                    f"{name}{braces} {_num(fam['series'][key])}"
                )
    return "\n".join(lines) + "\n"



def _series_labels(key: str) -> Dict[str, str]:
    return {
        m.group("key"): m.group("value")
        for m in _LABEL_RE.finditer(key)
    }


# ------------------------------------------------------------ objectives


@dataclasses.dataclass(frozen=True)
class SloObjective:
    name: str
    kind: str  #: "error_ratio" | "latency"
    metric: str
    target: float  #: good fraction the objective promises, in (0, 1)
    fast_window_s: float
    slow_window_s: float
    burn_threshold: float
    description: str = ""
    #: error_ratio: label -> bad values; empty = every series of
    #: ``metric`` is a bad event (then ``total_metric`` is required)
    bad_labels: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
    #: error_ratio: denominator family (default: ``metric`` itself)
    total_metric: Optional[str] = None
    #: latency: observations above this bound are bad events
    threshold_s: Optional[float] = None

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def metric_refs(self) -> List[str]:
        refs = [self.metric]
        if self.total_metric:
            refs.append(self.total_metric)
        return refs


def _require(cond: bool, where: str, msg: str,
             errors: List[str]) -> bool:
    if not cond:
        errors.append(f"{where}: {msg}")
    return cond


def validate_slo_doc(doc: object) -> Tuple[List[SloObjective], List[str]]:
    """Strict schema validation of a parsed slo.yaml document ->
    (objectives, errors). Unknown keys anywhere are errors — the same
    stance the simlab scenario schema takes, and what lets the lint
    tier gate the committed file."""
    errors: List[str] = []
    objectives: List[SloObjective] = []
    if not isinstance(doc, dict):
        return [], ["slo document must be a mapping"]
    unknown = sorted(set(doc) - {"version", "objectives"})
    if unknown:
        errors.append(f"unknown top-level key(s) {unknown}")
    if doc.get("version") != 1:
        errors.append(
            f"version must be 1, got {doc.get('version')!r}"
        )
    raw = doc.get("objectives")
    if not isinstance(raw, list) or not raw:
        errors.append("objectives is required and must be a non-empty list")
        return [], errors
    seen_names = set()
    allowed = {
        "name", "description", "kind", "metric", "bad_labels",
        "total_metric", "threshold_s", "target", "windows",
        "burn_threshold",
    }
    for idx, o in enumerate(raw):
        where = f"objectives[{idx}]"
        if not isinstance(o, dict):
            errors.append(f"{where}: must be a mapping")
            continue
        unknown = sorted(set(o) - allowed)
        if unknown:
            errors.append(f"{where}: unknown key(s) {unknown}")
        name = o.get("name")
        if not _require(isinstance(name, str) and bool(name), where,
                        "name is required", errors):
            continue
        where = f"objectives[{idx}] ({name})"
        if name in seen_names:
            errors.append(f"{where}: duplicate objective name")
        seen_names.add(name)
        kind = o.get("kind")
        if not _require(kind in SLO_KINDS, where,
                        f"kind must be one of {list(SLO_KINDS)}",
                        errors):
            continue
        metric = o.get("metric")
        if not _require(isinstance(metric, str) and bool(metric),
                        where, "metric is required", errors):
            continue
        target = o.get("target")
        if not _require(
            isinstance(target, (int, float))
            and not isinstance(target, bool) and 0.0 < target < 1.0,
            where, "target must be a number in (0, 1)", errors,
        ):
            continue
        windows = o.get("windows")
        if not _require(isinstance(windows, dict), where,
                        "windows {fast_s, slow_s} is required", errors):
            continue
        unknown = sorted(set(windows) - {"fast_s", "slow_s"})
        if unknown:
            errors.append(f"{where}: windows has unknown key(s) {unknown}")
        fast = windows.get("fast_s")
        slow = windows.get("slow_s")
        ok = _require(
            isinstance(fast, (int, float)) and fast > 0
            and isinstance(slow, (int, float)) and slow > 0
            and not isinstance(fast, bool)
            and not isinstance(slow, bool),
            where, "windows.fast_s and windows.slow_s must be > 0",
            errors,
        )
        if ok and not fast < slow:
            errors.append(f"{where}: fast_s must be < slow_s")
            ok = False
        burn = o.get("burn_threshold")
        ok &= _require(
            isinstance(burn, (int, float))
            and not isinstance(burn, bool) and burn >= 1.0, where,
            "burn_threshold must be a number >= 1 (1.0 = exactly "
            "sustainable burn)", errors,
        )
        bad_labels: Tuple[Tuple[str, Tuple[str, ...]], ...] = ()
        total_metric = o.get("total_metric")
        threshold_s = o.get("threshold_s")
        if kind == "error_ratio":
            raw_bad = o.get("bad_labels")
            if raw_bad is not None:
                if not isinstance(raw_bad, dict) or not all(
                    isinstance(k, str) and isinstance(v, list)
                    and all(isinstance(x, str) for x in v)
                    for k, v in raw_bad.items()
                ):
                    errors.append(
                        f"{where}: bad_labels must map label -> "
                        "list of bad string values")
                    ok = False
                else:
                    bad_labels = tuple(
                        (k, tuple(v)) for k, v in sorted(raw_bad.items())
                    )
            if raw_bad is None and total_metric is None:
                errors.append(
                    f"{where}: error_ratio needs bad_labels (bad "
                    "subset of metric) or total_metric (metric counts "
                    "bad events, total_metric the denominator)")
                ok = False
            if total_metric is not None and not isinstance(
                    total_metric, str):
                errors.append(f"{where}: total_metric must be a string")
                ok = False
            if threshold_s is not None:
                errors.append(
                    f"{where}: threshold_s only applies to kind=latency")
                ok = False
        else:  # latency
            if not isinstance(threshold_s, (int, float)) or isinstance(
                    threshold_s, bool) or threshold_s <= 0:
                errors.append(
                    f"{where}: latency needs threshold_s > 0")
                ok = False
            if o.get("bad_labels") is not None or total_metric is not None:
                errors.append(
                    f"{where}: bad_labels/total_metric only apply to "
                    "kind=error_ratio")
                ok = False
        if not ok:
            continue
        objectives.append(SloObjective(
            name=name, kind=kind, metric=metric,
            target=float(target),
            fast_window_s=float(fast), slow_window_s=float(slow),
            burn_threshold=float(burn),
            description=str(o.get("description", "")),
            bad_labels=bad_labels,
            total_metric=total_metric,
            threshold_s=(
                float(threshold_s) if threshold_s is not None else None
            ),
        ))
    return objectives, errors


def load_slo(path: str) -> List[SloObjective]:
    """Load + validate ``slo.yaml``. Raises :class:`SloError` on any
    schema violation (the lint tier runs the same validation through
    ccaudit, so a committed file that raises here fails CI first) and
    ImportError when pyyaml is unavailable (callers degrade loudly)."""
    import yaml

    try:
        with open(path) as f:
            doc = yaml.safe_load(f)
    except OSError as e:
        raise SloError(f"cannot read {path}: {e}") from e
    except yaml.YAMLError as e:
        raise SloError(f"{path}: not valid YAML: {e}") from e
    objectives, errors = validate_slo_doc(doc)
    if errors:
        raise SloError(f"{path}: " + "; ".join(errors))
    return objectives


def default_slo_path() -> str:
    """``deployments/slo.yaml`` resolved from the package location
    (works from any cwd), overridable via ``TPU_CC_SLO_FILE``."""
    return os.environ.get("TPU_CC_SLO_FILE") or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        *SLO_RELPATH.split("/"),
    )


# --------------------------------------------------------------- metrics


class SloMetrics:
    """The observer's own metric set (rendered by reflection like
    every other set — obs.registered_metrics)."""

    def __init__(self) -> None:
        self.burn_rate = Gauge(
            "tpu_cc_slo_burn_rate",
            "Error-budget burn rate per objective and window (1.0 = "
            "burning exactly at the sustainable rate)",
            ("objective", "window"),
        )
        self.budget_remaining = Gauge(
            "tpu_cc_slo_budget_remaining",
            "Fraction of the objective's error budget left over the "
            "observer's retained span (1.0 = untouched)",
            ("objective",),
        )
        self.scrapes_total = Counter(
            "tpu_cc_fleetobs_scrapes_total",
            "Replica exposition scrapes, by outcome (invalid = "
            "failed obs.validate_exposition and was NOT merged)",
            ("outcome",),
        )
        self.aggregation_invalid_total = Counter(
            "tpu_cc_fleetobs_aggregation_invalid_total",
            "Merged fleet expositions that failed validation (a merge "
            "bug: duplicate series or non-monotone buckets)",
        )
        self.alerts_total = Counter(
            "tpu_cc_slo_alerts_total",
            "Multi-window burn-rate alerts fired, per objective",
            ("objective",),
        )

    def render(self) -> str:
        from tpu_cc_manager_torch.obs import render_metric_set

        return render_metric_set(self)


# -------------------------------------------------------------- observer


class FleetObserver:
    """Scrape N sources, merge, evaluate the SLOs, keep the history."""

    DEFAULT_INTERVAL_S = 1.0

    def __init__(
        self,
        objectives: List[SloObjective],
        *,
        name: str = "fleetobs",
        recorder: Optional[Any] = None,
        interval_s: Optional[float] = None,
        capacity: int = 512,
    ):
        if interval_s is None:
            try:
                interval_s = float(os.environ.get(
                    "TPU_CC_FLEETOBS_INTERVAL_S", "") or 0)
            except ValueError:
                interval_s = 0.0
            if interval_s <= 0:
                interval_s = self.DEFAULT_INTERVAL_S
        self.name = name
        self.objectives = list(objectives)
        self.interval_s = interval_s
        #: flight recorder the ``slo_burn`` alert events note into
        self.recorder = recorder
        self.metrics = SloMetrics()
        self._samples: "deque[Sample]" = deque(maxlen=capacity)
        self._helps: Dict[str, str] = {}
        self._lock = threading.Lock()
        #: serializes _evaluate: the runner's closing observe() racing
        #: the scrape loop must not double-fire one alert transition
        self._eval_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sources: List[Source] = []
        #: objective name -> why it can never fire (kind/metric-type
        #: mismatch observed at evaluation time) — a dead objective
        #: must be a problems line, not silence
        self._misconfigured: Dict[str, str] = {}
        #: objective name -> currently firing (multi-window rule)
        self._firing: Dict[str, bool] = {}
        #: alert log: one entry per not-firing -> firing transition
        self.alerts: List[Dict[str, Any]] = []
        #: problems from the last AGGREGATED-exposition validation
        self.aggregation_problems: List[str] = []
        #: last merged snapshot (for render())
        self._last_merged: Optional[Snapshot] = None
        #: post-sample listeners (the fleet-level anomaly watchdog,
        #: ISSUE 15): fn(samples) after every observe() pass — the
        #: fleet-merged series ride the same window machinery a
        #: per-process tsring feeds
        self._listeners: List[Callable[[List[Sample]], Any]] = []

    def add_listener(
        self, fn: Callable[[List[Sample]], Any],
    ) -> "FleetObserver":
        self._listeners.append(fn)
        return self

    def samples(self) -> List[Sample]:
        """The retained (ts, merged snapshot) history — tsring sample
        shape, so window math and the watchdog consume it as-is."""
        with self._lock:
            return list(self._samples)

    # ------------------------------------------------------------ scraping
    def _fetch(self, source: Source) -> str:
        if callable(source):
            return source()
        with urllib.request.urlopen(source, timeout=5) as r:
            return r.read().decode()

    def scrape(self, sources: List[Source]) -> Snapshot:
        """One scrape pass: fetch + validate every source, merge the
        valid ones. Invalid/unreachable sources are counted and
        skipped — one broken replica must not poison the rollup."""
        parsed: List[Snapshot] = []
        for source in sources:
            try:
                text = self._fetch(source)
            except Exception:  # ccaudit: allow-swallow(an unreachable scrape target is an expected fleet condition: counted in tpu_cc_fleetobs_scrapes_total{outcome="unreachable"} and skipped — the rollup must carry on with the replicas that answered)
                self.metrics.scrapes_total.inc("unreachable")
                continue
            problems = validate_exposition(text)
            if problems:
                self.metrics.scrapes_total.inc("invalid")
                log.warning(
                    "fleetobs: invalid exposition from %r skipped "
                    "(%d problem(s); first: %s)",
                    getattr(source, "__name__", source),
                    len(problems), problems[0],
                )
                continue
            snap, helps = parse_exposition(text)
            self._helps.update(helps)
            parsed.append(snap)
            self.metrics.scrapes_total.inc("ok")
        return merge_snapshots(parsed)

    def observe(
        self, sources: List[Source], now: Optional[float] = None,
    ) -> Snapshot:
        """Scrape, validate the AGGREGATE, record the sample, evaluate
        every objective. The merged-exposition validation is the ISSUE
        9 satellite: merging 256 replicas must yield an exposition as
        strict as any single process's."""
        merged = self.scrape(sources)
        problems = validate_exposition(
            render_snapshot(merged, self._helps)
        )
        if problems:
            self.metrics.aggregation_invalid_total.inc()
            log.warning(
                "fleetobs: MERGED exposition invalid (%d problem(s); "
                "first: %s)", len(problems), problems[0],
            )
        ts = now if now is not None else time.time()
        with self._lock:
            self.aggregation_problems = problems
            self._last_merged = merged
            self._samples.append((ts, merged))
            samples = list(self._samples)
        self._evaluate(samples, ts)
        for fn in self._listeners:
            try:
                fn(samples)
            except Exception:  # ccaudit: allow-swallow(a broken listener must cost itself, never the scrape loop; the warning names it)
                log.warning("fleetobs listener failed", exc_info=True)
        return merged

    # ---------------------------------------------------------- SLO engine
    def _bad_total(
        self, obj: SloObjective, snap: Snapshot,
    ) -> Tuple[float, float]:
        """(bad events, total events) cumulative in one snapshot."""
        fam = snap.get(obj.metric) or {}
        if fam and obj.kind == "latency" and "hist" not in fam:
            self._note_misconfigured(
                obj, f"metric {obj.metric!r} is a "
                f"{fam.get('type')}, not a histogram")
        if fam and obj.kind == "error_ratio" and "series" not in fam:
            self._note_misconfigured(
                obj, f"metric {obj.metric!r} is a histogram; "
                "error_ratio needs a counter family")
        if obj.kind == "latency":
            bad = total = 0.0
            threshold = obj.threshold_s or 0.0
            for hist in (fam.get("hist") or {}).values():
                buckets = hist.get("buckets") or {}
                count = float(hist.get("count", 0))
                good = 0.0
                for le in sorted(buckets, key=_le_value):
                    bound = _le_value(le)
                    if bound <= threshold:
                        good = max(good, buckets[le])
                total += count
                bad += max(count - good, 0.0)
            return bad, total
        bad = 0.0
        metric_total = 0.0
        bad_labels = dict(obj.bad_labels)
        for key, value in (fam.get("series") or {}).items():
            metric_total += value
            labels = _series_labels(key)
            if bad_labels:
                if all(labels.get(k) in vals
                       for k, vals in bad_labels.items()):
                    bad += value
            else:
                bad += value  # whole family counts bad events
        if obj.total_metric:
            tfam = snap.get(obj.total_metric) or {}
            if tfam and "series" not in tfam:
                self._note_misconfigured(
                    obj, f"total_metric {obj.total_metric!r} is a "
                    "histogram; the denominator must be a counter "
                    "family")
            total = sum(tfam.get("series", {}).values())
        else:
            total = metric_total
        return bad, total

    def _window_burn(
        self, obj: SloObjective, samples: List[Sample],
        window_s: float, now: float,
    ) -> float:
        pair = window_pair(samples, window_s, now=now)
        if pair is None:
            return 0.0
        (_, old_snap), (_, new_snap) = pair
        old_bad, old_total = self._bad_total(obj, old_snap)
        new_bad, new_total = self._bad_total(obj, new_snap)
        d_bad = counter_delta(old_bad, new_bad)
        d_total = counter_delta(old_total, new_total)
        if d_total <= 0:
            return 0.0
        return (d_bad / d_total) / obj.budget

    def _note_misconfigured(self, obj: SloObjective,
                            reason: str) -> None:
        """A schema-valid objective whose metric TYPE can't answer its
        kind (error_ratio over a histogram, latency over a counter)
        evaluates to a permanent 0 — the alert-that-can-never-fire
        failure class. Validation can't see types; the first evaluation
        can, so it records the finding for problems()/summary()."""
        if obj.name not in self._misconfigured:
            self._misconfigured[obj.name] = reason
            log.warning("SLO %s is DEAD: %s", obj.name, reason)

    def _evaluate(self, samples: List[Sample], now: float) -> None:
        with self._eval_lock:
            for obj in self.objectives:
                fast = self._window_burn(obj, samples, obj.fast_window_s, now)
                slow = self._window_burn(obj, samples, obj.slow_window_s, now)
                self.metrics.burn_rate.set(round(fast, 4), obj.name, "fast")
                self.metrics.burn_rate.set(round(slow, 4), obj.name, "slow")
                # budget over the whole RETAINED SPAN (first sample ->
                # latest), not the replicas' process lifetimes: the
                # counters are cumulative, so judging the raw latest
                # ratio would charge this observer for events before it
                # started watching (exactly what simlab's
                # start-after-initial-convergence exists to exclude)
                # and a single early incident would depress the gauge
                # forever on a long-lived deployment
                bad0, total0 = self._bad_total(obj, samples[0][1])
                bad1, total1 = self._bad_total(obj, samples[-1][1])
                d_bad = counter_delta(bad0, bad1)
                d_total = counter_delta(total0, total1)
                consumed = (
                    (d_bad / d_total) / obj.budget
                    if d_total > 0 else 0.0
                )
                remaining = min(max(1.0 - consumed, 0.0), 1.0)
                self.metrics.budget_remaining.set(
                    round(remaining, 4), obj.name)
                firing = (fast >= obj.burn_threshold
                          and slow >= obj.burn_threshold)
                was = self._firing.get(obj.name, False)
                self._firing[obj.name] = firing
                if firing and not was:
                    self.metrics.alerts_total.inc(obj.name)
                    entry = {
                        "at": round(now, 3),
                        "objective": obj.name,
                        "fast_burn": round(fast, 3),
                        "slow_burn": round(slow, 3),
                        "budget_remaining": round(remaining, 4),
                    }
                    with self._lock:
                        self.alerts.append(entry)
                    log.warning(
                        "SLO %s burning: fast %.1fx / slow %.1fx over the "
                        "%.1fx threshold (budget remaining %.1f%%)",
                        obj.name, fast, slow, obj.burn_threshold,
                        remaining * 100,
                    )
                    if self.recorder is not None:
                        # the alert lands in the flight-recorder dump —
                        # the black box says WHEN the budget burned
                        self.recorder.note("slo_burn", **entry)

    # ------------------------------------------------------------- reading
    def problems(self) -> List[str]:
        """Fleet ``problems`` lines for currently-burning objectives
        (joined into the fleet controller's report digest) plus any
        aggregation-validity finding."""
        out = []
        for obj in self.objectives:
            if self._firing.get(obj.name):
                fast = self.metrics.burn_rate.value(obj.name, "fast")
                remaining = self.metrics.budget_remaining.value(obj.name)
                out.append(
                    f"SLO {obj.name} burning error budget at "
                    f"{fast or 0:.1f}x the sustainable rate "
                    f"({(remaining or 0) * 100:.1f}% budget left)"
                )
        for name, reason in sorted(self._misconfigured.items()):
            out.append(
                f"SLO {name} can never fire: {reason} — fix the "
                "objective's kind or metric"
            )
        with self._lock:
            if self.aggregation_problems:
                out.append(
                    "fleet metrics aggregation invalid: "
                    f"{len(self.aggregation_problems)} problem(s); "
                    f"first: {self.aggregation_problems[0]}"
                )
        return out

    def status(self) -> Dict[str, Any]:
        """Small per-objective digest for /report."""
        out: Dict[str, Any] = {}
        for obj in self.objectives:
            out[obj.name] = {
                "burning": bool(self._firing.get(obj.name)),
                "fast_burn": self.metrics.burn_rate.value(
                    obj.name, "fast"),
                "slow_burn": self.metrics.burn_rate.value(
                    obj.name, "slow"),
                "budget_remaining": self.metrics.budget_remaining.value(
                    obj.name),
            }
        return out

    def summary(self) -> Dict[str, Any]:
        """The artifact block (simlab) / debug surface: objectives,
        alert log, scrape accounting, aggregation validity."""
        with self._lock:
            alerts = list(self.alerts)
            agg_problems = list(self.aggregation_problems)
            n_samples = len(self._samples)
        return {
            "objectives": self.status(),
            "alerts": alerts,
            "samples": n_samples,
            "scrapes": {
                outcome: self.metrics.scrapes_total.value(outcome)
                for outcome in ("ok", "invalid", "unreachable")
            },
            "aggregation_problems": agg_problems,
            "misconfigured": dict(sorted(self._misconfigured.items())),
        }

    def render(self) -> str:
        """The fleet rollup exposition: the merged replica series plus
        the observer's own SLO/scrape metrics (disjoint family names,
        so the concatenation is itself a valid exposition)."""
        with self._lock:
            merged = self._last_merged
            helps = dict(self._helps)
        body = render_snapshot(merged, helps) if merged else ""
        return body + self.metrics.render()

    # ---------------------------------------------------------------- loop
    def start(self, sources: List[Source]) -> "FleetObserver":
        """Periodic scrape loop (daemon; idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            return self
        self._sources = sources
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name=f"fleetobs-{self.name}", daemon=True,
        )
        self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.observe(self._sources)
            except Exception:  # ccaudit: allow-swallow(the scrape loop must survive any single pass failing — a malformed source or a transient socket error costs one sample, and the warning names it)
                log.warning("fleetobs observe pass failed",
                            exc_info=True)
            self._stop.wait(self.interval_s)

    def stop(self) -> None:
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=5)
