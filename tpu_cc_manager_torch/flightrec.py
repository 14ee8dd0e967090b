"""Flight recorder — the bounded per-process black box (ISSUE 8).

Metrics answer "what is the rate of X"; traces answer "where did this
reconcile's time go". What neither answers after a crash or a stuck
flip is "what were the last things this process DID, and what was the
host doing while it did them" — the reference has nothing (SURVEY.md
§5.5), and until now neither did we: a reconcile failure left a log
line and a ``failed`` label, and the r05 real-chip flip regression sat
unattributed partly because nobody recorded host contention around the
flip window (ROADMAP item 1's missing sensor).

:class:`FlightRecorder` keeps three bounded rings — recent completed
spans (wired as a tracer sink), structured events (:meth:`note`), and
host-contention samples (:meth:`sample` / :meth:`bracket`, /proc-based,
bracketing every device flip) — plus a metrics-snapshot hook. A *dump*
serializes all of it with a reason stamp into one JSON artifact:

- on **reconcile failure** (throttled — one dump per
  ``min_dump_interval_s``, a flapping device must not fill the disk);
- on **SIGTERM** (:func:`install_sigterm_dump`, chaining the previous
  handler), so the kubelet killing a wedged agent leaves the black box
  behind;
- on demand via ``GET /debug/flightrec`` on the health server (no file
  written — the snapshot IS the response body).

simlab gives every replica its own recorder and stitches the
recordings fleet-wide by trace id into the artifact's fleet timeline
(simlab/runner.py). Dump schema: docs/observability.md.

Everything here is observability: no method raises into a reconcile,
and an unreadable /proc degrades to an ``unavailable`` sample.
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Any, Callable, Dict, Iterator, List, Optional

log = logging.getLogger("tpu-cc-manager.flightrec")

#: dump schema version (tests pin the shape; bump on breaking change)
SCHEMA_VERSION = 1


def sample_host() -> Dict[str, Any]:
    """One cheap host-contention sample from /proc: load averages,
    total-CPU jiffies (delta between two samples = host-wide CPU
    pressure), this process's own utime/stime, and available memory.
    ~3 file reads, no allocation beyond the dict — cheap enough to
    bracket every flip. Returns ``{"unavailable": True}`` where /proc
    is missing (non-Linux dev box)."""
    out: Dict[str, Any] = {"at": round(time.time(), 3)}
    try:
        with open("/proc/loadavg") as f:
            parts = f.read().split()
        out["load1"], out["load5"] = float(parts[0]), float(parts[1])
        out["runnable"] = parts[3]  # "running/total" threads
        with open("/proc/stat") as f:
            cpu = f.readline().split()
        # user+nice+system+idle+iowait+irq+softirq+steal
        out["cpu_total_jiffies"] = sum(int(x) for x in cpu[1:9])
        out["cpu_idle_jiffies"] = int(cpu[4])
        with open("/proc/self/stat") as f:
            me = f.read().rsplit(")", 1)[1].split()
        # fields 14/15 (1-based, after comm): utime, stime
        out["self_utime_jiffies"] = int(me[11])
        out["self_stime_jiffies"] = int(me[12])
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    out["mem_available_kb"] = int(line.split()[1])
                    break
    except Exception:  # ccaudit: allow-swallow(observability sensor: an unreadable /proc degrades to an explicit "unavailable" sample — the degradation IS the signal, and a sampler that raises would take down the flip it brackets)
        return {"at": out["at"], "unavailable": True}
    return out


class FlightRecorder:
    """Bounded black box for one process (or one simlab replica)."""

    #: ring sizes: recent-history breadth, not archival — the JSONL
    #: trace sink is the archival surface
    SPAN_RING = 512
    EVENT_RING = 256
    SAMPLE_RING = 128

    def __init__(
        self,
        name: str = "",
        *,
        metrics: Optional[Any] = None,
        dump_dir: Optional[str] = None,
        min_dump_interval_s: float = 30.0,
        span_ring: int = SPAN_RING,
        event_ring: int = EVENT_RING,
        sample_ring: int = SAMPLE_RING,
        tsring: Optional[Any] = None,
        profiler: Optional[Any] = None,
    ):
        #: identity stamped into every dump (node name for agents,
        #: replica name in simlab)
        self.name = name
        #: object with ``.render() -> str`` (obs.Metrics and both
        #: controller metric sets) or a callable returning a dict;
        #: snapshotted at dump time, never continuously
        self._metrics = metrics
        #: optional tsring.TimeSeriesRing (ISSUE 9): dumps then carry
        #: the windowed rate/quantile history LEADING UP TO the crash,
        #: not just the instant of it (points elided — dumps stay small)
        self.tsring = tsring
        #: optional profiler.SamplingProfiler (ISSUE 15): when it holds
        #: samples at dump time (armed by an operator or the watchdog),
        #: the dump embeds the folded-stack summary — the black box
        #: then says what the interpreter was EXECUTING, not only what
        #: the process did
        self.profiler = profiler
        self.dump_dir = dump_dir or os.environ.get(
            "TPU_CC_FLIGHTREC_DIR") or None
        self.min_dump_interval_s = min_dump_interval_s
        self._spans: deque = deque(maxlen=span_ring)
        self._events: deque = deque(maxlen=event_ring)
        self._samples: deque = deque(maxlen=sample_ring)
        self._lock = threading.Lock()
        self._last_dump = 0.0  # monotonic; throttles maybe_dump
        self.dumps_total = 0
        self._dump_seq = 0

    # ------------------------------------------------------------ feeding
    def observe_span(self, span: Any) -> None:
        """Tracer sink: retain the completed span (as its dict)."""
        try:
            d = span.to_dict() if hasattr(span, "to_dict") else dict(span)
        except Exception:  # ccaudit: allow-swallow(tracer-sink contract: a sink must never raise into the reconcile that produced the span; an unserializable span is dropped from the ring, the JSONL sink still has it)
            return
        with self._lock:
            self._spans.append(d)

    def note(self, kind: str, **fields: Any) -> None:
        """Record one structured event (reconcile outcome, repair fired,
        watch error burst, ...). Never raises."""
        entry = {"at": round(time.time(), 3), "kind": kind}
        entry.update(fields)
        with self._lock:
            self._events.append(entry)

    def sample(self, tag: str,
               trace_id: Optional[str] = None) -> Dict[str, Any]:
        """Take one host-contention sample, tagged. ``trace_id``
        (ISSUE 15) joins the sample to the trace it brackets, so an
        incident reader correlates "host was loaded" with "THIS flip
        was slow" instead of eyeballing timestamps."""
        s = sample_host()
        s["tag"] = tag
        if trace_id:
            s["trace"] = trace_id
        with self._lock:
            self._samples.append(s)
        return s

    @contextmanager
    def bracket(self, tag: str,
                trace_id: Optional[str] = None) -> Iterator[None]:
        """Host samples BRACKETING a critical section — the engine
        wraps every device flip, so a slow real-chip flip carries the
        host-contention evidence ROADMAP item 1 needs (was the 4.43 s
        flip the chip, or a noisy neighbor?). The engine passes the
        flip's trace id so both samples carry the stitch key."""
        self.sample(f"{tag}:pre", trace_id=trace_id)
        try:
            yield
        finally:
            self.sample(f"{tag}:post", trace_id=trace_id)

    # ------------------------------------------------------------ reading
    def _metrics_snapshot(self) -> Any:
        m = self._metrics
        if m is None:
            return None
        try:
            if hasattr(m, "render"):
                return {"exposition": m.render()}
            if callable(m):
                return m()
        except Exception:
            log.warning("flightrec metrics snapshot failed", exc_info=True)
        return None

    def snapshot(self, reason: str = "inspect") -> Dict[str, Any]:
        """The full black-box contents as one JSON-able document (the
        dump body, and the ``/debug/flightrec`` response)."""
        with self._lock:
            spans = list(self._spans)
            events = list(self._events)
            samples = list(self._samples)
        doc = {
            "flightrec_version": SCHEMA_VERSION,
            "reason": reason,
            "at": round(time.time(), 3),
            "name": self.name,
            "spans": spans,
            "events": events,
            "host_samples": samples,
            "metrics": self._metrics_snapshot(),
        }
        if self.tsring is not None:
            try:
                doc["timeseries"] = self.tsring.to_doc(
                    include_points=False)
            except Exception:  # ccaudit: allow-swallow(black-box contract: a broken time-series ring must cost the dump one section, never the dump itself — the warning names the loss)
                log.warning("flightrec timeseries embed failed",
                            exc_info=True)
        if self.profiler is not None:
            try:
                if getattr(self.profiler, "samples_total", 0):
                    # only when something was actually sampled: an
                    # idle (never-armed) profiler must not bloat every
                    # dump with an empty section
                    doc["profile"] = self.profiler.summary()
            except Exception:  # ccaudit: allow-swallow(black-box contract: a broken profiler must cost the dump one section, never the dump itself — the warning names the loss)
                log.warning("flightrec profile embed failed",
                            exc_info=True)
        return doc

    # ------------------------------------------------------------ dumping
    def dump(self, reason: str, path: Optional[str] = None) -> Optional[str]:
        """Write one dump artifact now; returns its path, or None when
        no dump directory is configured or the write failed (logged —
        a black box must never take down what it records)."""
        if path is None:
            if not self.dump_dir:
                return None
            with self._lock:
                self._dump_seq += 1
                seq = self._dump_seq
            fname = (
                f"flightrec-{self.name or 'proc'}-{os.getpid()}-"
                f"{seq:04d}-{reason}.json"
            )
            path = os.path.join(self.dump_dir, fname)
        try:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            doc = self.snapshot(reason)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(doc, f, indent=1, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)  # a dump is whole or absent, never torn
        except Exception:
            log.warning("flight-recorder dump failed", exc_info=True)
            return None
        with self._lock:
            self.dumps_total += 1
            self._last_dump = time.monotonic()
        log.info("flight recorder dumped (%s): %s", reason, path)
        return path

    def maybe_dump(self, reason: str) -> Optional[str]:
        """Throttled dump for recurring triggers (reconcile failures):
        at most one per ``min_dump_interval_s`` — a flapping device
        must not fill the disk with near-identical dumps."""
        with self._lock:
            if (self._last_dump
                    and time.monotonic() - self._last_dump
                    < self.min_dump_interval_s):
                return None
        return self.dump(reason)


# ----------------------------------------------------- process plumbing

_default = FlightRecorder()


def get_recorder() -> FlightRecorder:
    """The process-wide recorder — what code without an injected
    recorder (one-shot CLIs, the engine's default path) records into."""
    return _default


def set_recorder(recorder: Optional[FlightRecorder]) -> None:
    """Swap the process-wide recorder (tests use this for isolation)."""
    global _default
    _default = recorder or FlightRecorder()


def install_sigterm_dump(
    recorder: FlightRecorder,
    signum: int = signal.SIGTERM,
) -> Optional[Callable[[int, Any], None]]:
    """Make SIGTERM (the kubelet's pod-stop signal) leave the black box
    behind before the process dies: dump, then CHAIN to whatever
    handler was installed before (the agent's clean-shutdown handler,
    or the default action re-raised so the exit code stays honest).
    Returns the installed handler (tests invoke it directly), or None
    when not on the main thread (embedded use — Python only allows
    signal handler installation there).

    The dump runs on a WORKER thread with a bounded join, never inline
    in the handler: signal handlers run on the main thread between
    bytecodes, and the main thread may hold the recorder's (or the
    logging module's) non-reentrant lock at delivery time — an inline
    dump would deadlock the very shutdown it instruments. If the dump
    can't finish inside the bound (a held lock, a hung disk), the
    chain proceeds without it: a missing black box must never turn a
    clean kubelet stop into a SIGKILL."""
    previous = signal.getsignal(signum)

    def handler(sig: int, frame: Any) -> None:
        t = threading.Thread(
            target=lambda: recorder.dump("sigterm"),
            daemon=True, name="flightrec-sigterm-dump",
        )
        t.start()
        t.join(timeout=5.0)
        if callable(previous):
            previous(sig, frame)
        elif previous == signal.SIG_DFL:
            # restore + re-raise: the process must still die of
            # SIGTERM (exit status and the kubelet's view stay honest)
            signal.signal(sig, signal.SIG_DFL)
            signal.raise_signal(sig)

    try:
        signal.signal(signum, handler)
    except ValueError:
        return None  # not the main thread
    return handler


def stitch_by_trace(
    recordings: List[Dict[str, Any]],
) -> Dict[str, List[Dict[str, Any]]]:
    """Group spans from many recordings (each a :meth:`snapshot` dict)
    by trace id — the fleet-timeline primitive: a controller's
    desired-write span and every replica reconcile that adopted its
    context land in one bucket, whatever process recorded them."""
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for rec in recordings:
        for span in rec.get("spans") or []:
            tid = span.get("trace")
            if not tid:
                continue
            entry = dict(span)
            if rec.get("name"):
                entry.setdefault("recorder", rec["name"])
            by_trace.setdefault(tid, []).append(entry)
    for spans in by_trace.values():
        spans.sort(key=lambda s: s.get("start_ts") or 0.0)
    return by_trace
