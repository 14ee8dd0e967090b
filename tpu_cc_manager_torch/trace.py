"""Reconcile tracing — per-phase spans with durable export.

The reference's only "tracing" is ``set -x`` on its bash engine
(SURVEY.md §5.1: every command echoed to the pod log, nothing structured,
nothing timed). This module is the deliberate improvement SURVEY.md §7.2
step 5 calls for: every reconcile becomes a tree of timed spans
(enumerate → plan → evict → per-device flip → reschedule), so the
wall-clock dominators the reference can only be guessed at from logs —
eviction pod-waits and device reset/boot (SURVEY.md §3.5) — are measured
per phase, per device.

Design:

- :class:`Tracer` keeps a thread-local span stack (nesting without
  explicit parent plumbing) and a bounded ring of completed spans.
  Work handed to another thread keeps its place in the tree via
  :meth:`Tracer.current_span` (capture on the submitting thread) +
  :meth:`Tracer.adopt` (re-seat on the worker) — the parallel flip
  pipeline's per-device spans nest under the reconcile exactly as the
  serial loop's did.
- Sinks observe every completed span: :class:`JsonlSink` appends one JSON
  line per span to ``CC_TRACE_FILE`` (the structured replacement for
  ``set -x``; size-capped via ``TPU_CC_TRACE_JSONL_MAX_MB``); the agent
  adds a metrics sink so ``/metrics`` exports a per-phase duration
  histogram; ``/debug/traces`` on the health server serves the ring for
  live inspection.
- Tracing is always on (it is microseconds of overhead per reconcile);
  sinks are what you opt into.
- **Cross-process propagation** (ISSUE 8): :func:`format_traceparent`
  renders an open span as a W3C-traceparent-style string
  (``00-<trace>-<span>-01``) that rides the
  ``tpu.google.com/cc.trace`` node annotation in the SAME write as the
  desired-mode label; :meth:`Tracer.adopt_remote` re-seats the parsed
  context on the consuming process's thread, so the agent's reconcile
  tree carries the controller's trace id. Span ids carry a per-tracer
  random prefix so independently-minted traces from different
  processes (or different tracers in one process) never collide when a
  collector stitches them by trace id.

The span vocabulary (``PHASES``) is intentionally closed: the per-phase
histogram's label cardinality stays bounded no matter what attrs
individual spans carry.
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Optional, Tuple

log = logging.getLogger("tpu-cc-manager.trace")

#: fixed version field of the traceparent-style context string
TRACEPARENT_VERSION = "00"

# Innermost OPEN span per thread across ALL tracer instances — the
# join key structured logging needs (obs.JsonLogFormatter): the agent,
# simlab replicas, and controllers each run their own Tracer, and a
# log record must find "the span I am inside" without knowing which
# tracer opened it. Maintained by Tracer.span/adopt/adopt_remote.
_active = threading.local()

# The same per-thread stacks, readable from OTHER threads: the sampling
# profiler (profiler.py, ISSUE 15) keys each wall-clock sample to the
# span active on the sampled thread, and a thread-local is invisible
# across threads. Each thread's stack LIST is registered here once (on
# its first span); registration and pruning happen under _registry_lock,
# while the sampler reads bare dict lookups + list[-1] — both atomic
# under the GIL, and a sampler that sees a stale entry (a reused ident
# whose new thread has not opened a span yet) reads an empty stack.
_registry_lock = threading.Lock()
_thread_stacks: Dict[int, List["Span"]] = {}
_REGISTRY_PRUNE_AT = 512


def _active_stack() -> List["Span"]:
    stack = getattr(_active, "stack", None)
    if stack is None:
        stack = _active.stack = []
        with _registry_lock:
            if len(_thread_stacks) >= _REGISTRY_PRUNE_AT:
                live = {t.ident for t in threading.enumerate()}
                for dead in [i for i in _thread_stacks
                             if i not in live]:
                    del _thread_stacks[dead]
            _thread_stacks[threading.get_ident()] = stack
    return stack


def span_on_thread(ident: int) -> Optional["Span"]:
    """The innermost open span on the thread with OS ident ``ident``
    (None when that thread is outside any span, or has never opened
    one). Sampling-grade by design: the read is lock-free and a span
    closing concurrently may still be returned for one sample — fine
    for a profiler, wrong for anything that needs a fence."""
    stack = _thread_stacks.get(ident)  # ccaudit: allow-race-lockset(sampler-grade read: dict get + list[-1] are GIL-atomic; registration is lock-guarded and a stale/racing entry costs one mis-keyed sample, never a crash)
    try:
        return stack[-1] if stack else None
    except IndexError:
        # the owning thread popped its last span between the check and
        # the index — the span just closed, so "no active span" is the
        # true answer (and an escaped IndexError would kill the armed
        # sampler thread permanently)
        return None


def active_span() -> Optional["Span"]:
    """The innermost open span on THIS thread, whichever tracer opened
    it (None at top level)."""
    stack = getattr(_active, "stack", None)
    return stack[-1] if stack else None


def current_trace_ids() -> Tuple[Optional[str], Optional[str]]:
    """(trace_id, span_id) of the active span — (None, None) outside
    any span. The one key logs and traces join on."""
    span = active_span()
    if span is None:
        return None, None
    return span.trace_id, span.span_id


class RemoteContext:
    """A parsed cross-process trace context: just the two ids
    :meth:`Tracer.adopt` needs to re-seat a remote parent."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


def format_traceparent(span: "Span") -> str:
    """Render ``span`` as the cc.trace annotation value:
    ``00-<trace>-<span>-01`` (W3C traceparent shape with this build's
    counter-style ids). Safe on an OPEN span — ids are assigned at
    creation."""
    return f"{TRACEPARENT_VERSION}-{span.trace_id}-{span.span_id}-01"


def parse_traceparent(value: Optional[str]) -> Optional[RemoteContext]:
    """Parse an annotation value back into a context; None for
    missing/garbled input (a node-writable annotation is hostile
    surface — bad context degrades to a local trace, never throws)."""
    if not value or not isinstance(value, str):
        return None
    parts = value.split("-")
    if len(parts) != 4 or parts[0] != TRACEPARENT_VERSION:
        return None
    _, trace_id, span_id, _ = parts
    if not trace_id or not span_id:
        return None
    return RemoteContext(trace_id, span_id)

#: Closed span-name vocabulary (metrics label values).
PHASES = (
    "desired_write",  # controller/driver root: desired-mode label commit
    "reconcile",    # root: one desired-mode application end to end
    "enumerate",    # device discovery
    "plan",         # divergence computation
    "slice_wait",   # slice-coordination wait for quorum commit
    "evict",        # L2 drain
    "flip",         # one device: stage + reset + wait + verify
    "stage",        # flip sub-phase: discard stale + stage domains
    "reset",        # flip sub-phase: the device reset itself
    "wait_ready",   # flip sub-phase: post-reset boot wait
    "verify",       # flip sub-phase: query-back + independent verify
    "reschedule",   # L2 restore
    "state_label",  # observed-state label publish
)


class Span:
    __slots__ = (
        "name", "trace_id", "span_id", "parent_id",
        "start_ts", "t0", "dur_s", "status", "error", "attrs",
    )

    def __init__(self, name: str, trace_id: str, span_id: str,
                 parent_id: Optional[str], attrs: Dict[str, object]):
        self.name = name
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.start_ts = time.time()
        #: monotonic start, set as the span opens (Tracer.span)
        self.t0 = 0.0
        self.dur_s: float = 0.0
        self.status = "ok"
        self.error: Optional[str] = None
        self.attrs = attrs

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "trace": self.trace_id,
            "span": self.span_id,
            "start_ts": round(self.start_ts, 6),
            "dur_s": round(self.dur_s, 6),
            "status": self.status,
        }
        if self.parent_id is not None:
            d["parent"] = self.parent_id
        if self.error is not None:
            d["error"] = self.error
        if self.attrs:
            d["attrs"] = self.attrs
        return d


class Tracer:
    """Thread-safe span recorder. One process-wide instance is enough; the
    thread-local stack keeps concurrent threads' span trees separate."""

    def __init__(self, ring_size: int = 2048):
        self._ring: deque = deque(maxlen=ring_size)
        self._sinks: List[Callable[[Span], None]] = []
        self._local = threading.local()
        self._ids = itertools.count(1)
        # random per-tracer prefix: ids minted by DIFFERENT tracers
        # (two processes, or the agent's tracer vs a controller's in
        # one simlab process) must never collide once a collector
        # stitches spans fleet-wide by trace id
        self._id_prefix = os.urandom(4).hex()
        self._lock = threading.Lock()

    # ------------------------------------------------------------- plumbing
    def _stack(self) -> List[Span]:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def _next_id(self) -> str:
        with self._lock:
            return f"{self._id_prefix}{next(self._ids):x}"

    def add_sink(self, sink: Callable[[Span], None]) -> "Tracer":
        self._sinks.append(sink)
        return self

    def remove_sink(self, sink: Callable[[Span], None]) -> None:
        """Detach a sink added with :meth:`add_sink` (no-op when
        absent). Scoped consumers of the PROCESS tracer — simlab's
        per-run controller-span collector — must detach on teardown or
        every past run's sink keeps firing."""
        try:
            self._sinks.remove(sink)
        except ValueError:
            pass

    def current_span(self) -> Optional[Span]:
        """The innermost open span on THIS thread (None at top level).
        Capture it before submitting work to another thread and hand it
        to :meth:`adopt` there — cross-thread span parenting."""
        stack = self._stack()
        return stack[-1] if stack else None

    @contextmanager
    def adopt(self, parent: Optional[Span]) -> Iterator[None]:
        """Make ``parent`` (captured via :meth:`current_span` on another
        thread) the current span for this thread while the context is
        active: spans opened inside nest under it — same trace id,
        ``parent_id=parent.span_id`` — exactly as if they ran on the
        submitting thread. The parent span object is only *read* here
        (its ids), so adopting a still-open span owned by another thread
        is safe. No-op when ``parent`` is None (untraced caller)."""
        if parent is None:
            yield
            return
        stack = self._stack()
        stack.append(parent)
        active = _active_stack()
        active.append(parent)
        try:
            yield
        finally:
            stack.pop()
            active.pop()

    @contextmanager
    def adopt_remote(
        self, context: "Optional[RemoteContext | str]"
    ) -> Iterator[None]:
        """Adopt a CROSS-PROCESS parent: ``context`` is a
        :class:`RemoteContext` or a raw traceparent annotation value.
        Spans opened inside carry the remote trace id and parent the
        remote span id — the agent's reconcile tree continues the
        controller's desired-write trace. No-op (a local root as
        before) on None or a garbled value."""
        if isinstance(context, str):
            context = parse_traceparent(context)
        if not isinstance(context, RemoteContext):
            # None, or any non-context garbage off a node annotation:
            # degrade to a local root, never throw
            yield
            return
        with self.adopt(context):  # type: ignore[arg-type]
            yield

    # --------------------------------------------------------------- spans
    @contextmanager
    def span(self, name: str, **attrs: object) -> Iterator[Span]:
        """Time a phase. Exceptions mark the span failed and propagate."""
        stack = self._stack()
        parent = stack[-1] if stack else None
        sid = self._next_id()
        s = Span(
            name,
            trace_id=parent.trace_id if parent else sid,
            span_id=sid,
            parent_id=parent.span_id if parent else None,
            attrs=attrs,
        )
        # the span keeps its monotonic start (to_dict leaves it out):
        # [t0, t0 + dur_s] lies on the clock a device trace is tied to
        t0 = s.t0 = time.monotonic()
        stack.append(s)
        active = _active_stack()
        active.append(s)
        try:
            yield s
        except BaseException as e:
            s.status = "error"
            s.error = f"{type(e).__name__}: {e}"
            raise
        finally:
            s.dur_s = time.monotonic() - t0
            stack.pop()
            active.pop()
            self._record(s)

    def _record(self, s: Span) -> None:
        with self._lock:
            self._ring.append(s)
        for sink in self._sinks:
            try:
                sink(s)
            except Exception:  # a broken sink must never break a reconcile
                log.exception("trace sink failed")

    # ------------------------------------------------------------- reading
    def recent(self, limit: int = 256) -> List[dict]:
        """Most recent completed spans, oldest first."""
        with self._lock:  # snapshot: reconcile threads append concurrently
            items = list(self._ring)
        return [s.to_dict() for s in items[-limit:]]

    def traces(self, limit: int = 16) -> List[List[dict]]:
        """Recent spans grouped by trace id, oldest trace first."""
        with self._lock:
            items = list(self._ring)
        by_trace: Dict[str, List[dict]] = {}
        for s in items:
            by_trace.setdefault(s.trace_id, []).append(s.to_dict())
        return list(by_trace.values())[-limit:]


def _jsonl_cap_from_env() -> int:
    """``TPU_CC_TRACE_JSONL_MAX_MB`` -> byte cap (0 = unbounded; a
    typo degrades to unbounded — the historical behavior — rather
    than crashing an agent at startup)."""
    try:
        mb = float(os.environ.get("TPU_CC_TRACE_JSONL_MAX_MB", "") or 0)
    except ValueError:
        return 0
    return int(mb * 1024 * 1024) if mb > 0 else 0


class JsonlSink:
    """Append one JSON line per completed span to a file — the structured
    successor of the bash engine's ``set -x`` log. Enable with
    ``CC_TRACE_FILE=/var/log/tpu-cc-trace.jsonl``.

    Size-capped (``TPU_CC_TRACE_JSONL_MAX_MB``, or ``max_bytes``): when
    appending a span would push the file past the cap, the file rotates
    to ``<path>.1`` (replacing the previous rotation) and the span
    starts the fresh file — a long-running agent holds at most ~2x the
    cap on disk instead of filling it. Every span is still EXACTLY one
    complete line in exactly one of the two files: the size check and
    the write happen under one lock, and a line is never split across
    the rotation boundary."""

    def __init__(self, path: str, max_bytes: Optional[int] = None):
        self.path = path
        self.max_bytes = (
            _jsonl_cap_from_env() if max_bytes is None else max_bytes
        )
        self.rotations = 0
        self._lock = threading.Lock()
        self._size: Optional[int] = None  # lazily stat'ed

    def _current_size(self) -> int:
        if self._size is None:
            try:
                self._size = os.path.getsize(self.path)
            except OSError:
                self._size = 0
        return self._size

    def __call__(self, span: Span) -> None:
        line = json.dumps(span.to_dict(), sort_keys=True) + "\n"
        data = len(line.encode("utf-8"))
        with self._lock:
            if (self.max_bytes
                    and self._current_size() + data > self.max_bytes
                    and self._current_size() > 0):
                try:
                    os.replace(self.path, self.path + ".1")
                    self.rotations += 1
                    # reset ONLY on success: a failed rotation leaves
                    # the full file in place, and believing it empty
                    # would let it grow by max_bytes per failed attempt
                    self._size = 0
                except OSError:
                    log.warning("trace jsonl rotation failed",
                                exc_info=True)
            with open(self.path, "a") as f:
                f.write(line)
            self._size = self._current_size() + data


_default = Tracer()


def get_tracer() -> Tracer:
    return _default


def set_tracer(tracer: Optional[Tracer]) -> None:
    """Swap the process-wide tracer (tests use this for isolation)."""
    global _default
    _default = tracer or Tracer()
