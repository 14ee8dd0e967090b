"""L3 — node-label watching with coalescing and resume robustness.

Takes the union of the reference's two watcher implementations
(SURVEY.md §7.2 step 4):

- from the Go agent: the **lossy coalescing** synchronization primitive
  (reference cmd/main.go:48-76). `SyncableModeConfig.get()` blocks until
  the value differs from the last one read; N rapid label flips collapse
  into one reconcile of the latest value. Intermediate modes are
  *intentionally* skippable — only the newest desired state matters.
- from the Python agent: the **watch-stream robustness** (reference
  main.py:605-689): resourceVersion resume, 300 s server-side watch
  timeout, 5 s reconnect backoff, full re-list + compare on HTTP 410,
  and a fatal threshold of 10 consecutive errors (beyond which the
  DaemonSet restart policy is the recovery mechanism).
"""

from __future__ import annotations

import copy
import json
import logging
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.k8s.client import ApiException, KubeClient

log = logging.getLogger("tpu-cc-manager.watch")

#: reference main.py:633
WATCH_TIMEOUT_S = 300
#: reference main.py:688-689
RECONNECT_BACKOFF_S = 5
#: reference main.py:102,665-673
MAX_CONSECUTIVE_ERRORS = 10

#: growth ceiling for :func:`jittered_backoff` — one failed reconnect
#: waits ~base, a long outage converges to roughly a minute between
#: attempts instead of the whole fleet knocking every 5 s
BACKOFF_CAP_S = 60.0


def jittered_backoff(base_s: float, attempt: int,
                     cap_s: float = BACKOFF_CAP_S) -> float:
    """Capped exponential backoff with multiplicative jitter: the wait
    before retry ``attempt`` (1-based; 0 is treated as 1). The fixed
    5 s reconnect pause the reference agents shipped synchronizes every
    watcher in the fleet onto the same retry cadence — after an API
    server blip, N agents reconnect in one wave, and the wave is
    exactly what a recovering server cannot absorb. Growth spreads
    attempts over time, jitter (uniform ×[0.5, 1.5)) spreads them
    across agents; every retry loop on the watch path shares this one
    arithmetic so the discipline can't drift per-loop (the ccaudit
    retry-discipline contract, docs/analysis.md §v6)."""
    growth = min(cap_s, base_s * (2 ** max(0, attempt - 1)))
    return growth * (0.5 + random.random())


class SyncableModeConfig:
    """Lossy last-value-wins mailbox (reference cmd/main.go:48-76)."""

    def __init__(self, on_coalesced: Optional[Callable[[], None]] = None):
        self._cond = threading.Condition()
        self._current: Optional[str] = None
        self._last_read: Optional[str] = None
        self._has_value = False
        self._closed = False
        self._on_coalesced = on_coalesced

    def set(self, value: Optional[str]) -> None:
        """Publish a new desired value; wakes any blocked get()
        (reference cmd/main.go:61-66 Set + Broadcast)."""
        with self._cond:
            if (
                self._has_value
                and self._current != self._last_read
                and value != self._current
            ):
                # a pending-but-unread value is being overwritten: that
                # update is absorbed by coalescing and will never reconcile
                if self._on_coalesced:
                    self._on_coalesced()
            self._current = value
            self._has_value = True
            self._cond.notify_all()

    def get(
        self, timeout: Optional[float] = None
    ) -> Tuple[bool, Optional[str]]:
        """Block until the current value differs from the last one read,
        then consume it (reference cmd/main.go:68-76).

        Returns ``(True, value)`` when a new value was consumed (value may
        be None — the label was removed), or ``(False, None)`` on
        timeout/close.
        """
        with self._cond:
            ok = self._cond.wait_for(
                lambda: self._closed
                or (self._has_value and self._current != self._last_read),
                timeout=timeout,
            )
            if not ok or self._closed:
                return False, None
            self._last_read = self._current
            return True, self._current

    def peek_pending(self) -> Tuple[bool, Optional[str]]:
        """Non-consuming peek: ``(True, value)`` when a newer value is
        waiting that differs from the last one consumed, else
        ``(False, None)``. Lets a long in-flight reconcile (the
        slice-coordination wait) notice it may have been superseded
        without disturbing the mailbox's coalescing contract — the
        caller decides whether the pending value actually *changes* the
        effective mode (label-removal can coalesce back to the same
        default)."""
        with self._cond:
            if (
                not self._closed
                and self._has_value
                and self._current != self._last_read
            ):
                return True, self._current
            return False, None

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


def stable_doctor_digest(raw: Optional[str]) -> Optional[str]:
    """Volatile-timestamp-free reduction of the doctor annotation: the
    ``{ok, fail}`` digest only, so a periodic republish that merely
    moves the verdict timestamp compares equal. Shared by the watch
    wake filter below and the planner's row fingerprint
    (plan.FleetEncoding) — the two MUST agree or watch wake-ups and
    encoding re-encodes diverge. Total over hostile node-writable
    annotations: malformed or non-dict shapes reduce to a stable value
    (the raw text) instead of throwing in a watch thread."""
    if not raw:
        return None
    try:
        d = json.loads(raw)
    except ValueError:
        return raw
    if not isinstance(d, dict):
        return raw
    return json.dumps({"ok": d.get("ok"), "fail": d.get("fail")},
                      sort_keys=True)


def node_report_fingerprint(node: dict) -> Tuple[Any, ...]:
    """Comparable digest of exactly the node state the controllers'
    reports depend on: tpu labels (desired/state/slice/doctor-ok and
    the accelerator selector), the evidence annotation, and the STABLE
    part of the doctor verdict (ok + failing checks — not its
    timestamp, or every periodic doctor publish would wake a scan that
    finds nothing new). Shared by the fleet and policy controllers'
    node-watch wake filters."""
    meta = node.get("metadata", {})
    labels = meta.get("labels") or {}
    ann = meta.get("annotations") or {}
    relevant = tuple(sorted(
        (k, v) for k, v in labels.items()
        if "tpu.google.com" in k or k == L.TPU_ACCELERATOR_LABEL
    ))
    doctor = stable_doctor_digest(ann.get(L.DOCTOR_ANNOTATION))
    return (relevant, ann.get(L.EVIDENCE_ANNOTATION), doctor)


class FingerprintWakeFilter:
    """The one report-relevance wake filter (shared by
    :func:`run_node_watch` and the informer subscriptions in
    fleet.py/policy.py): wake on DELETED or whenever a node's
    :func:`node_report_fingerprint` changes — a periodic
    doctor-republish that only moves its timestamp must not wake a
    scan that finds nothing new. Single-threaded by contract: one
    filter instance belongs to one watch/informer delivery thread."""

    def __init__(self, wake: Callable[[], None]) -> None:
        self.wake = wake
        self._prints: Dict[str, object] = {}

    def __call__(self, etype: str, node: dict) -> None:
        name = (node.get("metadata") or {}).get("name", "")
        if etype == "DELETED":
            self._prints.pop(name, None)
            self.wake()
            return
        fp = node_report_fingerprint(node)
        if self._prints.get(name) != fp:
            self._prints[name] = fp
            self.wake()


def run_node_watch(kube: Any, stop: threading.Event,
                   wake: Callable[[], None],
                   *, timeout_s: int, backoff_s: float,
                   logger: logging.Logger, who: str,
                   on_event: Optional[
                       Callable[[str, dict], None]] = None,
                   on_gap: Optional[
                       Callable[[], None]] = None) -> None:
    """Shared node-watch pump for both controllers: stream node events,
    call ``wake()`` for report-relevant changes (fingerprint-filtered —
    see :func:`node_report_fingerprint`), wake once per from-scratch
    (re)connect to cover the unreplayable gap, back off and
    re-establish on transient failures, and return — degrading the
    caller to pure interval polling — when the client has no
    node-watch support (501, or a clientset whose ``watch_nodes``
    isn't a generator).

    ``on_event`` receives every non-bookmark ``(etype, node)`` delta
    BEFORE the wake filter — the feed the fleet controller's
    incremental :class:`~tpu_cc_manager.plan.FleetEncoding` rides, so
    the planner's feature block tracks deltas instead of re-encoding
    the fleet each scan. The callee dedups; this pump only delivers.

    ``on_gap`` fires at every from-scratch (re)connect, BEFORE the
    gap-covering wake: deltas between streams are unreplayable, so a
    delta-trusting consumer (the fleet controller's sync-skip path,
    ISSUE 19) must list-reconcile before trusting the feed again."""
    rv = None
    failures = 0
    relevant = FingerprintWakeFilter(wake)
    while not stop.is_set():
        if rv is None:
            # a fresh watch starts at "now" and cannot replay what
            # happened before it: wake one scan to cover the gap
            # (on_gap first — the woken scan must already know its
            # delta feed has a hole)
            if on_gap is not None:
                on_gap()
            wake()
        try:
            # the no-watch probe is scoped to the CALL alone: a
            # TypeError from event processing must hit the generic
            # backoff-and-retry below, not masquerade as a clientset
            # without watch support
            try:
                stream = iter(kube.watch_nodes(
                    resource_version=rv, timeout_s=timeout_s,
                ))
            except TypeError:
                logger.info("%s: client has no node-watch support; "
                            "interval polling only", who)
                return
            for etype, obj in stream:
                meta = obj.get("metadata", {})
                rv = meta.get("resourceVersion", rv)
                if etype == "BOOKMARK":
                    continue
                if on_event is not None:
                    on_event(etype, obj)
                relevant(etype, obj)
                if stop.is_set():
                    return
            failures = 0  # clean server-side timeout
        except ApiException as e:
            if e.status == 501:
                logger.info("%s: client has no node-watch support; "
                            "interval polling only", who)
                return
            rv = None
            failures += 1
            stop.wait(jittered_backoff(backoff_s, failures))
        except Exception:
            logger.warning("%s: node watch failed; retrying", who,
                           exc_info=True)
            rv = None
            failures += 1
            stop.wait(jittered_backoff(backoff_s, failures))


class NodeInformer:
    """Watch-fed shared node read cache (ISSUE 11) — the informer-style
    layer that lets every controller read fleet state from local memory
    instead of paying per-scan LIST/GET round trips (BENCH_NOTES r03:
    the hot path is API round trips, not device work).

    Grown out of this module's existing primitives: the delta feed is
    :func:`run_node_watch`'s ``on_event`` hook shape, and the cache is
    :class:`NodeWatcher`'s ``latest_node`` snapshot generalized to the
    whole fleet. One informer serves N consumers (all controller
    shards in a process share it), so the fleet pays ONE watch stream
    and ONE priming LIST regardless of controller count.

    Resume contract (the gap :func:`run_node_watch` tolerates but a
    read cache cannot): LIST, remember the highest resourceVersion,
    then WATCH **from that rv** — a write landing between the list and
    the watch establishment is replayed, never missed. On 410 (history
    compacted under us) or any transport failure the informer re-lists
    and re-arms; consumers' ``on_wake`` fires once per relist to cover
    the unreplayable gap exactly like the pump's fresh-connect wake.
    When the client has no node-watch support at all, the informer
    degrades to interval re-listing every ``resync_s`` so reads stay
    bounded-stale instead of frozen."""

    def __init__(
        self,
        kube: Any,
        *,
        watch_timeout_s: int = WATCH_TIMEOUT_S,
        backoff_s: float = RECONNECT_BACKOFF_S,
        resync_s: float = 30.0,
        name: str = "informer",
    ) -> None:
        self.kube = kube
        self.watch_timeout_s = watch_timeout_s
        self.backoff_s = backoff_s
        self.resync_s = resync_s
        self.name = name
        self._lock = threading.Lock()
        self._nodes: Dict[str, dict] = {}
        self._rv: Optional[str] = None
        self._primed = False
        #: token -> (on_event, on_wake); mutated under _lock, iterated
        #: on a snapshot so callbacks never run while it is held
        self._subs: Dict[int, Tuple[Optional[Callable[[str, dict], None]],
                                    Optional[Callable[[], None]]]] = {}
        self._sub_seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # read/health accounting (exposed via stats())
        self._lists_total = 0
        self._events_total = 0
        self._watch_supported = True

    # ------------------------------------------------------------ consumers
    def subscribe(
        self,
        on_event: Optional[Callable[[str, dict], None]] = None,
        on_wake: Optional[Callable[[], None]] = None,
    ) -> int:
        """Register a delta/wake consumer; returns an unsubscribe
        token. ``on_event`` receives every non-bookmark ``(etype,
        node)`` delta (the :func:`run_node_watch` ``on_event`` shape);
        ``on_wake`` fires once per relist — the consumer must treat it
        as "anything may have changed" and re-read."""
        with self._lock:
            self._sub_seq += 1
            token = self._sub_seq
            self._subs[token] = (on_event, on_wake)
        return token

    def unsubscribe(self, token: int) -> None:
        with self._lock:
            self._subs.pop(token, None)

    # -------------------------------------------------------------- reading
    def list_nodes(
        self,
        label_selector: Optional[str] = None,
        node_filter: Optional[Callable[[dict], bool]] = None,
    ) -> List[dict]:
        """Cache-served LIST: zero API round trips. Same shape and
        copy semantics as ``KubeClient.list_nodes`` — callers may
        mutate the returned objects freely. ``node_filter`` (the shard
        partition predicate) runs BEFORE the deepcopy: at N shards a
        post-copy filter would deepcopy the whole fleet per shard per
        scan and throw (N-1)/N of it away, all under the shared
        lock."""
        from tpu_cc_manager_torch.k8s.objects import match_selector

        with self._lock:
            # ccaudit: allow-blocking-under-lock(deepcopy of cached node objects, not I/O: copying inside the lock is what keeps readers consistent with the watch thread's swaps)
            return [
                copy.deepcopy(n) for n in self._nodes.values()
                if match_selector(
                    (n.get("metadata") or {}).get("labels") or {},
                    label_selector,
                ) and (node_filter is None or node_filter(n))
            ]

    def get_node(self, name: str) -> dict:
        """Cache-served GET; raises ApiException(404) like the client
        would so informer-backed reads stay drop-in."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise ApiException(404, f"node {name} not found")
            # ccaudit: allow-blocking-under-lock(deepcopy of one cached node object, not I/O — same contract as NodeWatcher.latest_node)
            return copy.deepcopy(node)

    @property
    def primed(self) -> bool:
        with self._lock:
            return self._primed

    def stats(self) -> dict:
        with self._lock:
            return {
                "nodes": len(self._nodes),
                "lists": self._lists_total,
                "events": self._events_total,
                "watch_supported": self._watch_supported,
            }

    # ------------------------------------------------------------- plumbing
    def _snapshot_subs(self) -> List[Tuple[
            Optional[Callable[[str, dict], None]],
            Optional[Callable[[], None]]]]:
        with self._lock:
            return list(self._subs.values())

    def _apply(self, etype: str, node: dict) -> None:
        meta = node.get("metadata") or {}
        name = meta.get("name")
        if not name:
            return
        with self._lock:
            self._events_total += 1
            rv = meta.get("resourceVersion")
            if rv is not None:
                self._rv = rv
            if etype == "DELETED":
                self._nodes.pop(name, None)
            else:
                self._nodes[name] = copy.deepcopy(node)
        for on_event, _ in self._snapshot_subs():
            if on_event is not None:
                on_event(etype, node)

    def prime(self) -> None:
        """Synchronous initial LIST: fills the cache and captures the
        resume rv before :meth:`start` arms the watch — callers that
        hand the informer to a controller get a warm cache first."""
        self._relist()

    def _relist(self) -> None:
        nodes = self.kube.list_nodes(None)
        rv = 0
        fresh: Dict[str, dict] = {}
        for n in nodes:
            meta = n.get("metadata") or {}
            name = meta.get("name")
            if not name:
                continue
            fresh[name] = n
            try:
                rv = max(rv, int(meta.get("resourceVersion") or 0))
            except ValueError:
                pass
        with self._lock:
            self._nodes = fresh
            self._rv = str(rv) if rv else None
            self._primed = True
            self._lists_total += 1
        for _, on_wake in self._snapshot_subs():
            if on_wake is not None:
                on_wake()

    # ------------------------------------------------------------ main loop
    def _run(self) -> None:
        failures = 0
        while not self._stop.is_set():
            try:
                if not self.primed:
                    self._relist()
                with self._lock:
                    rv = self._rv
                try:
                    stream = iter(self.kube.watch_nodes(
                        resource_version=rv,
                        timeout_s=self.watch_timeout_s,
                    ))
                except TypeError:
                    # clientset without watch support: degrade to
                    # interval re-listing so reads stay bounded-stale
                    with self._lock:
                        self._watch_supported = False
                    log.info("%s: client has no node-watch support; "
                             "re-listing every %.0fs", self.name,
                             self.resync_s)
                    while not self._stop.wait(self.resync_s):
                        self._relist()
                    return
                for etype, node in stream:
                    if etype == "BOOKMARK":
                        meta = node.get("metadata") or {}
                        rv2 = meta.get("resourceVersion")
                        if rv2 is not None:
                            with self._lock:
                                self._rv = rv2
                        continue
                    self._apply(etype, node)
                    if self._stop.is_set():
                        return
                # clean server-side timeout: reconnect from current rv
                failures = 0
            except ApiException as e:
                if e.status == 501:
                    with self._lock:
                        self._watch_supported = False
                    log.info("%s: node watch unsupported (501); "
                             "re-listing every %.0fs", self.name,
                             self.resync_s)
                    while not self._stop.wait(self.resync_s):
                        self._relist()
                    return
                failures += 1
                if e.status == 410:
                    log.warning("%s: watch history expired (410); "
                                "re-listing", self.name)
                else:
                    pause = jittered_backoff(self.backoff_s, failures)
                    log.warning("%s: watch failed (%s); re-listing in "
                                "%.1fs", self.name, e, pause)
                    self._stop.wait(pause)
                with self._lock:
                    self._primed = False  # next loop turn re-lists
            except Exception:
                failures += 1
                log.warning("%s: unexpected informer error; re-listing",
                            self.name, exc_info=True)
                self._stop.wait(jittered_backoff(self.backoff_s, failures))
                with self._lock:
                    self._primed = False

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "NodeInformer":
        self._thread = threading.Thread(
            target=self._run, name=f"node-informer-{self.name}",
            daemon=True,
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def client(
        self, base: Any,
        node_filter: Optional[Callable[[dict], bool]] = None,
    ) -> "InformerKubeClient":
        """An informer-backed client view over ``base``: node reads
        come from this cache (optionally partition-scoped by
        ``node_filter``, applied pre-copy), everything else (writes,
        leases, CRs, watches) passes through."""
        return InformerKubeClient(self, base, node_filter=node_filter)


class InformerKubeClient:
    """KubeClient facade serving ``list_nodes``/``get_node`` from a
    :class:`NodeInformer` cache and delegating every other verb to the
    wrapped client. Hand this to a controller and its steady-state
    scans perform ZERO node read round trips (pinned by
    tests/test_shard.py) while writes keep their real path."""

    def __init__(self, informer: NodeInformer, base: Any,
                 node_filter: Optional[Callable[[dict], bool]] = None,
                 ) -> None:
        self.informer = informer
        self.base = base
        self.node_filter = node_filter

    def list_nodes(self, label_selector: Optional[str] = None) -> List[dict]:
        return self.informer.list_nodes(label_selector, self.node_filter)

    def get_node(self, name: str) -> dict:
        return self.informer.get_node(name)

    def __getattr__(self, name: str) -> Any:
        return getattr(self.base, name)


class FatalWatchError(Exception):
    """Too many consecutive watch failures (reference main.py:665-673)."""


class NodeWatcher:
    """Watches one node's cc.mode label and feeds a SyncableModeConfig."""

    def __init__(
        self,
        kube: KubeClient,
        node_name: str,
        config: SyncableModeConfig,
        *,
        label_key: str = L.CC_MODE_LABEL,
        watch_timeout_s: int = WATCH_TIMEOUT_S,
        backoff_s: float = RECONNECT_BACKOFF_S,
        max_consecutive_errors: int = MAX_CONSECUTIVE_ERRORS,
        on_fatal: Optional[Callable[[Exception], None]] = None,
        on_error: Optional[Callable[[], None]] = None,
        on_event: Optional[Callable[[str, dict], None]] = None,
    ):
        self.kube = kube
        self.node_name = node_name
        self.config = config
        self.label_key = label_key
        self.watch_timeout_s = watch_timeout_s
        self.backoff_s = backoff_s
        self.max_consecutive_errors = max_consecutive_errors
        self.on_fatal = on_fatal
        self.on_error = on_error
        #: fires on EVERY delivered node event (after the snapshot is
        #: refreshed, before label dedup): the agent pulses its drain
        #: wake from here so in-flight drain waits re-check on the
        #: watch event (ISSUE 14). Must be cheap and never raise-prone
        #: — it runs on the watch thread.
        self.on_event = on_event
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: last label value pushed downstream (dedup at the watch layer,
        #: reference main.py:651-661 only reconciles on actual change)
        self._last_value: Optional[str] = None
        self.resource_version: Optional[str] = None
        self.consecutive_errors = 0
        #: newest full node object seen (prime read or watch event),
        #: guarded by its own lock — the taint layer seeds its CAS
        #: replaces from this snapshot instead of paying a fresh GET
        #: (ISSUE 6: the desired-label event that triggers a reconcile
        #: carries a node fresher than anything a GET would return)
        self._snapshot_lock = threading.Lock()
        self._last_node: Optional[dict] = None
        #: the adoptable cc.trace context (ISSUE 8), and the annotation
        #: value observed at the last desired-label CHANGE. A new
        #: desired write only carries a trace when its writer stamped a
        #: FRESH context — an unstamped write (operator kubectl) must
        #: not inherit a finished rollout's annotation, or every later
        #: reconcile stitches under a dead trace. Guarded by
        #: _snapshot_lock like the node snapshot it derives from.
        self._trace_ctx: Optional[str] = None
        self._ctx_at_last_change: Optional[str] = None

    # ------------------------------------------------------------ helpers
    def read_node_label(self) -> Optional[str]:
        """Read the label + capture resourceVersion (reference
        main.py:585-600)."""
        node = self.kube.get_node(self.node_name)
        self.resource_version = node["metadata"]["resourceVersion"]
        self._remember_node(node)
        return node["metadata"].get("labels", {}).get(self.label_key)

    def _remember_node(self, node: dict) -> None:
        meta = node.get("metadata") or {}
        label = (meta.get("labels") or {}).get(self.label_key)
        ann = (meta.get("annotations") or {}).get(L.CC_TRACE_ANNOTATION)
        if not isinstance(ann, str):
            ann = None
        with self._snapshot_lock:
            self._last_node = node
            # runs BEFORE _push updates _last_value, so a differing
            # label here means THIS node object is a new desired write:
            # adopt its annotation only if the writer stamped a fresh
            # one (prime counts as a change — the restart-rejoin case)
            if label != self._last_value:
                self._trace_ctx = (
                    ann if ann != self._ctx_at_last_change else None
                )
                self._ctx_at_last_change = ann

    def latest_node(self) -> Optional[dict]:
        """A deep copy of the newest node object this watcher has seen
        (None before the prime read). Callers may mutate it freely —
        it's a seed for optimistic-concurrency writes, nothing more."""
        import copy

        with self._snapshot_lock:
            # ccaudit: allow-blocking-under-lock(deepcopy of one node object, not I/O: the copy must happen inside the lock or the watch thread could swap the snapshot mid-copy)
            return copy.deepcopy(self._last_node) if self._last_node else None

    def latest_trace_context(self) -> Optional[str]:
        """The desired-writer's cross-process trace context, delivered
        by the same watch event as the desired-label change that
        triggers the reconcile. Last-writer-wins matches the mailbox's
        coalescing contract: the newest desired write's trace owns
        whatever reconcile runs next. None before the prime read, when
        no writer stamps contexts, or when the newest desired write
        did NOT stamp a fresh one (the node merely still carries a
        previous write's annotation — adopting that would attribute
        this reconcile to a finished trace)."""
        with self._snapshot_lock:
            return self._trace_ctx

    def _fire_on_event(self, etype: str, node: dict) -> None:
        if self.on_event is None:
            return
        try:
            self.on_event(etype, node)
        except Exception:
            log.debug("on_event hook failed", exc_info=True)

    def _push(self, value: Optional[str]) -> None:
        if value != self._last_value:
            log.info(
                "%s changed on %s: %r -> %r",
                self.label_key, self.node_name, self._last_value, value,
            )
            self._last_value = value
            self.config.set(value)

    def prime(self) -> Optional[str]:
        """Initial read; remembers the value so the watch only fires on
        change. Returns the initial label value."""
        value = self.read_node_label()
        # ccaudit: allow-race-lockset(prime() runs before start() spawns the watch thread — happens-before, never concurrent with _push)
        self._last_value = value
        return value

    # ---------------------------------------------------------- main loop
    def run(self) -> None:
        """Blocking watch loop; returns only on stop() or fatal error."""
        while not self._stop.is_set():
            try:
                for etype, node in self.kube.watch_nodes(
                    name=self.node_name,
                    resource_version=self.resource_version,
                    timeout_s=self.watch_timeout_s,
                ):
                    self.consecutive_errors = 0
                    rv = node["metadata"].get("resourceVersion")
                    if rv is not None:
                        self.resource_version = rv  # main.py:648-649
                    if etype in ("ADDED", "MODIFIED"):
                        # snapshot BEFORE pushing the label downstream:
                        # a reconcile triggered by this event must find
                        # a seed at least as fresh as its own trigger
                        self._remember_node(node)
                        self._fire_on_event(etype, node)
                        self._push(
                            node["metadata"].get("labels", {}).get(self.label_key)
                        )
                    elif etype == "DELETED":
                        log.warning("node %s deleted from the API", self.node_name)
                        self._fire_on_event(etype, node)
                    if self._stop.is_set():
                        return
                # clean server-side timeout: reconnect immediately with rv
                self.consecutive_errors = 0
            except ApiException as e:
                self.consecutive_errors += 1
                if self.on_error:
                    self.on_error()
                if self.consecutive_errors >= self.max_consecutive_errors:
                    fatal = FatalWatchError(
                        f"{self.consecutive_errors} consecutive watch errors; "
                        f"last: {e}"
                    )
                    log.error("%s", fatal)
                    if self.on_fatal:
                        self.on_fatal(fatal)
                        return
                    raise fatal from e
                if e.status == 410:
                    # history expired: full re-read and resync if changed
                    # (reference main.py:675-687)
                    log.warning("watch history expired (410); re-listing node")
                    try:
                        self._push(self.read_node_label())
                        continue  # no backoff after successful resync
                    except ApiException as e2:
                        log.error("re-list after 410 failed: %s", e2)
                pause = jittered_backoff(
                    self.backoff_s, self.consecutive_errors
                )
                log.warning(
                    "watch error (%d consecutive): %s; reconnecting in %.1fs",
                    self.consecutive_errors, e, pause,
                )
                self._stop.wait(pause)
            except Exception as e:  # defensive: never kill silently
                self.consecutive_errors += 1
                log.exception("unexpected watcher error")
                if self.consecutive_errors >= self.max_consecutive_errors:
                    if self.on_fatal:
                        self.on_fatal(e)
                        return
                    raise
                self._stop.wait(jittered_backoff(
                    self.backoff_s, self.consecutive_errors
                ))

    # --------------------------------------------------------- lifecycle
    def start(self) -> "NodeWatcher":
        self._thread = threading.Thread(
            target=self.run, name=f"node-watch-{self.node_name}", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self.config.close()
        if self._thread:
            self._thread.join(timeout=5)
