"""The shared watch pump: ONE node-watch stream fanned out to N
replica mailboxes.

This is the piece that makes 256 live replicas affordable: instead of
256 per-node watch streams (each a held server thread + socket), one
stream over the whole fleet feeds every replica's last-value mailbox,
with the NodeWatcher's robustness contract kept intact — rv resume,
clean-timeout reconnect, error backoff, and full relist on 410 (the
reference main.py:675-687 behavior the watch_410 fault exercises).

Lag measurement: the runner stamps each desired-label patch
(:class:`LagStamps`); when the pump delivers that value for that node,
the stamp-to-delivery delta lands in the shared
``tpu_cc_watch_pump_lag_seconds`` histogram (obs.watch_pump_lag_histogram)
— the artifact's watch-pump lag distribution is measured at exactly the
point a per-node agent's mailbox would learn of the change.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.k8s.client import ApiException

log = logging.getLogger("tpu-cc-manager.simlab.pump")


class LagStamps:
    """One stamp per node: (desired value, monotonic patch time). The
    pump takes the stamp only when it delivers the SAME value — a
    coalesced-away intermediate flip never yields a bogus sample."""

    def __init__(self):
        self._lock = threading.Lock()
        self._stamps: Dict[str, tuple] = {}

    def record(self, node: str, value: str, t: float) -> None:
        with self._lock:
            self._stamps[node] = (value, t)

    def take(self, node: str, value) -> Optional[float]:
        with self._lock:
            hit = self._stamps.get(node)
            if hit is None or hit[0] != value:
                return None
            del self._stamps[node]
            return hit[1]


class WatchPump:
    def __init__(
        self,
        kube,
        replicas: Dict[str, object],
        pool,
        stamps: LagStamps,
        lag_hist,
        *,
        watch_timeout_s: float = 10.0,
        backoff_s: float = 0.2,
    ):
        self.kube = kube
        self.replicas = replicas
        self.pool = pool
        self.stamps = stamps
        self.lag_hist = lag_hist
        self.watch_timeout_s = watch_timeout_s
        self.backoff_s = backoff_s
        self._rv: Optional[str] = None
        #: last desired value delivered downstream per node (the
        #: NodeWatcher._last_value dedup, fleet-wide)
        self._last: Dict[str, Optional[str]] = {}
        #: cc.trace annotation seen at each node's last desired CHANGE
        #: (the NodeWatcher freshness rule, fleet-wide): a new desired
        #: write only carries a trace if its writer stamped a FRESH
        #: context — an unstamped write must not inherit a finished
        #: write's annotation
        self._last_ctx: Dict[str, Optional[str]] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # counters (monotonic; read for the artifact)
        self.events_total = 0       # watch events examined
        self.delivered_total = 0    # desired-mode changes fanned out
        self.echo_filtered_total = 0  # events with no desired change
        self.relists_total = 0
        self.errors_total = 0
        self.gone_410_total = 0
        self.lag_samples: List[float] = []
        self._lag_lock = threading.Lock()

    # ------------------------------------------------------------ plumbing
    def _observe_lag(self, node: str, value,
                     trace_id: Optional[str] = None) -> Optional[float]:
        t = self.stamps.take(node, value)
        if t is None:
            return None
        lag = time.monotonic() - t
        # the desired write's trace id exemplifies the lag bucket
        # (ISSUE 15): a slow pump bucket names a concrete fleet trace
        self.lag_hist.observe(lag, trace_id=trace_id)
        with self._lag_lock:
            self.lag_samples.append(lag)
        return lag

    def _deliver(self, node: str, value, trace: Optional[str] = None) -> None:
        if value == self._last.get(node):
            self.echo_filtered_total += 1
            return
        self._last[node] = value
        fresh = trace if trace != self._last_ctx.get(node) else None
        # ccaudit: allow-race-lockset(_deliver runs only on the pump thread after start(); prime() writes happen-before — same single-writer contract as _last)
        self._last_ctx[node] = trace
        from tpu_cc_manager_torch.trace import parse_traceparent

        ctx = parse_traceparent(fresh)
        lag = self._observe_lag(
            node, value,
            trace_id=ctx.trace_id if ctx is not None else None)
        if value is None:
            return  # label removed: nothing to reconcile (no default)
        self.delivered_total += 1
        # the desired-writer's cc.trace context and this delivery's
        # measured pump lag travel WITH the value: the replica adopts
        # the trace and stamps the lag as a span attribute, so the
        # fleet-wide lag distribution also lands on the right spans.
        # Only a FRESHLY-stamped context rides (see _last_ctx)
        self.pool.submit(node, value, trace=fresh, lag=lag)

    def prime(self) -> None:
        """Initial LIST: seed per-node last values + the resume rv
        WITHOUT delivering (the runner submits the initial mode itself,
        so startup is one deliberate storm, not a list echo)."""
        nodes = self.kube.list_nodes()
        rv = 0
        for n in nodes:
            name = n["metadata"]["name"]
            if name in self.replicas:
                # ccaudit: allow-race-lockset(prime() runs before start() spawns the pump thread — happens-before, never concurrent with _deliver)
                self._last[name] = (n["metadata"].get("labels") or {}).get(
                    L.CC_MODE_LABEL
                )
                # seed the freshness baseline too: an annotation already
                # on the node at prime must not look freshly stamped
                # when the first unstamped desired change arrives
                # ccaudit: allow-race-lockset(prime() runs before start() — same happens-before as _last above)
                self._last_ctx[name] = (
                    n["metadata"].get("annotations") or {}
                ).get(L.CC_TRACE_ANNOTATION)
            rv = max(rv, int(n["metadata"].get("resourceVersion") or 0))
        # ccaudit: allow-race-lockset(prime() runs before start() — same happens-before as _last above)
        self._rv = str(rv) if rv else None

    def _relist(self) -> None:
        """Full resynchronization after 410 (or to recover from a list
        storm): compare-and-deliver, like the watcher's re-list path."""
        while not self._stop.is_set():
            try:
                nodes = self.kube.list_nodes()
                break
            except ApiException as e:
                # a 429/500 storm mid-relist: keep trying — the pump
                # wedged on a failed resync would strand the fleet
                self.errors_total += 1
                log.warning("relist failed (%s); retrying", e)
                self._stop.wait(self.backoff_s)
        else:
            return
        self.relists_total += 1
        rv = int(self._rv or 0)
        for n in nodes:
            name = n["metadata"]["name"]
            rv = max(rv, int(n["metadata"].get("resourceVersion") or 0))
            if name in self.replicas:
                self._deliver(
                    name,
                    (n["metadata"].get("labels") or {}).get(
                        L.CC_MODE_LABEL),
                    trace=(n["metadata"].get("annotations") or {}).get(
                        L.CC_TRACE_ANNOTATION),
                )
        self._rv = str(rv) if rv else None

    # ---------------------------------------------------------- main loop
    def run(self) -> None:
        while not self._stop.is_set():
            try:
                for etype, obj in self.kube.watch_nodes(
                    resource_version=self._rv,
                    # floor at 1: scenarios may say 0.5, and a
                    # truncated-to-0 window would busy-loop reconnects
                    # against the server under test
                    timeout_s=max(1, int(self.watch_timeout_s)),
                ):
                    meta = obj.get("metadata", {})
                    rv = meta.get("resourceVersion")
                    if rv is not None:
                        self._rv = rv
                    if etype == "BOOKMARK":
                        continue
                    self.events_total += 1
                    if etype == "DELETED":
                        continue
                    name = meta.get("name")
                    if name not in self.replicas:
                        continue
                    self._deliver(
                        name,
                        (meta.get("labels") or {}).get(L.CC_MODE_LABEL),
                        trace=(meta.get("annotations") or {}).get(
                            L.CC_TRACE_ANNOTATION),
                    )
                    if self._stop.is_set():
                        return
                # clean server-side timeout: reconnect immediately
            except ApiException as e:
                self.errors_total += 1
                if e.status == 410:
                    self.gone_410_total += 1
                    log.warning("watch history expired (410); relisting")
                    self._relist()
                    continue
                log.warning("watch error: %s; reconnecting in %.1fs",
                            e, self.backoff_s)
                self._stop.wait(self.backoff_s)
            except Exception:
                self.errors_total += 1
                log.exception("unexpected pump error")
                self._stop.wait(self.backoff_s)

    # --------------------------------------------------------- lifecycle
    def start(self) -> "WatchPump":
        self._thread = threading.Thread(
            target=self.run, name="simlab-pump", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)

    def stats(self) -> dict:
        from tpu_cc_manager_torch.simlab.report import percentile

        with self._lag_lock:
            samples = list(self.lag_samples)
        return {
            "events": self.events_total,
            "delivered": self.delivered_total,
            "echo_filtered": self.echo_filtered_total,
            "relists": self.relists_total,
            "watch_errors": self.errors_total,
            "watch_410": self.gone_410_total,
            "lag_samples": len(samples),
            "lag_p50_s": percentile(samples, 0.50),
            "lag_p95_s": percentile(samples, 0.95),
            "lag_max_s": round(max(samples), 5) if samples else None,
        }
