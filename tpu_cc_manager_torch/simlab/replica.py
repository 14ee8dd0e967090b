"""Replica shell + worker pool — live agents without thread-per-node.

Each :class:`ReplicaShell` is one simulated node's agent: a real
:class:`~tpu_cc_manager.engine.ModeEngine` over its own fake device
backend, publishing the observed-state label (and optionally evidence)
through a SHARED flow-controlled HTTP client. What it deliberately does
NOT own is threads: desired-mode changes land in a last-value mailbox
(fed by the shared watch pump) and a bounded :class:`WorkerPool`
executes the reconciles — the coalescing contract is the agent's
(``SyncableModeConfig`` semantics: N rapid flips collapse to the newest
value), the execution model is what lets 256 replicas fit a 1-core
sandbox.

Failure semantics mirror the real agent (agent.py reconcile): invalid
modes reject cleanly with a ``failed`` state label; retryable failures
re-enter the queue after a short delay (the self-repair analog) so a
replica that lost a state-label write to a 429 storm still converges.

Shared-loop mode (ISSUE 13, ``TPU_CC_SIMLAB_SHARED_LOOP=1``): the
``kube`` every shell publishes through may be ONE
:class:`~tpu_cc_manager.k8s.aio_bridge.SyncKubeFacade` — the whole
fleet's writes then multiplex a single event loop's pipelined
connection pool (k8s/aio.py) instead of checking thread-private
sockets out of the threaded client. The shell is agnostic by design:
both clients speak the same ``KubeClient``/throttle surface, so the
runner swaps the transport without a scenario byte changing
(docs/io.md §"The async core"; the artifact's ``metrics.kube_io``
records which core served the run).
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Dict, List, Optional

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.device.gate import DeviceGate
from tpu_cc_manager_torch.engine import FatalModeError, ModeEngine, NullDrainer
from tpu_cc_manager_torch.flightrec import FlightRecorder
from tpu_cc_manager_torch.k8s.batch import NodePatchBatcher
from tpu_cc_manager_torch.modes import STATE_FAILED, InvalidModeError

log = logging.getLogger("tpu-cc-manager.simlab.replica")

#: mailbox sentinel: "no pending desired value"
_EMPTY = object()

#: worker-queue sentinel telling a worker thread to exit
_STOP = object()


class SimGate(DeviceGate):
    """In-memory device gate: records the permission bits chmod WOULD
    set on each device path instead of touching a devfs that fake
    chips don't have. This makes the engine's fail-secure contract —
    a device locked for a flip stays at FLIP_LOCK_PERMS until a later
    successful verify reopens it — OBSERVABLE per replica, which is
    exactly what the lifecycle invariants oracle
    (simlab.invariants) checks at quiescence."""

    def __init__(self) -> None:
        super().__init__(enabled=True)
        self._perms_lock = threading.Lock()
        self._perms: Dict[str, int] = {}

    def _chmod(self, path: str, perms: int, *, must_succeed: bool) -> bool:
        with self._perms_lock:
            self._perms[path] = perms
        return True

    def current_perms(self, path: str):
        with self._perms_lock:
            return self._perms.get(path)

    def perms_snapshot(self) -> Dict[str, int]:
        with self._perms_lock:
            return dict(self._perms)


class ReplicaShell:
    """One node's reconciling agent, mailbox-driven."""

    #: retryable-failure requeue delay and lifetime retry budget (the
    #: agent's REPAIR_INTERVAL_S analog, scaled to scenario time; the
    #: convergence timeout is the real backstop)
    REPAIR_DELAY_S = 0.5
    MAX_REPAIRS = 50

    def __init__(
        self,
        node_name: str,
        kube,
        backend,
        tracer,
        *,
        evidence: bool = False,
        metrics=None,
        attestor=None,
    ):
        self.node_name = node_name
        self.kube = kube
        self.backend = backend
        self.evidence = evidence
        #: optional per-replica attest.FakeTpm (scenario.attestation):
        #: the engine extends ITS measured flip history and evidence
        #: quotes come from IT, so one process carries a fleet of
        #: independent PCRs (runner.AttestationLab owns the state dirs
        #: and the verifier-side trust root)
        self.attestor = attestor
        #: recording device gate: the oracle's fail-secure probe
        self.gate = SimGate()
        #: optional obs.Metrics — the SAME metric set a real agent
        #: exposes, so this replica is a genuine scrape target for the
        #: fleet observatory (fleetobs.py, ISSUE 9): outcomes, the
        #: reconcile-duration histogram, and the batcher's publish-loss
        #: counters all land here exactly as agent.py wires them
        self.metrics = metrics
        # the write-coalescing layer (k8s.batch): the state-label write
        # is the replica's carrier — it transports the PREVIOUS
        # this replica's flight recording (ISSUE 8): small rings — the
        # runner collects every replica's snapshot after the run and
        # stitches them fleet-wide by trace id. The shared tracer can't
        # be sinked per replica, so the reconcile root spans are
        # recorded explicitly in _reconcile.
        self.recorder = FlightRecorder(
            name=node_name, span_ring=64, event_ring=64, sample_ring=32,
        )
        # reconcile's deferred evidence, so a flip costs one write, not
        # two. The runner's settle pass flushes stragglers. Publish-loss
        # events note into THIS replica's recorder (not the process
        # default), so a write-storm's retried/dropped keys reach the
        # collected recordings.
        if metrics is not None:
            self.batcher = NodePatchBatcher(
                kube, node_name, recorder=self.recorder,
                on_coalesced=(
                    lambda kind: metrics
                    .publications_coalesced_total.inc(kind)
                ),
                on_retry=lambda kind: metrics.publish_retries_total.inc(),
                on_drop=(
                    lambda kind: metrics
                    .publications_dropped_total.inc(kind)
                ),
            )
        else:
            self.batcher = NodePatchBatcher(kube, node_name,
                                            recorder=self.recorder)
        self.engine = ModeEngine(
            set_state_label=self.batcher.write_state_label,
            drainer=NullDrainer(),
            evict_components=False,
            backend=backend,
            tracer=tracer,
            recorder=self.recorder,
            gate=self.gate,
            attestor=attestor,
        )
        self._tracer = tracer
        self._lock = threading.Lock()
        self._pending = _EMPTY
        self._pending_trace: Optional[str] = None
        self._pending_lag: Optional[float] = None
        self._queued = False
        self.alive = True
        self.applied: Optional[str] = None
        #: code-version behavior tag (the rolling-upgrade drill):
        #: "v1" is the baseline; an upgraded replica advertises its
        #: version as the cc.agent-version annotation, deferred
        #: through the batcher so it rides the next carrier write —
        #: the observable behavior difference between the two code
        #: versions reconciling one pool mid-rollout. Written under
        #: _lock (upgrade()), read on the worker thread.
        self.version = "v1"
        self._version_published = "v1"
        # counters (read single-threaded at report time)
        self.reconciles = 0
        self.outcomes: Dict[str, int] = {}
        self.repairs = 0
        self.coalesced = 0
        self._resubmit: Optional[
            Callable[[str, str, Optional[str]], None]] = None
        self._timers: List[threading.Timer] = []
        #: evidence generation bookkeeping (the agent's
        #: _evidence_published_gen analog, scaled down): wanted >
        #: published means the newest document hasn't landed and the
        #: next success or settle flush must deliver it
        self.evidence_wanted_gen = 0
        self.evidence_published_gen = 0

    # ------------------------------------------------------------ mailbox
    def offer(self, value: str, trace: Optional[str] = None,
              lag: Optional[float] = None) -> bool:
        """Last-value-wins mailbox write. Returns True when the caller
        should enqueue this replica on the worker queue (not already
        queued, and alive — a crashed replica keeps the pending value
        for its restart to pick up). ``trace``/``lag`` ride the value
        (and coalesce with it — the newest desired write's trace owns
        the reconcile, exactly the real agent's contract)."""
        with self._lock:
            if self._pending is not _EMPTY and self._pending != value:
                self.coalesced += 1  # overwritten unread value
            self._pending = value
            self._pending_trace = trace
            self._pending_lag = lag
            if self._queued or not self.alive:
                return False
            self._queued = True
            return True

    def run_pending(self) -> None:
        """Worker entry point: drain the mailbox, reconciling the newest
        desired value each pass, until nothing is pending."""
        while True:
            with self._lock:
                if self._pending is _EMPTY or not self.alive:
                    self._queued = False
                    break
                value = self._pending
                trace, lag = self._pending_trace, self._pending_lag
                self._pending = _EMPTY
                self._pending_trace = self._pending_lag = None
            self._reconcile(value, trace, lag)
        # mailbox drained: flush any deferred publication that found no
        # carrier write (respects the batcher's flush window/backoff) —
        # the replica's idle-tick analog
        self.batcher.maybe_flush()

    # ---------------------------------------------------------- reconcile
    def _reconcile(self, mode: str, trace: Optional[str] = None,
                   lag: Optional[float] = None) -> None:
        outcome = "error"
        ok = False
        # adopt the desired-writer's trace context (simlab driver or
        # policy-driven rollout): this replica's reconcile tree joins
        # the fleet-wide trace the runner stitches by trace id
        with self._tracer.adopt_remote(trace):
            with self._tracer.span(
                "reconcile", mode=mode, node=self.node_name
            ) as root:
                if lag is not None:
                    # the pump-lag measurement lands on the span it
                    # belongs to, not only a disembodied histogram
                    root.attrs["pump_lag_s"] = round(lag, 6)
                try:
                    ok = self.engine.set_mode(mode)
                    outcome = "success" if ok else "failure"
                except InvalidModeError as e:
                    log.error("%s: rejecting desired mode: %s",
                              self.node_name, e)
                    self._publish_failed()
                    outcome = "invalid"
                except FatalModeError as e:
                    # the DaemonSet-restart analog: this replica is down
                    # until a scripted restart brings it back
                    log.error("%s: fatal: %s", self.node_name, e)
                    with self._lock:
                        self.alive = False
                    outcome = "fatal"
                except Exception:
                    log.exception("%s: reconcile crashed", self.node_name)
                    self._publish_failed()
                root.attrs["outcome"] = outcome
        # the root span is closed (dur_s final) — record it in this
        # replica's black box for the runner's fleet-timeline stitch
        self.recorder.observe_span(root)
        self.recorder.note("reconcile", mode=mode, outcome=outcome)
        self.reconciles += 1
        self.outcomes[outcome] = self.outcomes.get(outcome, 0) + 1
        if self.metrics is not None:
            self.metrics.reconciles_total.inc(outcome)
            # the (possibly adopted) reconcile trace id rides as the
            # latency bucket's exemplar (ISSUE 15): a slow bucket in
            # this replica's exposition names a trace the fleet-wide
            # stitch resolves back to the desired write that caused it
            self.metrics.reconcile_duration.observe(
                root.dur_s, trace_id=root.trace_id)
        if ok:
            self.applied = mode
            if self.evidence:
                self._defer_evidence()
            with self._lock:
                version = self.version
                publish_version = version != self._version_published
            if publish_version:
                self._defer_version(version)
        elif outcome in ("failure", "error"):
            self._arm_repair(mode, trace)

    def _defer_evidence(self) -> None:
        """Build this node's evidence document and hand it to the
        coalescing batcher: it rides the NEXT reconcile's state write
        (or the runner's settle flush); only the newest generation is
        ever sent, superseded ones are counted by the batcher."""
        import json as _json

        from tpu_cc_manager_torch.evidence import build_evidence

        try:
            doc = build_evidence(
                self.node_name, self.backend,
                attestor=(self.attestor if self.attestor is not None
                          else "auto"),
            )
            payload = _json.dumps(doc, sort_keys=True,
                                  separators=(",", ":"))
        except Exception:
            log.warning("%s: evidence build failed", self.node_name,
                        exc_info=True)
            return
        self.evidence_wanted_gen += 1

        def landed(gen: int) -> None:
            self.evidence_published_gen = max(
                self.evidence_published_gen, gen
            )

        self.batcher.defer(
            "evidence",
            annotations={L.EVIDENCE_ANNOTATION: payload},
            gen=self.evidence_wanted_gen,
            on_published=landed,
        )

    def _defer_version(self, version: str) -> None:
        """Advertise the running code version (upgrade drill): a
        coalescing publication riding the next carrier write — an
        upgrade costs zero extra round trips, pinned by the oracle's
        writes-per-flip budget."""

        def landed(gen: int) -> None:
            with self._lock:
                self._version_published = version

        self.batcher.defer(
            "agent_version",
            annotations={L.AGENT_VERSION_ANNOTATION: version},
            on_published=landed,
        )

    def _publish_failed(self) -> None:
        try:
            self.batcher.write_state_label(STATE_FAILED)
        except Exception:
            log.warning("%s: could not publish failed state",
                        self.node_name)

    def _arm_repair(self, mode: str, trace: Optional[str] = None) -> None:
        """Requeue a retryable failure after a short delay, like the
        agent's idle-tick self-repair — a label event will never come
        to retry it (the desired label is already correct). The failed
        round's trace context rides the retry: the repair is still
        part of the same desired-write's story."""
        if self._resubmit is None or self.repairs >= self.MAX_REPAIRS:
            return
        self.repairs += 1

        def fire():
            with self._lock:
                if not self.alive or self._pending is not _EMPTY:
                    return  # newer work already queued
            self._resubmit(self.node_name, mode, trace)

        t = threading.Timer(self.REPAIR_DELAY_S, fire)
        t.daemon = True
        t.start()
        self._timers.append(t)

    # ------------------------------------------------------------- faults
    def crash(self) -> None:
        with self._lock:
            self.alive = False

    def restart(self) -> None:
        """Back alive; the caller re-reads the node's desired label and
        resubmits (a restarted agent's prime-read analog)."""
        with self._lock:
            self.alive = True

    def upgrade(self, version: str) -> None:
        """Process-replacement half of a rolling agent upgrade: down,
        new code version swapped in. The injector restarts it with the
        same prime-read the crash fault uses; the first successful
        reconcile after restart advertises the new version."""
        with self._lock:
            self.alive = False
            self.version = version

    def close(self) -> None:
        for t in self._timers:
            t.cancel()
        self._timers.clear()


class WorkerPool:
    """Bounded reconcile executor: N daemon workers over one queue of
    replica names. ``submit`` is the only producer API — it routes
    through the replica mailbox so concurrent producers (pump, fault
    restarts, repair timers) keep last-value-wins semantics."""

    def __init__(self, replicas: Dict[str, ReplicaShell], n_workers: int):
        self.replicas = replicas
        self._q: "queue.Queue" = queue.Queue()
        self._threads: List[threading.Thread] = []
        self.n_workers = n_workers
        for r in replicas.values():
            r._resubmit = self.submit

    def start(self) -> "WorkerPool":
        for i in range(self.n_workers):
            t = threading.Thread(
                target=self._worker, name=f"simlab-worker-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        return self

    def submit(self, name: str, value: str,
               trace: Optional[str] = None,
               lag: Optional[float] = None) -> None:
        replica = self.replicas.get(name)
        if replica is None:
            return
        if replica.offer(value, trace, lag):
            self._q.put(name)

    def requeue(self, name: str) -> None:
        """Enqueue a replica whose mailbox already holds a pending value
        (restart after crash)."""
        replica = self.replicas.get(name)
        if replica is None:
            return
        with replica._lock:
            if (replica._pending is _EMPTY or replica._queued
                    or not replica.alive):
                return
            replica._queued = True
        self._q.put(name)

    def _worker(self) -> None:
        while True:
            name = self._q.get()
            if name is _STOP:
                return
            try:
                self.replicas[name].run_pending()
            except Exception:
                log.exception("worker failed on %s", name)

    def stop(self) -> None:
        for _ in self._threads:
            self._q.put(_STOP)
        for t in self._threads:
            t.join(timeout=5)
        for r in self.replicas.values():
            r.close()
