"""L3 — the per-node agent: watch desired state, reconcile, publish status.

Orchestration mirrors the union of the reference's Go agent (startup +
coalesced reconcile loop, cmd/main.go:119-170) and Python agent
(watch_and_apply, main.py:585-700), with the additions SURVEY.md §7.2
step 5 calls for: metrics around every reconcile, /healthz, and optional
slice coordination.

Error philosophy (reference cmd/main.go:164-167 + main.py:300-307):

- a *reconcile* failure is logged, published as ``cc.mode.state=failed``,
  and the loop continues — the next label event retries;
- a *fatal* condition (mixed-capability node, 10 consecutive watch
  errors) exits the process; the DaemonSet restart policy is the
  recovery mechanism (SURVEY.md §5.3).
"""

from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import uuid
import time
from contextlib import contextmanager
from typing import Iterator, Optional

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.config import AgentConfig
from tpu_cc_manager_torch.drain import (
    EVENT_FOR_OUTCOME, NodeFlipTaint, build_drainer, build_node_event,
    post_event_best_effort,
)
from tpu_cc_manager_torch.engine import FatalModeError, ModeEngine
from tpu_cc_manager_torch.flightrec import FlightRecorder, set_recorder
from tpu_cc_manager_torch.k8s.batch import NodePatchBatcher
from tpu_cc_manager_torch.k8s.client import KubeClient
from tpu_cc_manager_torch.modes import STATE_FAILED, InvalidModeError
from tpu_cc_manager_torch.slice_coord import SliceAbortError
from tpu_cc_manager_torch.obs import HealthServer, Metrics, create_readiness_file
from tpu_cc_manager_torch.profiler import SamplingProfiler
from tpu_cc_manager_torch.trace import JsonlSink, Tracer, get_tracer
from tpu_cc_manager_torch.tsring import TimeSeriesRing
from tpu_cc_manager_torch.watchdog import Watchdog
from tpu_cc_manager_torch.watch import FatalWatchError, NodeWatcher, SyncableModeConfig

log = logging.getLogger("tpu-cc-manager.agent")

#: sentinel telling the event-recorder worker to exit
_EVENT_STOP: dict = {}


def with_default(value: Optional[str], default: Optional[str]) -> Optional[str]:
    """Empty/absent label falls back to the default mode (reference
    main.py:691-697; cmd/main.go:158-161). Returns None when neither is
    set, meaning 'nothing to reconcile'."""
    if value:
        return value
    return default or None


class CCManagerAgent:
    #: sentinel for "no evidence build yet this process" — distinct from
    #: None, which means "built unsigned" and must trigger a republish
    #: when a key later appears
    _KEY_UNSET = object()

    def __init__(
        self,
        kube: KubeClient,
        cfg: AgentConfig,
        *,
        metrics: Optional[Metrics] = None,
        slice_coordinator=None,
        backend=None,
        tracer: Optional[Tracer] = None,
    ):
        self.kube = kube
        self.cfg = cfg
        self.metrics = metrics or Metrics()
        # per-agent tracer (not the process-wide one): the multi-node
        # simulation runs many agents in one process, and each agent's
        # spans must land only in its own metrics/sinks. An injected
        # tracer must be dedicated to this agent — sinks are added to it,
        # so sharing one across agents double-counts every span.
        self.tracer = tracer or Tracer()
        self.tracer.add_sink(self.metrics.observe_span)
        if cfg.trace_file:
            self.tracer.add_sink(JsonlSink(cfg.trace_file))
        # the in-process time-series ring (tsring.py, ISSUE 9):
        # periodic snapshots of every registered metric, windowed into
        # rates and quantile estimates on /debug/timeseries and inside
        # flight-recorder dumps
        self.tsring = TimeSeriesRing(self.metrics, name=cfg.node_name)
        # the sampling profiler (profiler.py, ISSUE 15): disarmed and
        # free until an operator arms it (TPU_CC_PROFILER=1) or the
        # watchdog auto-arms a capture burst on an anomaly
        self.profiler = SamplingProfiler(name=cfg.node_name)
        # the per-process black box (flightrec.py, ISSUE 8): recent
        # spans + structured events + host-contention samples, dumped
        # on reconcile failure / SIGTERM / GET /debug/flightrec
        self.flightrec = FlightRecorder(
            name=cfg.node_name, metrics=self.metrics,
            dump_dir=cfg.flightrec_dir, tsring=self.tsring,
            profiler=self.profiler,
        )
        self.tracer.add_sink(self.flightrec.observe_span)
        # the online anomaly watchdog (watchdog.py, ISSUE 15): scores
        # the declared flip/reconcile series on every tsring tick and
        # assembles an incident packet — window stats + exemplar trace
        # ids + a live profile + a throttled black-box dump — served
        # at GET /debug/incidents
        self.watchdog = Watchdog(
            sources=[self.metrics], profiler=self.profiler,
            recorder=self.flightrec, name=cfg.node_name,
        )
        self.tsring.add_listener(self.watchdog.consume)
        # modules that can't take an injected recorder (the batcher's
        # publish-loss accounting) note into the process-wide one:
        # point it at this agent's black box
        set_recorder(self.flightrec)
        self.config_mailbox = SyncableModeConfig(
            on_coalesced=lambda: self.metrics.coalesced_total.inc()
        )
        #: pulsed by every node-watch delta: an in-flight drain wait
        #: (drain.py's pod-wait loops) re-checks on the event instead
        #: of the next poll boundary (ISSUE 14's wake treatment)
        self._drain_wake = threading.Event()
        self.watcher = NodeWatcher(
            kube,
            cfg.node_name,
            self.config_mailbox,
            on_fatal=self._on_fatal_watch,
            on_error=lambda: self.metrics.watch_errors_total.inc(),
            on_event=lambda etype, node: self._drain_wake.set(),
        )
        self.slice_coordinator = slice_coordinator
        if (
            slice_coordinator is not None
            and slice_coordinator.tracer is get_tracer()
        ):
            # coordinator was built without an explicit tracer: adopt it so
            # slice_wait spans land in this agent's trace tree (a tracer
            # injected into the coordinator is left alone)
            slice_coordinator.tracer = self.tracer
        if (
            slice_coordinator is not None
            and slice_coordinator.should_abort is None
        ):
            # an in-flight slice round is superseded the moment a newer
            # desired mode lands in the mailbox — don't stall the round
            # out to its timeout
            slice_coordinator.should_abort = self._superseded_by_pending

        self._backend = backend
        # the write-coalescing I/O layer (k8s.batch, ISSUE 6): evidence
        # and doctor publications defer into it, the taint layer's CAS
        # replaces carry them, the fail-secure state write drains it
        # synchronously, and the idle tick flushes whatever found no
        # carrier. Loss accounting lands in the metrics counters.
        self.batcher = NodePatchBatcher(
            kube, cfg.node_name,
            tracer=self.tracer,
            recorder=self.flightrec,
            on_coalesced=(
                lambda kind: self.metrics
                .publications_coalesced_total.inc(kind)
            ),
            on_retry=(
                lambda kind: self.metrics.publish_retries_total.inc()
            ),
            on_drop=(
                lambda kind: self.metrics
                .publications_dropped_total.inc(kind)
            ),
        )
        self.engine = ModeEngine(
            set_state_label=self._set_state_label,
            drainer=build_drainer(kube, cfg, wake=self._drain_wake),
            evict_components=cfg.evict_components and cfg.drain_strategy != "none",
            backend=backend,
            tracer=self.tracer,
            flip_taint=NodeFlipTaint(
                kube, cfg.node_name,
                batcher=self.batcher,
                node_hint=self.watcher.latest_node,
            ),
            # when the taint-clear replace carries the label, the
            # current-mode gauge still has to move
            notify_state_label=self.metrics.set_current_mode,
            # the long-lived agent keeps the flip executor's worker
            # pool (and through the shared client pool, its warm
            # connections) across reconciles; shutdown() closes it
            persistent_flip_pool=True,
            # host-contention samples bracket every device flip
            recorder=self.flightrec,
        )
        self.health: Optional[HealthServer] = None
        self._fatal: Optional[Exception] = None
        self._stop = threading.Event()
        self.reconcile_count = 0
        self.last_outcome = "none"
        # self-repair state: the last desired mode whose reconcile failed,
        # and the earliest monotonic time a retry may run (VERDICT r1
        # item 8 — heal half-flipped slices without operator relabeling)
        self._repair_mode: Optional[str] = None
        self._repair_due: float = 0.0
        self._repair_failures = 0  # consecutive failures for one mode
        # evidence delivery generations: wanted > published means the
        # newest evidence hasn't landed on the cluster (failed/dropped
        # write) and the idle tick should republish. A stale queued
        # task's success can never mask a newer miss — each task only
        # advances published to ITS OWN generation.
        self._evidence_wanted_gen = 0
        self._evidence_published_gen = 0
        self._evidence_retry_due = 0.0
        self._evidence_key_check_due = 0.0
        #: wall-clock deadline to republish evidence before its
        #: embedded identity token expires (None: no expiring token)
        self._evidence_identity_refresh_at: Optional[float] = None
        #: the key the last evidence build signed with; the idle tick
        #: republishes when the live key differs (the Secret appearing
        #: on a converged, otherwise-idle fleet must re-sign every
        #: node's evidence — no mode flip will ever come to do it).
        #: Sentinel: no build yet this process
        self._evidence_key_used: object = self._KEY_UNSET
        #: the attestation (fake-TPM quote) key of the last build —
        #: same posture-watch treatment as the evidence key
        self._attest_key_used: object = self._KEY_UNSET
        #: the key of the last SUCCESSFULLY PUBLISHED document — the
        #: CCEvidenceResigned Event compares against this, so it fires
        #: only for re-signs that landed, on whichever path landed them
        self._evidence_published_key: object = self._KEY_UNSET
        # periodic doctor self-check throttle (first run shortly after
        # startup, then every doctor_interval_s)
        self._doctor_due = 0.0
        # idle-tick gate drift-heal throttle
        self._gate_reassert_due = 0.0
        # Event-name uniqueness: per-process counter + a startup-unique
        # token, so a restarted agent never collides with the previous
        # process's still-live events (409 AlreadyExists would silently
        # drop them). itertools.count: next() is atomic under the GIL,
        # and events are emitted from two threads (reconcile outcomes,
        # and CCEvidenceResigned from inside the recorder's publish
        # task) — a racing += could mint duplicate names whose second
        # create 409s and is silently dropped.
        self._event_seq = itertools.count(1)
        self._event_token = uuid.uuid4().hex[:8]
        self._event_warned = False
        # Async event delivery (client-go EventRecorder parity): the
        # reconcile loop enqueues, a daemon worker POSTs — an API-server
        # hiccup or slow event write must never stretch reconcile
        # latency. Bounded: overflow drops the event (observability,
        # not correctness).
        self._event_queue: "queue.Queue[dict]" = queue.Queue(maxsize=64)
        self._event_worker: Optional[threading.Thread] = None
        # _event_lock makes close+enqueue atomic: without it a reconcile
        # thread could pass the closed check, lose the CPU, and enqueue
        # behind the stop sentinel into a dead queue
        self._event_lock = threading.Lock()
        self._events_closed = False  # set by shutdown; no enqueues after

    # ------------------------------------------------------------ plumbing
    def _set_state_label(self, value: str) -> None:
        """Publish the observed-state label through the batcher: still
        ONE synchronous, ordered write (fail-secure — a failure raises
        to the reconcile error paths exactly as the plain patch did),
        but the patch also carries any pending evidence/doctor
        publications, so the ordered write doubles as their carrier."""
        self.batcher.write_state_label(value)
        self.metrics.set_current_mode(value)

    def _superseded_by_pending(self, in_flight_mode: str) -> bool:
        """True when the mailbox holds a pending desired value that
        RESOLVES (with_default) to a different mode than the in-flight
        round — a label flap or removal that coalesces back to the same
        effective mode is not a supersession, just churn."""
        has, value = self.config_mailbox.peek_pending()
        if not has:
            return False
        return with_default(value, self.cfg.default_mode) != in_flight_mode

    def _reconcile_current(self, mode: str) -> bool:
        """Reconcile, following supersessions: a superseded round
        immediately re-reconciles the NEWEST desired mode — consuming
        the pending mailbox value if one is still there, or re-running
        the same mode if a flap coalesced back to it (the aborted
        round's ack was retracted, so it must re-run either way). Without
        this, an X->Y->X flap observed mid-round would abort the X round
        and then block on the mailbox forever with X unapplied."""
        # ccaudit: allow-retry-discipline(supersession follow-up, not congestion retry: each turn consumes an already-DELIVERED newer mode from the mailbox (or one label re-read) — pacing it would just hold the freshest desired state unapplied; the stop check bounds it)
        while True:
            ok = self.reconcile(mode)
            if self.last_outcome != "superseded" or self._stop.is_set():
                return ok
            got, value = self.config_mailbox.get(timeout=0)
            if not got:
                # nothing pending — either a flap coalesced back to this
                # mode, or the watcher isn't feeding the mailbox yet (the
                # STARTUP reconcile runs before watcher.start()). Re-read
                # the label directly: re-running the old mode against a
                # changed label would supersede-abort forever.
                try:
                    node = self.kube.get_node(self.cfg.node_name)
                    value = (node["metadata"].get("labels") or {}).get(
                        L.CC_MODE_LABEL)
                except Exception:
                    log.warning("desired-label re-read failed; retrying "
                                "the superseded mode", exc_info=True)
                    continue
            new_mode = with_default(value, self.cfg.default_mode)
            if new_mode is None:
                # desired mode withdrawn entirely (label removed, no
                # default): the superseded round stays unapplied by design
                self._disarm_repair()
                return ok
            mode = new_mode

    def _publish_evidence(self) -> None:
        """Best-effort per-flip attestation evidence annotation (see
        tpu_cc_manager.evidence): published after every successful
        reconcile so the fleet controller can audit evidence-vs-label
        consistency. Delivered through the COALESCING publish core
        (k8s.batch): the document defers into the batcher, rides the
        next node write (usually the next flip's taint set) or the idle
        tick's flush, and only the newest generation is ever sent — an
        API-server hiccup or slow annotation write never stretches
        reconcile latency, superseded generations are counted
        (publications_coalesced_total), and a publish that exhausts the
        flush retry budget is re-deferred from the idle tick because
        published < wanted. Staleness in between is visible, not
        silent — the fleet audit flags it."""
        if not self.cfg.emit_evidence:
            return
        import json as _json

        from tpu_cc_manager_torch import device as devlayer
        from tpu_cc_manager_torch.evidence import build_evidence, evidence_key

        # this publication's generation: anything that keeps it from
        # landing (build failure, queue overflow, write failure) leaves
        # published < wanted, and the idle tick republishes — stale
        # on-cluster evidence reads as a label-vs-device contradiction
        # to auditors, and the next label change may never come
        self._evidence_wanted_gen += 1
        gen = self._evidence_wanted_gen

        # build the document SYNCHRONOUSLY (cheap local reads): a
        # drain-time build could race the next flip and attest a torn
        # mid-transition state under the old reconcile's banner. Only
        # the API write is deferred.
        try:
            with self.tracer.span("evidence_build"):
                from tpu_cc_manager_torch.attest import tpm_key

                backend = self._backend or devlayer.get_backend()
                key = evidence_key()
                # snapshot BEFORE the build: a rotation landing between
                # this read and the quote's own would then record the
                # OLD key against a new-key quote — one harmless extra
                # republish on the next idle tick; reading AFTER would
                # record the NEW key against an old-key quote and
                # suppress the re-sign forever
                akey = tpm_key()
                doc = build_evidence(self.cfg.node_name, backend,
                                     key=key)
                payload = _json.dumps(doc, sort_keys=True,
                                      separators=(",", ":"))
            # recorded at build time (not publish time): what matters
            # for the idle tick's re-sign check is the posture of the
            # newest document headed for the cluster. The attestation
            # key rides along: a rotated TPM key must re-sign quotes
            # the same way a rotated pool key re-signs digests.
            self._evidence_key_used = key
            self._attest_key_used = akey
            self._evidence_identity_refresh_at = (
                self._evidence_refresh_deadline(doc)
            )
        except Exception:
            log.warning("evidence build failed; will retry", exc_info=True)
            return

        def landed(published_gen: int) -> None:
            # runs on whichever thread's write carried the document
            # (taint CAS, state patch, or idle-tick flush). Advance
            # published only to THIS publication's generation — a stale
            # write's success must not mask a newer miss.
            self._evidence_published_gen = max(
                self._evidence_published_gen, published_gen
            )
            # rotation progress is fleet-visible only for documents
            # that actually LANDED: compare signing posture against
            # the last successfully published one, so the Event is
            # truthful (never claims a failed publish) and fires on
            # whichever path re-signed — the idle-tick posture
            # check, the dropped-publish retry, or a plain flip
            prev = self._evidence_published_key
            self._evidence_published_key = key
            if prev is not self._KEY_UNSET and key != prev:
                self._emit_node_event(
                    "CCEvidenceResigned",
                    "evidence key posture changed (Secret "
                    "appeared/rotated/removed); re-signed "
                    "attestation evidence with the current key",
                )

        self.batcher.defer(
            "evidence",
            annotations={L.EVIDENCE_ANNOTATION: payload},
            gen=gen,
            on_published=landed,
        )

    def _evidence_refresh_deadline(self, doc: dict) -> Optional[float]:
        """The earlier of the identity-token and attestation-token
        refresh deadlines: either aging out makes the idle tick
        republish. Fake-tpm quotes carry no expiry (their freshness is
        the key posture check)."""
        from tpu_cc_manager_torch.attest import quote_refresh_deadline

        deadlines = [
            d for d in (
                self._identity_refresh_deadline(doc),
                quote_refresh_deadline(doc),
            ) if d is not None
        ]
        return min(deadlines) if deadlines else None

    def _identity_refresh_deadline(self, doc: dict) -> Optional[float]:
        """Wall-clock time at which the evidence should be republished
        because its embedded identity token nears expiry (verifiers
        class an expired token with 'missing'; an idle node must
        refresh BEFORE that, since no flip will come to do it). None
        when no identity is expected or the token carries no expiry."""
        try:
            token = (doc.get("identity") or {}).get("token")
            if not token:
                from tpu_cc_manager_torch.identity import get_identity_provider

                if get_identity_provider() is not None:
                    # a provider is configured but the fetch failed
                    # (metadata blip): RETRY from the idle tick — one
                    # blip must not strip identity from this node's
                    # evidence for the rest of the process lifetime
                    return time.time() + 2 * (
                        self.cfg.repair_interval_s or 30.0
                    )
                return None
            from tpu_cc_manager_torch.identity import token_claims

            _, claims = token_claims(token)
            exp = claims.get("exp")
            iat = claims.get("iat", time.time())
            if not isinstance(exp, (int, float)):
                return None
            # refresh when REPUBLISH_MARGIN of the lifetime remains
            # (see identity.py for why it sits inside the token cache's
            # serve margin) — comfortably ahead of the verifier-visible
            # expiry (~12 min for 1 h GCE tokens)
            from tpu_cc_manager_torch.identity import REPUBLISH_MARGIN

            return float(exp) - REPUBLISH_MARGIN * max(
                float(exp) - float(iat), 0.0
            )
        except Exception:
            log.debug("evidence republish deadline unparseable; "
                      "relying on the repair-interval fallback",
                      exc_info=True)
            return None

    def _on_fatal_watch(self, exc: Exception) -> None:
        self._fatal = exc
        self._stop.set()
        self.config_mailbox.close()

    def _prime_with_retry(self) -> Optional[str]:
        """Initial node read with the watch loop's backoff/fatal policy
        (reference main.py:664-689 applied to startup)."""
        from tpu_cc_manager_torch.k8s.client import ApiException

        attempts = 0
        while True:
            try:
                return self.watcher.prime()
            except ApiException as e:
                attempts += 1
                self.metrics.watch_errors_total.inc()
                if attempts >= self.watcher.max_consecutive_errors:
                    raise FatalWatchError(
                        f"{attempts} consecutive failures reading node "
                        f"{self.cfg.node_name} at startup; last: {e}"
                    ) from e
                log.warning(
                    "startup node read failed (%d): %s; retrying in %.1fs",
                    attempts, e, self.watcher.backoff_s,
                )
                # event wait, not a fixed sleep: shutdown (the only
                # wake source at startup) cuts the backoff short
                if self._stop.wait(self.watcher.backoff_s):
                    return None

    # ----------------------------------------------------------- reconcile
    @contextmanager
    def _reconcile_span(self, raw_mode: str) -> Iterator[object]:
        """The reconcile root span, seated under the desired-writer's
        cross-process trace context when the watched node carries one
        (the cc.trace annotation rides the same write — and therefore
        the same watch event — as the desired label): ONE trace then
        spans controller desired-write → watch delivery → drain →
        flip phases → state publish. A missing/garbled annotation
        degrades to the historical local root."""
        with self.tracer.adopt_remote(self.watcher.latest_trace_context()):
            with self.tracer.span("reconcile", mode=raw_mode) as root:
                yield root

    def reconcile(self, raw_mode: str) -> bool:
        """One mode application, instrumented. Never raises except
        FatalModeError."""
        start = time.monotonic()
        outcome = "error"
        try:
            return self._reconcile_traced(raw_mode, start)
        finally:
            # OUTSIDE the span context: the root reconcile span has hit
            # the sinks (flightrec's ring included) by now, so a
            # failure dump contains the very reconcile it documents —
            # outcome attr, duration, and adopted cross-process parent
            outcome = self.last_outcome or outcome
            self.flightrec.note(
                "reconcile", mode=raw_mode, outcome=outcome,
                dur_s=round(time.monotonic() - start, 4),
            )
            if outcome in ("failure", "error", "slice_abort", "fatal"):
                # the black box leaves the scene of the crash: recent
                # spans, events, host samples, and a metrics snapshot
                # land in one JSON artifact (throttled — a flapping
                # device can't fill the disk)
                self.flightrec.maybe_dump(f"reconcile_{outcome}")

    def _reconcile_traced(self, raw_mode: str, start: float) -> bool:
        outcome = "error"
        with self._reconcile_span(raw_mode) as root_span:
            try:
                if self.slice_coordinator is not None:
                    ok = self.slice_coordinator.apply_slice_coherent(
                        raw_mode, self.engine
                    )
                else:
                    ok = self.engine.set_mode(raw_mode)
                outcome = "success" if ok else "failure"
                return ok
            except InvalidModeError as e:
                # bad label value: report, keep serving (the operator may
                # fix it)
                log.error("rejecting desired mode: %s", e)
                try:
                    self._set_state_label(STATE_FAILED)
                except Exception:
                    log.exception("failed to publish failed state")
                outcome = "invalid"
                return False
            except SliceAbortError as e:
                # the slice never agreed; local devices untouched
                log.error("slice coordination aborted: %s", e)
                if e.shutting_down:
                    # termination artifact, not a real failure: leave the
                    # durable state label alone
                    outcome = "shutdown"
                    return False
                if e.superseded:
                    # the operator changed the desired mode mid-round: not
                    # a failure — the mailbox already holds the new mode
                    # and the main loop reconciles it immediately. No
                    # failed label, no Warning event, no repair arming.
                    outcome = "superseded"
                    return False
                try:
                    self._set_state_label(STATE_FAILED)
                except Exception:
                    log.exception("failed to publish failed state")
                outcome = "slice_abort"
                return False
            except FatalModeError:
                outcome = "fatal"
                raise
            except Exception:
                log.exception("reconcile crashed")
                try:
                    self._set_state_label(STATE_FAILED)
                except Exception:
                    log.exception("failed to publish failed state")
                return False
            finally:
                dur = time.monotonic() - start
                self.last_outcome = outcome
                if outcome == "success":
                    self._publish_evidence()
                self._arm_repair(raw_mode, outcome)
                self._emit_reconcile_event(raw_mode, outcome, dur)
                root_span.attrs["outcome"] = outcome
                # the reconcile's trace id rides as the latency
                # bucket's exemplar (ISSUE 15): a slow bucket on
                # /metrics points at THIS reconcile's trace
                self.metrics.reconcile_duration.observe(
                    dur, trace_id=root_span.trace_id)
                self.metrics.reconciles_total.inc(outcome)
                self.reconcile_count += 1
                log.info("reconcile finished: %s in %.3fs", outcome, dur)

    def _publish_doctor(self) -> None:
        """Periodic trust-surface self-check (tpu_cc_manager.doctor)
        published as the cc.doctor annotation for the fleet controller
        to aggregate. Runs on the idle tick, so it must never raise and
        never block the mailbox for long; the report build is local
        reads plus one get_node, and the verdict write defers into the
        coalescing batcher like evidence — it rides the next node write
        or flush, and only the newest verdict is ever sent."""
        import json as _json

        from tpu_cc_manager_torch import device as devlayer
        from tpu_cc_manager_torch.doctor import run_doctor

        try:
            with self.tracer.span("doctor"):
                backend = self._backend or devlayer.get_backend()
                report = run_doctor(
                    kube=self.kube, node_name=self.cfg.node_name,
                    backend=backend,
                )
            summary = {
                "ok": report["ok"],
                "fail": sorted({c["name"] for c in report["checks"]
                                if c["severity"] == "fail"}),
                "warn": sorted({c["name"] for c in report["checks"]
                                if c["severity"] == "warn"}),
                "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            }
            payload = _json.dumps(summary, sort_keys=True,
                                  separators=(",", ":"))
        except Exception:
            log.warning("doctor self-check failed", exc_info=True)
            return
        if not report["ok"]:
            log.warning("doctor self-check failing: %s", summary["fail"])

        ok_label = "true" if report["ok"] else "false"
        # annotation = detail, label = selectable mirror; one deferred
        # publication so both always land in the same write
        self.batcher.defer(
            "doctor",
            labels={L.DOCTOR_OK_LABEL: ok_label},
            annotations={L.DOCTOR_ANNOTATION: payload},
        )

    def _emit_reconcile_event(self, mode: str, outcome: str, dur: float) -> None:
        """Best-effort core/v1 Event so `kubectl describe node` carries
        the mode-flip history (the reference records outcomes only in a
        label + pod logs). Never interferes with the reconcile result."""
        hit = EVENT_FOR_OUTCOME.get(outcome)
        if hit is None:
            return
        reason, etype = hit
        self._emit_node_event(
            reason,
            f"cc mode reconcile to '{mode}': {outcome} in {dur:.2f}s",
            etype, infix="cc-reconcile",
        )

    def _emit_node_event(self, reason: str, message: str,
                         etype: str = "Normal", *,
                         infix: str = "cc-maint") -> None:
        """Best-effort node Event through the async recorder — reconcile
        outcomes and trust-surface maintenance (key rotation) both show
        in `kubectl describe node`. ``infix`` keeps the two name
        spaces distinct."""
        if not self.cfg.emit_events:
            return
        seq = next(self._event_seq)
        event = build_node_event(
            self.cfg.node_name, reason, message, etype,
            name=(
                f"{self.cfg.node_name}.{infix}."
                f"{self._event_token}.{seq}"
            ),
        )
        if self._enqueue_recorder_item(event) == "full":
            self.metrics.events_dropped_total.inc()
            log.debug("event queue full; dropping %s", reason)

    def _enqueue_recorder_item(self, item) -> str:
        """Hand an Event dict or a callable task to the async recorder
        worker. Returns "ok", "closed" (shutting down — a routine
        non-delivery, not a drop), or "full" (bounded-queue overflow —
        the caller accounts for the drop)."""
        with self._event_lock:
            if self._events_closed:
                return "closed"  # would strand behind the STOP sentinel
            if self._event_worker is None or not self._event_worker.is_alive():
                self._event_worker = threading.Thread(
                    target=self._event_loop, daemon=True,
                    name="cc-event-recorder",
                )
                self._event_worker.start()
            try:
                self._event_queue.put_nowait(item)
                return "ok"
            except queue.Full:
                return "full"

    def _event_loop(self) -> None:
        """Daemon worker draining the recorder queue (Event dicts and
        callable tasks such as evidence publication). One failed POST
        must never affect a reconcile. A clientset without Events support
        (501) stays at debug; anything else (403 RBAC missing, 400
        validation) warns once so a misconfigured deployment doesn't
        silently lose the whole feature."""
        while True:
            # ccaudit: allow-stop-aware-wait(the _EVENT_STOP sentinel IS the wakeup: stop() enqueues it, so this blocking get returns immediately on shutdown — a timeout would only add idle churn to a daemon drain thread)
            event = self._event_queue.get()
            try:
                if event is _EVENT_STOP:
                    return
                if callable(event):
                    try:
                        event()
                    except Exception:
                        log.exception("async recorder task failed")
                    continue
                delivered, warned = post_event_best_effort(
                    self.kube, event, warned_before=self._event_warned
                )
                if delivered:
                    self.metrics.events_emitted_total.inc()
                if warned:
                    self._event_warned = True
            finally:
                self._event_queue.task_done()

    def flush_events(self, timeout: float = 5.0) -> bool:
        """Block until queued events AND deferred publications are
        delivered (tests + shutdown). The batcher flush is synchronous;
        a failed flush stays pending (retry machinery owns it) and does
        not fail this wait — same contract the recorder queue had."""
        self.batcher.flush()
        if self._event_worker is None or not self._event_worker.is_alive():
            return True
        # queue-join with a deadline: ride the queue's own
        # all_tasks_done condition (task_done() notifies it) instead
        # of spinning a 10ms poll against the worker's progress
        deadline = time.monotonic() + timeout
        with self._event_queue.all_tasks_done:
            while self._event_queue.unfinished_tasks:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._event_queue.all_tasks_done.wait(remaining)
        return True

    # -------------------------------------------------------------- repair
    def _disarm_repair(self) -> None:
        self._repair_mode = None
        self._repair_failures = 0

    def _arm_repair(self, mode: str, outcome: str) -> None:
        """Arm (or disarm) the self-repair retry; runs at the end of
        every reconcile.

        Only *retryable* failures arm it: an invalid label value fails
        deterministically until the operator fixes the label, and that
        label change triggers its own reconcile — retrying would just
        churn the API server. Consecutive failures for the same mode
        back off exponentially (capped at 32x the base interval): a
        persistently stuck slice member would otherwise cost a full
        commit-timeout wait every repair_interval_s, starving the event
        loop and hammering the API server with the slice wait's 1 Hz
        node lists."""
        if (
            not self.cfg.repair_interval_s
            or self._stop.is_set()
            or outcome not in ("failure", "slice_abort", "error")
        ):
            self._disarm_repair()
            return
        if mode != self._repair_mode:
            self._repair_failures = 0
        self._repair_mode = mode
        self._repair_failures += 1
        delay = self.cfg.repair_interval_s * min(
            2 ** (self._repair_failures - 1), 32
        )
        self._repair_due = time.monotonic() + delay
        # fast-track the next doctor self-check: a failed flip changes
        # the node's trust surfaces (fail-secure gate lock, statefile
        # state) and the fleet should see the failing verdict within
        # seconds, not after the remaining doctor interval
        self._doctor_due = 0.0

    def _maybe_repair(self) -> None:
        """Idle-tick self-repair: retry the last failed reconcile.

        The reference retries only on the next label *event*
        (cmd/main.go:164-167) — but a half-flipped slice never produces
        one: the desired label is already correct, only this node's
        device state (and ``cc.mode.state=failed``) lag. Retrying here
        re-enters the slice protocol, observes the still-actionable
        quorum commit on the anchor, and converges the laggard without
        any operator relabeling (VERDICT r1 item 8). Plain (non-slice)
        device faults heal the same way.
        """
        now = time.monotonic()
        # deliver deferred publications that found no carrier write
        # FIRST: the doctor check below reads the on-cluster evidence,
        # and the retry branch must not mistake "awaiting its flush"
        # for "failed"
        self.batcher.maybe_flush()
        if (self.cfg.emit_evidence
                and self._evidence_published_gen < self._evidence_wanted_gen
                and not self.batcher.has_pending("evidence")
                and now >= self._evidence_retry_due):
            # a dropped/failed evidence publish left stale on-cluster
            # evidence; republish from current device state (throttled —
            # a persistently failing API must not be hammered every tick)
            self._evidence_retry_due = now + (
                self.cfg.repair_interval_s or 30.0
            )
            self._publish_evidence()
        elif (self.cfg.emit_evidence
                and self._evidence_key_used is not self._KEY_UNSET
                and now >= self._evidence_key_check_due):
            # key-posture change: the evidence-key Secret appeared (or
            # rotated/vanished) on an idle, converged node. No mode flip
            # will ever come to re-sign the annotation, and a keyed
            # verifier would read the stale unsigned document as an
            # 'unsigned' fleet problem telling the operator to apply a
            # fix they already applied — so the agent re-signs here.
            # Advanced on EVERY check, not just on change: idle ticks
            # run ~1/s and the Secret file must not be opened that often
            from tpu_cc_manager_torch.attest import tpm_key
            from tpu_cc_manager_torch.evidence import evidence_key

            self._evidence_key_check_due = now + (
                self.cfg.repair_interval_s or 30.0
            )
            if (evidence_key() != self._evidence_key_used
                    or tpm_key() != self._attest_key_used):
                log.info(
                    "evidence key posture changed; re-signing evidence"
                )
                # the CCEvidenceResigned Event rides the publish task:
                # it fires only once the re-signed document LANDS
                self._publish_evidence()
            elif (self._evidence_identity_refresh_at is not None
                    and time.time()
                    >= self._evidence_identity_refresh_at):
                # the embedded identity token nears expiry and no flip
                # is coming: republish so verifiers never see this
                # idle node's identity age out into 'expired'
                log.info("identity token nearing expiry; refreshing "
                         "evidence")
                self._publish_evidence()
        # heal gate-perms drift on idle nodes (same cadence as repair;
        # local chmods only, no cluster traffic)
        if self.cfg.repair_interval_s and now >= self._gate_reassert_due:
            self._gate_reassert_due = now + self.cfg.repair_interval_s
            self.engine.reassert_gate()
        # periodic doctor self-check published as the cc.doctor
        # annotation: keeps the fleet controller's trust-surface
        # aggregation fresh without anyone running doctor by hand
        if self.cfg.doctor_interval_s and now >= self._doctor_due:
            self._doctor_due = now + self.cfg.doctor_interval_s
            self._publish_doctor()
        if self._repair_mode is None or time.monotonic() < self._repair_due:
            return
        mode = self._repair_mode
        log.info("self-repair: retrying failed reconcile to %r", mode)
        self.metrics.repairs_total.inc()
        self.reconcile(mode)  # re-arms (with backoff) or disarms itself

    # ---------------------------------------------------------------- run
    def run(self, max_reconciles: Optional[int] = None) -> int:
        """Run the agent. Returns a process exit code. ``max_reconciles``
        bounds loop iterations for tests/bench (None = forever)."""
        cfg = self.cfg
        if self.slice_coordinator is not None:
            self.slice_coordinator.start()
        if cfg.health_port:  # 0 disables (SURVEY.md §5.6 table)
            try:
                self.health = HealthServer(
                    self.metrics, port=cfg.health_port,
                    tracer=self.tracer, flightrec=self.flightrec,
                    tsring=self.tsring, watchdog=self.watchdog,
                ).start()
            except OSError as e:
                log.warning("health server disabled: %s", e)
        self.tsring.start()
        if os.environ.get("TPU_CC_PROFILER", "").lower() in (
                "1", "true", "yes"):
            # operator opt-in continuous sampling (the on-demand half
            # of ISSUE 15; the watchdog's capture bursts need no arm)
            self.profiler.arm()

        try:
            # initial read + reconcile (reference cmd/main.go:131-149,
            # main.py:614-617); transient API errors at startup get the
            # same backoff treatment as the watch loop
            initial = self._prime_with_retry()
            mode = with_default(initial, cfg.default_mode)
            # a prime cut short by shutdown returns None — that is NOT
            # "no label, apply the default": a stopping agent must not
            # drain and flip the node toward the default on its way out
            if mode is not None and not self._stop.is_set():
                ok = self._reconcile_current(mode)
                if (not ok and initial is None
                        and self.last_outcome not in ("superseded",
                                                      "shutdown")):
                    # startup default-apply failure is fatal in the Go agent
                    # (cmd/main.go:141-145); a superseded or shutting-down
                    # startup round is not a failure
                    log.error("initial default-mode apply failed; exiting")
                    return 1
            # signal readiness only after the initial reconcile
            # (reference main.py:617, scripts/cc-manager.sh:536)
            create_readiness_file(cfg.readiness_file)
            if self.health:
                self.health.ready = True

            self.watcher.start()
            while not self._stop.is_set():
                got, value = self.config_mailbox.get(timeout=1.0)
                if not got:
                    if max_reconciles is not None and self.reconcile_count >= max_reconciles:
                        break
                    self._maybe_repair()
                    continue
                if self._stop.is_set():
                    break
                mode = with_default(value, cfg.default_mode)
                if mode is None:
                    # desired mode withdrawn (label removed, no default):
                    # a pending repair must not re-apply the stale mode
                    self._disarm_repair()
                    continue
                # failure: log + continue (go :164-167); supersession:
                # retried inside with the newest mode
                self._reconcile_current(mode)
                if max_reconciles is not None and self.reconcile_count >= max_reconciles:
                    break
            if self._fatal is not None:
                log.error("agent exiting on fatal error: %s", self._fatal)
                return 1
            return 0
        except FatalModeError as e:
            log.error("fatal: %s", e)
            return 1
        except FatalWatchError as e:
            log.error("fatal: %s", e)
            return 1
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self._stop.set()
        # close the recorder first (under the lock, so a reconcile
        # finishing concurrently either enqueued before the close or
        # skips emission entirely — nothing can land behind STOP), then
        # deliver what's queued and stop the worker
        with self._event_lock:
            self._events_closed = True
        self.flush_events(timeout=2.0)
        if self._event_worker is not None and self._event_worker.is_alive():
            try:
                self._event_queue.put_nowait(_EVENT_STOP)
            except queue.Full:
                pass
        if self.slice_coordinator is not None:
            self.slice_coordinator.stop()
        self.tsring.stop()
        self.profiler.disarm()
        self.watcher.stop()
        # best-effort final flush of deferred publications, then release
        # the engine's persistent flip-executor threads
        try:
            self.batcher.close()
        except Exception:
            log.warning("final publish flush failed", exc_info=True)
        self.engine.close()
        if self.health:
            self.health.live = False
            self.health.stop()
            self.health = None
