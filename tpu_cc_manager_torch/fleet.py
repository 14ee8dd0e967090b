"""Fleet controller — the long-running operator-side audit service.

The per-node agents make each node converge; the rollout tool changes a
pool on purpose; this controller answers "what state is the fleet in
RIGHT NOW" continuously. It periodically lists the pool, runs the JAX
fleet planner (tpu_cc_manager.plan — one fused XLA computation over the
whole fleet), and serves:

- ``GET /metrics`` — pool-level Prometheus gauges: nodes per observed
  mode, divergence count, failed count, incoherent / half-flipped slice
  counts, scan duration;
- ``GET /report``  — the latest full fleet report as JSON (the same
  shape as ``python -m tpu_cc_manager.plan``);
- ``GET /healthz`` — liveness (scan loop alive and not persistently
  failing).

Deliberately read-only: remediation stays with the agents (per node)
and the rollout tool (operator-driven). The reference has no fleet-level
view at all — its operators grep node labels by hand (SURVEY.md §5.5).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import List, Optional

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.evidence import audit_evidence
from tpu_cc_manager_torch.k8s.client import KubeClient
from tpu_cc_manager_torch.k8s.objects import match_selector
from tpu_cc_manager_torch.obs import (
    OBSERVED_MODE_VALUES, Counter, Gauge, Histogram, RouteServer,
    kube_queue_rejected_counter, kube_throttle_wait_histogram,
    render_metric_set, wire_queue_reject_observer, wire_throttle_observer,
)
from tpu_cc_manager_torch.plan import (
    FleetEncoding, TickSession, analyze_encoding, compile_stats,
)
from tpu_cc_manager_torch.tsring import TimeSeriesRing

#: the shared node-watch pump and its wake filter moved to watch.py
#: (the watch layer owns delta delivery now that the planner's feature
#: block rides it); re-exported here for embedders and history
from tpu_cc_manager_torch.watch import (  # noqa: F401
    FingerprintWakeFilter, node_report_fingerprint, run_node_watch,
)

log = logging.getLogger("tpu-cc-manager.fleet")


def fleet_problems(report: dict) -> List[str]:
    """The audit findings that mean an operator must look — the health
    classification ``fleet-controller --once`` (cron/CI) exits non-zero
    on. Lives here, next to the report shape, so a new report section
    is classified where it is produced. Divergence alone is NOT a
    problem (agents may simply still be converging); failures, evidence
    contradictions, failing doctor verdicts, and half-flipped slices
    are."""
    problems: List[str] = []
    if report.get("failed"):
        problems.append(f"failed nodes: {sorted(report['failed'])}")
    audit = report.get("evidence_audit") or {}
    # 'missing' IS a problem here: the audit only reports it for nodes
    # whose label claims a SUCCESSFUL mode with no evidence behind it —
    # the simplest forgery (no HMAC to defeat), or an agent that died
    # between labeling and committing. The ROLLOUT judge tolerates
    # missing evidence (pre-evidence agents must not brick a rollout);
    # an audit's job is suspicion, not tolerance.
    for issue in ("missing", "invalid", "label_device_mismatch"):
        if audit.get(issue):
            problems.append(f"evidence {issue}: {sorted(audit[issue])}")
    if audit.get("unsigned"):
        from tpu_cc_manager_torch.evidence import UNSIGNED_RUNBOOK

        # deployment asymmetry, not forgery: say exactly what to fix
        problems.append(
            f"evidence unsigned under a keyed verifier: "
            f"{sorted(audit['unsigned'])} — these agents publish "
            "plain-hashed evidence while this controller holds the "
            f"pool key; {UNSIGNED_RUNBOOK}"
        )
    # 'unverifiable' (signed docs, unkeyed auditor) is deliberately NOT
    # a problem: it is the expected state mid-enablement (agents keyed
    # first). It stays visible via the evidence_issues metric.
    # 'stale_key' (verifies only under a rotation-tail key) likewise:
    # the sync healer re-signs on its own cadence; the bucket/metric
    # exists so the operator knows when the old key line can go.
    if audit.get("identity_mismatch"):
        # the forged-evidence drill: a document whose platform-identity
        # token speaks for another node (or fails verification) means
        # someone with the pool evidence key — but without control of
        # THIS node's metadata server — minted it
        problems.append(
            "evidence identity mismatch (token speaks for another "
            f"node or fails verification): "
            f"{sorted(audit['identity_mismatch'])}"
        )
    if audit.get("attestation_mismatch"):
        # the node-root drill: the document verifies under the pool key
        # and may even carry the node's own identity, but the TEE quote
        # contradicts it — nonce replay, bad quote signature, or a
        # device claim that disagrees with the measured flip history
        # (state changed outside the measured engine path)
        problems.append(
            "evidence attestation mismatch (TEE quote contradicts the "
            f"document): {sorted(audit['attestation_mismatch'])}"
        )
    if audit.get("attestation_outage"):
        # the verifier-side outage latch: quotes verified on an earlier
        # scan of this controller process, and now NONE do while nodes
        # still attach them — the nodes are fine; the VERIFIER lost its
        # trust root. Without this line the whole fleet degrades to an
        # attestation_unverifiable metric an operator has to know to
        # watch (VERDICT r5 weak #5).
        problems.append(
            "attestation went unverifiable fleet-wide after quotes had "
            "verified — likely the verifier lost its trust root "
            "(TPU_CC_TPM_KEY[_FILE] / TPU_CC_ATTESTATION_JWKS_FILE): "
            f"{sorted(audit['attestation_outage'])}"
        )
    if audit.get("attestation_missing"):
        # gated upstream like identity_missing: populated on mixed
        # pools or under TPU_CC_REQUIRE_ATTESTATION
        problems.append(
            "evidence lacks attestation on an attestation-bearing "
            f"pool: {sorted(audit['attestation_missing'])} — node root "
            "can re-sign evidence, but cannot mint a TEE quote whose "
            "measured history matches a forged claim"
        )
    if audit.get("identity_missing"):
        # populated on mixed pools, under TPU_CC_REQUIRE_IDENTITY, or
        # when an earlier scan of this controller process saw VERIFIED
        # identity (the fleet-wide-outage latch; audit_evidence's
        # identity_seen_before encodes all three)
        problems.append(
            "evidence lacks platform identity on an identity-bearing "
            f"pool: {sorted(audit['identity_missing'])} — a stolen "
            "pool key can sign evidence but cannot mint the node's "
            "instance identity token"
        )
    doctor = report.get("doctor") or {}
    if doctor.get("failing"):
        problems.append(
            "doctor failing: "
            f"{sorted(d['node'] for d in doctor['failing'])}"
        )
    if report.get("half_flipped_slices"):
        problems.append(
            f"half-flipped slices: {sorted(report['half_flipped_slices'])}"
        )
    if report.get("incoherent_slices"):
        # unlike plain divergence, incoherent DESIRED labels on one
        # slice can never self-converge — members hold in slice_wait
        # until an operator fixes the labels
        problems.append(
            f"incoherent slices: {sorted(report['incoherent_slices'])}"
        )
    return problems


class FleetMetrics:
    def __init__(self):
        self.nodes = Gauge("tpu_cc_fleet_nodes", "Nodes in the fleet")
        self.nodes_by_mode = Gauge(
            "tpu_cc_fleet_nodes_by_mode",
            "Nodes per observed mode", ("mode",),
        )
        self.needs_flip = Gauge(
            "tpu_cc_fleet_needs_flip",
            "Nodes whose observed mode diverges from desired",
        )
        self.failed = Gauge(
            "tpu_cc_fleet_failed_nodes", "Nodes reporting failed state"
        )
        self.incoherent_slices = Gauge(
            "tpu_cc_fleet_incoherent_slices",
            "Multi-host slices whose members disagree on desired/observed mode",
        )
        self.half_flipped_slices = Gauge(
            "tpu_cc_fleet_half_flipped_slices",
            "Multi-host slices stuck mid-flip (some members at target)",
        )
        self.evidence_issues = Gauge(
            "tpu_cc_fleet_evidence_issues",
            "Nodes failing the evidence-vs-label audit, by issue",
            ("issue",),
        )
        self.doctor_failing = Gauge(
            "tpu_cc_fleet_doctor_failing_nodes",
            "Nodes whose published doctor verdict has failing checks",
        )
        self.doctor_unreported = Gauge(
            "tpu_cc_fleet_doctor_unreported_nodes",
            "Nodes publishing no doctor verdict at all (the "
            "TPU_CC_WEBHOOK_REQUIRE_DOCTOR preflight: enforce only "
            "at zero)",
        )
        self.scans_total = Counter(
            "tpu_cc_fleet_scans_total", "Fleet scans, by outcome", ("outcome",)
        )
        self.scan_duration = Histogram(
            "tpu_cc_fleet_scan_duration_seconds",
            "Wall-clock duration of one fleet scan",
        )
        self.kube_throttle_wait = kube_throttle_wait_histogram()
        self.kube_queue_rejected = kube_queue_rejected_counter()
        # planner compile economics (ISSUE 8 satellite): mirrors of
        # plan.py's monotonic trace/compile-cache counters, refreshed
        # every scan — the PR-7 "restart = zero cache misses" claim
        # becomes scrapeable instead of only test-pinned
        self.planner_retraces = Counter(
            "tpu_cc_planner_retraces_total",
            "XLA (re)traces of planner kernels since process start, "
            "per kernel (steady state: one per shape bucket, ever)",
            ("kernel",),
        )
        self.planner_cache_hits = Counter(
            "tpu_cc_planner_compile_cache_hits_total",
            "Planner compiles served from the persistent compile "
            "cache (TPU_CC_COMPILE_CACHE_DIR)",
        )
        self.planner_cache_misses = Counter(
            "tpu_cc_planner_compile_cache_misses_total",
            "Planner compiles that missed the persistent compile "
            "cache (cold XLA paid; a warmed restart should add zero)",
        )
        self.planner_events_dropped = Counter(
            "tpu_cc_planner_events_dropped_total",
            "Malformed node-watch events dropped by the planner's "
            "feature block (FleetEncoding.apply_event) instead of "
            "thrown in a watch thread — nonzero means the API server "
            "is emitting node objects the encoder can't read",
        )

    def update(self, report: dict) -> None:
        self.nodes.set(report["nodes"])
        counts = report["mode_counts"]
        # the canonical vocabulary, so modes that vanished from the fleet
        # zero out instead of going stale
        for mode in OBSERVED_MODE_VALUES:
            self.nodes_by_mode.set(counts.get(mode, 0), mode)
        self.needs_flip.set(len(report["needs_flip"]))
        self.failed.set(len(report["failed"]))
        self.incoherent_slices.set(len(report["incoherent_slices"]))
        self.half_flipped_slices.set(len(report["half_flipped_slices"]))
        audit = report.get("evidence_audit", {})
        from tpu_cc_manager_torch.evidence import EVIDENCE_ISSUE_KEYS

        # the canonical bucket vocabulary (shared with audit_evidence):
        # iterating a fixed tuple keeps zero-out semantics when a
        # bucket is absent from this scan's audit
        for issue in EVIDENCE_ISSUE_KEYS:
            self.evidence_issues.set(len(audit.get(issue, [])), issue)
        self.doctor_failing.set(
            len(report.get("doctor", {}).get("failing", []))
        )
        self.doctor_unreported.set(
            len(report.get("doctor", {}).get("unreported", []))
        )
        stats = compile_stats()
        for kernel, n in stats["retraces"].items():
            self.planner_retraces.set_total(n, kernel)
        self.planner_cache_hits.set_total(stats["cache_hits"])
        self.planner_cache_misses.set_total(stats["cache_misses"])

    def render(self) -> str:
        # reflection over every metric attribute (obs.registered_metrics):
        # adding a gauge above can no longer silently miss exposition
        return render_metric_set(self)


class FleetController:
    def __init__(
        self,
        kube: KubeClient,
        *,
        selector: str = L.TPU_ACCELERATOR_LABEL,
        interval_s: float = 30.0,
        port: int = 8090,
        max_consecutive_errors: int = 10,
        leader_elector=None,
        observer=None,
        informer=None,
        node_filter=None,
        attest_key=None,
    ):
        self.kube = kube
        self.selector = selector
        #: optional attestation trust root override (federation.py):
        #: None keeps the env posture (tpm_keys); a bytes/tuple value —
        #: or a zero-arg callable returning one, so a region's trust
        #: domain can rotate/revoke without rebuilding the controller —
        #: scopes this controller's quote judging to ONE trust domain.
        #: An empty tuple is a revoked domain: every quote reads
        #: 'unverifiable' and the outage latch fires for THIS
        #: controller only, never its siblings in other regions.
        self.attest_key = attest_key
        #: optional watch.NodeInformer (ISSUE 11): when set, this
        #: controller does NOT open its own node watch — it subscribes
        #: to the shared informer's delta/wake feed instead, and the
        #: caller typically hands an informer-backed ``kube`` so scans
        #: read fleet state from local memory (0 node read round trips
        #: in steady state, pinned by tests/test_shard.py)
        self.informer = informer
        self._informer_token = None
        #: the shared report-relevance wake filter for the informer
        #: feed (run_node_watch keeps its own instance internally);
        #: informer-delivery-thread-only after run() subscribes
        self._informer_wake_filter = FingerprintWakeFilter(self._wake_scan)
        #: optional partition predicate (shard.py): nodes failing it
        #: are invisible to this controller — the watch feed applies it
        #: exactly like the selector, so a shard's encoding never
        #: ingests a foreign partition's nodes
        self.node_filter = node_filter
        #: optional fleetobs.FleetObserver (ISSUE 9): when set, its
        #: burning-SLO lines join every report's problems digest and
        #: the fleet rollup exposition serves on /fleet/metrics. The
        #: observer's scrape loop belongs to whoever constructed it —
        #: this controller only *reads* it.
        self.observer = observer
        #: optional tpu_cc_manager.leader.LeaderElector: when set, run()
        #: scans only while holding the Lease (standby replicas stay
        #: hot but quiet — see policy.py's identical gating)
        self.leader_elector = leader_elector
        #: election reporting: namespace resolved ONCE at construction
        #: (embedders inject an elector with their own namespace; the
        #: env default matches _leader_elector in __main__), and the
        #: lease lookups are skipped entirely when election is off —
        #: no point paying two guaranteed-404 GETs per scan
        from tpu_cc_manager_torch.config import _env_bool

        self._election_ns = os.environ.get(
            "OPERATOR_NAMESPACE", "tpu-system"
        )
        self._election_enabled = (
            leader_elector is not None
            or _env_bool("TPU_CC_LEADER_ELECT", False)
        )
        if interval_s <= 0:
            raise ValueError(
                f"scan interval must be > 0, got {interval_s!r} "
                "(a zero interval busy-loops against the API server)"
            )
        self.interval_s = interval_s
        self.max_consecutive_errors = max_consecutive_errors
        self.metrics = FleetMetrics()
        # the QPS token bucket's per-request wait lands on THIS
        # controller's /metrics — "is the limiter throttling us at
        # fleet scale?" must be a histogram, not a guess
        wire_throttle_observer(kube, self.metrics.kube_throttle_wait)
        # overload honesty: writes the aio admission gate refuses are
        # this controller's saturation signal (TPU_CC_KUBE_QUEUE)
        wire_queue_reject_observer(kube, self.metrics.kube_queue_rejected)
        self.last_report: Optional[dict] = None
        self.consecutive_errors = 0
        #: sticky across scans: once any scan sees an identity-bearing
        #: evidence document, a LATER uniform all-missing pool is a
        #: metadata outage to flag, not a never-on-GCE pool to ignore
        #: (audit_evidence's identity_seen_before). Process-local by
        #: design — deliberately decommissioning identity is
        #: acknowledged by restarting the controller
        self._identity_ever_seen = False
        #: attestation's twin latch: armed by the first VERIFIED quote;
        #: a later scan where every quote reads 'unverifiable' is then
        #: a verifier-trust-root outage (attestation_outage problem),
        #: not a metric-only fade. Same restart-to-acknowledge rule.
        self._attestation_ever_verified = False
        #: label-vs-evidence mismatch debounce (ISSUE 6): evidence now
        #: rides the coalescing publish core, so a scan racing a flip
        #: can see the new state label before the (deferred) evidence
        #: annotation lands — a transient, self-healing skew, not the
        #: lying-label attack. A node must stay mismatched across TWO
        #: consecutive scans to surface as a problem; first-scan hits
        #: are reported separately (label_device_mismatch_transient)
        #: so the skew stays visible without paging anyone.
        self._prior_label_mismatch: set = set()
        #: watch-triggered scans: a node watch wakes the scan loop the
        #: moment report-relevant state changes, so mode divergence /
        #: failed flips / doctor verdicts surface in seconds instead of
        #: at the next interval tick; the interval remains the liveness
        #: fallback. Bursts coalesce through the min scan gap.
        self._wake = threading.Event()
        #: the planner's per-node feature block (ISSUE 7): fed
        #: incrementally by the node watch's delta stream and
        #: fingerprint-diff-synced against each scan's list, so the
        #: per-scan encode cost tracks what CHANGED, not fleet size
        self._encoding = FleetEncoding()
        #: the planner's incremental tick state (ISSUE 19): device-
        #: resident sharded columns + the host mirror that lets a scan
        #: re-evaluate only the rows the watch feed dirtied. One
        #: session per controller; analyze_encoding(session=...) owns
        #: its rebuild/verify cadence.
        self._tick_session = TickSession()
        #: delta-feed trust (ISSUE 19): while a watch/informer feed is
        #: live, scans may SKIP the full list reconcile (`sync`) —
        #: apply_event already wrote every delta — and only resync on
        #: cadence or after a feed gap (reconnect / informer relist)
        #: flags that deltas may have been missed.
        #: guards the three feed flags below — written from the watch/
        #: informer threads, test-and-reset atomically by the scan
        self._feed_lock = threading.Lock()
        self._delta_feed_active = False
        self._resync_needed = True
        self._scans_since_sync = 0
        self.watch_timeout_s = 300
        self.watch_backoff_s = 5.0
        from tpu_cc_manager_torch.config import _env_float

        self.min_scan_gap_s = _env_float(
            "TPU_CC_FLEET_MIN_SCAN_GAP_S", 5.0
        )
        self.sync_every = int(os.environ.get(
            "TPU_CC_FLEET_SYNC_EVERY", "8"
        ))
        self._stop = threading.Event()
        #: the controller's own metric history (tsring.py, ISSUE 9)
        self.tsring = TimeSeriesRing(self.metrics, name="fleet")
        #: the controller-side anomaly watchdog (watchdog.py, ISSUE
        #: 15): its own scan-path series — a scan-duration excursion
        #: or an API flow-control stall fires an incident with the
        #: offending window's stats on /debug/incidents
        from tpu_cc_manager_torch.watchdog import WatchSeries, Watchdog

        self.watchdog = Watchdog(
            series=(
                WatchSeries(
                    "tpu_cc_fleet_scan_duration_seconds", "p99",
                    description="fleet scan duration",
                ),
                WatchSeries(
                    "tpu_cc_kube_throttle_wait_seconds", "p99",
                    min_scale=0.1,
                    description="API client flow-control waits",
                ),
            ),
            sources=[self.metrics], name="fleet",
        )
        self.tsring.add_listener(self.watchdog.consume)
        self._server = RouteServer(port, name="fleet-http")
        self._server.add_route("/healthz", self._healthz)
        self._server.add_route("/readyz", self._readyz)
        self._server.add_route("/metrics", self._metrics_route)
        self._server.add_route("/report", self._report_route)
        self._server.add_route("/debug/timeseries", self._timeseries_route)
        self._server.add_route("/debug/incidents", self._incidents_route)
        self._server.add_route("/fleet/metrics", self._fleet_metrics_route)

    @property
    def attestation_ever_verified(self) -> bool:
        """Has any scan of this controller process verified a TEE
        quote? This is the armed state of the ``attestation_outage``
        latch — simlab's revoked-root drill reads it so the revocation
        fires only AFTER the latch is armed (a fleet that never
        verified stays quiet by design, so revoking earlier would test
        nothing)."""
        return self._attestation_ever_verified

    # -------------------------------------------------------------- scans
    def scan_once(self) -> dict:
        t0 = time.monotonic()
        try:
            # Everything through metric publication is inside the counted
            # block: any failure (malformed node objects, JAX runtime
            # errors, metric-shape bugs) increments consecutive_errors and
            # degrades /healthz instead of crashing run() or — worse —
            # retrying forever with the error counter stuck at 0.
            nodes = self.kube.list_nodes(self.selector)
            if self.node_filter is not None:
                # shard partition scope: the scan sees exactly the
                # nodes the watch feed admits (filter symmetry keeps
                # encoding and list truth in agreement)
                nodes = [n for n in nodes if self.node_filter(n)]
            # list truth reconciles the watch-fed feature block
            # (unchanged nodes cost a fingerprint compare, not a
            # re-encode), then ONE jitted planner tick answers the
            # divergence/slice/doctor questions in a batch. With a
            # live delta feed the fingerprint sweep itself is skipped
            # between cadence resyncs — apply_event already wrote
            # every delta — but a feed gap forces the next scan to
            # reconcile (ISSUE 19).
            with self._feed_lock:
                do_sync = (not self._delta_feed_active
                           or self._resync_needed
                           or self._scans_since_sync >= self.sync_every)
                if do_sync:
                    # reset BEFORE the sync runs: a gap landing while
                    # we reconcile re-arms the flag for the next scan
                    self._resync_needed = False
                    self._scans_since_sync = 0
                else:
                    self._scans_since_sync += 1
            if do_sync:
                self._encoding.sync(nodes)
            report = analyze_encoding(
                self._encoding, session=self._tick_session
            )
            # label-vs-device truth: the JAX planner trusts label text;
            # the evidence audit cross-checks it against what each
            # node's agent independently attested (VERDICT r2 item 7)
            # resolve a callable trust root per scan (federation: the
            # region's domain may have been revoked since last tick)
            ak = (self.attest_key() if callable(self.attest_key)
                  else self.attest_key)
            audit = audit_evidence(
                nodes, identity_seen_before=self._identity_ever_seen,
                attestation_seen_before=self._attestation_ever_verified,
                attest_key=ak,
            )
            self._identity_ever_seen = (
                self._identity_ever_seen or audit.get("identity_seen", False)
            )
            self._attestation_ever_verified = (
                self._attestation_ever_verified
                or audit.get("attestation_seen", False)
            )
            cur_mismatch = set(audit.get("label_device_mismatch", []))
            audit["label_device_mismatch"] = sorted(
                cur_mismatch & self._prior_label_mismatch
            )
            audit["label_device_mismatch_transient"] = sorted(
                cur_mismatch - self._prior_label_mismatch
            )
            self._prior_label_mismatch = cur_mismatch
            report["evidence_audit"] = audit
            # report["doctor"] comes batched from the planner tick:
            # which nodes report failing trust-surface checks
            # (malformed verdicts count as failing), and which report
            # NOTHING — ``unreported`` is the preflight for
            # TPU_CC_WEBHOOK_REQUIRE_DOCTOR (enforce only at zero)
            report["policies"] = self._policy_summaries()
            report["leader_elections"] = self._election_summaries()
            # the actionable digest rides in the report itself, so the
            # live /report and `--once` stdout agree — an operator (or
            # alert rule) reads one field either way
            report["problems"] = fleet_problems(report)
            if self.observer is not None:
                # burning SLOs are fleet problems: the objective layer
                # degrades GRADUALLY (budget burn) before any binary
                # gate fails — surface it in the same digest
                report["problems"].extend(self.observer.problems())
                report["slo"] = self.observer.status()
            from tpu_cc_manager_torch.trace import current_trace_ids

            # the active trace (if any) rides as the scan-latency
            # bucket's exemplar (ISSUE 15)
            self.metrics.scan_duration.observe(
                time.monotonic() - t0,
                trace_id=current_trace_ids()[0])
            self.metrics.update(report)
            # encoder-side drop total lives on the encoding (update()
            # never sees it — reports carry analysis, not ingest
            # health), mirrored here via the external-total pattern
            self.metrics.planner_events_dropped.set_total(
                float(self._encoding.events_dropped)
            )
            self.last_report = report
        except Exception:
            self.metrics.scans_total.inc("error")
            self.consecutive_errors += 1
            raise
        self.consecutive_errors = 0
        self.metrics.scans_total.inc("success")
        return report

    def _election_summaries(self) -> dict:
        """Election state of both controllers, so /report is the one
        pane for HA debugging too: who leads, for how long, how many
        failovers. Empty entries when the Lease doesn't exist (election
        disabled) or the client has no lease support."""
        out = {}
        if not self._election_enabled:
            return out
        for name in ("tpu-cc-policy-controller",
                     "tpu-cc-fleet-controller"):
            try:
                lease = self.kube.get_lease(self._election_ns, name)
            except Exception:
                log.debug("lease %s unreadable; omitting from status",
                          name, exc_info=True)
                continue
            spec = lease.get("spec") or {}
            out[name] = {
                "holder": spec.get("holderIdentity"),
                "acquireTime": spec.get("acquireTime"),
                "renewTime": spec.get("renewTime"),
                "transitions": spec.get("leaseTransitions", 0),
            }
        return out

    def _policy_summaries(self) -> List[dict]:
        """Status summaries of the cluster's TPUCCPolicies, so /report
        is the single operator pane. Empty when the CRD isn't installed
        (404) or the controller lacks CR read rights."""
        try:
            policies = self.kube.list_cluster_custom(
                L.POLICY_GROUP, L.POLICY_VERSION, L.POLICY_PLURAL
            )
        except Exception:  # ccaudit: allow-swallow(CRD absent or unreadable: /report simply omits the policies pane)
            return []
        out = []
        for p in policies:
            st = p.get("status") or {}
            out.append({
                "name": p["metadata"]["name"],
                "mode": (p.get("spec") or {}).get("mode"),
                "phase": st.get("phase"),
                "nodes": st.get("nodes"),
                "converged": st.get("converged"),
                "message": st.get("message"),
            })
        return sorted(out, key=lambda d: d["name"])

    @property
    def healthy(self) -> bool:
        return self.consecutive_errors < self.max_consecutive_errors

    @property
    def port(self) -> int:
        return self._server.port

    # -------------------------------------------------------------- routes
    def _healthz(self):
        return ((200, b"ok", "text/plain") if self.healthy
                else (503, b"unhealthy", "text/plain"))

    def _readyz(self):
        """Leader-aware readiness (see policy.py _readyz): standbys are
        healthy but not Ready, keeping Service traffic on the scanner."""
        if not self.healthy:
            return 503, b"unhealthy", "text/plain"
        if (self.leader_elector is not None
                and not self.leader_elector.is_leader):
            return 503, b"standby (not leader)", "text/plain"
        return 200, b"ok", "text/plain"

    def _metrics_route(self):
        # scan-histogram exemplars ride this render: OpenMetrics type
        # (obs.OPENMETRICS_CONTENT_TYPE rationale); the merged
        # /fleet/metrics below stays classic — the merge strips
        # exemplars by policy
        from tpu_cc_manager_torch.obs import OPENMETRICS_CONTENT_TYPE

        return (200, self.metrics.render().encode(),
                OPENMETRICS_CONTENT_TYPE)

    def _timeseries_route(self, query=None):
        # ?metric=<prefix> narrows to one family (ISSUE 15 satellite)
        return self.tsring.route(
            metric_prefix=(query or {}).get("metric"))

    def _incidents_route(self):
        return self.watchdog.route()

    def _fleet_metrics_route(self):
        """The fleet ROLLUP exposition (fleetobs.py): replica series
        merged fleet-wide plus the SLO burn/budget gauges. A separate
        route from /metrics because the rollup re-exposes the agents'
        family names — concatenating it with this controller's own set
        would be exactly the duplicate-declaration bug the validator
        exists to catch."""
        if self.observer is None:
            return 404, b"fleet observer not wired", "text/plain"
        return (200, self.observer.render().encode(),
                "text/plain; version=0.0.4")

    def _report_route(self):
        if self.last_report is None:
            return 503, b"no scan completed yet", "text/plain"
        body = json.dumps(self.last_report, indent=2, sort_keys=True).encode()
        return 200, body, "application/json"

    # -------------------------------------------------------------- watch
    _node_fingerprint = staticmethod(node_report_fingerprint)

    def _on_watch_event(self, etype: str, node: dict) -> None:
        """Feed the planner's feature block — FLEET nodes only. The
        watch streams every cluster node (no server-side selector), but
        the scan lists with ``self.selector``: an unfiltered feed would
        ingest foreign nodes into the encoding (visible in any report
        snapshotted before the next sync() prunes them, and permanently
        sizing the bucket to cluster scale). DELETED always forwards —
        removing an absent row is a no-op."""
        if etype != "DELETED":
            labels = (node.get("metadata") or {}).get("labels") or {}
            if not match_selector(labels, self.selector):
                return
            if self.node_filter is not None and not self.node_filter(node):
                return
        self._encoding.apply_event(etype, node)

    def _wake_scan(self) -> None:
        self._wake.set()

    def _watch_gap(self) -> None:
        """The private watch (re)connected: any deltas between streams
        may have been lost, so the next scan must list-reconcile before
        the planner trusts the feed again (ISSUE 19)."""
        with self._feed_lock:
            self._resync_needed = True

    def _informer_gap_wake(self) -> None:
        """Informer wake doubles as its gap signal: the shared informer
        calls on_wake after every relist/reconnect storm as well as on
        deltas, and a spurious resync costs one fingerprint sweep —
        cheap insurance against a silently stale encoding."""
        with self._feed_lock:
            self._resync_needed = True
        self._wake.set()

    def _on_informer_event(self, etype: str, node: dict) -> None:
        """Shared-informer delta: feed the encoding exactly like the
        private watch did, and wake the scan loop on report-relevant
        changes through the shared fingerprint filter
        (watch.FingerprintWakeFilter). The selector/partition gate
        applies to the wake too — a shared informer delivers the
        WHOLE cluster's events, and at N shards an unscoped wake
        would rescan every shard on every foreign-partition change."""
        self._on_watch_event(etype, node)
        if etype != "DELETED":
            labels = (node.get("metadata") or {}).get("labels") or {}
            if not match_selector(labels, self.selector):
                return
            if self.node_filter is not None and not self.node_filter(node):
                return
        self._informer_wake_filter(etype, node)

    def _watch_loop(self) -> None:
        """Background node watch via :func:`watch.run_node_watch`;
        report-relevant changes wake the scan loop, and every delta
        feeds the planner's feature block so the next scan encodes
        only what moved."""
        with self._feed_lock:
            self._delta_feed_active = True
        try:
            run_node_watch(
                self.kube, self._stop, self._wake.set,
                timeout_s=self.watch_timeout_s,
                backoff_s=self.watch_backoff_s,
                logger=log, who="fleet",
                on_event=self._on_watch_event,
                on_gap=self._watch_gap,
            )
        finally:
            # pump returned (no watch support, or stop): scans fall
            # back to list-reconciling every time
            with self._feed_lock:
                self._delta_feed_active = False

    # ---------------------------------------------------------------- run
    def run(self) -> int:
        self._server.start()
        self.tsring.start()
        # planner compile warmup (ISSUE 7, env-gated — plan.maybe_warmup)
        from tpu_cc_manager_torch import plan

        plan.maybe_warmup(log)
        log.info(
            "fleet controller serving on :%d (selector %r, every %.0fs "
            "+ watch-triggered)",
            self.port, self.selector, self.interval_s,
        )
        if self.informer is not None:
            # shared informer (ISSUE 11): its single watch stream feeds
            # this controller's encoding and wake — no private watch
            self._informer_token = self.informer.subscribe(
                on_event=self._on_informer_event,
                # on_wake fires once per informer relist — exactly the
                # delta-feed gap the sync-skip path must resync over
                on_wake=self._informer_gap_wake,
            )
            with self._feed_lock:
                self._delta_feed_active = True
        else:
            watcher = threading.Thread(
                target=self._watch_loop, name="fleet-watch", daemon=True
            )
            watcher.start()
        if self.leader_elector is not None:
            self.leader_elector.start()
        try:
            while not self._stop.is_set():
                if (self.leader_elector is not None
                        and not self.leader_elector.is_leader):
                    # field contract: every /report carries the digest,
                    # standby included (consumers index it)
                    self.last_report = {"standby": True, "problems": []}
                    self._stop.wait(self.leader_elector.retry_period_s)
                    continue
                try:
                    report = self.scan_once()
                    log.info(
                        "fleet scan: %d nodes, %d divergent, %d failed",
                        report["nodes"], len(report["needs_flip"]),
                        len(report["failed"]),
                    )
                except Exception as e:
                    log.warning("fleet scan failed: %s", e)
                    if not self.healthy:
                        log.error(
                            "%d consecutive scan failures; exiting",
                            self.consecutive_errors,
                        )
                        return 1
                # wake-aware sleep: a watch event ends it early, the
                # interval is the liveness fallback. The min scan gap
                # coalesces event bursts (a 32-node rollout is one or
                # two scans, not 32) and bounds watch-driven scan rate
                if self._wake.wait(self.interval_s):
                    self._wake.clear()
                    # capped at the interval: a wake may only ever make
                    # the next scan SOONER than the tick it replaced
                    self._stop.wait(min(self.min_scan_gap_s,
                                        self.interval_s))
            return 0
        finally:
            self.stop()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()  # unblock a wake-aware sleep immediately
        if self.informer is not None and self._informer_token is not None:
            # a stopped controller must not keep consuming the shared
            # feed (shard demotion constructs a fresh one on re-promote)
            self.informer.unsubscribe(self._informer_token)
            self._informer_token = None
        if self.leader_elector is not None:
            self.leader_elector.stop()  # release: standby takes over now
        self.tsring.stop()
        self._server.stop()
