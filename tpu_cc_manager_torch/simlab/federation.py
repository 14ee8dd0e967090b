"""FederationLab — one scenario, N regions, N live API servers.

The multi-region counterpart of :class:`~tpu_cc_manager.simlab.runner.
SimLab` (ISSUE 16): a schema-2 scenario with ``regions`` gets one
FULL per-region cell — its own :class:`FakeApiServer`, its own live
replica fleet (worker pool + watch pump), its own attestation trust
domain — federated by ONE :class:`~tpu_cc_manager.federation.
FederationManager` whose region-affine ring, posture windows, and
evacuation flow are exactly what production runs.

What the lab measures beyond SimLab:

- ``region_evac_convergence_s`` — region_evacuate injection → the
  fleet stable again (evacuated region fully cordoned AND every other
  region converged after absorbing); the bench axis ISSUE 16 gates.
- the cross-region ``e2e_convergence_p99_s`` — stitched over flight-
  recorder trace ids from every region's desired_write spans (the
  federation controller stamps them on the process tracer) joined to
  every region's replica reconcile spans.
- per-region fault surfaces: ``region_partition`` / ``region_blackout``
  (FakeKube's blackout gate severs that region's API server),
  ``region_latency_skew`` (response_delay_s), ``region_evacuate``,
  and region-scoped ``root_revoked`` (that region's trust domain only —
  the region_attestation_latch invariant pins the non-spill).

The lab exposes the same judgment surface SimLab does (``replicas``,
``final_fleet_reports()``, ``scenario``) so the invariants oracle
(:mod:`~tpu_cc_manager.simlab.invariants`) runs unchanged; the
store-scoped checks see ``server is None`` and skip, and the
federation-specific contract is judged from the artifact's
``metrics.federation`` block.
"""

from __future__ import annotations

import logging
import os
import tempfile
import threading
import time
from typing import Dict, List, Optional

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.device.fake import fake_backend
from tpu_cc_manager_torch.federation import (
    FederationManager, FleetPosture, RegionSpec, RegionTrustDomain,
)
from tpu_cc_manager_torch.flightrec import FlightRecorder, stitch_by_trace
from tpu_cc_manager_torch.k8s.apiserver import FakeApiServer
from tpu_cc_manager_torch.k8s.client import HttpKubeClient, KubeConfig
from tpu_cc_manager_torch.k8s.objects import make_node
from tpu_cc_manager_torch.obs import (
    Metrics, kube_throttle_wait_histogram, watch_pump_lag_histogram,
)
from tpu_cc_manager_torch.simlab.pump import LagStamps, WatchPump
from tpu_cc_manager_torch.simlab.replica import (
    _EMPTY as _REPLICA_EMPTY, ReplicaShell, WorkerPool,
)
from tpu_cc_manager_torch.simlab.report import build_artifact, percentile
from tpu_cc_manager_torch.simlab.runner import POOL_LABEL, _env_int
from tpu_cc_manager_torch.simlab.scenario import Scenario, ScenarioError
from tpu_cc_manager_torch.trace import Tracer, get_tracer

log = logging.getLogger("tpu-cc-manager.simlab.federation")

#: region fault kinds the lab executes (scenario.py validates them)
_HEAL_DEFAULT_S = 5.0


class _RegionCell:
    """One region's live assembly: API server, node fleet, replicas,
    worker pool, watch pump, and (when the scenario runs attestation)
    per-node TPMs keyed to the region's OWN trust domain — explicit
    keys, never the process env, because two regions must be able to
    trust different roots in one process."""

    def __init__(self, lab: "FederationLab", region, index: int) -> None:
        sc = lab.scenario
        self.name = region.name
        self.spec = region
        self.server = FakeApiServer().start()
        self.store = self.server.store
        self.pools = [f"{region.name}-p{j}" for j in range(region.pools)]
        self.node_names = [
            f"{region.name}-{i:04d}" for i in range(region.nodes)
        ]
        for i, name in enumerate(self.node_names):
            self.store.add_node(make_node(name, labels={
                L.TPU_ACCELERATOR_LABEL: "tpu-v5p-slice",
                POOL_LABEL: self.pools[i % region.pools],
                L.CC_MODE_LABEL: sc.initial_mode,
            }))
        self.trust_domain: Optional[RegionTrustDomain] = None
        self._tpms: Dict[str, object] = {}
        if sc.attestation:
            from tpu_cc_manager_torch.attest import FakeTpm

            key = f"simlab-fed-{region.name}-key-0".encode()
            self.trust_domain = RegionTrustDomain(region.name, (key,))
            for name in self.node_names:
                self._tpms[name] = FakeTpm(
                    state_dir=os.path.join(lab.tpm_dir, name), key=key,
                )
        self.data_kube = self._client(qps=sc.qps)
        self.data_kube.add_throttle_observer(lab._observe_throttle)
        self.replicas: Dict[str, ReplicaShell] = {
            name: ReplicaShell(
                name, self.data_kube,
                fake_backend(n_chips=sc.chips_per_node),
                lab.tracer, evidence=sc.evidence,
                metrics=Metrics(),
                attestor=self._tpms.get(name),
            )
            for name in self.node_names
        }
        self.pool = WorkerPool(self.replicas, lab.region_workers).start()
        self.pump = WatchPump(
            self._client(qps=0), self.replicas, self.pool,
            lab.stamps, lab.lag_hist,
            watch_timeout_s=sc.watch_timeout_s,
        )
        self.pump.prime()
        self.pump.start()

    def _client(self, qps: float = 0.0) -> HttpKubeClient:
        return HttpKubeClient(
            KubeConfig("127.0.0.1", self.server.port, use_tls=False),
            qps=qps,
        )

    def stop(self) -> None:
        self.pump.stop()
        self.pool.stop()
        self.server.stop()


class FederationLab:
    """Run one schema-2 ``regions`` scenario end to end."""

    def __init__(self, scenario: Scenario):
        if not scenario.regions:
            raise ScenarioError(
                f"scenario {scenario.name!r} has no regions — use SimLab"
            )
        self.scenario = scenario
        self.workers = _env_int("TPU_CC_SIMLAB_WORKERS",
                                scenario.workers)
        # each region runs its own worker pool against its own server;
        # splitting the scenario's budget keeps the total thread count
        # (the 1-core sandbox constraint) what the scenario asked for
        self.region_workers = max(
            2, self.workers // len(scenario.regions))
        #: SimLab-compatible judgment surface for the invariants oracle:
        #: no single store (checks that need one skip via None)
        self.server = None
        self.injector = None
        self.attest_lab = None
        self.shard_manager = None
        self.cells: Dict[str, _RegionCell] = {}
        self.replicas: Dict[str, ReplicaShell] = {}
        self.fed: Optional[FederationManager] = None
        self.stamps = LagStamps()
        self.lag_hist = watch_pump_lag_histogram()
        self.throttle_hist = kube_throttle_wait_histogram()
        self._throttle_samples: List[float] = []
        self._throttle_lock = threading.Lock()
        self._phase_durations: Dict[str, List[float]] = {}
        self._phase_lock = threading.Lock()
        self.tracer = Tracer()
        self.tracer.add_sink(self._phase_sink)
        self._tmp = tempfile.TemporaryDirectory(prefix="simlab-fed-tpm-")
        self.tpm_dir = self._tmp.name
        # the federation controller's desired_write spans land on the
        # PROCESS tracer (rollout/federation get_tracer()) — the same
        # filtered-sink capture SimLab uses for policy rollouts
        self.ctrl_rec = FlightRecorder(
            name="controller", span_ring=256, event_ring=8, sample_ring=8,
        )

        def _ctrl_sink(span) -> None:
            if span.name == "desired_write":
                self.ctrl_rec.observe_span(span)

        self._ctrl_sink = _ctrl_sink
        #: heal timers for duration-bounded region faults; settle fires
        #: any still pending so the judged fleet is the healed one
        self._heal_timers: List[threading.Timer] = []
        self._heal_lock = threading.Lock()
        #: monotonic stamp of the region_evacuate injection (the
        #: region_evac_convergence_s axis is this -> fleet stable)
        self._t_evac: Optional[float] = None
        self._conv_end_t: Optional[float] = None

    # ------------------------------------------------------------ plumbing
    def _phase_sink(self, span) -> None:
        with self._phase_lock:
            self._phase_durations.setdefault(span.name, []).append(
                span.dur_s
            )

    def _observe_throttle(self, waited: float) -> None:
        self.throttle_hist.observe(waited)
        if waited > 0:
            with self._throttle_lock:
                self._throttle_samples.append(waited)

    def _cell_of(self, region: str) -> _RegionCell:
        cell = self.cells.get(region)
        if cell is None:
            raise ScenarioError(f"unknown region {region!r}")
        return cell

    def _heal_later(self, delay_s: float, fn) -> None:
        t = threading.Timer(delay_s, fn)
        t.daemon = True
        with self._heal_lock:
            self._heal_timers.append(t)
        t.start()

    # -------------------------------------------------------------- setup
    def _build(self) -> None:
        sc = self.scenario
        for i, region in enumerate(sc.regions):
            cell = _RegionCell(self, region, i)
            self.cells[region.name] = cell
            self.replicas.update(cell.replicas)
        self.fed = FederationManager(
            [
                RegionSpec(
                    name=cell.name,
                    client_factory=cell._client,
                    pools=list(cell.pools),
                    trust_domain=cell.trust_domain,
                )
                for cell in self.cells.values()
            ],
            pool_label=POOL_LABEL,
            shards_per_region=max(1, sc.controllers.shards or 1),
            policy=False,
            fleet_interval_s=1.0,
        )
        self.fed.start()
        if not self.fed.wait_covered(timeout_s=30.0):
            log.warning("federation did not reach full coverage before "
                        "the timeline; continuing")

    # --------------------------------------------------- fleet plane taps
    def _region_fleet_controllers(self, region: str) -> List[object]:
        return [b.fleet
                for b in self.fed.managers[region].bundles()]

    def _region_armed(self, region: str) -> bool:
        return any(
            getattr(c, "attestation_ever_verified", False)
            for c in self._region_fleet_controllers(region)
        )

    def final_fleet_reports(self) -> List[dict]:
        out = []
        for region in sorted(self.cells):
            for c in self._region_fleet_controllers(region):
                if getattr(c, "last_report", None):
                    out.append(c.last_report)
        return out

    # ------------------------------------------------------------- actions
    def _act_set_mode(self, params: dict) -> dict:
        posture = FleetPosture(
            mode=params["mode"],
            windows=dict(params.get("windows") or {}),
            source="timeline",
        )
        self.fed.apply_posture(posture)
        return {"mode": posture.mode,
                "windows": dict(posture.windows),
                "regions": self.fed.regions}

    def _inject(self, kind: str, params: dict, rel_t: float) -> dict:
        entry: dict = {"fault": kind, "at_s": round(rel_t, 3)}
        entry.update({k: v for k, v in params.items()})
        if kind == "region_partition" or kind == "region_blackout":
            region = params["region"]
            cell = self._cell_of(region)
            duration = float(params.get("duration_s", _HEAL_DEFAULT_S))
            cell.store.blackout = True
            self.fed.set_partitioned(region, True)

            def _heal(cell=cell, region=region):
                cell.store.blackout = False
                self.fed.set_partitioned(region, False)
                log.info("region %s: %s healed", region, kind)

            self._heal_later(duration, _heal)
            entry["duration_s"] = duration
        elif kind == "region_latency_skew":
            region = params["region"]
            cell = self._cell_of(region)
            delay = float(params["delay_s"])
            duration = float(params.get("duration_s", _HEAL_DEFAULT_S))
            cell.store.response_delay_s = delay

            def _heal(cell=cell, region=region):
                cell.store.response_delay_s = 0.0
                log.info("region %s: latency skew healed", region)

            self._heal_later(duration, _heal)
            entry["duration_s"] = duration
        elif kind == "region_evacuate":
            region = params["region"]
            self._cell_of(region)
            if self._t_evac is None:
                self._t_evac = time.monotonic()
            entry.update(self.fed.evacuate(region))
        elif kind == "root_revoked":
            # region-scoped by default in a federation scenario: only
            # THAT region's trust domain drops. Without a region the
            # drill revokes every domain (the single-region analog).
            targets = ([params["region"]] if params.get("region")
                       else sorted(self.cells))
            armed: Dict[str, bool] = {}
            for region in targets:
                deadline = time.monotonic() + 30.0
                while (not self._region_armed(region)
                       and time.monotonic() < deadline):
                    time.sleep(0.1)
                armed[region] = self._region_armed(region)
                domain = self.cells[region].trust_domain
                if domain is None:
                    raise ScenarioError(
                        "root_revoked needs attestation: true")
                domain.revoke()
                log.warning("region %s: trust root revoked (armed=%s)",
                            region, armed[region])
            entry["regions_revoked"] = targets
            # same key the single-region oracle reads: was at least one
            # quote verified before the revocation latched?
            entry["armed_before_revoke"] = all(armed.values())
            entry["armed_by_region"] = armed
        else:
            # schema validation already scoped the timeline; anything
            # else here is a scenario the federation lab cannot drive
            raise ScenarioError(
                f"fault {kind!r} is not supported by the federation lab"
            )
        return entry

    # --------------------------------------------------------- convergence
    def _wait_converged(self, target: str, timeout_s: float,
                        initial: bool = False):
        """(elapsed_s or None, pending). Non-evacuated regions: every
        node's state label at ``target`` (out-of-band store peek, like
        SimLab — measurement must add no HTTP load). Evacuated regions:
        fully cordoned, judged via the federation's own informer-cache
        check (zero store reads by construction)."""
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        evacuated = set() if initial else set(
            self.fed.stats()["evacuated"])
        pending_nodes = {
            name
            for region, cell in self.cells.items()
            if region not in evacuated
            for name in cell.node_names
        }
        pending_cordons = set(evacuated)
        cell_of_node = {
            name: cell
            for cell in self.cells.values() for name in cell.node_names
        }
        while (pending_nodes or pending_cordons) and \
                time.monotonic() < deadline:
            # evacuation can land mid-wait: re-scope the judgment
            if not initial:
                now_evac = set(self.fed.stats()["evacuated"])
                for region in now_evac - evacuated:
                    evacuated.add(region)
                    pending_cordons.add(region)
                    pending_nodes -= set(
                        self.cells[region].node_names)
            pending_nodes = {
                n for n in pending_nodes
                if cell_of_node[n].store.peek_node_label(
                    n, L.CC_MODE_STATE_LABEL) != target
            }
            pending_cordons = {
                r for r in pending_cordons
                if not self.fed.region_cordoned(r)
            }
            if pending_nodes or pending_cordons:
                time.sleep(0.05)
        pending = sorted(pending_nodes) + sorted(
            f"region:{r}:cordon" for r in pending_cordons)
        if pending:
            return None, pending
        return time.monotonic() - t0, []

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        sc = self.scenario
        os.environ.setdefault("TPU_CC_IDENTITY", "none")
        os.environ.setdefault("TPU_CC_ATTESTATION", "none")
        log.info("federation lab: scenario %r — %d nodes over %d "
                 "regions (%s)", sc.name, sc.nodes, len(sc.regions),
                 ", ".join(f"{r.name}:{r.nodes}" for r in sc.regions))
        get_tracer().add_sink(self._ctrl_sink)
        notes = None
        faults: List[dict] = []
        try:
            self._build()

            # initial storm to initial_mode, outside the measurement
            for cell in self.cells.values():
                for name in cell.node_names:
                    cell.pool.submit(name, sc.initial_mode)
            initial_s, pending = self._wait_converged(
                sc.initial_mode, min(60.0, sc.converge.timeout_s),
                initial=True,
            )
            if initial_s is None:
                notes = (f"{len(pending)} replicas never initialized "
                         f"to {sc.initial_mode!r}")
                return self._finish(False, None, None, pending, faults,
                                    notes)

            # ---- the timeline (actions pre-sorted by `at`)
            t0 = time.monotonic()
            t_change: Optional[float] = None
            for action in sc.actions:
                delay = t0 + action.at - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                rel_t = time.monotonic() - t0
                if action.kind == "fault":
                    params = dict(action.params)
                    kind = params.pop("fault")
                    faults.append(self._inject(kind, params, rel_t))
                    continue
                if action.kind != "set_mode":
                    raise ScenarioError(
                        f"action {action.kind!r} is not supported by "
                        "the federation lab")
                entry = self._act_set_mode(action.params)
                entry.update({"at_s": round(rel_t, 3),
                              "action": action.kind})
                faults.append(entry)
                if (t_change is None
                        and action.params["mode"] == sc.converge.mode):
                    t_change = time.monotonic()

            conv_s, pending = self._wait_converged(
                sc.converge.mode, sc.converge.timeout_s
            )
            if conv_s is not None:
                self._conv_end_t = time.monotonic()
                if t_change is not None:
                    conv_s = self._conv_end_t - t_change
            ok = conv_s is not None
            if ok:
                self._settle()
            if not ok:
                notes = (f"{len(pending)} judgment(s) never reached "
                         f"{sc.converge.mode!r} within "
                         f"{sc.converge.timeout_s}s")
            return self._finish(ok, initial_s, conv_s, pending, faults,
                                notes)
        finally:
            self._teardown()

    def _settle(self) -> None:
        """Heal any still-pending region fault, drain straggler
        reconciles, flush deferred publications, then one final fleet
        scan per region so the artifact's audit (and the
        region_attestation_latch judgment) reflects the settled
        fleet."""
        with self._heal_lock:
            timers = list(self._heal_timers)
            self._heal_timers = []
        for t in timers:
            t.cancel()
            try:
                t.function()
            except Exception:
                log.warning("settle heal failed", exc_info=True)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            busy = any(
                r._queued or r._pending is not _REPLICA_EMPTY
                for r in self.replicas.values()
            )
            if not busy:
                break
            time.sleep(0.05)
        for r in self.replicas.values():
            r.batcher.flush()
        for region in sorted(self.cells):
            for c in self._region_fleet_controllers(region):
                try:
                    c.scan_once()
                except Exception:
                    log.warning("final fleet scan failed (region %s)",
                                region, exc_info=True)

    # ------------------------------------------------------ trace stitch
    def _stitch_traces(self) -> dict:
        """Stitch the CROSS-REGION causal story: every region's
        desired_write span (federation controller, process tracer) is
        joined by trace id to every region's replica reconcile spans —
        the e2e convergence distribution spans API servers, which no
        single region's recorder could produce."""
        recordings = [self.ctrl_rec.snapshot("run_end")]
        for r in self.replicas.values():
            recordings.append(r.recorder.snapshot("run_end"))
        stitched = stitch_by_trace(recordings)
        samples: List[float] = []
        cross = 0
        example: List[dict] = []
        for spans in stitched.values():
            recorders = {s.get("recorder") for s in spans
                         if s.get("recorder")}
            desired = [s for s in spans if s["name"] == "desired_write"]
            if len(recorders) > 1 and desired:
                cross += 1
                if len(spans) > len(example):
                    example = spans
            if not desired:
                continue
            t0 = min(s["start_ts"] for s in desired)
            ends: Dict[str, float] = {}
            for s in spans:
                if s["name"] != "reconcile":
                    continue
                node = ((s.get("attrs") or {}).get("node")
                        or s.get("recorder"))
                end = s["start_ts"] + s["dur_s"]
                if node and end > ends.get(node, 0.0):
                    ends[node] = end
            samples.extend(
                max(0.0, end - t0) for end in ends.values()
            )
        return {
            "traces": len(stitched),
            "cross_process_traces": cross,
            "e2e_samples": len(samples),
            "e2e_convergence_p50_s": percentile(samples, 0.50),
            "e2e_convergence_p99_s": percentile(samples, 0.99),
            "timeline_example": example[:12],
        }

    # ------------------------------------------------------------- finish
    def _federation_block(self, conv_ok: bool) -> dict:
        stats = self.fed.stats() if self.fed is not None else {}
        evacuated = set(stats.get("evacuated") or ())
        regions: Dict[str, dict] = {}
        for name, cell in sorted(self.cells.items()):
            regions[name] = {
                "nodes": len(cell.node_names),
                "pools": list(cell.pools),
                # the zero-cross-region-reads ledger: each region's
                # FakeKube counts ONLY its own traffic; a regression
                # reader can compare steady-state read rates per region
                "node_read_requests": cell.store.node_read_requests,
                "evacuated": name in evacuated,
            }
        block = {
            "regions": regions,
            "posture": stats.get("posture"),
            "evacuations": stats.get("evacuations") or [],
            "partitioned": stats.get("partitioned") or [],
            "attestation": (self.fed.attestation_summary()
                            if self.fed is not None else {}),
        }
        if self._t_evac is not None:
            if conv_ok and self._conv_end_t is not None:
                block["region_evac_convergence_s"] = round(
                    max(0.0, self._conv_end_t - self._t_evac), 4)
            else:
                # a failed evac drill leaves the axis ABSENT — bench.py
                # fails loudly on None rather than gating a lie
                log.error("region evacuation never stabilized; the "
                          "region_evac_convergence_s axis stays absent")
        return block

    def _finish(self, ok, initial_s, conv_s, pending, faults, notes):
        replica_stats = {"total": 0, "repairs": 0, "coalesced": 0}
        publish_stats = {"coalesced": 0, "folded": 0, "flushed": 0,
                         "retries": 0, "dropped": 0, "pending": 0}
        for r in self.replicas.values():
            replica_stats["total"] += r.reconciles
            replica_stats["repairs"] += r.repairs
            replica_stats["coalesced"] += r.coalesced
            for outcome, n in r.outcomes.items():
                replica_stats[outcome] = (
                    replica_stats.get(outcome, 0) + n
                )
            for k, v in r.batcher.stats().items():
                publish_stats[k] = publish_stats.get(k, 0) + v
        replica_stats["publish"] = publish_stats
        replica_stats["api_writes"] = {
            name: cell.store.node_write_stats()
            for name, cell in sorted(self.cells.items())
        }
        with self._throttle_lock:
            waits = list(self._throttle_samples)
        throttle = {
            "waits": sum(c.data_kube.throttle_waits
                         for c in self.cells.values()),
            "wait_s_total": round(
                sum(c.data_kube.throttle_wait_s_total
                    for c in self.cells.values()), 4),
            "wait_p50_s": percentile(waits, 0.50),
            "wait_max_s": round(max(waits), 5) if waits else None,
            "histogram": self.throttle_hist.snapshot(),
        }
        controllers = {
            "running": sum(
                len(self._region_fleet_controllers(r))
                for r in self.cells
            ) if self.fed is not None else 0,
            "federation": self.fed.stats() if self.fed is not None
            else None,
        }
        reports = self.final_fleet_reports()
        problems = [p for rep in reports
                    for p in (rep.get("problems") or [])]
        if problems:
            controllers["fleet_problems"] = [
                p if len(p) <= 160 else p[:160] + "..."
                for p in problems[:5]
            ]
            controllers["fleet_problem_count"] = len(problems)
        lifecycle = {"versions": {}}
        for r in self.replicas.values():
            lifecycle["versions"][r.version] = (
                lifecycle["versions"].get(r.version, 0) + 1
            )
        with self._phase_lock:
            phase_durations = {
                k: list(v) for k, v in self._phase_durations.items()
            }
        pump_stats = {
            name: cell.pump.stats()
            for name, cell in sorted(self.cells.items())
        }
        return build_artifact(
            self.scenario,
            ok=ok,
            initial_convergence_s=initial_s,
            convergence_s=conv_s,
            pending=pending,
            pump_stats=pump_stats,
            throttle=throttle,
            phase_durations=phase_durations,
            replica_stats=replica_stats,
            faults=faults,
            controllers=controllers,
            trace_stitch=self._stitch_traces(),
            lifecycle=lifecycle,
            kube_io={"core": "threaded", "regions": len(self.cells)},
            federation=self._federation_block(ok),
            notes=notes,
        )

    def _teardown(self) -> None:
        get_tracer().remove_sink(self._ctrl_sink)
        with self._heal_lock:
            timers = list(self._heal_timers)
            self._heal_timers = []
        for t in timers:
            t.cancel()
        # heal blackouts BEFORE stopping: a stopped server with the
        # gate still raised would hang client close paths on retries
        for cell in self.cells.values():
            cell.store.blackout = False
            cell.store.response_delay_s = 0.0
        if self.fed is not None:
            try:
                self.fed.stop()
            except Exception:
                log.warning("federation stop failed", exc_info=True)
        for cell in self.cells.values():
            try:
                cell.stop()
            except Exception:
                log.warning("region %s teardown failed", cell.name,
                            exc_info=True)
        self._tmp.cleanup()
