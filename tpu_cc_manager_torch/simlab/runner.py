"""SimLab — orchestrates one scenario run end to end.

Assembly (all in one process, all over the real HTTP wire):

- a :class:`~tpu_cc_manager.k8s.apiserver.FakeApiServer` holding the
  scenario's node fleet;
- N :class:`~tpu_cc_manager.simlab.replica.ReplicaShell` live agents
  sharing one flow-controlled data-plane client, executed by a bounded
  :class:`~tpu_cc_manager.simlab.replica.WorkerPool`;
- ONE :class:`~tpu_cc_manager.simlab.pump.WatchPump` feeding every
  replica's mailbox from a single fleet-wide watch stream;
- optional fleet/policy controllers (with a leader-elected policy pair
  when the scenario says so), so policy-driven rollouts and fleet
  audits run concurrently with the agent churn;
- a :class:`~tpu_cc_manager.simlab.faults.FaultInjector` executing the
  scenario's scripted faults on schedule.

The run is judged by convergence: every node's observed-state label
reaching ``converge.mode`` within ``converge.timeout_s``, measured from
the first action that initiates the change. The artifact
(:mod:`~tpu_cc_manager.simlab.report`) carries the number the bench
trend gate compares plus the full diagnostic surface.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Dict, List, Optional

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.device.fake import fake_backend
from tpu_cc_manager_torch.k8s.apiserver import FakeApiServer
from tpu_cc_manager_torch.k8s.client import HttpKubeClient, KubeConfig
from tpu_cc_manager_torch.k8s.objects import make_node
from tpu_cc_manager_torch.obs import (
    Metrics, kube_throttle_wait_histogram, watch_pump_lag_histogram,
)
from tpu_cc_manager_torch.flightrec import FlightRecorder, stitch_by_trace
from tpu_cc_manager_torch.simlab.faults import FaultInjector
from tpu_cc_manager_torch.simlab.pump import LagStamps, WatchPump
from tpu_cc_manager_torch.simlab.replica import (
    _EMPTY as _REPLICA_EMPTY, ReplicaShell, WorkerPool,
)
from tpu_cc_manager_torch.simlab.report import build_artifact
from tpu_cc_manager_torch.simlab.scenario import Scenario
from tpu_cc_manager_torch.trace import Tracer, format_traceparent, get_tracer

log = logging.getLogger("tpu-cc-manager.simlab")

#: the policy controllers' election Lease (must match __main__'s)
POLICY_LEASE = "tpu-cc-policy-controller"

#: pool-membership label on simlab nodes (scenario actions scope by it)
POOL_LABEL = "simlab.pool"


class AttestationLab:
    """Live attestation state for one scenario run: a software TPM per
    simulated node (own state dir, own measured flip history) plus the
    lab-provisioned VERIFIER trust root (TPU_CC_TPM_KEY for the run
    only — saved and restored), with key rotation and root revocation
    as first-class operations for the lifecycle faults.

    The split mirrors production exactly: the per-node TPMs are the
    node side (root can ask them to quote anything, cannot rewrite
    their history); the env key is the verifier side (the fleet
    audit's trust root). ``rotate`` moves both in the rotation posture
    (new primary + verify-only tail); ``revoke`` removes only the
    verifier side — the nodes keep quoting into the void, which is
    precisely the attestation_outage drill."""

    def __init__(self, node_names: List[str],
                 key_seed: str = "simlab-tpm-key"):
        import tempfile

        from tpu_cc_manager_torch.attest import FakeTpm

        self._tmp = tempfile.TemporaryDirectory(prefix="simlab-tpm-")
        self._key_seed = key_seed
        self._seq = 0
        self._retired: List[str] = []
        self.key = f"{key_seed}-0"
        self.rotations = 0
        self.revoked = False
        #: (node, claim, doc) per planted node-root forgery
        self.forged: List[dict] = []
        self.tpms = {
            name: FakeTpm(
                state_dir=os.path.join(self._tmp.name, name),
                key=self.key.encode(),
            )
            for name in node_names
        }
        # ALL four sources attest.tpm_key()/tpm_keys() read are owned
        # for the run — an ambient TPU_CC_TPM_KEY_FILE on the host
        # would otherwise keep the verifier silently keyed straight
        # through a "revocation" (and pollute rotation tails)
        self._prior_env = {
            name: os.environ.get(name)
            for name in ("TPU_CC_TPM_KEY", "TPU_CC_TPM_OLD_KEYS",
                         "TPU_CC_TPM_KEY_FILE",
                         "TPU_CC_TPM_OLD_KEYS_FILE")
        }
        os.environ["TPU_CC_TPM_KEY"] = self.key
        for name in ("TPU_CC_TPM_OLD_KEYS", "TPU_CC_TPM_KEY_FILE",
                     "TPU_CC_TPM_OLD_KEYS_FILE"):
            os.environ.pop(name, None)

    def rotate(self) -> dict:
        self._seq += 1
        self._retired.insert(0, self.key)
        self.key = f"{self._key_seed}-{self._seq}"
        # verifier first — retired keys into the verify-only rotation
        # tail (TPU_CC_TPM_OLD_KEYS, attest.tpm_keys), new primary in —
        # then the signers: no ordering window where a fresh quote is
        # unverifiable
        os.environ["TPU_CC_TPM_OLD_KEYS"] = "\n".join(self._retired)
        os.environ["TPU_CC_TPM_KEY"] = self.key
        for tpm in self.tpms.values():
            tpm.set_key(self.key.encode())
        self.rotations += 1
        return {"rotation": self._seq, "tail_keys": len(self._retired)}

    def revoke(self) -> dict:
        # losing the PRIMARY is the whole outage: retired keys alone
        # keep a verifier keyless by attest.tpm_keys' rule. Every
        # source goes, including the file fallbacks cleared at
        # construction — belt and braces against a mid-run setter.
        for name in self._prior_env:
            os.environ.pop(name, None)
        self.revoked = True
        return {"revoked": True}

    def note_forged(self, node: str, claim: str, doc: dict) -> None:
        self.forged.append({"node": node, "claim": claim, "doc": doc})

    def close(self) -> None:
        for name, prior in self._prior_env.items():
            if prior is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = prior
        self._tmp.cleanup()


def _env_int(name: str, default: int) -> int:
    """Positive-int env override; unset, unparseable, or <= 0 (the
    documented '0 = scenario's value') falls back to the default."""
    try:
        value = int(os.environ.get(name, "") or 0)
    except ValueError:
        return default
    return value if value > 0 else default


class SimLab:
    def __init__(self, scenario: Scenario):
        self.scenario = scenario
        # TPU_CC_SIMLAB_WORKERS overrides the scenario's worker count
        # (config.py table) — the sandbox knob for "this host has more
        # cores than the scenario assumed"
        self.workers = _env_int("TPU_CC_SIMLAB_WORKERS",
                                scenario.workers)
        #: shared-loop replica I/O (ISSUE 13): when set, the fleet's
        #: data-plane client is a SyncKubeFacade over ONE AsyncKubeClient
        #: event loop instead of the threaded HttpKubeClient — env-keyed
        #: (not scenario schema) so ANY committed scenario can run in
        #: either I/O mode without a byte changing in scenarios/*.json
        self.shared_loop = os.environ.get(
            "TPU_CC_SIMLAB_SHARED_LOOP", ""
        ).lower() in ("1", "true", "yes")
        self.server: Optional[FakeApiServer] = None
        self.node_names: List[str] = []
        self.replicas: Dict[str, ReplicaShell] = {}
        self.pool: Optional[WorkerPool] = None
        self.pump: Optional[WatchPump] = None
        self.stamps = LagStamps()
        self.injector: Optional[FaultInjector] = None
        #: per-node TPMs + verifier trust root (scenario.attestation)
        self.attest_lab: Optional[AttestationLab] = None
        self._controller_threads: List[threading.Thread] = []
        self._controllers: List[object] = []
        #: tpu_cc_manager.shard.ShardManager when controllers.shards>0
        self.shard_manager = None
        #: shared node informer feeding the (non-sharded) policy
        #: controllers' scan wakes AND their rollouts' event-driven
        #: judges (ISSUE 14); the sharded plane brings its own
        self._policy_informer = None
        #: monotonic stamp of measured-convergence completion (the
        #: shard failover axis is kill -> this)
        self._conv_end_t: Optional[float] = None
        self._phase_durations: Dict[str, List[float]] = {}
        self._phase_lock = threading.Lock()
        self.tracer = Tracer()
        self.tracer.add_sink(self._phase_sink)
        # the driver's own black box: its desired_write spans are the
        # controller half of every stitched trace (ISSUE 8) — one per
        # set_mode action, so a small ring is plenty
        self.driver_rec = FlightRecorder(
            name="driver", span_ring=256, event_ring=128, sample_ring=8,
        )
        # policy-driven rollouts stamp their desired_write spans on the
        # PROCESS-default tracer (rollout.py get_tracer()), whose ring
        # the replica batchers' publish spans also churn through — a
        # post-run ring read would race eviction at 256 replicas. A
        # filtered sink captures exactly the controller spans as they
        # close; attached in run(), detached in _teardown.
        self.ctrl_rec = FlightRecorder(
            name="controller", span_ring=256, event_ring=8, sample_ring=8,
        )

        def _ctrl_sink(span) -> None:
            if span.name == "desired_write":
                self.ctrl_rec.observe_span(span)

        self._ctrl_sink = _ctrl_sink
        # the fleet observatory (fleetobs.py, ISSUE 9): scrapes every
        # replica's metric set in-process on an interval, merges the
        # fleet exposition (validated), and burns SLO budgets from
        # deployments/slo.yaml. Its alert events note into a dedicated
        # black box collected with the rest of the recordings.
        self.observer = None
        self.slo_skipped: Optional[str] = None
        self.obs_rec = FlightRecorder(
            name="fleetobs", span_ring=8, event_ring=64, sample_ring=8,
        )
        # the fleet-level anomaly watchdog (watchdog.py, ISSUE 15):
        # rides the observer's merged sample history — one detector
        # over the whole fleet's windowed series instead of N per-
        # replica sampling threads. Incidents (exemplar trace ids +
        # live profile + black-box note) land in the artifact, with
        # each exemplar resolved against the fleet-wide trace stitch.
        self.watchdog = None
        self.profiler = None
        self.lag_hist = watch_pump_lag_histogram()
        self.throttle_hist = kube_throttle_wait_histogram()
        self._throttle_samples: List[float] = []
        self._throttle_lock = threading.Lock()

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

    def _client(self, qps: float = 0.0) -> HttpKubeClient:
        return HttpKubeClient(
            KubeConfig("127.0.0.1", self.server.port, use_tls=False),
            qps=qps,
        )

    def _pool_of(self, i: int) -> str:
        return f"p{i % self.scenario.pools}"

    # -------------------------------------------------------------- setup
    def _build_fleet(self) -> None:
        sc = self.scenario
        store = self.server.store
        self.node_names = [f"sim-{i:04d}" for i in range(sc.nodes)]
        for i, name in enumerate(self.node_names):
            store.add_node(make_node(name, labels={
                L.TPU_ACCELERATOR_LABEL: "tpu-v5p-slice",
                POOL_LABEL: self._pool_of(i),
                L.CC_MODE_LABEL: sc.initial_mode,
            }))
        if sc.attestation:
            self.attest_lab = AttestationLab(self.node_names)
        for name in self.node_names:
            self.replicas[name] = ReplicaShell(
                name, self.data_kube,
                fake_backend(n_chips=sc.chips_per_node),
                self.tracer, evidence=sc.evidence,
                metrics=Metrics(),
                attestor=(self.attest_lab.tpms[name]
                          if self.attest_lab is not None else None),
            )

    def _start_observer(self) -> None:
        """Build + start the SLO observer over every replica's metric
        render (in-process scrape — zero HTTP load on the system under
        test, and zero node writes by construction). Degrades loudly
        to a skipped block when pyyaml or slo.yaml is unavailable —
        observability must never fail a scenario on its own."""
        from tpu_cc_manager_torch import fleetobs

        try:
            objectives = fleetobs.load_slo(fleetobs.default_slo_path())
        except ImportError:
            self.slo_skipped = "pyyaml not installed"
            log.warning("slo engine skipped: pyyaml not installed")
            return
        except fleetobs.SloError as e:
            self.slo_skipped = f"slo.yaml invalid: {e}"
            log.warning("slo engine skipped: %s", e)
            return
        self.observer = fleetobs.FleetObserver(
            objectives, name=self.scenario.name, recorder=self.obs_rec,
        )
        if os.environ.get("TPU_CC_SIMLAB_WATCHDOG", "1").lower() not in (
                "0", "false", "no"):
            from tpu_cc_manager_torch.profiler import SamplingProfiler
            from tpu_cc_manager_torch.watchdog import Watchdog

            self.profiler = SamplingProfiler(name="simlab")
            self.watchdog = Watchdog(
                sources=[r.metrics for r in self.replicas.values()],
                profiler=self.profiler, recorder=self.obs_rec,
                name=self.scenario.name,
            )
            self.observer.add_listener(self.watchdog.consume)
        self.observer.start(
            [r.metrics.render for r in self.replicas.values()]
        )

    def _start_controllers(self) -> None:
        sc = self.scenario
        if sc.controllers.shards:
            # sharded control plane (ISSUE 11): N consistent-hash
            # controller shards over ONE shared node informer — each
            # shard a per-lease FleetController (and PolicyController
            # when the scenario runs the policy plane) scoped to its
            # pool partition; /fleet/metrics merges shard expositions
            from tpu_cc_manager_torch.shard import ShardManager

            self.shard_manager = ShardManager(
                lambda: self._client(qps=0),
                shards=sc.controllers.shards,
                pools=[f"p{i}" for i in range(sc.pools)],
                pool_label=POOL_LABEL,
                policy=sc.controllers.policy,
                fleet_interval_s=5.0,
                policy_interval_s=1.0,
                verify_evidence=sc.evidence,
            )
            self.shard_manager.start()
            if not self.shard_manager.wait_covered(timeout_s=15.0):
                log.warning(
                    "shard plane did not reach full partition coverage "
                    "before the timeline; continuing (coverage: %s)",
                    self.shard_manager.coverage(),
                )
            return
        if sc.controllers.fleet:
            from tpu_cc_manager_torch.fleet import FleetController

            fleet = FleetController(
                self._client(qps=sc.qps), interval_s=5.0, port=0,
                observer=self.observer,
            )
            self._controllers.append(fleet)
            t = threading.Thread(target=fleet.run, daemon=True,
                                 name="simlab-fleet")
            t.start()
            self._controller_threads.append(t)
        if sc.controllers.policy:
            from tpu_cc_manager_torch.policy import PolicyController
            from tpu_cc_manager_torch.watch import NodeInformer

            # ONE shared informer for every policy replica (the shard
            # plane has its own): feeds the controllers' node wakes
            # and their rollouts' delta-judged windows (ISSUE 14), so
            # in-scenario rollout judging adds zero LIST load to the
            # faulted API server
            informer = NodeInformer(self._client(qps=0),
                                    name="simlab-policy")
            try:
                informer.prime()
            except Exception:
                log.warning("simlab policy informer prime failed; "
                            "priming from the watch thread",
                            exc_info=True)
            self._policy_informer = informer.start()

            n = 2 if sc.controllers.leader_elect else 1
            for i in range(n):
                elector = None
                kube = self._client(qps=sc.qps)
                if sc.controllers.leader_elect:
                    from tpu_cc_manager_torch.leader import LeaderElector

                    # short terms so a flapped lease re-resolves inside
                    # scenario time; elector traffic rides an unlimited
                    # client like __main__._leader_elector does
                    elector = LeaderElector(
                        self._client(qps=0),
                        name=POLICY_LEASE,
                        identity=f"simlab-policy-{i}",
                        namespace="tpu-system",
                        lease_duration_s=2.0,
                        renew_period_s=0.5,
                        retry_period_s=0.25,
                    )
                ctrl = PolicyController(
                    kube, interval_s=1.0, port=0, poll_s=0.05,
                    verify_evidence=sc.evidence,
                    leader_elector=elector,
                    adopt_after_s=2.0,
                    informer=self._policy_informer,
                )
                self._controllers.append(ctrl)
                t = threading.Thread(target=ctrl.run, daemon=True,
                                     name=f"simlab-policy-{i}")
                t.start()
                self._controller_threads.append(t)

    # ------------------------------------------------------------- actions
    def _nodes_in_pool(self, pool: Optional[int]) -> List[str]:
        if pool is None:
            return self.node_names
        tag = f"p{pool}"
        return [
            name for i, name in enumerate(self.node_names)
            if self._pool_of(i) == tag
        ]

    def _act_set_mode(self, params: dict) -> dict:
        mode = params["mode"]
        names = self._nodes_in_pool(params.get("pool"))
        # ONE desired_write span per action, stamped as the cc.trace
        # annotation in the SAME store write as the desired label —
        # exactly the real controller contract (rollout.launch_group).
        # Every replica reconcile triggered by this action adopts the
        # context, so the fleet-wide stitch joins driver and replicas
        # on this span's trace id.
        with self.tracer.span(
            "desired_write", mode=mode, nodes=len(names),
            pool=params.get("pool"),
        ) as span:
            context = format_traceparent(span)
            for name in names:
                self.stamps.record(name, mode, time.monotonic())
                # out-of-band store write (like _wait_converged's
                # polling): the driver's input must neither add HTTP
                # load to the system under test nor soak a scripted
                # write_429 storm
                self.server.store.set_node_labels_direct(
                    name, {L.CC_MODE_LABEL: mode},
                    annotations={L.CC_TRACE_ANNOTATION: context},
                )
        self.driver_rec.observe_span(span)
        return {"mode": mode, "nodes": len(names),
                "trace_id": span.trace_id}

    def _create_policy(self, *, mode: str, pool: Optional[int],
                       name: Optional[str] = None,
                       max_unavailable: Optional[int] = None,
                       group_timeout_s: float = 120) -> dict:
        """Create one TPUCCPolicy CR in the store (shared by the
        create_policy action and the policy_conflict fault)."""
        selector = (f"{POOL_LABEL}=p{pool}" if pool is not None
                    else L.TPU_ACCELERATOR_LABEL)
        names = self._nodes_in_pool(pool)
        if max_unavailable is None:
            max_unavailable = len(names)
        if name is None:
            name = (f"simlab-{self.scenario.name}-"
                    f"{pool if pool is not None else 'all'}")
        self.server.store.add_custom(L.POLICY_GROUP, L.POLICY_PLURAL, {
            "apiVersion": f"{L.POLICY_GROUP}/{L.POLICY_VERSION}",
            "kind": L.POLICY_KIND,
            "metadata": {"name": name},
            "spec": {
                "mode": mode,
                "nodeSelector": selector,
                "strategy": {
                    "maxUnavailable": max_unavailable,
                    "groupTimeoutSeconds": group_timeout_s,
                },
            },
        })
        return {"policy": name, "mode": mode, "selector": selector}

    def _act_create_policy(self, params: dict) -> dict:
        return self._create_policy(
            mode=params["mode"],
            pool=params.get("pool"),
            max_unavailable=params.get("max_unavailable"),
            group_timeout_s=params.get("group_timeout_s", 120),
        )

    # --------------------------------------------------- fleet plane taps
    def _fleet_controllers(self) -> List[object]:
        from tpu_cc_manager_torch.fleet import FleetController

        ctls = [c for c in self._controllers
                if isinstance(c, FleetController)]
        if self.shard_manager is not None:
            ctls.extend(b.fleet for b in self.shard_manager.bundles())
        return ctls

    def _attestation_armed(self) -> bool:
        """Has any fleet scan verified a TEE quote yet? (The
        root_revoked fault waits for this — the outage latch only
        fires on a once-verified fleet.)"""
        return any(
            getattr(c, "attestation_ever_verified", False)
            for c in self._fleet_controllers()
        )

    def final_fleet_reports(self) -> List[dict]:
        """Every fleet controller's last report (after the settle
        scan) — the invariants oracle judges audit buckets and
        problems lines from these."""
        return [c.last_report for c in self._fleet_controllers()
                if getattr(c, "last_report", None)]

    # --------------------------------------------------------- convergence
    def _wait_converged(self, target: str, timeout_s: float):
        """(elapsed_s or None, pending names). Polls the store directly
        — measurement must not add HTTP load to the system under
        test."""
        store = self.server.store
        t0 = time.monotonic()
        deadline = t0 + timeout_s
        pending = set(self.node_names)
        while pending and time.monotonic() < deadline:
            pending = {
                n for n in pending
                if store.peek_node_label(
                    n, L.CC_MODE_STATE_LABEL) != target
            }
            if pending:
                time.sleep(0.05)
        if pending:
            return None, sorted(pending)
        return time.monotonic() - t0, []

    # ----------------------------------------------------------------- run
    def run(self) -> dict:
        sc = self.scenario
        # the CLI path has no conftest: keep platform identity and
        # attestation probes out of a lab run unless explicitly set
        os.environ.setdefault("TPU_CC_IDENTITY", "none")
        os.environ.setdefault("TPU_CC_ATTESTATION", "none")
        log.info("simlab: scenario %r — %d nodes / %d pools / "
                 "%d workers / qps=%s", sc.name, sc.nodes, sc.pools,
                 self.workers, sc.qps or "off")
        self.server = FakeApiServer().start()
        get_tracer().add_sink(self._ctrl_sink)
        notes = None
        faults: List[dict] = []
        try:
            if self.shared_loop:
                # opt-in shared-loop mode (ISSUE 13,
                # TPU_CC_SIMLAB_SHARED_LOOP): every replica's
                # publish/state writes multiplex ONE event loop's
                # pipelined connection pool (k8s/aio.py) through a
                # sync façade, instead of checking thread-private
                # sockets out of the threaded client's pool — the
                # 1,024-replica fleet exercises the same I/O core the
                # agent opts into with TPU_CC_KUBE_AIO. Same throttle
                # surface, so faults' set_qps squeezes and the
                # artifact's throttle block work unchanged.
                from tpu_cc_manager_torch.k8s.aio_bridge import SyncKubeFacade

                self.data_kube = SyncKubeFacade(
                    KubeConfig("127.0.0.1", self.server.port,
                               use_tls=False),
                    qps=sc.qps,
                )
            else:
                self.data_kube = self._client(qps=sc.qps)
            self.data_kube.add_throttle_observer(self._observe_throttle)
            self.ops_kube = self._client(qps=0)
            self._build_fleet()
            self.pool = WorkerPool(self.replicas, self.workers).start()
            self.pump = WatchPump(
                self._client(qps=0), self.replicas, self.pool,
                self.stamps, self.lag_hist,
                watch_timeout_s=sc.watch_timeout_s,
            )
            self.pump.prime()
            self.pump.start()
            self.injector = FaultInjector(
                store=self.server.store,
                replicas=self.replicas,
                pool=self.pool,
                data_kube=self.data_kube,
                ops_kube=self.ops_kube,
                base_qps=sc.qps,
                lease_names=(
                    [POLICY_LEASE] if sc.controllers.leader_elect else []
                ),
                nodes_in_pool=self._nodes_in_pool,
                attest_lab=self.attest_lab,
                create_policy=self._create_policy,
                attestation_armed=self._attestation_armed,
                converge_mode=sc.converge.mode,
            )

            # initial reconcile: one deliberate storm to initial_mode,
            # outside the measurement (the bench's wait_all("off") analog)
            for name in self.node_names:
                self.pool.submit(name, sc.initial_mode)
            initial_s, pending = self._wait_converged(
                sc.initial_mode, min(60.0, sc.converge.timeout_s)
            )
            if initial_s is None:
                notes = (f"{len(pending)} replicas never initialized "
                         f"to {sc.initial_mode!r}")
                return self._finish(False, None, None, pending, faults,
                                    notes)
            # observer starts AFTER the initial convergence storm: the
            # SLO budgets judge the scenario timeline, not the lab's
            # own setup traffic
            self._start_observer()
            self._start_controllers()
            if self.shard_manager is not None:
                self.injector.shard_manager = self.shard_manager

            # ---- the timeline (actions are pre-sorted by `at`)
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
                    faults.append(
                        self.injector.inject(kind, params, rel_t)
                    )
                    continue
                if action.kind == "set_mode":
                    entry = self._act_set_mode(action.params)
                else:
                    entry = self._act_create_policy(action.params)
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
            if conv_s is not None and t_change is not None:
                # convergence is change-initiation -> last node, not
                # wait-start -> last node (actions after the initiating
                # one consumed timeline seconds the fleet was already
                # converging through)
                conv_s = time.monotonic() - t_change
            ok = conv_s is not None
            if ok:
                # AFTER the measurement: settle time (straggler drain +
                # the final fleet scan) must not inflate the trend-gated
                # convergence number
                self._settle()
            if not ok:
                notes = (f"{len(pending)} nodes never reached "
                         f"{sc.converge.mode!r} within "
                         f"{sc.converge.timeout_s}s")
            return self._finish(ok, initial_s, conv_s, pending, faults,
                                notes)
        finally:
            self._teardown()

    def _settle(self) -> None:
        """After convergence: drain straggler work (the state label
        lands before that reconcile's evidence write), then run one
        final fleet scan so the artifact's audit reflects the settled
        fleet — mid-churn skew (evidence a throttled write behind its
        label) is the scan racing the storm, not an end-state
        finding."""
        if self.injector is not None:
            # restorative fault callbacks (uncordon, throttle restore)
            # run early: the settled fleet the oracle judges must be
            # the restored one even when convergence beat the delay
            self.injector.settle()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            busy = any(
                r._queued or r._pending is not _REPLICA_EMPTY
                for r in self.replicas.values()
            )
            if not busy:
                break
            time.sleep(0.05)
        # deliver deferred publications that found no carrier (the last
        # reconcile's evidence has no next state write to ride): the
        # final fleet scan below must audit the settled fleet, and the
        # newest-generation-always-lands contract is judged here
        for r in self.replicas.values():
            r.batcher.flush()
        for c in self._controllers:
            from tpu_cc_manager_torch.fleet import FleetController

            if isinstance(c, FleetController):
                try:
                    c.scan_once()
                except Exception:
                    log.warning("final fleet scan failed",
                                exc_info=True)
        if self.shard_manager is not None:
            for bundle in self.shard_manager.bundles():
                try:
                    bundle.fleet.scan_once()
                except Exception:
                    log.warning("final shard fleet scan failed",
                                exc_info=True)

    # ------------------------------------------------------ trace stitch
    def _stitch_traces(self) -> "tuple[dict, dict]":
        """Collect every process-local flight recording (driver +
        controllers + all replicas), stitch spans fleet-wide by trace
        id, and derive the end-to-end convergence distribution: for
        each desired-write trace, per node, label-commit
        (``desired_write`` span start) → that node's LAST adopted
        ``reconcile`` span end (the state publish happens inside it).
        This is the cross-process latency ROADMAP item 2 asks for —
        measured from causal traces, not from the driver's poll.
        Returns (summary block, the full stitched map) — the incident
        packets' exemplar trace ids are resolved against the map."""
        recordings = [self.driver_rec.snapshot("run_end"),
                      self.ctrl_rec.snapshot("run_end"),
                      self.obs_rec.snapshot("run_end")]
        for r in self.replicas.values():
            recordings.append(r.recorder.snapshot("run_end"))
        stitched = stitch_by_trace(recordings)
        from tpu_cc_manager_torch.simlab.report import percentile

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
            # one stitched fleet timeline as evidence the propagation
            # works end to end (capped: the artifact must stay small)
            "timeline_example": example[:12],
        }, stitched

    def _incidents_block(self, stitched: dict) -> Optional[dict]:
        """The watchdog's autopsy record for the artifact (ISSUE 15):
        each packet's exemplar trace ids resolved against the
        fleet-wide stitch — ``resolved_trace_ids`` are ids present in
        the stitched map at all, ``cross_process_trace_ids`` the
        subset whose span bucket spans more than one recorder (the
        incident demonstrably joins a controller's desired write to a
        replica's slow reconcile)."""
        if self.watchdog is None:
            return None
        cross_ids = {
            tid for tid, spans in stitched.items()
            if len({s.get("recorder") for s in spans
                    if s.get("recorder")}) > 1
        }
        packets = []
        for p in self.watchdog.incidents():
            p = dict(p)
            tids = {
                e.get("trace_id") for e in (p.get("exemplars") or [])
                if e.get("trace_id")
            }
            p["resolved_trace_ids"] = sorted(tids & set(stitched))
            p["cross_process_trace_ids"] = sorted(tids & cross_ids)
            packets.append(p)
        return {
            "count": self.watchdog.incidents_total,
            "last_capture_s": self.watchdog.last_capture_s,
            "packets": packets[-8:],
        }

    def _finish(self, ok, initial_s, conv_s, pending, faults, notes):
        replica_stats = {"total": 0, "repairs": 0, "coalesced": 0}
        # the coalescing publish core's loss accounting, fleet-wide
        # (ISSUE 6): superseded/folded/flushed/retried/dropped
        # publications across every replica batcher
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
        # HTTP round trips vs the logical mutations they carried: the
        # gap is the batching win; per-request numbers without this
        # split would silently inflate under coalescing
        if self.server is not None:
            replica_stats["api_writes"] = (
                self.server.store.node_write_stats()
            )
        from tpu_cc_manager_torch.simlab.report import percentile

        with self._throttle_lock:
            waits = list(self._throttle_samples)
        throttle = {
            "waits": self.data_kube.throttle_waits,
            "wait_s_total": round(
                self.data_kube.throttle_wait_s_total, 4),
            "wait_p50_s": percentile(waits, 0.50),
            "wait_max_s": round(max(waits), 5) if waits else None,
            "histogram": self.throttle_hist.snapshot(),
        }
        # which I/O core served the fleet's data plane — with the
        # async core's own accounting (dials vs requests is the
        # multiplexing win; replays prove the exactly-once path)
        kube_io = {"core": "aio" if self.shared_loop else "threaded"}
        if self.shared_loop:
            kube_io.update(self.data_kube.stats())
        controllers = {"running": len(self._controllers)}
        for c in self._controllers:
            report = getattr(c, "last_report", None) or {}
            # the policy controller's report keys policies by name; the
            # fleet controller's carries a list of policy summaries
            policies = report.get("policies")
            if isinstance(policies, dict):
                phases = {
                    name: (st or {}).get("phase")
                    for name, st in policies.items()
                }
                if phases:
                    controllers.setdefault("policy_phases", {}).update(
                        phases)
            if "problems" in report:
                # headline-capped: a fleet-wide finding enumerates every
                # node and would dwarf the artifact
                controllers["fleet_problems"] = [
                    p if len(p) <= 160 else p[:160] + "..."
                    for p in report["problems"][:5]
                ]
                controllers["fleet_problem_count"] = len(
                    report["problems"])
        if self.injector is not None:
            replica_stats["crashed"] = self.injector.crashed_total
            replica_stats["restarted"] = self.injector.restarted_total
        # lifecycle surface (ISSUE 12): versions running at quiescence,
        # upgrade/evacuation accounting, and the attestation lab state
        # — the invariants oracle reads the live lab, but the artifact
        # must carry enough for a regression reader too
        versions: Dict[str, int] = {}
        for r in self.replicas.values():
            versions[r.version] = versions.get(r.version, 0) + 1
        lifecycle = {"versions": versions}
        if self.injector is not None:
            lifecycle["upgraded"] = self.injector.upgraded_total
            lifecycle["evacuated"] = len(self.injector.evacuated_nodes)
        if self.attest_lab is not None:
            lifecycle["attestation"] = {
                "rotations": self.attest_lab.rotations,
                "revoked": self.attest_lab.revoked,
                "forged_nodes": [f["node"]
                                 for f in self.attest_lab.forged],
            }
        shards = None
        if self.shard_manager is not None:
            from tpu_cc_manager_torch.obs import validate_exposition

            killed = bool(self.injector is not None
                          and self.injector.last_shard_kill_t)
            handoffs_done = False
            if killed:
                # the fleet may converge before the dead shard's lease
                # ripens: the failover axis judges control-plane
                # recovery too, so wait (bounded) for the coverage
                # monitor to stamp every handoff
                handoffs_done = self.shard_manager.wait_failovers(
                    timeout_s=30.0
                )
            merged = self.shard_manager.merged_fleet_metrics()
            stats = self.shard_manager.stats()
            shards = {
                "stats": stats,
                # the one-fleet-view contract: the merged per-shard
                # /fleet/metrics must itself be a valid exposition
                "merged_exposition_problems": len(
                    validate_exposition(merged)
                ),
            }
            if killed and self._conv_end_t is not None:
                # the ISSUE 11 failover axis: shard kill -> BOTH every
                # node at the target mode AND the orphaned partition
                # re-held by a survivor (whichever lands later). A
                # handoff that never completed must leave the axis
                # ABSENT (None downstream) — agents converge
                # autonomously, so stamping convergence alone would
                # let a broken lease takeover pass as a small, green
                # number on the exact axis that gates it (bench.py and
                # shard_smoke both fail loudly on None).
                handoffs = [
                    f["handoff_s"] for f in stats["failovers"]
                    if f["handoff_s"] is not None
                ]
                if handoffs_done and handoffs:
                    shards["failover_convergence_s"] = round(max(
                        max(0.0, self._conv_end_t
                            - self.injector.last_shard_kill_t),
                        max(handoffs),
                    ), 4)
                else:
                    log.error(
                        "shard failover never completed: %s",
                        stats["failovers"],
                    )
        # final SLO state: one closing observe() so the artifact's
        # budget/alert story includes everything through settle, then
        # the engine's summary (or the honest skip reason)
        if self.observer is not None:
            try:
                self.observer.observe(
                    [r.metrics.render for r in self.replicas.values()]
                )
            except Exception:
                log.warning("closing slo observe failed", exc_info=True)
            slo = self.observer.summary()
        else:
            slo = {"skipped": self.slo_skipped or "observer not started"}
        with self._phase_lock:
            phase_durations = {
                k: list(v) for k, v in self._phase_durations.items()
            }
        trace_stitch, stitched = self._stitch_traces()
        return build_artifact(
            self.scenario,
            ok=ok,
            initial_convergence_s=initial_s,
            convergence_s=conv_s,
            pending=pending,
            pump_stats=(self.pump.stats() if self.pump else {}),
            throttle=throttle,
            phase_durations=phase_durations,
            replica_stats=replica_stats,
            faults=faults,
            controllers=controllers,
            trace_stitch=trace_stitch,
            slo=slo,
            incidents=self._incidents_block(stitched),
            shards=shards,
            lifecycle=lifecycle,
            kube_io=kube_io,
            notes=notes,
        )

    def _teardown(self) -> None:
        get_tracer().remove_sink(self._ctrl_sink)
        if self.shared_loop and getattr(self, "data_kube", None) is not None:
            # reclaim the shared loop's pooled connections (and their
            # reader tasks) — the bridge loop itself outlives the run
            try:
                self.data_kube.close()
            except Exception:
                log.warning("shared-loop client close failed",
                            exc_info=True)
        if self.observer is not None:
            self.observer.stop()
        if self.injector is not None:
            self.injector.cancel()
        for c in self._controllers:
            try:
                c.stop()
            except Exception:
                log.warning("controller stop failed", exc_info=True)
        if self.shard_manager is not None:
            try:
                self.shard_manager.stop()
            except Exception:
                log.warning("shard manager stop failed", exc_info=True)
        if self._policy_informer is not None:
            try:
                self._policy_informer.stop()
            except Exception:
                log.warning("policy informer stop failed", exc_info=True)
        for t in self._controller_threads:
            t.join(timeout=5)
        if self.pump is not None:
            self.pump.stop()
        if self.pool is not None:
            self.pool.stop()
        if self.server is not None:
            self.server.stop()
        if self.attest_lab is not None:
            # restores the process's prior TPU_CC_TPM_KEY posture and
            # removes the per-node TPM state dirs
            self.attest_lab.close()
