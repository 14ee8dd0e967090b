"""Scripted fault injection for simlab scenarios.

Each injector method executes one fault action from the timeline and
returns a log entry for the artifact. Faults act on the same surfaces
production faults would: the FakeKube store's injection knobs
(watch/list failures — the wire clients observe them as real HTTP
errors), the shared data-plane client's token bucket (throttle
squeeze), replica liveness (crash/restart), the coordination Lease
(leader flap — stolen exactly as a rogue writer would steal it, via a
CAS replace), and — the lifecycle families (ISSUE 12) — replica code
versions (rolling upgrade), the attestation key material (rotation /
revoked trust root, incl. the node-root forgery drill), the policy
surface (overlapping claims), and node cordons (evacuation drains
racing flips).

Timer discipline: every delayed callback goes through :meth:`_timer`,
which gates execution on the injector's cancelled flag — a timer that
fires after :meth:`cancel` is a no-op instead of mutating a torn-down
replica (the cancel-vs-in-flight-callback race is pinned by
tests/test_simlab.py). Restorative timers (throttle restore, uncordon)
additionally register with :meth:`settle` so a run that converges
before their delay still ends in the restored state.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.k8s.client import ApiException, ConflictError

log = logging.getLogger("tpu-cc-manager.simlab.faults")


class FaultInjector:
    def __init__(
        self,
        *,
        store,
        replicas: Dict[str, object],
        pool,
        data_kube,
        ops_kube,
        base_qps: float,
        lease_names: List[str],
        lease_namespace: str = "tpu-system",
        shard_manager=None,
        nodes_in_pool: Optional[Callable[[Optional[int]], List[str]]] = None,
        attest_lab=None,
        create_policy: Optional[Callable[..., dict]] = None,
        attestation_armed: Optional[Callable[[], bool]] = None,
        converge_mode: Optional[str] = None,
    ):
        self.store = store
        self.replicas = replicas
        self.pool = pool
        self.data_kube = data_kube
        self.ops_kube = ops_kube
        self.base_qps = base_qps
        self.lease_names = lease_names
        self.lease_namespace = lease_namespace
        #: tpu_cc_manager.shard.ShardManager when the scenario runs a
        #: sharded control plane (controllers.shards > 0)
        self.shard_manager = shard_manager
        #: pool-scope resolver (runner._nodes_in_pool); None scopes to
        #: every replica
        self.nodes_in_pool = nodes_in_pool
        #: runner.AttestationLab when scenario.attestation is on — the
        #: key_rotation / root_revoked surfaces
        self.attest_lab = attest_lab
        #: runner hook creating one TPUCCPolicy CR (policy_conflict)
        self.create_policy = create_policy
        #: runner hook: has any fleet scan verified a quote yet? The
        #: revoked-root drill waits for the outage latch to ARM before
        #: revoking — revoking a never-verified fleet tests nothing
        self.attestation_armed = attestation_armed
        #: the scenario's converge mode (forgery picks a contradicting
        #: claim deterministically)
        self.converge_mode = converge_mode
        self._timers: List[threading.Timer] = []
        #: guards _timers/_cancelled/_restores: cancel() vs an
        #: in-flight timer callback must never race a torn-down
        #: replica (the satellite fix — callbacks re-check under this
        #: lock before touching anything)
        self._timers_lock = threading.Lock()
        self._cancelled = False
        #: (name, fn) restorative callbacks not yet run: settle() runs
        #: them early so convergence-before-delay still restores state
        self._restores: Dict[int, Callable[[], None]] = {}
        self._restore_seq = 0
        #: restores currently EXECUTING (timer thread or settle);
        #: settle() waits these out — the oracle must never judge a
        #: fleet mid-uncordon
        self._restores_inflight = 0
        self._restores_done = threading.Condition(self._timers_lock)
        self.crashed_total = 0
        self.restarted_total = 0
        self.upgraded_total = 0
        #: logical node-write mutation units this injector's faults
        #: issued through the REAL write path (cordon/uncordon spec
        #: flips) — the invariants oracle subtracts them from the
        #: fleet's writes-per-flip budget
        self.fault_write_units = 0
        #: nodes the evacuation_drain fault cordoned (oracle: none may
        #: stay cordoned at quiescence)
        self.evacuated_nodes: List[str] = []
        #: monotonic stamp of the most recent shard_kill — the runner
        #: derives shard_failover_convergence_s (kill -> fleet
        #: converged) from it
        self.last_shard_kill_t: float = 0.0

    # ------------------------------------------------------------ dispatch
    def inject(self, fault: str, params: dict, rel_t: float) -> dict:
        entry = {"at_s": round(rel_t, 3), "fault": fault}
        entry.update(getattr(self, f"_{fault}")(params))
        log.info("fault injected: %s", entry)
        return entry

    def _timer(self, delay_s: float, fn, restore: bool = False) -> None:
        """Arm a delayed callback. The wrapper re-checks the cancelled
        flag under the timer lock at fire time, so a timer whose
        callback races cancel() becomes a no-op instead of mutating a
        replica the teardown already owns. ``restore=True`` marks fn
        as restorative: settle() runs it early (once) if the run ends
        before the delay elapses."""
        with self._timers_lock:
            if self._cancelled:
                return
            if restore:
                self._restore_seq += 1
                token = self._restore_seq
                self._restores[token] = fn
            else:
                token = None

        def guarded() -> None:
            with self._timers_lock:
                if self._cancelled:
                    return
                if token is not None:
                    # claim the restore: settle() must not run it twice
                    if self._restores.pop(token, None) is None:
                        return
                    self._restores_inflight += 1
            if token is None:
                fn()
                return
            try:
                fn()
            finally:
                with self._restores_done:
                    self._restores_inflight -= 1
                    self._restores_done.notify_all()

        t = threading.Timer(delay_s, guarded)
        t.daemon = True
        with self._timers_lock:
            if self._cancelled:
                return
            self._timers.append(t)
        t.start()

    # -------------------------------------------------------------- kinds
    def _restart_with_prime(self, victims: List[str]) -> None:
        """Restart each victim and replay the restarted agent's prime
        read: desired comes from the cluster, not from anything the
        dead process held. The cc.trace annotation rides the same node
        object (ISSUE 8), so a post-restart reconcile still joins the
        desired write's fleet-wide trace — exactly what the real
        agent's NodeWatcher.prime + latest_trace_context does after a
        DaemonSet restart."""
        for name in victims:
            replica = self.replicas[name]
            replica.restart()
            with self._timers_lock:
                # timeline thread (first upgrade cohort) and timer
                # threads both restart; the counter needs the lock
                self.restarted_total += 1
            try:
                node = self.ops_kube.get_node(name)
                meta = node["metadata"]
                desired = (meta.get("labels") or {}).get(
                    L.CC_MODE_LABEL
                )
                trace = (meta.get("annotations") or {}).get(
                    L.CC_TRACE_ANNOTATION
                )
            except ApiException:
                desired = None
                trace = None
            if desired is not None:
                self.pool.submit(name, desired, trace=trace)
            else:
                self.pool.requeue(name)  # drain anything it missed

    def _agent_crash(self, params: dict) -> dict:
        count = min(int(params["count"]), len(self.replicas))
        restart_after_s = float(params.get("restart_after_s", 1.0))
        victims = [
            name for name, r in sorted(self.replicas.items())
            if r.alive
        ][:count]
        for name in victims:
            self.replicas[name].crash()
        self.crashed_total += len(victims)
        # restorative: a run that converges while victims are still
        # down (they crashed already-converged) must end with the
        # restarts DONE, not cancelled at teardown — settle() runs
        # them early and waits them out
        self._timer(restart_after_s,
                    lambda: self._restart_with_prime(victims),
                    restore=True)
        return {"crashed": len(victims),
                "restart_after_s": restart_after_s}

    def _watch_drop(self, params: dict) -> dict:
        count = int(params["count"])
        with self.store._lock:
            self.store.fail_next_watches += count
        return {"count": count}

    def _watch_410(self, params: dict) -> dict:
        self.store.compact_watch_history()
        return {}

    def _list_429(self, params: dict) -> dict:
        count = int(params["count"])
        with self.store._lock:
            self.store.fail_next_lists += count
        return {"count": count}

    def _write_429(self, params: dict) -> dict:
        count = int(params["count"])
        with self.store._lock:
            self.store.fail_next_node_writes += count
        return {"count": count}

    def _throttle_squeeze(self, params: dict) -> dict:
        qps = float(params["qps"])
        duration_s = float(params["duration_s"])
        self.data_kube.set_qps(qps)
        self._timer(
            duration_s, lambda: self.data_kube.set_qps(self.base_qps),
            restore=True,
        )
        return {"qps": qps, "duration_s": duration_s}

    def _leader_flap(self, params: dict) -> dict:
        """Steal every election Lease for one term: the holder demotes
        at its next renew, the thief never renews, and a live replica
        re-acquires after staleness — adoption of any in-flight rollout
        record included."""
        from tpu_cc_manager_torch.leader import _now_rfc3339

        stolen = []
        for name in self.lease_names:
            for _ in range(5):  # CAS retry against a racing renew
                try:
                    lease = self.ops_kube.get_lease(
                        self.lease_namespace, name
                    )
                except ApiException:
                    break  # no lease yet: nothing to steal
                spec = lease.setdefault("spec", {})
                spec["holderIdentity"] = "simlab-flap"
                spec["renewTime"] = _now_rfc3339()
                try:
                    self.ops_kube.replace_lease(
                        self.lease_namespace, name, lease
                    )
                    stolen.append(name)
                    break
                except (ConflictError, ApiException):
                    time.sleep(0.02)
        return {"leases_stolen": stolen}

    def _shard_kill(self, params: dict) -> dict:
        """Crash one controller shard host mid-run: its partition's
        lease goes stale (no release) and a surviving host must
        re-acquire it and resume the partition's controllers — the
        failover drill the shard_failover_convergence_s axis times."""
        if self.shard_manager is None:
            return {"skipped": "no shard manager"}
        host = int(params.get("host", 0))
        self.last_shard_kill_t = time.monotonic()
        entry = self.shard_manager.kill_host(host)
        restart_after_s = params.get("restart_after_s")
        if restart_after_s is not None:
            self._timer(
                float(restart_after_s),
                lambda: self.shard_manager.restart_host(host),
            )
            entry["restart_after_s"] = float(restart_after_s)
        return entry

    # --------------------------------------------- lifecycle (ISSUE 12)
    def _scoped(self, pool) -> List[str]:
        names = (self.nodes_in_pool(pool) if self.nodes_in_pool
                 else sorted(self.replicas))
        return [n for n in names if n in self.replicas]

    def _agent_upgrade(self, params: dict) -> dict:
        """Rolling agent upgrade: the scoped replicas restart cohort by
        cohort with a new code-version behavior, so for the rollout's
        duration TWO code versions reconcile one pool. Each cohort is
        a crash + version swap + prime-read restart — the DaemonSet
        rolling-update analog; the stagger is the maxUnavailable
        window."""
        version = params.get("version", "v2")
        cohorts = max(1, int(params.get("cohorts", 2)))
        stagger_s = float(params.get("stagger_s", 0.25))
        names = self._scoped(params.get("pool"))
        cohorts = min(cohorts, max(1, len(names)))
        groups = [names[i::cohorts] for i in range(cohorts)]

        def roll(group: List[str]) -> Callable[[], None]:
            def fire() -> None:
                for name in group:
                    self.replicas[name].upgrade(version)
                self._restart_with_prime(group)
            return fire

        for i, group in enumerate(groups):
            if not group:
                continue
            if i == 0:
                roll(group)()  # first cohort goes down NOW
            else:
                # restorative: the rolling upgrade must COMPLETE —
                # a cohort whose stagger lands after convergence is
                # rolled by settle() instead of dying with the run
                self._timer(i * stagger_s, roll(group), restore=True)
        self.upgraded_total += len(names)
        return {"nodes": len(names), "cohorts": len(groups),
                "version": version, "stagger_s": stagger_s}

    def _key_rotation(self, params: dict) -> dict:
        """Rotate the attestation signing key fleet-wide, mid-scan:
        every node's TPM signs with the new key from now on, and the
        verifier trust root gains the new primary with the old key in
        its rotation tail — so in-flight quotes stay verifiable while
        the next wave's evidence re-quotes under the new key. The
        invariants oracle then requires every node's settled evidence
        to verify under the NEW primary alone."""
        if self.attest_lab is None:
            return {"skipped": "attestation disabled"}
        return self.attest_lab.rotate()

    def _root_revoked(self, params: dict) -> dict:
        """Revoke the VERIFIER's attestation trust root. The nodes are
        fine and keep quoting; nobody can check them anymore — the
        audit's attestation_outage latch must fire (loud problem, not
        a metric fade) and the fleet must never read as verified
        again. Waits (bounded) for a fleet scan to VERIFY a quote
        first: the latch only arms on a once-verified fleet, so
        revoking earlier would drill nothing.

        ``forge=true`` adds the node-root drill on top: one
        already-converged node's agent is killed (root owns the node
        now) and a forged evidence document — device claims rewritten,
        re-quoted, re-digested, exactly what root CAN do — is planted
        in its place. The measured flip history inside the quote still
        contradicts the claim, which needs no verifier key to read."""
        if self.attest_lab is None:
            return {"skipped": "attestation disabled"}
        armed = False
        if self.attestation_armed is not None:
            deadline = time.monotonic() + 20.0
            while time.monotonic() < deadline:
                if self.attestation_armed():
                    armed = True
                    break
                time.sleep(0.05)
        entry = self.attest_lab.revoke()
        entry["armed_before_revoke"] = armed
        if params.get("forge"):
            victim = self._pick_converged_node()
            if victim is None:
                entry["forged"] = None
                entry["forge_skipped"] = "no converged node to forge"
            else:
                # root took the node: the honest agent is dead and
                # stays dead, so the forged document cannot be healed
                # away by a later honest publish
                replica = self.replicas[victim]
                replica.crash()
                self.crashed_total += 1
                # deliver the dead agent's pending publications FIRST:
                # the forgery replaces the node's settled document —
                # a straggler honest flush overwriting the plant would
                # make the drill test nothing
                try:
                    replica.batcher.flush()
                except Exception:
                    log.warning("victim flush failed", exc_info=True)
                claim = self._contradicting_claim(replica)
                from tpu_cc_manager_torch.evidence import forge_evidence_claim
                import json as _json

                doc = forge_evidence_claim(
                    victim, replica.backend, claim,
                    attestor=replica.attestor,
                )
                # out-of-band store write: root writes the annotation
                # with its own credentials, not through the system
                # under test's flow-controlled clients
                self.store.set_node_labels_direct(victim, {}, annotations={
                    L.EVIDENCE_ANNOTATION: _json.dumps(
                        doc, sort_keys=True, separators=(",", ":")
                    ),
                })
                self.attest_lab.note_forged(victim, claim, doc)
                entry["forged"] = victim
                entry["forged_claim"] = claim
        return entry

    def _pick_converged_node(self) -> Optional[str]:
        """First node (deterministic order) whose state label already
        reads the converge mode — the forgery victim must not owe the
        fleet any further convergence. Bounded wait: the drill runs
        after the final wave, so someone converges soon."""
        if self.converge_mode is None:
            return None
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            for name in sorted(self.replicas):
                try:
                    state = self.store.peek_node_label(
                        name, L.CC_MODE_STATE_LABEL
                    )
                except ApiException:
                    continue
                if state == self.converge_mode:
                    return name
            time.sleep(0.05)
        return None

    def _contradicting_claim(self, replica) -> str:
        """A claim mode that contradicts the victim's measured flip
        history (what a forger claims is by definition not what the
        measured engine path last did)."""
        from tpu_cc_manager_torch.attest import measured_mode

        measured = None
        if replica.attestor is not None:
            try:
                _, events = replica.attestor._read_state()
                measured = measured_mode(events)
            except Exception:  # ccaudit: allow-swallow(unreadable TPM state just means no measured mode; the claim falls back to a fixed contradiction)
                measured = None
        return "off" if measured != "off" else "on"

    def _policy_conflict(self, params: dict) -> dict:
        """Two policies claiming overlapping pools: the OWNER (first in
        name order) selects the whole fleet; the RIVAL selects one
        pool inside it with a different target mode. The controller's
        name-ordered claim rule must park the rival in phase
        Conflicted — patching nothing — while the owner converges the
        fleet; the oracle pins both."""
        if self.create_policy is None:
            return {"skipped": "no policy surface"}
        pool = params.get("pool", 0)
        owner = self.create_policy(
            name="aa-conflict-owner", mode=params["mode"], pool=None,
        )
        rival = self.create_policy(
            name="zz-conflict-rival", mode=params["rival_mode"],
            pool=pool,
        )
        return {"owner": owner["policy"], "owner_mode": params["mode"],
                "rival": rival["policy"],
                "rival_mode": params["rival_mode"], "pool": pool}

    def _flip_latency(self, params: dict) -> dict:
        """Inject device-reset latency into the scoped replicas' fake
        chips (ISSUE 15): flips still SUCCEED, just slowly — the
        scripted anomaly the watchdog must catch live, with the guilty
        phase (``reset``) on the worker threads' stacks for the
        profiler and the slow reconciles' trace ids in the histogram
        exemplars. ``duration_s`` restores the original latency via a
        restorative timer (settle() runs it early on a fast run)."""
        delay_s = float(params["delay_s"])
        names = self._scoped(params.get("pool"))
        count = min(int(params.get("count", len(names))), len(names))
        victims = names[:count]
        # capture each chip's PRIOR latency before clobbering it, so
        # the restore puts back what was there — not a hardcoded 0
        # that would cancel an overlapping flip_latency fault (or a
        # scenario-configured baseline) early
        prior: List[tuple] = []
        for name in victims:
            for chip in self.replicas[name].backend.chips:
                prior.append((chip, chip._reset_latency_s))
                chip.set_reset_latency(delay_s)
        duration_s = params.get("duration_s")
        entry = {"nodes": len(victims), "delay_s": delay_s}
        if duration_s is not None:
            def restore() -> None:
                for chip, was in prior:
                    chip.set_reset_latency(was)

            self._timer(float(duration_s), restore, restore=True)
            entry["duration_s"] = float(duration_s)
        return entry

    def _evacuation_drain(self, params: dict) -> dict:
        """Region-evacuation drain racing in-flight flips: cordon N
        nodes through the REAL write path (spec.unschedulable — the
        kubectl-drain analog) while the mode storm is in flight, then
        uncordon after duration_s. The cordon must neither stop
        reconciliation (agents are DaemonSets; they tolerate) nor
        survive the run (settle() runs the uncordon early if the run
        converges first)."""
        count = int(params["count"])
        duration_s = float(params.get("duration_s", 1.0))
        names = self._scoped(params.get("pool"))[:count]
        cordoned = []
        for name in names:
            try:
                self.ops_kube.patch_node(
                    name, {"spec": {"unschedulable": True}}
                )
                cordoned.append(name)
                with self._timers_lock:
                    self.fault_write_units += 1
            except ApiException:
                log.warning("evacuation cordon failed for %s", name,
                            exc_info=True)
        self.evacuated_nodes.extend(cordoned)

        def uncordon() -> None:
            for name in cordoned:
                try:
                    self.ops_kube.patch_node(
                        name, {"spec": {"unschedulable": False}}
                    )
                    with self._timers_lock:
                        self.fault_write_units += 1
                except ApiException:
                    log.warning("evacuation uncordon failed for %s",
                                name, exc_info=True)

        self._timer(duration_s, uncordon, restore=True)
        return {"cordoned": len(cordoned), "duration_s": duration_s}

    # ----------------------------------------------------------- teardown
    def settle(self) -> None:
        """Run outstanding RESTORATIVE callbacks early (uncordon,
        throttle restore) and wait out ones already executing on a
        timer thread: a run that converges before (or during) their
        delay still ends in the restored state the invariants oracle
        judges. Each restore runs exactly once — here or in its
        timer, never both."""
        while True:
            with self._timers_lock:
                if self._cancelled:
                    return
                if not self._restores:
                    break
                token = next(iter(self._restores))
                fn = self._restores.pop(token)
                self._restores_inflight += 1
            try:
                fn()
            finally:
                with self._restores_done:
                    self._restores_inflight -= 1
                    self._restores_done.notify_all()
        deadline = time.monotonic() + 15.0
        with self._restores_done:
            while (self._restores_inflight > 0
                   and not self._cancelled
                   and time.monotonic() < deadline):
                self._restores_done.wait(timeout=0.1)
            if self._restores_inflight > 0:
                log.warning(
                    "settle: %d restorative callback(s) still in "
                    "flight after 15s", self._restores_inflight,
                )

    def cancel(self) -> None:
        """Cancel undelivered timers (teardown). A timer callback that
        already fired past Timer.cancel() re-checks the cancelled flag
        under the lock and becomes a no-op — it never mutates a
        torn-down replica (pinned by tests/test_simlab.py)."""
        with self._timers_lock:
            self._cancelled = True
            timers = list(self._timers)
            self._timers.clear()
            self._restores.clear()
        for t in timers:
            t.cancel()
