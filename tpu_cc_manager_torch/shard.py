"""Horizontal control-plane sharding (ISSUE 11 / ROADMAP item 2).

One fleet/policy controller pair tops out well below the north-star
scale: simlab runs 256 live replicas through a single scanner, and the
per-scan API round trips — not device work — are the measured ceiling
(BENCH_NOTES r03). This module is the classic control-plane answer,
retargeted at the TPU CC reconciler:

- **Consistent-hash partitioning** (:class:`HashRing`): pools map to a
  fixed set of shard ids via a virtual-node hash ring, so adding or
  removing a shard moves only ~1/N of the pools (pinned by
  tests/test_shard.py). The ring is the ONLY sanctioned pool->shard
  lookup; ccaudit's ``shard-bypass`` rule fails cross-shard partition
  access that skips it.
- **A lease per shard** (``tpu-cc-shard-<k>``): each controller host
  runs a :class:`~tpu_cc_manager.leader.LeaderElector` per shard lease.
  The preferred host (shard index modulo host count) contests
  immediately; every other host starts with an ``initial_delay_s``
  handicap and then competes under the elector's observed-staleness
  rule — so a healthy fleet settles one shard per host, and a dead
  host's partition is re-acquired by a survivor after one lease
  duration, CAS-arbitrated.
- **Scoped controllers per held lease** (:class:`ControllerShard`): a
  host that wins shard *k*'s lease runs a
  :class:`~tpu_cc_manager.fleet.FleetController` whose node view is
  filtered to shard *k*'s pools, and (optionally) a
  :class:`~tpu_cc_manager.policy.PolicyController` whose policy view is
  filtered to the policies the ring assigns shard *k*. Demotion stops
  the bundle; the record-adoption machinery in policy.py finishes any
  rollout the dead shard left behind.
- **One shared informer, zero scan reads**: every shard's controllers
  read through one :class:`~tpu_cc_manager.watch.NodeInformer`
  (one watch stream + one priming LIST for the whole process), so
  steady-state scans perform zero node read round trips regardless of
  shard count.
- **One fleet view**: the manager merges every live shard's
  ``/fleet/metrics`` exposition (fleetobs merge semantics) and serves
  the aggregate — plus its own coverage/failover gauges — on a single
  ``/fleet/metrics`` route.

docs/sharding.md states the full contract.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import logging
import threading
import time
from typing import (
    TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Set,
    Tuple,
)

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.leader import LeaderElector
from tpu_cc_manager_torch.obs import (
    Counter, Gauge, RouteServer, render_metric_set, validate_exposition,
)
from tpu_cc_manager_torch.watch import NodeInformer

if TYPE_CHECKING:  # runtime imports stay lazy (fleet/policy import shard-adjacent modules)
    from tpu_cc_manager_torch.policy import PolicyController

log = logging.getLogger("tpu-cc-manager.shard")

#: lease name for shard k (namespace is the manager's)
SHARD_LEASE_FMT = "tpu-cc-shard-{index}"

#: virtual nodes per ring member: enough that a handful of shards
#: split pools near-evenly without making ring construction slow
DEFAULT_VNODES = 64


def _hash64(key: str) -> int:
    """Stable 64-bit hash (sha256 prefix): Python's ``hash()`` is
    salted per process, and the ring MUST agree across every controller
    host or two shards would both claim one pool."""
    return int.from_bytes(
        hashlib.sha256(key.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Consistent-hash ring over a fixed member set.

    ``owner_of(key)`` walks clockwise from the key's hash to the first
    virtual node; removing a member reassigns ONLY that member's arcs
    (``without()`` — the failover/scale-down movement bound the tests
    pin). Construction is deterministic across processes.

    Region affinity (federation, ISSUE 16): members may carry a region
    tag (``regions={member: region}``). ``owner_of(key, region=r)``
    walks clockwise to the first virtual node belonging to a member OF
    THAT REGION — the global vnode order is untouched, so the walk is
    still deterministic across processes, removing one member still
    moves only ~1/N of the region's keys (its arcs redistribute among
    the region's survivors), and a region with no members left falls
    back to the plain global walk: failover leaves the home region
    ONLY when the whole region is down."""

    def __init__(self, members: Sequence[str],
                 vnodes: int = DEFAULT_VNODES,
                 regions: Optional[Dict[str, str]] = None) -> None:
        if not members:
            raise ValueError("a hash ring needs at least one member")
        if len(set(members)) != len(members):
            raise ValueError(f"duplicate ring members: {sorted(members)}")
        self.members = tuple(members)
        self.vnodes = vnodes
        self.regions: Dict[str, str] = dict(regions or {})
        stray = sorted(set(self.regions) - set(self.members))
        if stray:
            raise ValueError(f"region tags for non-members: {stray}")
        points: List[Tuple[int, str]] = []
        for m in members:
            for v in range(vnodes):
                points.append((_hash64(f"{m}#{v}"), m))
        points.sort()
        self._points = points
        self._hashes = [h for h, _ in points]
        self._region_members: Dict[str, frozenset] = {}
        by_region: Dict[str, set] = {}
        for m in self.members:
            r = self.regions.get(m)
            if r is not None:
                by_region.setdefault(r, set()).add(m)
        self._region_members = {
            r: frozenset(ms) for r, ms in by_region.items()
        }

    def owner_of(self, key: str, region: Optional[str] = None) -> str:
        """The member owning ``key`` — the one true pool->shard lookup
        (ccaudit's shard-bypass and region-bypass rules treat partition
        access without it as a finding). With ``region``, the walk is
        constrained to that region's members (home-region placement);
        an empty/unknown region falls back to the global walk."""
        h = _hash64(key)
        i = bisect.bisect_right(self._hashes, h)
        if i == len(self._points):
            i = 0
        if region is None or region not in self._region_members:
            return self._points[i][1]
        n = len(self._points)
        for step in range(n):
            m = self._points[(i + step) % n][1]
            if self.regions.get(m) == region:
                return m
        return self._points[i][1]  # unreachable: region set non-empty

    def partition(self, keys: Sequence[str],
                  region_of: Optional[Callable[[str], Optional[str]]]
                  = None) -> Dict[str, List[str]]:
        """All members' partitions at once: member -> sorted keys
        (members owning nothing map to an empty list). ``region_of``
        maps a key to its home region for region-affine placement."""
        out: Dict[str, List[str]] = {m: [] for m in self.members}
        for key in keys:
            region = region_of(key) if region_of is not None else None
            out[self.owner_of(key, region=region)].append(key)
        for v in out.values():
            v.sort()
        return out

    def members_in(self, region: str) -> List[str]:
        """The ring members tagged with ``region`` (sorted)."""
        return sorted(self._region_members.get(region, ()))

    def region_of(self, member: str) -> Optional[str]:
        return self.regions.get(member)

    def without(self, member: str) -> "HashRing":
        """The ring minus one member (scale-down / permanent loss):
        only the removed member's keys move — the consistent-hash
        property the partition layer exists for. Region tags survive."""
        rest = [m for m in self.members if m != member]
        return HashRing(rest, vnodes=self.vnodes, regions={
            m: r for m, r in self.regions.items() if m != member
        })


class ShardScopedClient:
    """Read-scoping client facade: ``list_nodes`` filtered by a node
    predicate and/or ``list_cluster_custom`` filtered by an object-name
    predicate; every other verb — all writes included — passes through
    untouched. Controllers stay completely unaware they are sharded."""

    def __init__(self, base: Any, *,
                 node_filter: Optional[Callable[[dict], bool]] = None,
                 custom_filter: Optional[Callable[[str], bool]] = None,
                 ) -> None:
        self.base = base
        self.node_filter = node_filter
        self.custom_filter = custom_filter

    def list_nodes(self, label_selector: Optional[str] = None) -> List[dict]:
        nodes = self.base.list_nodes(label_selector)
        if self.node_filter is None:
            return nodes
        return [n for n in nodes if self.node_filter(n)]

    def list_cluster_custom(self, group: str, version: str,
                            plural: str) -> List[dict]:
        objs = self.base.list_cluster_custom(group, version, plural)
        if self.custom_filter is None:
            return objs
        return [
            o for o in objs
            if self.custom_filter((o.get("metadata") or {}).get("name", ""))
        ]

    def __getattr__(self, name: str) -> Any:
        return getattr(self.base, name)


class ControllerShard:
    """The controller bundle for ONE shard's partition, constructed on
    lease acquisition and torn down on demotion. Owns a partition-
    scoped FleetController (always) and PolicyController (when the
    manager runs the policy plane)."""

    def __init__(self, manager: "ShardManager", shard_id: str) -> None:
        self.manager = manager
        self.shard_id = shard_id
        self.pools = frozenset(manager.pools_of(shard_id))
        self._threads: List[threading.Thread] = []
        from tpu_cc_manager_torch.fleet import FleetController

        pool_label = manager.pool_label
        pools = self.pools

        def in_partition(node: dict) -> bool:
            labels = (node.get("metadata") or {}).get("labels") or {}
            return labels.get(pool_label) in pools

        self.node_filter = in_partition
        self.fleet = FleetController(
            # the partition predicate rides INSIDE the informer client
            # (applied before the cache deepcopy) AND as the
            # controller's node_filter (the watch-feed/wake gate)
            manager.informer.client(manager.client_factory(),
                                    node_filter=in_partition),
            selector=manager.selector,
            interval_s=manager.fleet_interval_s,
            port=0,
            informer=manager.informer,
            node_filter=in_partition,
            # per-region attestation trust root (federation, ISSUE 16):
            # the audit verifies quotes under THIS manager's explicit
            # key posture instead of the process-global env — a revoked
            # root in one region latches only that region's shards
            attest_key=manager.attest_key,
        )
        self.policy: Optional["PolicyController"] = None
        if manager.policy:
            from tpu_cc_manager_torch.policy import PolicyController

            ring = manager.ring
            sid = shard_id
            self.policy = PolicyController(
                ShardScopedClient(
                    manager.informer.client(manager.client_factory()),
                    custom_filter=lambda name: ring.owner_of(name) == sid,
                ),
                interval_s=manager.policy_interval_s,
                port=0,
                poll_s=manager.policy_poll_s,
                verify_evidence=manager.verify_evidence,
                adopt_after_s=manager.adopt_after_s,
                informer=manager.informer,
            )

    def start(self) -> "ControllerShard":
        t = threading.Thread(
            target=self.fleet.run, daemon=True,
            name=f"shard-fleet-{self.shard_id}",
        )
        t.start()
        self._threads.append(t)
        if self.policy is not None:
            t2 = threading.Thread(
                target=self.policy.run, daemon=True,
                name=f"shard-policy-{self.shard_id}",
            )
            t2.start()
            self._threads.append(t2)
        return self

    def stop(self) -> None:
        self.fleet.stop()
        if self.policy is not None:
            self.policy.stop()
        for t in self._threads:
            t.join(timeout=5)

    def metrics_text(self) -> str:
        """This shard's fleet exposition (the per-shard /fleet/metrics
        input the manager merges)."""
        return self.fleet.metrics.render()


class ShardHost:
    """One controller-process replica: an elector per shard lease plus
    the ControllerShard bundles for every lease it currently holds."""

    def __init__(self, manager: "ShardManager", index: int) -> None:
        self.manager = manager
        self.index = index
        self.host_id = f"host-{index}"
        self._lock = threading.Lock()
        self._bundles: Dict[str, ControllerShard] = {}
        self._electors: Dict[str, LeaderElector] = {}
        self._alive = False

    # ---------------------------------------------------------- promotion
    def _on_promoted(self, shard_id: str) -> None:
        bundle = ControllerShard(self.manager, shard_id)
        stale: Optional[ControllerShard] = None
        with self._lock:
            if not self._alive:
                stale = bundle  # crashed while the callback was in flight
            else:
                stale = self._bundles.pop(shard_id, None)
                self._bundles[shard_id] = bundle
        if stale is not None and stale is not bundle:
            stale.stop()
        if stale is bundle:
            return
        bundle.start()
        log.info("%s: acquired shard %s (pools %s)", self.host_id,
                 shard_id, sorted(bundle.pools))

    def _on_demoted(self, shard_id: str) -> None:
        with self._lock:
            bundle = self._bundles.pop(shard_id, None)
        if bundle is not None:
            bundle.stop()
            log.warning("%s: lost shard %s; controllers stopped",
                        self.host_id, shard_id)

    # ---------------------------------------------------------- lifecycle
    def start(self) -> "ShardHost":
        m = self.manager
        with self._lock:
            self._alive = True
        for k, shard_id in enumerate(m.shard_ids):
            preferred = (k % m.n_hosts) == self.index
            elector = LeaderElector(
                m.client_factory(),
                name=SHARD_LEASE_FMT.format(index=k),
                identity=self.host_id,
                namespace=m.lease_namespace,
                lease_duration_s=m.lease_duration_s,
                renew_period_s=m.renew_period_s,
                retry_period_s=m.retry_period_s,
                initial_delay_s=(
                    0.0 if preferred else m.lease_duration_s
                ),
                on_started_leading=(
                    lambda sid=shard_id: self._on_promoted(sid)
                ),
                on_stopped_leading=(
                    lambda sid=shard_id: self._on_demoted(sid)
                ),
            )
            with self._lock:
                self._electors[shard_id] = elector
            elector.start()
        return self

    def crash(self) -> None:
        """Die without releasing anything: peers must wait out lease
        staleness, exactly like a real process death (the shard-kill
        fault). Controllers stop via the electors' demotion callbacks."""
        with self._lock:
            self._alive = False
            electors = list(self._electors.values())
            self._electors = {}
        for e in electors:
            e.abandon()

    def stop(self) -> None:
        """Clean shutdown: release held leases so peers take over
        immediately."""
        with self._lock:
            self._alive = False
            electors = list(self._electors.values())
            self._electors = {}
        for e in electors:
            e.stop()
        with self._lock:
            bundles = list(self._bundles.values())
            self._bundles = {}
        for b in bundles:
            b.stop()

    # ------------------------------------------------------------ reading
    @property
    def alive(self) -> bool:
        with self._lock:
            return self._alive

    def held_shards(self) -> List[str]:
        with self._lock:
            return sorted(
                sid for sid, e in self._electors.items() if e.is_leader
            )

    def covered_shards(self) -> List[str]:
        """Shards this host both HOLDS (lease) and RUNS (controller
        bundle constructed) — coverage means scans are actually
        happening, not just that a lease moved."""
        with self._lock:
            return sorted(
                sid for sid, e in self._electors.items()
                if e.is_leader and sid in self._bundles
            )

    def bundles(self) -> List[ControllerShard]:
        with self._lock:
            return list(self._bundles.values())


class ShardMetrics:
    """The manager's own fleet-view metric set (rendered by reflection
    like every other set)."""

    def __init__(self) -> None:
        self.hosts_live = Gauge(
            "tpu_cc_shard_hosts_live",
            "Controller shard hosts currently alive",
        )
        self.partitions_covered = Gauge(
            "tpu_cc_shard_partitions_covered",
            "Shard partitions currently held by a live host's lease",
        )
        self.partitions_total = Gauge(
            "tpu_cc_shard_partitions_total",
            "Shard partitions (consistent-hash ring members)",
        )
        self.failovers_total = Counter(
            "tpu_cc_shard_failovers_total",
            "Shard partitions re-acquired after a host loss",
        )
        self.merge_invalid_total = Counter(
            "tpu_cc_shard_merge_invalid_total",
            "Merged per-shard fleet expositions that failed validation",
        )

    def render(self) -> str:
        return render_metric_set(self)


class ShardManager:
    """N consistent-hash controller shards over one shared informer.

    Owns: the ring, the shard hosts (each an elector per lease +
    scoped controllers per held lease), the shared
    :class:`~tpu_cc_manager.watch.NodeInformer`, the merged
    ``/fleet/metrics`` route, and the failover bookkeeping the
    ``shard_failover_convergence_s`` bench axis reads."""

    def __init__(
        self,
        client_factory: Callable[[], Any],
        *,
        shards: Optional[int] = None,
        pools: Sequence[str],
        pool_label: str,
        hosts: Optional[int] = None,
        selector: str = L.TPU_ACCELERATOR_LABEL,
        policy: bool = False,
        fleet_interval_s: float = 5.0,
        policy_interval_s: float = 1.0,
        policy_poll_s: float = 0.05,
        verify_evidence: bool = False,
        adopt_after_s: float = 2.0,
        lease_namespace: str = "tpu-system",
        lease_duration_s: float = 2.0,
        renew_period_s: float = 0.5,
        retry_period_s: float = 0.25,
        port: int = 0,
        shard_ids: Optional[Sequence[str]] = None,
        ring: Optional[HashRing] = None,
        attest_key: Any = None,
        region: Optional[str] = None,
    ) -> None:
        if shard_ids is not None:
            if not shard_ids:
                raise ValueError("shard_ids must be non-empty")
            self.shard_ids = list(shard_ids)
            shards = len(self.shard_ids)
        else:
            if shards is None or shards < 1:
                raise ValueError(f"shards must be >= 1, got {shards}")
            self.shard_ids = [f"shard-{k}" for k in range(shards)]
        self.client_factory = client_factory
        #: ring injection (federation, ISSUE 16): the federation layer
        #: hands each region's manager a region-scoped view of ONE
        #: federation-wide region-affine ring, so every host agrees on
        #: placement without a second hashing scheme. Default: a plain
        #: private ring over this manager's shard ids.
        self.ring = ring if ring is not None else HashRing(self.shard_ids)
        #: explicit attestation verifier posture for this manager's
        #: fleet controllers (None = process-global env resolution) —
        #: the per-region trust-root boundary
        self.attest_key = attest_key
        #: region tag (stats/logs only; placement is the ring's job)
        self.region = region
        self.pools = list(pools)
        self.pool_label = pool_label
        self.selector = selector
        self.n_hosts = hosts if hosts is not None else shards
        if self.n_hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.n_hosts}")
        self.policy = policy
        self.fleet_interval_s = fleet_interval_s
        self.policy_interval_s = policy_interval_s
        self.policy_poll_s = policy_poll_s
        self.verify_evidence = verify_evidence
        self.adopt_after_s = adopt_after_s
        self.lease_namespace = lease_namespace
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.retry_period_s = retry_period_s
        #: the ONE watch stream + read cache every shard's controllers
        #: share (ISSUE 11: informer-fed scans, zero node read RPCs).
        #: In a federation each region's manager owns its own informer
        #: against its home API server — the per-region judge reads
        #: this cache and never crosses a region boundary.
        self.informer = NodeInformer(
            client_factory(),
            name=f"shards-{region}" if region else "shards",
        )
        self._partition = self.ring.partition(self.pools)
        self.hosts = [ShardHost(self, i) for i in range(self.n_hosts)]
        self.metrics = ShardMetrics()
        self.metrics.partitions_total.set(shards)
        self._lock = threading.Lock()
        #: failover log: {shard kills -> coverage-restored seconds}
        self._failovers: List[dict] = []
        self._monitors: List[threading.Thread] = []
        self._stop = threading.Event()
        self._server = RouteServer(port, name="shard-http")
        self._server.add_route("/fleet/metrics", self._fleet_metrics_route)
        self._server.add_route("/shards", self._shards_route)

    # ------------------------------------------------------------ partition
    def pools_of(self, shard_id: str) -> List[str]:
        """Shard *k*'s pool partition. The table behind this accessor
        is ring-derived; reaching into it with anything but a ring
        lookup is exactly what ccaudit's shard-bypass rule flags."""
        return list(self._partition.get(shard_id, []))

    def shard_of_pool(self, pool: str) -> str:
        return self.ring.owner_of(pool)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "ShardManager":
        self.informer.prime()
        self.informer.start()
        self._server.start()
        for host in self.hosts:
            host.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for host in self.hosts:
            host.stop()
        self.informer.stop()
        self._server.stop()
        for t in self._monitors:
            t.join(timeout=5)

    # ------------------------------------------------------------- failures
    def kill_host(self, index: int) -> dict:
        """Crash one host (no lease release — survivors must wait out
        staleness) and start a monitor that stamps how long full
        partition coverage took to restore. Returns the fault-log
        entry shape the simlab artifact carries."""
        host = self.hosts[index]
        orphaned = host.held_shards()
        host.crash()
        t0 = time.monotonic()
        entry = {
            "host": host.host_id,
            "orphaned_shards": orphaned,
            "handoff_s": None,
        }
        with self._lock:
            self._failovers.append(entry)

        def monitor() -> None:
            while not self._stop.is_set():
                if self._covered_shards() >= len(self.shard_ids):
                    handoff = time.monotonic() - t0
                    with self._lock:
                        entry["handoff_s"] = round(handoff, 4)
                    self.metrics.failovers_total.inc()
                    log.info(
                        "shard failover complete: %s's partition(s) %s "
                        "re-acquired in %.2fs", host.host_id, orphaned,
                        handoff,
                    )
                    return
                self._stop.wait(0.05)

        t = threading.Thread(target=monitor, daemon=True,
                             name=f"shard-failover-{index}")
        t.start()
        with self._lock:
            self._monitors.append(t)
        return {"host": host.host_id, "orphaned_shards": orphaned}

    def restart_host(self, index: int) -> dict:
        """Bring a crashed host back as a fresh standby (it does not
        preempt live holders; it competes normally from here on)."""
        old = self.hosts[index]
        if old.alive:
            return {"host": old.host_id, "restarted": False}
        host = ShardHost(self, index)
        self.hosts[index] = host
        host.start()
        return {"host": host.host_id, "restarted": True}

    # -------------------------------------------------------------- reading
    def _covered_shards(self) -> int:
        held: Set[str] = set()
        for host in self.hosts:
            if host.alive:
                held.update(host.covered_shards())
        return len(held)

    def coverage(self) -> Dict[str, Optional[str]]:
        """shard id -> live covering host id (lease held AND
        controllers running; None = uncovered)."""
        out: Dict[str, Optional[str]] = {
            sid: None for sid in self.shard_ids
        }
        for host in self.hosts:
            if not host.alive:
                continue
            for sid in host.covered_shards():
                out[sid] = host.host_id
        return out

    def bundles(self) -> List[ControllerShard]:
        out: List[ControllerShard] = []
        for host in self.hosts:
            if host.alive:
                out.extend(host.bundles())
        return out

    def wait_failovers(self, timeout_s: float = 30.0) -> bool:
        """Block until every recorded shard kill has its coverage-
        restored handoff stamped (the failover monitors finished).
        The fleet may converge before the control plane heals — the
        failover axis must wait for BOTH."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                pending = any(
                    f["handoff_s"] is None for f in self._failovers
                )
            if not pending:
                return True
            if self._stop.wait(0.05):
                return False
        with self._lock:
            return not any(
                f["handoff_s"] is None for f in self._failovers
            )

    def wait_covered(self, timeout_s: float = 30.0) -> bool:
        """Block until every partition is held by a live host (startup
        settling / post-failover convergence)."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._covered_shards() >= len(self.shard_ids):
                return True
            if self._stop.wait(0.05):
                return False
        return self._covered_shards() >= len(self.shard_ids)

    # ------------------------------------------------------- merged rollup
    def merged_fleet_metrics(self) -> str:
        """Every live shard's fleet exposition merged into ONE fleet
        view (fleetobs merge semantics: gauges/counters sum, histogram
        buckets union monotonically) plus this manager's own
        coverage/failover set. The aggregate is re-validated; an
        invalid merge is counted, never silently served as truth."""
        from tpu_cc_manager_torch import fleetobs

        self._refresh_gauges()
        snaps: List[Any] = []
        helps: Dict[str, str] = {}
        for bundle in self.bundles():
            text = bundle.metrics_text()
            if validate_exposition(text):
                self.metrics.merge_invalid_total.inc()
                continue
            snap, h = fleetobs.parse_exposition(text)
            helps.update(h)
            snaps.append(snap)
        merged = fleetobs.merge_snapshots(snaps)
        body = fleetobs.render_snapshot(merged, helps) if merged else ""
        out = body + self.metrics.render()
        if validate_exposition(out):
            self.metrics.merge_invalid_total.inc()
        return out

    def stats(self) -> dict:
        """The artifact/debug block: ring shape, live coverage, the
        failover log (handoff seconds per kill)."""
        self._refresh_gauges()
        with self._lock:
            failovers = [dict(f) for f in self._failovers]
        return {
            "region": self.region,
            "shards": len(self.shard_ids),
            "hosts": self.n_hosts,
            "hosts_live": sum(1 for h in self.hosts if h.alive),
            "partition": {
                sid: self.pools_of(sid) for sid in self.shard_ids
            },
            "coverage": self.coverage(),
            "failovers": failovers,
        }

    def _refresh_gauges(self) -> None:
        self.metrics.hosts_live.set(
            sum(1 for h in self.hosts if h.alive)
        )
        self.metrics.partitions_covered.set(self._covered_shards())

    # --------------------------------------------------------------- routes
    def _fleet_metrics_route(self) -> Tuple[int, bytes, str]:
        return (200, self.merged_fleet_metrics().encode(),
                "text/plain; version=0.0.4")

    def _shards_route(self) -> Tuple[int, bytes, str]:
        body = json.dumps(self.stats(), indent=2, sort_keys=True).encode()
        return 200, body, "application/json"

    @property
    def port(self) -> int:
        return self._server.port
