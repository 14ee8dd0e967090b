"""Multi-region federation: N API servers, one fleet (ISSUE 16).

Everything through PR 15 — sharded controllers, the async kube core,
reactive rollout, the incident pipeline — converges one pool behind ONE
API server. Production CC fleets span regions with independent control
planes, asymmetric latency, and separate attestation trust domains.
This module is the federation layer ROADMAP item 2 names:

- **One region-affine ring** (:class:`~tpu_cc_manager.shard.HashRing`
  with ``regions=`` tags): federation members are ``<region>/shard-<k>``
  and every pool's owner is resolved with the home region pinned, so
  controller shards place onto their home region's API server while the
  single hashing scheme keeps placement deterministic across every
  host. :meth:`FederationManager.owner_of` is the ONE sanctioned
  region-aware lookup — ccaudit's ``region-bypass`` rule flags
  partition access that skips it, exactly like shard-bypass.
- **One posture, per-region windows** (:class:`FleetPosture` /
  :func:`posture_from_policy`): a single policy CR expresses the
  desired fleet mode plus ``spec.regionWindows`` — per-region rollout
  offsets. Each region's desired-state write goes through its OWN API
  server inside its own ``desired_write`` trace span (the rollout
  engine's exact patch shape via
  :func:`~tpu_cc_manager.rollout.desired_patch_body`), and the rollout
  judge reads ONLY that region's informer cache: zero cross-region
  steady-state node reads, pinned against FakeKube's
  ``node_read_requests`` counter per region.
- **Region evacuation as a first-class flow** (:meth:`evacuate`):
  the evacuated region's pending posture writes park, its nodes are
  cordoned (``spec.unschedulable``) through its own API server, and
  every OTHER region's still-waiting window collapses to NOW — region
  B absorbs while region A drains, including the evac-races-upgrade
  interleaving simlab's ``federation-*`` scenarios drive.
- **Per-region attestation trust roots** (:class:`RegionTrustDomain`):
  each region's fleet controllers judge quotes under an EXPLICIT key
  posture (never the process-global env), so a revoked root in region
  A drops region A to 'unverifiable' and latches ``attestation_outage``
  there — region B's verified count is untouched (invariant
  ``region_attestation_latch``).

docs/federation.md states the full contract.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.k8s.client import ApiException
from tpu_cc_manager_torch.rollout import desired_patch_body
from tpu_cc_manager_torch.shard import DEFAULT_VNODES, HashRing, ShardManager
from tpu_cc_manager_torch.trace import format_traceparent, get_tracer

log = logging.getLogger("tpu-cc-manager.federation")

#: federation ring member id for shard k of a region
MEMBER_FMT = "{region}/shard-{index}"


class FederationError(Exception):
    pass


class RegionTrustDomain:
    """One region's attestation verifier posture: an explicit, mutable
    key tuple — NEVER the process-global env (``tpm_keys``), which
    cannot express two regions trusting different roots in one process.

    ``keys()`` is handed to each region's fleet controllers as their
    ``attest_key`` callable, resolved per scan, so :meth:`rotate` and
    :meth:`revoke` take effect on the next tick without rebuilding
    anything. A revoked domain returns the EMPTY tuple — the explicitly
    keyless posture under which every quote judges 'unverifiable' and
    the region's attestation_outage latch fires; ``None`` (fall back to
    env) is deliberately unreachable from here."""

    def __init__(self, region: str, keys: Sequence[bytes] = ()) -> None:
        self.region = region
        self._lock = threading.Lock()
        self._keys: Tuple[bytes, ...] = tuple(keys)
        self._revoked = False

    def keys(self) -> Tuple[bytes, ...]:
        with self._lock:
            return () if self._revoked else self._keys

    def rotate(self, new_key: bytes) -> None:
        """New primary, old keys kept as the rotation tail (attest.py's
        still-old-quotes-must-verify rule)."""
        with self._lock:
            self._keys = (new_key,) + self._keys

    def revoke(self) -> None:
        """Drop THIS region's trust wholesale (compromised root). Other
        regions' domains are separate objects — nothing spills."""
        with self._lock:
            self._revoked = True

    def restore(self) -> None:
        with self._lock:
            self._revoked = False

    @property
    def revoked(self) -> bool:
        with self._lock:
            return self._revoked


@dataclasses.dataclass
class RegionSpec:
    """One region's wiring: its API server (client factory), its pool
    partition of the fleet, and its attestation trust domain (None =
    the process-global env posture — single-region compatibility)."""

    name: str
    client_factory: Callable[[], Any]
    pools: Sequence[str]
    trust_domain: Optional[RegionTrustDomain] = None


@dataclasses.dataclass
class FleetPosture:
    """ONE desired fleet posture: the mode every region converges to,
    with per-region window offsets (seconds from :meth:`apply_posture`;
    absent region = opens immediately). ``source`` names the policy CR
    it came from, for the artifact."""

    mode: str
    windows: Dict[str, float] = dataclasses.field(default_factory=dict)
    source: Optional[str] = None


def posture_from_policy(policy: dict) -> FleetPosture:
    """A cross-region policy CR -> FleetPosture: ``spec.mode`` plus
    ``spec.regionWindows`` (policy.parse_policy_spec validates both;
    PolicySpecError propagates — one bad CR must surface, not
    half-apply)."""
    from tpu_cc_manager_torch.policy import parse_policy_spec

    spec = parse_policy_spec(policy)
    return FleetPosture(
        mode=spec["mode"],
        windows=dict(spec["region_windows"]),
        source=(policy.get("metadata") or {}).get("name"),
    )


class RegionRingView:
    """A region-scoped facade over the ONE federation ring: every
    lookup resolves with the home region pinned, so a region's
    ShardManager partitions its pools exactly where
    :meth:`FederationManager.owner_of` says they live — one hashing
    scheme, no second source of placement truth."""

    def __init__(self, ring: HashRing, region: str) -> None:
        self.ring = ring
        self.region = region
        self.members = tuple(ring.members_in(region))
        if not self.members:
            raise FederationError(
                f"region {region!r} has no ring members"
            )
        self.vnodes = ring.vnodes

    def owner_of(self, key: str, region: Optional[str] = None) -> str:
        return self.ring.owner_of(key, region=self.region)

    def partition(
        self, keys: Sequence[str],
        region_of: Optional[Callable[[str], Optional[str]]] = None,
    ) -> Dict[str, List[str]]:
        out: Dict[str, List[str]] = {m: [] for m in self.members}
        for key in keys:
            out[self.owner_of(key)].append(key)
        for v in out.values():
            v.sort()
        return out


class FederationManager:
    """N regions, each its own API server + per-region ShardManager
    (own informer, own trust domain), one federation-wide region-affine
    ring, one posture."""

    def __init__(
        self,
        regions: Sequence[RegionSpec],
        *,
        pool_label: str,
        shards_per_region: int = 1,
        hosts_per_region: Optional[int] = None,
        selector: str = L.TPU_ACCELERATOR_LABEL,
        policy: bool = False,
        fleet_interval_s: float = 1.0,
        lease_duration_s: float = 2.0,
        renew_period_s: float = 0.5,
        retry_period_s: float = 0.25,
        vnodes: int = DEFAULT_VNODES,
    ) -> None:
        if not regions:
            raise FederationError("a federation needs at least one region")
        names = [r.name for r in regions]
        if len(set(names)) != len(names):
            raise FederationError(f"duplicate region names: {sorted(names)}")
        if shards_per_region < 1:
            raise FederationError(
                f"shards_per_region must be >= 1, got {shards_per_region}"
            )
        self.specs: Dict[str, RegionSpec] = {r.name: r for r in regions}
        self.pool_label = pool_label
        self.selector = selector
        #: pool -> home region. The table is spec-derived; read it ONLY
        #: through region_of_pool / owner_of — ccaudit's region-bypass
        #: rule flags anything else, mirroring shard.py's partition rule
        self._pool_region: Dict[str, str] = {}
        for r in regions:
            for pool in r.pools:
                if pool in self._pool_region:
                    raise FederationError(
                        f"pool {pool!r} claimed by both "
                        f"{self._pool_region[pool]!r} and {r.name!r}"  # ccaudit: allow-region-bypass(constructor builds the table from the spec; duplicate-claim error names the prior owner)
                    )
                self._pool_region[pool] = r.name  # ccaudit: allow-region-bypass(constructor builds the table from the spec — the one sanctioned write site)
        members: List[str] = []
        tags: Dict[str, str] = {}
        for r in regions:
            for k in range(shards_per_region):
                m = MEMBER_FMT.format(region=r.name, index=k)
                members.append(m)
                tags[m] = r.name
        #: THE federation ring: every region's manager sees it through
        #: a RegionRingView, so placement is one deterministic scheme
        self.ring = HashRing(members, vnodes=vnodes, regions=tags)
        self.managers: Dict[str, ShardManager] = {}
        for r in regions:
            domain = r.trust_domain
            self.managers[r.name] = ShardManager(
                r.client_factory,
                shard_ids=self.ring.members_in(r.name),
                ring=RegionRingView(self.ring, r.name),
                pools=list(r.pools),
                pool_label=pool_label,
                hosts=hosts_per_region,
                selector=selector,
                policy=policy,
                fleet_interval_s=fleet_interval_s,
                lease_duration_s=lease_duration_s,
                renew_period_s=renew_period_s,
                retry_period_s=retry_period_s,
                port=0,
                attest_key=(domain.keys if domain is not None else None),
                region=r.name,
            )
        #: per-region write clients (posture patches, cordons): every
        #: region's writes go through ITS API server, never a sibling's
        self._clients: Dict[str, Any] = {
            r.name: r.client_factory() for r in regions
        }
        self._lock = threading.Lock()
        self._posture: Optional[FleetPosture] = None
        self._generation = 0
        self._evacuated: Set[str] = set()
        self._partitioned: Set[str] = set()
        self._evacuations: List[dict] = []
        #: set by evacuate(): every still-waiting region window
        #: collapses to NOW (absorb). Re-created per posture.
        self._absorb = threading.Event()
        self._stop = threading.Event()
        self._workers: List[threading.Thread] = []
        self._started = False

    # ------------------------------------------------------------ placement
    def region_of_pool(self, pool: str) -> str:
        """A pool's home region — the spec-derived half of the one
        sanctioned lookup."""
        region = self._pool_region.get(pool)
        if region is None:
            raise FederationError(f"pool {pool!r} belongs to no region")
        return region

    def owner_of(self, pool: str) -> Tuple[str, str]:
        """THE region-aware owner lookup: (home region, owning ring
        member). Controller shards place onto their home region's API
        server because the ring walk is pinned to that region; the
        global fallback fires only when the whole region is absent."""
        region = self.region_of_pool(pool)
        return region, self.ring.owner_of(pool, region=region)

    def pools_in_region(self, region: str) -> List[str]:
        if region not in self.specs:
            raise FederationError(f"unknown region {region!r}")
        return sorted(list(self.specs[region].pools))

    @property
    def regions(self) -> List[str]:
        return sorted(self.specs)

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "FederationManager":
        for name in sorted(self.managers):
            self.managers[name].start()
        self._started = True
        return self

    def stop(self) -> None:
        self._stop.set()
        self._absorb.set()  # wake any window still waiting
        for t in self._workers:
            t.join(timeout=5)
        for m in self.managers.values():
            m.stop()

    def wait_covered(self, timeout_s: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_s
        for m in self.managers.values():
            remaining = max(0.0, deadline - time.monotonic())
            if not m.wait_covered(timeout_s=remaining):
                return False
        return True

    # -------------------------------------------------------------- posture
    def apply_posture(self, posture: FleetPosture) -> None:
        """Launch ONE fleet posture: a window worker per region waits
        its offset (or until an evacuation elsewhere collapses it to
        now), then writes the desired label + trace annotation to every
        node of that region's pools THROUGH that region's API server.
        A partitioned region's write defers, retrying until the
        partition heals; an evacuated region's write parks forever."""
        with self._lock:
            self._posture = posture
            self._generation += 1
            gen = self._generation
            self._absorb = threading.Event()
            absorb = self._absorb
        log.info("posture %r (source=%s) windows=%s",
                 posture.mode, posture.source, posture.windows)
        for region in self.regions:
            t = threading.Thread(
                target=self._region_window_worker,
                args=(region, posture, gen, absorb),
                daemon=True,
                name=f"fed-window-{region}",
            )
            t.start()
            self._workers.append(t)

    def _region_window_worker(
        self, region: str, posture: FleetPosture, gen: int,
        absorb: threading.Event,
    ) -> None:
        offset = float(posture.windows.get(region, 0.0))
        if offset > 0:
            # the absorb event is the ONLY early exit: an evacuation
            # elsewhere means this region opens NOW to take the load
            absorb.wait(timeout=offset)
        while not self._stop.is_set():
            with self._lock:
                if gen != self._generation:
                    return  # superseded by a newer posture
                if region in self._evacuated:
                    log.info("region %s: posture %r parked (evacuated)",
                             region, posture.mode)
                    return
            try:
                self._write_region_desired(region, posture.mode)
                return
            except ApiException as e:
                # partition / blackout: desired state DEFERS — the
                # write lands when the region heals, never half-lands
                log.warning("region %s: posture write deferred: %s",
                            region, e)
                if self._stop.wait(0.2):
                    return

    def _write_region_desired(self, region: str, mode: str) -> None:
        names = self._region_node_names(region)
        # ONE desired_write span per region per posture: its
        # traceparent rides the cc.trace annotation in the SAME patch
        # as the desired label (rollout._launch's contract), so the
        # cross-region e2e convergence axis stitches every region's
        # desired-write -> state-publish story from trace ids alone
        with get_tracer().span(
            "desired_write", group=f"region-{region}", mode=mode,
            nodes=len(names),
        ) as span:
            context = format_traceparent(span)
            client = self._clients[region]
            for name in names:
                client.patch_node(name, desired_patch_body(mode, context))
        log.info("region %s: desired %r written to %d nodes",
                 region, mode, len(names))

    def _region_node_names(self, region: str) -> List[str]:
        """The region's pool nodes, read from the region's OWN informer
        cache (a warm informer list is zero API round trips — and by
        construction never a cross-region read)."""
        manager = self.managers[region]
        pools = frozenset(self.specs[region].pools)
        pool_label = self.pool_label
        cached = manager.informer.client(
            self._clients[region],
            node_filter=lambda n: ((n.get("metadata") or {})
                                   .get("labels") or {})
            .get(pool_label) in pools,
        )
        nodes = cached.list_nodes(self.selector)
        return sorted(
            (n.get("metadata") or {}).get("name", "") for n in nodes
        )

    # ------------------------------------------------------------- judging
    def region_converged(self, region: str, mode: str) -> bool:
        """The per-region rollout judge: every pool node's state label
        equals ``mode``, read from THAT region's informer cache only —
        the zero-cross-region-reads contract the federation tests pin
        against each FakeKube's node_read_requests counter."""
        manager = self.managers[region]
        pools = frozenset(self.specs[region].pools)
        nodes = manager.informer.client(self._clients[region]).list_nodes(
            self.selector
        )
        saw = 0
        for n in nodes:
            labels = (n.get("metadata") or {}).get("labels") or {}
            if labels.get(self.pool_label) not in pools:
                continue
            saw += 1
            if labels.get(L.CC_MODE_STATE_LABEL) != mode:
                return False
        return saw > 0

    def region_cordoned(self, region: str) -> bool:
        """Evacuation's success check: every pool node in the region is
        unschedulable (again purely from the region's informer cache)."""
        manager = self.managers[region]
        pools = frozenset(self.specs[region].pools)
        nodes = manager.informer.client(self._clients[region]).list_nodes(
            self.selector
        )
        saw = 0
        for n in nodes:
            labels = (n.get("metadata") or {}).get("labels") or {}
            if labels.get(self.pool_label) not in pools:
                continue
            saw += 1
            if not (n.get("spec") or {}).get("unschedulable"):
                return False
        return saw > 0

    def wait_posture(self, timeout_s: float = 60.0) -> bool:
        """Block until the active posture holds fleet-wide: every
        non-evacuated region converged to its mode, every evacuated
        region fully cordoned."""
        with self._lock:
            posture = self._posture
        if posture is None:
            raise FederationError("no posture applied")
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self._posture_holds(posture.mode):
                return True
            if self._stop.wait(0.05):
                return False
        return self._posture_holds(posture.mode)

    def _posture_holds(self, mode: str) -> bool:
        with self._lock:
            evacuated = set(self._evacuated)
        for region in self.regions:
            if region in evacuated:
                if not self.region_cordoned(region):
                    return False
            elif not self.region_converged(region, mode):
                return False
        return True

    # ---------------------------------------------------------- evacuation
    def evacuate(self, region: str) -> dict:
        """Drain one region while the others absorb: park the region's
        posture writes, collapse every OTHER region's still-waiting
        window to NOW, and cordon the region's nodes through its own
        API server (retrying through faults — evacuation is exactly
        the flow that races partitions and upgrades). Returns the
        fault-log entry the simlab artifact carries."""
        if region not in self.specs:
            raise FederationError(f"unknown region {region!r}")
        t0 = time.monotonic()
        with self._lock:
            already = region in self._evacuated
            self._evacuated.add(region)
            absorb = self._absorb
            entry = {
                "region": region,
                "already_evacuated": already,
                "cordoned": 0,
                "cordon_s": None,
            }
            self._evacuations.append(entry)
        absorb.set()
        t = threading.Thread(
            target=self._cordon_region, args=(region, entry, t0),
            daemon=True, name=f"fed-evac-{region}",
        )
        t.start()
        self._workers.append(t)
        log.warning("region %s: evacuation started (others absorb)",
                    region)
        return dict(entry)

    def _cordon_region(self, region: str, entry: dict, t0: float) -> None:
        from tpu_cc_manager_torch.watch import jittered_backoff

        client = self._clients[region]
        pending = self._region_node_names(region)
        done = 0
        rounds = 0
        while pending and not self._stop.is_set():
            still: List[str] = []
            for name in pending:
                try:
                    client.patch_node(
                        name, {"spec": {"unschedulable": True}}
                    )
                    done += 1
                except ApiException:
                    still.append(name)
            pending = still
            # nodes that failed this round retry on a growing jittered
            # pause: a partitioned region's API server comes back to a
            # paced trickle, not a per-200ms full-region patch storm
            rounds += 1
            if pending and self._stop.wait(
                jittered_backoff(0.2, rounds, cap_s=5.0)
            ):
                break
        with self._lock:
            entry["cordoned"] = done
            entry["cordon_s"] = round(time.monotonic() - t0, 4)
        log.info("region %s: %d nodes cordoned in %.2fs",
                 region, done, entry["cordon_s"])

    # ----------------------------------------------------------- partitions
    def set_partitioned(self, region: str, partitioned: bool) -> None:
        """Bookkeeping hook for the fault injector (the real deferral
        is the ApiException retry loop in the window worker — this just
        makes the artifact's stats truthful about WHY a write waited)."""
        with self._lock:
            if partitioned:
                self._partitioned.add(region)
            else:
                self._partitioned.discard(region)

    # -------------------------------------------------------------- reading
    def attestation_summary(self) -> Dict[str, dict]:
        """Per-region attestation posture for the artifact: revocation
        state plus each region's latest fleet-scan attestation audit
        (merged over the region's shard bundles)."""
        out: Dict[str, dict] = {}
        for region in self.regions:
            domain = self.specs[region].trust_domain
            verified = 0
            outage: List[str] = []
            seen = False
            for bundle in self.managers[region].bundles():
                report = bundle.fleet.last_report or {}
                audit = report.get("evidence_audit") or {}
                if audit.get("attestation_seen"):
                    seen = True
                verified += audit.get("attestation_verified", 0)
                outage.extend(audit.get("attestation_outage", []))
            out[region] = {
                "revoked": (domain.revoked if domain is not None
                            else False),
                "attestation_seen": seen,
                "attestation_verified": verified,
                "attestation_outage": sorted(set(outage)),
            }
        return out

    def stats(self) -> dict:
        with self._lock:
            posture = self._posture
            evacuated = sorted(self._evacuated)
            partitioned = sorted(self._partitioned)
            evacuations = [dict(e) for e in self._evacuations]
        return {
            "regions": self.regions,
            "ring_members": list(self.ring.members),
            "posture": (
                None if posture is None else {
                    "mode": posture.mode,
                    "windows": dict(posture.windows),
                    "source": posture.source,
                }
            ),
            "evacuated": evacuated,
            "partitioned": partitioned,
            "evacuations": evacuations,
            "managers": {
                region: self.managers[region].stats()
                for region in self.regions
            },
        }
