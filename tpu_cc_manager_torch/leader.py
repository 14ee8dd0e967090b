"""Lease-based leader election for the cluster-side controllers
(VERDICT r3 missing #3).

The policy and fleet controllers used to be single-replica Deployments
with no election: two replicas (a rolling update, an operator scaling
up for availability) would double-scan, fight over status writes, and
— worst — both pass the rollout layer's concurrent-record guard in the
same window and launch two fresh records on different anchor nodes.
The reference's ecosystem gets this for free from client-go's
leaderelection package (vendor/k8s.io/client-go in the reference
tree); this is the same algorithm on a ``coordination.k8s.io/v1``
Lease, sized down:

- One Lease object per controller (``tpu-cc-policy-controller`` /
  ``tpu-cc-fleet-controller``) in the operator namespace.
- The holder renews ``renewTime`` every ``renew_period_s``; replicas
  observe it. A candidate takes over only after the OBSERVED renewTime
  has sat unchanged for ``lease_duration_s`` on the candidate's own
  monotonic clock — never by comparing the holder's wall-clock stamp
  against the local clock (the same observed-staleness rule the
  rollout record's heartbeat fencing uses, rollout.py).
- Every acquire/renew is an optimistic-concurrency PUT on the Lease's
  ``resourceVersion``: of N racing candidates exactly one replace
  lands; the rest see 409 and go back to observing.
- A leader that cannot renew within its own lease duration must assume
  a peer has taken over and STOP leading (demote first, keep retrying
  as a candidate) — acting while unable to prove leadership is exactly
  the double-writer scenario election exists to prevent.

Controllers gate their scan loops on ``is_leader``; standbys stay hot
(HTTP surface up, /healthz ok, reporting "standby") so failover is one
lease duration, not one pod schedule.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from tpu_cc_manager_torch.k8s.client import ApiException, ConflictError, KubeClient

log = logging.getLogger("tpu-cc-manager.leader")

LEASE_DURATION_S = 15.0
RENEW_PERIOD_S = 5.0
RETRY_PERIOD_S = 2.0


def _now_rfc3339() -> str:
    # MicroTime, the Lease spec's stamp format
    t = time.time()
    base = time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(t))
    return f"{base}.{int((t % 1) * 1e6):06d}Z"


class LeaderElector:
    """Acquire/renew/release loop for one Lease. Thread-owned: call
    :meth:`start`, check :attr:`is_leader`, call :meth:`stop` (which
    releases the lease so a peer can take over immediately)."""

    def __init__(
        self,
        kube: KubeClient,
        *,
        name: str,
        identity: str,
        namespace: str = "tpu-system",
        lease_duration_s: float = LEASE_DURATION_S,
        renew_period_s: float = RENEW_PERIOD_S,
        retry_period_s: float = RETRY_PERIOD_S,
        initial_delay_s: float = 0.0,
        on_started_leading: Optional[Callable[[], None]] = None,
        on_stopped_leading: Optional[Callable[[], None]] = None,
    ):
        if lease_duration_s <= renew_period_s:
            raise ValueError(
                "lease_duration_s must exceed renew_period_s "
                f"({lease_duration_s} <= {renew_period_s}): a holder "
                "must get several renew attempts per lease lifetime"
            )
        self.kube = kube
        self.name = name
        self.identity = identity
        self.namespace = namespace
        self.lease_duration_s = lease_duration_s
        self.renew_period_s = renew_period_s
        self.retry_period_s = retry_period_s
        #: handicap before the FIRST election attempt: a standby
        #: candidate (shard.py's non-preferred hosts) yields the
        #: initial create race to the preferred owner, then competes
        #: normally — takeover still requires observed staleness, so
        #: the delay only shapes placement, never safety
        self.initial_delay_s = initial_delay_s
        self.on_started_leading = on_started_leading
        self.on_stopped_leading = on_stopped_leading
        self._is_leader = False
        #: monotonic stamp of the last demotion — observers judging
        #: "did work happen while not leading?" must grant the
        #: deposition window (a leader learns of its deposition at its
        #: next failed renew; work started just before is legitimate)
        self.deposed_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        #: observed (renewTime value, monotonic first seen unchanged) of
        #: the CURRENT holder — staleness is judged on our clock only
        self._observed: Optional[tuple] = None
        #: monotonic stamp of OUR last successful renew, for the
        #: must-demote-when-unrenewable rule
        self._last_renew_ok = 0.0

    # ------------------------------------------------------------ state
    @property
    def is_leader(self) -> bool:
        return self._is_leader

    def _set_leader(self, value: bool) -> None:
        if value and not self._is_leader:
            log.info("%s: became leader (%s)", self.name, self.identity)
            self._is_leader = True
            if self.on_started_leading:
                self.on_started_leading()
        elif not value and self._is_leader:
            log.warning("%s: lost leadership (%s)", self.name,
                        self.identity)
            self._is_leader = False
            self.deposed_at = time.monotonic()
            if self.on_stopped_leading:
                self.on_stopped_leading()

    # ------------------------------------------------------------- core
    def _lease_body(self, cur: Optional[dict]) -> dict:
        spec = {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration_s),
            "renewTime": _now_rfc3339(),
        }
        if cur is None:
            spec["acquireTime"] = spec["renewTime"]
            spec["leaseTransitions"] = 0
            return {
                "apiVersion": "coordination.k8s.io/v1",
                "kind": "Lease",
                "metadata": {"name": self.name,
                             "namespace": self.namespace},
                "spec": spec,
            }
        prev = cur.get("spec") or {}
        if prev.get("holderIdentity") == self.identity:
            spec["acquireTime"] = prev.get("acquireTime",
                                           spec["renewTime"])
            spec["leaseTransitions"] = prev.get("leaseTransitions", 0)
        else:
            spec["acquireTime"] = spec["renewTime"]
            spec["leaseTransitions"] = prev.get("leaseTransitions", 0) + 1
        out = dict(cur)
        out["spec"] = spec
        return out

    def try_acquire_or_renew(self) -> bool:
        """One election step. Returns the resulting leadership."""
        try:
            cur = self.kube.get_lease(self.namespace, self.name)
        except ApiException as e:
            if e.status != 404:
                raise
            try:
                self.kube.create_lease(
                    self.namespace, self._lease_body(None)
                )
                self._last_renew_ok = time.monotonic()
                return True
            except ConflictError:
                return False  # lost the create race; observe next tick
            except ApiException as ce:
                if ce.status == 409:
                    return False
                raise
        holder = (cur.get("spec") or {}).get("holderIdentity")
        if holder == self.identity:
            # our lease: renew via CAS. A 409 means a peer judged us
            # dead and took over — believe it.
            try:
                self.kube.replace_lease(
                    self.namespace, self.name, self._lease_body(cur)
                )
                self._last_renew_ok = time.monotonic()
                return True
            except ConflictError:
                return False
        if not holder:
            # explicitly released (clean shutdown): claim immediately —
            # the CAS still arbitrates racing claimants
            try:
                self.kube.replace_lease(
                    self.namespace, self.name, self._lease_body(cur)
                )
                self._last_renew_ok = time.monotonic()
                self._observed = None
                return True
            except ConflictError:
                return False
        # someone else's: take over only once its renewTime has sat
        # unchanged for a full lease duration ON OUR CLOCK
        renew = (cur.get("spec") or {}).get("renewTime")
        now = time.monotonic()
        if self._observed is None or self._observed[0] != renew:
            self._observed = (renew, now)
            return False
        if now - self._observed[1] < self.lease_duration_s:
            return False
        try:
            self.kube.replace_lease(
                self.namespace, self.name, self._lease_body(cur)
            )
            self._last_renew_ok = time.monotonic()
            self._observed = None
            log.info(
                "%s: took over lease from stale holder %r",
                self.name, holder,
            )
            return True
        except ConflictError:
            self._observed = None  # somebody else moved; re-observe
            return False

    def _loop(self) -> None:
        if self.initial_delay_s > 0:
            self._stop.wait(self.initial_delay_s)
        while not self._stop.is_set():
            try:
                leading = self.try_acquire_or_renew()
            except Exception as e:
                log.warning("%s: election step failed: %s", self.name, e)
                leading = self._is_leader and (
                    time.monotonic() - self._last_renew_ok
                    < self.lease_duration_s
                )
            if self._is_leader and not leading:
                # cannot prove leadership anymore: demote BEFORE a peer
                # could have taken over and started writing
                self._set_leader(False)
            elif leading:
                self._set_leader(True)
            self._stop.wait(
                self.renew_period_s if leading else self.retry_period_s
            )

    # --------------------------------------------------------- lifecycle
    def start(self) -> "LeaderElector":
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name=f"leader-elector-{self.name}",
        )
        self._thread.start()
        return self

    def abandon(self) -> None:
        """Stop electing WITHOUT releasing the lease — the crash
        simulation (shard-kill drills): the holder just vanishes, so a
        peer takes over only after observing a full lease duration of
        staleness, exactly like a real process death. Fires
        ``on_stopped_leading`` (a crashing shard host must still tear
        its controllers down in-process)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        self._set_leader(False)

    def stop(self) -> None:
        """Stop electing; if leading, release the lease (zero the
        holder) so a standby takes over immediately instead of waiting
        out the full lease duration."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        if not self._is_leader:
            return
        self._set_leader(False)
        try:
            cur = self.kube.get_lease(self.namespace, self.name)
            if (cur.get("spec") or {}).get("holderIdentity") \
                    == self.identity:
                released = dict(cur)
                released["spec"] = dict(cur["spec"],
                                        holderIdentity="",
                                        renewTime=None)
                self.kube.replace_lease(self.namespace, self.name,
                                        released)
                log.info("%s: released lease", self.name)
        except (ApiException, ConflictError) as e:
            log.warning("%s: lease release failed: %s", self.name, e)
