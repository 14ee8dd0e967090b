"""Slice-coherent mode flips — the capability the reference never needed.

A multi-host TPU slice (e.g. v5p-128 = 16 hosts) is one ICI/attestation
domain: flipping CC mode on some member nodes but not others would leave
the slice half-protected, which is worse than either uniform state. The
reference's agents are fully node-independent (SURVEY.md §2.3); this
module adds the per-slice choreography SURVEY.md §7.2 step 7 calls for,
using only the coordination fabric the architecture already has — the
Kubernetes API server — so no new communication backend is introduced.

Protocol (all state in node labels/annotations, so it survives agent
restarts and is kubectl-observable):

- **Membership**: nodes of one slice share ``tpu.google.com/cc.slice``
  (set by the provisioner / GKE node-pool labels).
- **Liveness**: each agent heartbeats ``cc.slice.hb=<unix-ts>`` on its own
  node. A member is *alive* if its heartbeat is fresher than HB_TTL_S.
- **Leadership**: the alive member with the lexicographically smallest
  node name is the leader. Deterministic — every member computes the same
  answer from the same node list; no election messages. If the leader
  dies its heartbeat stales out and the next member takes over.
- **Commit fencing (CAS)**: commits live on the *anchor* node — the
  lexicographically smallest member of the slice, alive or not (the node
  *object* always exists even when its agent is down). The leader writes
  the commit with ``replace_node`` preconditioned on the anchor's
  resourceVersion (Kubernetes optimistic concurrency, the mechanism
  client-go's leader-election leases use). Two members that both believe
  they are leader during a heartbeat-staleness window therefore race a
  compare-and-swap on one object: exactly one write per epoch wins, the
  loser gets 409 Conflict, re-reads, and finds the round already
  committed. Members always *read* commits from the anchor, so divergent
  leaders can never produce divergent observed commits. The winning
  leader also records ``cc.slice.leader=<name>`` and
  ``cc.slice.epoch=<epoch>`` on the anchor for auditability.
- **Epochs**: rounds are ordered by the cluster's resourceVersion, which
  is globally monotone (etcd revision). The leader stamps each commit
  with the highest member rv it observed; members remember the epoch of
  the last commit they consumed (``cc.slice.done=<mode>:<epoch>``, on
  their own node, durable across restarts). A commit is actionable only
  if its epoch is *strictly greater* than the member's done epoch —
  stale commits left over from old rounds (e.g. on a node that lost and
  later regained leadership) can never trigger a flip.
- **Two-phase flip**:

  1. every member publishes ``cc.slice.ack=<mode>`` on its own node
     ("I see the new desired mode and am ready to flip");
  2. the leader, once ALL alive members ack the same mode and not all of
     them have already completed it, publishes
     ``cc.slice.commit=<mode>:<epoch>`` on the anchor node via CAS;
  3. members flip locally only after observing a commit whose mode
     equals the mode they acked and whose epoch is newer than their done
     epoch; then they record ``cc.slice.done``.

  A member that aborts (timeout, shutdown, API errors) **retracts its
  ack** so the leader stops counting it. The retraction is best-effort:
  if the leader read the ack in the same instant, the rest of the slice
  may proceed while the aborted member reports ``cc.mode.state=failed``
  — a visibly mixed slice (the fleet planner's ``half_flipped_slices``
  audit catches exactly this), never a silently mixed one. Full
  atomicity under arbitrary timing is the two-generals problem; the
  protocol guarantees no member *flips* without a quorum commit, and
  every divergence is published. Divergences also *heal*: the agent's
  self-repair loop (CCManagerAgent._maybe_repair) retries the failed
  reconcile, and because the quorum commit on the anchor stays
  actionable until the laggard records ``done``, the retry converges the
  slice without a new quorum round or any operator relabeling.

Divergent per-slice policies (BASELINE config 5) fall out naturally:
coordination is scoped to one slice id, so two slices of one pool can
hold different modes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.k8s.client import ApiException, ConflictError, KubeClient
from tpu_cc_manager_torch.trace import Tracer, get_tracer

log = logging.getLogger("tpu-cc-manager.slice")

#: Heartbeat refresh period and liveness TTL.
HB_PERIOD_S = 10.0
HB_TTL_S = 45.0
#: How long a member waits for the slice to agree before giving up.
COMMIT_TIMEOUT_S = 600.0
POLL_S = 1.0

# local aliases: the protocol strings live in labels.py with the rest of
# the cluster-visible surface (ccaudit's label-literal rule enforces it)
HB_ANNOTATION = L.SLICE_HB_ANNOTATION
DONE_ANNOTATION = L.SLICE_DONE_ANNOTATION


class SliceAbortError(Exception):
    """The slice round did not reach a commit; the local flip was NOT
    attempted. The agent publishes the failed state and keeps serving —
    except when ``shutting_down`` is set (an artifact of agent
    termination) or ``superseded`` is set (the operator changed the
    desired mode mid-round; the NEW mode is about to reconcile), in
    which cases no failure is published."""

    def __init__(self, msg: str, *, shutting_down: bool = False,
                 superseded: bool = False):
        super().__init__(msg)
        self.shutting_down = shutting_down
        self.superseded = superseded


def _parse_stamp(raw: Optional[str]) -> Tuple[Optional[str], int]:
    """'mode:epoch' -> (mode, epoch); absent/garbage -> (None, -1)."""
    if not raw or ":" not in raw:
        return None, -1
    mode, _, epoch = raw.rpartition(":")
    try:
        return mode, int(epoch)
    except ValueError:
        return None, -1


class SliceCoordinator:
    def __init__(
        self,
        kube: KubeClient,
        node_name: str,
        *,
        hb_period_s: float = HB_PERIOD_S,
        hb_ttl_s: float = HB_TTL_S,
        commit_timeout_s: Optional[float] = None,
        poll_s: float = POLL_S,
        clock=time.time,
        tracer: Optional[Tracer] = None,
        should_abort=None,
    ):
        self.kube = kube
        self.node_name = node_name
        self.tracer = tracer or get_tracer()
        self.hb_period_s = hb_period_s
        self.hb_ttl_s = hb_ttl_s
        # env parsing/validation lives in config.py
        # (TPU_CC_SLICE_COMMIT_TIMEOUT_S -> cfg.slice_commit_timeout_s,
        # threaded in by __main__) — None here just means the default
        self.commit_timeout_s = (
            COMMIT_TIMEOUT_S if commit_timeout_s is None
            else commit_timeout_s
        )
        self.poll_s = poll_s
        self.clock = clock
        #: Optional callable polled during the commit wait with the
        #: in-flight mode: True means a newer desired mode has arrived
        #: that RESOLVES to a different mode, so this round is superseded
        #: (the agent wires it to a with_default-aware mailbox peek —
        #: a label flap that coalesces back to the same effective mode
        #: must not abort the round).
        self.should_abort = should_abort
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------- membership
    def slice_id(self) -> Optional[str]:
        node = self.kube.get_node(self.node_name)
        return node["metadata"].get("labels", {}).get(L.TPU_SLICE_LABEL)

    def members(self, slice_id: str) -> List[dict]:
        return sorted(
            self.kube.list_nodes(f"{L.TPU_SLICE_LABEL}={slice_id}"),
            key=lambda n: n["metadata"]["name"],
        )

    def _alive(self, nodes: List[dict]) -> List[dict]:
        now = self.clock()
        alive = []
        for n in nodes:
            raw = n["metadata"].get("annotations", {}).get(HB_ANNOTATION)
            try:
                fresh = raw is not None and now - float(raw) <= self.hb_ttl_s
            except ValueError:
                fresh = False
            # our own row is alive by definition (we're executing)
            if fresh or n["metadata"]["name"] == self.node_name:
                alive.append(n)
        return alive

    # ----------------------------------------------------------- heartbeat
    def heartbeat_once(self) -> None:
        self.kube.set_node_annotations(
            self.node_name, {HB_ANNOTATION: str(self.clock())}
        )

    def start(self) -> "SliceCoordinator":
        """Run the background heartbeat (agent lifetime)."""

        def loop():
            while not self._stop.is_set():
                try:
                    self.heartbeat_once()
                except ApiException as e:
                    log.warning("slice heartbeat failed: %s", e)
                self._stop.wait(self.hb_period_s)

        self._hb_thread = threading.Thread(
            target=loop, name="slice-heartbeat", daemon=True
        )
        self._hb_thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._hb_thread:
            self._hb_thread.join(timeout=5)

    # ------------------------------------------------------------ protocol
    def _annotate_self(self, key: str, value: Optional[str]) -> None:
        self.kube.set_node_annotations(self.node_name, {key: value})

    @staticmethod
    def _ann(node: dict, key: str) -> Optional[str]:
        return node["metadata"].get("annotations", {}).get(key)

    def _retract_ack(self) -> None:
        try:
            self._annotate_self(L.SLICE_ACK_ANNOTATION, None)
        except ApiException as e:
            log.warning("could not retract slice ack: %s", e)

    def apply_slice_coherent(self, raw_mode: str, engine) -> bool:
        """Run the 2-phase protocol around ``engine.set_mode``.

        Falls back to a plain local flip when the node is not part of a
        multi-host slice. Raises SliceAbortError when the round never
        reached a commit (the local device state was not touched).
        """
        # validate BEFORE any ack is published: a typo'd mode must be
        # the instant InvalidModeError rejection every other path gives
        # (engine.set_mode would catch it, but only after this member
        # acked garbage to the slice and waited out the whole quorum
        # timeout on peers who will never ack it)
        from tpu_cc_manager_torch.modes import parse_mode

        parse_mode(raw_mode)
        slice_id = self.slice_id()
        if not slice_id:
            return engine.set_mode(raw_mode)
        members = self.members(slice_id)
        if len(members) <= 1:
            return engine.set_mode(raw_mode)

        log.info(
            "slice %s: coordinating flip to %r across %d members",
            slice_id, raw_mode, len(members),
        )
        me = next(
            n for n in members if n["metadata"]["name"] == self.node_name
        )
        my_done_mode, my_done_epoch = _parse_stamp(
            self._ann(me, DONE_ANNOTATION)
        )
        if my_done_mode == raw_mode:
            # this member already completed a round for exactly this mode
            # (routine agent restart re-reconciling the unchanged label):
            # no quorum needed — the local engine call is idempotent and
            # republishes the state label (engine fast path).
            log.info(
                "slice %s: mode %r already completed (epoch %d); "
                "re-applying locally without coordination",
                slice_id, raw_mode, my_done_epoch,
            )
            return engine.set_mode(raw_mode)

        try:
            self.heartbeat_once()
            self._annotate_self(L.SLICE_ACK_ANNOTATION, raw_mode)
        except ApiException as e:
            raise SliceAbortError(f"could not publish slice ack: {e}") from e

        deadline = time.monotonic() + self.commit_timeout_s
        last_hb = self.clock()
        # refresh the heartbeat well inside the TTL even when start()'s
        # background thread isn't running, without PATCHing every poll
        hb_refresh_s = min(self.hb_period_s, self.hb_ttl_s / 3.0)
        commit_epoch: Optional[int] = None
        with self.tracer.span(
            "slice_wait", slice=slice_id, mode=raw_mode
        ) as wait_span:
            while time.monotonic() < deadline and not self._stop.is_set():
                try:
                    if self.clock() - last_hb >= hb_refresh_s:
                        self.heartbeat_once()
                        last_hb = self.clock()
                    members = self.members(slice_id)
                except ApiException as e:
                    log.warning(
                        "slice %s: membership read failed: %s", slice_id, e
                    )
                    self._stop.wait(self.poll_s)
                    continue
                if not members:
                    break  # slice dissolved (labels removed) mid-round
                # a round the slice has already WON must be honored
                # BEFORE any supersession abort: peers may observe the
                # same commit this poll and flip — aborting now would
                # leave the slice mixed, the exact incoherence this
                # coordinator exists to prevent. Commits are read from
                # the anchor (smallest member), the single fenced
                # location — NOT from whichever node this member
                # currently computes as leader.
                c_mode, c_epoch = _parse_stamp(
                    self._ann(members[0], L.SLICE_COMMIT_ANNOTATION)
                )
                if c_mode == raw_mode and c_epoch > my_done_epoch:
                    commit_epoch = c_epoch
                    break

                # superseded? (VERDICT r2 item 4: an in-flight round must
                # not stall out the full timeout and publish a spurious
                # `failed` when the operator changes the desired mode
                # mid-round). Two signals, either suffices: the agent's
                # mailbox (should_abort), and this node's own desired
                # label re-read from the member list we just fetched.
                if (self.should_abort is not None
                        and self.should_abort(raw_mode)):
                    self._superseded_abort(slice_id, raw_mode)
                me_row = next(
                    (n for n in members
                     if n["metadata"]["name"] == self.node_name), None,
                )
                if me_row is not None:
                    desired_now = (me_row["metadata"].get("labels") or {}
                                   ).get(L.CC_MODE_LABEL)
                    # a REMOVED or empty label maps to the agent's
                    # default mode, which this coordinator doesn't know —
                    # only a present-and-different value is proof of
                    # supersession
                    if desired_now and desired_now != raw_mode:
                        self._superseded_abort(slice_id, raw_mode)
                alive = self._alive(members)
                if not alive:
                    break
                leader = alive[0]["metadata"]["name"]

                if leader == self.node_name:
                    try:
                        self._maybe_commit(raw_mode, alive, members)
                    except ApiException as e:
                        # transient commit-write failure: keep polling (the
                        # ack must stay published, so no retract here)
                        log.warning(
                            "slice %s: commit publish failed: %s",
                            slice_id, e,
                        )
                        self._stop.wait(self.poll_s)
                        continue

                self._stop.wait(self.poll_s)
            wait_span.attrs["committed"] = commit_epoch is not None

        if commit_epoch is not None:
            log.info(
                "slice %s: commit epoch %d observed; flipping locally",
                slice_id, commit_epoch,
            )
            ok = engine.set_mode(raw_mode)
            if ok:
                try:
                    self._annotate_self(
                        DONE_ANNOTATION, f"{raw_mode}:{commit_epoch}"
                    )
                except ApiException as e:
                    log.warning("could not record slice done: %s", e)
            else:
                # local flip failed AFTER the quorum commit: the slice is
                # now visibly half-flipped (cc.mode.state=failed here).
                # Leaving `done` unrecorded keeps the commit actionable,
                # so the agent's repair loop re-converges this laggard
                # without a new quorum round (VERDICT r1 item 8).
                log.error(
                    "slice %s: local flip to %r failed after commit epoch "
                    "%d — slice is half-flipped until repaired",
                    slice_id, raw_mode, commit_epoch,
                )
            return ok

        self._retract_ack()
        shutting_down = self._stop.is_set()
        raise SliceAbortError(
            f"slice {slice_id}: no commit for mode {raw_mode!r} within "
            f"{self.commit_timeout_s:.0f}s"
            + (" (shutting down)" if shutting_down else "")
            + "; refusing to flip — the slice must move atomically",
            shutting_down=shutting_down,
        )

    def _superseded_abort(self, slice_id: str, raw_mode: str) -> None:
        """Abort the round cleanly: retract the ack (the leader must stop
        counting us toward the OLD mode's quorum) and raise with
        superseded set, so the agent skips the failed label and proceeds
        straight to the new mode."""
        self._retract_ack()
        raise SliceAbortError(
            f"slice {slice_id}: round for mode {raw_mode!r} superseded by "
            f"a newer desired mode; aborting without failure",
            superseded=True,
        )

    def _maybe_commit(
        self, raw_mode: str, alive: List[dict], members: List[dict]
    ) -> None:
        """Leader side: publish a fresh commit when every alive member has
        acked this mode and not all of them have already completed it.

        The write is a compare-and-swap on the anchor node (``members[0]``)
        preconditioned on its resourceVersion, so concurrent would-be
        leaders (heartbeat-staleness dual-leader window) produce exactly
        one commit per epoch — the loser's PUT fails with 409 and the next
        poll observes the winner's commit instead."""
        acks = [self._ann(n, L.SLICE_ACK_ANNOTATION) for n in alive]
        if not all(a == raw_mode for a in acks):
            return
        stamps = [_parse_stamp(self._ann(n, DONE_ANNOTATION)) for n in alive]
        laggard_epochs = [e for (m, e) in stamps if m != raw_mode]
        if not laggard_epochs:
            return  # round already completed everywhere; nothing to commit
        # fresh read of the anchor: both the CAS precondition and the
        # re-commit-churn check must see the latest committed state
        anchor_name = members[0]["metadata"]["name"]
        anchor = self.kube.get_node(anchor_name)
        ann = anchor["metadata"].setdefault("annotations", {})
        c_mode, c_epoch = _parse_stamp(ann.get(L.SLICE_COMMIT_ANNOTATION))
        if c_mode == raw_mode and c_epoch > max(laggard_epochs):
            return  # published commit already actionable for every laggard
        # epoch: the highest member rv observed — globally monotone (etcd
        # revision), and necessarily newer than every done epoch from
        # earlier rounds
        epoch = max(
            int(n["metadata"]["resourceVersion"]) for n in alive + [anchor]
        )
        try:
            prev_epoch = int(ann.get(L.SLICE_EPOCH_ANNOTATION, -1))
        except ValueError:
            prev_epoch = -1
        if epoch <= prev_epoch:
            return  # stale view of the slice; re-poll before writing
        ann[L.SLICE_COMMIT_ANNOTATION] = f"{raw_mode}:{epoch}"
        ann[L.SLICE_LEADER_ANNOTATION] = self.node_name
        ann[L.SLICE_EPOCH_ANNOTATION] = str(epoch)
        try:
            self.kube.replace_node(anchor_name, anchor)
        except ConflictError:
            # a concurrent leader won the CAS; their commit (visible on
            # the next poll) fences this epoch — do not retry blindly
            log.info(
                "slice commit CAS lost by %s for %r (epoch %d); deferring "
                "to the concurrent writer",
                self.node_name, raw_mode, epoch,
            )
            return
        log.info(
            "slice leader %s committed %r at epoch %d on anchor %s "
            "(%d acks)",
            self.node_name, raw_mode, epoch, anchor_name, len(acks),
        )
