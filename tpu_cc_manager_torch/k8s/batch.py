"""Write-coalescing I/O layer between the reconcile path and the API.

BENCH_NOTES r03–r05 established that the flip hot path is node-write
round trips, not device work: a flip historically cost ~five separate
writes (state label, taint add, taint clear, evidence annotation,
doctor annotation) against a contended API server. This module is the
structural fix ROADMAP item 4 calls for: same-node mutations issued
around one reconcile merge into at most two HTTP writes.

:class:`NodePatchBatcher` owns ONE node's pending mutations and offers
three delivery paths, strongest ordering first:

1. **Synchronous ordered writes** (``write_labels_now``) — the
   fail-secure ``cc.mode.state`` write. Sent immediately as one JSON
   merge patch that also CARRIES everything pending, so the ordered
   write costs the same round trip it always did while draining the
   coalescing queue for free. Failure propagates to the caller
   (fail-secure semantics are the caller's contract) and pending
   mutations are retained, never half-applied — a merge patch is atomic
   server-side.
2. **Carrier folds** (``fold_into_node`` / ``mark_folded``) — the flip
   taint's CAS replaces already hold the whole node object in hand;
   folding pending label/annotation mutations into that object makes
   the taint write the evidence/doctor publication too. The caller
   reports landing via ``mark_folded`` (a conflicted CAS retry simply
   re-folds).
3. **Deferred coalescing publications** (``defer`` + ``flush`` /
   ``maybe_flush``) — evidence and doctor documents are keyed
   publications where only the NEWEST generation ever matters: a newer
   ``defer`` under the same key replaces an unsent older one (counted —
   ``coalesced_total``; that drop is by design and loss-accounted, not
   silent). Whatever hasn't ridden a carrier is flushed with bounded
   retry/backoff; a publication that exhausts its retry budget is
   dropped LOUDLY (``dropped_total`` + ``on_drop``) and the owner's
   generation bookkeeping (agent.py ``_evidence_published_gen``)
   notices published < wanted and re-defers a fresh build from its
   idle tick — the newest generation always lands eventually.

What never batches: taint list edits themselves (CAS replace,
order-critical), drain pause/restore labels (the pod-wait poll reads
them), and the fail-secure state write never waits behind the queue.
Full contract: docs/io.md.

Thread-safety: every mutation of pending state happens under ``_lock``;
HTTP writes happen OUTSIDE the lock (ccaudit blocking-under-lock), so a
flush racing a carrier fold can at worst deliver the same newest
payload twice — an idempotent merge, not a reorder.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.flightrec import get_recorder
from tpu_cc_manager_torch.trace import Tracer, get_tracer

log = logging.getLogger("tpu-cc-manager.k8s.batch")

#: (key, gen) pairs a carrier write is transporting; handed back to
#: ``mark_folded`` when the carrier lands.
FoldToken = List[Tuple[str, int]]


class _Pending:
    """One key's newest unsent publication."""

    __slots__ = ("gen", "labels", "annotations", "on_published", "retries")

    def __init__(
        self,
        gen: int,
        labels: Optional[Dict[str, Optional[str]]],
        annotations: Optional[Dict[str, Optional[str]]],
        on_published: Optional[Callable[[int], None]],
    ) -> None:
        self.gen = gen
        self.labels = dict(labels or {})
        self.annotations = dict(annotations or {})
        self.on_published = on_published
        self.retries = 0


class NodePatchBatcher:
    """Per-node write coalescer (see module docstring for the model)."""

    #: a publication that failed this many direct flushes is dropped
    #: (accounted); the owner's generation bookkeeping re-defers fresh
    MAX_RETRIES = 8
    #: exponential backoff for failed flushes: base * 2^(n-1), capped
    BACKOFF_BASE_S = 0.2
    BACKOFF_CAP_S = 30.0

    def __init__(
        self,
        kube: Any,
        node_name: str,
        *,
        flush_interval_s: float = 0.25,
        tracer: Optional[Tracer] = None,
        on_coalesced: Optional[Callable[[str], None]] = None,
        on_retry: Optional[Callable[[str], None]] = None,
        on_drop: Optional[Callable[[str], None]] = None,
        recorder: Optional[Any] = None,
    ) -> None:
        self.kube = kube
        self.node_name = node_name
        self.flush_interval_s = flush_interval_s
        self._tracer = tracer or get_tracer()
        self._on_coalesced = on_coalesced
        self._on_retry = on_retry
        self._on_drop = on_drop
        #: flight recorder the publish-loss events note into; None =
        #: the process-wide one at event time (the agent points that at
        #: its own black box via flightrec.set_recorder; simlab
        #: replicas inject theirs — a per-replica batcher noting into
        #: the process default would be invisible to the fleet stitch)
        self._recorder = recorder
        self._lock = threading.Lock()
        self._pending: Dict[str, _Pending] = {}
        self._gen_seq: Dict[str, int] = {}
        #: monotonic time before which maybe_flush stays quiet (set by
        #: failed flushes — the backoff — and successful ones — the
        #: minimum flush spacing)
        self._next_flush_at = 0.0
        self._consecutive_failures = 0
        # accounting (all under _lock; read via stats())
        self.coalesced_total = 0  #: superseded-before-send publications
        self.folded_total = 0  #: publications that rode a carrier write
        self.flushed_total = 0  #: publications delivered by direct flush
        self.retries_total = 0  #: failed direct-flush write attempts
        self.dropped_total = 0  #: publications dropped after MAX_RETRIES

    # ------------------------------------------------------------ deferred
    def next_gen(self, key: str) -> int:
        """Allocate the next generation number for ``key`` (monotonic
        per batcher; callers carrying their own generation counters —
        the agent's evidence machinery — pass theirs to defer)."""
        with self._lock:
            gen = self._gen_seq.get(key, 0) + 1
            self._gen_seq[key] = gen
            return gen

    def defer(
        self,
        key: str,
        *,
        labels: Optional[Dict[str, Optional[str]]] = None,
        annotations: Optional[Dict[str, Optional[str]]] = None,
        gen: Optional[int] = None,
        on_published: Optional[Callable[[int], None]] = None,
    ) -> int:
        """Queue a coalescing publication: the newest ``defer`` under a
        key wins; an unsent older one is superseded (counted). Returns
        the generation this publication carries. Never blocks, never
        raises."""
        coalesced = False
        with self._lock:
            if gen is None:
                gen = self._gen_seq.get(key, 0) + 1
            self._gen_seq[key] = max(self._gen_seq.get(key, 0), gen)
            if key in self._pending:
                coalesced = True
                self.coalesced_total += 1
            first = not self._pending
            self._pending[key] = _Pending(gen, labels, annotations,
                                          on_published)
            # schedule a direct flush one flush window out: the window
            # is the carrier-write grace period — a reconcile's taint/
            # state write usually arrives first and transports this for
            # free. The first pending item arms a fresh schedule; later
            # ones may only PULL it earlier (a long failure backoff is
            # shortened for fresh data — backoff punishes failed
            # WRITES, not new generations).
            due = time.monotonic() + self.flush_interval_s
            self._next_flush_at = (
                due if first else min(self._next_flush_at, due)
            )
        if coalesced and self._on_coalesced is not None:
            self._notify(self._on_coalesced, key)
        return gen

    def has_pending(self, key: Optional[str] = None) -> bool:
        with self._lock:
            if key is not None:
                return key in self._pending
            return bool(self._pending)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "coalesced": self.coalesced_total,
                "folded": self.folded_total,
                "flushed": self.flushed_total,
                "retries": self.retries_total,
                "dropped": self.dropped_total,
            }

    # ------------------------------------------------------------ carriers
    def fold_into_node(self, node: dict) -> FoldToken:
        """Merge every pending mutation into a node object about to be
        CAS-replaced (mutates ``node`` in place). Returns the token to
        hand to :meth:`mark_folded` once that replace LANDED; a
        conflicted attempt just folds again into the fresh read."""
        token: FoldToken = []
        with self._lock:
            for key, p in self._pending.items():
                meta = node.setdefault("metadata", {})
                # a None value means delete-key (merge-patch semantics on
                # the flush path); on a full replace body that translates
                # to the key being ABSENT, never a literal null
                for field, muts in (("labels", p.labels),
                                    ("annotations", p.annotations)):
                    if not muts:
                        continue
                    target = meta.setdefault(field, {})
                    for k, v in muts.items():
                        if v is None:
                            target.pop(k, None)
                        else:
                            target[k] = v
                token.append((key, p.gen))
        return token

    def mark_folded(self, token: FoldToken) -> None:
        """A carrier write holding ``token``'s publications landed:
        retire exactly those generations (a newer defer that arrived
        mid-write stays pending) and fire their callbacks."""
        if not token:
            return
        callbacks: List[Tuple[Callable[[int], None], int]] = []
        with self._lock:
            for key, gen in token:
                p = self._pending.get(key)
                if p is not None and p.gen == gen:
                    del self._pending[key]
                    self.folded_total += 1
                    if p.on_published is not None:
                        callbacks.append((p.on_published, gen))
        for cb, gen in callbacks:
            self._notify(cb, gen)

    def fold_into_patch(self, patch: dict) -> FoldToken:
        """Merge pending mutations into an outgoing merge-patch body
        (mutates ``patch``); same token contract as fold_into_node.
        The CALLER's keys win on conflict — an ordered write's payload
        is never overridden by a deferred one."""
        token: FoldToken = []
        meta = patch.setdefault("metadata", {})
        caller_labels = dict(meta.get("labels") or {})
        caller_ann = dict(meta.get("annotations") or {})
        with self._lock:
            for key, p in self._pending.items():
                if p.labels:
                    merged = dict(p.labels)
                    merged.update(caller_labels)
                    caller_labels = merged
                if p.annotations:
                    merged = dict(p.annotations)
                    merged.update(caller_ann)
                    caller_ann = merged
                token.append((key, p.gen))
        if caller_labels:
            meta["labels"] = caller_labels
        if caller_ann:
            meta["annotations"] = caller_ann
        return token

    # ----------------------------------------------------- ordered writes
    def write_labels_now(self, labels: Dict[str, Optional[str]]) -> None:
        """Synchronous ordered label write (the fail-secure state path):
        ONE merge patch carrying ``labels`` plus everything pending.
        Raises on failure — the caller owns fail-secure semantics — and
        pending publications are retained for the next carrier/flush
        (the merge patch is atomic server-side: on failure NOTHING
        landed, so there is no half-applied state to reason about)."""
        patch: dict = {"metadata": {"labels": dict(labels)}}
        token = self.fold_into_patch(patch)
        self._write_patch(patch)  # raises to the caller on failure
        self.mark_folded(token)

    def write_state_label(self, value: str) -> None:
        """Fail-secure observed-state publish: ONE synchronous ordered
        write of the ``cc.mode.state`` label (``write_labels_now``
        semantics — raises on failure, doubles as a publication
        carrier). The one definition of the log+write pair the agent
        and simlab replicas both publish through."""
        log.info("setting %s=%s on node %s", L.CC_MODE_STATE_LABEL,
                 value, self.node_name)
        self.write_labels_now({L.CC_MODE_STATE_LABEL: value})

    # --------------------------------------------------------------- flush
    def maybe_flush(self) -> None:
        """Idle-tick entry point: flush pending publications when due
        (respects the flush window and failure backoff). Never raises."""
        with self._lock:
            if not self._pending or time.monotonic() < self._next_flush_at:
                return
        self.flush()

    def flush(self) -> bool:
        """Deliver everything pending in ONE write now (unconditional;
        maybe_flush is the window/backoff-respecting entry point).
        Returns True when nothing remains pending. Failures are
        absorbed into the retry/backoff accounting (never raises)."""
        with self._lock:
            if not self._pending:
                return True
            snapshot = [(k, p) for k, p in self._pending.items()]
        labels: Dict[str, Optional[str]] = {}
        ann: Dict[str, Optional[str]] = {}
        for _, p in snapshot:
            labels.update(p.labels)
            ann.update(p.annotations)
        try:
            with self._tracer.span("publish_flush",
                                   keys=[k for k, _ in snapshot]):
                self._write_split(labels, ann)
        except Exception as e:
            self._record_flush_failure(snapshot, e)
            return False
        callbacks: List[Tuple[Callable[[int], None], int]] = []
        with self._lock:
            self._consecutive_failures = 0
            self._next_flush_at = time.monotonic() + self.flush_interval_s
            for key, p in snapshot:
                cur = self._pending.get(key)
                if cur is not None and cur.gen == p.gen:
                    del self._pending[key]
                    self.flushed_total += 1
                    if p.on_published is not None:
                        callbacks.append((p.on_published, p.gen))
        for cb, gen in callbacks:
            self._notify(cb, gen)
        return not self.has_pending()

    def close(self) -> None:
        """Best-effort final flush (shutdown)."""
        self.flush()

    # ------------------------------------------------------------ plumbing
    def _write_patch(self, patch: dict) -> None:
        meta = patch.get("metadata") or {}
        self._write_split(meta.get("labels") or {},
                          meta.get("annotations") or {})

    def _write_split(
        self,
        labels: Dict[str, Optional[str]],
        ann: Dict[str, Optional[str]],
    ) -> None:
        """One node write for the combined payload, via the narrowest
        client verb that covers it (keeps the KubeClient convenience
        surface — and everything tests/fakes layer onto it — honest)."""
        if labels and ann:
            self.kube.patch_node(self.node_name, {
                "metadata": {"labels": labels, "annotations": ann},
            })
        elif ann:
            self.kube.set_node_annotations(self.node_name, ann)
        elif labels:
            self.kube.set_node_labels(self.node_name, labels)

    def _record_flush_failure(
        self, snapshot: List[Tuple[str, _Pending]], exc: Exception
    ) -> None:
        dropped: List[str] = []
        retried: List[str] = []
        with self._lock:
            self._consecutive_failures += 1
            backoff = min(
                self.BACKOFF_BASE_S * 2 ** (self._consecutive_failures - 1),
                self.BACKOFF_CAP_S,
            )
            self._next_flush_at = time.monotonic() + backoff
            for key, p in snapshot:
                cur = self._pending.get(key)
                if cur is None or cur.gen != p.gen:
                    continue  # superseded mid-write; the newer one owns retries
                cur.retries += 1
                self.retries_total += 1
                retried.append(key)
                if cur.retries >= self.MAX_RETRIES:
                    del self._pending[key]
                    self.dropped_total += 1
                    dropped.append(key)
        log.warning(
            "publish flush for %s failed (%s); retrying %s in %.1fs%s",
            self.node_name, exc, retried, backoff,
            f"; DROPPED after retry budget: {dropped}" if dropped else "",
        )
        # the black box keeps the loss accounting next to the spans it
        # explains: a dump after a publish storm shows WHICH keys were
        # retried/dropped, not just the counters' totals
        (self._recorder or get_recorder()).note(
            "publish_flush_failed", node=self.node_name,
            error=f"{type(exc).__name__}: {exc}", retried=retried,
            dropped=dropped, backoff_s=round(backoff, 2),
        )
        for key in retried:
            if self._on_retry is not None:
                self._notify(self._on_retry, key)
        for key in dropped:
            if self._on_drop is not None:
                self._notify(self._on_drop, key)

    @staticmethod
    def _notify(cb: Callable[[Any], None], arg: Any) -> None:
        try:
            cb(arg)
        except Exception:
            # observability/bookkeeping hooks must never sink a write
            log.debug("batcher callback failed", exc_info=True)
