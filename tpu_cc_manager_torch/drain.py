"""L2 — drain TPU workloads around a mode flip, and publish observed state.

Two drain strategies, selectable per deployment:

1. :class:`ComponentDrainer` — the pause-label protocol, a faithful
   TPU-native rebuild of the reference's gpu-operator eviction module
   (reference gpu_operator_eviction.py): flip each
   ``tpu.google.com/pool.deploy.*`` node label to a paused marker that
   preserves the original value, wait for the component's pods to leave
   the node (2 s poll, 300 s timeout per component, warn-and-continue on
   timeout — reference gpu_operator_eviction.py:174-208), and restore the
   original labels afterwards.

2. :class:`NodeDrainer` — the GKE-native strategy the reference lacks
   (SURVEY.md §7.1): cordon the node (``spec.unschedulable``), evict
   TPU-consuming pods through the Eviction API (respecting PDBs: 429 is
   retried with backoff until the timeout), then uncordon. This is what
   "drain a TPU node pool" actually means without a cooperating operator.

Both preserve the reference's cardinal invariant: **restore is always
attempted, even when the flip failed** (the engine calls ``reschedule()``
in a ``finally`` — reference scripts/cc-manager.sh:210-215).

The observed-state label writer lives here too, mirroring the reference's
placement (gpu_operator_eviction.py:262-286).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, Optional, Sequence, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.engine import Drainer, FlipTaint, NullDrainer
from tpu_cc_manager_torch.k8s.client import ApiException, KubeClient

log = logging.getLogger("tpu-cc-manager.drain")

#: Per-component pod-deletion wait (reference gpu_operator_eviction.py:136;
#: scripts/cc-manager.sh:275 uses kubectl --timeout=5m).
EVICTION_TIMEOUT_S = 300
#: Poll interval while waiting for pods to go away
#: (reference gpu_operator_eviction.py:200).
EVICTION_POLL_S = 2


def _drain_wait(wake: Optional[threading.Event], poll_s: float) -> None:
    """One drain-wait interval, cut short by the wake event when the
    caller wired one (the agent pulses it from its node-watch delta
    thread, so a restore/taint/cordon change is noticed on the watch
    event instead of the next poll boundary — ISSUE 14's wake
    treatment). ``poll_s`` survives as the liveness fallback: pod
    deletions produce no node event, so the re-check cadence is still
    bounded. Without a wake source this is a plain interruptible
    sleep."""
    if wake is None:
        time.sleep(poll_s)  # ccaudit: allow-poll(no wake source wired: a bare drainer — one-shot CLI without a watch — has nothing to pulse this wait) # ccaudit: allow-stop-aware-wait(same CLI path: there is no stop event either — the agent path always wires the wake, which stop() pulses)
        return
    if wake.wait(poll_s):
        wake.clear()


def set_cc_mode_state_label(kube: KubeClient, node_name: str, value: str) -> None:
    """Publish the observed-state label (reference
    gpu_operator_eviction.py:262-286). Value is the achieved mode or
    'failed' — the Python reference's convention, which we standardize on
    (the bash engine's success/failed variant was a wart, SURVEY.md §5.5)."""
    log.info("setting %s=%s on node %s", L.CC_MODE_STATE_LABEL, value, node_name)
    kube.set_node_labels(node_name, {L.CC_MODE_STATE_LABEL: value})  # ccaudit: allow-direct-node-write(the fail-secure state write: synchronous and ordered by contract, used by one-shot CLIs without a batcher; the agent routes through NodePatchBatcher.write_labels_now)


#: reconcile outcome -> (core/v1 Event reason, Event type); "shutdown"
#: is a termination artifact, not an outcome worth recording
EVENT_FOR_OUTCOME = {
    "success": ("CCModeApplied", "Normal"),
    "failure": ("CCModeFailed", "Warning"),
    "error": ("CCModeFailed", "Warning"),
    "invalid": ("CCModeInvalid", "Warning"),
    "slice_abort": ("CCSliceAborted", "Warning"),
    "fatal": ("CCModeFailed", "Warning"),
}


def build_node_event(node_name: str, reason: str, message: str,
                     etype: str, name: str) -> dict:
    """Core/v1 Event against a Node. Events for cluster-scoped Nodes
    must live in the "default" namespace — a real apiserver rejects
    event.namespace != involvedObject.namespace (which is empty for
    Nodes)."""
    now = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())
    return {
        "kind": "Event",
        "apiVersion": "v1",
        "metadata": {"name": name, "namespace": "default"},
        "involvedObject": {
            "kind": "Node", "apiVersion": "v1", "name": node_name,
        },
        "reason": reason,
        "message": message,
        "type": etype,
        "source": {"component": "tpu-cc-manager", "host": node_name},
        "firstTimestamp": now,
        "lastTimestamp": now,
        "count": 1,
    }


def build_reconcile_event(
    node_name: str, mode: str, outcome: str, duration_s: float, name: str
) -> Optional[dict]:
    """Core/v1 Event for one reconcile outcome, shared by the agent's
    async recorder and the one-shot CLI (the bash engine builds the same
    shape in _post_event). None for outcomes that don't record."""
    hit = EVENT_FOR_OUTCOME.get(outcome)
    if hit is None:
        return None
    reason, etype = hit
    return build_node_event(
        node_name, reason,
        f"cc mode reconcile to '{mode}': {outcome} in {duration_s:.2f}s",
        etype, name,
    )


def post_event_best_effort(kube: KubeClient, event: dict,
                           warned_before: bool = False) -> Tuple[bool, bool]:
    """Deliver one Event, never raising. Returns (delivered, warned):
    a clientset without Events support (501) is routine and stays at
    debug, anything else (403 RBAC missing, 400 validation) warns — once
    per caller, tracked via ``warned_before`` — because it means the
    deployment is silently losing the feature."""
    try:
        kube.create_event(event["metadata"]["namespace"], event)
        return True, False
    except Exception as e:
        if getattr(e, "status", None) == 501:
            log.debug("event emission skipped: %s", e)
            return False, False
        if not warned_before:
            log.warning(
                "event emission failing (suppressing further warnings): %s",
                e,
            )
            return False, True
        return False, False


class NodeFlipTaint(FlipTaint):
    """Real k8s flip taint: ``tpu.google.com/cc.mode=flipping:NoSchedule``
    held on the node while the engine flips its devices, so the scheduler
    stops placing new TPU pods on a node whose devices are gated. The
    pause labels only speak to a cooperating operator; the taint speaks to
    kube-scheduler itself (SURVEY.md §7.1's GKE-native drain direction).

    ``spec.taints`` is a list, so a merge patch would replace it
    wholesale and wipe taints other controllers (node-lifecycle's
    not-ready/unreachable) add concurrently. Both operations therefore
    use optimistic-concurrency replace: read the node, edit the taint
    list, ``replace_node`` with the read resourceVersion, and retry on
    409 conflict. Both are idempotent."""

    #: bounded retries: losing every race for this long means the node
    #: object is churning so hard the taint is the least of its problems
    MAX_CAS_ATTEMPTS = 8

    def __init__(self, kube: KubeClient, node_name: str,
                 batcher=None, node_hint=None):
        self.kube = kube
        self.node_name = node_name
        #: optional NodePatchBatcher (k8s.batch): every CAS replace this
        #: taint layer performs is a CARRIER for the batcher's pending
        #: label/annotation publications — the node object is already in
        #: hand, so evidence/doctor ride the taint write for free and
        #: the flip's publication round trips collapse into the two
        #: writes the flip makes anyway (ISSUE 6)
        self.batcher = batcher
        #: optional zero-cost seed source (the agent wires the node
        #: watcher's latest_node): the desired-label event that triggers
        #: a reconcile carries a node FRESHER than anything a GET would
        #: return, so the opening taint write can skip its read entirely.
        #: Historically a watcher hint measured slower because async
        #: evidence/event writes landed between the event and the taint
        #: write, dooming the seeded PUT — the batcher removed exactly
        #: those interleaving writes, which is what makes this hint
        #: profitable now.
        self.node_hint = node_hint
        #: node returned by our own last successful replace — the
        #: freshest possible seed for the NEXT write of the same flip
        #: (set -> clear), making the steady-state clear a single round
        #: trip instead of GET+PUT (BENCH phase_p50_s: taint ops are
        #: the flip hot path's dominant cost).
        self._cached: Optional[dict] = None

    def _seed(self, hint_ok: bool = False) -> Optional[dict]:
        if self._cached is not None:
            node, self._cached = self._cached, None
            return node
        if hint_ok and self.node_hint is not None:
            # only the flip's OPENING write (set) may seed from the
            # watcher snapshot: nothing writes the node between the
            # triggering label event and the taint set. The CLOSING
            # write may sit behind drain pause/restore patches the
            # snapshot hasn't caught up with — a stale seed there costs
            # a doomed PUT on top of the fallback read.
            try:
                return self.node_hint()
            except Exception:
                log.debug("taint seed hint failed; falling back to GET",
                          exc_info=True)
        return None

    def invalidate_cache(self) -> None:
        """Drop the cached node. The engine calls this after drain
        pause/restore label patches (which bump the node's rv and would
        make the seeded clear pay a doomed PUT before its fallback)."""
        self._cached = None

    def _cas_loop(self, mutate, cache_result: bool,
                  hint_ok: bool = False) -> bool:
        """Read(or seed)-modify-replace with 409 retry. ``mutate(node)``
        edits in place and returns True to write, None for no-op. A
        no-op judged on a SEED is re-confirmed against a fresh read —
        a stale seed may hide work that is actually needed. Returns
        True only when a replace actually LANDED (a retry that finds
        the work already done returns False).

        ``cache_result``: only the flip's OPENING write (set) caches
        its replace return — it is fresh for the same flip's closing
        write. The closing write must NOT cache: by the next reconcile
        the label change itself has moved the rv, and a stale seed
        costs a doomed PUT before the fallback read (measured: it
        roughly doubled taint_set)."""
        from tpu_cc_manager_torch.k8s.client import ConflictError

        seed = self._seed(hint_ok)
        # ccaudit: allow-retry-discipline(optimistic CAS, not congestion retry: every attempt starts from a FRESH read, contention is at most one other writer per node (the agent), and MAX_CAS_ATTEMPTS caps it — pacing would stretch the flip's critical path for no herd reduction)
        for _ in range(self.MAX_CAS_ATTEMPTS):
            seeded = seed is not None
            node = seed if seeded else self.kube.get_node(self.node_name)
            seed = None
            if mutate(node) is None:
                if seeded:
                    continue  # confirm the no-op on a fresh read
                return False
            # carrier fold: this replace transports whatever the batcher
            # holds (evidence/doctor publications); a conflicted attempt
            # re-folds into the next read, and only a LANDED replace
            # retires the folded generations
            token = (self.batcher.fold_into_node(node)
                     if self.batcher is not None else None)
            try:
                result = self.kube.replace_node(self.node_name, node)  # ccaudit: allow-direct-node-write(this CAS replace IS the batcher's carrier: the fold above transports every pending publication)
                self._cached = result if cache_result else None
                if token and self.batcher is not None:
                    self.batcher.mark_folded(token)
                return True
            except ConflictError:
                continue
        raise ApiException(409, "taint update kept conflicting")

    def _edit_taints(self, edit, cache_result: bool = False,
                     hint_ok: bool = False) -> None:
        def mutate(node):
            taints = list(node.get("spec", {}).get("taints") or [])
            new = edit(taints)
            if new is None:
                return None
            node.setdefault("spec", {})["taints"] = new
            return True

        self._cas_loop(mutate, cache_result, hint_ok)

    def set(self) -> None:
        def add(taints):
            if any(t.get("key") == L.FLIP_TAINT_KEY for t in taints):
                return None
            return taints + [{
                "key": L.FLIP_TAINT_KEY,
                "value": L.FLIP_TAINT_VALUE,
                "effect": L.FLIP_TAINT_EFFECT,
            }]

        log.info("tainting %s %s=%s:%s for the flip", self.node_name,
                 L.FLIP_TAINT_KEY, L.FLIP_TAINT_VALUE, L.FLIP_TAINT_EFFECT)
        self._edit_taints(add, cache_result=True, hint_ok=True)

    def clear(self) -> None:
        def remove(taints):
            kept = [t for t in taints if t.get("key") != L.FLIP_TAINT_KEY]
            return None if len(kept) == len(taints) else kept

        log.info("removing flip taint from %s", self.node_name)
        self._edit_taints(remove)

    def clear_and_publish_state(self, state: str) -> bool:
        """Taint removal + ``cc.mode.state`` label in the SAME CAS
        replace: the node object is already in hand for the taint edit,
        so folding the label in removes one whole PATCH round trip from
        every flip (the reconcile hot path's dominant cost is node-write
        round trips, BENCH phase_p50_s). Atomic as a bonus: observers
        (webhook steering on the state label) can never see the new
        state while the flip taint still repels pods.

        Returns True when the label was published here; False when the
        taint was already absent (no replace happened — the caller's
        plain label write is cheaper than a read-modify-write)."""
        log.info(
            "removing flip taint from %s and setting %s=%s",
            self.node_name, L.CC_MODE_STATE_LABEL, state,
        )
        def mutate(node):
            taints = list(node.get("spec", {}).get("taints") or [])
            kept = [
                t for t in taints if t.get("key") != L.FLIP_TAINT_KEY
            ]
            if len(kept) == len(taints):
                return None  # no taint to clear: plain patch is cheaper
            node.setdefault("spec", {})["taints"] = kept
            node["metadata"].setdefault("labels", {})[
                L.CC_MODE_STATE_LABEL] = state
            return True

        return self._cas_loop(mutate, cache_result=False)


def paused_value(original: str) -> str:
    """Encode the pause marker, preserving the original for restore
    (reference gpu_operator_eviction.py:43-70 '<PAUSED_STR>_<original>')."""
    return f"{L.PAUSED_STR}_{original}"


def unpaused_value(value: str) -> str:
    """Invert paused_value; idempotent on already-unpaused values."""
    prefix = L.PAUSED_STR + "_"
    return value[len(prefix):] if value.startswith(prefix) else value


class ComponentDrainer(Drainer):
    def __init__(
        self,
        kube: KubeClient,
        node_name: str,
        namespace: str = "tpu-system",
        component_labels: Sequence[str] = L.COMPONENT_LABELS,
        timeout_s: float = EVICTION_TIMEOUT_S,
        poll_s: float = EVICTION_POLL_S,
        wake: Optional[threading.Event] = None,
    ):
        self.kube = kube
        self.node_name = node_name
        self.namespace = namespace
        self.component_labels = tuple(component_labels)
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        #: optional wake source for the pod-wait loops (see
        #: engine.Drainer's wake contract): the agent wires its node
        #: watcher's delta pulse here
        self.wake = wake

    # -- reference gpu_operator_eviction.py:98-129 ----------------------
    def fetch_current_component_labels(self) -> Dict[str, str]:
        node = self.kube.get_node(self.node_name)
        node_labels = node["metadata"].get("labels", {})
        return {
            k: node_labels[k] for k in self.component_labels if k in node_labels
        }

    # -- reference gpu_operator_eviction.py:131-215 ---------------------
    def evict(self) -> None:
        current = self.fetch_current_component_labels()
        to_pause = {
            k: paused_value(v)
            for k, v in current.items()
            if not v.startswith(L.PAUSED_STR) and v != "false"
        }
        # node-write tracking for the engine's taint-seed cache: a node
        # with nothing to pause leaves the node object untouched
        self.wrote_node = bool(to_pause)
        if not to_pause:
            log.info("no TPU-stack components deployed on %s; nothing to drain",
                     self.node_name)
            return
        log.info("pausing components on %s: %s", self.node_name,
                 sorted(to_pause))
        self.kube.set_node_labels(self.node_name, to_pause)  # ccaudit: allow-direct-node-write(drain protocol: the pause labels must be visible to the operator BEFORE the pod-wait poll below — deferring them would deadlock the wait)
        for label_key in to_pause:
            self._wait_component_gone(label_key)

    def _wait_component_gone(self, label_key: str) -> None:
        app = L.COMPONENT_APP_LABELS.get(label_key)
        if app is None:
            return
        deadline = time.monotonic() + self.timeout_s
        selector = f"app={app}"
        while True:
            pods = self.kube.list_pods(
                self.namespace,
                label_selector=selector,
                field_selector=f"spec.nodeName={self.node_name}",
            )
            if not pods:
                log.info("component %s drained from %s", app, self.node_name)
                return
            if time.monotonic() >= deadline:
                # warn-and-continue, not fatal
                # (reference gpu_operator_eviction.py:205-207)
                log.warning(
                    "timed out after %ss waiting for %d %s pod(s) to leave %s; "
                    "continuing anyway", self.timeout_s, len(pods), app,
                    self.node_name,
                )
                return
            _drain_wait(self.wake, self.poll_s)

    # -- reference gpu_operator_eviction.py:217-260 ---------------------
    def reschedule(self) -> None:
        """Unpause from live label state (not an in-memory snapshot), so a
        crashed-and-restarted agent can still restore — durable state lives
        in the labels (SURVEY.md §5.4)."""
        restore = {}
        live = self.fetch_current_component_labels()
        for k, v in live.items():
            if v.startswith(L.PAUSED_STR):
                restore[k] = unpaused_value(v)
        if restore:
            log.info("restoring components on %s: %s", self.node_name,
                     sorted(restore))
            self.kube.set_node_labels(self.node_name, restore)  # ccaudit: allow-direct-node-write(drain protocol: restore must land even when the flip failed — it cannot wait behind a batcher flush that may be backing off)
            self.wrote_node = True


class NodeDrainer(Drainer):
    """Cordon + Eviction-API drain of TPU-consuming pods (GKE-native)."""

    def __init__(
        self,
        kube: KubeClient,
        node_name: str,
        namespaces: Sequence[str] = ("default",),
        pod_label_selector: Optional[str] = None,
        timeout_s: float = EVICTION_TIMEOUT_S,
        poll_s: float = EVICTION_POLL_S,
        wake: Optional[threading.Event] = None,
    ):
        self.kube = kube
        self.node_name = node_name
        self.namespaces = tuple(namespaces)
        self.pod_label_selector = pod_label_selector
        self.timeout_s = timeout_s
        self.poll_s = poll_s
        #: optional wake source (see engine.Drainer's wake contract)
        self.wake = wake

    def _cordon(self, value: bool) -> None:
        self.kube.patch_node(self.node_name, {"spec": {"unschedulable": value}})  # ccaudit: allow-direct-node-write(ordered drain step: cordon must precede the evictions issued right after it)

    def _tpu_pods(self):
        out = []
        for ns in self.namespaces:
            for pod in self.kube.list_pods(
                ns,
                label_selector=self.pod_label_selector,
                field_selector=f"spec.nodeName={self.node_name}",
            ):
                out.append((ns, pod["metadata"]["name"]))
        return out

    def evict(self) -> None:
        log.info("cordoning %s and evicting TPU pods", self.node_name)
        self._cordon(True)
        deadline = time.monotonic() + self.timeout_s
        while True:
            pods = self._tpu_pods()
            if not pods:
                return
            blocked = 0
            for ns, name in pods:
                try:
                    self.kube.evict_pod(ns, name)
                except ApiException as e:
                    if e.status == 429:  # PDB says not yet
                        blocked += 1
                    elif e.status != 404:
                        raise
            if blocked == 0 and not self._tpu_pods():
                return
            if time.monotonic() >= deadline:
                log.warning(
                    "timed out draining %s (%d pod(s) still blocked); "
                    "continuing anyway", self.node_name, blocked,
                )
                return
            _drain_wait(self.wake, self.poll_s)

    def reschedule(self) -> None:
        log.info("uncordoning %s", self.node_name)
        self._cordon(False)


def build_drainer(kube: KubeClient, cfg,
                  wake: Optional[threading.Event] = None) -> Drainer:
    """Map an AgentConfig's drain_strategy to a Drainer (single source of
    truth for both the long-lived agent and the one-shot CLI).
    ``wake``: optional watch-delta pulse for the pod-wait loops (the
    agent wires its node watcher's event stream; one-shot CLIs pass
    nothing and keep the plain poll)."""
    if cfg.drain_strategy == "node":
        return NodeDrainer(kube, cfg.node_name, wake=wake)
    if cfg.drain_strategy == "components":
        return ComponentDrainer(
            kube, cfg.node_name, namespace=cfg.operator_namespace,
            wake=wake,
        )
    return NullDrainer()
