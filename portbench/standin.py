"""The benchmark's API-server stand-in: a frozen copy of the port's
``tpu_cc_manager_torch/k8s/fake.py`` (commit 102b71c, copied unchanged
below this docstring but for three things), so that no later change to
the program can speed up the yardstick its scans are timed against.

- ``match_selector`` and ``merge_patch`` are copies of
  ``tpu_cc_manager_torch/k8s/objects.py`` (same commit), kept here;
- ``FakeKube`` derives from ``object``, not from the port's
  ``KubeClient``: the benchmark drives only the verbs defined here;
- the only import from the program is the two exception types its
  controllers catch.
"""

from __future__ import annotations

import bisect
import copy
import json
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from tpu_cc_manager_torch.k8s.client import ApiException, ConflictError


def merge_patch(target: dict, patch: dict) -> dict:
    """RFC 7386 JSON merge patch: dicts merge recursively, null deletes.

    This is the patch flavor both agents use for labels (the reference
    patches ``{"metadata": {"labels": {...}}}``,
    gpu_operator_eviction.py:165-171).
    """
    out = copy.deepcopy(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_patch(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def match_selector(labels: Dict[str, str], selector: Optional[str]) -> bool:
    """Subset of k8s label-selector syntax used by the agents:
    ``k=v``, ``k==v``, ``k!=v``, bare ``k`` (exists), comma-joined."""
    if not selector:
        return True
    for term in selector.split(","):
        term = term.strip()
        if not term:
            continue
        if "!=" in term:
            k, v = term.split("!=", 1)
            if labels.get(k.strip()) == v.strip():
                return False
        elif "==" in term:
            k, v = term.split("==", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        elif "=" in term:
            k, v = term.split("=", 1)
            if labels.get(k.strip()) != v.strip():
                return False
        else:
            if term not in labels:
                return False
    return True


class _WatchEvent:
    """One retained watch event. The snapshot is deep-copied ONCE at
    record time and never mutated; ``wire()`` caches the serialized
    NDJSON line so N watchers fanning one event out over HTTP pay ONE
    json.dumps instead of N (ISSUE 11: the apiserver's fan-out cost
    used to scale O(history x watchers) in encoding alone)."""

    __slots__ = ("rv", "etype", "obj", "_wire")

    def __init__(self, rv: int, etype: str, obj: dict):
        self.rv = rv
        self.etype = etype
        self.obj = obj
        self._wire: Optional[bytes] = None

    def wire(self) -> bytes:
        # benign last-writer-wins: two watchers racing this encode the
        # same immutable snapshot to identical bytes
        # ccaudit: allow-race-lockset(idempotent memoization of an immutable snapshot: concurrent writers produce byte-identical values, a lost update costs one redundant json.dumps)
        if self._wire is None:
            self._wire = json.dumps(
                {"type": self.etype, "object": self.obj}
            ).encode() + b"\n"
        return self._wire


def _paginate(
    items: List[dict], limit: Optional[int], cont: Optional[str]
) -> Tuple[List[dict], Optional[str]]:
    """Name-ordered chunking with an offset continue token (the real API
    server's chunked-LIST contract, close enough for client testing)."""
    items.sort(key=lambda o: o["metadata"]["name"])
    try:
        start = int(cont) if cont else 0
    except ValueError:
        raise ApiException(410, f"invalid continue token {cont!r}") from None
    if limit is None or limit <= 0:
        return items[start:], None
    page = items[start:start + limit]
    nxt = start + limit
    return page, (str(nxt) if nxt < len(items) else None)


class FakeKube:
    def __init__(self, watch_history_limit: int = 1000):
        self._lock = threading.Condition()
        self._nodes: Dict[str, dict] = {}
        self._pods: Dict[Tuple[str, str], dict] = {}
        self._rv = 0
        # watch history: _WatchEvent records plus a parallel rv list so
        # watchers bisect to their resume point. Compaction is CHUNKED
        # (trim only past limit + chunk, back down to limit): the old
        # trim-on-every-write sliced a full limit-sized list per write
        # once the ring filled — O(limit) per write, the quiet half of
        # the fan-out wall long simlab runs hit (ISSUE 11 satellite).
        # The 410 contract is unchanged: a resume below the oldest
        # retained rv still fails at establishment.
        self._events: List[_WatchEvent] = []
        self._event_rvs: List[int] = []
        self._history_limit = watch_history_limit
        # fault injection
        self.pdb_blocked: set = set()  # {(ns, name)} -> evict raises 429
        self.fail_next_watches = 0  # next N watch_nodes calls raise 500
        #: next N node LISTs answer 429 (API-server overload storm, the
        #: priority-and-fairness rejection clients must retry through)
        self.fail_next_lists = 0
        #: next N node WRITES (patch/replace) answer 429 — the write-path
        #: overload storm the coalescing publish core must absorb
        #: without losing its newest generation (ISSUE 6)
        self.fail_next_node_writes = 0
        self.patch_delay_s = 0.0  # simulated API latency
        #: regional API blackout (federation, ISSUE 16): while set,
        #: every API verb answers 503 and in-flight watches sever —
        #: the whole control plane of ONE region going dark. Driver
        #: out-of-band surfaces (peek_node_label, add_node,
        #: set_node_labels_direct) stay up: measurement and scenario
        #: input must survive the fault they script.
        self.blackout = False
        #: inter-region latency skew (federation): a flat per-request
        #: delay on every API verb, slept OUTSIDE the store lock so a
        #: slow region slows its callers, never its own event fan-out
        self.response_delay_s = 0.0
        # Write accounting (ISSUE 6 satellite): batching merges several
        # LOGICAL mutations into one HTTP round trip, so "requests" and
        # "mutations" are now different numbers — counting only requests
        # would let batching silently inflate the per-request economics
        # bench.py reports. ``node_write_requests`` counts node-write API
        # calls (patch/replace, incl. 429-rejected ones — the server
        # still paid for them); ``node_write_mutations`` counts the
        # logical units those calls carried (label keys, annotation
        # keys, a taint-list change, a spec field).
        self.node_write_requests = 0
        self.node_write_mutations = 0
        #: node READ round trips (get_node + list_nodes): the number
        #: the informer refactor (ISSUE 11) drives to zero on the
        #: steady-state scan path — tests/test_shard.py pins it.
        #: peek_node_label is measurement surface and stays uncounted.
        self.node_read_requests = 0
        #: when set, idle watches emit BOOKMARK events at this cadence
        #: (like a real API server with allowWatchBookmarks), letting
        #: clients keep their resourceVersion current through
        #: other-object churn
        self.bookmark_every_s: Optional[float] = None
        #: core/v1 Events recorded via create_event: an append-ordered
        #: flat list (each event carries metadata.namespace)
        self.cluster_events: List[dict] = []
        #: cluster-scoped custom resources, keyed (group, plural, name).
        #: version is deliberately not part of the key: the fake serves
        #: one storage version, like a real API server does
        self._customs: Dict[Tuple[str, str, str], dict] = {}
        #: watch history for custom resources: (rv, type, group, plural,
        #: snapshot) — separate from the node history so node churn
        #: can't 410 a policy watcher
        self._custom_events: List[Tuple[int, str, str, str, dict]] = []
        #: coordination.k8s.io/v1 Leases, keyed (namespace, name)
        self._leases: Dict[Tuple[str, str], dict] = {}

    # ------------------------------------------------------------ helpers
    @property
    def _compact_chunk(self) -> int:
        """Compaction slack: histories trim only once they exceed
        limit + chunk (then back down to limit), amortizing the slice
        over a quarter-limit of writes instead of paying O(limit) per
        write. Derived from the LIVE limit so tests that shrink
        ``_history_limit`` get proportionally tight compaction."""
        return max(1, self._history_limit // 4)

    def _bump(self, obj: dict) -> None:
        self._rv += 1
        obj["metadata"]["resourceVersion"] = str(self._rv)

    def _record(self, etype: str, node: dict) -> None:
        self._events.append(
            _WatchEvent(self._rv, etype, copy.deepcopy(node))
        )
        self._event_rvs.append(self._rv)
        if len(self._events) > self._history_limit + self._compact_chunk:
            # chunked resourceVersion-window compaction: pay one slice
            # per chunk of writes, not per write
            self._events = self._events[-self._history_limit:]
            self._event_rvs = self._event_rvs[-self._history_limit:]
        self._lock.notify_all()

    def _events_after(self, rv: int) -> List[_WatchEvent]:
        """Retained node events with rv strictly greater than ``rv``
        (caller holds _lock). Binary search over the parallel rv list:
        a fleet of watchers rescanning the whole history linearly on
        every wakeup was O(history x watchers x writes) — the fake API
        server's own scaling wall at 256 live replicas."""
        i = bisect.bisect_right(self._event_rvs, rv)
        return self._events[i:]

    # ------------------------------------------------------- test surface
    def add_node(self, node: dict) -> dict:
        with self._lock:
            self._bump(node)
            self._nodes[node["metadata"]["name"]] = node
            self._record("ADDED", node)
            return copy.deepcopy(node)

    def add_pod(self, pod: dict) -> dict:
        with self._lock:
            self._bump(pod)
            self._pods[(pod["metadata"]["namespace"], pod["metadata"]["name"])] = pod
            return copy.deepcopy(pod)

    def compact_watch_history(self) -> None:
        """Drop all retained events: any resume from an old rv now 410s."""
        with self._lock:
            self._events = []
            self._event_rvs = []

    @property
    def latest_rv(self) -> str:
        with self._lock:
            return str(self._rv)

    def node_write_stats(self) -> dict:
        """Snapshot of the node-write accounting: HTTP-round-trip
        ``requests`` vs the ``mutations`` (logical label/annotation/
        taint/spec units) they carried. The gap between the two IS the
        coalescing win — bench.py reports both."""
        with self._lock:
            return {
                "requests": self.node_write_requests,
                "mutations": self.node_write_mutations,
            }

    def peek_node_label(self, name: str, key: str):
        """Measurement-only read of one node label WITHOUT the full-node
        deepcopy ``get_node`` pays: bench/simlab convergence pollers call
        this at tens of Hz per node, and deepcopying evidence-laden node
        objects inside the store lock was measurement load distorting
        the system under test."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise ApiException(404, f"node {name} not found")
            return (node["metadata"].get("labels") or {}).get(key)

    def _fault_gate(self) -> None:
        """Region-fault front door, called at the ENTRY of every API
        verb BEFORE the lock: latency skew sleeps here (out of lock —
        a slow region must not serialize its own watchers), then a
        blackout answers 503 like a dead regional control plane."""
        delay = self.response_delay_s
        if delay:
            time.sleep(delay)
        if self.blackout:
            raise ApiException(503, "injected regional API blackout")

    def _check_node_write_fault(self) -> None:
        """429 the next N node writes when armed (caller holds _lock)."""
        self.node_write_requests += 1
        if self.fail_next_node_writes > 0:
            self.fail_next_node_writes -= 1
            raise ApiException(429, "injected node-write overload")

    @staticmethod
    def _mutation_units(old: dict, new: dict) -> int:
        """Logical mutation units between two node objects: changed/
        removed label keys + annotation keys + 1 per changed spec
        field. resourceVersion/managed metadata moves don't count."""
        units = 0
        for field in ("labels", "annotations"):
            a = (old.get("metadata") or {}).get(field) or {}
            b = (new.get("metadata") or {}).get(field) or {}
            keys = set(a) | set(b)
            units += sum(1 for k in keys if a.get(k) != b.get(k))
        old_spec = old.get("spec") or {}
        new_spec = new.get("spec") or {}
        for k in set(old_spec) | set(new_spec):
            if old_spec.get(k) != new_spec.get(k):
                units += 1
        return units

    # ------------------------------------------------------------- nodes
    def get_node(self, name: str) -> dict:
        self._fault_gate()
        with self._lock:
            self.node_read_requests += 1
            node = self._nodes.get(name)
            if node is None:
                raise ApiException(404, f"node {name} not found")
            return copy.deepcopy(node)

    def list_nodes(self, label_selector: Optional[str] = None) -> List[dict]:
        self._fault_gate()
        with self._lock:
            self.node_read_requests += 1
            if self.fail_next_lists > 0:
                self.fail_next_lists -= 1
                raise ApiException(429, "injected list overload")
            return [
                copy.deepcopy(n)
                for n in self._nodes.values()
                if match_selector(n["metadata"].get("labels", {}), label_selector)
            ]

    def list_nodes_page(
        self,
        label_selector: Optional[str] = None,
        limit: Optional[int] = None,
        cont: Optional[str] = None,
    ) -> Tuple[List[dict], Optional[str]]:
        """Chunked LIST: (items, continue_token). Name-ordered like the
        real API server; the token encodes the resume position."""
        return _paginate(self.list_nodes(label_selector), limit, cont)

    def set_node_labels_direct(
        self, name: str,
        labels: Dict[str, Optional[str]],
        annotations: Optional[Dict[str, Optional[str]]] = None,
    ) -> dict:
        """Operator hand-of-god label write for scenario/bench drivers:
        bypasses write-fault injection and the write accounting (it is
        the scenario's INPUT, not system-under-test traffic) while
        still bumping the resourceVersion and emitting a watch event
        like any real write — a driver that wrote through the faulted
        path would soak the very storm it scripted. ``annotations``
        ride the same write (the simlab driver stamps its cc.trace
        context exactly like a real controller: in ONE write with the
        desired label)."""
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise ApiException(404, f"node {name} not found")
            meta: Dict[str, object] = {"labels": labels}
            if annotations:
                meta["annotations"] = annotations
            merged = merge_patch(node, {"metadata": meta})
            merged["metadata"]["name"] = name
            self._nodes[name] = merged
            self._bump(merged)
            self._record("MODIFIED", merged)
            return copy.deepcopy(merged)

    def patch_node(self, name: str, patch: dict) -> dict:
        self._fault_gate()
        if self.patch_delay_s:
            time.sleep(self.patch_delay_s)
        with self._lock:
            node = self._nodes.get(name)
            if node is None:
                raise ApiException(404, f"node {name} not found")
            self._check_node_write_fault()
            merged = merge_patch(node, patch)
            merged["metadata"]["name"] = name  # name is immutable
            self.node_write_mutations += self._mutation_units(node, merged)
            self._nodes[name] = merged
            self._bump(merged)
            self._record("MODIFIED", merged)
            return copy.deepcopy(merged)

    def replace_node(self, name: str, node: dict) -> dict:
        self._fault_gate()
        with self._lock:
            cur = self._nodes.get(name)
            if cur is None:
                raise ApiException(404, f"node {name} not found")
            self._check_node_write_fault()
            if node["metadata"].get("resourceVersion") != cur["metadata"]["resourceVersion"]:
                raise ConflictError(
                    f"rv {node['metadata'].get('resourceVersion')} != "
                    f"{cur['metadata']['resourceVersion']}"
                )
            new = copy.deepcopy(node)
            new["metadata"]["name"] = name
            self.node_write_mutations += self._mutation_units(cur, new)
            self._nodes[name] = new
            self._bump(new)
            self._record("MODIFIED", new)
            return copy.deepcopy(new)

    # ------------------------------------------------------------- leases
    def get_lease(self, namespace: str, name: str) -> dict:
        self._fault_gate()
        with self._lock:
            lease = self._leases.get((namespace, name))
            if lease is None:
                raise ApiException(404, f"lease {namespace}/{name} not found")
            return copy.deepcopy(lease)

    def create_lease(self, namespace: str, lease: dict) -> dict:
        self._fault_gate()
        with self._lock:
            name = lease["metadata"]["name"]
            if (namespace, name) in self._leases:
                raise ApiException(
                    409, f"lease {namespace}/{name} already exists"
                )
            new = copy.deepcopy(lease)
            new["metadata"]["namespace"] = namespace
            self._bump(new)
            self._leases[(namespace, name)] = new
            return copy.deepcopy(new)

    def replace_lease(self, namespace: str, name: str,
                      lease: dict) -> dict:
        self._fault_gate()
        with self._lock:
            cur = self._leases.get((namespace, name))
            if cur is None:
                raise ApiException(404, f"lease {namespace}/{name} not found")
            if (lease["metadata"].get("resourceVersion")
                    != cur["metadata"]["resourceVersion"]):
                # the CAS two would-be leaders race on: exactly one
                # replace lands per observed rv
                raise ConflictError(
                    f"rv {lease['metadata'].get('resourceVersion')} != "
                    f"{cur['metadata']['resourceVersion']}"
                )
            new = copy.deepcopy(lease)
            new["metadata"]["name"] = name
            new["metadata"]["namespace"] = namespace
            self._bump(new)
            self._leases[(namespace, name)] = new
            return copy.deepcopy(new)

    # -------------------------------------------------------------- pods
    def list_pods(
        self,
        namespace: str,
        label_selector: Optional[str] = None,
        field_selector: Optional[str] = None,
    ) -> List[dict]:
        node_name = None
        if field_selector:
            for term in field_selector.split(","):
                if term.startswith("spec.nodeName="):
                    node_name = term.split("=", 1)[1]
        with self._lock:
            out = []
            for (ns, _), pod in self._pods.items():
                if ns != namespace:
                    continue
                if not match_selector(pod["metadata"].get("labels", {}), label_selector):
                    continue
                if node_name and pod["spec"].get("nodeName") != node_name:
                    continue
                out.append(copy.deepcopy(pod))
            return out

    def list_pods_page(
        self,
        namespace: str,
        label_selector: Optional[str] = None,
        field_selector: Optional[str] = None,
        limit: Optional[int] = None,
        cont: Optional[str] = None,
    ) -> Tuple[List[dict], Optional[str]]:
        return _paginate(
            self.list_pods(namespace, label_selector, field_selector), limit, cont
        )

    def delete_pod(self, namespace: str, name: str) -> None:
        with self._lock:
            if (namespace, name) not in self._pods:
                raise ApiException(404, f"pod {namespace}/{name} not found")
            del self._pods[(namespace, name)]
            self._lock.notify_all()

    def evict_pod(self, namespace: str, name: str) -> None:
        self._fault_gate()
        with self._lock:
            if (namespace, name) in self.pdb_blocked:
                raise ApiException(429, "Cannot evict pod: PodDisruptionBudget")
            if (namespace, name) not in self._pods:
                raise ApiException(404, f"pod {namespace}/{name} not found")
            del self._pods[(namespace, name)]
            self._lock.notify_all()

    def create_event(self, namespace: str, event: dict) -> dict:
        self._fault_gate()
        with self._lock:
            stored = copy.deepcopy(event)
            body_ns = stored.get("metadata", {}).get("namespace")
            if body_ns is not None and body_ns != namespace:
                # real apiserver rule: event.namespace must match the
                # request path's namespace
                raise ApiException(
                    400,
                    f"the namespace of the object ({body_ns}) does not "
                    f"match the namespace on the request ({namespace})",
                )
            stored.setdefault("metadata", {})["namespace"] = namespace
            self._rv += 1
            stored["metadata"]["resourceVersion"] = str(self._rv)
            self.cluster_events.append(stored)
            if len(self.cluster_events) > (self._history_limit
                                           + self._compact_chunk):
                # same chunked bound as the watch history: a long
                # simlab run's Event stream must not grow memory
                # forever (ISSUE 11 satellite)
                self.cluster_events = (
                    self.cluster_events[-self._history_limit:]
                )
            return copy.deepcopy(stored)

    def list_events(self, namespace: str) -> List[dict]:
        with self._lock:
            return [
                copy.deepcopy(e) for e in self.cluster_events
                if e["metadata"]["namespace"] == namespace
            ]

    # ------------------------------------------------- custom resources
    def add_custom(self, group: str, plural: str, obj: dict) -> dict:
        """Create a cluster-scoped custom resource (test surface, the
        ``kubectl apply`` analog)."""
        with self._lock:
            stored = copy.deepcopy(obj)
            stored.setdefault("metadata", {}).setdefault("generation", 1)
            self._bump(stored)
            self._customs[(group, plural, stored["metadata"]["name"])] = stored
            self._record_custom("ADDED", group, plural, stored)
            return copy.deepcopy(stored)

    def list_cluster_custom(
        self, group: str, version: str, plural: str
    ) -> List[dict]:
        self._fault_gate()
        with self._lock:
            return sorted(
                (
                    copy.deepcopy(o)
                    for (g, p, _), o in self._customs.items()
                    if g == group and p == plural
                ),
                key=lambda o: o["metadata"]["name"],
            )

    def get_cluster_custom(
        self, group: str, version: str, plural: str, name: str
    ) -> dict:
        self._fault_gate()
        with self._lock:
            obj = self._customs.get((group, plural, name))
            if obj is None:
                raise ApiException(
                    404, f"{plural}.{group} {name!r} not found"
                )
            return copy.deepcopy(obj)

    def patch_cluster_custom(
        self,
        group: str,
        version: str,
        plural: str,
        name: str,
        patch: dict,
        subresource: Optional[str] = None,
    ) -> dict:
        self._fault_gate()
        with self._lock:
            cur = self._customs.get((group, plural, name))
            if cur is None:
                raise ApiException(
                    404, f"{plural}.{group} {name!r} not found"
                )
            if subresource == "status":
                # status subresource: only .status moves; spec/metadata in
                # the patch body are ignored and generation never bumps
                # (the real API server's subresource contract)
                merged = merge_patch(
                    cur, {"status": patch.get("status", {})}
                )
            elif subresource:
                raise ApiException(
                    404, f"subresource {subresource!r} not served"
                )
            else:
                # main resource: status in the patch is ignored (it has a
                # subresource), and a spec change bumps the generation —
                # observedGeneration bookkeeping depends on this
                body = {k: v for k, v in patch.items() if k != "status"}
                merged = merge_patch(cur, body)
                if merged.get("spec") != cur.get("spec"):
                    gen = merged["metadata"].get("generation", 1)
                    merged["metadata"]["generation"] = gen + 1
            merged["metadata"]["name"] = name
            self._customs[(group, plural, name)] = merged
            self._bump(merged)
            self._record_custom("MODIFIED", group, plural, merged)
            return copy.deepcopy(merged)

    def _record_custom(self, etype: str, group: str, plural: str,
                       obj: dict) -> None:
        self._custom_events.append(
            (self._rv, etype, group, plural, copy.deepcopy(obj))
        )
        if len(self._custom_events) > (self._history_limit
                                       + self._compact_chunk):
            self._custom_events = self._custom_events[-self._history_limit:]
        self._lock.notify_all()

    def watch_cluster_custom(
        self,
        group: str,
        version: str,
        plural: str,
        resource_version: Optional[str] = None,
        timeout_s: int = 300,
    ) -> Iterator[Tuple[str, dict]]:
        """Watch one cluster-scoped CR collection; the same rv / replay
        / server-timeout semantics as watch_nodes. No 410 compaction
        model here (policy objects are few and slow-moving); a caller
        that falls behind simply re-lists."""
        self._fault_gate()
        deadline = time.monotonic() + timeout_s
        last_rv = int(resource_version) if resource_version is not None else None
        while True:
            if self.blackout:
                # sever in-flight CR watches too: a blacked-out region
                # streams nothing
                raise ApiException(503, "injected regional API blackout")
            with self._lock:
                if last_rv is None:
                    last_rv = self._rv
                pending = [
                    (rv, t, obj)
                    for (rv, t, g, p, obj) in self._custom_events
                    if rv > last_rv and g == group and p == plural
                ]
                if self._custom_events:
                    last_rv = max(last_rv, self._custom_events[-1][0])
                if not pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return
                    self._lock.wait(timeout=min(remaining, 0.5))
                    continue
            for rv, etype, obj in pending:
                yield etype, copy.deepcopy(obj)

    # ------------------------------------------------------------- watch
    def _watch_stream(
        self,
        name: Optional[str],
        resource_version: Optional[str],
        timeout_s: float,
        allow_bookmarks: bool,
    ) -> Iterator[Tuple[str, object]]:
        """Shared watch core: yields ``("EVENT", _WatchEvent)`` and
        ``("BOOKMARK", node_dict)`` — :meth:`watch_nodes` (clientset
        shape) and :meth:`watch_nodes_wire` (pre-encoded apiserver fan
        out) are thin views over it, so the rv/410/timeout semantics
        cannot drift between the two."""
        self._fault_gate()
        with self._lock:
            if self.fail_next_watches > 0:
                self.fail_next_watches -= 1
                raise ApiException(500, "injected watch failure")
        deadline = time.monotonic() + timeout_s
        last_rv = int(resource_version) if resource_version is not None else None
        last_bookmark = time.monotonic()
        establishing = True

        while True:
            if self.blackout:
                # sever the in-flight stream: a blacked-out region's
                # watchers see a broken watch and retry into the 503s
                raise ApiException(503, "injected regional API blackout")
            bookmark = None
            with self._lock:
                if last_rv is None:
                    # no rv: start from "now", like an unversioned k8s watch
                    last_rv = self._rv
                elif establishing:
                    # staleness is judged at watch establishment only: once
                    # streaming, this generator examines every event (even
                    # ones the name filter drops), so later compaction of
                    # already-examined history must not kill a live stream
                    oldest_retained = self._events[0].rv if self._events else self._rv + 1
                    if last_rv + 1 < oldest_retained and last_rv < self._rv:
                        # requested window fell out of history
                        raise ApiException(410, "too old resource version")
                establishing = False
                pending = [
                    ev
                    for ev in self._events_after(last_rv)
                    if name is None or ev.obj["metadata"]["name"] == name
                ]
                if self._events:
                    # everything currently retained has now been examined
                    last_rv = max(last_rv, self._events[-1].rv)
                if not pending:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return  # server-side watch timeout: clean stream end
                    if (
                        allow_bookmarks
                        and self.bookmark_every_s is not None
                        and time.monotonic() - last_bookmark
                        >= self.bookmark_every_s
                    ):
                        # fast-forward the client past churn it filtered
                        # out (other nodes, pods) so a reconnect from this
                        # rv stays inside retained history
                        last_bookmark = time.monotonic()
                        last_rv = self._rv
                        bookmark = {
                            "kind": "Node",
                            "apiVersion": "v1",
                            "metadata": {
                                "name": name or "",
                                "resourceVersion": str(self._rv),
                            },
                        }
                    else:
                        self._lock.wait(timeout=min(remaining, 0.5))
                        continue
            if bookmark is not None:
                yield "BOOKMARK", bookmark
                continue
            for ev in pending:
                last_rv = max(last_rv, ev.rv)
                yield "EVENT", ev

    def watch_nodes(
        self,
        name: Optional[str] = None,
        resource_version: Optional[str] = None,
        timeout_s: int = 300,
        allow_bookmarks: bool = True,
    ) -> Iterator[Tuple[str, dict]]:
        for kind, item in self._watch_stream(
            name, resource_version, timeout_s, allow_bookmarks
        ):
            if kind == "BOOKMARK":
                yield "BOOKMARK", item  # type: ignore[misc]
            else:
                yield item.etype, copy.deepcopy(item.obj)  # type: ignore[union-attr]

    def watch_nodes_wire(
        self,
        name: Optional[str] = None,
        resource_version: Optional[str] = None,
        timeout_s: float = 300,
        allow_bookmarks: bool = True,
    ) -> Iterator[bytes]:
        """The apiserver's fan-out path: NDJSON watch lines with the
        per-event encode paid ONCE fleet-wide (``_WatchEvent.wire``),
        instead of once per watcher per event. Bookmarks are per-stream
        (they carry the stream's name) and stay encoded ad hoc."""
        for kind, item in self._watch_stream(
            name, resource_version, timeout_s, allow_bookmarks
        ):
            if kind == "BOOKMARK":
                yield json.dumps(
                    {"type": "BOOKMARK", "object": item}
                ).encode() + b"\n"
            else:
                yield item.wire()  # type: ignore[union-attr]
