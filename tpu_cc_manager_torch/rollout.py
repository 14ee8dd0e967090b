"""Rolling pool-wide mode changes — the operator-side orchestrator.

The reference has no pool-level tooling at all: an admin labels nodes by
hand (reference README_PYTHON.md:77-102) and every agent flips the moment
it sees its label, so a pool-wide change takes the whole pool's TPU
workloads down at once. This module adds the controlled rollout BASELINE
config 3 describes ("4-node v5e GKE pool: rolling CC enable with pod
eviction"): patch desired-state labels group by group, bounded by a
disruption window, watching the observed-state labels the agents publish.

Semantics:

- **Unit of rollout = slice group.** All member nodes of a multi-host
  slice receive the desired label in the same step — a slice flips
  coherently (tpu_cc_manager.slice_coord), so staggering its members
  would just park the early ones in ``slice_wait``. Nodes without a
  slice label are singleton groups.
- **Window.** Up to ``max_unavailable`` groups are in flight at once. A
  group completes when every member's ``cc.mode.state`` label reaches
  the target mode; it fails when any member publishes ``failed`` or the
  group times out.
- **Failure budget.** Each failed group consumes budget; when exhausted,
  no further groups launch (in-flight groups drain), remaining groups
  are reported ``not_attempted``, and the rollout is ``aborted``.
- **Preflight.** The JAX fleet planner (tpu_cc_manager.plan) audits the
  pool first; failed nodes or half-flipped slices fail fast unless
  ``force`` — rolling a new mode over a broken fleet only hides the
  breakage.
- **Durable record + resume.** The rollout's identity, parameters, group
  plan, and per-group outcomes are persisted to the
  ``tpu.google.com/cc.rollout`` annotation on the pool's anchor node
  (the lexicographically smallest member — the same durable-location
  convention slice commits use) at every state transition, with group
  *intent* written before the labels are patched. An operator-side crash
  therefore loses nothing that matters: ``rollout --resume``
  reconstructs the window, the remaining budget, and the not-yet-judged
  groups from cluster state, relaunches the groups that were in flight
  (label patches are idempotent), and produces ONE coherent final
  report with every group counted exactly once. A second concurrent
  rollout is refused while an unfinished record exists.
- **Liveness heartbeat + ownership fencing.** A running rollout stamps
  the record every few seconds; automatic adopters (the policy
  controller) only resume records whose heartbeat they have OBSERVED
  sitting unchanged for a full window on their own clock (wall-clock
  comparison would break under cross-host skew) — a live human-run
  rollout is never hijacked. Adoption seizes the record's ``owner``
  field, and every subsequent persist by any writer fences against it:
  a revived original owner stops with :class:`OwnershipLostError` at
  its next persist instead of clobbering the adopter. Manual
  ``--resume`` deliberately ignores liveness: the human asserting the
  old run is dead outranks it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.k8s.client import ApiException, KubeClient
from tpu_cc_manager_torch.modes import parse_mode
from tpu_cc_manager_torch.plan import analyze_fleet
from tpu_cc_manager_torch.trace import format_traceparent, get_tracer

log = logging.getLogger("tpu-cc-manager.rollout")


class RolloutError(Exception):
    """Preflight or configuration problem; nothing was patched."""


#: Group outcomes that consume failure budget.
_BUDGET_CONSUMING = ("failed", "timeout")
#: Group outcomes that are final (never re-attempted on resume).
_TERMINAL = ("skipped", "succeeded", "failed", "timeout", "not_attempted")

#: How often a LIVE rollout stamps record["heartbeat"]. An unfinished
#: record whose heartbeat keeps CHANGING belongs to a running
#: operator/controller; automatic adoption (policy controller) must
#: leave it alone. Staleness is judged by OBSERVATION — the adopter
#: watches whether the value changes across its own scans on its own
#: monotonic clock — never by comparing the stamp against local
#: wall-clock time (the stamping process may run on an operator
#: workstation whose clock is skewed vs the controller pod). Manual
#: ``rollout --resume`` ignores liveness entirely: the human asserting
#: the old run is dead outranks it.
HEARTBEAT_PERIOD_S = 5.0
#: How long an adopter must observe an UNCHANGED heartbeat before the
#: record counts as abandoned.
HEARTBEAT_STALE_S = 30.0

#: Durable-record schema version (the rollout-record sibling of
#: evidence.EVIDENCE_VERSION): bump on any incompatible change to the
#: record's SHAPE. The record is cluster state parsed by every future
#: controller version, so skew is a fact of life during rolling
#: controller upgrades: records WITHOUT a version (written by
#: pre-versioning controllers) read as v1; records from the FUTURE (a
#: newer controller evolved the shape) are refused loudly by
#: resume/adoption — misparsing them could silently drop or corrupt a
#: resumable rollout — while the concurrent-rollout guard still honors
#: them (their existence is meaningful even when their shape is not
#: parseable).
ROLLOUT_RECORD_VERSION = 1


def rollout_record_version(record: dict) -> int:
    """The schema version a record claims: versionless = v1 (the shape
    every pre-versioning controller wrote); an unparseable version is
    treated as from the future — whatever wrote it, it was not any
    released controller, so refusing beats guessing."""
    v = record.get("version", 1)
    try:
        return int(v)
    except (TypeError, ValueError):
        return ROLLOUT_RECORD_VERSION + 1


class OwnershipLostError(RolloutError):
    """Another process took over this rollout's durable record (the
    fencing check in ``_persist`` saw a foreign owner). This process
    must stop driving immediately — patching labels or judging groups
    past this point would mean two writers on the same rollout."""


def load_rollout_record(kube: KubeClient, nodes: Sequence[dict]
                        ) -> Tuple[Optional[dict], Optional[str]]:
    """The rollout record that MATTERS on these nodes -> (record, node):
    an unfinished record always wins over a newer complete one (in a
    multi-pool cluster, pool B finishing a rollout must not mask pool
    A's crashed-and-resumable record, for either --resume or the
    concurrent-rollout guard); among several of the same completeness,
    newest started wins. Scanning every node (not just the current
    anchor) tolerates the anchor changing between rollouts."""
    best: Optional[dict] = None
    best_node: Optional[str] = None
    for n in nodes:
        raw = (n["metadata"].get("annotations") or {}).get(
            L.ROLLOUT_ANNOTATION)
        if not raw:
            continue
        try:
            rec = json.loads(raw)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        better = (
            best is None
            or (best.get("complete") and not rec.get("complete"))
            or (bool(best.get("complete")) == bool(rec.get("complete"))
                and rec.get("started", 0) > best.get("started", 0))
        )
        if better:
            best, best_node = rec, n["metadata"]["name"]
    return best, best_node


def load_rollout_records(kube: KubeClient, nodes: Sequence[dict]
                         ) -> List[Tuple[dict, str]]:
    """EVERY distinct rollout record on these nodes -> [(record,
    anchor node)]. With concurrent per-pool rollouts there can be one
    unfinished record per disjoint pool; callers that schedule
    (adoption, the concurrency guard) must see all of them, not the
    single 'best' one ``load_rollout_record`` picks for resume.
    Deduped by record id (an id lives on one anchor; if churn ever
    duplicates it, the copy with the newest heartbeat wins)."""
    by_id: Dict[str, Tuple[dict, str]] = {}
    for n in nodes:
        raw = (n["metadata"].get("annotations") or {}).get(
            L.ROLLOUT_ANNOTATION)
        if not raw:
            continue
        try:
            rec = json.loads(raw)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        rid = str(rec.get("id"))
        prev = by_id.get(rid)
        if prev is None or (
            (rec.get("heartbeat") or 0) > (prev[0].get("heartbeat") or 0)
        ):
            by_id[rid] = (rec, n["metadata"]["name"])
    return sorted(by_id.values(), key=lambda t: t[0].get("started", 0))


def record_node_names(record: dict) -> set:
    """The node names a record's rollout touches (union of its groups'
    members). Empty for shapes this version cannot parse (future
    schema, missing groups) — callers treat empty as UNKNOWN scope and
    act conservatively (block everything), never as 'touches
    nothing'."""
    names: set = set()
    groups = record.get("groups")
    if isinstance(groups, dict):
        for g in groups.values():
            if isinstance(g, dict):
                for m in g.get("nodes") or []:
                    names.add(m)
    return names


def desired_patch_body(mode: str, traceparent: Optional[str]) -> dict:
    """The canonical desired-write patch: desired-mode label plus the
    trace annotation IN THE SAME WRITE (zero extra round trips; the
    agent's reconcile adopts the trace id from the patch that caused
    it). Every code path that sets desired state — the rollout engine's
    group launch, federation's per-region posture writes — must build
    its patch here, or the flight-recorder stitch loses the
    desired-write → state-publish edge. ``traceparent=None`` clears a
    stale annotation (rollback paths)."""
    return {"metadata": {
        "labels": {L.CC_MODE_LABEL: mode},
        "annotations": {L.CC_TRACE_ANNOTATION: traceparent},
    }}


@dataclasses.dataclass
class GroupResult:
    name: str
    nodes: List[str]
    #: skipped | planned | succeeded | failed | timeout | not_attempted
    #: | stopped — ``stopped`` marks groups left behind by a cooperative
    #: stop (leader demotion): intentionally unfinished, the durable
    #: record stays adoptable, and the group is NOT a failure
    outcome: str
    detail: str = ""

    def to_dict(self) -> dict:
        d = {"name": self.name, "nodes": self.nodes, "outcome": self.outcome}
        if self.detail:
            d["detail"] = self.detail
        return d


@dataclasses.dataclass
class RolloutReport:
    mode: str
    groups: List[GroupResult]
    aborted: bool
    preflight: dict
    #: True when the rollout exited via a cooperative stop (leader
    #: demotion) rather than finishing or aborting on failures. The
    #: report is still not ``ok`` — work remains — but the durable
    #: record was intentionally left unfinished for adoption, so
    #: consumers must read this as a handoff, not a failure.
    stopped_early: bool = False
    stop_reason: str = ""

    @property
    def failed(self) -> List[str]:
        return [g.name for g in self.groups if g.outcome in ("failed", "timeout")]

    @property
    def succeeded(self) -> List[str]:
        return [g.name for g in self.groups if g.outcome == "succeeded"]

    @property
    def stopped(self) -> List[str]:
        """Groups handed off unfinished by a cooperative stop."""
        return [g.name for g in self.groups if g.outcome == "stopped"]

    @property
    def ok(self) -> bool:
        return not self.aborted and not self.failed

    def to_dict(self) -> dict:
        out = {
            "mode": self.mode,
            "ok": self.ok,
            "aborted": self.aborted,
            "groups": [g.to_dict() for g in self.groups],
            "preflight": self.preflight,
        }
        if self.stopped_early:
            out["stopped_early"] = True
            out["stop_reason"] = self.stop_reason
        return out

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)


class Rollout:
    def __init__(
        self,
        kube: KubeClient,
        mode: str,
        *,
        selector: str = L.TPU_ACCELERATOR_LABEL,
        max_unavailable: int = 1,
        failure_budget: int = 0,
        canary: int = 0,
        group_timeout_s: float = 600.0,
        poll_s: float = 0.5,
        force: bool = False,
        dry_run: bool = False,
        verify_evidence: bool = True,
        on_group=None,
        informer=None,
    ):
        #: optional progress hook called after every group reaches a
        #: terminal outcome: on_group(name, outcome, done, total).
        #: Exceptions are swallowed — a broken observer must not fail
        #: the rollout.
        self.on_group = on_group
        self.kube = kube
        self.mode = parse_mode(mode).value  # reject bad input before any patch
        self.selector = selector
        if max_unavailable < 1:
            raise RolloutError("max_unavailable must be >= 1")
        self.max_unavailable = max_unavailable
        self.failure_budget = failure_budget
        if canary < 0:
            raise RolloutError("canary must be >= 0")
        #: first ``canary`` to-run groups launch serially (window 1)
        #: and must each SUCCEED before the configured window opens; any
        #: canary failure/timeout aborts the rollout outright (the
        #: failure budget never excuses a canary — it exists to prove
        #: the flip before the blast radius widens)
        self.canary = canary
        self.group_timeout_s = group_timeout_s
        self.poll_s = poll_s
        self.force = force
        self.dry_run = dry_run
        #: Cross-check converged groups against their attestation
        #: evidence: a member whose label claims the target while its
        #: PRESENT evidence is invalid or attests another mode does not
        #: count as converged (it resolves via the group timeout, with
        #: the evidence problem in the detail). Missing evidence is
        #: accepted — agents predating the evidence feature must not
        #: brick a rollout.
        self.verify_evidence = verify_evidence
        if verify_evidence:
            from tpu_cc_manager_torch.evidence import evidence_keys

            #: resolved once: the key set is static for the process, and
            #: the judge tick must not re-read the key file every poll.
            #: The full set (primary + rotation tail), so a mid-rotation
            #: fleet's old-key evidence still counts as converged
            self._evidence_key = evidence_keys() or None
            self._warned_no_key = False
            self._warned_unsigned = False
            self._warned_attestation_unverifiable = False
        #: member -> why its evidence was rejected, for actionable
        #: timeout verdicts (unsigned-under-key names the manifest fix)
        self._suspect_reasons: Dict[str, str] = {}
        #: the evidence check's identity and attestation judges: seconds
        #: in each (identity_s, attestation_s) and each verdict's count
        #: (id_<verdict>, att_<verdict>); the group plan's span reports
        #: them for its checks
        self._judge_stats: Dict[str, float] = {}
        #: the group plan's evidence documents as its RS256 pre-pass
        #: parsed them, node -> (annotation, document); empty elsewhere
        self._parsed: Dict[str, Tuple[str, dict]] = {}
        #: total groups this run will judge (set once planning is done);
        #: the progress hook's denominator
        self._planned_total: Optional[int] = None
        #: cooperative stop (leader demotion): the driver stops
        #: launching/judging and leaves the durable record UNFINISHED,
        #: so the new leader adopts it via the heartbeat-staleness path
        #: instead of two leaders driving the same record
        self._stop_requested = threading.Event()
        self._stop_reason = ""
        #: durable-record state (anchor-node annotation); set by run()
        self._record: Optional[dict] = None
        self._record_node: Optional[str] = None
        self._resume_from: Optional[Tuple[dict, str]] = None
        self._last_heartbeat = 0.0
        import uuid as _uuid

        #: fencing identity: stamped into the record; _persist refuses
        #: to overwrite a record another owner has claimed
        self._owner = _uuid.uuid4().hex[:12]
        #: set by resume(): the first persist claims the record from its
        #: previous (presumed-dead) owner instead of fencing against it
        self._force_claim = False
        #: canary groups still to prove (set by run(); persisted in the
        #: record so a resumed rollout keeps its canary discipline)
        self._canary_left = 0
        #: optional watch.NodeInformer (or anything with subscribe/
        #: unsubscribe/list_nodes/get_node/primed/stats): the judge's
        #: event feed. When wired and healthy, in-flight groups are
        #: judged INSIDE the delta callback off the shared watch
        #: stream, the driving loop blocks on ``_wake`` instead of
        #: sleeping out ``poll_s``, and the liveness-fallback judge
        #: tick reads the informer's in-memory cache — steady-state
        #: judging performs ZERO node read round trips (pinned by
        #: tests/test_rollout.py against FakeKube.node_read_requests).
        #: ``poll_s`` survives only as the liveness fallback cadence
        #: and the group-timeout clock. See docs/rollout.md.
        self.informer = informer
        #: wakes the driving loop: set by the delta callback when a
        #: group reaches a terminal outcome (so the next group's
        #: desired writes launch from THIS wake, not the next tick)
        #: and by request_stop
        self._wake = threading.Event()
        #: guards every judge-shared structure below — the delta
        #: callback (informer delivery thread) and the driving loop
        #: both judge; the lock is what makes a delta-fed judge racing
        #: the group timeout pick exactly ONE terminal outcome
        self._judge_lock = threading.Lock()
        #: gname -> (members, monotonic deadline, stale_failed set)
        self._in_flight: Dict[str, Tuple[List[str], float, set]] = {}
        #: member node name -> its in-flight group
        self._watched: Dict[str, str] = {}
        #: member -> newest observed node object (seeded at launch,
        #: updated by label-change deltas / cache refreshes)
        self._live: Dict[str, dict] = {}
        #: delta- or tick-judged terminal GroupResults awaiting the
        #: driving loop's settlement (record persist, budget, canary)
        self._ready: deque = deque()  # ccaudit: allow-unbounded-queue(holds at most the in-flight group cohort: a group enters once, on its terminal judgement, and max_in_flight bounds the cohort)
        self._feed_token = None
        #: monotonic stamp of the last settled terminal outcome; the
        #: next launch turns it into one advance-latency sample
        self._last_terminal_at: Optional[float] = None
        #: observable judge economics (the bench's rollout_advance_p50_s
        #: and zero-read-pin source): judge_ticks = fallback passes
        #: served from the informer cache; judge_node_reads = REAL
        #: LIST round trips the judge paid (degraded/legacy mode
        #: only); delta_judges = judgements run inside the delta
        #: callback; advance_latencies_s = group terminal -> next
        #: group's first desired write (bounded ring)
        self.stats: Dict[str, object] = {
            "judge_ticks": 0,
            "judge_node_reads": 0,
            "delta_judges": 0,
            "advance_latencies_s": deque(maxlen=512),
        }

    @classmethod
    def resume(
        cls,
        kube: KubeClient,
        *,
        selector: Optional[str] = None,
        group_timeout_s: float = 600.0,
        poll_s: float = 0.5,
        dry_run: bool = False,
        verify_evidence: bool = True,
        on_group=None,
        record: Optional[dict] = None,
        record_node: Optional[str] = None,
        informer=None,
    ) -> "Rollout":
        """Rebuild a Rollout from the pool's unfinished durable record.
        Mode, window, budget, AND selector come from the record (the
        record persists the selector precisely so the resumed run scopes
        the same node set); ``force`` is implied (a mid-rollout pool
        legitimately contains half-flipped slices — that's what is being
        resumed). ``dry_run`` previews the resume without patching.
        ``record``/``record_node`` PIN the record to resume: with
        concurrent per-pool rollouts a cluster can hold several
        unfinished records, and a scheduling caller (policy adoption)
        that already chose one must not have the search below pick a
        different, newer one out from under it. An EXPLICIT
        ``selector`` scopes the search to that pool only: when its
        record is complete, resume refuses rather than wandering
        cluster-wide and force-claiming some OTHER pool's rollout —
        possibly a live one — out from under its driver."""
        if record is not None and record_node is not None:
            pass  # pinned by the caller
        else:
            explicit = selector is not None
            nodes = kube.list_nodes(
                selector if explicit else L.TPU_ACCELERATOR_LABEL
            )
            record, record_node = load_rollout_record(kube, nodes)
            if not explicit and (record is None
                                 or record.get("complete")):
                # unscoped resume: the record's anchor may sit outside
                # the default pool (original rollout used a different
                # selector), or — with per-pool concurrent records —
                # the default pool's own COMPLETE record may mask an
                # unfinished one on another pool: scan the cluster. An
                # EXPLICIT selector never widens, even when its pool
                # shows nothing — a typo'd or churned-away selector
                # must not land on some OTHER pool's record and
                # force-claim a live rollout from its driver.
                record, record_node = load_rollout_record(
                    kube, kube.list_nodes(None)
                )
        if record is None or record.get("complete"):
            raise RolloutError("no unfinished rollout to resume on this pool")
        ver = rollout_record_version(record)
        if ver > ROLLOUT_RECORD_VERSION:
            raise RolloutError(
                f"rollout record {record.get('id')!r} has schema "
                f"version {ver}, newer than this controller's supported "
                f"v{ROLLOUT_RECORD_VERSION}: a newer controller wrote "
                "it; upgrade this controller (or let the newer one "
                "finish) instead of resuming with a shape this version "
                "cannot parse safely"
            )
        r = cls(
            kube, record["mode"],
            # a legacy record without a persisted selector must scope
            # to the default TPU pool, never to None (= every node in
            # the cluster — a resume would drain and flip non-TPU
            # nodes)
            selector=(record.get("selector") or selector
                      or L.TPU_ACCELERATOR_LABEL),
            max_unavailable=int(record.get("max_unavailable", 1)),
            failure_budget=int(record.get("failure_budget", 0)),
            group_timeout_s=group_timeout_s, poll_s=poll_s, force=True,
            dry_run=dry_run, verify_evidence=verify_evidence,
            on_group=on_group, informer=informer,
        )
        # a versionless (pre-versioning) record is adopted as v1: this
        # controller maintains a v1 shape from here on, and persists say
        # so explicitly
        record.setdefault("version", ROLLOUT_RECORD_VERSION)
        r._resume_from = (record, record_node)
        r._force_claim = True
        return r

    # ---------------------------------------------------------- durability
    def _persist(self) -> None:
        """Write the record annotation; best-effort against transport
        failures (a persist failure degrades resume fidelity, it must
        not fail the live rollout). Every persist stamps the liveness
        heartbeat, and FENCES first: the on-cluster record is re-read
        and, if another owner has claimed it (an adopter took over a
        rollout whose heartbeat looked stale — e.g. this process was
        stopped for a while), raises OwnershipLostError instead of
        clobbering the adopter's state. The read-check-write is not
        atomic, but it shrinks the two-writer window from 'forever'
        (blind overwrite) to one API round trip, and the loser stops at
        its very next persist."""
        if self._record is None or self._record_node is None:
            return
        if self._force_claim:
            # resume: deliberately seize the record from its previous
            # (presumed-dead) owner; every LATER persist fences normally,
            # protecting this adopter from the next one
            self._force_claim = False
        else:
            self._fence()
        self._record["owner"] = self._owner
        self._record["heartbeat"] = time.time()
        self._last_heartbeat = time.monotonic()
        try:
            payload = json.dumps(
                self._record, sort_keys=True, separators=(",", ":")
            )
            self.kube.set_node_annotations(
                self._record_node, {L.ROLLOUT_ANNOTATION: payload}
            )
        except ApiException as e:
            log.warning(
                "rollout record persist failed (resume fidelity "
                "degraded): %s", e,
            )

    def _fence(self) -> None:
        try:
            raw = (self.kube.get_node(self._record_node)["metadata"]
                   .get("annotations") or {}).get(L.ROLLOUT_ANNOTATION)
            if raw:
                current = json.loads(raw)
                if isinstance(current, dict):
                    if current.get("id") != self._record.get("id"):
                        # a DIFFERENT record sits on the anchor. A
                        # complete one is history (a finished earlier
                        # rollout) and may be overwritten; an unfinished
                        # one means a newer rollout superseded this
                        # writer while it was wedged — clobbering it
                        # would mask the live record from every
                        # resume/concurrency guard
                        if not current.get("complete"):
                            raise OwnershipLostError(
                                f"anchor now carries a different "
                                f"unfinished rollout "
                                f"{current.get('id')!r}; this writer "
                                f"({self._record.get('id')!r}) is stale"
                            )
                    elif current.get("owner") not in (None, self._owner):
                        raise OwnershipLostError(
                            f"rollout record {self._record.get('id')!r} "
                            f"was taken over by owner "
                            f"{current.get('owner')!r}; stopping this "
                            "writer"
                        )
        except OwnershipLostError:
            raise
        except (ApiException, ValueError):
            pass  # can't read back: proceed best-effort, as before

    def _record_group(self, gname: str, nodes: List[str], outcome: str,
                      detail: str = "") -> None:
        if self._record is not None:
            g = self._record["groups"].setdefault(
                gname, {"nodes": list(nodes)}
            )
            g["outcome"] = outcome
            if detail:
                g["detail"] = detail
            self._persist()
        if self.on_group is not None and outcome in _TERMINAL:
            groups = (self._record or {}).get("groups", {})
            done = sum(
                1 for g in groups.values()
                if g.get("outcome") in _TERMINAL
            )
            total = self._planned_total
            if total is None or total < len(groups):
                total = len(groups)
            try:
                self.on_group(gname, outcome, done, total)
            except Exception:
                log.warning("rollout progress hook failed", exc_info=True)

    # --------------------------------------------------- event-driven judge
    def _subscribe_feed(self) -> None:
        """Arm the delta feed for this run. Failure degrades to the
        interval path — the feed is a latency/IO optimization, never a
        correctness dependency."""
        if self.informer is None or self.dry_run:
            return
        try:
            self._feed_token = self.informer.subscribe(
                on_event=self._on_delta, on_wake=self._on_feed_wake
            )
        except Exception:
            log.warning("rollout judge feed subscription failed; "
                        "falling back to interval judging",
                        exc_info=True)
            self._feed_token = None

    def _unsubscribe_feed(self) -> None:
        if self.informer is not None and self._feed_token is not None:
            try:
                self.informer.unsubscribe(self._feed_token)
            except Exception:
                log.debug("feed unsubscribe failed", exc_info=True)
            self._feed_token = None

    def _feed_healthy(self) -> bool:
        """True when the informer cache may serve this judge tick:
        subscribed, primed, and actually watch-fed. An informer
        degraded to interval re-listing (no watch support) would serve
        reads staler than the judge's own poll cadence, so the judge
        falls back to its own LIST instead."""
        if self._feed_token is None or self.informer is None:
            return False
        try:
            if not self.informer.primed:
                return False
            stats = getattr(self.informer, "stats", None)
            if callable(stats) and not stats().get(
                    "watch_supported", True):
                # permanent for this informer (it degrades to interval
                # re-listing and never re-arms the watch): drop the
                # subscription so the fan-out stops paying for us and
                # every later tick goes straight to the legacy LIST
                log.info("judge feed has no watch support; interval "
                         "judging for the rest of this rollout")
                self._unsubscribe_feed()
                return False
            return True
        except Exception:
            log.debug("informer health probe failed; treating the "
                      "feed as degraded", exc_info=True)
            return False

    def _on_delta(self, etype: str, node: dict) -> None:
        """Informer delta callback (delivery thread): update the
        member's observed snapshot and judge its group IN PLACE. A
        terminal outcome queues for the driving loop's settlement and
        wakes it, so the next group's desired writes launch from this
        wake instead of waiting out the poll tick.

        Cost bound (this runs on the SHARED informer delivery
        thread): deltas for unwatched nodes return after one dict
        probe; a watched delta judges one group — label compares plus,
        only in the label-converged-but-unproven window, per-member
        evidence HMAC checks over in-hand annotations. No I/O ever
        happens here; persists and launches stay on the driver."""
        # never let an exception escape into the SHARED informer's
        # delivery loop: it would tear down the watch and force a
        # fleet-wide relist on every consumer. A failed judgement here
        # is retried by the fallback tick.
        try:
            name = (node.get("metadata") or {}).get("name")
            if not name:
                return
            # lock-free fast path keeps unwatched deltas (the vast
            # majority on a big cluster) off the judge lock entirely;
            # GIL-atomic dict probe, re-checked under the lock — the
            # benign miss window is covered by the fallback tick
            # ccaudit: allow-race-lockset(read-only probe; every _watched write is lock-guarded, a stale read only defers one judge to the poll tick)
            if name not in self._watched:
                return
            with self._judge_lock:
                gname = self._watched.get(name)
                if gname is None:
                    return
                if etype == "DELETED":
                    self._live.pop(name, None)
                else:
                    self._live[name] = node
                self.stats["delta_judges"] += 1  # type: ignore[operator]
                self._judge_locked(gname)
        except Exception:
            log.exception("delta judge failed; the fallback tick "
                          "covers this group")

    def _on_feed_wake(self) -> None:
        """Informer relist (watch gap): anything may have changed —
        refresh every watched member from the cache and re-judge.
        Exception-proof for the same reason as :meth:`_on_delta`."""
        if self.informer is None:
            return
        try:
            with self._judge_lock:
                self._refresh_watched_locked()
                for gname in list(self._in_flight):
                    self._judge_locked(gname)
        except Exception:
            log.exception("relist judge failed; the fallback tick "
                          "covers the in-flight groups")

    def _refresh_watched_locked(self) -> None:
        """Refresh every watched member from the informer cache
        (caller holds ``_judge_lock``): a member the cache no longer
        knows drops from the live map, so the next judge fails its
        group as vanished — the one place those semantics live."""
        inf = self.informer
        for m in list(self._watched):
            try:
                self._live[m] = inf.get_node(m)
            except ApiException:
                # gone from the (re)listed cache: vanished mid-flight
                self._live.pop(m, None)
            except Exception:
                log.debug("cache refresh of %s failed", m,
                          exc_info=True)

    def _judge_locked(self, gname: str,
                      deadline_only: bool = False) -> None:
        """Judge one in-flight group against the live observed map
        (caller holds ``_judge_lock``). A terminal outcome removes the
        group from the in-flight window EXACTLY ONCE — whichever of
        the delta callback, the relist refresh, or the fallback tick
        gets here first wins, and the losers find nothing in flight."""
        entry = self._in_flight.get(gname)
        if entry is None:
            return
        members, deadline, stale_failed = entry
        by_name = (
            None if deadline_only
            else {m: self._live[m] for m in members if m in self._live}
        )
        outcome = self._judge_group(
            gname, members, deadline, stale_failed, by_name
        )
        if outcome is None:
            return
        del self._in_flight[gname]
        for m in members:
            self._watched.pop(m, None)
            self._live.pop(m, None)
        self._ready.append(outcome)
        self._wake.set()

    def _watch_group(self, gname: str, members: List[str],
                     by_name: Dict[str, dict]) -> None:
        """Register a group's members for delta tracking BEFORE its
        desired labels are patched: a convergence delta landing in the
        patch->admit gap (a very fast agent) must update the live map,
        not vanish. Judging stays disarmed until :meth:`_admit_group`
        enters the group into the in-flight window."""
        with self._judge_lock:
            for m in members:
                self._watched[m] = gname
                if m in by_name:
                    self._live[m] = by_name[m]

    def _unwatch_group(self, members: List[str]) -> None:
        """Roll back :meth:`_watch_group` for a launch that failed."""
        with self._judge_lock:
            for m in members:
                self._watched.pop(m, None)
                self._live.pop(m, None)

    def _admit_group(self, gname: str, members: List[str],
                     by_name: Dict[str, dict], stale_failed: set) -> None:
        """Enter one launched group into the judged window (members
        registered by :meth:`_watch_group`, or seeded here for resume
        drains), then judge it once immediately — deltas that landed
        between the launch patches and this admit are already in the
        live map and must not wait out a fallback tick."""
        with self._judge_lock:
            for m in members:
                if m not in self._watched:
                    # not pre-registered (a resume drain): seed from
                    # the pool snapshot. A pre-registered member with
                    # NO live entry was DELETED in the patch->admit
                    # gap — re-seeding the stale snapshot would defer
                    # its vanished fast-fail to the next tick.
                    if m in by_name:
                        self._live[m] = by_name[m]
                self._watched[m] = gname
            self._in_flight[gname] = (
                members, time.monotonic() + self.group_timeout_s,
                stale_failed,
            )
            self._judge_locked(gname)

    def _has_ready(self) -> bool:
        with self._judge_lock:
            return bool(self._ready)

    def _launch_slot_free(self) -> bool:
        """ONE consistent snapshot of the launch gate: a window slot
        is offered only when no judged-but-unsettled outcome is
        queued. Both mutations (in-flight removal, ready enqueue)
        happen inside ``_judge_locked``'s critical section, so reading
        them under one acquisition cannot see a slot freed by an
        outcome whose budget/canary consequences are still pending."""
        with self._judge_lock:
            if self._ready:
                return False
            return len(self._in_flight) < (
                1 if self._canary_left > 0 else self.max_unavailable
            )

    def _judge_tick(self, fetch_pool: bool
                    ) -> Optional[Dict[str, dict]]:
        """The liveness fallback + group-timeout clock: refresh every
        watched member and judge every in-flight group. Feed healthy:
        served entirely from the informer's in-memory cache — ZERO
        node read round trips. Degraded (watch drop the informer
        cannot heal) or legacy (no feed): one real LIST per tick,
        exactly the historical interval judge. Returns the fresh pool
        map for launch bookkeeping (None when the poll failed)."""
        fresh: Optional[Dict[str, dict]] = None
        if self._feed_healthy():
            try:
                if fetch_pool:
                    fresh = {
                        n["metadata"]["name"]: n
                        for n in self.informer.list_nodes(self.selector)
                    }
            except Exception:
                log.debug("informer pool read failed; judging from "
                          "deltas only", exc_info=True)
            with self._judge_lock:
                self.stats["judge_ticks"] += 1  # type: ignore[operator]
                if fresh is not None:
                    for m in list(self._watched):
                        if m in fresh:
                            self._live[m] = fresh[m]
                        else:
                            self._live.pop(m, None)
                else:
                    self._refresh_watched_locked()
                for gname in list(self._in_flight):
                    self._judge_locked(gname)
            return fresh
        # degraded/legacy: the historical one-LIST-per-tick judge
        try:
            fresh = {
                n["metadata"]["name"]: n
                for n in self.kube.list_nodes(self.selector)
            }
        except ApiException as e:
            log.warning("pool poll failed: %s", e)
            fresh = None
        with self._judge_lock:
            if fresh is not None:
                self.stats["judge_node_reads"] += 1  # type: ignore[operator]
                for m in list(self._watched):
                    if m in fresh:
                        self._live[m] = fresh[m]
                    else:
                        self._live.pop(m, None)
            for gname in list(self._in_flight):
                self._judge_locked(gname, deadline_only=fresh is None)
        return fresh

    # ------------------------------------------------------------ planning
    def discover(self) -> List[dict]:
        nodes = self.kube.list_nodes(self.selector)
        if not nodes:
            raise RolloutError(
                f"no nodes match selector {self.selector!r}; nothing to roll"
            )
        return nodes

    @staticmethod
    def plan_groups(nodes: Sequence[dict]) -> List[Tuple[str, List[str]]]:
        """Slice-aware grouping: one group per slice, singletons for
        unsliced nodes; deterministic order (slices first, by name)."""
        slices: Dict[str, List[str]] = {}
        solo: List[str] = []
        for node in nodes:
            meta = node["metadata"]
            slice_id = meta.get("labels", {}).get(L.TPU_SLICE_LABEL)
            if slice_id:
                slices.setdefault(slice_id, []).append(meta["name"])
            else:
                solo.append(meta["name"])
        groups = [
            (f"slice/{s}", sorted(members))
            for s, members in sorted(slices.items())
        ]
        groups += [(f"node/{n}", [n]) for n in sorted(solo)]
        return groups

    def _converged(self, node: dict) -> bool:
        labels = node["metadata"].get("labels", {})
        return (
            labels.get(L.CC_MODE_LABEL) == self.mode
            and labels.get(L.CC_MODE_STATE_LABEL) == self.mode
        )

    # ------------------------------------------------------------- running
    def run(self) -> RolloutReport:
        # the preflight's spans: the listing and the planner here, the
        # group plan below re-seated under the same root (its trace id)
        # — the root closes before any desired-mode write, so each
        # group's desired_write stays the root of its own trace
        with get_tracer().span("preflight", mode=self.mode,
                               dry_run=self.dry_run) as preflight_span:
            with get_tracer().span("discover") as span:
                nodes = self.discover()
                span.attrs["nodes"] = len(nodes)
            preflight = analyze_fleet(nodes)
        blockers = []
        if preflight["failed"]:
            blockers.append(f"failed nodes: {preflight['failed']}")
        if preflight["half_flipped_slices"]:
            blockers.append(
                f"half-flipped slices: {preflight['half_flipped_slices']}"
            )
        if blockers and not self.force and not self.dry_run:
            # dry-run is read-only: always allowed to show the plan (the
            # blockers are visible in the report's preflight section)
            raise RolloutError(
                "preflight found a broken fleet (" + "; ".join(blockers) +
                "); fix it or pass --force"
            )

        by_name = {n["metadata"]["name"]: n for n in nodes}
        results: List[GroupResult] = []
        pending = deque()
        budget = self.failure_budget
        aborted = False

        in_flight_seed: List[Tuple[str, List[str]]] = []
        if self._resume_from is not None:
            # -------- resume: the record, not re-planning, is the truth
            self._record, self._record_node = self._resume_from
            try:
                self._canary_left = max(
                    0, int(self._record.get("canary_left", 0) or 0)
                )
            except (TypeError, ValueError):
                self._canary_left = 0
            groups_rec = self._record.get("groups", {})
            relaunch = deque()
            for gname in sorted(groups_rec):
                g = groups_rec[gname]
                members = list(g.get("nodes", []))
                oc = g.get("outcome", "pending")
                if oc in _TERMINAL:
                    # judged before the crash: counted exactly once,
                    # never re-attempted
                    results.append(GroupResult(
                        gname, members, oc, g.get("detail", "")))
                elif oc == "in_flight":
                    relaunch.append((gname, members))
                else:
                    pending.append((gname, members))
            budget -= sum(
                1 for g in groups_rec.values()
                if g.get("outcome") in _BUDGET_CONSUMING
            )
            aborted = bool(self._record.get("aborted"))
            if self.dry_run:
                # preview only: report the record's state, patch nothing
                for gname, members in relaunch:
                    results.append(GroupResult(
                        gname, members, "planned",
                        "would relaunch (was in flight at crash)",
                    ))
                for gname, members in pending:
                    results.append(GroupResult(gname, members, "planned"))
                pending = deque()
                relaunch = deque()
                self._record = None  # no persistence from a preview
            elif aborted:
                # the rollout had already aborted: its in-flight groups'
                # labels are patched and the nodes are flipping — DRAIN
                # them (judge to a terminal outcome) rather than falsely
                # reporting them not_attempted; pending stays blocked
                in_flight_seed = list(relaunch)
            else:
                # intent was persisted before the patch: relaunching is
                # an idempotent re-patch + fresh judge window
                pending = deque(list(relaunch) + list(pending))
            if not self.dry_run:
                # claim the record NOW: the stamped heartbeat tells other
                # would-be adopters a live process is driving it again
                self._persist()
            log.info(
                "resuming rollout %s to %r: %d judged, %d to relaunch/"
                "drain, %d pending, remaining budget %d",
                self._record.get("id") if self._record else "(dry-run)",
                self.mode, len(results), len(relaunch) + len(in_flight_seed),
                len(pending), budget,
            )
        else:
            # the guard must see records on ANY node, not just this
            # selector's pool — two selectors can overlap without being
            # equal. Scope: an unfinished record only blocks THIS
            # rollout when its node set intersects ours (disjoint pools
            # legitimately roll concurrently, one record per pool
            # anchor); a record whose node set cannot be parsed (future
            # schema) blocks everything — unknown scope is treated as
            # maximal, never as empty.
            if not self.dry_run:
                my_names = {n["metadata"]["name"] for n in nodes}
                for existing, _ in load_rollout_records(
                    self.kube, self.kube.list_nodes(None)
                ):
                    if existing.get("complete"):
                        continue
                    rec_nodes = record_node_names(existing)
                    if rec_nodes and not (rec_nodes & my_names):
                        continue
                    scope = (
                        f"over node(s) {sorted(rec_nodes & my_names)[:5]}"
                        if rec_nodes else "of unknown scope"
                    )
                    raise RolloutError(
                        f"an unfinished rollout (id {existing.get('id')},"
                        f" mode {existing.get('mode')!r}) {scope} "
                        "already overlaps this pool; finish it with "
                        "--resume"
                    )
            planned_count = 0
            evidence_calls = evidence_docs = 0
            evidence_s = 0.0
            from tpu_cc_manager_torch import identity as _identity
            from tpu_cc_manager_torch import rs256 as _rs256

            jwks_loads = _identity.jwks_loads
            self._judge_stats = {"identity_s": 0.0, "attestation_s": 0.0}
            self._judge_stats.update(
                (f"{axis}_{v}", 0) for axis in ("id", "att")
                for v in ("ok", "missing", "expired", "mismatch",
                          "invalid", "unverifiable")
            )
            with get_tracer().adopt(preflight_span), \
                    get_tracer().span("groups") as span:
                groups = self.plan_groups(nodes)
                at_target = [
                    all(self._converged(by_name[m]) for m in members)
                    for _, members in groups
                ]
                # the RS256 pre-pass: every signature the evidence check
                # will verify, in one launch of K6; the judges answer
                # from the batch (identity.rs256_batch) and take their
                # JWKS from it until the loop ends, and no verdict or
                # key outlives this group plan
                batch = None
                if self.verify_evidence:
                    batch, self._parsed = _rs256.prepare(
                        (m, (by_name[m]["metadata"].get("annotations")
                             or {}).get(L.EVIDENCE_ANNOTATION))
                        for (_, members), conv in zip(groups, at_target)
                        if conv for m in members
                    )
                rs256_batch_s = batch.seconds if batch is not None else 0.0
                evidence_s += rs256_batch_s
                rs256_scope = _identity.rs256_batch.set(batch)
                try:
                    for (gname, members), converged in zip(groups,
                                                           at_target):
                        if converged and self.verify_evidence:
                            # a node lying BEFORE the rollout starts must
                            # not slip through as 'skipped': route it
                            # through the judged path, where the
                            # contradiction surfaces. Read-only, so
                            # dry-run uses it too — the preview must
                            # classify groups the way the real run would
                            t_ev = time.monotonic()
                            converged = not self._evidence_suspects(
                                members, by_name
                            )
                            evidence_s += time.monotonic() - t_ev
                            evidence_calls += 1
                            evidence_docs += sum(
                                1 for m in members
                                if (by_name[m]["metadata"].get(
                                    "annotations") or {}).get(
                                        L.EVIDENCE_ANNOTATION)
                            )
                        if converged:
                            results.append(
                                GroupResult(gname, members, "skipped",
                                            f"already at {self.mode}")
                            )
                        elif self.dry_run:
                            # the preview marks which groups would canary
                            # (the first N to-run groups, matching the
                            # live run's pending order)
                            detail = ("canary: serial, must succeed"
                                      if planned_count < self.canary
                                      else "")
                            planned_count += 1
                            results.append(GroupResult(
                                gname, members, "planned", detail))
                        else:
                            pending.append((gname, members))
                finally:
                    _identity.rs256_batch.reset(rs256_scope)
                    self._parsed = {}
                planned = planned_count + len(pending)
                span.attrs.update(
                    groups=len(results) + len(pending),
                    skipped=len(results) + len(pending) - planned,
                    planned=planned, evidence_calls=evidence_calls,
                    evidence_docs=evidence_docs, evidence_s=evidence_s,
                    jwks_loads=_identity.jwks_loads - jwks_loads,
                    jwks_snapshot=(batch.snapshot_hits if batch is not None
                                   else 0),
                    rsa_batched=batch.batched if batch is not None else 0,
                    rsa_host=batch.host if batch is not None else 0,
                    rsa_batch_s=rs256_batch_s,
                    **self._judge_stats,
                )
            if not self.dry_run:
                import uuid as _uuid

                self._record_node = sorted(by_name)[0]  # pool anchor
                self._canary_left = min(self.canary, len(pending))
                self._record = {
                    "version": ROLLOUT_RECORD_VERSION,
                    "id": _uuid.uuid4().hex[:8],
                    "started": time.time(),
                    "mode": self.mode,
                    "selector": self.selector,
                    "max_unavailable": self.max_unavailable,
                    "failure_budget": self.failure_budget,
                    "canary_left": self._canary_left,
                    "complete": False,
                    "aborted": False,
                    "groups": {},
                }
                for r in results:
                    self._record["groups"][r.name] = {
                        "nodes": list(r.nodes), "outcome": r.outcome,
                        "detail": r.detail,
                    }
                for gname, members in pending:
                    self._record["groups"][gname] = {
                        "nodes": list(members), "outcome": "pending",
                    }
                self._persist()

        # the denominator the progress hook reports: every group this
        # run will ultimately judge — already-judged + queued + adopted
        # in-flight — not just the ones recorded so far (queued groups
        # only enter the record at launch, so len(record.groups) would
        # read '3/3 done' with work still pending, ADVICE r3)
        self._planned_total = (
            len(results) + len(pending) + len(in_flight_seed)
        )
        report = RolloutReport(self.mode, results, aborted=aborted,
                               preflight=preflight)
        if self.dry_run or (not pending and not in_flight_seed):
            self._finish_record(report)
            report.groups.sort(key=lambda g: g.name)
            return report

        log.info(
            "rolling %d group(s) to %r, window %d, budget %d",
            len(pending), self.mode, self.max_unavailable,
            self.failure_budget,
        )
        with self._judge_lock:
            self._in_flight.clear()
            self._watched.clear()
            self._live.clear()
            self._ready.clear()
        for gname, members in in_flight_seed:
            # resumed drain of an aborted rollout's in-flight groups:
            # already patched pre-crash; judge only, with a fresh window
            stale_failed = {
                m for m in members
                if by_name.get(m, {}).get("metadata", {}).get(
                    "labels", {}).get(L.CC_MODE_STATE_LABEL) == "failed"
            }
            self._admit_group(gname, members, by_name, stale_failed)
        canary_groups: set = set()
        self._subscribe_feed()
        try:
            return self._drive(
                pending, results, by_name, budget, report, canary_groups
            )
        finally:
            self._unsubscribe_feed()

    def _drive(self, pending, results: List[GroupResult],
               by_name: Dict[str, dict], budget: int,
               report: RolloutReport, canary_groups: set
               ) -> RolloutReport:
        """The wake-driven launch/judge/settle loop. Each turn: settle
        terminal outcomes the judges queued (delta callback or tick),
        apply budget/canary/abort consequences, refill the disruption
        window from pending (pipelined: a freed slot relaunches in the
        SAME turn its group settled), run the liveness/timeout judge
        tick on the ``poll_s`` cadence, then block on the wake event.
        With a healthy feed the block ends the instant a delta judges
        a group terminal; without one it times out at ``poll_s`` — the
        historical interval behavior, now interruptible."""
        last_tick = 0.0
        while True:
            with self._judge_lock:
                if not (pending or self._in_flight or self._ready):
                    break
            progress = False

            # ---- settle judged outcomes FIRST: budget and canary
            # state must be current before a launch fills the slot
            while True:
                with self._judge_lock:
                    outcome = (self._ready.popleft()
                               if self._ready else None)
                if outcome is None:
                    break
                progress = True
                gname = outcome.name
                results.append(outcome)
                if gname in canary_groups:
                    canary_groups.discard(gname)
                    self._canary_left = max(0, self._canary_left - 1)
                    if self._record is not None:
                        self._record["canary_left"] = self._canary_left
                    if outcome.outcome != "succeeded":
                        # set the abort flag BEFORE the outcome
                        # persist below: one write carries both
                        self._canary_failed(report, gname,
                                            outcome.outcome,
                                            persist=False)
                self._record_group(
                    gname, outcome.nodes, outcome.outcome,
                    outcome.detail,
                )
                if outcome.outcome in _BUDGET_CONSUMING:
                    budget -= 1
                self._last_terminal_at = time.monotonic()

            if budget < 0 and not report.aborted:
                report.aborted = True
                if self._record is not None:
                    self._record["aborted"] = True
                    self._persist()
                with self._judge_lock:
                    n_in_flight = len(self._in_flight)
                log.error(
                    "failure budget exhausted; draining %d in-flight "
                    "group(s), %d pending group(s) not attempted",
                    n_in_flight, len(pending),
                )
            if report.aborted and pending:
                for gname, members in pending:
                    results.append(
                        GroupResult(gname, members, "not_attempted",
                                    "rollout aborted")
                    )
                    self._record_group(gname, members, "not_attempted",
                                       "rollout aborted")
                pending.clear()

            # ---- launch: refill the window. On a terminal wake this
            # runs in the same turn the group settled, so the next
            # group's desired writes go out immediately (pipelined
            # window advancement) instead of after the next tick.
            while (
                pending
                and budget >= 0
                and not report.aborted
                # atomic gate: a slot freed by a concurrent delta
                # judgement must not be refilled before its budget and
                # canary consequences settle (next turn settles first
                # — the pre-wait check sees the ready queue), and the
                # canary phase stays serial (window 1) regardless of
                # max_unavailable
                and self._launch_slot_free()
            ):
                progress = True
                was_canary = self._canary_left > 0
                gname, members = pending.popleft()
                # a member that vanished from the pool while the group sat
                # in the queue (GKE node repair/deletion) fails the group
                # at launch, mirroring _judge_group's in-flight check
                gone = sorted(m for m in members if m not in by_name)
                if gone:
                    detail = (f"node(s) disappeared from the pool before "
                              f"launch: {gone}")
                    results.append(GroupResult(gname, members, "failed",
                                               detail))
                    if was_canary:
                        self._canary_failed(report, gname, "vanished",
                                            persist=False)
                    self._record_group(gname, members, "failed", detail)
                    budget -= 1
                    continue
                # a node already showing 'failed' at launch (--force over a
                # broken fleet) can't fail fast: the agent re-publishing
                # the same value is invisible, so for those members only
                # convergence or the group timeout decides
                stale_failed = {
                    m for m in members
                    if by_name[m]["metadata"].get("labels", {}).get(
                        L.CC_MODE_STATE_LABEL
                    ) == "failed"
                }
                # one advance-latency sample: the previous terminal
                # settlement -> THIS group's first desired write (the
                # pipelining the bench's rollout_advance_p50_s gates)
                if self._last_terminal_at is not None:
                    with self._judge_lock:
                        self.stats["advance_latencies_s"].append(
                            round(time.monotonic()
                                  - self._last_terminal_at, 6)
                        )
                    self._last_terminal_at = None
                # persist INTENT before patching: a crash between the
                # two leaves the group marked in_flight, and resume
                # relaunches it (idempotent patch) instead of losing it
                self._record_group(gname, members, "in_flight")
                # track deltas from BEFORE the first patch: a
                # convergence event in the patch->admit gap updates
                # the live map and the admit-time judge sees it
                self._watch_group(gname, members, by_name)
                if self._launch(gname, members, by_name):
                    if was_canary:
                        canary_groups.add(gname)
                    self._admit_group(gname, members, by_name,
                                      stale_failed)
                else:
                    self._unwatch_group(members)
                    detail = "desired-label patch failed"
                    results.append(
                        GroupResult(gname, members, "failed", detail)
                    )
                    if was_canary:
                        self._canary_failed(report, gname, "launch failed",
                                            persist=False)
                    self._record_group(gname, members, "failed", detail)
                    budget -= 1

            # ---- liveness fallback + group-timeout clock, on the
            # poll_s cadence regardless of how often deltas wake us
            if (self._window_used()
                    and time.monotonic() - last_tick >= self.poll_s):
                last_tick = time.monotonic()
                fresh = self._judge_tick(fetch_pool=bool(pending))
                if fresh is not None:
                    by_name = fresh

            if (
                self._record is not None
                and time.monotonic() - self._last_heartbeat
                >= HEARTBEAT_PERIOD_S
            ):
                # no state transition lately: refresh liveness so a slow
                # group doesn't make this rollout look abandoned
                self._persist()
            if self._stop_requested.is_set():
                # cooperative stop (leader demotion): DON'T finish the
                # record — stop stamping its heartbeat and walk away, so
                # the new leader's observed-staleness adoption picks the
                # same record up and finishes the remaining groups.
                # In-flight desired labels are already patched; agents
                # keep converging them; the adopter re-judges them.
                reason = self._stop_reason or "stop requested"
                with self._judge_lock:
                    stopped = {g: e[0]
                               for g, e in self._in_flight.items()}
                    # judged-but-unsettled outcomes are handed off too:
                    # settling past the stop would persist state the
                    # adopter is about to own (it re-judges them)
                    for oc in self._ready:
                        stopped.setdefault(oc.name, oc.nodes)
                    self._in_flight.clear()
                    self._watched.clear()
                    self._live.clear()
                    self._ready.clear()
                for gname, members in stopped.items():
                    results.append(GroupResult(
                        gname, members, "stopped", reason
                    ))
                for gname, members in pending:
                    results.append(GroupResult(
                        gname, members, "stopped", reason
                    ))
                # a rollout that had ALREADY aborted (canary/budget
                # failure, record persisted aborted=True) stays a
                # failure — the stop only cuts its in-flight drain
                # short; flagging it as a clean handoff would mask the
                # abort from the policy's Degraded status and backoff
                if not report.aborted:
                    report.stopped_early = True
                    report.stop_reason = reason
                report.aborted = True  # report-level only: for a pure
                # handoff the RECORD stays non-aborted + incomplete =
                # adoptable
                log.warning(
                    "rollout stopped (%s): leaving record %s for "
                    "adoption (%d in-flight, %d pending)", reason,
                    (self._record or {}).get("id"), len(stopped),
                    len(pending),
                )
                report.groups.sort(key=lambda g: g.name)
                return report
            if not progress and self._window_used():
                # quiet turn: block until a delta judges a group
                # terminal (the wake) or the liveness tick is due.
                # Clear-then-check orders against the judge threads:
                # an outcome queued after the clear re-sets the event,
                # so the wait never strands a ready settlement.
                self._wake.clear()
                with self._judge_lock:
                    have_ready = bool(self._ready)
                # re-check the stop too: request_stop() sets the wake
                # AFTER this turn's stop check ran, and the clear
                # above would otherwise swallow it for a full wait
                if not have_ready and not self._stop_requested.is_set():
                    # capped at the heartbeat period: a long poll_s
                    # must slow the fallback judge, never liveness
                    self._wake.wait(
                        min(self.poll_s, HEARTBEAT_PERIOD_S)
                        if self._record is not None else self.poll_s
                    )

        self._finish_record(report)
        report.groups.sort(key=lambda g: g.name)
        return report

    def _window_used(self) -> int:
        with self._judge_lock:
            return len(self._in_flight)

    def request_stop(self, reason: str = "stop requested") -> None:
        """Ask a running rollout to stop at its next loop turn without
        finishing the durable record (see the in-loop handler). Safe
        from any thread; used by the policy controller when it loses
        leader election mid-roll."""
        self._stop_reason = reason
        self._stop_requested.set()
        self._wake.set()  # unblock the driving loop's event wait now

    def _canary_failed(self, report: RolloutReport, gname: str,
                       how: str, persist: bool = True) -> None:
        """A canary group did not succeed: abort outright — the canary
        exists to prove the flip BEFORE the blast radius widens, so the
        failure budget never excuses it. Callers that persist the group
        outcome right after pass ``persist=False`` so ONE write carries
        both the outcome and the abort flag — a crash between two
        separate persists would leave a record that resumes as a
        budget-excused ordinary failure, wide window and all."""
        if report.aborted:
            return
        report.aborted = True
        if self._record is not None:
            self._record["aborted"] = True
            if persist:
                self._persist()
        log.error(
            "canary group %s did not succeed (%s); aborting rollout",
            gname, how,
        )

    def _finish_record(self, report: RolloutReport) -> None:
        """Mark the durable record complete (kept for audit; the next
        rollout overwrites it)."""
        if self._record is None:
            return
        self._record["complete"] = True
        self._record["aborted"] = report.aborted
        self._persist()

    def _launch(
        self, gname: str, members: List[str], by_name: Dict[str, dict]
    ) -> bool:
        """Patch the desired-state label on every member of one group.

        All-or-nothing per group: on a partial failure the already-patched
        members are rolled back to their previous desired label —
        otherwise a multi-host slice would be left with incoherent desired
        state (agents parked in slice_wait) and the disruption would
        exceed the window, the exact states the preflight exists to block.
        """
        log.info("launching group %s (%s) -> %r", gname, members, self.mode)
        patched: List[str] = []
        # ONE desired-write span per group: its traceparent rides the
        # cc.trace annotation in the SAME patch as the desired label
        # (zero extra round trips), so every member agent's reconcile
        # adopts this trace and the group's whole desired-write →
        # state-publish story stitches under one trace id (ISSUE 8)
        with get_tracer().span(
            "desired_write", group=gname, mode=self.mode,
            nodes=len(members),
        ) as span:
            context = format_traceparent(span)
            for m in members:
                try:
                    self.kube.patch_node(
                        m, desired_patch_body(self.mode, context)
                    )
                    patched.append(m)
                except ApiException as e:
                    log.error("could not label %s: %s", m, e)
                    for p in patched:
                        prev = by_name[p]["metadata"].get("labels", {}).get(
                            L.CC_MODE_LABEL
                        )
                        try:
                            # revert the label AND clear the aborted
                            # launch's trace annotation in one write —
                            # the rollback's own reconcile (and later
                            # self-repairs) must not keep stitching
                            # under the dead rollout's trace id
                            self.kube.patch_node(p, {"metadata": {
                                "labels": {L.CC_MODE_LABEL: prev},
                                "annotations": {
                                    L.CC_TRACE_ANNOTATION: None,
                                },
                            }})
                        except ApiException as e2:  # best effort
                            log.error(
                                "rollback of %s to %r failed: %s",
                                p, prev, e2,
                            )
                    return False
        return True

    def _judge_group(
        self,
        gname: str,
        members: List[str],
        deadline: float,
        stale_failed: frozenset = frozenset(),
        by_name: Optional[Dict[str, dict]] = None,
    ) -> Optional[GroupResult]:
        """None = still in flight; otherwise the terminal GroupResult.
        ``by_name`` is this tick's pool snapshot (None = the poll failed;
        only the deadline is checked)."""
        if by_name is None:
            if time.monotonic() >= deadline:
                return GroupResult(
                    gname, members, "timeout",
                    f"no convergence within {self.group_timeout_s:.0f}s "
                    "(pool poll failing)",
                )
            return None  # transient: retry next tick
        # A member absent from a fresh pool snapshot is gone (GKE node
        # repair/deletion mid-rollout): fail the group immediately instead
        # of burning the whole group timeout treating it as "lagging".
        vanished = sorted(m for m in members if m not in by_name)
        if vanished:
            return GroupResult(
                gname, members, "failed",
                f"node(s) disappeared from the pool mid-rollout: {vanished}",
            )
        states = {
            m: by_name.get(m, {}).get("metadata", {}).get("labels", {}).get(
                L.CC_MODE_STATE_LABEL
            )
            for m in members
        }
        bad = [
            m for m, s in states.items()
            if s == "failed" and m not in stale_failed
        ]
        if bad:
            return GroupResult(
                gname, members, "failed",
                f"agent(s) reported failed state: {sorted(bad)}",
            )
        if all(s == self.mode for s in states.values()):
            suspect = (
                self._evidence_suspects(members, by_name)
                if self.verify_evidence else []
            )
            if not suspect:
                log.info("group %s converged to %r", gname, self.mode)
                return GroupResult(gname, members, "succeeded")
            # label text claims convergence but the device-truth channel
            # disagrees (or is tampered): don't trust it. Evidence is
            # published asynchronously after the label, so keep waiting
            # — a persistent contradiction resolves via the timeout.
            if time.monotonic() >= deadline:
                detail = ", ".join(
                    f"{m}: {self._suspect_reasons.get(m, '?')}"
                    for m in suspect
                )
                msg = (
                    f"labels reached {self.mode!r} but evidence "
                    f"disagrees or fails verification on: [{detail}]"
                )
                if any(self._suspect_reasons.get(m) == "unsigned"
                       for m in suspect):
                    from tpu_cc_manager_torch.evidence import UNSIGNED_RUNBOOK

                    msg += (
                        " — agents are publishing unsigned evidence "
                        "while this verifier holds the pool key: "
                        f"{UNSIGNED_RUNBOOK}"
                    )
                return GroupResult(gname, members, "timeout", msg)
            return None
        if time.monotonic() >= deadline:
            lag = sorted(m for m, s in states.items() if s != self.mode)
            return GroupResult(
                gname, members, "timeout",
                f"no convergence within {self.group_timeout_s:.0f}s; "
                f"lagging: {lag}",
            )
        return None

    def _count_judge(self, axis: str, verdict: str, seconds: float) -> None:
        """One identity (``id``) or attestation (``att``) judgement."""
        st = self._judge_stats
        key = "identity_s" if axis == "id" else "attestation_s"
        st[key] = st.get(key, 0.0) + seconds
        st[f"{axis}_{verdict}"] = st.get(f"{axis}_{verdict}", 0) + 1

    def _evidence_suspects(self, members: List[str],
                           by_name: Dict[str, dict]) -> List[str]:
        """Members whose PRESENT evidence annotation contradicts this
        rollout counting them as converged. Classification is entirely
        :func:`tpu_cc_manager.evidence.judge_evidence` — the same triage
        the fleet audit uses, so a document can never pass one verifier
        and fail the other:

        - ``malformed``/``digest_mismatch``/``node_mismatch``: suspect.
        - ``unsigned`` (plain doc, keyed verifier): suspect — the
          no-downgrade rule refuses it as proof — but warned loudly on
          first sighting with the deployment runbook, and the timeout
          verdict names the manifest fix.
        - ``no_key`` (signed doc, keyless verifier — the key is
          resolved ONCE at construction and never re-read mid-flight):
          tolerated blind spot, warned once... unless the doc's
          unauthenticated mode claim contradicts the target, which
          needs no key to read and stays a suspect.
        - ``ok`` attesting a different mode than the target: suspect.
        - identity or TEE-attestation contradictions (foreign token,
          quote that does not commit to the document or disagrees
          with the measured flip history): suspect — same verdicts as
          the fleet audit's mismatch buckets.

        Missing evidence is tolerated (pre-evidence agents must not
        brick a rollout). Per-member reasons land in
        ``self._suspect_reasons`` so the timeout verdict says what to
        FIX, not just who lagged."""
        from tpu_cc_manager_torch.attest import (
            judge_attestation, require_attestation,
        )
        from tpu_cc_manager_torch.evidence import (
            UNSIGNED_RUNBOOK, judge_evidence,
        )
        from tpu_cc_manager_torch.identity import (
            judge_identity, require_identity,
        )

        out: List[str] = []
        for m in members:
            meta = by_name.get(m, {}).get("metadata", {})
            raw = (meta.get("annotations") or {}).get(L.EVIDENCE_ANNOTATION)
            if not raw:
                continue
            parsed = self._parsed.get(m)
            try:
                doc = (parsed[1] if parsed is not None and parsed[0] is raw
                       else json.loads(raw))
                verdict, attested = judge_evidence(
                    doc, m, key=self._evidence_key
                )
            except Exception:
                log.debug("evidence for %s unjudgeable; counting "
                          "malformed", m, exc_info=True)
                verdict, attested = "malformed", None
            if verdict == "unsigned":
                # forensic outranks the deployment-gap runbook, same
                # rule as the audit: an unsigned doc attesting the
                # WRONG mode is a label/device contradiction first —
                # re-keying the agents would not make this node honest
                if attested is not None and attested != self.mode:
                    self._suspect_reasons[m] = (
                        f"attests {attested!r}, not {self.mode!r} "
                        "(and unsigned under a keyed verifier)"
                    )
                    out.append(m)
                    continue
                # loud the FIRST time, not only at group timeout — an
                # operator watching logs sees the fix minutes before
                # the timeout would have reported a mystery
                if not self._warned_unsigned:
                    self._warned_unsigned = True
                    log.warning(
                        "node %s publishes UNSIGNED evidence while "
                        "this verifier holds the pool key; its group "
                        "will not count as converged — %s",
                        m, UNSIGNED_RUNBOOK,
                    )
                self._suspect_reasons[m] = "unsigned"
                out.append(m)
                continue
            if verdict == "no_key":
                # tolerated blind spot (the fleet controller holding
                # the key still audits the digest) — but the keyless-
                # checkable claims below still run
                if not self._warned_no_key:
                    self._warned_no_key = True
                    log.warning(
                        "evidence is HMAC-signed but no "
                        "TPU_CC_EVIDENCE_KEY is configured here; "
                        "skipping digest verification"
                    )
            elif verdict != "ok":
                self._suspect_reasons[m] = verdict
                out.append(m)
                continue
            # keyless-checkable claims, for 'ok' AND 'no_key' docs —
            # the same invariant the fleet audit holds: a document can
            # never pass the rollout judge but fail the audit
            if attested is not None and attested != self.mode:
                qualifier = (
                    " (digest unverifiable: no key here)"
                    if verdict == "no_key" else ""
                )
                self._suspect_reasons[m] = (
                    f"attests {attested!r}, not {self.mode!r}{qualifier}"
                )
                out.append(m)
                continue
            # platform identity: a token speaking for another node (or
            # failing verification) is the stolen-pool-key forgery and
            # always a suspect; a MISSING or merely expired token is
            # one only when the operator requires identity — the
            # rollout must keep working on platforms that mint none
            t_judge = time.monotonic()
            try:
                iverdict, idetail = judge_identity(doc, m)
            except Exception as e:
                iverdict, idetail = "invalid", f"identity judge failed: {e}"
            self._count_judge("id", iverdict, time.monotonic() - t_judge)
            if iverdict in ("mismatch", "invalid"):
                self._suspect_reasons[m] = f"identity: {idetail}"
                out.append(m)
                continue
            elif (iverdict in ("missing", "expired")
                    and require_identity()):
                self._suspect_reasons[m] = (
                    f"identity {iverdict} "
                    "(TPU_CC_REQUIRE_IDENTITY is set)"
                )
                out.append(m)
                continue
            # TEE attestation, same shape as identity: a quote that
            # CONTRADICTS the document (nonce replay, bad signature,
            # or a claim disagreeing with the measured flip history —
            # the node-root forgery) is always a suspect; a missing
            # quote is one only under TPU_CC_REQUIRE_ATTESTATION, so
            # rollouts keep working on TEE-less pools. A rollout must
            # not count a forged-state node as converged when the
            # fleet audit would flag it a scan later.
            t_judge = time.monotonic()
            try:
                averdict, adetail = judge_attestation(doc, m)
            except Exception as e:
                averdict, adetail = (
                    "invalid", f"attestation judge failed: {e}"
                )
            self._count_judge("att", averdict, time.monotonic() - t_judge)
            if averdict in ("mismatch", "invalid"):
                self._suspect_reasons[m] = f"attestation: {adetail}"
                out.append(m)
            elif (averdict in ("missing", "expired")
                    and require_attestation()):
                self._suspect_reasons[m] = (
                    f"attestation {averdict} "
                    "(TPU_CC_REQUIRE_ATTESTATION is set)"
                )
                out.append(m)
            elif (averdict == "unverifiable"
                    and not self._warned_attestation_unverifiable):
                # tolerated blind spot, said out loud (the evidence
                # no_key posture): the measured-history contradiction
                # check above still ran keylessly, but a fully
                # fabricated quote would pass this verifier — the
                # keyed fleet audit remains the backstop
                self._warned_attestation_unverifiable = True
                log.warning(
                    "evidence attestation present but unverifiable "
                    "here (%s); quote authenticity is not being "
                    "checked by this rollout", adetail,
                )
        return sorted(out)
