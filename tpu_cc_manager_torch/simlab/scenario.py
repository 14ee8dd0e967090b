"""Scenario schema + strict validation for the simlab fleet lab.

A scenario is one JSON document describing a fleet (node count, pools,
chips per node), the lab's execution limits (worker slots, client-side
QPS), an action timeline (mode storms, policy creation, scripted
faults), and the convergence expectation the run is judged against.

Validation is STRICT — unknown keys anywhere in the document are
rejected. That strictness is what lets tests/test_simlab.py freshness-
gate the committed ``scenarios/*.json`` examples the same way
test_manifests.py gates the kustomize tree: a schema change that
orphans an example fails CI instead of rotting silently. The committed
files must also match :func:`canonical_scenario_text` byte for byte
(``python -m tpu_cc_manager simlab validate`` checks parse/semantics;
the test checks formatting freshness).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List

from tpu_cc_manager_torch.modes import InvalidModeError, Mode, parse_mode

#: bumped on breaking schema changes; scenarios carry it explicitly so
#: a future reader can refuse documents it does not understand
SCENARIO_VERSION = 1

#: additive schema revision (ISSUE 16): ``"schema": 2`` unlocks the
#: federation surface (``regions``, region faults, per-region set_mode
#: windows). Deliberately a SEPARATE key from ``version`` — version
#: stays the breaking-change gate pinned at 1 (a v2 *version* must
#: still be refused), while schema is the opt-in for additions a v1
#: reader would reject as unknown keys.
SCENARIO_SCHEMA_MAX = 2

#: fault kinds that only exist under schema 2 + ``regions``
REGION_FAULTS = frozenset({
    "region_partition", "region_blackout", "region_latency_skew",
    "region_evacuate",
})

#: fault kind -> {param: (required, type(s))}
FAULT_PARAMS: Dict[str, Dict[str, tuple]] = {
    # crash N replicas; they stop reconciling and restart (re-reading
    # their node's desired label) after restart_after_s
    "agent_crash": {"count": (True, int),
                    "restart_after_s": (False, (int, float))},
    # the next N watch (re)connects fail server-side (FakeKube
    # fail_next_watches): the pump must absorb the storm and reconnect
    "watch_drop": {"count": (True, int)},
    # compact the watch history: the pump's next resume 410s and it
    # must full-relist to resynchronize
    "watch_410": {},
    # the next N node LISTs answer 429 (apiserver overload storm):
    # relists and controller scans must retry through it
    "list_429": {"count": (True, int)},
    # the next N node WRITES (patch/replace) answer 429: the write-path
    # storm the coalescing publish core (k8s.batch) must absorb —
    # state writes re-enter via replica repair, deferred evidence
    # retries with backoff, and the newest generation still lands
    "write_429": {"count": (True, int)},
    # squeeze the shared data-plane client's token bucket to qps for
    # duration_s, then restore the scenario's configured rate
    "throttle_squeeze": {"qps": (True, (int, float)),
                         "duration_s": (True, (int, float))},
    # steal the policy controllers' election Lease for one lease term:
    # the leader demotes mid-rollout and a replica must take over and
    # adopt the unfinished record
    "leader_flap": {},
    # crash one controller shard host (no lease release — survivors
    # must wait out shard-lease staleness, then re-acquire its
    # partition); optional restart brings it back as a standby. The
    # repartition storm is several of these in sequence. Requires
    # controllers.shards > 0.
    "shard_kill": {"host": (False, int),
                   "restart_after_s": (False, (int, float))},
    # ---- lifecycle fault families (ISSUE 12) -------------------------
    # rolling agent upgrade: the pool's replicas restart cohort by
    # cohort with a new code-version behavior, so two versions
    # reconcile one pool mid-rollout; upgraded replicas advertise
    # their version via the cc.agent-version annotation riding a
    # carrier write (zero extra round trips)
    "agent_upgrade": {"pool": (False, int),
                      "cohorts": (False, int),
                      "stagger_s": (False, (int, float)),
                      "version": (False, str)},
    # rotate the attestation signing key fleet-wide mid-scan: every
    # node's TPM signs with the new key, the verifier keeps the old
    # key in its rotation tail, and the next wave's evidence must
    # re-verify cleanly (requires `attestation`)
    "key_rotation": {},
    # revoke the VERIFIER's attestation trust root: nodes keep
    # quoting, nobody can check them — the fleet's attestation_outage
    # latch must fire and the fleet must never read as verified again.
    # `forge` additionally plants a node-root forged evidence document
    # (statefile-rewrite analog) on one already-converged node, which
    # must land in attestation_mismatch, never be accepted, and never
    # flip a chip (requires `attestation` + a fleet audit plane)
    "root_revoked": {"forge": (False, bool),
                     # schema 2: revoke ONE region's trust domain
                     # instead of the process-global root — the
                     # region_attestation_latch invariant's input
                     "region": (False, str)},
    # two policies claiming overlapping pools: an owner policy (first
    # in name order) selecting the whole fleet and a rival selecting
    # one pool. The name-ordered conflict rule must park the rival in
    # phase Conflicted while the owner converges the fleet (requires
    # controllers.policy)
    "policy_conflict": {"mode": (True, str),
                        "rival_mode": (True, str),
                        "pool": (False, int)},
    # region-evacuation drain racing in-flight flips: cordon N nodes
    # (spec.unschedulable, a real API write) while a mode storm is in
    # flight, uncordon after duration_s — the cordon must neither stop
    # reconciliation nor survive the run
    "evacuation_drain": {"count": (True, int),
                         "pool": (False, int),
                         "duration_s": (False, (int, float))},
    # inject delay_s of device-reset latency into the scoped replicas'
    # fake chips (the scripted slow-flip, ISSUE 15): reconciles still
    # SUCCEED, just slowly — the fault the anomaly watchdog must
    # notice live, name the guilty phase for, and autopsy. Optional
    # duration_s restores the original latency (restorative timer)
    "flip_latency": {"delay_s": (True, (int, float)),
                     "count": (False, int),
                     "pool": (False, int),
                     "duration_s": (False, (int, float))},
    # ---- federation fault family (ISSUE 16, schema 2 + regions) ------
    # region partition: the region's API server refuses every verb
    # (503) for duration_s — posture writes must defer and land when
    # it heals; the other regions keep converging
    "region_partition": {"region": (True, str),
                         "duration_s": (False, (int, float))},
    # regional API blackout: same 503 front door, scripted as the
    # total-control-plane-outage variant (in-flight watches sever too)
    "region_blackout": {"region": (True, str),
                        "duration_s": (False, (int, float))},
    # inter-region latency skew: every API verb in the region pays
    # delay_s before answering (slept outside the store lock)
    "region_latency_skew": {"region": (True, str),
                            "delay_s": (True, (int, float)),
                            "duration_s": (False, (int, float))},
    # first-class region evacuation: park the region's posture writes,
    # cordon its nodes, collapse every other region's window to NOW —
    # the evac-races-upgrade interleaving is this at mid-rollout
    "region_evacuate": {"region": (True, str)},
}

#: action kind -> {param: (required, type(s))}; "fault" params are
#: validated separately against FAULT_PARAMS
ACTION_PARAMS: Dict[str, Dict[str, tuple]] = {
    # patch the desired-mode label on every node (or one pool).
    # ``windows`` (schema 2 + regions): {region: offset seconds} —
    # per-region rollout windows for ONE posture, federation.py's
    # FleetPosture.windows verbatim
    "set_mode": {"mode": (True, str), "pool": (False, int),
                 "windows": (False, dict)},
    # create a TPUCCPolicy covering every node (or one pool); requires
    # controllers.policy
    "create_policy": {"mode": (True, str), "pool": (False, int),
                      "max_unavailable": (False, int),
                      "group_timeout_s": (False, (int, float))},
    "fault": {},  # validated per fault kind
}


class ScenarioError(ValueError):
    """A scenario document failed validation."""


@dataclasses.dataclass(frozen=True)
class Action:
    at: float
    kind: str
    params: dict


@dataclasses.dataclass(frozen=True)
class Controllers:
    fleet: bool = False
    policy: bool = False
    leader_elect: bool = False
    #: 0 = the single fleet/policy controller pair; N > 0 = N
    #: consistent-hash controller shards (tpu_cc_manager.shard), each
    #: holding a per-shard lease and running partition-scoped
    #: controllers over ONE shared node informer
    shards: int = 0


@dataclasses.dataclass(frozen=True)
class Converge:
    mode: str
    timeout_s: float = 120.0


@dataclasses.dataclass(frozen=True)
class RegionDef:
    """One federation region (schema 2): its own FakeApiServer, its
    slice of the fleet's nodes and pools, its own attestation trust
    domain. The top-level ``nodes``/``pools`` stay the fleet totals
    (and must equal the region sums) so every nodes-derived knob —
    CLI overrides, bench axes, fault count clamps — keeps meaning
    what it always meant."""

    name: str
    nodes: int
    pools: int = 1


@dataclasses.dataclass(frozen=True)
class Scenario:
    name: str
    nodes: int
    converge: Converge
    actions: List[Action]
    pools: int = 1
    chips_per_node: int = 1
    initial_mode: str = Mode.OFF.value
    workers: int = 8
    qps: float = 0.0
    evidence: bool = False
    #: per-replica software TPMs + a lab-provisioned verifier trust
    #: root (TPU_CC_TPM_KEY for the run only): evidence carries real
    #: quotes over real measured flip histories, so the key_rotation /
    #: root_revoked lifecycle faults act on live attestation state.
    #: Requires `evidence` (quotes ride evidence documents).
    attestation: bool = False
    watch_timeout_s: float = 10.0
    controllers: Controllers = Controllers()
    #: schema revision the document declared (1 when absent)
    schema: int = 1
    #: federation regions (schema 2); empty = the classic one-server lab
    regions: tuple = ()

    def scaled_to(self, nodes: int) -> "Scenario":
        """CLI --nodes override (fault counts are clamped at runtime)."""
        if nodes < 1:
            raise ScenarioError(f"nodes override must be >= 1, got {nodes}")
        if self.regions:
            raise ScenarioError(
                "--nodes cannot override a regions scenario (the "
                "per-region node split is part of the document)"
            )
        return dataclasses.replace(self, nodes=nodes)

    def with_workers(self, workers: int) -> "Scenario":
        if workers < 1:
            raise ScenarioError(
                f"workers override must be >= 1, got {workers}")
        return dataclasses.replace(self, workers=workers)


def _reject_unknown(doc: dict, allowed, where: str) -> None:
    unknown = sorted(set(doc) - set(allowed))
    if unknown:
        raise ScenarioError(
            f"{where}: unknown key(s) {unknown}; allowed: "
            f"{sorted(allowed)}"
        )


def _mode(value, where: str) -> str:
    if not isinstance(value, str):
        raise ScenarioError(f"{where}: mode must be a string")
    try:
        parse_mode(value)
    except InvalidModeError as e:
        raise ScenarioError(f"{where}: {e}") from None
    return value


def _typed(doc: dict, spec: Dict[str, tuple], where: str) -> None:
    for key, (required, types) in spec.items():
        if key not in doc:
            if required:
                raise ScenarioError(f"{where}: missing required {key!r}")
            continue
        if isinstance(doc[key], bool) and types is not bool:
            # bool is an int subclass; an accidental true where a count
            # belongs must not validate
            raise ScenarioError(f"{where}: {key!r} must be {types}")
        if not isinstance(doc[key], types):
            raise ScenarioError(f"{where}: {key!r} must be {types}, "
                                f"got {type(doc[key]).__name__}")


def _validate_action(raw: dict, idx: int, pools: int) -> Action:
    where = f"actions[{idx}]"
    if not isinstance(raw, dict):
        raise ScenarioError(f"{where}: must be an object")
    base_keys = {"at", "action"}
    if "action" not in raw:
        raise ScenarioError(f"{where}: missing required 'action'")
    kind = raw["action"]
    if kind not in ACTION_PARAMS:
        raise ScenarioError(
            f"{where}: unknown action {kind!r}; known: "
            f"{sorted(ACTION_PARAMS)}"
        )
    at = raw.get("at", 0.0)
    if isinstance(at, bool) or not isinstance(at, (int, float)) or at < 0:
        raise ScenarioError(f"{where}: 'at' must be a number >= 0")
    params = {k: v for k, v in raw.items() if k not in base_keys}
    if kind == "fault":
        fault = params.get("fault")
        if fault not in FAULT_PARAMS:
            raise ScenarioError(
                f"{where}: unknown fault {fault!r}; known: "
                f"{sorted(FAULT_PARAMS)}"
            )
        spec = FAULT_PARAMS[fault]
        _reject_unknown({k: v for k, v in params.items() if k != "fault"},
                        spec, f"{where} (fault {fault})")
        _typed(params, spec, f"{where} (fault {fault})")
        for key in ("count", "cohorts"):
            if key in spec and params.get(key, 1) < 1:
                raise ScenarioError(f"{where}: {key!r} must be >= 1")
        for key in ("mode", "rival_mode"):
            if key in params:
                _mode(params[key], f"{where} (fault {fault} {key})")
        if fault == "policy_conflict" and \
                params["mode"] == params["rival_mode"]:
            raise ScenarioError(
                f"{where}: policy_conflict mode and rival_mode must "
                "differ (identical claims are not a conflict)"
            )
        pool = params.get("pool")
        if pool is not None and not (0 <= pool < pools):
            raise ScenarioError(
                f"{where}: pool {pool} out of range [0, {pools})"
            )
    else:
        _reject_unknown(params, ACTION_PARAMS[kind], where)
        _typed(params, ACTION_PARAMS[kind], where)
        _mode(params["mode"], where)
        pool = params.get("pool")
        if pool is not None and not (0 <= pool < pools):
            raise ScenarioError(
                f"{where}: pool {pool} out of range [0, {pools})"
            )
    return Action(at=float(at), kind=kind, params=params)


def validate_scenario(doc: dict, source: str = None) -> Scenario:
    """Validate one parsed scenario document -> :class:`Scenario`.
    Raises :class:`ScenarioError` with a precise message on the first
    violation; ``source`` (the scenario file's path) prefixes every
    message so a CI sweep over scenarios/ names the offending FILE,
    not just the offending key."""
    try:
        return _validate_scenario(doc)
    except ScenarioError as e:
        if source:
            raise ScenarioError(f"{source}: {e}") from None
        raise


def _validate_scenario(doc: dict) -> Scenario:
    if not isinstance(doc, dict):
        raise ScenarioError("scenario must be a JSON object")
    allowed = {
        "version", "schema", "name", "nodes", "pools", "chips_per_node",
        "initial_mode", "workers", "qps", "evidence", "attestation",
        "watch_timeout_s", "controllers", "actions", "converge",
        "regions",
    }
    _reject_unknown(doc, allowed, "scenario")
    if doc.get("version") != SCENARIO_VERSION:
        raise ScenarioError(
            f"version must be {SCENARIO_VERSION}, got "
            f"{doc.get('version')!r} (refusing a schema this reader "
            "does not understand)"
        )
    # 'schema' is the ADDITIVE revision: absent = 1 (pre-federation
    # documents), 2 unlocks 'regions' and the region fault family.
    # Anything else is a document from the future — refuse it.
    schema = doc.get("schema", 1)
    if isinstance(schema, bool) or not isinstance(schema, int) or \
            not (1 <= schema <= SCENARIO_SCHEMA_MAX):
        raise ScenarioError(
            f"schema must be an int in [1, {SCENARIO_SCHEMA_MAX}], got "
            f"{schema!r}"
        )
    if "regions" in doc and schema < 2:
        raise ScenarioError(
            "regions requires \"schema\": 2 (a schema-1 reader would "
            "reject the key)"
        )
    _typed(doc, {
        "name": (True, str),
        "nodes": (True, int),
        "pools": (False, int),
        "chips_per_node": (False, int),
        "initial_mode": (False, str),
        "workers": (False, int),
        "qps": (False, (int, float)),
        "evidence": (False, bool),
        "attestation": (False, bool),
        "watch_timeout_s": (False, (int, float)),
    }, "scenario")
    nodes = doc["nodes"]
    if not (1 <= nodes <= 4096):
        raise ScenarioError(f"nodes must be in [1, 4096], got {nodes}")
    pools = doc.get("pools", 1)
    if not (1 <= pools <= nodes):
        raise ScenarioError(
            f"pools must be in [1, nodes={nodes}], got {pools}")
    chips = doc.get("chips_per_node", 1)
    if not (1 <= chips <= 8):
        raise ScenarioError(
            f"chips_per_node must be in [1, 8], got {chips}")
    regions: List[RegionDef] = []
    raw_regions = doc.get("regions")
    if raw_regions is not None:
        if not isinstance(raw_regions, list) or not raw_regions:
            raise ScenarioError("regions must be a non-empty array")
        for i, raw in enumerate(raw_regions):
            where = f"regions[{i}]"
            if not isinstance(raw, dict):
                raise ScenarioError(f"{where}: must be an object")
            _reject_unknown(raw, {"name", "nodes", "pools"}, where)
            _typed(raw, {"name": (True, str), "nodes": (True, int),
                         "pools": (False, int)}, where)
            if not raw["name"]:
                raise ScenarioError(f"{where}: name must be non-empty")
            if raw["nodes"] < 1:
                raise ScenarioError(f"{where}: nodes must be >= 1")
            rpools = raw.get("pools", 1)
            if not (1 <= rpools <= raw["nodes"]):
                raise ScenarioError(
                    f"{where}: pools must be in [1, nodes="
                    f"{raw['nodes']}], got {rpools}"
                )
            regions.append(RegionDef(name=raw["name"],
                                     nodes=raw["nodes"], pools=rpools))
        names = [r.name for r in regions]
        if len(set(names)) != len(names):
            raise ScenarioError(
                f"regions: duplicate region names {sorted(names)}"
            )
        if sum(r.nodes for r in regions) != nodes:
            raise ScenarioError(
                f"regions: per-region nodes sum to "
                f"{sum(r.nodes for r in regions)}, but nodes={nodes} "
                "(the top-level total must stay truthful)"
            )
        if sum(r.pools for r in regions) != pools:
            raise ScenarioError(
                f"regions: per-region pools sum to "
                f"{sum(r.pools for r in regions)}, but pools={pools}"
            )
    region_names = {r.name for r in regions}
    workers = doc.get("workers", 8)
    if not (1 <= workers <= 64):
        raise ScenarioError(f"workers must be in [1, 64], got {workers}")
    qps = doc.get("qps", 0.0)
    if qps < 0:
        raise ScenarioError(f"qps must be >= 0 (0 = unthrottled), got {qps}")
    watch_timeout_s = doc.get("watch_timeout_s", 10.0)
    if watch_timeout_s <= 0:
        raise ScenarioError("watch_timeout_s must be > 0")
    initial_mode = _mode(doc.get("initial_mode", Mode.OFF.value), "initial_mode")

    raw_ctl = doc.get("controllers", {})
    if not isinstance(raw_ctl, dict):
        raise ScenarioError("controllers must be an object")
    _reject_unknown(raw_ctl, {"fleet", "policy", "leader_elect",
                              "shards"}, "controllers")
    for key, value in raw_ctl.items():
        if key == "shards":
            if isinstance(value, bool) or not isinstance(value, int):
                raise ScenarioError("controllers.shards must be an int")
            if not (0 <= value <= 64):
                raise ScenarioError(
                    f"controllers.shards must be in [0, 64], got {value}"
                )
        elif not isinstance(value, bool):
            raise ScenarioError(f"controllers.{key} must be a bool")
    controllers = Controllers(**raw_ctl)
    if controllers.leader_elect and not controllers.policy:
        raise ScenarioError(
            "controllers.leader_elect requires controllers.policy "
            "(the Lease being flapped belongs to the policy pair)"
        )
    if controllers.shards:
        if not controllers.fleet:
            raise ScenarioError(
                "controllers.shards requires controllers.fleet (the "
                "sharded plane is the fleet/policy controllers; with "
                "neither there is nothing to shard)"
            )
        if controllers.leader_elect:
            raise ScenarioError(
                "controllers.shards and controllers.leader_elect are "
                "mutually exclusive (shard leases are their own "
                "election; the flapped policy-pair Lease does not "
                "exist in sharded mode)"
            )

    raw_conv = doc.get("converge")
    if not isinstance(raw_conv, dict):
        raise ScenarioError("converge is required and must be an object")
    _reject_unknown(raw_conv, {"mode", "timeout_s"}, "converge")
    _typed(raw_conv, {"mode": (True, str),
                      "timeout_s": (False, (int, float))}, "converge")
    timeout_s = raw_conv.get("timeout_s", 120.0)
    if timeout_s <= 0:
        raise ScenarioError("converge.timeout_s must be > 0")
    converge = Converge(mode=_mode(raw_conv["mode"], "converge"),
                        timeout_s=float(timeout_s))

    raw_actions = doc.get("actions")
    if not isinstance(raw_actions, list) or not raw_actions:
        raise ScenarioError("actions is required and must be a "
                            "non-empty array")
    actions = [
        _validate_action(a, i, pools) for i, a in enumerate(raw_actions)
    ]
    attestation = doc.get("attestation", False)
    if attestation and not doc.get("evidence", False):
        raise ScenarioError(
            "attestation requires evidence (quotes ride evidence "
            "documents; without evidence there is nothing to attest)"
        )
    for a in actions:
        if a.kind == "create_policy" and not controllers.policy:
            raise ScenarioError(
                "create_policy action requires controllers.policy"
            )
        if a.kind == "fault" and a.params["fault"] in (
                "key_rotation", "root_revoked"):
            if not attestation:
                raise ScenarioError(
                    f"{a.params['fault']} fault requires attestation "
                    "(there is no signing key to rotate or trust root "
                    "to revoke otherwise)"
                )
            if not (controllers.fleet or controllers.shards):
                raise ScenarioError(
                    f"{a.params['fault']} fault requires a fleet audit "
                    "plane (controllers.fleet or controllers.shards) — "
                    "the attestation verdicts and the outage latch "
                    "live in the fleet scan"
                )
        if (a.kind == "fault" and a.params["fault"] == "policy_conflict"
                and not controllers.policy):
            raise ScenarioError(
                "policy_conflict fault requires controllers.policy"
            )
        if (a.kind == "fault" and a.params["fault"] == "leader_flap"
                and not controllers.leader_elect):
            raise ScenarioError(
                "leader_flap fault requires controllers.leader_elect"
            )
        if a.kind == "fault" and a.params["fault"] == "shard_kill":
            if not controllers.shards:
                raise ScenarioError(
                    "shard_kill fault requires controllers.shards > 0"
                )
            host = a.params.get("host", 0)
            if not (0 <= host < controllers.shards):
                raise ScenarioError(
                    f"shard_kill host {host} out of range "
                    f"[0, {controllers.shards})"
                )
        # federation cross-checks: region faults / per-region windows /
        # region-scoped revocation only mean something with regions,
        # and every named region must exist
        if a.kind == "fault" and a.params["fault"] in REGION_FAULTS:
            if not regions:
                raise ScenarioError(
                    f"{a.params['fault']} fault requires 'regions' "
                    "(\"schema\": 2)"
                )
            if a.params["region"] not in region_names:
                raise ScenarioError(
                    f"{a.params['fault']}: unknown region "
                    f"{a.params['region']!r}; known: "
                    f"{sorted(region_names)}"
                )
        if (a.kind == "fault" and a.params["fault"] == "root_revoked"
                and "region" in a.params):
            if not regions:
                raise ScenarioError(
                    "root_revoked 'region' requires 'regions' "
                    "(\"schema\": 2)"
                )
            if a.params["region"] not in region_names:
                raise ScenarioError(
                    f"root_revoked: unknown region "
                    f"{a.params['region']!r}; known: "
                    f"{sorted(region_names)}"
                )
        if a.kind == "set_mode" and "windows" in a.params:
            if not regions:
                raise ScenarioError(
                    "set_mode 'windows' requires 'regions' "
                    "(\"schema\": 2)"
                )
            for rname, offset in a.params["windows"].items():
                if rname not in region_names:
                    raise ScenarioError(
                        f"set_mode windows: unknown region {rname!r}; "
                        f"known: {sorted(region_names)}"
                    )
                if isinstance(offset, bool) or not isinstance(
                        offset, (int, float)) or offset < 0:
                    raise ScenarioError(
                        f"set_mode windows[{rname!r}] must be a "
                        "number of seconds >= 0"
                    )
    return Scenario(
        name=doc["name"],
        nodes=nodes,
        pools=pools,
        chips_per_node=chips,
        initial_mode=initial_mode,
        workers=workers,
        qps=float(qps),
        evidence=doc.get("evidence", False),
        attestation=attestation,
        watch_timeout_s=float(watch_timeout_s),
        controllers=controllers,
        actions=sorted(actions, key=lambda a: a.at),
        converge=converge,
        schema=schema,
        regions=tuple(regions),
    )


def load_scenario(path: str) -> Scenario:
    try:
        with open(path) as f:
            doc = json.load(f)
    except OSError as e:
        raise ScenarioError(f"cannot read {path}: {e}") from e
    except ValueError as e:
        raise ScenarioError(f"{path}: not valid JSON: {e}") from e
    return validate_scenario(doc, source=path)


def canonical_scenario_text(doc: dict) -> str:
    """The one true formatting for committed scenario files (2-space
    indent, sorted keys, trailing newline) — tests/test_simlab.py
    compares committed bytes against this, freshness-gate style."""
    return json.dumps(doc, indent=2, sort_keys=True) + "\n"
