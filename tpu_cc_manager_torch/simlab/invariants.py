"""The convergence-and-invariants oracle (ISSUE 12).

One reusable judgment over a finished simlab run: did the fleet not
only converge, but converge WITHOUT violating the contracts the
reconciler protocol promises under any interleaving of faults? The
property-based generator (simlab.propgen) runs every episode through
this oracle; hand-written scenarios and CI smokes can use it too — the
checks are feature-conditional, so a scenario without shards simply
skips the shard invariants.

The catalog (stable ids — shrink targets and reports key on them):

- ``convergence``      — every node reached converge.mode in budget
- ``half_flipped``     — no node's chips disagree at quiescence
- ``fail_secure``      — no CONVERGED node still holds a device at
  FLIP_LOCK_PERMS (a failing flip keeps its device locked; a verified
  one must reopen it — both directions of device/gate.py's contract)
- ``writes_per_flip``  — the fleet's logical node-write mutations stay
  inside the coalescing budget (≤ 1 state + 1 evidence unit per flip,
  plus exactly-accounted controller/fault writes) — the invariant that
  catches silent un-batching back toward the historical ~5 writes/flip
- ``leader_uniqueness`` — no shard partition held by two live hosts
- ``forged_evidence``  — a planted node-root forgery is never accepted:
  judged ``mismatch``, bucketed by the final audit, and the victim's
  chips never moved to the forged claim
- ``attestation_outage`` — a revoked verifier root LATCHES the
  attestation_outage problem and the fleet never reads verified again
- ``attestation_rotation`` — after a key rotation every node's settled
  evidence re-verifies under the NEW primary alone (no mismatch tail)
- ``region_attestation_latch`` — a region-scoped root revocation
  (federation) latches attestation_outage in the revoked region ONLY:
  sibling regions keep verifying, and the revoked region never reads
  verified again
- ``policy_conflict``  — the rival overlapping policy is parked in
  phase Conflicted; the owner is healthy
- ``upgrade_completeness`` — every upgraded replica is alive and its
  node advertises the new code version at quiescence
- ``evacuation_restored`` — no node is left cordoned by an evacuation
- ``exposition_valid`` — the merged fleet exposition (shards) and the
  observatory aggregation stayed valid

Checks read the LIVE lab (replica backends, gate recordings, the
store) plus the artifact — the oracle must see device truth, not just
what the labels claim.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Optional, Tuple

from tpu_cc_manager_torch import labels as L
from tpu_cc_manager_torch.device.gate import FLIP_LOCK_PERMS
from tpu_cc_manager_torch.modes import STATE_FAILED

log = logging.getLogger("tpu-cc-manager.simlab.invariants")

#: invariant id -> one-line contract (docs/simlab.md renders this)
INVARIANTS: Dict[str, str] = {
    "convergence": "every node reaches converge.mode within budget",
    "half_flipped": "no node's chips disagree on cc mode at quiescence",
    "fail_secure": "no converged node still holds a flip-locked device",
    "writes_per_flip": "node-write mutations stay in the coalescing "
                       "budget (~2 units per flip)",
    "leader_uniqueness": "no shard partition held by two live hosts",
    "forged_evidence": "a forged evidence document is never accepted "
                       "and never flips a chip",
    "attestation_outage": "a revoked verifier root latches the "
                          "attestation_outage problem",
    "attestation_rotation": "rotated-key evidence re-verifies under "
                            "the new primary alone",
    "region_attestation_latch": "a revoked region trust root latches "
                                "attestation_outage in THAT region "
                                "only — no spill, no spare",
    "policy_conflict": "the rival overlapping policy parks in phase "
                       "Conflicted; the owner stays healthy",
    "upgrade_completeness": "every upgraded replica is alive and "
                            "advertises its new version",
    "evacuation_restored": "no node is left cordoned by an evacuation",
    "exposition_valid": "merged fleet exposition / SLO aggregation "
                        "stayed valid",
}


@dataclasses.dataclass(frozen=True)
class Violation:
    """One broken invariant: a stable id, a human-readable detail, and
    the nodes involved (capped by the caller when rendering)."""

    invariant: str
    detail: str
    nodes: Tuple[str, ...] = ()

    def to_dict(self) -> dict:
        return {"invariant": self.invariant, "detail": self.detail,
                "nodes": list(self.nodes)[:16]}


def _fault_entries(artifact: dict, kind: str) -> List[dict]:
    return [f for f in artifact.get("faults") or []
            if f.get("fault") == kind]


# ------------------------------------------------------------- checks
def _check_convergence(lab, artifact, out: List[Violation]) -> None:
    if not artifact.get("ok"):
        out.append(Violation(
            "convergence",
            artifact.get("notes") or "scenario did not converge",
            tuple(artifact.get("pending_nodes") or ()),
        ))


def _check_half_flipped(lab, artifact, out: List[Violation]) -> None:
    for name, replica in sorted(lab.replicas.items()):
        modes = set()
        for chip in getattr(replica.backend, "chips", []):
            if not chip.is_cc_query_supported:
                continue
            try:
                modes.add(chip.query_cc_mode())
            except Exception:  # ccaudit: allow-swallow(an unqueryable chip is recorded as its own sentinel mode — disagreement, not silence)
                modes.add("<unqueryable>")
        if len(modes) > 1:
            out.append(Violation(
                "half_flipped",
                f"{name}: chips disagree on cc mode at quiescence: "
                f"{sorted(modes)}",
                (name,),
            ))


def _check_fail_secure(lab, artifact, out: List[Violation]) -> None:
    store = lab.server.store if lab.server is not None else None
    for name, replica in sorted(lab.replicas.items()):
        gate = getattr(replica, "gate", None)
        if gate is None or not hasattr(gate, "perms_snapshot"):
            continue
        locked = sorted(
            path for path, perms in gate.perms_snapshot().items()
            if perms == FLIP_LOCK_PERMS
        )
        if not locked:
            continue
        state = None
        if store is not None:
            try:
                state = store.peek_node_label(
                    name, L.CC_MODE_STATE_LABEL)
            except Exception:  # ccaudit: allow-swallow(post-run probe; an unreadable label reads as unknown and the check stays conservative)
                state = None
        # fail-secure is the point: a FAILED node keeping its device
        # locked is correct. A node whose label claims a successfully
        # applied mode while a device is still at FLIP_LOCK_PERMS has
        # handed workloads a gated chip — the contract break.
        if state is not None and state != STATE_FAILED:
            out.append(Violation(
                "fail_secure",
                f"{name}: state label claims {state!r} but device(s) "
                f"{locked} are still at FLIP_LOCK_PERMS",
                (name,),
            ))


def _check_writes_per_flip(lab, artifact, out: List[Violation]) -> None:
    store = lab.server.store if lab.server is not None else None
    if store is None:
        return
    mutations = store.node_write_stats()["mutations"]
    sc = lab.scenario
    flips = sum(
        r.outcomes.get("success", 0) for r in lab.replicas.values()
    )
    # the contract: a flip costs ONE state-label unit plus (when
    # enabled) ONE evidence unit, because everything else rides those
    # carriers. Controller- and fault-issued writes are accounted
    # exactly, not hidden in the ratio.
    per_flip = 1 + (1 if sc.evidence else 0)
    budget = flips * per_flip
    # policy-driven waves: desired label + trace annotation per node,
    # plus the rollout record churn on the anchor node
    n_policies = len(_fault_entries(artifact, "policy_conflict")) * 2
    n_policies += sum(1 for f in artifact.get("faults") or []
                      if f.get("action") == "create_policy")
    budget += n_policies * (2 * sc.nodes + 32)
    if lab.injector is not None:
        budget += lab.injector.fault_write_units
        # an upgraded replica publishes one version annotation unit
        budget += lab.injector.upgraded_total
    budget += max(8, sc.nodes // 4)  # failed-state / repair slack
    if mutations > budget:
        ratio = mutations / max(1, flips)
        out.append(Violation(
            "writes_per_flip",
            f"{mutations} node-write mutation units for {flips} flips "
            f"({ratio:.2f}/flip) exceeds the coalescing budget of "
            f"{budget} — the flip path is issuing uncoalesced writes",
        ))


def sample_shard_leadership(shard_manager) -> Optional[Violation]:
    """One at-most-one-leader-per-shard probe: any partition whose
    lease is held by TWO live hosts simultaneously is a split brain.
    propgen's episode runner samples this during the run; check_run
    takes a final sample at quiescence."""
    if shard_manager is None:
        return None
    held: Dict[str, List[str]] = {}
    for host in getattr(shard_manager, "hosts", []):
        if not host.alive:
            continue
        hostname = getattr(host, "name", None) or repr(host)
        for sid in host.held_shards():
            held.setdefault(sid, []).append(hostname)
    dup = {sid: hosts for sid, hosts in held.items() if len(hosts) > 1}
    if dup:
        return Violation(
            "leader_uniqueness",
            f"shard partition(s) held by multiple live hosts: {dup}",
        )
    return None


def _check_forged_evidence(lab, artifact, out: List[Violation]) -> None:
    attest_lab = getattr(lab, "attest_lab", None)
    if attest_lab is None or not attest_lab.forged:
        return
    import json as _json

    from tpu_cc_manager_torch.attest import judge_attestation

    reports = lab.final_fleet_reports()
    for entry in attest_lab.forged:
        node, claim, doc = entry["node"], entry["claim"], entry["doc"]
        verdict, detail = judge_attestation(doc, node)
        if verdict != "mismatch":
            out.append(Violation(
                "forged_evidence",
                f"{node}: forged document judged {verdict!r} "
                f"({detail}) — the measured-history contradiction was "
                "not read",
                (node,),
            ))
        # the forged claim must never have reached the silicon
        replica = lab.replicas.get(node)
        if replica is not None:
            flipped = [
                chip.path for chip in getattr(replica.backend, "chips", [])
                if chip.is_cc_query_supported
                and chip.query_cc_mode() == claim
            ]
            if flipped:
                out.append(Violation(
                    "forged_evidence",
                    f"{node}: device(s) {flipped} sit at the FORGED "
                    f"claim {claim!r} — a chip flipped on forged "
                    "evidence",
                    (node,),
                ))
        # if the forged document is still what the cluster serves, the
        # final audit must have flagged it (an honest later publish
        # replacing it is also acceptance-free — nothing to assert)
        store = lab.server.store if lab.server is not None else None
        if store is None or not reports:
            continue
        try:
            raw = (store.get_node(node)["metadata"].get("annotations")
                   or {}).get(L.EVIDENCE_ANNOTATION)
        except Exception:  # ccaudit: allow-swallow(post-run probe; a missing node/annotation means the forged doc is not live)
            raw = None
        planted = _json.dumps(doc, sort_keys=True,
                              separators=(",", ":"))
        if raw == planted:
            flagged = any(
                node in (audit.get("attestation_mismatch") or [])
                or node in (audit.get("invalid") or [])
                for audit in (
                    r.get("evidence_audit") or {} for r in reports
                )
            )
            if not flagged:
                out.append(Violation(
                    "forged_evidence",
                    f"{node}: forged document is live on the cluster "
                    "but the final fleet audit did not flag it",
                    (node,),
                ))


def _check_attestation_outage(lab, artifact,
                              out: List[Violation]) -> None:
    attest_lab = getattr(lab, "attest_lab", None)
    if attest_lab is None or not attest_lab.revoked:
        return
    revokes = _fault_entries(artifact, "root_revoked")
    if revokes and not any(f.get("armed_before_revoke")
                           for f in revokes):
        out.append(Violation(
            "attestation_outage",
            "the trust root was revoked before any fleet scan had "
            "verified a quote — the outage latch never armed, so the "
            "drill proved nothing (schedule the revocation later)",
        ))
        return
    reports = lab.final_fleet_reports()
    if not reports:
        out.append(Violation(
            "attestation_outage",
            "no fleet report available to judge the outage latch",
        ))
        return
    latched = False
    problem_line = False
    reverified = []
    for r in reports:
        audit = r.get("evidence_audit") or {}
        if audit.get("attestation_outage"):
            latched = True
        if any("attestation went unverifiable" in p
               for p in r.get("problems") or []):
            problem_line = True
        if audit.get("attestation_seen"):
            reverified.append(audit)
    if not latched:
        out.append(Violation(
            "attestation_outage",
            "verifier trust root revoked on a once-verified fleet but "
            "no final audit filled the attestation_outage bucket",
        ))
    if latched and not problem_line:
        out.append(Violation(
            "attestation_outage",
            "attestation_outage bucket filled but no fleet problems "
            "line surfaced it — the latch faded into a metric",
        ))
    if reverified:
        out.append(Violation(
            "attestation_outage",
            "a scan AFTER root revocation reported a verified quote — "
            "the fleet converged back to 'verified' without a trust "
            "root",
        ))


def _check_attestation_rotation(lab, artifact,
                                out: List[Violation]) -> None:
    attest_lab = getattr(lab, "attest_lab", None)
    if (attest_lab is None or attest_lab.rotations == 0
            or attest_lab.revoked):
        return
    import json as _json

    from tpu_cc_manager_torch.attest import judge_attestation

    store = lab.server.store if lab.server is not None else None
    if store is None:
        return
    stale: List[str] = []
    broken: List[str] = []
    primary = attest_lab.key.encode()
    for name in sorted(lab.replicas):
        try:
            raw = (store.get_node(name)["metadata"].get("annotations")
                   or {}).get(L.EVIDENCE_ANNOTATION)
        except Exception:  # ccaudit: allow-swallow(post-run probe; unreadable evidence is counted in the broken bucket below)
            raw = None
        if not raw:
            broken.append(name)
            continue
        try:
            doc = _json.loads(raw)
        except ValueError:
            broken.append(name)
            continue
        verdict, _detail = judge_attestation(doc, name, key=primary)
        if verdict != "ok":
            stale.append(f"{name}({verdict})")
    if broken:
        out.append(Violation(
            "attestation_rotation",
            f"{len(broken)} node(s) have no judgeable evidence after "
            "the rotation wave",
            tuple(broken),
        ))
    if stale:
        out.append(Violation(
            "attestation_rotation",
            "settled evidence does not verify under the rotated "
            f"primary alone: {stale[:8]} — the fleet never finished "
            "re-quoting",
            tuple(s.split("(")[0] for s in stale),
        ))


def _check_region_attestation(lab, artifact,
                              out: List[Violation]) -> None:
    """The federation trust-domain boundary (ISSUE 16): judged from
    the artifact's ``metrics.federation.attestation`` block — the
    FederationLab has no single store or env-global attest lab, so the
    per-region audits ARE the evidence surface."""
    fed = (artifact.get("metrics") or {}).get("federation") or {}
    att = fed.get("attestation") or {}
    revokes = [f for f in _fault_entries(artifact, "root_revoked")
               if f.get("regions_revoked")]
    if not att or not revokes:
        return
    if not any(f.get("armed_before_revoke") for f in revokes):
        out.append(Violation(
            "region_attestation_latch",
            "the region root was revoked before any of its fleet scans "
            "had verified a quote — the latch never armed, so the "
            "drill proved nothing (schedule the revocation later)",
        ))
        return
    revoked_regions = set()
    for f in revokes:
        revoked_regions.update(f["regions_revoked"])
    for region, a in sorted(att.items()):
        if region in revoked_regions:
            if not a.get("revoked"):
                out.append(Violation(
                    "region_attestation_latch",
                    f"region {region}: root_revoked fired but the "
                    "region's trust domain reads unrevoked",
                ))
            if not a.get("attestation_outage"):
                out.append(Violation(
                    "region_attestation_latch",
                    f"region {region}: trust root revoked on a "
                    "once-verified region but its final audit filled "
                    "no attestation_outage bucket",
                ))
        else:
            # the non-spill half: a sibling's revocation must never
            # reach this region's verifier or its verified count
            if a.get("attestation_outage"):
                out.append(Violation(
                    "region_attestation_latch",
                    f"region {region}: attestation_outage latched "
                    "without a revocation — a sibling region's revoked "
                    "root spilled across the trust-domain boundary",
                    tuple(a.get("attestation_outage") or ()),
                ))
            if a.get("attestation_seen") and not a.get(
                    "attestation_verified"):
                out.append(Violation(
                    "region_attestation_latch",
                    f"region {region}: lost all quote verification "
                    "though its own root was never revoked",
                ))


def _check_policy_conflict(lab, artifact, out: List[Violation]) -> None:
    conflicts = _fault_entries(artifact, "policy_conflict")
    if not conflicts:
        return
    phases = (artifact.get("controllers") or {}).get(
        "policy_phases") or {}
    for entry in conflicts:
        owner, rival = entry.get("owner"), entry.get("rival")
        if rival is not None and phases.get(rival) != "Conflicted":
            out.append(Violation(
                "policy_conflict",
                f"rival policy {rival!r} ended in phase "
                f"{phases.get(rival)!r}, not Conflicted — an "
                "overlapping claim was acted on",
            ))
        if owner is not None and phases.get(owner) in (
                "Conflicted", "Invalid", "Degraded"):
            out.append(Violation(
                "policy_conflict",
                f"owner policy {owner!r} ended unhealthy "
                f"({phases.get(owner)!r}) — the conflict rule parked "
                "the wrong side",
            ))


def _check_upgrade(lab, artifact, out: List[Violation]) -> None:
    if not _fault_entries(artifact, "agent_upgrade"):
        return
    store = lab.server.store if lab.server is not None else None
    dead: List[str] = []
    unadvertised: List[str] = []
    for name, replica in sorted(lab.replicas.items()):
        if replica.version == "v1":
            continue
        if not replica.alive:
            dead.append(name)
            continue
        advertised = None
        if store is not None:
            try:
                advertised = (store.get_node(name)["metadata"]
                              .get("annotations") or {}).get(
                    L.AGENT_VERSION_ANNOTATION)
            except Exception:  # ccaudit: allow-swallow(post-run probe; an unreadable annotation counts as unadvertised below)
                advertised = None
        if advertised != replica.version:
            unadvertised.append(name)
    if dead:
        out.append(Violation(
            "upgrade_completeness",
            f"{len(dead)} upgraded replica(s) never came back up",
            tuple(dead),
        ))
    if unadvertised:
        out.append(Violation(
            "upgrade_completeness",
            f"{len(unadvertised)} upgraded replica(s) never "
            "advertised their new version (the cc.agent-version "
            "publication was lost)",
            tuple(unadvertised),
        ))


def _check_evacuation(lab, artifact, out: List[Violation]) -> None:
    if lab.injector is None or not lab.injector.evacuated_nodes:
        return
    store = lab.server.store if lab.server is not None else None
    if store is None:
        return
    cordoned = []
    for name in sorted(set(lab.injector.evacuated_nodes)):
        try:
            node = store.get_node(name)
        except Exception:  # ccaudit: allow-swallow(post-run probe; a vanished node cannot be cordoned)
            continue
        if (node.get("spec") or {}).get("unschedulable"):
            cordoned.append(name)
    if cordoned:
        out.append(Violation(
            "evacuation_restored",
            f"{len(cordoned)} node(s) left cordoned after the "
            "evacuation window",
            tuple(cordoned),
        ))


def _check_exposition(lab, artifact, out: List[Violation]) -> None:
    m = artifact.get("metrics") or {}
    shards = m.get("shards")
    if shards is not None and shards.get(
            "merged_exposition_problems") not in (None, 0):
        out.append(Violation(
            "exposition_valid",
            "merged /fleet/metrics exposition invalid "
            f"({shards['merged_exposition_problems']} problem(s))",
        ))
    slo = m.get("slo")
    if isinstance(slo, dict) and slo.get("aggregation_problems"):
        out.append(Violation(
            "exposition_valid",
            "fleet metrics aggregation invalid: "
            f"{slo['aggregation_problems'][:2]}",
        ))


def check_run(lab, artifact,
              extra: Optional[List[Violation]] = None
              ) -> List[Violation]:
    """Judge one finished simlab run against the whole catalog.
    ``lab`` is the (torn-down) SimLab instance — replicas, gate
    recordings, store, and controllers stay readable after run() —
    and ``artifact`` its return value. ``extra`` carries violations a
    live probe observed mid-run (e.g. propgen's shard-leadership
    sampler). Returns violations in catalog order, empty = green."""
    out: List[Violation] = list(extra or [])
    _check_convergence(lab, artifact, out)
    _check_half_flipped(lab, artifact, out)
    _check_fail_secure(lab, artifact, out)
    _check_writes_per_flip(lab, artifact, out)
    final_sample = sample_shard_leadership(
        getattr(lab, "shard_manager", None))
    if final_sample is not None:
        out.append(final_sample)
    _check_forged_evidence(lab, artifact, out)
    _check_attestation_outage(lab, artifact, out)
    _check_attestation_rotation(lab, artifact, out)
    _check_region_attestation(lab, artifact, out)
    _check_policy_conflict(lab, artifact, out)
    _check_upgrade(lab, artifact, out)
    _check_evacuation(lab, artifact, out)
    _check_exposition(lab, artifact, out)
    order = list(INVARIANTS)
    out.sort(key=lambda v: (order.index(v.invariant)
                            if v.invariant in order else len(order)))
    return out
