"""Property-based lifecycle scenario generation (ISSUE 12).

simlab's committed scenarios test the failures we already imagined.
This module is the machine that finds the interleaving we didn't: a
SEEDED generator composes random timelines of infrastructure faults
(watch drops, crashes, 429 storms, shard kills) with the four
lifecycle fault families — rolling agent upgrades, attestation key
rotation / revoked trust root (with the node-root forgery drill),
overlapping-policy conflicts, and evacuation drains racing flips —
runs every episode through the live simlab harness, and judges it
with the reusable convergence-and-invariants oracle
(:mod:`simlab.invariants`).

On a violation the episode SHRINKS — QuickCheck/ddmin style: drop
fault events, then pull them earlier (reorder), re-running after each
edit and keeping only edits that still reproduce the same broken
invariant. The shrink order is derived from the seed, so a find
shrinks the same way twice. Every find is emitted as a replayable
``scenarios/gen-<seed>.json`` (canonical formatting — the file is a
first-class scenario, runnable with ``simlab run`` and promotable to a
named scenario by committing it) plus a report sidecar carrying the
violations and the stitched flight-recorder timeline.

Determinism contract: ``generate_episode(seed)`` is a pure function of
the seed (and the optional family override). The RUN of an episode is
real concurrent execution — the generator finds interleavings, it does
not fake them — so reproduction is probabilistic the way Jepsen's is:
same seed, same timeline, same faults, re-raced. The shrinker
re-verifies every step against a live re-run for exactly that reason.

CLI: ``python -m tpu_cc_manager simlab propgen --seeds 1,2,3``; the
``propgen-smoke`` CI job runs a fixed seed list through all four
families and requires zero violations (scripts/propgen_smoke.py).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import random
import threading
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

from tpu_cc_manager_torch.simlab.invariants import (
    Violation, check_run, sample_shard_leadership,
)
from tpu_cc_manager_torch.simlab.scenario import (
    ScenarioError, canonical_scenario_text, validate_scenario,
)

log = logging.getLogger("tpu-cc-manager.simlab.propgen")

#: the lifecycle fault families the generator composes (ISSUE 12);
#: "attestation" covers both the key_rotation and root_revoked drills.
#: "federation" (ISSUE 16) generates schema-2 multi-region episodes —
#: region partitions/blackouts/latency skews, region evacuations, and
#: the region-scoped revoked-root drill — run through FederationLab.
FAMILIES = ("upgrade", "attestation", "policy", "evacuation", "shards",
            "federation")

#: desired modes the generator draws from (never "ici": slice
#: semantics need multi-host topology the generated fleets don't have)
_MODES = ("on", "devtools", "off")

#: default convergence budget for generated episodes — generous, the
#: oracle's convergence invariant is about EVENTUAL convergence, not
#: speed (the bench axes judge speed)
_TIMEOUT_S = 75.0


def _rng(tag: str, seed: int) -> random.Random:
    return random.Random(f"tpu-cc-propgen-{tag}-{seed}")


# ---------------------------------------------------------- generation
def _pick_modes(rng: random.Random) -> Tuple[str, str]:
    """(intermediate wave mode, converge mode), distinct; the converge
    target is never the 'off' initial state, so convergence is a real
    fleet-wide change."""
    converge = rng.choice(("on", "devtools"))
    wave = rng.choice([m for m in _MODES if m != converge])
    return wave, converge


def _infra_extras(rng: random.Random, nodes: int) -> List[dict]:
    """0-2 composable infrastructure faults sprinkled into the early
    timeline — the generator's job is interleavings, and lifecycle
    events rarely get a quiet fleet."""
    pool = [
        {"action": "fault", "fault": "watch_drop", "count": 2},
        {"action": "fault", "fault": "agent_crash",
         "count": max(1, nodes // 4), "restart_after_s": 0.8},
        {"action": "fault", "fault": "write_429", "count": 20},
        {"action": "fault", "fault": "list_429", "count": 1},
        {"action": "fault", "fault": "watch_410"},
        {"action": "fault", "fault": "throttle_squeeze", "qps": 10,
         "duration_s": 0.5},
    ]
    extras = []
    for entry in rng.sample(pool, rng.randrange(0, 3)):
        entry = dict(entry)
        entry["at"] = round(rng.uniform(0.0, 0.6), 2)
        extras.append(entry)
    return extras


def generate_episode(seed: int,
                     families: Optional[Iterable[str]] = None) -> dict:
    """One scenario document, a pure function of ``seed`` (same seed →
    byte-identical doc). ``families`` overrides the seeded family
    choice — the smoke uses it to guarantee coverage of all four."""
    rng = _rng("gen", seed)
    if families is None:
        chosen = {FAMILIES[rng.randrange(len(FAMILIES))]}
        if chosen & {"upgrade", "evacuation"} and rng.random() < 0.5:
            chosen.add(rng.choice(("upgrade", "evacuation")))
    else:
        chosen = set(families)
        unknown = chosen - set(FAMILIES)
        if unknown:
            raise ValueError(f"unknown families: {sorted(unknown)}")
    if "federation" in chosen:
        # exclusive family: the multi-region lab drives region faults
        # and postures only — single-server fault kinds don't compose
        chosen = {"federation"}
    wave_mode, converge_mode = _pick_modes(rng)
    nodes = rng.choice((8, 10, 12, 16))
    pools = rng.choice((2, 4)) if nodes >= 8 else 1
    doc: dict = {
        "version": 1,
        "name": f"gen-{seed}",
        "nodes": nodes,
        "pools": pools,
        "chips_per_node": rng.choice((1, 2)),
        "initial_mode": "off",
        "workers": 4,
        "qps": 0,
        "evidence": False,
        "watch_timeout_s": 2,
        "converge": {"mode": converge_mode, "timeout_s": _TIMEOUT_S},
    }
    actions: List[dict] = []
    controllers: dict = {}

    if "federation" in chosen:
        # schema-2 multi-region episode (ISSUE 16): two regions, ONE
        # posture with per-region windows, plus either a region fault
        # racing the rollout or the region-scoped revoked-root drill
        nodes = rng.choice((8, 12, 16))
        half = nodes // 2
        doc.update({
            "schema": 2,
            "nodes": nodes,
            "pools": 2,
            "regions": [
                {"name": "region-a", "nodes": half, "pools": 1},
                {"name": "region-b", "nodes": nodes - half, "pools": 1},
            ],
        })
        controllers["fleet"] = True
        if rng.random() < 0.4:
            # region latch drill: converge first (the fault waits for
            # THAT region's fleet scans to verify a quote), then pull
            # ONE region's trust root — the oracle pins the non-spill
            doc["evidence"] = True
            doc["attestation"] = True
            actions.append({"at": 0.2, "action": "set_mode",
                            "mode": converge_mode})
            actions.append({"at": 2.0, "action": "fault",
                            "fault": "root_revoked",
                            "region": "region-a"})
        else:
            actions.append({
                "at": 0.2, "action": "set_mode", "mode": converge_mode,
                "windows": {"region-a": 0,
                            "region-b": rng.choice((0.3, 0.6))},
            })
            fault = rng.choice((
                {"fault": "region_partition", "region": "region-b",
                 "duration_s": rng.choice((0.5, 1.0))},
                {"fault": "region_blackout", "region": "region-b",
                 "duration_s": rng.choice((0.5, 1.0))},
                {"fault": "region_latency_skew", "region": "region-b",
                 "delay_s": 0.05,
                 "duration_s": rng.choice((0.5, 1.0))},
                {"fault": "region_evacuate", "region": "region-a"},
            ))
            fault.update({"at": round(rng.uniform(0.3, 0.7), 2),
                          "action": "fault"})
            actions.append(fault)
    elif "attestation" in chosen:
        doc["evidence"] = True
        doc["attestation"] = True
        controllers["fleet"] = True
        if rng.random() < 0.5:
            # rotation drill: wave, rotate mid-scan, converge wave —
            # every node must re-quote under the new primary
            actions.append({"at": 0.2, "action": "set_mode",
                            "mode": wave_mode})
            actions.append({"at": 1.0, "action": "fault",
                            "fault": "key_rotation"})
            actions.append({"at": 1.3, "action": "set_mode",
                            "mode": converge_mode})
        else:
            # revoked-root drill: converge first (the fault itself
            # waits for a VERIFIED fleet scan before revoking), then
            # pull the trust root; forge the node-root document half
            # the time
            actions.append({"at": 0.2, "action": "set_mode",
                            "mode": converge_mode})
            revoke = {"at": 2.0, "action": "fault",
                      "fault": "root_revoked"}
            if rng.random() < 0.5:
                revoke["forge"] = True
            actions.append(revoke)
    elif "policy" in chosen:
        controllers["policy"] = True
        actions.append({
            "at": 0.3, "action": "fault", "fault": "policy_conflict",
            "mode": converge_mode,
            "rival_mode": rng.choice(
                [m for m in _MODES if m != converge_mode]),
            "pool": rng.randrange(pools),
        })
    elif "shards" in chosen:
        controllers["fleet"] = True
        controllers["shards"] = 2
        actions.append({"at": 0.2, "action": "set_mode",
                        "mode": converge_mode})
        actions.append({"at": 0.5, "action": "fault",
                        "fault": "shard_kill", "host": rng.randrange(2)})
    else:
        actions.append({"at": 0.2, "action": "set_mode",
                        "mode": wave_mode})
        actions.append({"at": rng.choice((0.4, 0.6)),
                        "action": "set_mode", "mode": converge_mode})

    if "upgrade" in chosen:
        actions.append({
            "at": round(rng.uniform(0.2, 0.7), 2),
            "action": "fault", "fault": "agent_upgrade",
            "cohorts": rng.choice((2, 3)),
            "stagger_s": rng.choice((0.2, 0.4)),
        })
    if "evacuation" in chosen:
        actions.append({
            "at": round(rng.uniform(0.2, 0.5), 2),
            "action": "fault", "fault": "evacuation_drain",
            "count": max(1, nodes // 3),
            "duration_s": rng.choice((0.8, 1.5)),
        })
    if not chosen & {"attestation", "policy", "federation"}:
        actions.extend(_infra_extras(rng, nodes))

    if controllers:
        doc["controllers"] = controllers
    doc["actions"] = sorted(actions, key=lambda a: a.get("at", 0.0))
    validate_scenario(doc)  # the generator must only emit valid docs
    return doc


# ------------------------------------------------------------ episodes
@dataclasses.dataclass
class EpisodeResult:
    doc: dict
    artifact: dict
    violations: List[Violation]
    #: the live lab (post-run, torn down) for deeper inspection; not
    #: serialized into reports
    lab: object = dataclasses.field(repr=False, default=None)

    @property
    def ok(self) -> bool:
        return not self.violations


def run_episode(doc: dict, *,
                sample_interval_s: float = 0.1) -> EpisodeResult:
    """Run one scenario document through the live harness and the
    oracle. A background probe samples shard-leadership uniqueness
    during the run (post-hoc state can't see a transient split brain);
    fleet scans are accelerated (TPU_CC_FLEET_MIN_SCAN_GAP_S) so the
    attestation latch arms inside episode time."""
    from tpu_cc_manager_torch.simlab.federation import FederationLab
    from tpu_cc_manager_torch.simlab.runner import SimLab

    sc = validate_scenario(doc)
    prior_gap = os.environ.get("TPU_CC_FLEET_MIN_SCAN_GAP_S")
    os.environ["TPU_CC_FLEET_MIN_SCAN_GAP_S"] = "0.5"
    # schema-2 regions episodes run the multi-region lab (its artifact
    # carries the metrics.federation block the region invariants read)
    lab = FederationLab(sc) if sc.regions else SimLab(sc)
    stop = threading.Event()
    probe_hits: List[Violation] = []

    def probe() -> None:
        while not stop.is_set():
            v = sample_shard_leadership(
                getattr(lab, "shard_manager", None))
            if v is not None and not probe_hits:
                probe_hits.append(dataclasses.replace(
                    v, detail=v.detail + " (observed live, mid-run)"))
            stop.wait(sample_interval_s)

    thread = threading.Thread(target=probe, daemon=True,
                              name="propgen-leader-probe")
    thread.start()
    try:
        artifact = lab.run()
    finally:
        stop.set()
        thread.join(timeout=2)
        if prior_gap is None:
            os.environ.pop("TPU_CC_FLEET_MIN_SCAN_GAP_S", None)
        else:
            os.environ["TPU_CC_FLEET_MIN_SCAN_GAP_S"] = prior_gap
    violations = check_run(lab, artifact, extra=probe_hits)
    return EpisodeResult(doc=doc, artifact=artifact,
                         violations=violations, lab=lab)


# ------------------------------------------------------------ shrinking
def _drives_convergence(action: dict, converge_mode: str) -> bool:
    """Does this action initiate the fleet's change to the converge
    mode? (A set_mode wave, a policy, or the conflict fault's OWNER
    policy targeting it.)"""
    if action.get("action") in ("set_mode", "create_policy"):
        return action.get("mode") == converge_mode
    if (action.get("action") == "fault"
            and action.get("fault") == "policy_conflict"):
        return action.get("mode") == converge_mode
    return False


def shrink(doc: dict, reproduces: Callable[[dict], bool], *,
           seed: int = 0, max_runs: int = 32) -> Tuple[dict, int]:
    """Greedy delta-shrink of a violating episode: repeatedly try
    (a) DROPPING one action, then (b) REORDERING one action to the
    front of the timeline (``at`` → 0.0), keeping an edit only when
    ``reproduces(candidate)`` says the violation still fires.
    Candidates that fail schema validation are skipped (never
    counted); ``max_runs`` bounds the reproduction runs, since each
    may be a live fleet. Deterministic for a given ``seed``: the probe
    order is seeded, so the same find shrinks the same way twice.

    One structural rule on top of schema validity: if the ORIGINAL
    episode contains an action that initiates the converge-mode change
    (a set_mode wave / policy targeting converge.mode), every
    candidate must retain one. Dropping it would make ANY
    convergence-invariant find "reproduce" trivially — a fleet never
    told to converge proves nothing about the bug being shrunk.

    Returns (shrunk doc, reproduction runs spent). The shrunk doc is
    minimal w.r.t. single-action drops within the run budget — ddmin's
    1-minimality, the QuickCheck-style contract tests pin."""
    rng = _rng("shrink", seed)
    current = dict(doc)
    runs = 0
    converge_mode = (doc.get("converge") or {}).get("mode")
    must_keep_driver = converge_mode is not None and any(
        _drives_convergence(a, converge_mode) for a in doc["actions"]
    )

    def attempt(cand: dict) -> bool:
        nonlocal runs
        if runs >= max_runs:
            return False
        if must_keep_driver and not any(
                _drives_convergence(a, converge_mode)
                for a in cand["actions"]):
            return False  # structural, not a spent run
        try:
            validate_scenario(cand)
        except ScenarioError:
            return False
        runs += 1
        return bool(reproduces(cand))

    improved = True
    while improved and runs < max_runs:
        improved = False
        actions = current["actions"]
        order = list(range(len(actions)))
        rng.shuffle(order)
        # drop pass: fewer events beats everything else
        for i in order:
            if len(current["actions"]) <= 1:
                break
            cand = dict(current)
            cand["actions"] = (current["actions"][:i]
                               + current["actions"][i + 1:])
            if attempt(cand):
                current = cand
                improved = True
                break
        if improved:
            continue
        # reorder pass: pull one event to the front — "does the storm
        # need to arrive mid-flight, or does it break even first?"
        for i in order:
            acts = current["actions"]
            if i >= len(acts) or acts[i].get("at", 0.0) == 0.0:
                continue
            moved = dict(acts[i])
            moved["at"] = 0.0
            cand = dict(current)
            cand["actions"] = sorted(
                acts[:i] + [moved] + acts[i + 1:],
                key=lambda a: a.get("at", 0.0),
            )
            if cand["actions"] == acts:
                continue
            if attempt(cand):
                current = cand
                improved = True
                break
    return current, runs


def reproduces_violation(invariant: str) -> Callable[[dict], bool]:
    """A live reproduction predicate for :func:`shrink`: re-run the
    candidate episode and ask whether the SAME invariant still
    breaks (a shrink step that trades one violation for a different
    one is not a simplification of the find). The returned callable
    keeps the last REPRODUCING run as ``.last_result`` — that run
    belongs to the accepted (shrunk) document, so dump_find can pair
    the shrunk scenario with ITS OWN artifact and violations instead
    of the pre-shrink episode's."""

    def check(cand: dict) -> bool:
        try:
            result = run_episode(cand)
        except Exception:
            log.warning("shrink re-run crashed; treating as "
                        "non-reproducing", exc_info=True)
            return False
        hit = any(v.invariant == invariant for v in result.violations)
        if hit:
            check.last_result = result
        return hit

    check.last_result = None
    return check


# -------------------------------------------------------------- output
def dump_find(doc: dict, violations: Sequence[Violation],
              artifact: Optional[dict] = None, *,
              scenario_dir: str = "scenarios",
              report_dir: str = "propgen-finds",
              original_doc: Optional[dict] = None
              ) -> Tuple[str, str]:
    """Persist one find: the (possibly shrunk) episode as a REPLAYABLE
    canonical ``scenarios/gen-*.json`` — a first-class scenario file,
    promotable to a named scenario by committing it — plus a report
    sidecar (separate directory: everything under ``scenario_dir``
    must BE a scenario) carrying the violations, the stitched
    flight-recorder timeline, and the pre-shrink original."""
    name = doc.get("name") or "gen-unnamed"
    if not name.startswith("gen-"):
        name = f"gen-{name}"
    os.makedirs(scenario_dir, exist_ok=True)
    os.makedirs(report_dir, exist_ok=True)
    scenario_path = os.path.join(scenario_dir, f"{name}.json")
    with open(scenario_path, "w") as f:
        f.write(canonical_scenario_text(doc))
    report = {
        "scenario": name,
        "scenario_path": scenario_path,
        "violations": [v.to_dict() for v in violations],
        "invariants_checked": True,
    }
    if artifact is not None:
        report["artifact"] = artifact
        stitch = (artifact.get("metrics") or {}).get("trace_stitch")
        if stitch is not None:
            # the cross-process story of the failing run, stitched by
            # trace id (flightrec.stitch_by_trace) — the first thing a
            # triager reads
            report["timeline"] = stitch.get("timeline_example")
    if original_doc is not None and original_doc != doc:
        report["original_scenario"] = original_doc
    report_path = os.path.join(report_dir, f"{name}.report.json")
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
        f.write("\n")
    return scenario_path, report_path


# -------------------------------------------------------------- driver
def explore(seeds: Sequence[int], *,
            families: Optional[Iterable[str]] = None,
            shrink_finds: bool = True,
            max_shrink_runs: int = 8,
            scenario_dir: str = "scenarios",
            report_dir: str = "propgen-finds",
            log_fn: Callable[[str], None] = print) -> List[dict]:
    """Run one episode per seed; shrink and dump every find. Returns
    one summary dict per seed ({seed, name, ok, violations,
    scenario_path?, report_path?, convergence})."""
    from tpu_cc_manager_torch.simlab.report import convergence_key

    summaries: List[dict] = []
    for seed in seeds:
        doc = generate_episode(seed, families=families)
        log_fn(f"propgen: seed {seed} — {doc['name']} "
               f"({doc['nodes']} nodes, {len(doc['actions'])} actions)")
        result = run_episode(doc)
        summary: dict = {
            "seed": seed,
            "name": doc["name"],
            "ok": result.ok,
            "violations": [v.to_dict() for v in result.violations],
            "convergence": (result.artifact.get("metrics") or {}).get(
                convergence_key(doc["nodes"])),
        }
        if not result.ok:
            log_fn(f"propgen: seed {seed} VIOLATED: "
                   + "; ".join(f"{v.invariant}: {v.detail}"
                               for v in result.violations[:3]))
            shrunk, spent = doc, 0
            dump_result = result
            if shrink_finds and max_shrink_runs > 0:
                target = result.violations[0].invariant
                repro = reproduces_violation(target)
                shrunk, spent = shrink(
                    doc, repro, seed=seed, max_runs=max_shrink_runs,
                )
                if shrunk != doc and repro.last_result is not None:
                    # the report must describe the SHRUNK episode's own
                    # run — timeline and violations from the pre-shrink
                    # run would reference actions the persisted
                    # scenario no longer contains
                    dump_result = repro.last_result
                log_fn(f"propgen: shrink kept "
                       f"{len(shrunk['actions'])}/"
                       f"{len(doc['actions'])} actions "
                       f"({spent} re-runs)")
            spath, rpath = dump_find(
                shrunk, dump_result.violations, dump_result.artifact,
                scenario_dir=scenario_dir, report_dir=report_dir,
                original_doc=doc,
            )
            summary.update(scenario_path=spath, report_path=rpath,
                           shrink_runs=spent)
            log_fn(f"propgen: find persisted — replay with "
                   f"`python -m tpu_cc_manager simlab run {spath}`")
        summaries.append(summary)
    return summaries


def main_from_args(args) -> int:
    """CLI dispatch for ``simlab propgen`` (called via
    tpu_cc_manager.simlab.main_from_args)."""
    try:
        seeds = [int(s) for s in str(args.seeds).split(",") if s != ""]
    except ValueError:
        print(f"propgen: --seeds must be a comma-separated int list, "
              f"got {args.seeds!r}")
        return 2
    if not seeds:
        print("propgen: no seeds given")
        return 2
    families = None
    if args.families:
        families = [f for f in args.families.split(",") if f]
        unknown = sorted(set(families) - set(FAMILIES))
        if unknown:
            print(f"propgen: unknown families {unknown}; known: "
                  f"{sorted(FAMILIES)}")
            return 2
    summaries = explore(
        seeds,
        families=families,
        shrink_finds=not args.no_shrink,
        max_shrink_runs=args.max_shrink_runs,
        scenario_dir=args.scenario_dir,
        report_dir=args.report_dir,
    )
    print(json.dumps(summaries, indent=2, sort_keys=True))
    return 0 if all(s["ok"] for s in summaries) else 1
