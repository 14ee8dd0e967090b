"""Scenario artifact: the JSON document one simlab run leaves behind.

The artifact is the scenario's evidence — the convergence number the
bench trend gate compares (``pool<N>_convergence_s``), the watch-pump
lag distribution, the throttle-wait histogram delta, and the per-phase
p50 attribution — stamped with enough context (scenario name, limits,
fault log) that a regression reader can re-run the exact load."""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

ARTIFACT_VERSION = 1


def percentile(samples: List[float], q: float) -> Optional[float]:
    if not samples:
        return None
    s = sorted(samples)
    return round(s[min(len(s) - 1, max(0, int(q * len(s))))], 5)


def phase_percentiles(durations: Dict[str, List[float]],
                      q: float) -> Dict[str, float]:
    out = {}
    for name, durs in sorted(durations.items()):
        p = percentile(durs, q)
        if p is not None:
            out[name] = p
    return out


def convergence_key(nodes: int) -> str:
    """The trend-gated metric name: ``pool256_convergence_s`` for a
    256-node scenario (scripts/bench_trend.py compares it)."""
    return f"pool{nodes}_convergence_s"


def build_artifact(
    scenario,
    *,
    ok: bool,
    initial_convergence_s: Optional[float],
    convergence_s: Optional[float],
    pending: List[str],
    pump_stats: dict,
    throttle: dict,
    phase_durations: Dict[str, List[float]],
    replica_stats: dict,
    faults: List[dict],
    controllers: dict,
    trace_stitch: Optional[dict] = None,
    slo: Optional[dict] = None,
    incidents: Optional[dict] = None,
    shards: Optional[dict] = None,
    lifecycle: Optional[dict] = None,
    kube_io: Optional[dict] = None,
    federation: Optional[dict] = None,
    notes: Optional[str] = None,
) -> dict:
    metrics = {
        convergence_key(scenario.nodes): (
            round(convergence_s, 4) if convergence_s is not None else None
        ),
        "initial_convergence_s": (
            round(initial_convergence_s, 4)
            if initial_convergence_s is not None else None
        ),
        "watch_pump": pump_stats,
        "throttle": throttle,
        "phase_p50_s": phase_percentiles(phase_durations, 0.50),
        "phase_p95_s": phase_percentiles(phase_durations, 0.95),
        "reconciles": replica_stats,
    }
    if trace_stitch is not None:
        # the fleet-timeline stitch (runner._stitch_traces, ISSUE 8):
        # cross-process causal traces joined by trace id, and the
        # trend-gated end-to-end convergence latency derived from them
        metrics["trace_stitch"] = trace_stitch
        metrics["e2e_convergence_p99_s"] = trace_stitch.get(
            "e2e_convergence_p99_s")
    if shards is not None:
        # the sharded control plane's block (shard.py, ISSUE 11): ring
        # partition + live coverage, the lease handoff log, merged
        # fleet-view validity, and — when a shard_kill fault fired —
        # the kill -> fleet-converged latency the
        # shard_failover_convergence_s bench axis gates
        metrics["shards"] = shards
        metrics["shard_failover_convergence_s"] = shards.get(
            "failover_convergence_s")
    if lifecycle is not None:
        # the lifecycle-fault surface (ISSUE 12): code versions running
        # at quiescence, upgrade/evacuation accounting, and the
        # attestation lab's rotation/revocation/forgery record — what
        # the propgen invariants oracle judged, preserved for a
        # regression reader
        metrics["lifecycle"] = lifecycle
    if kube_io is not None:
        # which I/O core served the data plane (ISSUE 13): "aio" in
        # shared-loop mode, with the async client's dials/requests/
        # replays accounting — dials << requests is the multiplexing
        # the mode exists to prove
        metrics["kube_io"] = kube_io
    if federation is not None:
        # the multi-region block (federation.py, ISSUE 16): per-region
        # node-read ledgers (the zero-cross-region-reads evidence),
        # posture + evacuation record, per-region attestation audit,
        # and — when a region_evacuate fault fired AND the fleet
        # stabilized — the region_evac_convergence_s axis the bench
        # trend gate compares (absent on a failed drill, never a lie)
        metrics["federation"] = federation
        if "region_evac_convergence_s" in federation:
            metrics["region_evac_convergence_s"] = federation[
                "region_evac_convergence_s"]
    if slo is not None:
        # the fleet observatory's verdict (fleetobs.py, ISSUE 9):
        # per-objective burn rates + budget remaining, the alert log,
        # and the scrape/aggregation-validity accounting — or an
        # honest {"skipped": reason} when the engine couldn't run
        metrics["slo"] = slo
    if incidents is not None:
        # the anomaly watchdog's autopsy record (watchdog.py, ISSUE
        # 15): incident packets with window stats, exemplar trace ids
        # (resolved against the fleet-wide trace stitch), the live
        # profile, and capture latency — the in-run proof the
        # metrics → anomaly → exemplar → profile chain closed
        metrics["incidents"] = incidents
    artifact = {
        "artifact_version": ARTIFACT_VERSION,
        "scenario": scenario.name,
        "nodes": scenario.nodes,
        "ok": ok,
        "metrics": metrics,
        "faults": faults,
        "controllers": controllers,
        "limits": {
            "workers": scenario.workers,
            "qps": scenario.qps,
            "pools": scenario.pools,
            "chips_per_node": scenario.chips_per_node,
            "evidence": scenario.evidence,
        },
    }
    if pending:
        # name the stragglers: a failed run's artifact must be a lead,
        # not just a false
        artifact["pending_nodes"] = sorted(pending)[:16]
        artifact["pending_count"] = len(pending)
    if notes:
        artifact["notes"] = notes
    return artifact


def write_artifact(path: str, artifact: dict) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")
