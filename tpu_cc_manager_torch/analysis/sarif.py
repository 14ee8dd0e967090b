"""SARIF 2.1.0 output for ccaudit (v3 satellite).

``python -m tpu_cc_manager_torch.analysis --sarif ccaudit.sarif`` writes the
scan as a Static Analysis Results Interchange Format log alongside the
normal text/JSON output, so the CI ``ccaudit`` job can upload it and
findings annotate PR diffs inline (GitHub code scanning understands
SARIF natively).

The emitted subset is deliberately small and stable:

- one ``run`` with the ``ccaudit`` tool driver and one ``rule`` entry
  per rule id seen in the scan;
- one ``result`` per finding — ``level`` for *new* findings is the
  finding's severity (``error`` for every pre-v4 rule and
  ``loop-self-deadlock``; ``warning`` for the v4 asyncflow advisory
  families) and ``note`` for baselined ones, which additionally carry a
  ``suppressions`` entry (``kind: external``) so code-scanning UIs show
  them as suppressed rather than open;
- physical locations are repo-relative with ``uriBaseId: SRCROOT``.

``validate_sarif`` is the structural contract the test suite enforces —
the container has no jsonschema package, so the required-shape checks
are spelled out by hand against the 2.1.0 spec.
"""

from __future__ import annotations

import json
from typing import Dict, List, Sequence

from tpu_cc_manager_torch.analysis.core import Finding

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = (
    "https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
    "Schemata/sarif-schema-2.1.0.json"
)

#: one-line help per rule id, mirrored from docs/analysis.md
_RULE_HELP = {
    "raw-acquire": "Locks are acquired via `with`, or paired with a "
    "try/finally release.",
    "lock-order": "Potential ABBA deadlock: locks acquired in opposite "
    "orders across the transitive call graph.",
    "blocking-under-lock": "Blocking call (sleep/subprocess/socket/"
    "executor wait) reachable while a lock is held.",
    "label-literal": "Hard-coded protocol label literal outside "
    "labels.py.",
    "swallow": "Broad except handler that neither re-raises, logs, nor "
    "uses the bound exception.",
    "metric-name": "Metric name without exactly one declaration.",
    "protocol-literal": "Raw mode/state literal flowing into a "
    "label-write API.",
    "unvalidated-mode": "Mode label value reaching a device/subprocess "
    "sink without parse_mode().",
    "mode-exhaustive": "Mode dispatch that does not cover every enum "
    "member.",
    "protocol-liveness": "labels.py constant with no writer or no "
    "reader in the scanned tree.",
    "manifest-drift": "Deploy manifests / scenarios speaking a "
    "different protocol than labels.py/modes.py.",
    "race-lockset": "Shared location written with an empty or "
    "inconsistent guarding lockset across thread contexts.",
    # v4 — the asyncflow families
    "await-atomicity": "Read-check-write of shared state spans an "
    "await without a common asyncio.Lock — other coroutines interleave "
    "at the suspension point.",
    "lock-across-await": "A threading lock is held at an await — the "
    "whole event loop queues behind the lock's next owner.",
    "loop-affinity": "Loop-owned state (conn pool, futures, queues) "
    "touched from sync land outside the bridge's sanctioned routes.",
    "loop-self-deadlock": "bridge.call/gather or a bridge future's "
    ".result() from the loop thread — the loop waits on work only the "
    "loop can run.",
    "orphan-task": "create_task/ensure_future handle dropped, or a "
    "coroutine-valued call discarded without ever being awaited.",
    "async-exception": "An except exits an async request path without "
    "settling or propagating its pending entries "
    "(gather-settles-everything contract).",
    "retrace-hazard": "Jitted callable or jit factory invoked with a "
    "shape/static argument not derived from the bucket ladder "
    "(bucket_nodes/bucket_pools) — each distinct value is a silent "
    "multi-second XLA recompile in the tick path.",
    "host-sync-in-hot-path": "Implicit device-to-host transfer "
    "(float()/int()/np.asarray/.item()/iteration on a jit output) or "
    "block_until_ready() on a reconcile/scan hot path — stalls the "
    "controller thread; batch through one explicit jax.device_get.",
    "unserialized-dispatch": "A shard_map collective dispatched without "
    "holding _DISPATCH_LOCK (plan.py's contract): concurrent dispatch "
    "interleaves XLA's all-reduce rendezvous and parks participants in "
    "multi-second stalls.",
    "donation-violation": "Argument at a donate_argnums position read "
    "after the donating call — its device buffer now belongs to XLA.",
    "tracer-leak": "Traced value stored to self./module globals (runs "
    "once per retrace, not per call) or used in a Python if/while "
    "inside a jitted body (TracerBoolConversionError).",
    "unbounded-queue": "Queue/deque/asyncio.Queue constructed without "
    "a positive bound on the package surface — overload becomes memory "
    "growth and unbounded latency instead of an honest rejection "
    "(the aio writer backlog rides TPU_CC_KUBE_QUEUE).",
    "missing-deadline": "Blocking call or await on the reconcile/scan/"
    "flip closure with no timeout/deadline on some caller path — a "
    "wedged peer stalls the drain-flip-verify loop forever; wrap in "
    "wait_for, pass a timeout, or clamp against a deadline.",
    "retry-discipline": "Retry loop around an I/O sink missing backoff "
    "growth, jitter, or an attempt/deadline cap — uncapped immediate "
    "retries synchronize into a thundering herd exactly when the "
    "server is saturated.",
    "resource-leak": "Acquired socket/file/executor/tempfile/process "
    "not released on all exception paths — close it under try/finally, "
    "use a context manager, or visibly transfer ownership.",
    "stop-aware-wait": "Blocking wait on a controller thread that no "
    "stop/shutdown signal can interrupt — ride the _stop Event "
    "(self._stop.wait(t)) so SIGTERM never hangs a flip.",
    "stale-baseline": "Baseline entry matching no current finding — "
    "delete it (the ratchet only burns down).",
}


def _result(finding: Finding, suppressed: bool) -> dict:
    # a NEW finding surfaces at the finding's own severity ("error" for
    # every pre-v4 rule and loop-self-deadlock; "warning" for the v4
    # advisory families) — baselined findings demote to "note" with a
    # suppression either way
    out: dict = {
        "ruleId": finding.rule,
        "level": "note" if suppressed else finding.severity,
        "message": {"text": finding.message},
        "locations": [
            {
                "physicalLocation": {
                    "artifactLocation": {
                        "uri": finding.file,
                        "uriBaseId": "SRCROOT",
                    },
                    "region": {
                        "startLine": max(1, finding.line),
                        "snippet": {"text": finding.text},
                    },
                }
            }
        ],
    }
    if suppressed:
        out["suppressions"] = [
            {
                "kind": "external",
                "justification": "baselined in "
                "tpu_cc_manager_torch/analysis/baseline.json (the ratchet "
                "only burns down)",
            }
        ]
    return out


def to_sarif(
    new: Sequence[Finding],
    suppressed: Sequence[Finding],
    stale: Sequence[dict],
) -> dict:
    """Build the SARIF log dict for one ccaudit run. Stale baseline
    entries are reported as ``stale-baseline`` results so the gate's
    second failure mode annotates the PR too."""
    results: List[dict] = []
    rules_seen: Dict[str, None] = {}
    for f in new:
        results.append(_result(f, suppressed=False))
        rules_seen.setdefault(f.rule)
    for f in suppressed:
        results.append(_result(f, suppressed=True))
        rules_seen.setdefault(f.rule)
    for e in stale:
        rules_seen.setdefault("stale-baseline")
        results.append(
            {
                "ruleId": "stale-baseline",
                "level": "error",
                "message": {
                    "text": (
                        f"baseline entry for rule {e.get('rule')!r} "
                        "matches no current finding — delete it (or "
                        "--write-baseline)"
                    )
                },
                "locations": [
                    {
                        "physicalLocation": {
                            "artifactLocation": {
                                "uri": str(e.get("file", "")),
                                "uriBaseId": "SRCROOT",
                            },
                            "region": {
                                "startLine": max(1, int(e.get("line", 1)))
                            },
                        }
                    }
                ],
            }
        )
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [
            {
                "tool": {
                    "driver": {
                        "name": "ccaudit",
                        "informationUri": (
                            "https://github.com/tpu-cc-manager/"
                            "tpu-cc-manager/blob/main/docs/analysis.md"
                        ),
                        "rules": [
                            {
                                "id": rule,
                                "shortDescription": {
                                    "text": _RULE_HELP.get(rule, rule)
                                },
                            }
                            for rule in sorted(rules_seen)
                        ],
                    }
                },
                "columnKind": "utf16CodeUnits",
                "results": results,
            }
        ],
    }


def write_sarif(
    path: str,
    new: Sequence[Finding],
    suppressed: Sequence[Finding],
    stale: Sequence[dict],
) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(to_sarif(new, suppressed, stale), f, indent=1,
                  sort_keys=True)
        f.write("\n")


def validate_sarif(doc: dict) -> List[str]:
    """Structural validation against the SARIF 2.1.0 required shape
    (the container has no jsonschema package — the spec's MUSTs for the
    subset we emit are checked by hand). Returns a list of violations;
    empty means valid."""
    errors: List[str] = []

    def need(cond: bool, msg: str) -> None:
        if not cond:
            errors.append(msg)

    need(isinstance(doc, dict), "log must be an object")
    if not isinstance(doc, dict):
        return errors
    need(doc.get("version") == SARIF_VERSION,
         f"version must be {SARIF_VERSION!r}")
    runs = doc.get("runs")
    need(isinstance(runs, list) and len(runs) >= 1,
         "runs must be a non-empty array")
    for run in runs if isinstance(runs, list) else []:
        need(isinstance(run, dict), "run must be an object")
        if not isinstance(run, dict):
            continue
        driver = (run.get("tool") or {}).get("driver")
        need(isinstance(driver, dict), "run.tool.driver is required")
        if isinstance(driver, dict):
            need(isinstance(driver.get("name"), str) and driver["name"],
                 "driver.name must be a non-empty string")
            for rule in driver.get("rules", []):
                need(isinstance(rule.get("id"), str) and rule["id"],
                     "rule.id must be a non-empty string")
        rule_ids = {
            r.get("id")
            for r in (driver or {}).get("rules", [])
            if isinstance(r, dict)
        } if isinstance(driver, dict) else set()
        results = run.get("results", [])
        need(isinstance(results, list), "run.results must be an array")
        for res in results if isinstance(results, list) else []:
            need(isinstance(res.get("ruleId"), str),
                 "result.ruleId must be a string")
            need(res.get("level") in ("none", "note", "warning", "error"),
                 f"result.level invalid: {res.get('level')!r}")
            need(res.get("ruleId") in rule_ids,
                 f"result.ruleId {res.get('ruleId')!r} not declared in "
                 "driver.rules")
            msg = res.get("message")
            need(isinstance(msg, dict) and isinstance(msg.get("text"), str),
                 "result.message.text is required")
            for loc in res.get("locations", []):
                phys = loc.get("physicalLocation", {})
                art = phys.get("artifactLocation", {})
                need(isinstance(art.get("uri"), str),
                     "artifactLocation.uri must be a string")
                region = phys.get("region", {})
                start = region.get("startLine")
                need(isinstance(start, int) and start >= 1,
                     "region.startLine must be a positive integer")
            for sup in res.get("suppressions", []):
                need(sup.get("kind") in ("inSource", "external"),
                     f"suppression.kind invalid: {sup.get('kind')!r}")
    return errors
