"""L4 — configuration: flags-over-env, no config files (SURVEY.md §5.6).

Every flag defaults from an environment variable, exactly as the reference
does across its three implementations (reference cmd/main.go:83-117,
main.py:703-759, scripts/cc-manager.sh:5-6):

========================  =============================  =======================
flag                      env                            default
========================  =============================  =======================
--kubeconfig              KUBECONFIG                     in-cluster, else ~/.kube/config
--default-cc-mode / -m    DEFAULT_CC_MODE                "on"
--node-name               NODE_NAME                      (required)
--debug                   CC_MANAGER_DEBUG               false
(none)                    OPERATOR_NAMESPACE             "tpu-system"
(none)                    EVICT_OPERATOR_COMPONENTS      "true"
(none)                    DRAIN_STRATEGY                 "components" | "node" | "none"
(none)                    CC_READINESS_FILE              /run/tpu/validations/.cc-manager-ctr-ready
(none)                    CC_CAPABLE_DEVICE_IDS          "" (all Google chips capable)
--health-port             HEALTH_PORT                    8089 (0 disables)
(none)                    SLICE_COORDINATION             "false"
(none)                    TPU_CC_SLICE_COMMIT_TIMEOUT_S  600 (quorum wait before abort)
(none)                    REPAIR_INTERVAL_S              30 (0 disables self-repair)
(none)                    CC_TRACE_FILE                  "" (JSONL span sink off)
(none)                    TPU_CC_TRACE_JSONL_MAX_MB      0 (size cap on the JSONL span
                                                        sink; rotates to <path>.1 —
                                                        0/unset = unbounded)
(none)                    TPU_CC_LOG_FORMAT              "text" | "json" (JSON records
                                                        carry the active trace_id/span_id
                                                        so logs and traces join)
(none)                    TPU_CC_FLIGHTREC_DIR           "" (flight-recorder dump dir;
                                                        unset = no dumps written, the
                                                        /debug/flightrec route still
                                                        serves the live snapshot)
(none)                    EMIT_EVENTS                    true (reconcile Events)
(none)                    TPU_CC_DEVICE_GATING           "chmod" | "none" (device-node gating)
(none)                    TPU_CC_HOLDER_CHECK            "proc" | "none" (exclusive-hold scan)
(none)                    TPU_CC_RUNTIME_RESTART_CMD     "" (hook to evict an external holder)
(none)                    TPU_CC_HOLD_WAIT_S             30 (grace period for holders to leave)
(none)                    TPU_CC_EVIDENCE                true (per-flip evidence annotation)
(none)                    TPU_CC_EVIDENCE_KEY[_FILE]     "" (HMAC key; unset = plain sha256)
(none)                    TPU_CC_EVIDENCE_OLD_KEYS_FILE  "" (retired keys, one per line,
                                                        verify-only — key rotation)
(none)                    TPU_CC_KUBE_QPS[/_BURST]       0 = off (client-side API flow
                                                        control; controllers set 50 —
                                                        client-go QPS/Burst parity)
(none)                    TPU_CC_KUBE_AIO                unset (1 = the async I/O core:
                                                        one event loop multiplexing
                                                        pipelined connections behind a
                                                        sync facade — docs/io.md; not
                                                        for exec-plugin auth)
(none)                    TPU_CC_KUBE_INFLIGHT           4 (per-connection pipelined
                                                        in-flight window, async core)
(none)                    TPU_CC_FLEET_MIN_SCAN_GAP_S    5 (coalescing gap between
                                                        watch-triggered fleet scans)
(none)                    TPU_CC_POLICY_MIN_SCAN_GAP_S   2 (coalescing gap after any
                                                        policy-scan wake)
(none)                    TPU_CC_MAX_ROLLOUTS            3 (policy controller rollout
                                                        worker slots: disjoint pools
                                                        roll concurrently; 1 = strict
                                                        serialization)
(none)                    TPU_CC_IDENTITY                auto | gce | fake | none (platform
                                                        identity attached to evidence)
(none)                    TPU_CC_IDENTITY_KEY[_FILE]     "" (HS256 key, fake provider only)
(none)                    TPU_CC_IDENTITY_AUDIENCE       tpu-cc-manager (token audience)
(none)                    TPU_CC_IDENTITY_JWKS_FILE      "" (JWKS for offline RS256
                                                        verification of GCE tokens)
(none)                    TPU_CC_EVIDENCE_SYNC_INTERVAL_S 300 (native agent: idle-tick
                                                        evidence healer; 0 disables)
(none)                    TPU_CC_WEBHOOK_REQUIRE_DOCTOR  false (webhook also pins opted-in
                                                        pods to cc.doctor.ok=true nodes)
(none)                    TPU_CC_METADATA_HOST           metadata.google.internal
(none)                    TPU_CC_REQUIRE_IDENTITY        false (verifiers flag identity-less
                                                        evidence even on uniform pools)
(none)                    TPU_CC_ATTESTATION             auto | fake | confidential-space |
                                                        none (TEE quote over evidence;
                                                        auto = CS launcher socket if
                                                        present)
(none)                    TPU_CC_TPM_STATE_DIR           $TPU_CC_STATE_DIR/tpm (FakeTpm
                                                        PCR + measured flip log)
(none)                    TPU_CC_TPM_KEY[_FILE]          "" (FakeTpm quote key — the test
                                                        double's AIK stand-in)
(none)                    TPU_CC_ATTESTATION_JWKS_FILE   "" (JWKS for offline verification
                                                        of Confidential Space tokens)
(none)                    TPU_CC_REQUIRE_ATTESTATION     false (verifiers flag quote-less
                                                        evidence even on uniform pools)
(none)                    KUBE_API_TLS                   false (native agent + bash engine:
                                                        direct HTTPS, no proxy sidecar)
(none)                    KUBE_CA_FILE                   serviceaccount ca.crt (with TLS)
(none)                    BEARER_TOKEN_FILE              "" (SA token for direct API auth)
--interval (fleet)        FLEET_SCAN_INTERVAL            30 (seconds)
--port (fleet)            FLEET_PORT                     8090
(none)                    TPU_CC_LEADER_ELECT            false (controllers: Lease-based
                                                        leader election; replicas: 2 safe)
(none)                    POD_NAME                       "" (lease holder identity; the
                                                        manifests set it via downward API)
(none)                    OPERATOR_NAMESPACE             tpu-system (also where the
                                                        election Leases live)
(none)                    TPU_CC_SIMLAB_WORKERS          0 = scenario's value (simlab:
                                                        reconcile worker slots shared
                                                        by all replicas)
========================  =============================  =======================
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional

from tpu_cc_manager_torch import __version__
from tpu_cc_manager_torch import labels as L

#: Readiness file signalling "initial reconcile done" to the validation
#: framework (reference main.py:64: /run/nvidia/validations/...).
DEFAULT_READINESS_FILE = "/run/tpu/validations/.cc-manager-ctr-ready"


def _env_float(name: str, default: float) -> float:
    """Float env knob: unset, empty, or unparseable reads as the
    default (a typo must degrade to documented behavior, not crash a
    controller at startup)."""
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass
class AgentConfig:
    node_name: str
    default_mode: str = "on"
    kubeconfig: Optional[str] = None
    debug: bool = False
    operator_namespace: str = "tpu-system"
    evict_components: bool = True
    drain_strategy: str = "components"  # components | node | none
    readiness_file: str = DEFAULT_READINESS_FILE
    health_port: int = 8089
    slice_coordination: bool = False
    #: Seconds between self-repair retries of a failed reconcile (device
    #: fault or slice abort). The reference only retries on the *next
    #: label event* (cmd/main.go:164-167) — which for a half-flipped
    #: slice never comes, because the desired label is already correct.
    #: 0 disables.
    repair_interval_s: float = 30.0
    trace_file: Optional[str] = None
    #: Log record format: "text" (historical) or "json" — JSON records
    #: carry the active trace_id/span_id (obs.JsonLogFormatter), so
    #: logs and traces join on one key. TPU_CC_LOG_FORMAT.
    log_format: str = "text"
    #: Directory the flight recorder (tpu_cc_manager.flightrec) dumps
    #: its black-box JSON artifacts into on reconcile failure and
    #: SIGTERM. None = dumps disabled; the /debug/flightrec route
    #: serves the live snapshot either way. TPU_CC_FLIGHTREC_DIR.
    flightrec_dir: Optional[str] = None
    #: Emit core/v1 Events on reconcile outcomes so `kubectl describe
    #: node` shows the mode-flip history (the reference surfaces outcomes
    #: only in labels + pod logs). Best-effort; EMIT_EVENTS=false disables.
    emit_events: bool = True
    #: Publish the per-flip attestation evidence annotation
    #: (tpu_cc_manager.evidence). Best-effort; TPU_CC_EVIDENCE=false
    #: disables.
    emit_evidence: bool = True
    #: Seconds between periodic doctor self-checks published as the
    #: cc.doctor node annotation (tpu_cc_manager.doctor), keeping the
    #: fleet controller's trust-surface aggregation fresh without
    #: operator action. 0 disables. TPU_CC_DOCTOR_INTERVAL_S.
    doctor_interval_s: float = 300.0
    #: Seconds a slice member waits for quorum before aborting the round
    #: (slice_coord). Shared by the agent, the one-shot CLI, and through
    #: it the bash engine's slice delegation. TPU_CC_SLICE_COMMIT_TIMEOUT_S.
    slice_commit_timeout_s: float = 600.0

    def __post_init__(self):
        if self.log_format not in ("text", "json"):
            raise ValueError(
                f"invalid TPU_CC_LOG_FORMAT {self.log_format!r}: "
                "must be text|json"
            )
        if self.drain_strategy not in ("components", "node", "none"):
            raise ValueError(
                f"invalid DRAIN_STRATEGY {self.drain_strategy!r}: "
                "must be components|node|none"
            )
        if self.repair_interval_s < 0:
            raise ValueError(
                f"invalid REPAIR_INTERVAL_S {self.repair_interval_s!r}: "
                "must be >= 0 (0 disables self-repair)"
            )
        if self.doctor_interval_s < 0:
            raise ValueError(
                f"invalid TPU_CC_DOCTOR_INTERVAL_S "
                f"{self.doctor_interval_s!r}: must be >= 0 (0 disables)"
            )
        if self.slice_commit_timeout_s <= 0:
            raise ValueError(
                f"invalid TPU_CC_SLICE_COMMIT_TIMEOUT_S "
                f"{self.slice_commit_timeout_s!r}: must be > 0"
            )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu-cc-manager",
        description="TPU confidential-computing mode manager for Kubernetes",
    )
    p.add_argument(
        "--version", action="version",
        # native-agent parity (agent.cpp --version; reference Go agent's
        # urfave/cli -v): the image smoke and operators both probe it
        version=f"%(prog)s {__version__}",
    )
    p.add_argument(
        "--kubeconfig",
        default=os.environ.get("KUBECONFIG"),
        help="path to kubeconfig; omit for in-cluster config",
    )
    p.add_argument(
        "-m",
        "--default-cc-mode",
        default=os.environ.get("DEFAULT_CC_MODE", "on"),
        help="mode applied when the node has no cc.mode label (default: on)",
    )
    p.add_argument(
        "--node-name",
        default=os.environ.get("NODE_NAME"),
        help="this node's name (env NODE_NAME; required)",
    )
    p.add_argument(
        "--health-port",
        type=int,
        default=int(os.environ.get("HEALTH_PORT", "8089")),
        help="port for /healthz + /metrics (0 disables; default 8089)",
    )
    p.add_argument(
        "--debug",
        action="store_true",
        default=_env_bool("CC_MANAGER_DEBUG", False),
        help="enable debug logging",
    )
    # one-shot engine subcommands (parity with the bash engine CLI,
    # reference scripts/cc-manager.sh:472-533)
    sub = p.add_subparsers(dest="command")
    set_p = sub.add_parser("set-cc-mode", help="apply a mode once and exit")
    set_p.add_argument("-m", "--mode", required=True)
    set_p.add_argument(
        "-a", "--all-devices", action="store_true", default=True,
        help="operate on all devices (the only supported scope)",
    )
    sub.add_parser("get-cc-mode", help="print per-device modes and exit")
    probe = sub.add_parser(
        "probe-devices",
        help="print the device inventory as JSON (no NODE_NAME needed). "
             "Default backend: cuda — the live CUDA devices, i.e. hardware "
             "truth; pass --backend sysfs to inspect the surface a "
             "sysfs-backend agent actually manages.",
    )
    probe.add_argument(
        "--backend",
        choices=("cuda", "sysfs", "fake"),
        default=os.environ.get("TPU_CC_DEVICE_BACKEND", "cuda"),
        help="device backend to probe (env TPU_CC_DEVICE_BACKEND; "
             "default cuda)",
    )
    roll = sub.add_parser(
        "rollout",
        help="roll a mode change across the pool, bounded by a "
             "disruption window (operator-side; no NODE_NAME needed)",
    )
    roll.add_argument("-m", "--mode", default=None,
                      help="target mode (not needed with --resume)")
    roll.add_argument(
        "--resume", action="store_true",
        help="resume the pool's unfinished rollout from its durable "
             "record (anchor-node annotation) after an operator-side "
             "crash; mode/window/budget come from the record",
    )
    roll.add_argument(
        "--selector",
        default=None,
        help="label selector scoping the pool (default: "
             f"{L.TPU_ACCELERATOR_LABEL}). With --resume, an EXPLICIT "
             "selector narrows the search to that pool only — it will "
             "not wander into another pool's unfinished record",
    )
    roll.add_argument(
        "--max-unavailable", type=int, default=1,
        help="slice groups in flight at once (default 1)",
    )
    roll.add_argument(
        "--failure-budget", type=int, default=0,
        help="failed groups tolerated before aborting (default 0)",
    )
    roll.add_argument(
        "--canary", type=int, default=0,
        help="first N groups roll serially and must each succeed "
             "before the window opens; any canary failure aborts "
             "(default 0 = no canary)",
    )
    roll.add_argument(
        "--group-timeout", type=float, default=600.0,
        help="seconds to wait for one group to converge (default 600)",
    )
    roll.add_argument(
        "--force", action="store_true",
        help="proceed despite failed nodes / half-flipped slices",
    )
    roll.add_argument(
        "--dry-run", action="store_true",
        help="print the group plan without patching anything",
    )
    roll.add_argument(
        "--no-verify-evidence", action="store_true",
        help="trust cc.mode.state labels without cross-checking the "
             "per-node attestation evidence",
    )
    fleet = sub.add_parser(
        "fleet-controller",
        help="run the read-only fleet audit service: periodic JAX fleet "
             "scans served as /metrics + /report (operator-side; no "
             "NODE_NAME needed)",
    )
    fleet.add_argument(
        "--selector",
        default=L.TPU_ACCELERATOR_LABEL,
        help="label selector scoping the fleet",
    )
    fleet.add_argument(
        "--interval", type=float,
        default=float(os.environ.get("FLEET_SCAN_INTERVAL", "30")),
        help="seconds between fleet scans (default 30)",
    )
    fleet.add_argument(
        "--port", type=int,
        default=int(os.environ.get("FLEET_PORT", "8090")),
        help="HTTP port for /metrics, /report, /healthz (default 8090)",
    )
    fleet.add_argument(
        "--once", action="store_true",
        help="run one fleet scan, print the report, and exit non-zero "
             "if the audit found problems (failed nodes, evidence "
             "issues, failing doctor verdicts, half-flipped slices) — "
             "cron/CI usage",
    )
    pol = sub.add_parser(
        "policy-controller",
        help="run the declarative TPUCCPolicy controller: continuously "
             "reconcile the fleet to the modes the cluster's TPUCCPolicy "
             "objects declare, driving bounded rollouts and publishing "
             "status (operator-side; no NODE_NAME needed)",
    )
    pol.add_argument(
        "--interval", type=float,
        default=float(os.environ.get("POLICY_SCAN_INTERVAL", "30")),
        help="seconds between policy scans (default 30)",
    )
    pol.add_argument(
        "--port", type=int,
        default=int(os.environ.get("POLICY_PORT", "8091")),
        help="HTTP port for /metrics, /report, /healthz (default 8091)",
    )
    pol.add_argument(
        "--no-verify-evidence", action="store_true",
        help="trust cc.mode.state labels without cross-checking the "
             "per-node attestation evidence",
    )
    pol.add_argument(
        "--once", action="store_true",
        help="run one reconcile pass, print the report, and exit "
             "non-zero if any policy is Invalid/Conflicted/Degraded "
             "(cron/CI usage)",
    )
    wh = sub.add_parser(
        "webhook",
        help="run the admission webhook: steer pods labeled "
             f"{L.REQUIRES_CC_LABEL} onto nodes whose observed mode "
             "matches, and reject contradictory specs (operator-side; "
             "no NODE_NAME needed)",
    )
    wh.add_argument(
        "--port", type=int,
        default=int(os.environ.get("WEBHOOK_PORT", "8443")),
        help="HTTPS port for /mutate, /validate, /healthz (default 8443)",
    )
    wh.add_argument(
        "--cert", default=os.environ.get("WEBHOOK_CERT"),
        help="TLS server certificate (env WEBHOOK_CERT; required)",
    )
    wh.add_argument(
        "--key", default=os.environ.get("WEBHOOK_KEY"),
        help="TLS server key (env WEBHOOK_KEY; defaults to --cert)",
    )
    sim = sub.add_parser(
        "simlab",
        help="fleet-scale scenario lab: run hundreds of live reconciling "
             "agent replicas against the in-process wire-level API "
             "server, execute a declarative scenario (mode storms, "
             "policy rollouts, scripted faults), and emit a JSON "
             "artifact (operator/CI-side; no NODE_NAME needed) — see "
             "docs/simlab.md",
    )
    simsub = sim.add_subparsers(dest="simlab_command")
    sim_run = simsub.add_parser(
        "run", help="execute one scenario file and print the artifact"
    )
    sim_run.add_argument("scenario", help="path to a scenario JSON file")
    sim_run.add_argument(
        "--out", default=None,
        help="also write the artifact JSON to this path",
    )
    sim_run.add_argument(
        "--nodes", type=int, default=0,
        help="override the scenario's node count (0 = as written)",
    )
    sim_run.add_argument(
        "--workers", type=int, default=0,
        help="override the scenario's worker-slot count (0 = as "
             "written; env TPU_CC_SIMLAB_WORKERS also overrides)",
    )
    sim_val = simsub.add_parser(
        "validate", help="validate scenario files against the schema"
    )
    sim_val.add_argument("scenarios", nargs="+",
                         help="scenario JSON files to validate")
    sim_pg = simsub.add_parser(
        "propgen",
        help="property-based lifecycle scenario generation: run seeded "
             "random fault/lifecycle interleavings through the live "
             "harness and the convergence-and-invariants oracle; "
             "violations shrink and persist as replayable "
             "scenarios/gen-*.json (docs/simlab.md)",
    )
    sim_pg.add_argument(
        "--seeds", default="1,2,3,4",
        help="comma-separated episode seeds (default 1,2,3,4)",
    )
    sim_pg.add_argument(
        "--families", default="",
        help="restrict episodes to these fault families (comma-"
             "separated: upgrade,attestation,policy,evacuation,shards; "
             "default: seeded choice)",
    )
    sim_pg.add_argument(
        "--no-shrink", action="store_true",
        help="persist finds without the shrink pass",
    )
    sim_pg.add_argument(
        "--max-shrink-runs", type=int, default=8,
        help="reproduction-run budget per shrink (default 8)",
    )
    sim_pg.add_argument(
        "--scenario-dir", default="scenarios",
        help="where replayable gen-*.json finds land (default "
             "scenarios/)",
    )
    sim_pg.add_argument(
        "--report-dir", default="propgen-finds",
        help="where find reports (violations + stitched timeline) "
             "land (default propgen-finds/)",
    )
    doc = sub.add_parser(
        "doctor",
        help="cross-check every node-local trust surface (statefile, "
             "device gate, holders, labels, evidence) and print a JSON "
             "report; exits non-zero iff a check fails",
    )
    doc.add_argument(
        "--offline", action="store_true",
        help="skip the cluster checks (no API server access attempted)",
    )
    doc.add_argument(
        "--publish", action="store_true",
        help="also push the compact verdict as the cc.doctor node "
             "annotation for the fleet controller to aggregate",
    )
    return p


def parse_config(argv: Optional[List[str]] = None):
    """-> (AgentConfig, parsed_args). Validates NODE_NAME presence like the
    reference (cmd/main.go:109-115, main.py:737-739)."""
    args = build_parser().parse_args(argv)
    if not args.node_name and args.command not in (
        "get-cc-mode", "probe-devices", "rollout", "fleet-controller",
        "policy-controller", "webhook", "doctor", "simlab",
    ):
        raise SystemExit(
            "NODE_NAME env or --node-name flag is required"
        )
    cfg = AgentConfig(
        node_name=args.node_name or "",
        default_mode=args.default_cc_mode,
        kubeconfig=args.kubeconfig,
        debug=args.debug,
        operator_namespace=os.environ.get("OPERATOR_NAMESPACE", "tpu-system"),
        evict_components=_env_bool("EVICT_OPERATOR_COMPONENTS", True),
        drain_strategy=os.environ.get("DRAIN_STRATEGY", "components"),
        readiness_file=os.environ.get("CC_READINESS_FILE", DEFAULT_READINESS_FILE),
        health_port=args.health_port,
        slice_coordination=_env_bool("SLICE_COORDINATION", False),
        repair_interval_s=float(os.environ.get("REPAIR_INTERVAL_S", "30")),
        trace_file=os.environ.get("CC_TRACE_FILE") or None,
        log_format=os.environ.get("TPU_CC_LOG_FORMAT", "text") or "text",
        flightrec_dir=os.environ.get("TPU_CC_FLIGHTREC_DIR") or None,
        emit_events=_env_bool("EMIT_EVENTS", True),
        emit_evidence=_env_bool("TPU_CC_EVIDENCE", True),
        doctor_interval_s=float(
            os.environ.get("TPU_CC_DOCTOR_INTERVAL_S", "300")
        ),
        slice_commit_timeout_s=float(
            os.environ.get("TPU_CC_SLICE_COMMIT_TIMEOUT_S", "600")
        ),
    )
    return cfg, args
