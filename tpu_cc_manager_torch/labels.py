"""Label / annotation keys — the cluster-visible protocol surface.

The reference coordinates the whole fleet exclusively through node labels
(SURVEY.md §2.3): a desired-state label written by the operator, an
observed-state label written by the agent, and component pause labels used
to drain the GPU operator's pods. This module is the TPU-native rename of
that protocol; everything else in the framework refers to these constants.
"""

from __future__ import annotations

#: Desired-state label (analog of ``nvidia.com/cc.mode``, reference
#: cmd/main.go:39, main.py:50).
CC_MODE_LABEL = "tpu.google.com/cc.mode"

#: Observed-state label (analog of ``nvidia.com/cc.mode.state``, reference
#: gpu_operator_eviction.py:279). Value: the achieved mode, or "failed".
CC_MODE_STATE_LABEL = "tpu.google.com/cc.mode.state"

#: Pause-label protocol for TPU-stack components (analog of the five
#: ``nvidia.com/gpu.deploy.*`` labels, reference
#: gpu_operator_eviction.py:23-29). A cooperating operator's DaemonSets
#: carry nodeAffinity on these labels; setting the value to
#: ``paused-for-cc-flip`` (with the original value preserved as a suffix)
#: makes the operator remove the pod from the node.
COMPONENT_LABELS = (
    "tpu.google.com/pool.deploy.device-plugin",
    "tpu.google.com/pool.deploy.metrics-exporter",
    "tpu.google.com/pool.deploy.dra-driver",
    "tpu.google.com/pool.deploy.workload-validator",
    "tpu.google.com/pool.deploy.node-problem-detector",
)

#: App labels identifying the pods of each component above (analog of
#: ``COMPONENT_APP_LABELS``, reference gpu_operator_eviction.py:32-38).
COMPONENT_APP_LABELS = {
    "tpu.google.com/pool.deploy.device-plugin": "tpu-device-plugin",
    "tpu.google.com/pool.deploy.metrics-exporter": "tpu-metrics-exporter",
    "tpu.google.com/pool.deploy.dra-driver": "tpu-dra-driver",
    "tpu.google.com/pool.deploy.workload-validator": "tpu-workload-validator",
    "tpu.google.com/pool.deploy.node-problem-detector": "tpu-node-problem-detector",
}

#: Pause marker prefix (analog of ``PAUSED_STR = "paused-for-cc-flip"``,
#: reference gpu_operator_eviction.py:40-70).
PAUSED_STR = "paused-for-cc-flip"

#: Label selecting TPU nodes (set by GKE on TPU node pools); the DaemonSet
#: nodeSelector keys on it, and the fleet controller uses it to scope
#: listings.
TPU_ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"

#: GKE labels giving slice identity/topology on multi-host TPU node pools.
#: All nodes of one multi-host slice share the same topology value and
#: belong to one node pool; per-slice coherence keys off these.
TPU_TOPOLOGY_LABEL = "cloud.google.com/gke-tpu-topology"  # ccaudit: allow-protocol-liveness(GKE-written; documented for operators — slice identity keys off TPU_SLICE_LABEL)
TPU_SLICE_LABEL = "tpu.google.com/cc.slice"

#: Slice-coordination annotations (new vs the reference — SURVEY.md §7.2
#: step 7). See tpu_cc_manager.slice_coord for the protocol.
SLICE_LEADER_ANNOTATION = "tpu.google.com/cc.slice.leader"  # ccaudit: allow-protocol-liveness(operator-facing breadcrumb: leadership is recomputed from the member list, never read back)
SLICE_EPOCH_ANNOTATION = "tpu.google.com/cc.slice.epoch"
SLICE_ACK_ANNOTATION = "tpu.google.com/cc.slice.ack"
SLICE_COMMIT_ANNOTATION = "tpu.google.com/cc.slice.commit"
SLICE_HB_ANNOTATION = "tpu.google.com/cc.slice.hb"
SLICE_DONE_ANNOTATION = "tpu.google.com/cc.slice.done"

#: Per-flip attestation evidence annotation (tpu_cc_manager.evidence):
#: a hashed/HMAC'd document binding node, live device identities,
#: independently-read effective modes, and a statefile digest. Written by
#: the agent at every successful reconcile; audited fleet-wide by the
#: fleet controller.
EVIDENCE_ANNOTATION = "tpu.google.com/cc.evidence"

#: Node-local doctor verdict (tpu_cc_manager.doctor --publish): a
#: compact {ok, fail[], warn[]} summary of the node's trust-surface
#: checks, aggregated fleet-wide by the fleet controller — the
#: "deep-scan" channel that doesn't trust labels because it is produced
#: by the same cross-checks that catch lying labels.
DOCTOR_ANNOTATION = "tpu.google.com/cc.doctor"

#: Selectable mirror of the doctor verdict ("true"/"false"): label
#: selectors can't see annotations, and operators need
#: ``kubectl get nodes -l tpu.google.com/cc.doctor.ok=false`` to find
#: the nodes failing trust-surface checks without parsing JSON.
DOCTOR_OK_LABEL = "tpu.google.com/cc.doctor.ok"

#: Durable rollout record (tpu_cc_manager.rollout): the group plan,
#: per-group outcomes, and budget of the pool's current/last rollout,
#: stored as an annotation on the pool's anchor node so an operator-side
#: crash mid-rollout can be resumed (`rollout --resume`) from cluster
#: state alone.
ROLLOUT_ANNOTATION = "tpu.google.com/cc.rollout"

#: Cross-process trace context (tpu_cc_manager.trace, ISSUE 8): a
#: W3C-traceparent-style string ("00-<trace>-<span>-01") stamped by
#: whoever WRITES the desired-mode label — the rollout driver, the
#: policy controller, or the simlab driver — in the SAME node write as
#: the label itself (zero extra round trips). The agent's watch
#: surfaces it and the reconcile adopts it, so one trace id spans
#: desired-write → watch delivery → flip → state publish across
#: process boundaries. Observability only: never parsed for control
#: decisions, and a missing/garbled value degrades to a local trace.
CC_TRACE_ANNOTATION = "tpu.google.com/cc.trace"

#: Node taint held for the duration of a mode flip so the *scheduler* —
#: not just the component pause labels — keeps new TPU work off a node
#: whose devices are gated mid-flip. Cleared when the flip cycle ends
#: (success or failure; the cc.mode.state label carries the outcome).
FLIP_TAINT_KEY = "tpu.google.com/cc.mode"
FLIP_TAINT_VALUE = "flipping"
FLIP_TAINT_EFFECT = "NoSchedule"

#: Pod-side request for a confidential-compute guarantee
#: (tpu_cc_manager.webhook): a pod carrying this label asks to run only
#: on nodes whose OBSERVED mode (cc.mode.state — the agent-published
#: truth, not the desired label) equals the value. The mutating webhook
#: injects the matching nodeSelector; the validating webhook rejects
#: specs that contradict it (wrong explicit selector, or tolerating the
#: flip taint, which would let the pod land mid-flip).
REQUIRES_CC_LABEL = "tpu.google.com/requires-cc-mode"

#: Agent code-version breadcrumb (simlab's rolling-upgrade drill, and
#: any future agent that wants to advertise its build): written by the
#: reconcile path as a deferred publication riding a carrier write
#: (zero extra round trips), read by operators and by simlab's
#: lifecycle invariants oracle to prove a rolling agent upgrade
#: completed on every cohort.
AGENT_VERSION_ANNOTATION = "tpu.google.com/cc.agent-version"

#: TPUCCPolicy custom resource (tpu_cc_manager.policy): the declarative,
#: level-triggered replacement for hand-run rollouts. Cluster-scoped —
#: a policy selects node pools by label selector, so namespacing it
#: would be a lie. The reference has no declarative surface at all
#: (admins patch labels by hand, reference README_PYTHON.md:77-102).
POLICY_GROUP = "tpu.google.com"
POLICY_VERSION = "v1alpha1"
POLICY_PLURAL = "tpuccpolicies"
POLICY_KIND = "TPUCCPolicy"
