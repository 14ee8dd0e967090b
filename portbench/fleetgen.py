"""The fleet a cell serves, made from the seed: node objects with the
bench's mix and signed evidence.

Adapted from ``chip_smoke.py`` ``make_nodes`` (commit fef00ad). Three
changes: each share of the mix is an exact count placed by a seeded
permutation, so every seed holds the same amount of each kind of node in
other places; each node's evidence is a document signed with the seed's
HMAC key in the format the port's agents publish
(``tpu_cc_manager_torch/evidence.py`` ``build_evidence``), where the copy
carried a bare timestamp that no verifier accepts; and the NVLink domain
is the configuration's (``domain_hosts`` VMs under one slice label, or
none). Node objects carry the status block a kubelet reports, so a list
copies what an API server would hand back.

Nothing here imports the program: the label keys are the port's protocol
strings, written out.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import time
from typing import Dict, List, Optional

import numpy as np

CC_MODE_LABEL = "tpu.google.com/cc.mode"
CC_MODE_STATE_LABEL = "tpu.google.com/cc.mode.state"
SLICE_LABEL = "tpu.google.com/cc.slice"
ACCELERATOR_LABEL = "cloud.google.com/gke-tpu-accelerator"
EVIDENCE_ANNOTATION = "tpu.google.com/cc.evidence"
DOCTOR_ANNOTATION = "tpu.google.com/cc.doctor"
FLIP_TAINT = {"key": "tpu.google.com/cc.mode", "value": "flipping",
              "effect": "NoSchedule"}

#: the mix's kinds of node, in the order their shares are placed; a node
#: is of at most one of the first three (its mode), and independently of
#: the last four (doctor and evidence)
MODE_KINDS = ("divergent", "failed", "tainted")
SIDE_KINDS = ("doctor_failing", "no_evidence", "lying_evidence",
              "tampered_evidence")


def stamp(epoch_s: float) -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(epoch_s))


def evidence_key(seed: int) -> bytes:
    """The seed's pool evidence key (handed to the controller through
    ``TPU_CC_EVIDENCE_KEY``)."""
    return hashlib.sha256(f"portbench-evidence-{seed}".encode()).hexdigest(
    ).encode()


def _canonical(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def sign_evidence(name: str, mode: str, epoch_s: float, cfg: dict,
                  key: bytes, *, attest: Optional[str] = None,
                  tamper: bool = False) -> str:
    """The evidence annotation an agent publishes after a flip to
    ``mode``: one entry per GPU with its CC mode (``attest`` makes the
    devices claim another mode: a lying label), an HMAC-SHA256 digest
    over the canonical body (``tamper`` alters the body after signing)."""
    cc = attest or mode
    doc = {
        "version": 1,
        "node": name,
        "timestamp": stamp(epoch_s),
        "devices": [
            {"path": f"/dev/nvidia{g}", "name": cfg["gpu_name"], "cc": cc,
             "ici": None}
            for g in range(cfg["gpus_per_node"])
        ],
        "statefile_digest": "sha256:" + hashlib.sha256(
            f"{name}\0{cc}".encode()).hexdigest(),
    }
    doc["digest"] = "hmac-sha256:" + hmac.new(
        key, _canonical(doc), hashlib.sha256).hexdigest()
    if tamper:
        doc["timestamp"] = stamp(epoch_s - 1)
    return json.dumps(doc)


def doctor_verdict(failing: bool, epoch_s: float) -> str:
    if failing:
        return json.dumps({"ok": False, "fail": ["iommu"],
                           "at": stamp(epoch_s)})
    return json.dumps({"ok": True, "at": stamp(epoch_s)})


def node_status(epoch_s: float) -> dict:
    """The kubelet's status block, heartbeats at ``epoch_s``."""
    beat = stamp(epoch_s)
    conds = [
        {"type": t, "status": s, "reason": r, "message": m,
         "lastHeartbeatTime": beat, "lastTransitionTime": "2026-09-01T00:00:00Z"}
        for t, s, r, m in (
            ("MemoryPressure", "False", "KubeletHasSufficientMemory",
             "kubelet has sufficient memory available"),
            ("DiskPressure", "False", "KubeletHasNoDiskPressure",
             "kubelet has no disk pressure"),
            ("PIDPressure", "False", "KubeletHasSufficientPID",
             "kubelet has sufficient PID available"),
            ("Ready", "True", "KubeletReady",
             "kubelet is posting ready status"),
        )
    ]
    return {"conditions": conds}


def mix_masks(n: int, mix: Dict[str, float],
              rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """Exact counts of each kind, placed by one seeded permutation: the
    mode kinds on disjoint nodes, each side kind on its own draw."""
    out: Dict[str, np.ndarray] = {}
    order = rng.permutation(n)
    at = 0
    for kind in MODE_KINDS:
        k = int(round(mix[kind] * n))
        mask = np.zeros(n, bool)
        mask[order[at:at + k]] = True
        out[kind] = mask
        at += k
    for kind in SIDE_KINDS:
        k = int(round(mix[kind] * n))
        mask = np.zeros(n, bool)
        mask[rng.permutation(n)[:k]] = True
        out[kind] = mask
    return out


def node_name(cfg: dict, i: int) -> str:
    return f"{cfg['name_prefix']}-{i:05d}"


def domain_of(cfg: dict, i: int) -> Optional[str]:
    """Node ``i``'s NVLink domain label, or None for a solo domain."""
    hosts = cfg["domain_hosts"]
    if hosts <= 1:
        return None
    return f"{cfg['name_prefix']}-nvl-{i // hosts:04d}"


def make_fleet(cfg: dict, seed: int, now: float) -> List[dict]:
    """The configuration's fleet for ``seed``: desired mode ``on``
    everywhere; the mix's divergent nodes observe ``off``, its failed
    ones ``failed``, its tainted ones carry the flip taint; evidence ages
    drawn uniformly up to ``evidence_age_max_s``."""
    n = cfg["nodes"]
    rng = np.random.default_rng([seed, 0])
    key = evidence_key(seed)
    masks = mix_masks(n, cfg["mix"], rng)
    ages = rng.integers(0, cfg["mix"]["evidence_age_max_s"], n)
    beat_ages = rng.integers(0, 300, n)
    status = node_status(now)
    nodes = []
    for i in range(n):
        name = node_name(cfg, i)
        observed = ("off" if masks["divergent"][i]
                    else "failed" if masks["failed"][i] else "on")
        labels = {
            ACCELERATOR_LABEL: cfg["accelerator"],
            CC_MODE_LABEL: "on",
            CC_MODE_STATE_LABEL: observed,
            "kubernetes.io/hostname": name,
            "node.kubernetes.io/instance-type": cfg["instance_type"],
            "topology.kubernetes.io/zone": cfg["zone"],
            "cloud.google.com/gke-nodepool":
                f"{cfg['name_prefix']}-pool-{i // cfg['pool_nodes']:03d}",
        }
        dom = domain_of(cfg, i)
        if dom is not None:
            labels[SLICE_LABEL] = dom
        ann = {DOCTOR_ANNOTATION: doctor_verdict(
            bool(masks["doctor_failing"][i]), now - int(beat_ages[i]))}
        if not masks["no_evidence"][i]:
            mode = "off" if observed == "off" else "on"
            ann[EVIDENCE_ANNOTATION] = sign_evidence(
                name, mode, now - int(ages[i]), cfg, key,
                attest=("off" if masks["lying_evidence"][i]
                        and mode == "on" else None),
                tamper=bool(masks["tampered_evidence"][i]))
        spec: dict = {"providerID": f"gce://{cfg['name_prefix']}/{name}"}
        if masks["tainted"][i]:
            spec["taints"] = [dict(FLIP_TAINT)]
        st = {"conditions": [dict(c) for c in status["conditions"]],
              "capacity": dict(cfg["capacity"]),
              "allocatable": dict(cfg["capacity"]),
              "nodeInfo": dict(cfg["node_info"])}
        nodes.append({"kind": "Node", "apiVersion": "v1",
                      "metadata": {"name": name, "labels": labels,
                                   "annotations": ann},
                      "spec": spec, "status": st})
    return nodes
