"""The one traffic generator: a mix's parameters in, a seeded schedule of
node writes out.

A mix (``portbench/traffic/<mix>.json``) names its driver and gives:

- ``background``: every node's kubelet status report and doctor
  republish, once per ``kubelet_period_s`` and ``doctor_period_s``, each
  node at a seeded phase; a republished doctor verdict is failing with
  the configuration's ``doctor_failing`` share, so that share holds;
- ``rolling`` (optional): a rolling CC-mode change to ``target``.
  Groups flip in pool order, ``fleet_share_per_min`` of the fleet a
  minute. On a configuration with NVLink domains a group is one domain;
  on one without, ``solo_group`` solo nodes. A group whose members are
  not all converged and untainted is passed over, as an operator's
  rollout passes over broken domains (its preflight refuses failed
  nodes). Each node of a group gets three writes: the desired label at
  the group's time, the flip taint ``taint_after_s`` later, and the
  observed mode with fresh evidence and the taint cleared
  ``done_after_s`` later (``failed`` instead, with the taint cleared,
  on the ``failed_share`` of flips).

Every seed gets the same groups' sizes and the same pace; the seed moves
which nodes are where and the background's phases.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

import numpy as np

from portbench import fleetgen as G

#: kinds of write, as the writer logs them
KUBELET, DOCTOR, DESIRED, TAINT, DONE, DONE_FAILED = range(6)


class Schedule(NamedTuple):
    """Writes in due order: ``t`` seconds after the writer starts, the
    node's index, the kind, and for a doctor write whether the verdict
    is failing."""
    t: np.ndarray
    node: np.ndarray
    kind: np.ndarray
    failing: np.ndarray
    target: str


def _clean(node: dict) -> bool:
    labels = node["metadata"]["labels"]
    return (labels[G.CC_MODE_LABEL] == "on"
            and labels[G.CC_MODE_STATE_LABEL] == "on"
            and not node["spec"].get("taints"))


def rolling_groups(fleet: List[dict], cfg: dict, solo_group: int
                   ) -> List[List[int]]:
    """The rollout's groups in pool order, broken ones passed over."""
    groups: List[List[int]] = []
    if cfg["domain_hosts"] > 1:
        hosts = cfg["domain_hosts"]
        for start in range(0, len(fleet), hosts):
            members = list(range(start, min(start + hosts, len(fleet))))
            if all(_clean(fleet[i]) for i in members):
                groups.append(members)
        return groups
    cur: List[int] = []
    for i, node in enumerate(fleet):
        if _clean(node):
            cur.append(i)
            if len(cur) == solo_group:
                groups.append(cur)
                cur = []
    return groups


def make_schedule(fleet: List[dict], cfg: dict, mix: Dict, seed: int,
                  horizon_s: float) -> Schedule:
    """Every write due in ``[0, horizon_s)`` seconds."""
    n = len(fleet)
    rng = np.random.default_rng([seed, 1])
    ts, nodes, kinds, failing = [], [], [], []
    bg = mix["background"]
    for kind, period in ((KUBELET, bg["kubelet_period_s"]),
                         (DOCTOR, bg["doctor_period_s"])):
        phase = rng.random(n) * period
        reps = int(np.ceil(horizon_s / period))
        t = (phase[None, :] + period * np.arange(reps)[:, None]).ravel()
        idx = np.tile(np.arange(n), reps)
        keep = t < horizon_s
        ts.append(t[keep])
        nodes.append(idx[keep])
        kinds.append(np.full(int(keep.sum()), kind))
        fail = (rng.random(int(keep.sum())) < cfg["mix"]["doctor_failing"]
                if kind == DOCTOR else np.zeros(int(keep.sum()), bool))
        failing.append(fail)
    target = "on"
    roll = mix.get("rolling")
    if roll:
        target = roll["target"]
        groups = rolling_groups(fleet, cfg, roll["solo_group"])
        per_s = roll["fleet_share_per_min"] * n / 60.0
        t0 = 0.0
        flip_ts, flip_nodes, flip_kinds = [], [], []
        for members in groups:
            if t0 >= horizon_s:
                break
            failed = rng.random(len(members)) < roll["failed_share"]
            for j, i in enumerate(members):
                for kind, dt in ((DESIRED, 0.0),
                                 (TAINT, roll["taint_after_s"]),
                                 (DONE_FAILED if failed[j] else DONE,
                                  roll["done_after_s"])):
                    if t0 + dt < horizon_s:
                        flip_ts.append(t0 + dt)
                        flip_nodes.append(i)
                        flip_kinds.append(kind)
            t0 += len(members) / per_s
        ts.append(np.array(flip_ts, float))
        nodes.append(np.array(flip_nodes, np.int64))
        kinds.append(np.array(flip_kinds, np.int64))
        failing.append(np.zeros(len(flip_ts), bool))
    t = np.concatenate(ts)
    order = np.argsort(t, kind="stable")
    return Schedule(t[order], np.concatenate(nodes)[order],
                    np.concatenate(kinds)[order],
                    np.concatenate(failing)[order], target)


def patch_for(kind: int, name: str, failing: bool, target: str,
              wall_s: float, cfg: dict, key: bytes) -> dict:
    """The merge patch a write of ``kind`` sends, stamped ``wall_s``."""
    if kind == KUBELET:
        return {"status": G.node_status(wall_s)}
    if kind == DOCTOR:
        return {"metadata": {"annotations": {
            G.DOCTOR_ANNOTATION: G.doctor_verdict(failing, wall_s)}}}
    if kind == DESIRED:
        return {"metadata": {"labels": {G.CC_MODE_LABEL: target}}}
    if kind == TAINT:
        return {"spec": {"taints": [dict(G.FLIP_TAINT)]}}
    if kind == DONE:
        return {"metadata": {
            "labels": {G.CC_MODE_STATE_LABEL: target},
            "annotations": {G.EVIDENCE_ANNOTATION: G.sign_evidence(
                name, target, wall_s, cfg, key)}},
            "spec": {"taints": None}}
    if kind == DONE_FAILED:
        return {"metadata": {"labels": {G.CC_MODE_STATE_LABEL: "failed"}},
                "spec": {"taints": None}}
    raise ValueError(f"unknown write kind {kind}")
