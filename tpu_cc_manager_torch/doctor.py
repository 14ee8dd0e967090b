"""``doctor`` — node-local trust-surface diagnostic.

The framework's enforcement story spans several independent surfaces:
the durable staged/effective statefile, the device-node permission
gate, the exclusive-hold contract, the cluster labels, and the
attestation evidence. Each is self-healing in its own loop, but when an
operator is staring at a misbehaving node they need ONE command that
cross-checks all of them and says which link is broken. ``python -m
tpu_cc_manager doctor`` prints a JSON report of named checks, each
``ok`` / ``warn`` / ``fail``, and exits non-zero iff any check failed.

The reference has nothing like this — its debugging story is reading
the pod log of a `set -x` bash script (SURVEY.md §5.1).

Checks (device-local, always):

- ``enumerate``          — the backend can list devices at all;
- ``staged-committed``   — no device has a staged mode pending over its
  effective one (an interrupted flip that never reached commit);
- ``independent-read``   — the effective mode read through the OTHER
  implementation's store handle agrees (the engine's non-tautological
  verify surface);
- ``gate-perms``         — device-node permission bits encode the
  effective CC mode (flip-locked nodes are a ``warn``: that is the
  fail-secure hold, not drift);
- ``holders``            — foreign processes holding the device node
  (``warn``: legitimate workloads hold the chip between flips).

Checks (cluster, when the API server and NODE_NAME are available;
skipped with a ``warn`` otherwise):

- ``state-label``        — ``cc.mode.state`` matches the device-derived
  node mode (a mismatch is the lying-label case the evidence audit
  exists for — here caught on the node itself);
- ``desired-converged``  — desired label matches observed (divergence
  is a ``warn``: the agent may simply still be working);
- ``evidence``           — the published evidence annotation verifies,
  matches the local statefiles, and attests the labeled mode;
- ``identity``           — the evidence's platform-identity token
  verifies and binds to THIS node (``fail`` on a foreign/invalid
  token; ``warn`` when an explicitly configured provider produced no
  token, the token is expired, or the signature is unverifiable here);
- ``flip-taint``         — no leftover flip taint outside a flip.
"""

from __future__ import annotations

import json
import logging
from typing import List, Optional

from tpu_cc_manager_torch import labels as L

log = logging.getLogger("tpu-cc-manager.doctor")


def _check(checks: List[dict], name: str, severity: str, detail: str) -> None:
    checks.append({"name": name, "severity": severity, "detail": detail})


def _node_mode_from_devices(chips, store) -> Optional[str]:
    """Device-derived node-level mode — delegates the derivation rules
    (ici precedence, 'mixed' on disagreement) to evidence_mode so the
    doctor's state-label check can never drift from what the published
    evidence attests."""
    from tpu_cc_manager_torch.device.statefile import independent_read
    from tpu_cc_manager_torch.evidence import evidence_mode

    devices = []
    for c in chips:
        entry = {"cc": None, "ici": None}
        if getattr(c, "is_cc_query_supported", False):
            entry["cc"] = (independent_read(store, c.path, "cc")
                           if store is not None else c.query_cc_mode())
        if getattr(c, "is_ici_query_supported", False):
            entry["ici"] = (independent_read(store, c.path, "ici")
                            if store is not None else c.query_ici_mode())
        devices.append(entry)
    return evidence_mode({"devices": devices})


def _identity_check(checks: List[dict], doc: dict,
                    node_name: str) -> None:
    """The node diagnoses its OWN identity posture, so a broken
    metadata path / lapsed token / foreign token surfaces here first,
    not as a fleet-wide audit finding. Reuses the already-parsed
    evidence document; never dials the metadata server (that would add
    a blocking probe to every doctor run) — the provider MODE comes
    from the env alone."""
    import os as _os

    from tpu_cc_manager_torch.identity import judge_identity

    iverdict, idetail = judge_identity(doc, node_name)
    mode = _os.environ.get("TPU_CC_IDENTITY", "auto").lower()
    if iverdict == "ok":
        _check(checks, "identity", "ok",
               "platform identity token verifies and binds to this node")
    elif iverdict == "unverifiable":
        _check(checks, "identity", "warn",
               f"identity present but {idetail}")
    elif iverdict == "missing" and mode in ("fake", "gce"):
        _check(checks, "identity", "warn",
               f"TPU_CC_IDENTITY={mode} is configured but the "
               "published evidence carries no token — metadata path "
               "broken at publish time? (heals on the next evidence "
               "sync)")
    elif iverdict == "missing":
        # auto/none: absence is the normal posture off-GCE. A GCE
        # metadata OUTAGE also lands here (this host cannot tell the
        # two apart without probing) — the fleet audit's mixed-pool
        # identity_missing finding is the detector for that case.
        _check(checks, "identity", "ok",
               "no identity attached (no platform identity provider "
               "configured/detected)")
    elif iverdict == "expired":
        _check(checks, "identity", "warn",
               "identity token expired — the refresh loop is not "
               "keeping up")
    else:  # mismatch / invalid
        _check(checks, "identity", "fail",
               f"identity {iverdict}: {idetail}")


def _attestation_check(checks: List[dict], doc: dict,
                       node_name: str) -> None:
    """The node diagnoses its OWN attestation posture: a quote that
    fails to verify, commits to a different document, or contradicts
    the measured flip history fails HERE first — before the fleet
    audit's attestation_mismatch finding. Mirrors _identity_check's
    severity vocabulary so the two trust rungs read alike."""
    from tpu_cc_manager_torch.attest import get_attestor, judge_attestation

    averdict, adetail = judge_attestation(doc, node_name)
    # resolved provider, not the env string: 'auto' on a Confidential
    # Space VM HAS a provider, and a quote-less document there is the
    # degradation worth warning about
    configured = get_attestor() is not None
    if averdict == "ok":
        _check(checks, "attestation", "ok",
               "TEE quote verifies and matches the measured flip "
               "history")
    elif averdict == "unverifiable":
        _check(checks, "attestation", "warn",
               f"attestation present but {adetail}")
    elif averdict == "missing" and configured:
        _check(checks, "attestation", "warn",
               "an attestation provider is configured/detected but "
               "the published evidence carries no quote (heals on "
               "the next evidence sync)")
    elif averdict == "expired":
        _check(checks, "attestation", "warn",
               "attestation token expired — the evidence sync is not "
               "keeping up")
    elif averdict == "missing":
        _check(checks, "attestation", "ok",
               "no attestation attached (no TEE provider "
               "configured/detected)")
    else:  # mismatch / invalid
        _check(checks, "attestation", "fail",
               f"attestation {averdict}: {adetail}")


def run_doctor(kube=None, node_name: Optional[str] = None,
               backend=None) -> dict:
    """Execute every check; returns the report dict. Never raises — a
    diagnostic that crashes on the broken state it exists to diagnose
    is useless."""
    from tpu_cc_manager_torch.device.gate import (
        FLIP_LOCK_PERMS, MODE_PERMS, DeviceGate, gating_enabled,
    )
    from tpu_cc_manager_torch.device.holders import check_enabled, find_holders
    from tpu_cc_manager_torch.device.statefile import independent_read

    checks: List[dict] = []
    # ------------------------------------------------------ device local
    try:
        if backend is None:
            from tpu_cc_manager_torch import device as devlayer

            backend = devlayer.get_backend()
        chips, err = backend.find_tpus()
        if err:
            _check(checks, "enumerate", "fail", f"enumeration error: {err}")
            chips = []
        elif not chips:
            _check(checks, "enumerate", "warn", "no TPU devices found")
        else:
            _check(checks, "enumerate", "ok",
                   f"{len(chips)} device(s): "
                   f"{[c.path for c in chips]}")
    except Exception as e:
        _check(checks, "enumerate", "fail", f"backend unavailable: {e}")
        chips = []
        backend = None

    store = getattr(backend, "store", None)
    effective_cc = {}
    for c in chips:
        path = c.path
        try:
            if store is not None:
                pending = [
                    (dom, store.staged(path, dom), store.effective(path, dom))
                    for dom in ("cc", "ici")
                    if store.staged(path, dom) != store.effective(path, dom)
                ]
                if pending:
                    _check(
                        checks, "staged-committed", "fail",
                        f"{path}: staged mode(s) pending over effective "
                        f"(interrupted flip): {pending}",
                    )
                else:
                    _check(checks, "staged-committed", "ok",
                           f"{path}: staged == effective")
                mine = store.effective(path, "cc")
                other = independent_read(store, path, "cc")
                if mine != other:
                    _check(
                        checks, "independent-read", "fail",
                        f"{path}: store reads cc={mine!r} but the "
                        f"independent reader sees {other!r} "
                        "(statefile corruption or implementation skew)",
                    )
                else:
                    _check(checks, "independent-read", "ok",
                           f"{path}: cc={mine!r} agrees across readers")
                effective_cc[path] = other
            elif getattr(c, "is_cc_query_supported", False):
                effective_cc[path] = c.query_cc_mode()
        except Exception as e:
            _check(checks, "staged-committed", "fail", f"{path}: {e}")

    try:
        if gating_enabled() and chips:
            gate = DeviceGate()
            for c in chips:
                perms = gate.current_perms(c.path)
                if perms is None:
                    continue  # no devfs node (fake/jax identities)
                mode = effective_cc.get(c.path)
                if mode is None:
                    # the effective mode could not be established (the
                    # statefile check above already failed for this
                    # device): judging drift against an assumed mode
                    # would misdirect the operator from the real problem
                    _check(
                        checks, "gate-perms", "warn",
                        f"{c.path}: effective mode unknown; gate check "
                        "skipped (see staged-committed)",
                    )
                    continue
                want = MODE_PERMS.get(mode, MODE_PERMS["on"])
                if perms == FLIP_LOCK_PERMS:
                    _check(
                        checks, "gate-perms", "warn",
                        f"{c.path}: flip-locked (0o000) — mid-flip, or a "
                        "failed flip held fail-secure; a successful "
                        "reconcile reopens it",
                    )
                elif perms != want:
                    _check(
                        checks, "gate-perms", "fail",
                        f"{c.path}: perms {oct(perms)} do not encode "
                        f"cc={mode!r} (want {oct(want)}) — drift; the "
                        "agent's idle tick heals this when gating is on",
                    )
                else:
                    _check(checks, "gate-perms", "ok",
                           f"{c.path}: {oct(perms)} encodes cc={mode!r}")
    except Exception as e:
        _check(checks, "gate-perms", "fail", f"gate check error: {e}")

    try:
        if check_enabled() and chips:
            for c in chips:
                holders = find_holders(c.path)
                if holders:
                    _check(
                        checks, "holders", "warn",
                        f"{c.path}: held by "
                        f"{[(h.pid, h.comm) for h in holders]} — fine "
                        "between flips; a flip will wait/restart them",
                    )
                else:
                    _check(checks, "holders", "ok", f"{c.path}: free")
    except Exception as e:
        _check(checks, "holders", "warn", f"holder scan error: {e}")

    # ---------------------------------------------------------- cluster
    node = None
    if kube is not None and node_name:
        try:
            node = kube.get_node(node_name)
        except Exception as e:
            _check(checks, "cluster", "warn",
                   f"cannot read node {node_name!r}: {e} — cluster "
                   "checks skipped")
    else:
        _check(checks, "cluster", "warn",
               "no API server / NODE_NAME: cluster checks skipped")

    if node is not None:
        labels = node["metadata"].get("labels") or {}
        desired = labels.get(L.CC_MODE_LABEL)
        state = labels.get(L.CC_MODE_STATE_LABEL)
        device_mode = _node_mode_from_devices(chips, store)
        if state is not None and state != "failed" and device_mode \
                is not None and state != device_mode:
            _check(
                checks, "state-label", "fail",
                f"cc.mode.state={state!r} but devices read "
                f"{device_mode!r} — the label lies; the evidence audit "
                "flags this fleet-wide, doctor catches it locally",
            )
        else:
            _check(checks, "state-label", "ok",
                   f"cc.mode.state={state!r}, devices={device_mode!r}")
        if desired is not None and desired != state:
            _check(
                checks, "desired-converged", "warn",
                f"desired {desired!r} != observed {state!r} — the agent "
                "may still be reconciling (or has failed; see "
                "state-label / Events)",
            )
        else:
            _check(checks, "desired-converged", "ok",
                   f"desired == observed ({state!r})")

        raw = (node["metadata"].get("annotations") or {}).get(
            L.EVIDENCE_ANNOTATION
        )
        if not raw:
            _check(checks, "evidence", "warn",
                   "no evidence annotation published")
        else:
            try:
                from tpu_cc_manager_torch.evidence import (
                    evidence_keys, evidence_mode, signed_with_primary,
                    verify_evidence,
                )

                doc = json.loads(raw)
                # one key-file read, one snapshot: the verify below and
                # the stale-key check further down must judge against
                # the SAME key set, or a Secret rotating between two
                # reads yields a self-contradictory verdict
                ekeys = evidence_keys()
                ok, reason = verify_evidence(doc, key=ekeys,
                                             backend=backend)
                attested = evidence_mode(doc) if ok else None
                if not ok and reason == "no_key":
                    # signed evidence, no local key: a blind spot for
                    # THIS invocation, not a node problem (same
                    # tolerance the rollout judge applies)
                    _check(checks, "evidence", "warn",
                           "evidence is HMAC-signed but no "
                           "TPU_CC_EVIDENCE_KEY is available here; "
                           "cannot judge it")
                elif not ok:
                    _check(checks, "evidence", "fail",
                           f"evidence does not verify: {reason}")
                elif doc.get("node") != node_name:
                    _check(checks, "evidence", "fail",
                           f"evidence belongs to node "
                           f"{doc.get('node')!r} (replayed?)")
                elif (attested is not None and state not in
                        (None, "failed") and attested != state):
                    _check(checks, "evidence", "fail",
                           f"evidence attests {attested!r} but label "
                           f"claims {state!r}")
                else:
                    if (len(ekeys) > 1
                            and not signed_with_primary(doc, key=ekeys)):
                        # mid-rotation: valid under the tail key only —
                        # the sync healer will re-sign; warn (not fail)
                        # so a rotating fleet doesn't read as broken
                        _check(checks, "evidence", "warn",
                               "evidence verifies only under a "
                               "rotation-tail key; re-sign pending "
                               "(evidence sync will heal this)")
                    else:
                        _check(checks, "evidence", "ok",
                               f"verifies ({reason}), "
                               f"attests {attested!r}")
                _identity_check(checks, doc, node_name)
                _attestation_check(checks, doc, node_name)
            except Exception as e:
                _check(checks, "evidence", "fail",
                       f"evidence unreadable: {e}")

        taints = (node.get("spec") or {}).get("taints") or []
        flip = [t for t in taints if t.get("key") == L.FLIP_TAINT_KEY]
        if flip:
            _check(
                checks, "flip-taint", "warn",
                "flip taint present — a flip is in progress, or a "
                "crashed agent left it; the agent clears it on its next "
                "reconcile",
            )
        else:
            _check(checks, "flip-taint", "ok", "no flip taint")

    return {
        "node": node_name,
        "ok": all(c["severity"] != "fail" for c in checks),
        "checks": checks,
    }


def publish_report(kube, node_name: str, report: dict) -> bool:
    """Push a compact doctor verdict as a node annotation for the fleet
    controller to aggregate. Best-effort."""
    import time

    summary = {
        "ok": report["ok"],
        "fail": sorted({c["name"] for c in report["checks"]
                        if c["severity"] == "fail"}),
        "warn": sorted({c["name"] for c in report["checks"]
                        if c["severity"] == "warn"}),
        "at": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    try:
        # one merge patch for both: the annotation carries the detail,
        # the label is the selectable mirror (kubectl get nodes
        # -l cc.doctor.ok=false)
        kube.patch_node(node_name, {"metadata": {
            "annotations": {
                L.DOCTOR_ANNOTATION: json.dumps(
                    summary, sort_keys=True, separators=(",", ":")
                ),
            },
            "labels": {
                L.DOCTOR_OK_LABEL: "true" if summary["ok"] else "false",
            },
        }})
        return True
    except Exception:
        log.warning("doctor verdict publication failed", exc_info=True)
        return False


def main_from_args(cfg, args) -> int:
    """CLI glue (called from __main__): build the kube client when
    possible, run, print, exit 0/1."""
    kube = None
    if not args.offline and cfg.node_name:
        try:
            from tpu_cc_manager_torch.k8s.client import HttpKubeClient, KubeConfig

            kube = HttpKubeClient(KubeConfig.load(cfg.kubeconfig))
        except Exception as e:
            log.warning("no API access (%s); running device-local only", e)
    report = run_doctor(kube=kube, node_name=cfg.node_name or None)
    if args.publish and kube is not None and cfg.node_name:
        publish_report(kube, cfg.node_name, report)
    elif args.publish:
        log.warning("--publish needs API access and NODE_NAME; skipped")
    print(json.dumps(report, indent=2, sort_keys=True))
    return 0 if report["ok"] else 1
