"""The plain reference's view of a node: what each version of a node object
says, worked out from the object alone.

Independent of the program: the label keys are the protocol's strings,
the merge patch, the evidence check (HMAC-SHA256 over the canonical JSON
body) and the doctor and evidence-timestamp readings are written here
from their formats. It imports nothing of ``tpu_cc_manager_torch``.
"""

from __future__ import annotations

import calendar
import copy
import hashlib
import hmac
import json
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

CC_MODE_LABEL = "tpu.google.com/cc.mode"
CC_MODE_STATE_LABEL = "tpu.google.com/cc.mode.state"
SLICE_LABEL = "tpu.google.com/cc.slice"
EVIDENCE_ANNOTATION = "tpu.google.com/cc.evidence"
DOCTOR_ANNOTATION = "tpu.google.com/cc.doctor"
FLIP_TAINT_KEY = "tpu.google.com/cc.mode"

#: the reference's mode codes; reports name modes, so only the names
#: have to agree with the program
MODE_NAMES = ("unknown", "on", "off", "devtools", "ici", "failed")
MODE_CODE = {m: i for i, m in enumerate(MODE_NAMES)}
FAILED = MODE_CODE["failed"]
UNREPORTED, DOCTOR_OK, DOCTOR_FAILING = 0, 1, 2

#: the fleet audit's buckets a node's own document can put it in
AUDIT_BUCKETS = ("missing", "unsigned", "invalid", "label_device_mismatch")
AUDIT_CODE = {None: 0, **{b: i + 1 for i, b in enumerate(AUDIT_BUCKETS)}}


def merge_patch(target: dict, patch: dict) -> dict:
    """RFC 7386: objects merge recursively, null deletes, anything else
    replaces."""
    out = dict(target)
    for k, v in patch.items():
        if v is None:
            out.pop(k, None)
        elif isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_patch(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def mode_code(value: Optional[str]) -> int:
    return MODE_CODE.get(value or "unknown", 0)


def parse_stamp(stamp: Any) -> int:
    """``%Y-%m-%dT%H:%M:%SZ`` as epoch seconds; -1 when absent or not in
    that form."""
    if not isinstance(stamp, str):
        return -1
    try:
        return calendar.timegm(time.strptime(stamp, "%Y-%m-%dT%H:%M:%SZ"))
    except ValueError:
        return -1


def canonical(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def attested_mode(doc: dict) -> Optional[str]:
    """The node mode a document's devices attest: ``ici`` only when every
    device with an ICI reading has it on, else the devices' one CC mode,
    ``mixed`` when they disagree, None with no devices."""
    devices = doc.get("devices") or []
    cc = {d.get("cc") for d in devices if d.get("cc") is not None}
    ici = {d.get("ici") for d in devices if d.get("ici") is not None}
    if "on" in ici:
        return "ici" if ici == {"on"} else "mixed"
    if not cc:
        return None
    if len(cc) > 1:
        return "mixed"
    return next(iter(cc))


def judge_evidence(raw: str, name: str, key: bytes
                   ) -> Tuple[str, Optional[str]]:
    """A keyed verifier's verdict on one document: ``ok``, ``unsigned``
    (plain SHA-256, consistent, bound to the node), ``malformed``,
    ``digest_mismatch`` or ``node_mismatch``; and the mode it attests
    where its claims are worth reading."""
    try:
        doc = json.loads(raw)
    except ValueError:
        return "malformed", None
    if not isinstance(doc, dict) or not isinstance(doc.get("digest"), str):
        return "malformed", None
    body = canonical({k: v for k, v in doc.items() if k != "digest"})
    claimed = doc["digest"]
    if claimed.startswith("hmac-sha256:"):
        want = "hmac-sha256:" + hmac.new(key, body,
                                         hashlib.sha256).hexdigest()
        if not hmac.compare_digest(want, claimed):
            return "digest_mismatch", None
    else:
        # a keyed verifier never takes a plain digest as proof; it only
        # tells a deployment gap from tampering
        if "sha256:" + hashlib.sha256(body).hexdigest() != claimed:
            return "digest_mismatch", None
        if doc.get("node") != name:
            return "node_mismatch", None
        return "unsigned", attested_mode(doc)
    if doc.get("node") != name:
        return "node_mismatch", None
    return "ok", attested_mode(doc)


class Version(NamedTuple):
    """What one version of a node object says."""
    desired: int
    observed: int
    state: Optional[str]
    desired_label: Optional[str]
    slice: Optional[str]
    taint: bool
    doctor: int
    fail: Tuple
    at: Optional[str]
    ev_ts: int
    audit: Optional[str]
    ev_present: bool
    ev_verdict: Optional[str]
    ev_attested: Optional[str]


def parse_version(node: dict, key: bytes,
                  cache: Optional[Dict[Tuple[str, str], Tuple]] = None
                  ) -> Version:
    meta = node.get("metadata") or {}
    name = meta.get("name")
    labels = meta.get("labels") or {}
    ann = meta.get("annotations") or {}
    desired = labels.get(CC_MODE_LABEL)
    state = labels.get(CC_MODE_STATE_LABEL)
    taint = any(isinstance(t, dict) and t.get("key") == FLIP_TAINT_KEY
                for t in (node.get("spec") or {}).get("taints") or [])
    doctor, fail, at = UNREPORTED, (), None
    raw_doc = ann.get(DOCTOR_ANNOTATION)
    if raw_doc:
        try:
            verdict = json.loads(raw_doc)
        except ValueError:
            doctor, fail = DOCTOR_FAILING, ("unparseable",)
        else:
            if isinstance(verdict, dict) and verdict.get("ok"):
                doctor = DOCTOR_OK
            else:
                doctor = DOCTOR_FAILING
                if isinstance(verdict, dict):
                    fail = tuple(verdict.get("fail", []))
                    at = verdict.get("at")
    raw_ev = ann.get(EVIDENCE_ANNOTATION)
    ck = (name, raw_ev)
    if cache is not None and ck in cache:
        ev_ts, verdict_ev, attested = cache[ck]
    else:
        ev_ts, verdict_ev, attested = -1, None, None
        if raw_ev:
            try:
                doc = json.loads(raw_ev)
            except ValueError:
                doc = None
            if isinstance(doc, dict):
                ev_ts = parse_stamp(doc.get("timestamp"))
            verdict_ev, attested = judge_evidence(raw_ev, name, key)
        if cache is not None:
            cache[ck] = (ev_ts, verdict_ev, attested)
    audit = None
    if state not in (None, "failed"):
        if not raw_ev:
            audit = "missing"
        elif verdict_ev not in ("ok", "unsigned"):
            audit = "invalid"
        elif attested is not None and attested != state:
            audit = "label_device_mismatch"
        elif verdict_ev == "unsigned":
            audit = "unsigned"
    return Version(mode_code(desired), mode_code(state), state, desired,
                   labels.get(SLICE_LABEL), taint, doctor, fail, at, ev_ts,
                   audit, bool(raw_ev), verdict_ev, attested)


def node_names(nodes: List[dict]) -> List[str]:
    return [n["metadata"]["name"] for n in nodes]
