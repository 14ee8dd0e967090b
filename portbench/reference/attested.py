"""The plain reference for an attested fleet: each evidence document's
identity and attestation tokens judged from their formats, and the
rollout's group plan that follows.

Written from the formats alone, independent of the program: RS256 is
RSASSA-PKCS1-v1_5 with SHA-256 (RFC 8017 section 8.2.2), checked here
by ``pow`` and an exact compare of the encoded message; a JWT's claims
are read from its base64url parts; the attestation token must commit to
the SHA-256 of the canonical document without ``digest`` and
``attestation``. Expiry is judged at the call's wall clock: where a
token expires between the call's start and its return, both readings
are accepted. It imports nothing of the program.

Verdicts, as a verifier states them (``ok``, ``missing``, ``expired``,
``mismatch``, ``invalid``, ``unverifiable``):

- identity: no token is ``missing``; an unreadable one ``invalid``; a
  token for another audience or another node ``mismatch``; an RS256
  token under a ``kid`` the JWKS lacks ``unverifiable`` (a lagging key
  rotation), or ``expired`` past its ``exp``; a bad signature
  ``invalid``; else ``expired`` or ``ok``.
- attestation: no token is ``missing``; an unreadable one ``invalid``;
  an unknown ``kid`` ``unverifiable``; a bad signature ``mismatch``;
  past its ``exp`` ``expired``; an ``eat_nonce`` without the document's
  nonce ``mismatch``; else ``ok``.

A converged node whose signed, honest evidence carries them is a
suspect, so its group is planned, when either token reads ``mismatch``
or ``invalid``, or ``missing`` or ``expired`` under the require flag of
its axis. An ``unverifiable`` token is tolerated.
"""

from __future__ import annotations

import base64
import bisect
import hashlib
import hmac
import json
from collections import Counter
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np

from portbench.reference.check import Tally
from portbench.reference.model import EVIDENCE_ANNOTATION

#: the ASN.1 DigestInfo that prefixes a SHA-256 hash in EMSA-PKCS1-v1_5
SHA256_PREFIX = bytes([0x30, 0x31, 0x30, 0x0D, 0x06, 0x09, 0x60, 0x86, 0x48,
                       0x01, 0x65, 0x03, 0x04, 0x02, 0x01, 0x05, 0x00, 0x04,
                       0x20])

#: a token's verdict as a function of the wall clock
Judged = Callable[[float], str]


def _unb64(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def rs256_ok(n: int, e: int, signed: bytes, sig: bytes) -> bool:
    """Does ``sig`` sign ``signed`` under the public key ``(n, e)``?"""
    size = (n.bit_length() + 7) // 8
    if len(sig) != size:
        return False
    s = int.from_bytes(sig, "big")
    if s >= n:
        return False
    em = pow(s, e, n).to_bytes(size, "big")
    t = SHA256_PREFIX + hashlib.sha256(signed).digest()
    if size < len(t) + 11:
        return False
    want = b"\x00\x01" + b"\xff" * (size - len(t) - 3) + b"\x00" + t
    return hmac.compare_digest(em, want)


def read_jwks(doc: dict) -> Dict[str, Tuple[int, int]]:
    """A JWKS document's RSA keys, by ``kid``."""
    return {k["kid"]: (int.from_bytes(_unb64(k["n"]), "big"),
                       int.from_bytes(_unb64(k["e"]), "big"))
            for k in doc.get("keys", []) if k.get("kty") == "RSA"}


def _jwt(token) -> Optional[Tuple[dict, dict, bytes, str]]:
    """Header, claims, signed part and encoded signature; None if the
    token is not three parts or its header or claims are unreadable."""
    if not isinstance(token, str) or token.count(".") != 2:
        return None
    h, p, s = token.split(".")
    try:
        header = json.loads(_unb64(h))
        claims = json.loads(_unb64(p))
    except ValueError:
        return None
    if not isinstance(header, dict) or not isinstance(claims, dict):
        return None
    return header, claims, f"{h}.{p}".encode(), s


def _signed_by(pub: Tuple[int, int], signed: bytes, sig: str
               ) -> Optional[bool]:
    """Does the encoded ``sig`` sign ``signed``? None if undecodable."""
    try:
        raw = _unb64(sig)
    except ValueError:
        return None
    return rs256_ok(pub[0], pub[1], signed, raw)


def _expiring(exp, before: str) -> Judged:
    """``expired`` past ``exp`` (a number), else ``before``."""
    if not isinstance(exp, (int, float)):
        return lambda now: before
    return lambda now: "expired" if now > exp else before


def _fixed(verdict: str) -> Judged:
    return lambda now: verdict


def judge_identity(doc: dict, node: str, jwks: Dict[str, Tuple[int, int]],
                   audience: str) -> Judged:
    ident = doc.get("identity")
    if ident is None:
        return _fixed("missing")
    parts = _jwt(ident.get("token")) if isinstance(ident, dict) else None
    if parts is None:
        return _fixed("invalid")
    header, claims, signed, sig = parts
    gce = (claims.get("google") or {}).get("compute_engine") or {}
    if claims.get("aud") != audience or gce.get("instance_name") != node:
        return _fixed("mismatch")
    if header.get("alg") != "RS256":
        return _fixed("invalid")
    pub = jwks.get(header.get("kid"))
    if pub is None:
        return _expiring(claims.get("exp"), "unverifiable")
    if not _signed_by(pub, signed, sig):
        return _fixed("invalid")
    return _expiring(claims.get("exp"), "ok")


def document_nonce(doc: dict) -> str:
    body = {k: v for k, v in doc.items() if k not in ("digest", "attestation")}
    return hashlib.sha256(json.dumps(
        body, sort_keys=True, separators=(",", ":")).encode()).hexdigest()


def judge_attestation(doc: dict, jwks: Dict[str, Tuple[int, int]]) -> Judged:
    att = doc.get("attestation")
    if att is None:
        return _fixed("missing")
    parts = _jwt(att.get("token")) if isinstance(att, dict) else None
    if parts is None:
        return _fixed("invalid")
    header, claims, signed, sig = parts
    pub = jwks.get(header.get("kid"))
    if pub is None:
        return _fixed("unverifiable")
    ok = _signed_by(pub, signed, sig)
    if not ok:
        return _fixed("invalid" if ok is None else "mismatch")
    nonces = claims.get("eat_nonce")
    nonces = [nonces] if isinstance(nonces, str) else nonces
    committed = isinstance(nonces, list) and document_nonce(doc) in nonces
    exp = claims.get("exp")
    if not isinstance(exp, (int, float)):
        return _fixed("ok" if committed else "mismatch")
    return lambda now: ("expired" if exp < now
                        else "ok" if committed else "mismatch")


class Tokens:
    """Every node's evidence annotation at each resourceVersion, from the
    fleet as made and the writes sent in commit order, and both tokens'
    verdicts on each document (signatures checked once a document)."""

    def __init__(self, fleet: List[dict], writes: Iterable[Tuple[int, int,
                                                                 dict]],
                 identity_jwks: dict, attestation_jwks: dict,
                 audience: str) -> None:
        self.names = [n["metadata"]["name"] for n in fleet]
        self.id_keys = read_jwks(identity_jwks)
        self.att_keys = read_jwks(attestation_jwks)
        self.audience = audience
        #: per node: resourceVersions at which its annotation changed,
        #: and the annotation from each on (the first holds from the start)
        self.rvs: List[List[int]] = [[-1] for _ in fleet]
        self.raws: List[List[Optional[str]]] = [
            [(n["metadata"].get("annotations") or {}).get(
                EVIDENCE_ANNOTATION)] for n in fleet]
        for rv, node, patch in writes:
            ann = (patch.get("metadata") or {}).get("annotations") or {}
            if EVIDENCE_ANNOTATION in ann:
                self.rvs[node].append(rv)
                self.raws[node].append(ann[EVIDENCE_ANNOTATION])
        self._memo: Dict[Tuple[int, str], Tuple[Judged, Judged]] = {}

    def raw_at(self, node: int, rv: int) -> Optional[str]:
        return self.raws[node][bisect.bisect_right(self.rvs[node], rv) - 1]

    def judged(self, node: int, rv: int) -> Optional[Tuple[Judged, Judged]]:
        """The two verdicts on the node's document at ``rv`` (None
        without one, or one that is not a JSON object)."""
        raw = self.raw_at(node, rv)
        if raw is None:
            return None
        key = (node, raw)
        if key not in self._memo:
            try:
                doc = json.loads(raw)
            except ValueError:
                doc = None
            if not isinstance(doc, dict):
                return None
            self._memo[key] = (
                judge_identity(doc, self.names[node], self.id_keys,
                               self.audience),
                judge_attestation(doc, self.att_keys))
        return self._memo[key]


def _node_check(v, judged: Optional[Tuple[Judged, Judged]], now: float,
                mode: str, require: Tuple[bool, bool]
                ) -> Tuple[bool, List[str]]:
    """Is a converged node's evidence a suspect, and the token verdicts
    a verifier reaches on the way (identity first; attestation only
    where identity did not decide)."""
    if not v.ev_present:
        return False, []
    if v.ev_verdict != "ok" or (v.ev_attested is not None
                                and v.ev_attested != mode):
        return True, []
    if judged is None:
        return True, []
    idv = judged[0](now)
    if idv in ("mismatch", "invalid") or (
            idv in ("missing", "expired") and require[0]):
        return True, ["id_" + idv]
    attv = judged[1](now)
    suspect = attv in ("mismatch", "invalid") or (
        attv in ("missing", "expired") and require[1])
    return suspect, ["id_" + idv, "att_" + attv]


def expected_groups(hist, tokens: Tokens, vids: np.ndarray, rv: int,
                    now: float, mode: str, require: Tuple[bool, bool]
                    ) -> Tuple[Dict[str, Tuple[List[str], str, str]],
                               Counter]:
    """The rollout's plan at the versions ``vids`` (current at ``rv``)
    and wall clock ``now``: one group per slice, one per unsliced node;
    skipped when every member is at ``mode`` and none is a suspect, else
    planned. Also the token verdicts a verifier counts on the way."""
    members: Dict[str, List[int]] = {}
    for i in range(hist.n):
        v = hist.versions[int(vids[i])]
        g = f"slice/{v.slice}" if v.slice else f"node/{hist.names[i]}"
        members.setdefault(g, []).append(i)
    out = {}
    counts: Counter = Counter()
    for g, idx in members.items():
        vs = [hist.versions[int(vids[i])] for i in idx]
        skipped = all(v.desired_label == mode and v.state == mode
                      for v in vs)
        if skipped:
            # every member is judged, as a verifier names each suspect
            for i, v in zip(idx, vs):
                suspect, seen = _node_check(v, tokens.judged(i, rv), now,
                                            mode, require)
                counts.update(seen)
                skipped = skipped and not suspect
        out[g] = (sorted(hist.names[i] for i in idx),
                  "skipped" if skipped else "planned",
                  f"already at {mode}" if skipped else "")
    return out, counts


def check_groups(groups: List[dict], hist, tokens: Tokens, lo: int,
                 hi: int, clock: Tuple[float, float], mode: str,
                 require: Tuple[bool, bool], t: Tally) -> Optional[Counter]:
    """Judge a preflight's group plan: each group as the plan at either
    bound of the resourceVersions and either end of the wall clock has
    it. Returns the token verdict counts where all four readings agree
    on them, else None."""
    readings = [expected_groups(hist, tokens, hist.vids_at(rv), rv, now,
                                mode, require)
                for rv in (lo, hi) for now in clock]
    names = [g["name"] for g in groups]
    t.add(int(names != sorted(readings[0][0])), "groups: names or order")
    for g in groups:
        got = (list(g["nodes"]), g["outcome"], g.get("detail", ""))
        t.add(int(not any(r[0].get(g["name"]) == got for r in readings)),
              "groups: members or outcome")
    counts = [r[1] for r in readings]
    return counts[0] if all(c == counts[0] for c in counts) else None
