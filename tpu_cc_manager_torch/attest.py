"""Platform attestation — the TEE rung of the evidence chain.

Round-4 closed cross-node forgery: evidence is HMAC-signed with the
pool key AND carries the node's platform-identity token, so a stolen
pool key cannot speak for another node. The residual
(docs/security.md) was node-root forgery: root ON the node can
rewrite the durable statefile, read the node's own mounted pool key,
obtain the node's own identity token (it runs on the instance), and
publish perfectly-signed lies. Nothing in that chain is rooted below
the host OS.

This module adds the missing rung: a quote over the evidence document
from a root the host OS cannot counterfeit —

- ``FakeTpm`` (tests / smoke / TPU_CC_ATTESTATION=fake): a software
  TPM double with ONE extend-only PCR and a measured flip log. The
  mode engine extends the PCR on every REAL mode transition
  (engine.py calls :func:`note_mode_applied`); a quote signs
  (nonce, pcr, log) with the attestation key. The security property
  modeled: root can rewrite the statefile and re-sign evidence, and
  can even request a fresh quote over the forged document — but the
  forged CLAIM ("cc is on") contradicts the measured flip history
  ("last real transition was to off"), and extend-only history cannot
  be rewritten. On a real TPM the extend is rooted in hardware; the
  double trusts its state directory instead (the drill rewrites the
  statefile, not the TPM state — exactly the attack surface split a
  real vTPM gives you).
- ``ConfidentialSpaceAttestor`` (TPU_CC_ATTESTATION=confidential-space,
  or ``auto`` when the launcher socket exists): fetches a Google
  Confidential Space attestation token from the in-VM launcher's unix
  socket with the evidence digest as the EAT nonce. The token is an
  RS256 JWT verified offline against a provisioned JWKS
  (TPU_CC_ATTESTATION_JWKS_FILE — same no-public-internet posture as
  identity's JWKS). Confidential Space attests the VM/container
  measurement at the platform level, so there is no per-flip PCR to
  extend; nonce binding is the whole check.

The quote is attached INSIDE the evidence document before the pool-key
digest is computed, and its nonce commits to everything else in the
document (the canonical body minus ``digest``/``attestation``): a
verifier that accepts the quote knows it was minted for exactly this
document.

Verdicts (``judge_attestation``): ``ok | missing | invalid | mismatch
| unverifiable`` — deliberately the same shape as identity's, but a
SEPARATE axis: the fleet audit reports ``attestation_missing`` /
``attestation_mismatch`` buckets so an operator can tell "no TEE
configured" from "the TEE contradicts the evidence".

Env knobs (documented in config.py):

- ``TPU_CC_ATTESTATION``: ``auto`` (default: Confidential Space socket
  if present, else none — a bare /dev/tpm0 is logged but unusable
  without a userspace TPM stack), ``fake``, ``confidential-space``,
  ``none``.
- ``TPU_CC_TPM_STATE_DIR``: the FakeTpm's "hardware" state (PCR + log);
  defaults to ``$TPU_CC_STATE_DIR/tpm``.
- ``TPU_CC_TPM_KEY[_FILE]``: the FakeTpm quote-signing key (the test
  double's stand-in for an AIK; shared with verifiers like the pool
  evidence key).
- ``TPU_CC_ATTESTATION_JWKS_FILE``: JWKS for offline verification of
  Confidential Space tokens.
- ``TPU_CC_REQUIRE_ATTESTATION``: verifiers flag attestation-less
  evidence even on an all-missing pool (otherwise missing is only
  flagged on MIXED pools, mirroring identity).

Reference anchor: the hardware-enforced mode this approximates is the
reference's register-level CC flip (/root/reference/main.py:282-296),
where silicon — not a host-side file — holds the mode.
"""

from __future__ import annotations

import hashlib
import hmac as hmac_mod
import json
import logging
import os
import threading
import time
from typing import List, Optional, Tuple

log = logging.getLogger("tpu-cc-manager.attest")

ATTESTATION_VERSION = 1

#: the PCR's reset value (SHA-256 bank convention: all zeros)
PCR_INITIAL = "0" * 64

#: Confidential Space launcher socket (the in-VM token endpoint)
CS_SOCKET_DEFAULT = "/run/container_launcher/teeserver.sock"


# ------------------------------------------------------------ key/env
def tpm_keys() -> Tuple[bytes, ...]:
    """All accepted attestation keys, SIGNING (primary) key first.

    The PRIMARY — TPU_CC_TPM_KEY (the WHOLE inline value) or the whole
    stripped content of TPU_CC_TPM_KEY_FILE — signs every new quote;
    its legacy whole-value semantics are untouched, so a raw-random
    key containing a newline neither changes meaning on upgrade nor
    silently truncates. TPU_CC_TPM_OLD_KEYS (inline) or
    TPU_CC_TPM_OLD_KEYS_FILE lists RETIRED keys one per line, accepted
    for verification only — the rotation-tail posture mirrored from
    the evidence pool key (evidence.evidence_keys). Without the tail,
    rotating the attestation key mid-scan would make every verifier
    read the fleet's still-old quotes as ``mismatch`` — an
    attack-shaped verdict for a routine operation. Retired keys must
    therefore be newline-free (base64/hex keys are; raw-binary retired
    keys should be re-cut). A missing key/file is silent
    (optional-Secret posture); retired keys alone keep this verifier
    keyless, exactly like evidence's rule."""
    primary = tpm_key()
    if primary is None:
        return ()
    keys: Tuple[bytes, ...] = (primary,)
    raw = os.environ.get("TPU_CC_TPM_OLD_KEYS", "").encode()
    if not raw:
        old_path = os.environ.get("TPU_CC_TPM_OLD_KEYS_FILE", "")
        if old_path:
            try:
                with open(old_path, "rb") as f:
                    raw = f.read()
            except OSError:
                raw = b""
    for line in raw.splitlines():
        line = line.strip()
        if line and line not in keys:
            keys = keys + (line,)
    return keys


def tpm_key() -> Optional[bytes]:
    """The PRIMARY (signing) FakeTpm quote key, or None. Verifiers
    should resolve :func:`tpm_keys` instead so rotation-tail keys stay
    accepted."""
    inline = os.environ.get("TPU_CC_TPM_KEY", "")
    if inline:
        return inline.encode()
    path = os.environ.get("TPU_CC_TPM_KEY_FILE", "")
    if path:
        try:
            with open(path, "rb") as f:
                return f.read().strip() or None
        except OSError:
            return None
    return None


def require_attestation() -> bool:
    return os.environ.get(
        "TPU_CC_REQUIRE_ATTESTATION", ""
    ).lower() in ("1", "true", "yes")


def _canonical(obj) -> bytes:
    return json.dumps(obj, sort_keys=True, separators=(",", ":")).encode()


# ----------------------------------------------------------- PCR math
def extend_pcr(pcr_hex: str, event: str) -> str:
    """One TPM-style extend: PCR' = H(PCR || H(event))."""
    return hashlib.sha256(
        bytes.fromhex(pcr_hex) + hashlib.sha256(event.encode()).digest()
    ).hexdigest()


def replay_log(events: List[str]) -> str:
    """The PCR value a log of events folds to — the verifier-side half
    of extend-only history."""
    pcr = PCR_INITIAL
    for e in events:
        pcr = extend_pcr(pcr, str(e))
    return pcr


def measured_mode(events: List[str]) -> Optional[str]:
    """The last REAL mode transition the measured log records (events
    are ``mode:<value>``); None when no transition was ever measured."""
    for e in reversed(list(events)):
        if isinstance(e, str) and e.startswith("mode:"):
            return e[len("mode:"):]
    return None


# ------------------------------------------------------------ FakeTpm
class FakeTpm:
    """Software TPM double: one extend-only PCR persisted in a state
    directory, quotes HMAC-signed with the attestation key. The state
    dir plays the role of hardware — the node-root drill rewrites the
    STATEFILE, not this directory, because on real silicon the PCR is
    out of the filesystem entirely."""

    provider = "fake-tpm"

    def __init__(self, state_dir: Optional[str] = None,
                 key: Optional[bytes] = None):
        if state_dir is None:
            state_dir = os.environ.get("TPU_CC_TPM_STATE_DIR") or \
                os.path.join(
                    os.environ.get("TPU_CC_STATE_DIR", "/var/lib/tpu-cc"),
                    "tpm",
                )
        self.state_dir = state_dir
        self._key = key
        self._lock = threading.Lock()

    def _key_bytes(self) -> Optional[bytes]:
        return self._key if self._key is not None else tpm_key()

    def set_key(self, key: Optional[bytes]) -> None:
        """Swap the quote-signing key (the key-rotation drill: the node
        re-quotes under the new key on its next evidence build; the
        verifier keeps the old key in its rotation tail until the fleet
        has re-quoted). The measured log is untouched — rotation
        changes who vouches, not what happened."""
        with self._lock:
            self._key = key

    def _log_path(self) -> str:
        return os.path.join(self.state_dir, "log")

    def _read_state(self) -> Tuple[str, List[str]]:
        """(pcr, events). The append-only log is the ONLY persisted
        state — the PCR is derived by replay, so there is no two-file
        update to interrupt: a crash mid-extend leaves at worst a
        complete log line or none, never a log that disagrees with a
        separately-stored PCR (which would read as 'mismatch'
        forever)."""
        events: List[str] = []
        try:
            with open(self._log_path()) as f:
                events = [ln.rstrip("\n") for ln in f if ln.strip()]
        except OSError:
            pass
        return replay_log(events), events

    def extend(self, event: str) -> str:
        """Fold ``event`` into the measured log; returns the new PCR.
        Called by the mode engine on every REAL transition (never on
        the idempotent fast path — the log is flip history, not
        reconcile history). One O_APPEND write: atomic enough across
        the in-process agent and the bash engine's separate --extend
        process; the lock covers same-process threads."""
        with self._lock:
            os.makedirs(self.state_dir, exist_ok=True)
            with open(self._log_path(), "a") as f:
                f.write(event + "\n")
            pcr, _ = self._read_state()
            return pcr

    def quote(self, nonce_hex: str) -> dict:
        """Sign (nonce, pcr, log) — the log rides along so verifiers
        can replay it (TPM quote + event log, in one envelope)."""
        with self._lock:
            pcr, events = self._read_state()
        body = {
            "version": ATTESTATION_VERSION,
            "provider": self.provider,
            "nonce": nonce_hex,
            "pcr": pcr,
            "log": events,
        }
        key = self._key_bytes()
        if key:
            body["sig"] = hmac_mod.new(
                key, _canonical(body), hashlib.sha256
            ).hexdigest()
        return body


# ----------------------------------------- Confidential Space (real)
class ConfidentialSpaceAttestor:
    """Fetch a Confidential Space attestation token from the in-VM
    launcher socket, with the evidence digest as the EAT nonce. Only
    meaningful inside a Confidential Space VM; ``probe`` gates
    ``auto``."""

    provider = "confidential-space"

    def __init__(self, socket_path: Optional[str] = None,
                 timeout_s: float = 2.0):
        self.socket_path = socket_path or os.environ.get(
            "TPU_CC_CS_SOCKET", CS_SOCKET_DEFAULT
        )
        self.timeout_s = timeout_s

    def probe(self) -> bool:
        return os.path.exists(self.socket_path)

    def quote(self, nonce_hex: str) -> dict:
        import http.client
        import socket as socket_mod

        class _UnixConn(http.client.HTTPConnection):
            def __init__(conn_self, path, timeout):
                super().__init__("localhost", timeout=timeout)
                conn_self._path = path

            def connect(conn_self):
                s = socket_mod.socket(
                    socket_mod.AF_UNIX, socket_mod.SOCK_STREAM
                )
                s.settimeout(conn_self.timeout)
                s.connect(conn_self._path)
                conn_self.sock = s

        conn = _UnixConn(self.socket_path, self.timeout_s)
        try:
            body = json.dumps({
                "audience": "tpu-cc-manager",
                "token_type": "OIDC",
                "nonces": [nonce_hex],
            })
            conn.request("POST", "/v1/token", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            token = resp.read().decode()
            if resp.status != 200 or not token:
                raise RuntimeError(
                    f"launcher token endpoint: http {resp.status}"
                )
        finally:
            conn.close()
        return {
            "version": ATTESTATION_VERSION,
            "provider": self.provider,
            "nonce": nonce_hex,
            "token": token,
        }


# -------------------------------------------------------- resolution
_cache: dict = {}
_warned_tpm_device = False


def get_attestor(refresh: bool = False):
    """Resolve the node's attestor from TPU_CC_ATTESTATION. ``auto``
    takes the Confidential Space socket when present; a bare /dev/tpm0
    is logged once and SKIPPED (no userspace TPM stack is vendored —
    set an explicit mode to opt in); otherwise none."""
    global _warned_tpm_device
    mode = os.environ.get("TPU_CC_ATTESTATION", "auto").lower()
    if mode in ("none", "off", "false", ""):
        return None
    if refresh:
        _cache.pop(mode, None)
    if mode in _cache:
        return _cache[mode]
    if mode == "fake":
        _cache[mode] = FakeTpm()
    elif mode in ("confidential-space", "cs"):
        _cache[mode] = ConfidentialSpaceAttestor()
    elif mode == "auto":
        cs = ConfidentialSpaceAttestor()
        if cs.probe():
            _cache[mode] = cs
        else:
            if os.path.exists("/dev/tpm0") and not _warned_tpm_device:
                _warned_tpm_device = True
                log.info(
                    "/dev/tpm0 present but no userspace TPM stack is "
                    "vendored; set TPU_CC_ATTESTATION explicitly to "
                    "opt in to an attestation provider"
                )
            _cache[mode] = None
    else:
        log.warning("unknown TPU_CC_ATTESTATION=%r; attestation off",
                    mode)
        _cache[mode] = None
    return _cache[mode]


def note_mode_applied(mode: str) -> None:
    """Measured flip history: the mode engine calls this after every
    REAL (non-idempotent) successful transition. Best-effort — a
    broken TPM state dir must not fail a flip — and a no-op for
    providers without per-flip measurement (Confidential Space)."""
    att = get_attestor()
    extend = getattr(att, "extend", None)
    if extend is None:
        return
    try:
        extend(f"mode:{mode}")
    except Exception:
        log.warning("attestation extend failed; measured flip history "
                    "will lag", exc_info=True)


# ------------------------------------------------------- verification
def attestation_nonce(doc: dict) -> str:
    """What a quote for this document must commit to: SHA-256 of the
    canonical body minus ``digest`` (computed after the quote) and
    ``attestation`` (the quote itself)."""
    body = {k: v for k, v in doc.items()
            if k not in ("digest", "attestation")}
    return hashlib.sha256(_canonical(body)).hexdigest()


def verify_quote(att: dict, expected_nonce: str, *,
                 key: Optional[bytes] = None
                 ) -> Tuple[str, str]:
    """Judge a fake-tpm quote against the nonce it should commit to.
    Returns (verdict, detail): ok | invalid | mismatch | unverifiable.
    """
    if not isinstance(att, dict):
        return "invalid", "attestation field malformed"
    if att.get("provider") != FakeTpm.provider:
        return "invalid", f"unknown provider {att.get('provider')!r}"
    nonce = att.get("nonce")
    pcr = att.get("pcr")
    events = att.get("log")
    if not isinstance(nonce, str) or not isinstance(pcr, str) \
            or not isinstance(events, list):
        return "invalid", "quote shape malformed"
    if nonce != expected_nonce:
        return "mismatch", (
            "quote nonce does not commit to this document (quote "
            "replayed from another document?)"
        )
    if replay_log([str(e) for e in events]) != pcr:
        return "mismatch", "event log does not replay to the quoted PCR"
    # key=None resolves the env posture INCLUDING the rotation tail
    # (tpm_keys): during a key rotation the fleet's still-old quotes
    # must verify under a retired key instead of reading as forgery.
    # A tuple/list is an EXPLICIT posture (per-region trust roots,
    # federation): its keys verbatim, and an empty one means an
    # explicitly keyless verifier — 'unverifiable', never env fallback
    # (a revoked region must not inherit the process-global root).
    if key is None:
        keys: Tuple[bytes, ...] = tpm_keys()
    elif isinstance(key, (tuple, list)):
        keys = tuple(key)
    else:
        keys = (key,)
    if not keys:
        return "unverifiable", (
            "no attestation key provisioned (TPU_CC_TPM_KEY[_FILE]) — "
            "quote cannot be authenticated"
        )
    body = {k: v for k, v in att.items() if k != "sig"}
    sig = str(att.get("sig") or "")
    payload = _canonical(body)
    for k in keys:
        want = hmac_mod.new(k, payload, hashlib.sha256).hexdigest()
        if hmac_mod.compare_digest(want, sig):
            return "ok", "quote verifies"
    return "mismatch", "quote signature does not verify"


def _judge_cs_token(att: dict, expected_nonce: str) -> Tuple[str, str]:
    """Offline verification of a Confidential Space token against the
    provisioned JWKS, nonce included. Inside a group plan the keys are
    those its batch read when the plan began
    (:func:`identity._snapshot_keys`); elsewhere the file is read for
    each token."""
    token = att.get("token")
    if not isinstance(token, str) or token.count(".") != 2:
        return "invalid", "attestation token malformed"
    jwks_path = os.environ.get("TPU_CC_ATTESTATION_JWKS_FILE", "")
    if not jwks_path:
        return "unverifiable", (
            "no TPU_CC_ATTESTATION_JWKS_FILE provisioned — token "
            "cannot be verified offline"
        )
    from tpu_cc_manager_torch.identity import (
        _b64url_decode, _rsa_pkcs1_sha256_verify, _signed_parts,
        _snapshot_keys, load_jwks,
    )

    try:
        header_b64, payload_b64, sig_b64 = token.split(".")
        header = json.loads(_b64url_decode(header_b64))
        payload = json.loads(_b64url_decode(payload_b64))
    except Exception as e:
        return "invalid", f"attestation token undecodable: {e}"
    keys = _snapshot_keys(jwks_path)
    if keys is None:
        try:
            keys = load_jwks(jwks_path)
        except Exception as e:
            # an operator config error (truncated ConfigMap, unreadable
            # mount) must read as unverifiable, never as a fleet-wide
            # forgery alarm
            return "unverifiable", f"JWKS unreadable: {e}"
    kid = header.get("kid")
    if kid not in keys:
        return "unverifiable", f"token kid {kid!r} not in JWKS"
    n, e = keys[kid]
    try:
        signing_input, sig = _signed_parts(token)
        if not _rsa_pkcs1_sha256_verify(n, e, signing_input, sig):
            return "mismatch", "token signature does not verify"
    except Exception as e:
        return "invalid", f"token signature undecodable: {e}"
    exp = payload.get("exp")
    if isinstance(exp, (int, float)) and exp < time.time():
        # staleness, not forgery: the platform DID attest, the token
        # simply aged out on an idle node — classed like identity's
        # expired (missing-shaped), never as the forgery alarm
        return "expired", "attestation token expired"
    nonces = payload.get("eat_nonce")
    if isinstance(nonces, str):
        nonces = [nonces]
    if not isinstance(nonces, list) or expected_nonce not in nonces:
        return "mismatch", (
            "token eat_nonce does not commit to this document"
        )
    return "ok", "attestation token verifies"


def judge_attestation(doc: dict, node_name: Optional[str] = None, *,
                      key: Optional[bytes] = None
                      ) -> Tuple[str, str]:
    """Judge the ``attestation`` field of an evidence document. Returns
    (verdict, detail) with verdicts ``ok | missing | expired | invalid
    | mismatch | unverifiable`` — a separate axis from identity, so
    the fleet audit can distinguish "no TEE" from "TEE contradicts the
    evidence". ``expired`` (a Confidential Space token that aged out)
    is staleness, classed with missing by every verifier. The
    node-root drill lands in ``mismatch``: a forged claim's measured
    flip history disagrees with the mode the document attests."""
    if not isinstance(doc, dict):
        return "invalid", "document malformed"
    att = doc.get("attestation")
    if att is None:
        return "missing", "no attestation attached"
    expected = attestation_nonce(doc)
    if isinstance(att, dict) and att.get("provider") == \
            ConfidentialSpaceAttestor.provider:
        return _judge_cs_token(att, expected)
    verdict, detail = verify_quote(att, expected, key=key)
    if verdict not in ("ok", "unverifiable"):
        return verdict, detail
    # the root-forgery check: the document's device-truth claim must
    # agree with the MEASURED flip history. This comparison needs NO
    # key — the nonce commitment and PCR replay already passed — so it
    # runs even for 'unverifiable' quotes (keyless verifier host):
    # same principle as the evidence path's keyless-checkable claims.
    # It only catches forgers too lazy to fabricate a whole quote
    # there (no signature binds the log), but a contradiction is a
    # contradiction. An empty log is lenient (attestation enabled
    # mid-life, no transition measured yet) — strictness there would
    # flag every fresh enablement.
    from tpu_cc_manager_torch.evidence import evidence_mode

    measured = measured_mode(att.get("log") or [])
    claimed = evidence_mode(doc)
    if measured is not None and claimed is not None \
            and measured != claimed:
        qualifier = (
            " (quote signature unverifiable here — but the claim "
            "contradiction needs no key to read)"
            if verdict == "unverifiable" else ""
        )
        return "mismatch", (
            f"document attests mode {claimed!r} but the measured flip "
            f"history's last real transition was to {measured!r} — "
            "state was changed outside the measured engine path "
            f"(node-root statefile rewrite?){qualifier}"
        )
    if verdict == "unverifiable":
        return verdict, detail
    return "ok", "quote verifies and matches measured history"


def quote_refresh_deadline(doc: dict) -> Optional[float]:
    """Wall-clock time at which the evidence should be republished
    because its attestation token nears expiry — the attestation twin
    of the agent's identity-refresh deadline, and the freshness input
    ``evidence_in_sync`` uses for Confidential Space quotes (fake-tpm
    quotes carry no expiry: their freshness is the key posture). None
    when there is nothing to age out."""
    att = doc.get("attestation") if isinstance(doc, dict) else None
    if not isinstance(att, dict) or att.get("provider") != \
            ConfidentialSpaceAttestor.provider:
        return None
    token = att.get("token")
    if not isinstance(token, str) or token.count(".") != 2:
        return None
    from tpu_cc_manager_torch.identity import REPUBLISH_MARGIN, token_claims

    try:
        _, claims = token_claims(token)
        exp = claims.get("exp")
        if not isinstance(exp, (int, float)):
            return None
        iat = claims.get("iat")
        if isinstance(iat, (int, float)):
            margin = REPUBLISH_MARGIN * max(float(exp) - float(iat), 0.0)
        else:
            margin = 300.0
        return float(exp) - margin
    except Exception:  # ccaudit: allow-swallow(undecodable quote has no expiry to extract; caller treats None as never)
        return None


# --------------------------------------------------------------- CLI
def main(argv=None) -> int:
    """``python -m tpu_cc_manager.attest`` — the bash engine's hook
    into measured history (--extend after a real flip) plus operator
    introspection (--status)."""
    import argparse

    p = argparse.ArgumentParser(prog="tpu-cc-attest")
    p.add_argument("--extend", metavar="MODE",
                   help="record a real mode transition in the "
                        "measured log")
    p.add_argument("--status", action="store_true",
                   help="print the resolved provider and PCR state")
    args = p.parse_args(argv)
    if args.extend:
        note_mode_applied(args.extend)
        return 0
    if args.status:
        att = get_attestor()
        out = {"provider": getattr(att, "provider", None)}
        if isinstance(att, FakeTpm):
            pcr, events = att._read_state()
            out.update(pcr=pcr, log=events,
                       measured_mode=measured_mode(events))
        print(json.dumps(out, indent=2, sort_keys=True))
        return 0
    p.print_help()
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
