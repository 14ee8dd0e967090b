"""Platform identity for the evidence chain (VERDICT r3 missing #1).

The reference's security claim bottoms out in hardware: the flip
programs device registers and the device itself enforces the mode
(reference main.py:282-296 resets the GPU and re-queries it;
scripts/cc-manager.sh drives the same path). On TPU the attestation
mode is host-side durable state, so round 2 introduced the signed
evidence document — but its strongest link was an HMAC with a
POOL-SHARED key: any party holding the key (or root on any node of the
pool) could mint evidence for any other node.

This module adds the missing binding to a *platform* identity the pool
key cannot forge:

- On GCE/GKE, every node's metadata server mints **instance identity
  tokens** — RS256 JWTs signed by Google, carrying the instance name
  (which IS the GKE node name) and a caller-chosen audience. Only code
  running on that instance can obtain them; a stolen pool HMAC key on
  node A cannot produce node B's token.
- The agent attaches a fresh token to every evidence document
  (``doc["identity"]``); the document digest covers it, so the token
  and the device attestation are bound together.
- Verifiers (fleet audit, rollout judge) check the token's node
  binding and audience. A document signed with the stolen pool key but
  LACKING the node's identity token is flagged (``identity_missing``);
  a token minted for a different node is ``identity_mismatch``.

Providers:

- ``GceIdentity`` — fetches from the metadata server (host overridable
  for tests; 169.254.169.254 semantics). Full RS256 *signature*
  verification requires Google's JWKS, which an offline verifier may
  not reach — token claims (node binding, audience, expiry) are always
  checked, and the signature verdict degrades to ``unverifiable``
  without JWKS, exactly like the evidence HMAC degrades to ``no_key``.
- ``FakePlatformIdentity`` — HS256 with a test key, for tests and the
  smoke; with the key the signature IS verified, so the full
  forged-evidence drill runs hermetically.

Env knobs (documented in config.py):

- ``TPU_CC_IDENTITY``: ``auto`` (default: probe the metadata server
  once, cache the outcome), ``gce``, ``fake``, or ``none``.
- ``TPU_CC_IDENTITY_KEY[_FILE]``: HS256 key for the fake provider.
- ``TPU_CC_IDENTITY_AUDIENCE``: token audience (default
  ``tpu-cc-manager``) — pins tokens to this framework so an identity
  token minted for some other service cannot be replayed here.
- ``TPU_CC_REQUIRE_IDENTITY``: verifiers treat missing identity as a
  problem even on an all-missing pool (otherwise missing is only
  flagged on MIXED pools, where uniformity is the tell).
"""

from __future__ import annotations

import base64
import hashlib
import hmac as hmac_mod
import json
import logging
import os
import time
from contextvars import ContextVar
from typing import Optional, Tuple

log = logging.getLogger("tpu-cc-manager.identity")

DEFAULT_AUDIENCE = "tpu-cc-manager"

#: fraction of a token's lifetime remaining at which evidence should
#: be REPUBLISHED with a fresh token (agent idle tick, native-path
#: `evidence --sync`). Deliberately INSIDE _TokenCaching.refresh_margin
#: (0.25): by the time a republish is due, the provider cache already
#: refuses to serve the old token, so the rebuild fetches fresh instead
#: of re-serving and looping.
REPUBLISH_MARGIN = 0.2

#: metadata-server path serving instance identity tokens (GCE contract)
GCE_IDENTITY_PATH = (
    "/computeMetadata/v1/instance/service-accounts/default/identity"
)


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def identity_audience() -> str:
    return os.environ.get("TPU_CC_IDENTITY_AUDIENCE", DEFAULT_AUDIENCE)


def identity_key() -> Optional[bytes]:
    """HS256 key for the fake provider: TPU_CC_IDENTITY_KEY inline or
    TPU_CC_IDENTITY_KEY_FILE path. Missing file is silent (same
    optional-Secret posture as the evidence key)."""
    inline = os.environ.get("TPU_CC_IDENTITY_KEY", "")
    if inline:
        return inline.encode()
    path = os.environ.get("TPU_CC_IDENTITY_KEY_FILE", "")
    if path:
        try:
            with open(path, "rb") as f:
                return f.read().strip() or None
        except OSError:
            return None
    return None


# ------------------------------------------------------------- minting
def mint_fake_token(node_name: str, key: bytes, *,
                    audience: Optional[str] = None,
                    now: Optional[float] = None,
                    ttl_s: float = 3600.0) -> str:
    """HS256 JWT shaped like a GCE full-format instance identity token
    (claims nest under google.compute_engine the way the metadata
    server emits them), so verifiers exercise the same claim paths for
    fake and real tokens."""
    now = time.time() if now is None else now
    header = {"alg": "HS256", "typ": "JWT", "kid": "tpu-cc-fake"}
    payload = {
        "iss": "fake-metadata",
        "aud": audience or identity_audience(),
        "iat": int(now),
        "exp": int(now + ttl_s),
        "google": {"compute_engine": {"instance_name": node_name}},
    }
    signing_input = (
        _b64url(json.dumps(header, sort_keys=True).encode()) + "." +
        _b64url(json.dumps(payload, sort_keys=True).encode())
    )
    sig = hmac_mod.new(key, signing_input.encode(), hashlib.sha256).digest()
    return signing_input + "." + _b64url(sig)


class _TokenCaching:
    """Per-provider token cache. The reconcile path must not block on
    the metadata server (the evidence build is synchronous by design —
    agent.py builds it inline so device state isn't torn): steady-state
    flips hit the cache, and the agent's idle tick refreshes evidence —
    and with it the token — before expiry, so fetches happen off the
    hot path. ``refresh_margin`` is the fraction of remaining lifetime
    at which a cached token stops being served."""

    refresh_margin = 0.25

    def __init__(self):
        self._cache: dict = {}

    def cached_token(self, node_name: str,
                     audience: Optional[str] = None) -> str:
        aud = audience or identity_audience()
        now = time.time()
        hit = self._cache.get((node_name, aud))
        if hit is not None:
            tok, iat, exp = hit
            # opaque tokens (exp unknown) are never considered fresh —
            # they refetch every call rather than silently aging out
            if exp is not None and now < exp - self.refresh_margin * max(
                    exp - iat, 0):
                return tok
        try:
            tok = self.token(node_name, audience=aud)
        except Exception:
            # a fetch blip inside the refresh margin must not strip
            # identity: the cached token is still VALID (not expired),
            # just aging — serve it and let a later call refresh
            if hit is not None:
                tok, _iat, exp = hit
                if exp is not None and now < exp:
                    log.warning(
                        "identity token refresh failed; serving the "
                        "still-valid cached token", exc_info=True,
                    )
                    return tok
            raise
        iat, exp = now, None
        try:
            _, payload = token_claims(tok)
            if isinstance(payload.get("exp"), (int, float)):
                exp = float(payload["exp"])
            if isinstance(payload.get("iat"), (int, float)):
                iat = float(payload["iat"])
        except Exception:  # ccaudit: allow-swallow(opaque token is still servable; decode only feeds the expiry cache)
            pass
        self._cache[(node_name, aud)] = (tok, iat, exp)
        return tok


class FakePlatformIdentity(_TokenCaching):
    """Test/smoke provider: mints HS256 tokens with a shared key. The
    key plays the role of Google's signing key — hold it and you can
    mint identities, which is exactly the boundary the tests probe."""

    provider = "fake"

    def __init__(self, key: Optional[bytes] = None):
        super().__init__()
        #: explicit override; None = resolve the env key at token time,
        #: so a process-cached provider follows key-posture changes
        self._key = key

    def token(self, node_name: str,
              audience: Optional[str] = None) -> str:
        key = self._key if self._key is not None else identity_key()
        if not key:
            raise RuntimeError(
                "fake identity provider needs TPU_CC_IDENTITY_KEY[_FILE]"
            )
        return mint_fake_token(node_name, key, audience=audience)


class GceIdentity(_TokenCaching):
    """Fetches instance identity tokens from the GCE metadata server.
    ``node_name`` is ignored at mint time — the metadata server only
    ever speaks for its own instance, which is the entire point."""

    provider = "gce"

    def __init__(self, metadata_host: Optional[str] = None,
                 timeout_s: float = 1.0):
        super().__init__()
        self.metadata_host = metadata_host or os.environ.get(
            "TPU_CC_METADATA_HOST", "metadata.google.internal"
        )
        self.timeout_s = timeout_s

    def token(self, node_name: str,
              audience: Optional[str] = None) -> str:
        import urllib.parse
        import urllib.request

        aud = urllib.parse.quote(audience or identity_audience(),
                                 safe="")
        url = (
            f"http://{self.metadata_host}{GCE_IDENTITY_PATH}"
            f"?audience={aud}&format=full"
        )
        req = urllib.request.Request(
            url, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return resp.read().decode().strip()

    def probe(self) -> bool:
        """Cheap reachability check (instance id, not a token mint) for
        auto-detection — probing must not burn a full identity-token
        round trip just to throw the token away."""
        import urllib.request

        url = f"http://{self.metadata_host}/computeMetadata/v1/instance/id"
        req = urllib.request.Request(
            url, headers={"Metadata-Flavor": "Google"}
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s):
            return True


# ------------------------------------------------------- provider pick
#: cached auto-detection outcome: None = not probed yet; False = probed
#: and absent; provider otherwise. A hit is cached for the process
#: lifetime (the provider instance also holds the token cache); a MISS
#: is re-probed after _AUTO_RETRY_S — a metadata-server blip at agent
#: boot must not permanently strip identity from this node's evidence
_auto_cache: Optional[object] = None
_auto_probed_at: float = 0.0
_AUTO_RETRY_S = 300.0

#: explicit-mode provider singletons, so the token cache survives
#: across build_evidence calls
_explicit_cache: dict = {}


def get_identity_provider(refresh: bool = False):
    """Resolve the node's identity provider from TPU_CC_IDENTITY.
    ``auto`` probes the metadata server (negative outcome retried every
    ~5 min); explicit ``gce``/``fake`` trust the operator and skip
    probing. Returned instances are process-cached so their token
    caches persist."""
    global _auto_cache, _auto_probed_at
    mode = os.environ.get("TPU_CC_IDENTITY", "auto").lower()
    if mode in ("none", "off", "false", ""):
        return None
    if mode == "fake":
        if refresh or "fake" not in _explicit_cache:
            _explicit_cache["fake"] = FakePlatformIdentity()
        return _explicit_cache["fake"]
    if mode == "gce":
        if refresh or "gce" not in _explicit_cache:
            _explicit_cache["gce"] = GceIdentity()
        return _explicit_cache["gce"]
    now = time.monotonic()
    if refresh or (
            _auto_cache is False and now - _auto_probed_at > _AUTO_RETRY_S):
        _auto_cache = None
    if _auto_cache is None:
        _auto_probed_at = now
        prov = GceIdentity(timeout_s=0.5)
        try:
            prov.probe()
            _auto_cache = prov
        except Exception:
            log.debug("no ambient platform identity (metadata server "
                      "probe failed)", exc_info=True)
            _auto_cache = False
    return _auto_cache or None


# ------------------------------------------------------------- JWKS
#: SHA-256 DigestInfo prefix for EMSA-PKCS1-v1_5 (RFC 8017 §9.2)
_SHA256_DIGEST_INFO = bytes.fromhex(
    "3031300d060960864801650304020105000420"
)

#: cached parsed JWKS: path -> {kid: (n, e)}; mtime-checked so a
#: rotated ConfigMap mount is picked up without a restart
_jwks_cache: dict = {}


#: JWKS files :func:`load_jwks` has read in this process
jwks_loads = 0


def load_jwks(path: str) -> dict:
    """Parse a JWKS document (the shape of Google's
    https://www.googleapis.com/oauth2/v3/certs, provisioned out-of-band
    — e.g. a ConfigMap refreshed by cluster tooling; this framework has
    no business dialing the public internet from a verifier) into
    {kid: (n, e)} RSA public numbers."""
    import json as _json

    global jwks_loads
    jwks_loads += 1
    with open(path) as f:
        doc = _json.load(f)
    keys = {}
    for key in doc.get("keys", []):
        if key.get("kty") != "RSA" or not key.get("kid"):
            continue
        try:
            n = int.from_bytes(_b64url_decode(key["n"]), "big")
            e = int.from_bytes(_b64url_decode(key["e"]), "big")
        except Exception:
            log.debug("skipping malformed JWKS key %r", key.get("kid"),
                      exc_info=True)
            continue
        keys[key["kid"]] = (n, e)
    return keys


def _jwks_for_env() -> Optional[dict]:
    """JWKS from TPU_CC_IDENTITY_JWKS_FILE, cached on (path, mtime).
    Missing file is silent — the optional-ConfigMap posture, same as
    the evidence key. Inside a group plan, the keys its batch read when
    the plan began (:func:`_snapshot_keys`), with no ``stat``."""
    path = os.environ.get("TPU_CC_IDENTITY_JWKS_FILE", "")
    if not path:
        return None
    keys = _snapshot_keys(path)
    if keys is not None:
        return keys
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        return None
    hit = _jwks_cache.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    try:
        keys = load_jwks(path)
        if not keys:
            # present-but-unusable (EC-only keys, wrong document): the
            # operator believes offline verification is on — say once
            # per file version that the blind spot is still open
            log.warning(
                "JWKS file %s contains no usable RSA keys; RS256 "
                "tokens will degrade to 'unverifiable'", path,
            )
    except Exception:
        log.warning("cannot parse JWKS file %s", path, exc_info=True)
        keys = None
    # cache failures too (keyed on mtime): a broken file must not be
    # re-parsed and re-warned for every node of every fleet scan
    _jwks_cache[path] = (mtime, keys)
    return keys


#: the group plan's batch of RS256 verdicts (``rs256.Rs256Batch``): set by
#: ``Rollout.run`` around one group plan's evidence checks, None elsewhere
rs256_batch: ContextVar = ContextVar("rs256_batch", default=None)


def _snapshot_keys(path: str) -> Optional[dict]:
    """The keys ({kid: (n, e)}) the group plan's batch read from the
    JWKS at ``path`` when the plan began, counted on the batch; None
    outside a group plan and where that read gave no usable keys (the
    caller then reads the file as it does elsewhere)."""
    batch = rs256_batch.get()
    keys = batch.jwks.get(path) if batch is not None else None
    if keys is not None:
        batch.snapshot_hits += 1
    return keys


def _rsa_pkcs1_sha256_verify(n: int, e: int, signing_input: bytes,
                             sig: bytes) -> bool:
    """RSASSA-PKCS1-v1_5 / SHA-256 verification from the public
    numbers, pure stdlib: s^e mod n must equal the EMSA-PKCS1-v1_5
    encoding of the hash. That encoding is fully deterministic, so
    verification is an exact compare — no parsing of attacker-shaped
    ASN.1 (the class of bug behind historic BER-laxity forgeries).
    Inside a group plan the verdict comes from its batch (kernel K6)
    when the batch holds these exact inputs."""
    digest = hashlib.sha256(signing_input).digest()
    batch = rs256_batch.get()
    if batch is not None:
        ok = batch.verdict(n, e, digest, sig)
        if ok is not None:
            return ok
    k = (n.bit_length() + 7) // 8
    if len(sig) != k:
        return False
    m = pow(int.from_bytes(sig, "big"), e, n)
    em = m.to_bytes(k, "big")
    pad_len = k - 3 - len(_SHA256_DIGEST_INFO) - len(digest)
    if pad_len < 8:
        return False
    expected = (b"\x00\x01" + b"\xff" * pad_len + b"\x00"
                + _SHA256_DIGEST_INFO + digest)
    return hmac_mod.compare_digest(em, expected)


# ---------------------------------------------------------- verifying
def token_claims(token: str) -> Tuple[dict, dict]:
    """Parse (header, payload) WITHOUT verifying — callers must treat
    the claims as hostile until verify_token said otherwise."""
    parts = token.split(".")
    if len(parts) != 3:
        raise ValueError("not a three-part JWT")
    header = json.loads(_b64url_decode(parts[0]))
    payload = json.loads(_b64url_decode(parts[1]))
    if not isinstance(header, dict) or not isinstance(payload, dict):
        raise ValueError("JWT parts are not objects")
    return header, payload


def _signed_parts(token: str) -> Tuple[bytes, bytes]:
    """The signing input and the signature of a three-part JWT, as every
    RS256 check reads them; raises where the signature does not
    decode."""
    signing_input, _, sig_b64 = token.rpartition(".")
    return signing_input.encode(), _b64url_decode(sig_b64)


def claimed_node(payload: dict) -> Optional[str]:
    """The node the token speaks for. GCE full-format tokens carry the
    instance name (== GKE node name) under google.compute_engine."""
    gce = (payload.get("google") or {}).get("compute_engine") or {}
    name = gce.get("instance_name")
    return name if isinstance(name, str) else None


def verify_token(token: str, *, node_name: str,
                 audience: Optional[str] = None,
                 key: Optional[bytes] = None,
                 jwks: Optional[dict] = None,
                 now: Optional[float] = None) -> Tuple[str, str]:
    """Judge an identity token. Returns (verdict, detail):

    - ``'ok'``: claims check out AND the signature verified (HS256
      with the configured key).
    - ``'unverifiable'``: claims check out but the signature cannot be
      judged here (RS256 without Google's JWKS, or HS256 without the
      key) — same tolerated-blind-spot posture as evidence 'no_key'.
    - ``'mismatch'``: the token speaks for a different node or a
      different audience — replay, the thing node binding exists for.
    - ``'expired'``: claims check out but the token is past its exp —
      STALE evidence (an idle node whose agent stopped refreshing),
      not forgery; verifiers class it with 'missing', not 'mismatch',
      so an idle fleet doesn't read as under attack.
    - ``'invalid'``: malformed or a bad signature.
    """
    audience = audience or identity_audience()
    if key is None:
        key = identity_key()
    now = time.time() if now is None else now
    try:
        header, payload = token_claims(token)
    except Exception as e:
        return "invalid", f"malformed token: {e}"
    # binding checks FIRST: an expired token for the wrong node is a
    # replay, and forensic findings outrank staleness
    if payload.get("aud") != audience:
        return "mismatch", (
            f"audience {payload.get('aud')!r}, expected {audience!r}"
        )
    bound = claimed_node(payload)
    if bound != node_name:
        return "mismatch", (
            f"token speaks for {bound!r}, not {node_name!r}"
        )
    exp = payload.get("exp")
    expired = isinstance(exp, (int, float)) and now > exp
    alg = header.get("alg")
    if alg == "HS256":
        if not key:
            return ("expired", "token expired") if expired else (
                "unverifiable", "HS256 token but no identity key here")
        signing_input, sig = token.rsplit(".", 1)
        expect = hmac_mod.new(
            key, signing_input.encode(), hashlib.sha256
        ).digest()
        if not hmac_mod.compare_digest(_b64url(expect), sig):
            return "invalid", "bad HS256 signature"
        return ("expired", "token expired") if expired else ("ok", "ok")
    if alg == "RS256":
        # Google-signed. With a provisioned JWKS
        # (TPU_CC_IDENTITY_JWKS_FILE, or the jwks param) the signature
        # is FULLY verified offline; without one, the claims are still
        # bound-checked above and the signature verdict degrades
        # honestly instead of rejecting every real GCE token
        if jwks is None:
            jwks = _jwks_for_env()
        if jwks:
            kid = header.get("kid")
            pub = jwks.get(kid)
            if pub is None:
                # NOT forgery: Google rotates its signing keys on the
                # order of days, and the provisioned ConfigMap can lag.
                # A stale verifier artifact must read as a blind spot
                # (same staleness-is-not-forgery posture as 'expired'),
                # never flag the whole fleet as under attack
                return ("expired", "token expired") if expired else (
                    "unverifiable",
                    f"no JWKS key for kid {kid!r} — JWKS ConfigMap "
                    "lagging a key rotation? refresh it",
                )
            try:
                signing_input, sig = _signed_parts(token)
            except Exception as e:
                return "invalid", f"malformed RS256 signature: {e}"
            if not _rsa_pkcs1_sha256_verify(
                    pub[0], pub[1], signing_input, sig):
                return "invalid", "bad RS256 signature"
            return ("expired", "token expired") if expired else (
                "ok", "ok")
        return ("expired", "token expired") if expired else (
            "unverifiable", "RS256 signature needs Google JWKS")
    return "invalid", f"unsupported alg {alg!r}"


def judge_identity(doc: dict, node_name: str, *,
                   key: Optional[bytes] = None,
                   audience: Optional[str] = None,
                   now: Optional[float] = None) -> Tuple[str, str]:
    """Judge the ``identity`` field of an evidence document. Returns
    (verdict, detail) with verdicts ``ok | missing | expired |
    mismatch | invalid | unverifiable``. The evidence digest already
    covers the field, so a verifier that accepted the digest knows the
    identity it judges is the one the agent attached."""
    ident = doc.get("identity")
    if ident is None:
        return "missing", "no identity attached"
    if not isinstance(ident, dict) or not isinstance(
            ident.get("token"), str):
        return "invalid", "identity field malformed"
    return verify_token(
        ident["token"], node_name=node_name,
        audience=audience, key=key, now=now,
    )


def require_identity() -> bool:
    return os.environ.get(
        "TPU_CC_REQUIRE_IDENTITY", ""
    ).lower() in ("1", "true", "yes")
