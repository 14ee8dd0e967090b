"""The attested fleet's keys and tokens, made from the seed: RSA keys and
their JWKS documents, and every node's evidence re-signed with a
platform-identity token and an attestation token in it.

A Confidential VM's agent builds its evidence in this order (the port's
``evidence.build_evidence``): the body, then the instance-identity token
(``doc["identity"]``), then the attestation token, whose ``eat_nonce`` is
the SHA-256 of the canonical document without ``digest`` and
``attestation``, then the pool key's HMAC digest over everything. This
module re-signs each document :func:`portbench.fleetgen.make_fleet` made
in that order, and plants the configuration's ``attested`` shares on
nodes whose labels and evidence are otherwise sound, so each share
reaches the token checks.

Keys are multi-prime RSA (``rsa_primes`` primes of equal size, a modulus
of exactly ``rsa_bits`` bits, e = 65537): signing by the Chinese
remainder theorem over small primes is several times faster than over
two, and a verifier's work is that of any key of the modulus' size.
Signatures are spread over worker processes for a whole fleet.

Nothing here imports the program: the document's layout and the token
claims are the platform's formats, written out.
"""

from __future__ import annotations

import base64
import calendar
import contextlib
import hashlib
import hmac
import json
import multiprocessing
import os
import random
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from portbench import fleetgen as G

#: the attested shares, in the order they are placed
KINDS = ("idle_agent", "identity_replay", "stale_nonce",
         "attestation_missing", "kid_unknown", "signature_flipped")

#: SHA-256 DigestInfo prefix of EMSA-PKCS1-v1_5 (RFC 8017 section 9.2)
_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")

#: below this many signatures a fleet is signed in this process
_POOL_MIN = 512
#: signatures a worker makes per task
_CHUNK = 128


def b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def b64url_decode(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def _canonical(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


def attestation_nonce(doc: dict) -> str:
    """What an attestation token for ``doc`` commits to."""
    return hashlib.sha256(_canonical(
        {k: v for k, v in doc.items()
         if k not in ("digest", "attestation")})).hexdigest()


# ------------------------------------------------------------- RSA keys
class Key(NamedTuple):
    kid: str
    n: int
    e: int
    primes: Tuple[int, ...]
    #: d mod (p - 1) for each prime
    exps: Tuple[int, ...]
    #: Garner's coefficients: (p_0 ... p_{i-1})^-1 mod p_i, for i >= 1
    coefs: Tuple[int, ...]


def _probable_prime(n: int, rnd: random.Random) -> bool:
    for p in (3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47):
        if n % p == 0:
            return n == p
    d, s = n - 1, 0
    while d % 2 == 0:
        d //= 2
        s += 1
    for _ in range(24):
        x = pow(rnd.randrange(2, n - 1), d, n)
        if x in (1, n - 1):
            continue
        for _ in range(s - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def _root_ceil(x: int, k: int) -> int:
    """The least integer r with r ** k >= x."""
    lo, hi = 1, 1 << (x.bit_length() // k + 1)
    while lo < hi:
        mid = (lo + hi) // 2
        if mid ** k >= x:
            hi = mid
        else:
            lo = mid + 1
    return lo


def make_key(label: str, kid: str, bits: int, primes: int,
             e: int = 65537) -> Key:
    """A ``bits``-bit key of ``primes`` distinct primes of ``bits /
    primes`` bits each, drawn from ``label``: each prime lies in
    ``[ceil(2 ** ((bits - 1) / primes)), 2 ** (bits / primes))``, so the
    modulus has exactly ``bits`` bits."""
    if bits % primes:
        raise ValueError(f"{bits} bits do not split into {primes} primes")
    rnd = random.Random(f"portbench-rsa-{label}")
    lo, hi = _root_ceil(1 << (bits - 1), primes), 1 << (bits // primes)
    ps: List[int] = []
    while len(ps) < primes:
        c = rnd.randrange(lo, hi) | 1
        if c not in ps and (c - 1) % e and _probable_prime(c, rnd):
            ps.append(c)
    n = 1
    for p in ps:
        n *= p
    assert n.bit_length() == bits
    coefs, m = [], ps[0]
    for p in ps[1:]:
        coefs.append(pow(m, -1, p))
        m *= p
    return Key(kid, n, e, tuple(ps), tuple(pow(e, -1, p - 1) for p in ps),
               tuple(coefs))


def jwks(keys: Sequence[Key]) -> dict:
    """The JWKS document publishing ``keys``."""
    return {"keys": [
        {"kty": "RSA", "alg": "RS256", "use": "sig", "kid": k.kid,
         "n": b64url(k.n.to_bytes((k.n.bit_length() + 7) // 8, "big")),
         "e": b64url(k.e.to_bytes((k.e.bit_length() + 7) // 8, "big"))}
        for k in keys]}


def sign(key: Key, signing_input: bytes) -> bytes:
    """RSASSA-PKCS1-v1_5 with SHA-256, by CRT over the key's primes."""
    k = (key.n.bit_length() + 7) // 8
    digest = hashlib.sha256(signing_input).digest()
    em = (b"\x00\x01" + b"\xff" * (k - 3 - len(_DIGEST_INFO) - len(digest))
          + b"\x00" + _DIGEST_INFO + digest)
    m = int.from_bytes(em, "big")
    x, mod = pow(m, key.exps[0], key.primes[0]), key.primes[0]
    for p, d, c in zip(key.primes[1:], key.exps[1:], key.coefs):
        x += mod * ((pow(m, d, p) - x) * c % p)
        mod *= p
    return x.to_bytes(k, "big")


def _sign_chunk(args: Tuple[Sequence[Key], List[Tuple[int, bytes]]]
                ) -> List[bytes]:
    keys, chunk = args
    return [sign(keys[i], s) for i, s in chunk]


def sign_all(keys: Sequence[Key], work: List[Tuple[int, bytes]],
             pool=None) -> List[bytes]:
    """Each ``(key index, signing input)``'s signature, in order, on
    ``pool``'s workers where one is given."""
    if pool is None:
        return _sign_chunk((keys, work))
    chunks = [(keys, work[i:i + _CHUNK]) for i in range(0, len(work), _CHUNK)]
    return [s for part in pool.map(_sign_chunk, chunks) for s in part]


def signing_pool(signatures: int, workers: Optional[int] = None):
    """Worker processes for ``signatures`` signatures, started afresh
    (``spawn``: the calling process may hold threads, which a fork does
    not copy); none for a small batch."""
    workers = workers or min(8, os.cpu_count() or 1)
    if signatures < _POOL_MIN or workers < 2:
        return contextlib.nullcontext()
    return multiprocessing.get_context("spawn").Pool(workers)


# --------------------------------------------------------------- tokens
def _jwt_input(header: dict, payload: dict) -> str:
    return (b64url(json.dumps(header, separators=(",", ":")).encode()) + "."
            + b64url(json.dumps(payload, separators=(",", ":")).encode()))


def identity_claims(name: str, i: int, iat: int, cfg: dict) -> dict:
    """A GCE instance-identity token's claims, full format."""
    t = cfg["tokens"]
    sa = str(104_000_000_000_000_000_000 + i)
    return {
        "aud": t["audience"], "azp": sa,
        "email": f"{t['project_number']}-compute@developer."
                 "gserviceaccount.com",
        "email_verified": True, "exp": iat + t["ttl_s"],
        "google": {"compute_engine": {
            "instance_creation_timestamp": iat - 86_400,
            "instance_id": str(7_000_000_000_000_000_000 + i),
            "instance_name": name, "project_id": t["project_id"],
            "project_number": t["project_number"], "zone": cfg["zone"]}},
        "iat": iat, "iss": t["identity_iss"], "sub": sa,
    }


def attestation_claims(name: str, i: int, iat: int, nonce: str,
                       cfg: dict) -> dict:
    """A Google Cloud attestation token's claims, Confidential Space's
    OIDC shape, committed to ``nonce``."""
    t = cfg["tokens"]
    return {
        "aud": t["audience"], "iss": t["attestation_iss"],
        "sub": f"https://www.googleapis.com/compute/v1/projects/"
               f"{t['project_id']}/zones/{cfg['zone']}/instances/{name}",
        "iat": iat, "nbf": iat, "exp": iat + t["ttl_s"],
        "eat_nonce": [nonce], "eat_profile": t["eat_profile"],
        "hwmodel": t["hwmodel"], "secboot": True,
        "dbgstat": "disabled-since-boot", "swname": "CONFIDENTIAL_SPACE",
        "submods": {"gce": {
            "zone": cfg["zone"], "project_id": t["project_id"],
            "project_number": t["project_number"], "instance_name": name,
            "instance_id": str(7_000_000_000_000_000_000 + i)}},
    }


class Keys(NamedTuple):
    """The seed's keys: ``identity`` and ``attestation`` each hold the
    JWKS's two keys and, last, the key a lagging JWKS lacks."""
    identity: Tuple[Key, Key, Key]
    attestation: Tuple[Key, Key, Key]


def make_keys(seed: int, cfg: dict) -> Keys:
    t = cfg["tokens"]
    out = []
    for axis in ("identity", "attestation"):
        out.append(tuple(
            make_key(f"{seed}-{axis}-{j}",
                     hashlib.sha1(f"{seed}-{axis}-{j}".encode()).hexdigest(),
                     t["rsa_bits"], t["rsa_primes"])
            for j in (1, 2, 3)))
    return Keys(*out)


class Attested(NamedTuple):
    """What :func:`attest_fleet` did: each share's node indices, and the
    earliest expiry of a token meant valid and the latest of a token
    meant expired (epoch seconds)."""
    kinds: Dict[str, List[int]]
    valid_exp_min: int
    expired_exp_max: Optional[int]


def _stamp_s(stamp: str) -> int:
    return calendar.timegm(time.strptime(stamp, "%Y-%m-%dT%H:%M:%SZ"))


def attest_fleet(nodes: List[dict], cfg: dict, seed: int, hmac_key: bytes,
                 now: float, keys: Keys,
                 workers: Optional[int] = None) -> Attested:
    """Re-sign every node's evidence in place with both tokens and plant
    the configuration's ``attested`` shares (exact counts) on distinct
    nodes whose labels are converged and whose evidence is signed and
    honest. The rotation-lag ``kid`` and the flipped signature byte
    fall on the identity token of a share's even-numbered nodes and on
    the attestation token of its odd-numbered ones."""
    att_cfg = cfg["attested"]
    rng = np.random.default_rng([seed, 3])
    docs: Dict[int, dict] = {}
    tampered = set()
    for i, node in enumerate(nodes):
        raw = node["metadata"]["annotations"].get(G.EVIDENCE_ANNOTATION)
        if raw is None:
            continue
        doc = json.loads(raw)
        body = {k: v for k, v in doc.items() if k != "digest"}
        want = "hmac-sha256:" + hmac.new(hmac_key, _canonical(body),
                                         hashlib.sha256).hexdigest()
        if want != doc["digest"]:
            tampered.add(i)
        docs[i] = body
    labels = [n["metadata"]["labels"] for n in nodes]
    eligible = [i for i in sorted(docs) if i not in tampered
                and labels[i][G.CC_MODE_LABEL] == "on"
                and labels[i][G.CC_MODE_STATE_LABEL] == "on"
                and all(d["cc"] == "on" for d in docs[i]["devices"])]
    order = [eligible[j] for j in rng.permutation(len(eligible))]
    kinds: Dict[str, List[int]] = {}
    at = 0
    for kind in KINDS:
        k = int(att_cfg[kind])
        kinds[kind] = sorted(order[at:at + k])
        at += k
    if at > len(order):
        raise ValueError(f"{at} attested nodes asked, {len(order)} eligible")
    kind_of = {i: kind for kind, idx in kinds.items() for i in idx}
    lo_age, hi_age = att_cfg["idle_age_s"]
    for i in kinds["idle_agent"]:
        docs[i]["timestamp"] = G.stamp(now - int(rng.integers(lo_age,
                                                              hi_age + 1)))
    rank = {i: j for idx in kinds.values() for j, i in enumerate(idx)}

    def on_identity(i: int) -> bool:
        return rank[i] % 2 == 0

    def key_index(i: int, axis_identity: bool) -> int:
        lag = kind_of.get(i) == "kid_unknown" and \
            on_identity(i) == axis_identity
        return 2 if lag else i % 2

    # the identity tokens, then each document's nonce over them, then
    # the attestation tokens
    names = [n["metadata"]["name"] for n in nodes]
    iat = {i: _stamp_s(d["timestamp"]) for i, d in docs.items()}
    idx = sorted(docs)
    with signing_pool(2 * len(idx), workers) as pool:
        inputs = []
        for i in idx:
            k = keys.identity[key_index(i, True)]
            inputs.append(_jwt_input(
                {"alg": "RS256", "kid": k.kid, "typ": "JWT"},
                identity_claims(names[i], i, iat[i], cfg)))
        sigs = sign_all(keys.identity, [(key_index(i, True), s.encode())
                                        for i, s in zip(idx, inputs)], pool)
        tokens = {i: s + "." + b64url(g)
                  for i, s, g in zip(idx, inputs, sigs)}
        for i in idx:
            tok = tokens[i]
            if kind_of.get(i) == "identity_replay":
                # the token a node nearby got, speaking for that node
                tok = tokens[eligible[(eligible.index(i) + 1) % len(eligible)]]
            elif kind_of.get(i) == "signature_flipped" and on_identity(i):
                tok = flip_signature_byte(tok, rng)
            docs[i]["identity"] = {"provider": "gce", "token": tok}
        inputs, nonces = [], {}
        for i in idx:
            if kind_of.get(i) == "attestation_missing":
                continue
            nonce = attestation_nonce(docs[i])
            if kind_of.get(i) == "stale_nonce":
                # the quote of the node's previous document, published one
                # refresh before this one
                older = dict(docs[i], timestamp=G.stamp(iat[i] - 300))
                nonce = attestation_nonce(older)
            nonces[i] = nonce
            k = keys.attestation[key_index(i, False)]
            inputs.append((i, _jwt_input(
                {"alg": "RS256", "kid": k.kid, "typ": "JWT"},
                attestation_claims(names[i], i, iat[i], nonce, cfg))))
        sigs = sign_all(keys.attestation,
                        [(key_index(i, False), s.encode()) for i, s in inputs],
                        pool)
        for (i, s), g in zip(inputs, sigs):
            tok = s + "." + b64url(g)
            if kind_of.get(i) == "signature_flipped" and not on_identity(i):
                tok = flip_signature_byte(tok, rng)
            docs[i]["attestation"] = {"version": 1,
                                      "provider": "confidential-space",
                                      "nonce": nonces[i], "token": tok}
    for i in idx:
        doc = docs[i]
        doc["digest"] = "hmac-sha256:" + hmac.new(
            hmac_key, _canonical(doc), hashlib.sha256).hexdigest()
        if i in tampered:
            doc["timestamp"] = G.stamp(iat[i] - 1)
        nodes[i]["metadata"]["annotations"][G.EVIDENCE_ANNOTATION] = \
            json.dumps(doc)
    ttl = cfg["tokens"]["ttl_s"]
    idle = set(kinds["idle_agent"])
    return Attested(
        kinds, min(iat[i] + ttl for i in idx if i not in idle),
        max((iat[i] + ttl for i in idle), default=None))


def flip_signature_byte(token: str, rng: np.random.Generator) -> str:
    """``token`` with one byte of its signature flipped."""
    head, _, sig = token.rpartition(".")
    raw = bytearray(b64url_decode(sig))
    raw[int(rng.integers(0, len(raw)))] ^= 0xFF
    return head + "." + b64url(bytes(raw))


def write_jwks(run_dir: str, keys: Keys) -> Dict[str, str]:
    """Both JWKS files (the first two keys of each axis) under
    ``run_dir``; the environment that points the verifiers at them."""
    os.makedirs(run_dir, exist_ok=True)
    env = {}
    for axis, var in (("identity", "TPU_CC_IDENTITY_JWKS_FILE"),
                      ("attestation", "TPU_CC_ATTESTATION_JWKS_FILE")):
        path = os.path.join(run_dir, f"jwks-{axis}.json")
        with open(path, "w") as f:
            json.dump(jwks(getattr(keys, axis)[:2]), f)
        env[var] = path
    return env
