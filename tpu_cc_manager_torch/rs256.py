"""The group plan's RS256 batch: every identity and attestation signature
a preflight's evidence check will verify, verified by one launch of K6
(:mod:`tpu_cc_manager_torch.kernels.rsa_verify`) before the check runs.

``Rollout.run`` calls :func:`prepare` inside its ``groups`` span, before the
group loop, with the evidence annotations of the members of the groups that
will reach the evidence check. When a JWKS is provisioned (the identity
JWKS through :func:`identity._jwks_for_env`, the attestation JWKS read once
from ``TPU_CC_ATTESTATION_JWKS_FILE``), it parses each document once, takes
from each RS256 token its key by ``kid``, the SHA-256 of its signing input
and its signature, decoded as the judges decode them
(:func:`rs256_inputs`, which raises on no token), and verifies
what K6 takes in one launch on the planner's device. The rollout then sets
:data:`identity.rs256_batch` around its loop;
``identity._rsa_pkcs1_sha256_verify`` answers from the batch when its exact
inputs ``(n, e, digest, sig)`` are there and runs the host ``pow``
otherwise (another key size, a signature not of the key's length or not
below n, a key rotated since the batch was made). No verdict outlives the
group plan, and no other caller sees one.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from tpu_cc_manager_torch.attest import ConfidentialSpaceAttestor
from tpu_cc_manager_torch.identity import (
    _b64url_decode, _jwks_for_env, _signed_parts, load_jwks,
)
from tpu_cc_manager_torch.kernels import rsa_verify as K6

log = logging.getLogger("tpu-cc-manager-torch.rs256")

#: a document's parse as the pre-pass made it: (annotation, document)
Parsed = Tuple[str, dict]


class Rs256Batch:
    """One group plan's RS256 signatures and, after :meth:`run`, K6's
    verdict for each. ``batched`` counts the verifications answered from
    the batch, ``host`` those left to the host ``pow``; ``seconds`` is the
    time :func:`prepare` took."""

    def __init__(self) -> None:
        self._index: Dict[Tuple[int, int, bytes, bytes], int] = {}
        self._keys: Dict[Tuple[int, int], int] = {}
        self._sigs: List[bytes] = []
        self._digests: List[bytes] = []
        self._key_index: List[int] = []
        self._ok = None
        self.batched = 0
        self.host = 0
        self.seconds = 0.0

    def add(self, n: int, e: int, digest: bytes, sig: bytes) -> None:
        """Queue one verification, if K6 takes it: a 2048-bit key, a
        signature of 256 bytes below n."""
        key = (n, e, digest, sig)
        if key in self._index or len(sig) != K6.MODULUS_BYTES \
                or int.from_bytes(sig, "big") >= n:
            return
        k = self._keys.get((n, e))
        if k is None:
            if not K6.takes(n, e):
                return
            k = self._keys[(n, e)] = len(self._keys)
        self._index[key] = len(self._sigs)
        self._key_index.append(k)
        self._sigs.append(sig)
        self._digests.append(digest)

    def run(self) -> None:
        """Verify every queued signature in one launch on the planner's
        device (the plain version on the CPU) and keep the verdicts on
        the host."""
        if not self._sigs:
            return
        import torch

        from tpu_cc_manager_torch.kernels import _build
        from tpu_cc_manager_torch.plan import _DISPATCH_LOCK, _planner_device

        device = _planner_device()
        if device.type == "cuda":
            _build.library()  # loaded (or built) outside the dispatch lock
        sig = torch.from_numpy(K6.limbs(self._sigs, K6.LIMBS)).to(device)
        digest = torch.from_numpy(
            K6.limbs(self._digests, K6.DIGEST_LIMBS)).to(device)
        key_index = torch.tensor(self._key_index, dtype=torch.int32,
                                 device=device)
        table = K6.key_table(list(self._keys), device)
        with _DISPATCH_LOCK:
            # ccaudit: allow-blocking-under-lock(the kernel library is loaded above, outside the lock: this only launches K6 and reads its bytes back)
            self._ok = K6.rsa_verify(sig, key_index, digest,
                                     *table).cpu().numpy()

    def verdict(self, n: int, e: int, digest: bytes, sig: bytes
                ) -> Optional[bool]:
        """K6's verdict for these exact inputs, or None (counted as a
        host verification) where the batch has none."""
        i = self._index.get((n, e, digest, sig)) \
            if self._ok is not None else None
        if i is None:
            self.host += 1
            return None
        self.batched += 1
        return bool(self._ok[i])


def rs256_inputs(token: object, keys: dict, alg: Optional[str] = "RS256",
                 headers: Optional[dict] = None
                 ) -> Optional[Tuple[int, int, bytes, bytes]]:
    """``(n, e, signing input, signature)`` of the RS256 check a judge
    makes of ``token`` under ``keys`` ({kid: (n, e)}), decoded as the
    judges decode it: the header's ``kid`` names the key where its
    ``alg`` is ``alg`` (any, for None), and
    :func:`identity._signed_parts` reads the rest. None where the judge checks no signature under ``keys``.
    Raises nothing: a token the judges reject as undecodable is None
    here, and one they reject for its payload, which is left to them,
    is a check they never ask for. ``headers`` keeps each header
    segment's key across calls (a fleet's tokens share a few)."""
    try:
        header_b64, _, _ = token.split(".")
        pub = headers.get(header_b64, ()) if headers is not None else ()
        if pub == ():
            header = json.loads(_b64url_decode(header_b64))
            pub = keys.get(header.get("kid")) if (
                alg is None or header.get("alg") == alg) else None
            if headers is not None:
                headers[header_b64] = pub
        if pub is None:
            return None
        signing_input, sig = _signed_parts(token)
        return pub[0], pub[1], signing_input, sig
    except Exception:
        # the judge meets the same token and says what is wrong with it
        log.debug("RS256 token left to the judges", exc_info=True)
        return None


def _queue(batch: Rs256Batch, token: object, keys: dict,
           alg: Optional[str], headers: Dict[str, object]) -> None:
    """Queue ``token``'s check under ``keys``, where a judge makes one
    (:func:`rs256_inputs`, which raises nothing)."""
    inputs = rs256_inputs(token, keys, alg, headers)
    if inputs is not None:
        n, e, signing_input, sig = inputs
        batch.add(n, e, hashlib.sha256(signing_input).digest(), sig)


def _attestation_keys() -> Optional[dict]:
    """The attestation JWKS, read once, or None where none is
    provisioned or it cannot be read (the judge then says so)."""
    path = os.environ.get("TPU_CC_ATTESTATION_JWKS_FILE", "")
    if not path:
        return None
    try:
        return load_jwks(path) or None
    except Exception:  # ccaudit: allow-swallow(the judge reads the same file and says why it cannot)
        return None


def prepare(annotations: Iterable[Tuple[str, Optional[str]]]
            ) -> Tuple[Optional[Rs256Batch], Dict[str, Parsed]]:
    """The batch for the evidence annotations ``(node, annotation or
    None)`` the group plan will judge, verified, and each document as
    parsed; ``(None, {})`` when no JWKS is provisioned, so that nothing
    in the input can reach an RS256 check."""
    t0 = time.monotonic()
    id_keys = _jwks_for_env()
    att_keys = _attestation_keys()
    if not id_keys and not att_keys:
        return None, {}
    batch = Rs256Batch()
    parsed: Dict[str, Parsed] = {}
    id_headers: Dict[str, object] = {}
    att_headers: Dict[str, object] = {}
    provider = ConfidentialSpaceAttestor.provider
    for node, raw in annotations:
        if not raw:
            continue
        try:
            doc = json.loads(raw)
        except Exception:  # ccaudit: allow-swallow(the evidence check parses it again and judges it malformed)
            continue
        if not isinstance(doc, dict):
            continue
        parsed[node] = (raw, doc)
        ident = doc.get("identity")
        if id_keys and isinstance(ident, dict):
            _queue(batch, ident.get("token"), id_keys, "RS256", id_headers)
        att = doc.get("attestation")
        if att_keys and isinstance(att, dict) \
                and att.get("provider") == provider:
            _queue(batch, att.get("token"), att_keys, None, att_headers)
    batch.run()
    batch.seconds = time.monotonic() - t0
    return batch, parsed
