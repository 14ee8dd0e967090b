"""K6, batched RS256 (RSASSA-PKCS1-v1_5 / SHA-256) verification.

Replaces no TPU kernel: the JAX package verifies each RS256 token on the
host, one at a time, with Python's ``pow``
(``tpu_cc_manager/identity.py::_rsa_pkcs1_sha256_verify``). The CUDA kernel
is ``csrc/rsa_verify.cu``: one launch verifies a batch of signatures, each
``sig ^ e mod n`` compared exactly with the EMSA-PKCS1-v1_5 encoding of its
SHA-256 digest, one byte out per signature (1 verified, 0 not). The group
plan's evidence check sends it every identity and attestation signature of
a preflight (:mod:`tpu_cc_manager_torch.rs256`).

It takes 2048-bit keys: a 256-byte odd modulus and an odd exponent below
2^32 (:func:`takes`). Numbers travel as little-endian 32-bit limbs in
int32 tensors: ``sig`` [B, 64], ``key_index`` [B], ``digest`` [B, 8] (the
digest's bytes reversed), and the key table of :func:`key_table`: ``n``
[K, 64], ``r2`` = R^2 mod n [K, 64] (R = 2^2048), ``n0inv`` = -n^-1 mod
2^32 [K] and ``e`` [K]. A signature must be below its key's n. A key
index outside [0, K) verifies nothing.

Bound on an H100: 32-bit integer multiplies, about 156 k multiply-adds a
signature under e = 65537 (19 Montgomery products of 2 x 64 x 64). Times
on the card: PERF.md.

:func:`rsa_verify` launches the kernel for CUDA tensors and runs the plain
version (:func:`rsa_verify_reference`, Python's ``pow``) for CPU tensors;
any other device raises. A kernel that fails to build or to launch raises
too: nothing falls back to the plain version.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from tpu_cc_manager_torch.kernels import LAUNCHES, _build

#: limbs of a number, and bytes of a modulus and a signature
LIMBS = 64
MODULUS_BYTES = 256
#: limbs of a SHA-256 digest
DIGEST_LIMBS = 8
_R = 1 << (32 * LIMBS)
#: SHA-256 DigestInfo prefix for EMSA-PKCS1-v1_5 (RFC 8017 §9.2)
_SHA256_DIGEST_INFO = bytes.fromhex("3031300d060960864801650304020105000420")


def takes(n: int, e: int) -> bool:
    """Whether K6 takes the key ``(n, e)``: a 256-byte odd modulus and an
    odd exponent below 2^32."""
    return ((n.bit_length() + 7) // 8 == MODULUS_BYTES and n & 1 == 1
            and 0 < e < 2 ** 32 and e & 1 == 1)


def limbs(values: Sequence[bytes], width: int) -> np.ndarray:
    """Big-endian byte strings of ``4 * width`` bytes each as an int32
    ``[len(values), width]`` array of little-endian 32-bit limbs."""
    buf = bytearray(b"".join(v[::-1] for v in values))
    if len(buf) != 4 * width * len(values):
        raise ValueError(f"limbs: every value must be {4 * width} bytes")
    return np.frombuffer(buf, dtype="<u4").view(np.int32).reshape(
        len(values), width)


def key_table(keys: Sequence[Tuple[int, int]], device
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """``(n, r2, n0inv, e)`` on ``device`` for the keys ``(n, e)``, in
    order. Raises for a key K6 does not take."""
    bad = [i for i, (n, e) in enumerate(keys) if not takes(n, e)]
    if bad or not keys:
        raise ValueError(
            "key_table: K6 takes 256-byte odd moduli and odd exponents "
            f"below 2^32; refused key(s) {bad[:5]} of {len(keys)}")
    n_rows = limbs([n.to_bytes(MODULUS_BYTES, "big") for n, _ in keys], LIMBS)
    r2_rows = limbs([(_R * _R % n).to_bytes(MODULUS_BYTES, "big")
                     for n, _ in keys], LIMBS)
    n0inv = np.array([-pow(n, -1, 2 ** 32) % 2 ** 32 for n, _ in keys],
                     dtype=np.uint32).view(np.int32)
    e = np.array([e for _, e in keys], dtype=np.uint32).view(np.int32)
    return tuple(torch.from_numpy(a).to(device)
                 for a in (n_rows, r2_rows, n0inv, e))


def _check(sig, key_index, digest, n, r2, n0inv, e) -> None:
    shapes = {"sig": (sig, 2, LIMBS), "key_index": (key_index, 1, None),
              "digest": (digest, 2, DIGEST_LIMBS), "n": (n, 2, LIMBS),
              "r2": (r2, 2, LIMBS), "n0inv": (n0inv, 1, None),
              "e": (e, 1, None)}
    for name, (t, dim, width) in shapes.items():
        if (t.dtype != torch.int32 or t.dim() != dim
                or (width is not None and t.shape[1] != width)
                or not t.is_contiguous()):
            want = f"[*, {width}]" if width else "[*]"
            raise ValueError(
                f"rsa_verify: {name} must be a contiguous int32 {want} "
                f"tensor, got {t.dtype} {tuple(t.shape)}")
        if t.device != sig.device:
            raise ValueError(
                f"rsa_verify: {name} is on {t.device}, sig on {sig.device}")
    b, k = sig.shape[0], n.shape[0]
    if key_index.shape[0] != b or digest.shape[0] != b:
        raise ValueError(
            f"rsa_verify: {b} signatures, {key_index.shape[0]} key indices, "
            f"{digest.shape[0]} digests")
    if k < 1 or r2.shape[0] != k or n0inv.shape[0] != k or e.shape[0] != k:
        raise ValueError(
            f"rsa_verify: the key table's n, r2, n0inv and e have "
            f"{k}, {r2.shape[0]}, {n0inv.shape[0]} and {e.shape[0]} rows; "
            "they must agree and be at least 1")


def rsa_verify(sig: torch.Tensor, key_index: torch.Tensor,
               digest: torch.Tensor, n: torch.Tensor, r2: torch.Tensor,
               n0inv: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """One uint8 a signature: 1 where ``sig ^ e mod n`` under its key is
    the EMSA-PKCS1-v1_5 encoding of its SHA-256 digest, else 0. Launches
    K6 for CUDA tensors, runs :func:`rsa_verify_reference` for CPU
    tensors."""
    _check(sig, key_index, digest, n, r2, n0inv, e)
    if sig.device.type == "cpu":
        return rsa_verify_reference(sig, key_index, digest, n, r2, n0inv, e)
    if sig.device.type != "cuda":
        raise ValueError(f"rsa_verify: no kernel for {sig.device}")
    ok = torch.empty(sig.shape[0], dtype=torch.uint8, device=sig.device)
    lib = _build.library()
    with torch.cuda.device(sig.device):
        rc = lib.tcc_rsa_verify(
            sig.data_ptr(), key_index.data_ptr(), digest.data_ptr(),
            n.data_ptr(), r2.data_ptr(), n0inv.data_ptr(), e.data_ptr(),
            sig.shape[0], n.shape[0], ok.data_ptr(),
            torch.cuda.current_stream(sig.device).cuda_stream)
    _build.check(rc, "rsa_verify launch")
    LAUNCHES["rsa_verify"] += 1
    return ok


def _ints(rows: torch.Tensor) -> list:
    a = rows.cpu().numpy().view("<u4")
    return [int.from_bytes(r.tobytes(), "little") for r in a]


def rsa_verify_reference(sig: torch.Tensor, key_index: torch.Tensor,
                         digest: torch.Tensor, n: torch.Tensor,
                         r2: torch.Tensor, n0inv: torch.Tensor,
                         e: torch.Tensor) -> torch.Tensor:
    """The plain version of K6: Python's ``pow`` and the encoding built
    as bytes, on any device (``r2`` and ``n0inv`` go unused)."""
    del r2, n0inv
    mods = _ints(n)
    exps = [int(x) for x in e.cpu().numpy().view("<u4")]
    out = []
    for s, i, d in zip(_ints(sig), key_index.cpu().tolist(),
                       _ints(digest)):
        if not 0 <= i < len(mods) or exps[i] == 0:
            out.append(0)
            continue
        m = pow(s, exps[i], mods[i])
        em = (b"\x00\x01" + b"\xff" * (MODULUS_BYTES - 3 - 19 - 32) + b"\x00"
              + _SHA256_DIGEST_INFO + d.to_bytes(32, "big"))
        out.append(int(m.to_bytes(MODULUS_BYTES, "big") == em))
    return torch.tensor(out, dtype=torch.uint8, device=sig.device)
