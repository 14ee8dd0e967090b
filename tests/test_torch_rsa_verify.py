"""K6, the batched RS256 verification (``kernels/rsa_verify.py``), held to
Python's ``pow``.

Every case is a signature, the signing input it claims and a key index;
the wanted byte is what ``identity._rsa_pkcs1_sha256_verify`` (the host
check, ``pow``) says of that signature under that key, and 0 for an index
outside the key table. The cases: valid signatures under four 2048-bit
keys (2 and 8 primes, e 65537 and 3), each again with one byte flipped,
against another signing input and under another key; s = 0, 1, n - 2 and
n - 1; random s below n; indices -1 and K.

- On the CPU: the plain version (``rsa_verify_reference``) on a small
  batch, the key table's numbers, and the wrapper's refusals.
- On a card (skipped without one): K6 over ~10 000 cases in one launch,
  synchronised, bit-equal to the host check, one launch counted. The
  repository's ``tests/conftest.py`` warms the JAX planner, which the
  card's machine does not have, so run it there without it::

      python -m pytest --noconftest -p no:cacheprovider tests/test_torch_rsa_verify.py
"""

import hashlib
import random

import pytest

torch = pytest.importorskip("torch")

from portbench import attestgen as A  # noqa: E402
from tpu_cc_manager_torch import identity  # noqa: E402
from tpu_cc_manager_torch.kernels import LAUNCHES  # noqa: E402
from tpu_cc_manager_torch.kernels import rsa_verify as K6  # noqa: E402

#: (primes, e) of the four keys, all 2048-bit
KEYS = ((2, 65537), (8, 65537), (8, 3), (2, 3))


@pytest.fixture(scope="module")
def keys():
    return [A.make_key(f"k6-{p}-{e}", f"k{i}", 2048, p, e)
            for i, (p, e) in enumerate(KEYS)]


def make_cases(keys, valid, seed):
    """``[(key index, signing input, signature)]``: ``valid[i]`` valid
    signatures under key i, each also flipped, misapplied and under the
    next key, plus the edge values and random s below n."""
    rnd = random.Random(seed)
    cases = []
    for i, key in enumerate(keys):
        other = keys[(i + 1) % len(keys)]
        for j in range(valid[i]):
            msg = f"k6.{seed}.{i}.{j}".encode() * rnd.randint(1, 40)
            sig = A.sign(key, msg)
            cases.append((i, msg, sig))
            cases.append((i, msg + b"!", sig))
            if int.from_bytes(sig, "big") < other.n:
                cases.append(((i + 1) % len(keys), msg, sig))
            while True:
                flipped = bytearray(sig)
                flipped[rnd.randrange(1, len(sig))] ^= rnd.randrange(1, 256)
                if int.from_bytes(flipped, "big") < key.n:
                    break
            cases.append((i, msg, bytes(flipped)))
        for s in (0, 1, key.n - 2, key.n - 1, rnd.randrange(key.n)):
            cases.append((i, b"edge", s.to_bytes(256, "big")))
    cases.append((-1, b"no key", keys[0].n.to_bytes(256, "big")))
    cases.append((len(keys), b"no key", (1).to_bytes(256, "big")))
    return cases


def launch(keys, cases, device):
    table = K6.key_table([(k.n, k.e) for k in keys], device)
    sig = torch.from_numpy(K6.limbs([c[2] for c in cases], K6.LIMBS))
    digest = torch.from_numpy(K6.limbs(
        [hashlib.sha256(c[1]).digest() for c in cases], K6.DIGEST_LIMBS))
    idx = torch.tensor([c[0] for c in cases], dtype=torch.int32)
    return K6.rsa_verify(sig.to(device), idx.to(device), digest.to(device),
                         *table)


def wanted(keys, cases):
    return [int(0 <= i < len(keys) and identity._rsa_pkcs1_sha256_verify(
        keys[i].n, keys[i].e, msg, sig)) for i, msg, sig in cases]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("K6 runs on a CUDA card; this host has none")
    return torch.device("cuda", 0)


def test_k6_equals_the_host_check_on_every_case(keys, cuda):
    cases = make_cases(keys, (150, 1000, 1000, 150), seed=6)
    assert len(cases) > 9_000
    want = wanted(keys, cases)
    assert 0 < sum(want) < len(want)
    before = LAUNCHES["rsa_verify"]
    ok = launch(keys, cases, cuda)
    torch.cuda.synchronize()
    assert LAUNCHES["rsa_verify"] == before + 1
    assert ok.dtype == torch.uint8 and ok.shape == (len(cases),)
    got = ok.cpu().tolist()
    bad = [(c[0], c[1][:20], g, w)
           for c, g, w in zip(cases, got, want) if g != w]
    assert not bad, f"{len(bad)} of {len(cases)} differ: {bad[:5]}"


@pytest.mark.parametrize("batch", [1, 3, 17, 33])
def test_k6_on_a_ragged_batch(keys, cuda, batch):
    cases = make_cases(keys[1:2], (8,), seed=batch)[:batch]
    ok = launch(keys[1:2], cases, cuda)
    torch.cuda.synchronize()
    assert ok.cpu().tolist() == wanted(keys[1:2], cases)


def test_the_plain_version_equals_the_host_check(keys):
    cases = make_cases(keys, (2, 8, 8, 2), seed=7)
    before = dict(LAUNCHES)
    ok = launch(keys, cases, torch.device("cpu"))
    assert LAUNCHES == before  # the plain version is no launch
    want = wanted(keys, cases)
    assert ok.tolist() == want
    assert sum(want) == 20


def test_the_key_table_holds_montgomery_constants(keys):
    n, r2, n0inv, e = K6.key_table([(k.n, k.e) for k in keys], "cpu")
    for i, key in enumerate(keys):
        as_int = int.from_bytes(n[i].numpy().tobytes(), "little")
        assert as_int == key.n
        r2_int = int.from_bytes(r2[i].numpy().tobytes(), "little")
        assert r2_int == pow(2, 4096, key.n)
        assert (int(n0inv[i]) * key.n) % 2 ** 32 == 2 ** 32 - 1
        assert int(e[i]) == key.e


@pytest.mark.parametrize("n,e", [
    (2 ** 2047 + 1, 2), (2 ** 2047, 65537), (2 ** 1023 + 1, 65537),
    (2 ** 2048 + 1, 65537), (2 ** 2047 + 1, 2 ** 32 + 1)])
def test_the_key_table_refuses_what_k6_does_not_take(n, e):
    assert not K6.takes(n, e)
    with pytest.raises(ValueError, match="K6 takes"):
        K6.key_table([(n, e)], "cpu")


def test_the_wrapper_refuses_mismatched_inputs(keys):
    cases = make_cases(keys[1:2], (1,), seed=1)
    table = K6.key_table([(keys[1].n, keys[1].e)], "cpu")
    sig = torch.from_numpy(K6.limbs([c[2] for c in cases], K6.LIMBS))
    digest = torch.zeros(len(cases), K6.DIGEST_LIMBS, dtype=torch.int32)
    idx = torch.zeros(len(cases), dtype=torch.int32)
    with pytest.raises(ValueError, match="key indices"):
        K6.rsa_verify(sig, idx[1:], digest, *table)
    with pytest.raises(ValueError, match="sig must be"):
        K6.rsa_verify(sig[:, :32].contiguous(), idx, digest, *table)
    with pytest.raises(ValueError, match="digest must be"):
        K6.rsa_verify(sig, idx, digest.to(torch.int64), *table)
    with pytest.raises(ValueError, match="key table"):
        K6.rsa_verify(sig, idx, digest, table[0], table[1][:0], *table[2:])
