"""The port's rollout preflight over an attested fleet, held to the plain
reference and to the JAX package.

A fleet of 60 Confidential-VM nodes (the benchmark's ``cvm5k``
configuration cut down, ``portbench/configs/cvm5k.json``) whose evidence
carries an RS256 instance-identity token and an RS256 attestation token
under small multi-prime keys, with every attested share planted at
least twice: idle agents with expired tokens, a replayed identity token,
an attestation token committed to an older document, no attestation, a
``kid`` no JWKS holds, a flipped signature byte. Both tokens are
required (``TPU_CC_REQUIRE_IDENTITY``, ``TPU_CC_REQUIRE_ATTESTATION``).

- ``Rollout(kube, "on", dry_run=True).run()``'s groups equal the plain
  reference's (``portbench/reference/attested.py``) and the JAX
  package's.
- The ``groups`` span's verdict counts and ``jwks_loads`` equal what the
  planted shares give.
- The reference's RS256 check agrees with the port's
  ``identity._rsa_pkcs1_sha256_verify`` on valid and forged signatures.
- With the signature check skipped, the require flags cleared or the
  nonce check skipped, the port's groups differ from the reference's.
"""

import copy
import json
import math
import pathlib
import time

import pytest

torch = pytest.importorskip("torch")

from portbench import attestgen as A  # noqa: E402
from portbench import fleetgen as G  # noqa: E402
from portbench.program_spans import ring_records  # noqa: E402
from portbench.reference import attested as R  # noqa: E402
from portbench.reference.check import Tally  # noqa: E402
from portbench.reference.history import History  # noqa: E402
from tpu_cc_manager_torch import attest as tattest  # noqa: E402
from tpu_cc_manager_torch import identity as tidentity  # noqa: E402
from tpu_cc_manager_torch.k8s.fake import FakeKube  # noqa: E402
from tpu_cc_manager_torch.rollout import Rollout  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
SEED = 2 ** 33 + 18
SHARES = {"idle_agent": 3, "identity_replay": 2, "stale_nonce": 2,
          "attestation_missing": 3, "kid_unknown": 3, "signature_flipped": 3}


def small_cfg():
    with open(ROOT / "portbench" / "configs" / "cvm5k.json") as f:
        cfg = json.load(f)
    cfg.update(nodes=60, pool_nodes=15)
    cfg["attested"].update(SHARES)
    cfg["tokens"]["rsa_bits"] = 512
    return cfg


@pytest.fixture(scope="module")
def minted(tmp_path_factory):
    cfg = small_cfg()
    now = time.time()
    nodes = G.make_fleet(cfg, SEED, now)
    keys = A.make_keys(SEED, cfg)
    key = G.evidence_key(SEED)
    planted = A.attest_fleet(nodes, cfg, SEED, key, now, keys)
    env = A.write_jwks(str(tmp_path_factory.mktemp("jwks")), keys)
    return cfg, nodes, key, keys, planted, env


@pytest.fixture
def fleet(minted, monkeypatch):
    """The attested fleet, with the verifier's environment set."""
    cfg, nodes, key, keys, planted, env = minted
    for k, v in {**cfg["env"], **env}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("TPU_CC_EVIDENCE_KEY", key.decode())
    monkeypatch.setenv("TPU_CC_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("TPU_CC_PLANNER_MESH", "1")
    return minted


def port_groups(nodes):
    kube = FakeKube()
    for n in nodes:
        kube.add_node(copy.deepcopy(n))
    return Rollout(kube, "on", dry_run=True).run().to_dict()["groups"]


def reference_tally(groups, minted):
    """Mismatches between ``groups`` and the reference's plan, and the
    reference's token verdict counts."""
    cfg, nodes, key, _, _, env = minted
    hist = History(nodes, key)
    jwks = [json.loads(pathlib.Path(env[v]).read_text())
            for v in ("TPU_CC_IDENTITY_JWKS_FILE",
                      "TPU_CC_ATTESTATION_JWKS_FILE")]
    tokens = R.Tokens(nodes, [], *jwks, cfg["tokens"]["audience"])
    t = Tally()
    now = time.time()
    counts = R.check_groups(groups, hist, tokens, 0, 0, (now, now), "on",
                            (True, True), t)
    return t, counts


def planted_counts(minted):
    """The verdict counts the planted shares give, from the number of
    nodes that reach the identity judge (converged labels, evidence
    present, signed and honest)."""
    _, nodes, key, _, planted, _ = minted
    hist = History(nodes, key)
    judged = sum(1 for v in hist.versions
                 if v.desired_label == "on" and v.state == "on"
                 and v.ev_verdict == "ok" and v.ev_attested == "on")
    k = {kind: len(idx) for kind, idx in planted.kinds.items()}
    even = {kind: math.ceil(n / 2) for kind, n in k.items()}
    odd = {kind: n // 2 for kind, n in k.items()}
    want = {"id_expired": k["idle_agent"],
            "id_mismatch": k["identity_replay"],
            "id_invalid": even["signature_flipped"],
            "id_unverifiable": even["kid_unknown"]}
    want["id_ok"] = judged - sum(want.values())
    att = judged - want["id_expired"] - want["id_mismatch"] \
        - want["id_invalid"]
    want.update({"att_missing": k["attestation_missing"],
                 "att_mismatch": k["stale_nonce"] + odd["signature_flipped"],
                 "att_unverifiable": odd["kid_unknown"]})
    want["att_ok"] = att - sum(want[x] for x in (
        "att_missing", "att_mismatch", "att_unverifiable"))
    return want, att - k["attestation_missing"]


def test_every_share_is_planted_at_least_twice(minted):
    _, _, _, _, planted, _ = minted
    assert {k: len(v) for k, v in planted.kinds.items()} == SHARES
    nodes = [i for v in planted.kinds.values() for i in v]
    assert len(nodes) == len(set(nodes))


def test_the_port_plans_the_groups_the_reference_plans(fleet):
    groups = port_groups(fleet[1])
    t, counts = reference_tally(groups, fleet)
    assert t.count == 0, t.notes
    planned = {g["name"] for g in groups if g["outcome"] == "planned"}
    names = fleet[1]
    for kind in ("idle_agent", "identity_replay", "stale_nonce",
                 "attestation_missing", "signature_flipped"):
        for i in fleet[4].kinds[kind]:
            assert f"node/{names[i]['metadata']['name']}" in planned, kind
    for i in fleet[4].kinds["kid_unknown"]:
        assert f"node/{names[i]['metadata']['name']}" not in planned


def test_the_port_plans_the_groups_the_jax_package_plans(fleet):
    from tpu_cc_manager.k8s.fake import FakeKube as RefKube
    from tpu_cc_manager.rollout import Rollout as RefRollout

    kube = RefKube()
    for n in fleet[1]:
        kube.add_node(copy.deepcopy(n))
    want = RefRollout(kube, "on", dry_run=True).run().to_dict()["groups"]
    assert port_groups(fleet[1]) == want


def test_the_groups_span_counts_each_verdict(fleet):
    port_groups(fleet[1])
    recs, _ = ring_records()
    attrs = [r[6] for r in recs if r[0] == "groups"][-1]
    want, loads = planted_counts(fleet)
    got = {k: v for k, v in attrs.items()
           if k.startswith(("id_", "att_")) and v}
    assert got == {k: v for k, v in want.items() if v}
    _, counts = reference_tally(port_groups(fleet[1]), fleet)
    assert dict(counts) == got
    assert attrs["jwks_loads"] == loads
    assert attrs["identity_s"] > 0 and attrs["attestation_s"] > 0
    assert attrs["evidence_s"] >= attrs["identity_s"] + attrs["attestation_s"]


@pytest.mark.parametrize("bits,primes", [(512, 8), (1024, 2), (2048, 8)])
def test_the_reference_rs256_check_agrees_with_the_port(bits, primes):
    key = A.make_key(f"agree-{bits}-{primes}", "k", bits, primes)
    other = A.make_key(f"agree-other-{bits}", "o", bits, primes)
    assert key.n.bit_length() == bits
    msg = b"header.claims"
    good = A.sign(key, msg)
    k = len(good)
    flipped = bytes([good[0] ^ 1]) + good[1:]
    cases = [(msg, good), (b"header.claimz", good), (msg, flipped),
             (msg, A.sign(other, msg)), (msg, good[1:]), (msg, b"\0" * k),
             (msg, key.n.to_bytes(k, "big")),
             (msg, (key.n - 1).to_bytes(k, "big"))]
    got = [(R.rs256_ok(key.n, key.e, m, s),
            tidentity._rsa_pkcs1_sha256_verify(key.n, key.e, m, s))
           for m, s in cases]
    assert [g[0] for g in got] == [g[1] for g in got]
    assert [g[0] for g in got] == [True] + [False] * (len(cases) - 1)


def skip_signatures(monkeypatch):
    monkeypatch.setattr(tidentity, "_rsa_pkcs1_sha256_verify",
                        lambda *a: True)


def clear_require_flags(monkeypatch):
    monkeypatch.setenv("TPU_CC_REQUIRE_IDENTITY", "")
    monkeypatch.setenv("TPU_CC_REQUIRE_ATTESTATION", "")


def skip_nonce(monkeypatch):
    orig = tattest._judge_cs_token

    def judge(att, expected):
        _, claims = tidentity.token_claims(att["token"])
        return orig(att, claims["eat_nonce"][0])

    monkeypatch.setattr(tattest, "_judge_cs_token", judge)


@pytest.mark.parametrize("fault", [skip_signatures, clear_require_flags,
                                   skip_nonce])
def test_a_broken_check_plans_other_groups(fault, fleet, monkeypatch):
    fault(monkeypatch)
    t, _ = reference_tally(port_groups(fleet[1]), fleet)
    assert t.count > 0
