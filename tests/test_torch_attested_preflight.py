"""The port's rollout preflight over an attested fleet, held to the plain
reference and to the JAX package.

A fleet of 60 Confidential-VM nodes (the benchmark's ``cvm5k``
configuration cut down, ``portbench/configs/cvm5k.json``) whose evidence
carries an RS256 instance-identity token and an RS256 attestation token
under the configuration's 2048-bit multi-prime keys, the size K6 takes,
with every attested share planted at least twice: idle agents with expired tokens, a replayed identity token,
an attestation token committed to an older document, no attestation, a
``kid`` no JWKS holds, a flipped signature byte. Both tokens are
required (``TPU_CC_REQUIRE_IDENTITY``, ``TPU_CC_REQUIRE_ATTESTATION``).

- ``Rollout(kube, "on", dry_run=True).run()``'s groups equal the plain
  reference's (``portbench/reference/attested.py``) and the JAX
  package's.
- The ``groups`` span's verdict counts and ``jwks_loads`` equal what the
  planted shares give, every RS256 verdict from the group plan's batch
  (``rs256.py``, K6's plain version here).
- The batch changes no group and no verdict; a key swapped between the
  pre-pass and the judge, a 1024-bit key and a signature not below n go
  to the host ``pow``; no batch is seen outside the group plan; with no
  JWKS provisioned nothing is collected and nothing launches.
- The reference's RS256 check agrees with the port's
  ``identity._rsa_pkcs1_sha256_verify`` on valid and forged signatures.
- With the signature check skipped, the require flags cleared or the
  nonce check skipped, the port's groups differ from the reference's.
"""

import copy
import hashlib
import hmac
import json
import math
import os
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
from tpu_cc_manager_torch import rs256  # noqa: E402
from tpu_cc_manager_torch.kernels import rsa_verify as K6  # noqa: E402
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


def groups_attrs():
    """The newest ``groups`` span's attributes."""
    recs, _ = ring_records()
    return [r[6] for r in recs if r[0] == "groups"][-1]


def verdicts(attrs):
    return {k: v for k, v in attrs.items()
            if k.startswith(("id_", "att_")) and v}


#: the verdicts reached after a signature check: identity ok, expired
#: (the signature is checked first) and invalid; attestation ok,
#: expired and mismatch (a bad signature or, after it, the nonce)
VERIFIED = ("id_ok", "id_expired", "id_invalid", "att_ok", "att_expired",
            "att_mismatch")


def test_the_groups_span_counts_each_verdict(fleet):
    port_groups(fleet[1])
    attrs = groups_attrs()
    want, loads = planted_counts(fleet)
    got = verdicts(attrs)
    assert got == {k: v for k, v in want.items() if v}
    _, counts = reference_tally(port_groups(fleet[1]), fleet)
    assert dict(counts) == got
    # the pre-pass reads the attestation JWKS once; the judge still
    # reads it for every document
    assert attrs["jwks_loads"] == loads + 1
    assert attrs["rsa_host"] == 0
    assert attrs["rsa_batched"] == sum(got.get(k, 0) for k in VERIFIED)
    assert attrs["identity_s"] > 0 and attrs["attestation_s"] > 0
    assert attrs["rsa_batch_s"] > 0
    assert attrs["evidence_s"] >= attrs["identity_s"] \
        + attrs["attestation_s"] + attrs["rsa_batch_s"]


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


def no_batch(monkeypatch):
    monkeypatch.setattr(rs256, "prepare", lambda annotations: (None, {}))


def count_launches(monkeypatch):
    """Each K6 call the group plan makes, by its batch size."""
    calls = []
    real = K6.rsa_verify

    def spy(sig, *rest):
        calls.append(sig.shape[0])
        return real(sig, *rest)

    monkeypatch.setattr(K6, "rsa_verify", spy)
    return calls


def test_the_batch_changes_no_group_and_no_verdict(fleet, monkeypatch):
    launches = count_launches(monkeypatch)
    batched = port_groups(fleet[1])
    with_batch = groups_attrs()
    assert len(launches) == 1 and launches[0] >= with_batch["rsa_batched"]
    no_batch(monkeypatch)
    assert port_groups(fleet[1]) == batched
    without = groups_attrs()
    assert verdicts(without) == verdicts(with_batch)
    assert len(launches) == 1
    assert without["rsa_batched"] == without["rsa_host"] == 0
    assert without["jwks_loads"] == with_batch["jwks_loads"] - 1


def swap_identity_key(fleet):
    """The identity JWKS with its first kid's modulus replaced by
    another key's (a rotation that reuses the kid), the file's mtime
    moved so the identity judge reads it again."""
    path = fleet[5]["TPU_CC_IDENTITY_JWKS_FILE"]
    jwks = json.loads(pathlib.Path(path).read_text())
    other = A.make_key("swapped", jwks["keys"][0]["kid"], 2048, 8)
    jwks["keys"][0]["n"] = tidentity._b64url(other.n.to_bytes(256, "big"))
    st = os.stat(path)
    pathlib.Path(path).write_text(json.dumps(jwks))
    os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))


def test_a_key_swapped_after_the_pre_pass_is_checked_on_the_host(
        fleet, monkeypatch):
    path = fleet[5]["TPU_CC_IDENTITY_JWKS_FILE"]
    saved = pathlib.Path(path).read_text()
    port_groups(fleet[1])
    unswapped = verdicts(groups_attrs())
    real = rs256.prepare

    def prepare_then_swap(annotations):
        out = real(annotations)
        swap_identity_key(fleet)
        return out

    try:
        monkeypatch.setattr(rs256, "prepare", prepare_then_swap)
        late = port_groups(fleet[1])
        late_attrs = groups_attrs()
        # the same swap before the pre-pass: every verdict batched
        pathlib.Path(path).write_text(saved)
        monkeypatch.setattr(rs256, "prepare", real)
        swap_identity_key(fleet)
        early = port_groups(fleet[1])
        early_attrs = groups_attrs()
    finally:
        pathlib.Path(path).write_text(saved)
        os.utime(path, ns=(time.time_ns(), time.time_ns() + 2 * 10 ** 9))
    assert late == early
    assert verdicts(late_attrs) == verdicts(early_attrs)
    # the swapped kid's tokens no longer verify
    assert verdicts(late_attrs)["id_invalid"] > unswapped["id_invalid"]
    assert early_attrs["rsa_host"] == 0
    assert late_attrs["rsa_host"] > 0
    assert late_attrs["rsa_batched"] + late_attrs["rsa_host"] \
        == early_attrs["rsa_batched"]


def test_keys_and_signatures_k6_does_not_take_go_to_the_host(monkeypatch):
    key = A.make_key("take-2048", "a", 2048, 8)
    small = A.make_key("take-1024", "b", 1024, 2)
    msg = b"header.claims"
    good, small_good = A.sign(key, msg), A.sign(small, msg)
    digest = hashlib.sha256(msg).digest()
    batch = rs256.Rs256Batch()
    for n, e, sig in ((key.n, key.e, good), (small.n, small.e, small_good),
                      (key.n, key.e, key.n.to_bytes(256, "big")),
                      (key.n, key.e, good[1:])):
        batch.add(n, e, digest, sig)
    monkeypatch.setenv("TPU_CC_TORCH_DEVICE", "cpu")
    batch.run()
    over = (int.from_bytes(good, "big") + key.n)
    cases = [(key, good, True), (small, small_good, True),
             (key, key.n.to_bytes(256, "big"), False), (key, good[1:], False)]
    if over < 2 ** 2048:
        # not below n: the host reduces it mod n and accepts it
        cases.append((key, over.to_bytes(256, "big"), True))
    scope = tidentity.rs256_batch.set(batch)
    try:
        got = [tidentity._rsa_pkcs1_sha256_verify(k.n, k.e, msg, s)
               for k, s, _ in cases]
    finally:
        tidentity.rs256_batch.reset(scope)
    assert got == [want for _, _, want in cases]
    assert (batch.batched, batch.host) == (1, len(cases) - 1)


def test_no_batch_is_seen_outside_the_group_plan(fleet, monkeypatch):
    seen = []
    real = rs256.Rs256Batch.verdict

    def spy(self, *args):
        seen.append(args)
        return real(self, *args)

    monkeypatch.setattr(rs256.Rs256Batch, "verdict", spy)
    port_groups(fleet[1])
    assert seen and tidentity.rs256_batch.get() is None
    inside = len(seen)
    cfg, nodes, key, keys, planted, env = fleet
    docs = [json.loads(n["metadata"]["annotations"][
        "tpu.google.com/cc.evidence"]) for n in nodes
        if "tpu.google.com/cc.evidence" in (
            n["metadata"].get("annotations") or {})]
    verdicts_out = [tattest.judge_attestation(d, d.get("node"))[0]
                    for d in docs]
    assert "ok" in verdicts_out
    assert [tidentity.judge_identity(d, d.get("node"))[0]
            for d in docs].count("ok") > 0
    assert len(seen) == inside


def test_without_a_jwks_nothing_is_collected_or_launched(fleet,
                                                         monkeypatch):
    monkeypatch.delenv("TPU_CC_IDENTITY_JWKS_FILE")
    monkeypatch.delenv("TPU_CC_ATTESTATION_JWKS_FILE")
    launches = count_launches(monkeypatch)
    made = []
    real = rs256.Rs256Batch
    monkeypatch.setattr(rs256, "Rs256Batch",
                        lambda: made.append(1) or real())
    loads = tidentity.jwks_loads
    port_groups(fleet[1])
    attrs = groups_attrs()
    assert launches == [] and made == []
    assert tidentity.jwks_loads == loads
    assert (attrs["rsa_batched"], attrs["rsa_host"],
            attrs["rsa_batch_s"]) == (0, 0, 0.0)
    assert rs256.prepare([("n", "{}")]) == (None, {})


#: token segments a node can publish that no judge decodes: a lone
#: surrogate (a JSON ``\ud800`` escape in the annotation), non-ASCII text
HOSTILE = ("\ud800", "café")


def with_hostile_token(fleet, field, segment):
    """The fleet with one honest converged node's ``field`` token
    (identity or attestation) given ``segment`` as its payload, under its
    own valid header and signature, the document signed again with the
    pool key so that the judges reach the token."""
    _, nodes, key, _, planted, _ = fleet
    planted_idx = {i for v in planted.kinds.values() for i in v}
    hist = History(nodes, key)
    nodes = copy.deepcopy(nodes)
    for i, (node, v) in enumerate(zip(nodes, hist.versions)):
        ann = node["metadata"].get("annotations") or {}
        raw = ann.get(G.EVIDENCE_ANNOTATION)
        if i in planted_idx or not raw or not (
                v.desired_label == v.state == "on" and v.ev_verdict == "ok"
                and v.ev_attested == "on"):
            continue
        doc = json.loads(raw)
        if not isinstance(doc.get(field), dict):
            continue
        head, _, sig = doc[field]["token"].split(".")
        doc[field]["token"] = f"{head}.{segment}.{sig}"
        body = {k: v for k, v in doc.items() if k != "digest"}
        doc["digest"] = "hmac-sha256:" + hmac.new(
            key, A._canonical(body), hashlib.sha256).hexdigest()
        ann[G.EVIDENCE_ANNOTATION] = json.dumps(doc)
        return nodes, node["metadata"]["name"]
    raise AssertionError(f"no honest node carries {field}")


@pytest.mark.parametrize("segment", HOSTILE, ids=["surrogate", "non_ascii"])
@pytest.mark.parametrize("field", ["identity", "attestation"])
def test_a_hostile_token_is_judged_as_without_the_batch(field, segment,
                                                        fleet, monkeypatch):
    honest = port_groups(fleet[1])
    before = verdicts(groups_attrs())
    nodes, name = with_hostile_token(fleet, field, segment)
    batched = port_groups(nodes)
    with_batch = groups_attrs()
    assert with_batch["rsa_host"] == 0
    no_batch(monkeypatch)
    assert port_groups(nodes) == batched
    assert verdicts(groups_attrs()) == verdicts(with_batch)
    # the node the judges passed is now a suspect, its token invalid
    invalid = ("id_" if field == "identity" else "att_") + "invalid"
    assert verdicts(with_batch).get(invalid, 0) == before.get(invalid, 0) + 1
    group = f"node/{name}"
    assert [g["outcome"] for g in honest if g["name"] == group] \
        == ["skipped"]
    assert [g["outcome"] for g in batched if g["name"] == group] \
        == ["planned"]


#: a header naming kid "k" with no alg, and one with alg RS256
KID_ONLY, RS256_K = "eyJraWQiOiJrIn0", tidentity._b64url(
    b'{"alg":"RS256","kid":"k"}')


@pytest.mark.parametrize("token", [
    None, 7, "a.b", "a.b.c.d", "\ud800.e30.AA", "W10.e30.AA",
    "eyJraWQiOltdfQ.e30.AA", KID_ONLY + ".e30.A", KID_ONLY + ".\ud800.AA",
], ids=["none", "int", "two_parts", "four_parts", "surrogate_header",
        "list_header", "list_kid", "bad_signature", "surrogate_payload"])
def test_rs256_inputs_raises_on_no_token(token):
    keys = {"k": (2 ** 2047 + 1, 65537)}
    headers = {}
    assert rs256.rs256_inputs(token, keys) is None
    assert rs256.rs256_inputs(token, keys, None, headers) is None
    # a header the cache kept serves the next token alike
    assert rs256.rs256_inputs(token, keys, None, headers) is None


def test_rs256_inputs_reads_what_the_judges_verify():
    keys = {"k": (2 ** 2047 + 1, 65537)}
    token = RS256_K + ".e30.AAEC"
    want = (keys["k"][0], 65537, (RS256_K + ".e30").encode(), b"\0\1\2")
    headers = {}
    assert rs256.rs256_inputs(token, keys, "RS256", headers) == want
    assert rs256.rs256_inputs(token, keys, "RS256", headers) == want
    assert rs256.rs256_inputs(KID_ONLY + ".e30.AAEC", keys) is None
    assert rs256.rs256_inputs(KID_ONLY + ".e30.AAEC", keys, None)[:2] \
        == keys["k"]
    assert rs256.rs256_inputs(token, {"j": keys["k"]}) is None
