"""The attested preflight cell (``cvm5k.attested_preflight``) on the CPU at
a tiny size: a sound traced run is correct, reports the identity and
attestation metrics and holds the program's verdict counts to the
reference's; the control and each of three faults in the program's
token checks (signatures skipped, the require flags cleared, the nonce
check skipped) come out not correct. A pool of signing workers, which a
whole fleet uses, signs what one process signs."""

import json
import os

import pytest

import tinyroot
from portbench import attestgen as A
from portbench.harness import run_cell

CELL = "cvm5k.attested_preflight"
SEED = 2 ** 32 + 18


@pytest.fixture
def root(tmp_path, cpu_planner):
    saved = dict(os.environ)
    dst = tinyroot.make(str(tmp_path))
    p = f"{dst}/portbench/configs/cvm5k.json"
    with open(p) as f:
        cfg = json.load(f)
    cfg.update(nodes=60, pool_nodes=15)
    cfg["attested"].update(idle_agent=2, identity_replay=2, stale_nonce=2,
                           attestation_missing=2, kid_unknown=2,
                           signature_flipped=2)
    cfg["tokens"]["rsa_bits"] = 512
    with open(p, "w") as f:
        json.dump(cfg, f)
    p = f"{dst}/portbench/traffic/attested_preflight.json"
    with open(p) as f:
        mix = json.load(f)
    # doctor verdicts republished every second, so the fleet moves
    # under the preflights
    mix.update(lead_s=1, warm_calls=1,
               background={"kubelet_period_s": 300, "doctor_period_s": 1})
    with open(p, "w") as f:
        json.dump(mix, f)
    yield dst
    # a run sets the configuration's environment in this process
    os.environ.clear()
    os.environ.update(saved)


def test_a_sound_traced_run_is_correct(root):
    r = run_cell(root, CELL, SEED, 3.0, True, require_cuda=False)
    assert r["correct"], r["notes"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"identity_ms.preflight", "attestation_ms.preflight",
            "groups_ms.preflight",
            "evidence_ms.preflight"} <= set(r["metrics"])
    note = next(n for n in r["notes"] if n.startswith("verdict counts"))
    k = r["attempted"]
    assert f"in {k} of {k} preflights" in note, note


def test_the_control_is_not_correct(root):
    r = run_cell(root, CELL, SEED, 2.0, False, require_cuda=False,
                 control=True)
    assert not r["correct"]
    assert r["checks"]["plan_mismatch"]["value"] > 0


def skip_signatures(objs):
    ident = objs["identity"]
    objs["restore"].append((ident, "_rsa_pkcs1_sha256_verify",
                            ident._rsa_pkcs1_sha256_verify))
    ident._rsa_pkcs1_sha256_verify = lambda *a: True


def clear_require_flags(objs):
    for mod, name in ((objs["identity"], "require_identity"),
                      (objs["attest"], "require_attestation")):
        objs["restore"].append((mod, name, getattr(mod, name)))
        setattr(mod, name, lambda: False)


def skip_nonce(objs):
    att, ident = objs["attest"], objs["identity"]
    orig = att._judge_cs_token

    def judge(a, expected):
        _, claims = ident.token_claims(a["token"])
        return orig(a, claims["eat_nonce"][0])

    objs["restore"].append((att, "_judge_cs_token", orig))
    att._judge_cs_token = judge


@pytest.mark.parametrize("fault", [skip_signatures, clear_require_flags,
                                   skip_nonce])
def test_a_broken_token_check_is_not_correct(fault, root):
    r = run_cell(root, CELL, SEED, 2.0, False, require_cuda=False,
                 fault=fault)
    assert not r["correct"]
    assert r["checks"]["group_mismatch"]["value"] > 0, r["notes"]


def test_a_pool_signs_what_one_process_signs():
    key = A.make_key("pool", "k", 512, 8)
    work = [(0, f"header.claims-{i}".encode()) for i in range(300)]
    with A.signing_pool(A._POOL_MIN, workers=2) as pool:
        assert pool is not None
        assert A.sign_all([key], work, pool) == A.sign_all([key], work)
