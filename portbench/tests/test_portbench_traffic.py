"""The traffic generator's schedule and seeding, and the evidence signer
against the evidence format the port's verifiers read."""

import json

import numpy as np
import pytest

from conftest import ROOT
from portbench import fleetgen as G
from portbench import traffic as T
from portbench.reference.model import judge_evidence


def load(kind, name):
    with open(f"{ROOT}/portbench/{kind}/{name}.json") as f:
        return json.load(f)


def small(conf, n):
    cfg = load("configs", conf)
    cfg["nodes"] = n
    cfg["pool_nodes"] = max(1, n // 4)
    return cfg


@pytest.mark.parametrize("conf,n", [("gke15k", 1800), ("k8s5k", 1000)])
def test_mix_counts_are_exact_and_seeded(conf, n):
    cfg = small(conf, n)
    a = G.make_fleet(cfg, 3, 1.8e9)
    b = G.make_fleet(cfg, 3, 1.8e9)
    c = G.make_fleet(cfg, 4, 1.8e9)
    assert a == b
    assert a != c

    def counts(fleet):
        states = [x["metadata"]["labels"][G.CC_MODE_STATE_LABEL]
                  for x in fleet]
        return (states.count("off"), states.count("failed"),
                sum(bool(x["spec"].get("taints")) for x in fleet),
                sum(G.EVIDENCE_ANNOTATION not in x["metadata"]["annotations"]
                    for x in fleet))

    assert counts(a) == counts(c)
    assert counts(a)[0] == round(cfg["mix"]["divergent"] * n)
    slices = {x["metadata"]["labels"].get(G.SLICE_LABEL) for x in a}
    if cfg["domain_hosts"] > 1:
        assert len(slices) == -(-n // cfg["domain_hosts"])
    else:
        assert slices == {None}


def test_schedule_seeding_and_rates():
    cfg = small("gke15k", 3600)
    mix = load("traffic", "rolling")
    fleet = G.make_fleet(cfg, 5, 1.8e9)
    s1 = T.make_schedule(fleet, cfg, mix, 5, 300.0)
    s2 = T.make_schedule(fleet, cfg, mix, 5, 300.0)
    s3 = T.make_schedule(fleet, cfg, mix, 6, 300.0)
    for f in ("t", "node", "kind"):
        np.testing.assert_array_equal(getattr(s1, f), getattr(s2, f))
    assert not np.array_equal(s1.t, s3.t)
    assert np.all(np.diff(s1.t) >= 0)
    # the background: each node once per period, n / 150 writes a second
    for kind in (T.KUBELET, T.DOCTOR):
        nodes = s1.node[s1.kind == kind]
        assert sorted(nodes.tolist()) == list(range(3600))
    # the rolling change: 4 % of the fleet a minute, whole domains, three
    # writes a node at 0, +1 and +5 s
    desired = s1.kind == T.DESIRED
    per_min = np.sum(s1.t[desired] < 60.0)
    assert abs(per_min - 0.04 * 3600) <= cfg["domain_hosts"]
    for node in np.unique(s1.node[desired])[:20]:
        mine = s1.t[(s1.node == node) & (s1.kind >= T.DESIRED)]
        assert np.allclose(np.diff(mine), [1.0, 4.0])
        labels = fleet[node]["metadata"]["labels"]
        assert labels[G.CC_MODE_STATE_LABEL] == "on"
        assert not fleet[node]["spec"].get("taints")
    # the same number of flips on another seed
    assert np.sum(s3.kind == T.DESIRED) == np.sum(desired)


def test_solo_groups_skip_broken_nodes():
    cfg = small("k8s5k", 400)
    fleet = G.make_fleet(cfg, 9, 1.8e9)
    groups = T.rolling_groups(fleet, cfg, 8)
    assert all(len(g) == 8 for g in groups)
    broken = [i for i, x in enumerate(fleet) if not T._clean(x)]
    assert not set(broken) & {i for g in groups for i in g}


def test_evidence_signer_matches_the_format(cpu_planner):
    from tpu_cc_manager_torch.evidence import judge_evidence as port_judge

    cfg = load("configs", "gke15k")
    key = G.evidence_key(11)
    good = json.loads(G.sign_evidence("n1", "on", 1.8e9, cfg, key))
    lying = json.loads(G.sign_evidence("n1", "on", 1.8e9, cfg, key,
                                       attest="off"))
    tampered = json.loads(G.sign_evidence("n1", "on", 1.8e9, cfg, key,
                                          tamper=True))
    assert len(good["devices"]) == cfg["gpus_per_node"]
    assert port_judge(good, "n1", key=key) == ("ok", "on")
    assert port_judge(lying, "n1", key=key) == ("ok", "off")
    assert port_judge(tampered, "n1", key=key)[0] == "digest_mismatch"
    assert port_judge(good, "n2", key=key)[0] == "node_mismatch"
    other = G.evidence_key(12)
    assert port_judge(good, "n1", key=other)[0] == "digest_mismatch"
    # the reference's own check gives the same verdicts
    for doc, name, k in ((good, "n1", key), (lying, "n1", key),
                         (tampered, "n1", key), (good, "n2", key),
                         (good, "n1", other)):
        assert judge_evidence(json.dumps(doc), name, k) == \
            port_judge(doc, name, key=k)


def test_patches_round_trip_through_the_standin():
    from portbench.standin import FakeKube

    cfg = small("k8s5k", 50)
    fleet = G.make_fleet(cfg, 1, 1.8e9)
    kube = FakeKube()
    for node in fleet:
        kube.add_node(node)
    key = G.evidence_key(1)
    name = fleet[0]["metadata"]["name"]
    kube.patch_node(name, T.patch_for(T.TAINT, name, False, "off", 1.8e9,
                                      cfg, key))
    assert kube.get_node(name)["spec"]["taints"]
    kube.patch_node(name, T.patch_for(T.DONE, name, False, "off", 1.8e9,
                                      cfg, key))
    node = kube.get_node(name)
    assert "taints" not in node["spec"]
    assert node["metadata"]["labels"][G.CC_MODE_STATE_LABEL] == "off"
    ev = node["metadata"]["annotations"][G.EVIDENCE_ANNOTATION]
    assert judge_evidence(ev, name, key) == ("ok", "off")
