"""The plain reference's report on hand-made fleets, and its comparison
with the port's planner and audit on the CPU."""

import copy
import json

import numpy as np
import pytest

from portbench import fleetgen as G
from portbench.reference.check import (
    Tally, check_audit, check_groups, check_plan, control_report,
    expected_groups,
)
from portbench.reference.history import History

KEY = b"k" * 16
NOW = 1_800_000_000
CFG = {"gpu_name": "NVIDIA H100 80GB HBM3", "gpus_per_node": 2}


def node(name, desired="on", state="on", slice_=None, taint=False,
         doctor=True, ev_age=60, ev_mode=None, tamper=False):
    ann = {}
    if doctor is not None:
        ann[G.DOCTOR_ANNOTATION] = G.doctor_verdict(not doctor, NOW - 5)
    if ev_age is not None:
        mode = ev_mode or state
        ann[G.EVIDENCE_ANNOTATION] = G.sign_evidence(
            name, mode, NOW - ev_age, CFG, KEY, tamper=tamper)
    labels = {G.CC_MODE_LABEL: desired, G.CC_MODE_STATE_LABEL: state}
    if slice_:
        labels[G.SLICE_LABEL] = slice_
    spec = {"taints": [dict(G.FLIP_TAINT)]} if taint else {}
    return {"metadata": {"name": name, "labels": labels,
                         "annotations": ann}, "spec": spec}


def fleet():
    return [
        node("a"),                                   # converged
        node("b", state="off"),                      # divergent
        node("c", state="failed", ev_age=None),      # failed
        node("d", taint=True),                       # mid-flip
        node("e", slice_="s1", desired="off", state="off"),
        node("f", slice_="s1", desired="off", state="on"),  # half-flipped
        node("g", slice_="s2", desired="on"),
        node("h", slice_="s2", desired="off", state="off"),  # incoherent
        node("i", doctor=False),                     # failing doctor
        node("j", ev_age=7200),                      # stale evidence
        node("k", ev_age=None),                      # missing evidence
        node("l", ev_mode="off"),                    # lying evidence
        node("m", tamper=True),                      # tampered evidence
        node("n", doctor=None),                      # no doctor verdict
    ]


EXPECTED = {
    "nodes": 14,
    "needs_flip": ["b", "c", "f"],
    "failed": ["c"],
    "flipping": ["d"],
    "stale_evidence": ["j"],
    "mode_counts": {"on": 10, "off": 3, "failed": 1},
    "incoherent_slices": ["s1", "s2"],
    "half_flipped_slices": ["s1"],
    "doctor": {"reported": 13, "unreported": ["n"],
               "failing": [{"node": "i", "fail": ["iommu"],
                            "at": G.stamp(NOW - 5)}]},
}


def judge(report, nodes=None, clock=(NOW, NOW)):
    nodes = nodes or fleet()
    hist = History(nodes, KEY)
    hist.arrays()
    t = Tally()
    check_plan(report, hist, 100, 100, clock, 3600, t)
    return t


def test_the_hand_made_report_is_correct():
    t = judge(copy.deepcopy(EXPECTED))
    assert t.count == 0, t.notes


@pytest.mark.parametrize("edit", [
    lambda r: r["needs_flip"].remove("b"),
    lambda r: r["failed"].append("a"),
    lambda r: r["flipping"].clear(),
    lambda r: r["stale_evidence"].append("a"),
    lambda r: r["mode_counts"].update(on=9),
    lambda r: r["incoherent_slices"].clear(),
    lambda r: r["half_flipped_slices"].append("s2"),
    lambda r: r["doctor"]["failing"][0].update(fail=["tpm"]),
    lambda r: r["doctor"]["unreported"].clear(),
    lambda r: r.update(nodes=13),
    lambda r: r["needs_flip"].append("zz"),
])
def test_each_altered_answer_is_caught(edit):
    report = copy.deepcopy(EXPECTED)
    edit(report)
    assert judge(report).count > 0


def test_stale_flag_is_judged_over_the_clock_span():
    nodes = [node("a", ev_age=3600), node("b", ev_age=3601)]
    base = {"nodes": 2, "needs_flip": [], "failed": [], "flipping": [],
            "mode_counts": {"on": 2}, "incoherent_slices": [],
            "half_flipped_slices": [],
            "doctor": {"reported": 2, "unreported": [], "failing": []}}
    # a at exactly 3600 s is not stale, b is; one second later both are
    for stale, clock, ok in ((["b"], (NOW, NOW), True),
                             (["a", "b"], (NOW, NOW), False),
                             (["a", "b"], (NOW, NOW + 1), True),
                             ([], (NOW, NOW + 1), False)):
        r = dict(base, stale_evidence=stale)
        assert (judge(r, nodes, clock).count == 0) == ok


def test_a_write_between_the_bounds_may_show_either_version():
    nodes = fleet()
    hist = History(nodes, KEY)
    hist.add(101, 0, {"metadata": {"labels": {G.CC_MODE_LABEL: "off"}}})
    hist.arrays()
    before = copy.deepcopy(EXPECTED)
    after = copy.deepcopy(EXPECTED)
    after["needs_flip"].append("a")
    for report in (before, after):
        t = Tally()
        check_plan(report, hist, 100, 101, (NOW, NOW), 3600, t)
        assert t.count == 0, t.notes
    # once the bounds pass the write, only the new version will do
    t = Tally()
    check_plan(before, hist, 101, 101, (NOW, NOW), 3600, t)
    assert t.count > 0


def test_a_report_may_not_go_back_past_an_earlier_one():
    nodes = fleet()
    hist = History(nodes, KEY)
    hist.add(101, 0, {"metadata": {"labels": {G.CC_MODE_LABEL: "off"}}})
    hist.add(102, 0, {"metadata": {"labels": {G.CC_MODE_LABEL: "on"}}})
    hist.arrays()
    before = copy.deepcopy(EXPECTED)
    flipped = copy.deepcopy(EXPECTED)
    flipped["needs_flip"].append("a")
    # a report that had to show the first write sets the next one's floor
    t = Tally()
    floor = check_plan(flipped, hist, 100, 101, (NOW, NOW), 3600, t)
    assert t.count == 0 and floor[0] > 0
    # the node's first version also fits in bounds (100, 102] but lies
    # before the floor; its newest (back to "on") is past it and fits
    for report, ok in ((before, False), (flipped, True)):
        t = Tally()
        check_plan(report, hist, 100, 101, (NOW, NOW), 3600, t, floor=floor)
        assert (t.count == 0) == ok, t.notes
    t = Tally()
    check_plan(before, hist, 100, 102, (NOW, NOW), 3600, t, floor=floor)
    assert t.count == 0, t.notes


def test_audit_buckets():
    hist = History(fleet(), KEY)
    hist.arrays()
    audit = {b: [] for b in ("missing", "unsigned", "unverifiable",
                             "stale_key", "invalid", "identity_missing",
                             "identity_mismatch", "attestation_missing",
                             "attestation_mismatch",
                             "attestation_unverifiable",
                             "attestation_outage")}
    audit.update(missing=["k"], invalid=["m"], label_device_mismatch=[],
                 label_device_mismatch_transient=["l"])
    t = Tally()
    raw = check_audit(audit, None, hist, 100, 100, t)
    assert t.count == 0, t.notes
    assert raw == {"l"}
    # the second scan: the debounce moves l to the reported bucket
    audit2 = dict(audit, label_device_mismatch=["l"],
                  label_device_mismatch_transient=[])
    check_audit(audit2, raw, hist, 100, 100, t)
    assert t.count == 0, t.notes
    for edit in (dict(missing=[]), dict(invalid=["m", "a"]),
                 dict(unverifiable=["a"])):
        t = Tally()
        check_audit(dict(audit2, **edit), raw, hist, 100, 100, t)
        assert t.count > 0


def test_the_port_agrees_with_the_reference(cpu_planner):
    from tpu_cc_manager_torch.evidence import audit_evidence
    from tpu_cc_manager_torch.plan import analyze_fleet

    nodes = fleet()
    hist = History(nodes, KEY)
    hist.arrays()
    now = int(__import__("time").time())
    # evidence ages relative to this host's clock, which the port reads
    for n in nodes:
        ann = n["metadata"]["annotations"]
        if G.EVIDENCE_ANNOTATION in ann:
            doc = json.loads(ann[G.EVIDENCE_ANNOTATION])
            assert doc["node"] == n["metadata"]["name"]
    report = analyze_fleet(copy.deepcopy(nodes), device="cpu")
    t = Tally()
    check_plan(report, hist, 100, 100, (now, now + 5), 3600, t)
    # the hand-made fleet's clock is in the future: every node with
    # evidence reads fresh on this host, and the judge agrees
    assert t.count == 0, t.notes
    audit = audit_evidence(copy.deepcopy(nodes), key=KEY)
    audit["label_device_mismatch_transient"] = []
    t = Tally()
    check_audit(audit, None, hist, 100, 100, t)
    assert t.count == 0, t.notes


def test_group_plan():
    nodes = fleet()
    hist = History(nodes, KEY)
    hist.arrays()
    groups = expected_groups(hist, hist.vids_at(100), "on")
    assert groups["node/a"][1:] == ("skipped", "already at on")
    assert groups["node/b"][1] == "planned"
    assert groups["node/l"][1] == "planned"      # lying evidence
    assert groups["node/m"][1] == "planned"      # tampered evidence
    assert groups["node/k"][1] == "skipped"      # missing is tolerated
    assert groups["slice/s2"][0] == ["g", "h"]
    report = [{"name": g, "nodes": m, "outcome": o,
               **({"detail": d} if d else {})}
              for g, (m, o, d) in sorted(groups.items())]
    t = Tally()
    check_groups(report, hist, 100, 100, "on", t)
    assert t.count == 0, t.notes
    report[0]["outcome"] = "planned" if report[0]["outcome"] == "skipped" \
        else "skipped"
    check_groups(report, hist, 100, 100, "on", t)
    assert t.count > 0


def test_the_control_fails_the_comparison():
    nodes = [node(f"n{i}", ev_age=age) for i, age in
             enumerate(range(0, 7200, 300))]
    hist = History(nodes, KEY)
    hist.arrays()
    vids = hist.vids_at(100)
    sound = control_report(hist, vids, NOW, 3600, np.int32)
    t = Tally()
    check_plan(sound, hist, 100, 100, (NOW, NOW), 3600, t)
    assert t.count == 0, t.notes
    low = control_report(hist, vids, NOW, 3600, np.int16)
    check_plan(low, hist, 100, 100, (NOW, NOW), 3600, t)
    assert t.count > 0
