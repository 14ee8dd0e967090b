"""The port's incremental tick session held to the JAX session, step by step.

Each case of tests/test_plan_incremental.py that drives a TickSession is
replayed on a reference session and a port session (``device="cpu"``)
fed the same node changes; after every step the two reports must be
equal, and where the reference pins session statistics or checksums the
port must show the same ones.

The reference runs on a one-device mesh here (``TPU_CC_PLANNER_MESH=1``):
on a multi-device mesh its sharded scatter loses the update of a shard's
last row when the delta block carries padding (ROADMAP Queue 3), which a
verifying tick then reports as drift. The port has one device and no
such row.
"""

import copy
import json
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpu_cc_manager import plan as jplan  # noqa: E402
from tpu_cc_manager.k8s.objects import make_node  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_device_reference(monkeypatch):
    monkeypatch.setenv("TPU_CC_PLANNER_MESH", "1")


def _node(name, desired="on", observed="on", slice_id=None, taint=False,
          doctor=None, ev=None):
    labels = {L.CC_MODE_LABEL: desired, L.CC_MODE_STATE_LABEL: observed}
    if slice_id:
        labels[L.TPU_SLICE_LABEL] = slice_id
    node = make_node(name, labels=labels)
    ann = node["metadata"]["annotations"]
    if doctor is not None:
        ann[L.DOCTOR_ANNOTATION] = json.dumps(doctor)
    if ev is not None:
        ann[L.EVIDENCE_ANNOTATION] = json.dumps({"timestamp": ev})
    if taint:
        node["spec"]["taints"] = [
            {"key": L.FLIP_TAINT_KEY, "effect": "NoSchedule"}]
    return node


def _mixed_nodes(n=40):
    return {
        f"n{i:03d}": _node(
            f"n{i:03d}", slice_id=f"s{i // 4}", desired="on",
            observed="on" if i % 5 else "off", taint=(i % 7 == 0),
            doctor=({"ok": False, "fail": ["hw"]} if i % 11 == 0
                    else {"ok": True}))
        for i in range(n)
    }


class Pair:
    """A reference and a port encoding + session, fed alike."""

    def __init__(self, nodes=None, full_every=0):
        self.jenc, self.tenc = jplan.FleetEncoding(), tplan.FleetEncoding()
        self.jsess = jplan.TickSession(full_every=full_every)
        self.tsess = tplan.TickSession(full_every=full_every, device=CPU)
        for nd in (nodes or {}).values():
            self.apply(nd)

    def apply(self, node):
        a = self.jenc.apply(copy.deepcopy(node))
        assert self.tenc.apply(copy.deepcopy(node)) == a
        return a

    def remove(self, name):
        a = self.jenc.remove(name)
        assert self.tenc.remove(name) == a
        return a

    def report(self, force_full=False):
        want = jplan.analyze_encoding(self.jenc, self.jsess,
                                      force_full=force_full)
        got = tplan.analyze_encoding(self.tenc, self.tsess,
                                     force_full=force_full)
        assert got == want, f"port and reference reports differ ({VERSIONS})"
        return got


def _norm(report):
    """Order-insensitive report compare (name lists are set-like; a
    session's rows follow swap-removes, a fresh encoding's do not)."""
    r = copy.deepcopy(report)
    for key in ("needs_flip", "failed", "flipping", "stale_evidence",
                "incoherent_slices", "half_flipped_slices"):
        r[key] = sorted(r[key])
    return r


def _legacy_report(nodes):
    enc = tplan.FleetEncoding()
    for nd in nodes.values():
        enc.apply(copy.deepcopy(nd))
    return _norm(tplan.analyze_encoding(enc, device=CPU))


def _flip(nodes, name, state):
    nd = copy.deepcopy(nodes[name])
    nd["metadata"]["labels"][L.CC_MODE_STATE_LABEL] = state
    nodes[name] = nd
    return nd


def test_incremental_matches_full_after_mixed_deltas():
    nodes = _mixed_nodes()
    pair = Pair(nodes)
    pair.report()
    for i in (3, 8, 21):
        pair.apply(_flip(nodes, f"n{i:03d}", "off"))
    nodes["n100"] = _node("n100", slice_id="s2", desired="off",
                          observed="on")
    pair.apply(nodes["n100"])
    pair.remove("n005")
    del nodes["n005"]
    moved = copy.deepcopy(nodes["n012"])
    moved["metadata"]["labels"][L.TPU_SLICE_LABEL] = "s9"
    nodes["n012"] = moved
    pair.apply(moved)
    assert _norm(pair.report()) == _legacy_report(nodes)
    assert pair.tsess.stats == pair.jsess.stats
    assert pair.tsess.stats["rebuilds"] == 1
    assert pair.tsess.stats["incr_ticks"] == 1


def test_forced_full_tick_checksum_pin():
    """A forced full tick runs K1 over the resident block and compares
    every output with the incremental state; the checksum it leaves is
    the reference's, bit for bit."""
    nodes = _mixed_nodes()
    pair = Pair(nodes)
    pair.report()
    pair.apply(_flip(nodes, "n002", "failed"))
    pair.report(force_full=True)
    assert pair.tsess.stats["verifies"] == 1
    assert pair.tsess.last_checksum == pair.jsess.last_checksum is not None
    res = pair.tsess.tick(pair.tenc, force_full=True)
    assert res.kind == "full"
    assert res.checksum == pair.tsess.last_checksum
    assert pair.jsess.tick(pair.jenc, force_full=True).checksum == \
        res.checksum


def test_drift_raises_and_next_tick_rebuilds():
    nodes = _mixed_nodes()
    pair = Pair(nodes)
    pair.report()
    pair.tsess._state["mode_counts"][0] += 1  # inject drift
    with pytest.raises(tplan.IncrementalDriftError):
        tplan.analyze_encoding(pair.tenc, pair.tsess, force_full=True)
    assert pair.tsess._shards is None
    assert tplan.analyze_encoding(pair.tenc, pair.tsess) == \
        jplan.analyze_encoding(pair.jenc, pair.jsess)
    assert pair.tsess.stats["rebuilds"] == 2


def test_zero_column_round_trips_between_ticks():
    """The block is uploaded once per rebuild (8 columns) and never
    again; delta ticks move only the kb-sized scatter operands, and a
    tick with nothing dirty moves nothing — the reference's counts."""
    nodes = _mixed_nodes()
    pair = Pair(nodes)
    pair.report()
    assert pair.tsess.stats["column_puts"] == 8
    block, = pair.tsess._shards
    for round_ in range(3):
        for i in (1, 6, 17):
            pair.apply(_flip(nodes, f"n{i:03d}",
                             "on" if round_ % 2 else "off"))
        pair.report()
    pair.report(force_full=True)
    # updated in place, never replaced
    assert len(pair.tsess._shards) == 1 and pair.tsess._shards[0] is block
    pair.report()
    assert pair.tsess.stats == pair.jsess.stats
    assert pair.tsess.stats["column_puts"] == 8
    assert pair.tsess.stats["cached_ticks"] == 1


def test_bucket_growth_triggers_rebuild_and_stays_correct():
    nodes = _mixed_nodes(40)
    pair = Pair(nodes)
    pair.report()
    for i in range(40, 70):  # bucket 64 -> 128
        nodes[f"n{i:03d}"] = _node(f"n{i:03d}", slice_id=f"s{i // 4}",
                                   observed="off" if i % 3 else "on")
        pair.apply(nodes[f"n{i:03d}"])
    assert _norm(pair.report()) == _legacy_report(nodes)
    assert pair.tsess.stats["rebuilds"] == 2
    assert pair.tsess.node_bucket == pair.jsess.node_bucket == 128
    assert [tuple(b.shape) for b in pair.tsess._shards] == [(8, 128)]


def test_remove_swap_with_last_interacts_with_compaction():
    pair = Pair()
    nodes = {}
    for i in range(30):
        nodes[f"n{i:03d}"] = _node(f"n{i:03d}", slice_id=f"s{i // 3}",
                                   observed="off" if i % 4 else "on")
        pair.apply(nodes[f"n{i:03d}"])
    pair.report()
    for round_ in range(25):
        nd = _node("churn", slice_id=f"eph-{round_}", observed="off")
        nodes["churn"] = nd
        pair.apply(nd)
        if round_ % 5 == 2:
            victim = f"n{round_:03d}"
            pair.remove(victim)
            nodes.pop(victim, None)
        assert _norm(pair.report()) == _legacy_report(nodes)
    pair.report(force_full=True)
    enc = pair.tenc
    n = len(enc._names)
    for sid, rows in enc._slice_rows.items():
        for row in rows:
            assert row < n and int(enc._slice[row]) == sid


def test_doctor_details_cleanup_on_remove():
    pair = Pair()
    pair.apply(_node("sick", doctor={"ok": False, "fail": ["iommu"]}))
    pair.apply(_node("fine", doctor={"ok": True}))
    pair.report()
    assert pair.remove("sick")
    assert "sick" not in pair.tenc._doctor_details
    assert pair.report()["doctor"]["failing"] == []


def test_sync_changed_count_under_fingerprint_skips():
    enc = tplan.FleetEncoding()
    nodes = [_node(f"n{i}", observed="on") for i in range(6)]
    assert enc.sync(nodes) == 6
    assert enc.sync(nodes) == 0
    nodes[2] = _node("n2", observed="off")
    assert enc.sync(nodes) == 1
    assert enc.sync(nodes[:-1]) == 1
    assert len(enc) == 5


def test_apply_event_drop_counts():
    enc = tplan.FleetEncoding()
    enc.apply_event("ADDED", {"metadata": {}})
    enc.apply_event("ADDED", {"metadata": {"name": "ok", "labels": {}}})
    enc.apply_event("DELETED", {"metadata": {"name": "ok"}})
    assert enc.events_dropped == 1
    assert len(enc) == 0


def test_policy_scratch_reuses_device_buffers():
    nodes = _mixed_nodes(16)
    pools = [
        ("pool-a", "on",
         [copy.deepcopy(nodes[f"n{i:03d}"]) for i in (1, 2, 3, 4)]),
        ("pool-b", "off",
         [copy.deepcopy(nodes[f"n{i:03d}"]) for i in (8, 9)]),
    ]
    scratch = tplan.PoolScanScratch(device=CPU)
    jscratch = jplan.PoolScanScratch()

    def both(p):
        want = jplan.analyze_pools(p, scratch=jscratch)
        assert want == jplan.analyze_pools(p)
        got = tplan.analyze_pools(p, scratch=scratch)
        assert got == want, VERSIONS
        return got

    both(pools)
    assert scratch.session.stats["column_puts"] == 8
    both(pools)
    retarget = [("pool-a", "off", pools[0][2]), pools[1]]
    both(retarget)
    shrunk = [("pool-a", "off", pools[0][2][:2]), pools[1]]
    both(shrunk)
    assert scratch.session.stats["column_puts"] == 8
    assert scratch.session.stats == jscratch.session.stats


def test_shard_edge_rows_verify_exactly():
    """Dirty rows at every position of the block, the padding-adjacent
    last live row included, verify against K1 on the resident block."""
    nodes = {f"n{i:03d}": _node(f"n{i:03d}", slice_id=f"s{i // 8}")
             for i in range(63)}
    pair = Pair(nodes)
    pair.report()
    for i in range(63):
        pair.apply(_flip(nodes, f"n{i:03d}", "off" if i % 2 else "failed"))
        if i % 8 == 7 or i == 62:
            pair.report(force_full=True)
    assert pair.tsess.stats["verifies"] == pair.jsess.stats["verifies"] == 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_churn_stays_in_lockstep(seed):
    """Random applies, adds, removes and slice moves; a report after
    every step, a verifying full tick every fifth."""
    rng = np.random.default_rng(seed)
    states = ["on", "off", "devtools", "failed"]
    now = int(time.time())
    nodes = {}
    pair = Pair(full_every=7)
    for step in range(40):
        op = rng.integers(4)
        name = f"n{int(rng.integers(90)):03d}"
        if op == 0 and name in nodes:
            pair.remove(name)
            del nodes[name]
        else:
            ev = None
            if rng.random() < 0.5:
                ev = time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime(
                    now - int(rng.choice([60, 9000]))))
            nodes[name] = _node(
                name, desired=states[rng.integers(3)],
                observed=states[rng.integers(4)],
                slice_id=(f"s{int(rng.integers(12))}"
                          if rng.random() < 0.7 else None),
                taint=bool(rng.random() < 0.2),
                doctor=({"ok": bool(rng.random() < 0.7), "fail": ["x"]}
                        if rng.random() < 0.6 else None), ev=ev)
            pair.apply(nodes[name])
        pair.report(force_full=(step % 5 == 4))
    assert pair.tsess.stats == pair.jsess.stats
    assert pair.tsess.last_checksum == pair.jsess.last_checksum
