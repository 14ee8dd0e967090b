"""The port's sharded control plane (``shard.py``) held to the reference's.

The 18 cases of tests/test_shard.py run on both packages
(``tests/torch_mirror.py``) on a one-shard planner: every assertion holds
on each side, and what each case leaves behind must be equal on the two
sides, the state of every ``ShardManager`` when the case stopped it
included (its ring partition, coverage and failover log, the pools each
live shard holds, each shard lease's holder and transitions). The cases
that reach the planner run again at 8 planner shards in
tests/test_torch_shard_mesh.py; the port plans on the CPU
(``TPU_CC_TORCH_DEVICE=cpu``), where its kernels run their plain
versions.

No mirrored case binds a fixed port: every ``ShardManager``, its
controllers and the cases' own ``FleetController`` bind port 0, and the
mirror refuses a bind to any default port (``FIXED_PORTS``).

Beyond the cases: ``HashRing`` placement on both packages over 1 024
seeded keys, with and without region tags, at several vnode counts;
and the port's shards over a seeded fleet, whose scans summed must equal
one unsharded scan of the whole fleet, which must equal the reference's.
"""

import copy
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_shard  # noqa: E402
import tpu_cc_manager.fleet as jfleet  # noqa: E402
import tpu_cc_manager.k8s.fake as jfake  # noqa: E402
import tpu_cc_manager.shard as jshard  # noqa: E402
import tpu_cc_manager_torch.fleet as tfleet  # noqa: E402
import tpu_cc_manager_torch.k8s.fake as tfake  # noqa: E402
import tpu_cc_manager_torch.policy as tpolicy  # noqa: E402
import tpu_cc_manager_torch.rollout as trollout  # noqa: E402
import tpu_cc_manager_torch.shard as tshard  # noqa: E402
from torch_mirror import (  # noqa: E402
    FIXED_PORTS, at_shards, both, cases, no_fixed_ports, planner_calls,
    port_twin, threads_ended,
)
from test_torch_plan import _fleet  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_shard, port_twin("test_shard"))

#: the cases that never reach the planner (the ring, the informer, the
#: scoped client, the fake's watch history and wire fan-out, a
#: controller's wake filter without a scan); every other case scans
#: (a ``FleetController`` of its own, or a ``ShardManager``'s shards)
#: and runs at 8 planner shards too. The test holds this true.
OFF_PLANNER = frozenset({
    "test_cluster_events_are_bounded",
    "test_informer_fed_controller_wakes_fingerprint_filtered",
    "test_informer_relists_through_410",
    "test_informer_resumes_from_list_rv_no_gap",
    "test_informer_serves_reads_from_watch_fed_cache",
    "test_informer_wake_fires_on_relist_and_events_fan_out",
    "test_ring_is_deterministic_and_total",
    "test_ring_rejects_empty_and_duplicates",
    "test_ring_without_moves_only_the_removed_members_keys",
    "test_scoped_client_filters_nodes_and_customs_writes_pass_through",
    "test_watch_history_compaction_is_chunked_and_bounded",
    "test_wire_watch_fans_out_over_http",
    "test_wire_watch_matches_clientset_watch_and_caches_encoding",
})
PLANNER = frozenset(p.values[0] for p in cases(test_shard)) - OFF_PLANNER

#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` (``MIRROR_FILES=shard``,
#: 4 copies at once on 8 cores, 10 runs each) found no case of this
#: file leaving a state that differs from itself in 40 runs (PERF.md
#: §6); a case joins only with that evidence. In 4 of 80 runs each,
#: ``test_shard_kill_survivor_reacquires_partition`` and
#: ``test_shard_restart_rejoins_as_standby_without_preemption`` raised
#: "cannot join thread before it is started" in ``kill_host`` instead
#: (the reference's stop-during-start race, ROADMAP Queue 3): an
#: exception is never masked, so such a run fails here as it fails in
#: test_shard.py.
RACY = {}

#: the port's planner entry points the controllers bound at import
ENTRY_POINTS = [(tfleet, "analyze_encoding"), (tpolicy, "analyze_pools"),
                (trollout, "analyze_fleet")]


def prepare(mp, shards=1):
    """A mirrored case's surroundings: the port plans on the CPU at
    ``shards`` planner shards; no fixed port may be bound."""
    mp.setenv(tplan.DEVICE_ENV, "cpu")
    mp.setenv(tplan.MESH_ENV, str(shards))
    return no_fixed_ports(mp)


def run_mirrored(mods, planner, racy, name, params, shards, request,
                 tmp_path, monkeypatch, view=None):
    """One mirrored case at ``shards`` planner shards: both sides equal
    (as ``view`` shows them, when given; see ``torch_mirror.both``), the
    planner reached exactly when ``planner`` says, no fixed port."""
    bound = prepare(monkeypatch, shards)
    with planner_calls(monkeypatch, ENTRY_POINTS) as calls, \
            threads_ended() as left:
        both(mods, name, params, request, tmp_path, VERSIONS, racy, view)
    assert not left, f"{name} left threads running: {left}"
    assert bool(calls) == (name in planner), (
        f"{name} {'reaches' if calls else 'does not reach'} the port's "
        "planner: OFF_PLANNER must say so")
    assert not FIXED_PORTS & set(bound), bound


@pytest.mark.parametrize("name,params,shards", at_shards(cases(test_shard), 1))
def test_shard_case_on_both_packages(name, params, shards, request,
                                     tmp_path, monkeypatch):
    run_mirrored(MODS, PLANNER, RACY, name, params, shards, request,
                 tmp_path, monkeypatch)


# ------------------------------------------------------- the ring itself


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return [f"pool-{rng.integers(1 << 40):x}-{i}" for i in range(n)]


@pytest.mark.parametrize("vnodes", [1, 8, 64])
@pytest.mark.parametrize("regions", [0, 2, 3])
def test_ring_places_every_key_as_the_reference_does(vnodes, regions):
    """``HashRing`` on both packages over 1 024 seeded keys: the same
    owner for every key (plainly and pinned to each region), the same
    partition, and the same owners once a member is removed."""
    members = [f"r{k % max(regions, 1)}/shard-{k}" for k in range(6)]
    tags = {m: m.split("/")[0] for m in members} if regions else None
    keys = _keys(1024, seed=vnodes * 10 + regions)
    rings = [mod.HashRing(members, vnodes=vnodes, regions=tags)
             for mod in (jshard, tshard)]
    region_names = sorted(set(tags.values())) if tags else []
    for want, got in [(rings[0], rings[1]),
                      (rings[0].without(members[1]),
                       rings[1].without(members[1]))]:
        assert [got.owner_of(k) for k in keys] == [
            want.owner_of(k) for k in keys]
        for region in region_names + ["nowhere"]:
            assert [got.owner_of(k, region=region) for k in keys] == [
                want.owner_of(k, region=region) for k in keys], region
            assert got.members_in(region) == want.members_in(region)
        assert got.partition(keys) == want.partition(keys)
    assert len(set(rings[1].owner_of(k) for k in keys)) == len(members)


# ------------------------------------------- the shards' scans, summed


def _sharded_fleet(fake, nodes, n_pools):
    kube = fake.FakeKube()
    for i, node in enumerate(nodes):
        node = copy.deepcopy(node)
        node["metadata"]["labels"][L.TPU_ACCELERATOR_LABEL] = "tpu-v5p-slice"
        node["metadata"]["labels"][test_shard.POOL_LABEL] = f"p{i % n_pools}"
        kube.add_node(node)
    return kube


def _counts(report):
    return {"nodes": report["nodes"], "divergent": len(report["needs_flip"]),
            "failed": len(report["failed"]),
            "mode_counts": report["mode_counts"]}


def _sum(reports):
    out = {"nodes": 0, "divergent": 0, "failed": 0, "mode_counts": {}}
    for r in map(_counts, reports):
        for key in ("nodes", "divergent", "failed"):
            out[key] += r[key]
        for mode, n in r["mode_counts"].items():
            out["mode_counts"][mode] = out["mode_counts"].get(mode, 0) + n
    return out


@pytest.mark.parametrize("shards", [2, 4])
def test_shard_scans_sum_to_one_scan_and_to_the_reference(shards,
                                                          monkeypatch):
    """A seeded fleet of 2 000 nodes in 8 pools behind the port's
    ``ShardManager`` at ``shards`` shards: the shards' scan reports
    summed (nodes, divergent, failed, per-mode counts) equal one
    unsharded port scan of the whole fleet, and that scan equals the
    reference's, list for list."""
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    monkeypatch.setenv(tplan.MESH_ENV, "1")
    bound = no_fixed_ports(monkeypatch)
    nodes = _fleet(2000, seed=shards)
    kube = _sharded_fleet(tfake, nodes, 8)
    # the default lease settings: 0.4 s leases lapse under a loaded
    # host, and a stop that meets a shard's controllers still starting
    # raises (the stop-during-start race, ROADMAP Queue 3)
    port_mgr = tshard.ShardManager(
        lambda: kube, shards=shards, pools=[f"p{k}" for k in range(8)],
        pool_label=test_shard.POOL_LABEL, fleet_interval_s=0.2)
    port_mgr.start()
    try:
        assert port_mgr.wait_covered(timeout_s=30)
        # each shard's report from its own scan loop: a scan called from
        # here would race the loop's scans on the controller's encoding
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            bundles = port_mgr.bundles()
            if len(bundles) == shards and all(b.fleet.last_report
                                              for b in bundles):
                break
            time.sleep(0.05)
        shard_reports = [b.fleet.last_report for b in bundles]
        assert sorted(b.shard_id for b in bundles) == sorted(
            port_mgr.shard_ids)
    finally:
        port_mgr.stop()
    whole = tfleet.FleetController(kube, port=0).scan_once()
    assert _sum(shard_reports) == _counts(whole)
    ref = jfleet.FleetController(_sharded_fleet(jfake, nodes, 8),
                                 port=0).scan_once()
    for key in ("nodes", "needs_flip", "failed", "flipping", "mode_counts",
                "incoherent_slices", "half_flipped_slices",
                "stale_evidence", "doctor"):
        assert whole[key] == ref[key], (key, VERSIONS)
    assert not FIXED_PORTS & set(bound), bound


# ----------------------- a fault both packages share (ROADMAP Queue 3)


def _resync_over_a_stale_list(pkg):
    """An informer-fed ``FleetController`` whose reconciling scan lists
    the nodes, and then, before it reconciles its encoding with that
    list, the informer feeds it a newer write of one node: the scan
    writes the listed (older) state back, and the next scan, trusting
    the feed, keeps it. Returns both scans' ``needs_flip``."""
    import importlib

    labels = importlib.import_module(f"{pkg}.labels")
    fleet = importlib.import_module(f"{pkg}.fleet")
    fake = importlib.import_module(f"{pkg}.k8s.fake")
    objects = importlib.import_module(f"{pkg}.k8s.objects")
    watch = importlib.import_module(f"{pkg}.watch")
    state = labels.CC_MODE_STATE_LABEL
    kube = fake.FakeKube()
    for i in range(4):
        kube.add_node(objects.make_node(f"n{i}", labels={
            labels.TPU_ACCELERATOR_LABEL: "tpu-v5p-slice",
            labels.CC_MODE_LABEL: "on", state: "on"}))
    informer = watch.NodeInformer(kube, name="stale")
    informer.prime()
    ctrl = fleet.FleetController(watch.InformerKubeClient(informer, kube),
                                 port=0, informer=informer)
    # wired as run() wires it, without the loop
    ctrl._informer_token = informer.subscribe(
        on_event=ctrl._on_informer_event,
        on_wake=ctrl._informer_gap_wake)
    ctrl._delta_feed_active = True
    informer.start()
    try:
        assert ctrl.scan_once()["needs_flip"] == []
        listed = ctrl.kube.list_nodes

        def list_then_write(*a, **kw):
            out = listed(*a, **kw)
            kube.set_node_labels("n1", {state: "off"})
            deadline = time.monotonic() + 10
            while (informer.get_node("n1")["metadata"]["labels"][state]
                   != "off" and time.monotonic() < deadline):
                time.sleep(0.01)
            time.sleep(0.1)  # the subscribers' fan-out follows the cache
            return out

        ctrl.kube.list_nodes = list_then_write
        ctrl._resync_needed = True
        stale = ctrl.scan_once()["needs_flip"]
        ctrl.kube.list_nodes = listed
        return stale, ctrl.scan_once()["needs_flip"]
    finally:
        ctrl.stop()
        informer.stop()


def test_a_reconciling_scan_over_a_stale_list_hides_a_fed_write(
        monkeypatch):
    """Both packages lose node n1's divergence (desired on, state off)
    when the scan that reconciles its encoding took its list before the
    informer fed it n1's write, and keep it lost until the next
    reconciling scan (every ``TPU_CC_FLEET_SYNC_EVERY`` scans). This
    pins the port to the reference's behaviour; the fix belongs to both
    packages at once (ROADMAP Queue 3), and then this test changes."""
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    monkeypatch.setenv(tplan.MESH_ENV, "1")
    want = _resync_over_a_stale_list("tpu_cc_manager")
    got = _resync_over_a_stale_list("tpu_cc_manager_torch")
    assert got == want == ([], []), (got, want, VERSIONS)
