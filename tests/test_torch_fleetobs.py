"""The port's fleet observatory (``fleetobs.py``) held to the reference's.

The 16 cases of tests/test_fleetobs.py run on both packages
(``tests/torch_mirror.py``) on a one-shard planner: every assertion holds
on each side, and what each case leaves behind must be equal on the two
sides, every ``FleetObserver``'s alert log (its clock reading ``at``
masked) and the problems of its last merged exposition included. The one
case that scans (``test_fleet_controller_surfaces_observer``, a
``FleetController`` on port 0) runs again at 8 planner shards in
tests/test_torch_shard_mesh.py.

Beyond the cases: ``merge_snapshots`` over the expositions of the port's
controller shards, on both packages, must give the same merged snapshot
and the same rendered exposition, valid, whose node gauge is the fleet's.
"""

import copy

import pytest

torch = pytest.importorskip("torch")

import test_fleetobs  # noqa: E402
import tpu_cc_manager.fleetobs as jfleetobs  # noqa: E402
import tpu_cc_manager_torch.fleetobs as tfleetobs  # noqa: E402
from test_torch_plan import _fleet  # noqa: E402
from test_torch_shard import VERSIONS, run_mirrored  # noqa: E402
from torch_mirror import at_shards, cases, no_fixed_ports, port_twin  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.fleet import FleetController  # noqa: E402
from tpu_cc_manager_torch.k8s.fake import FakeKube  # noqa: E402
from tpu_cc_manager_torch.obs import validate_exposition  # noqa: E402
from tpu_cc_manager_torch.shard import HashRing, ShardScopedClient  # noqa: E402

MODS = (test_fleetobs, port_twin("test_fleetobs"))

#: the one case that scans; the others never reach the planner. The
#: test holds this true.
PLANNER = frozenset({"test_fleet_controller_surfaces_observer"})

#: cases whose threads race the case's own end: none (the observer runs
#: no thread in these cases)
RACY = {}


@pytest.mark.parametrize("name,params,shards",
                         at_shards(cases(test_fleetobs), 1))
def test_fleetobs_case_on_both_packages(name, params, shards, request,
                                        tmp_path, monkeypatch):
    run_mirrored(MODS, PLANNER, RACY, name, params, shards, request,
                 tmp_path, monkeypatch)


@pytest.mark.parametrize("shards", [2, 3])
def test_merge_of_shard_expositions_matches_the_reference(shards,
                                                          monkeypatch):
    """The port's controller shards over a seeded fleet of 2 000 nodes
    in 6 pools, each a ``FleetController`` over its partition (the ring's
    pools, through ``ShardScopedClient``, as ``ControllerShard`` builds
    it); their expositions parsed and merged by each package: the same
    snapshot, the same text, valid, holding the fleet's node count."""
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    no_fixed_ports(monkeypatch)
    kube = FakeKube()
    for i, node in enumerate(_fleet(2000, seed=40 + shards)):
        node = copy.deepcopy(node)
        node["metadata"]["labels"][L.TPU_ACCELERATOR_LABEL] = "tpu-v5p-slice"
        node["metadata"]["labels"]["pool"] = f"p{i % 6}"
        kube.add_node(node)
    ring = HashRing([f"shard-{k}" for k in range(shards)])
    texts = []
    for members in ring.partition([f"p{k}" for k in range(6)]).values():
        scoped = ShardScopedClient(kube, node_filter=lambda n, m=frozenset(
            members): n["metadata"]["labels"].get("pool") in m)
        ctrl = FleetController(scoped, port=0)
        ctrl.scan_once()
        texts.append(ctrl.metrics.render())
    merged = []
    for fleetobs in (jfleetobs, tfleetobs):
        parsed = [fleetobs.parse_exposition(t) for t in texts]
        helps = {}
        for _, h in parsed:
            helps.update(h)
        snap = fleetobs.merge_snapshots([s for s, _ in parsed])
        merged.append((snap, fleetobs.render_snapshot(snap, helps)))
    assert merged[1] == merged[0], VERSIONS
    snap, text = merged[1]
    assert validate_exposition(text) == []
    assert snap["tpu_cc_fleet_nodes"]["series"][""] == 2000
