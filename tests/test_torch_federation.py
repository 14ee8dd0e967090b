"""The port's federation layer (``federation.py``) held to the reference's.

The 13 cases of tests/test_federation.py run on both packages (``tests/torch_mirror.py``) on a one-shard planner:
every assertion holds on each side, and what each case leaves behind must
be equal on the two sides, the state of every ``FederationManager`` when
the case stopped it included (its ``stats()``, its
``attestation_summary()`` and each region's ``node_read_requests``, with
each region's ``ShardManager``). The cases that reach the planner run
again at 8 planner shards in tests/test_torch_shard_mesh.py; the port
plans on the CPU (``TPU_CC_TORCH_DEVICE=cpu``). Three of the cases test
schema 2 of the scenario lab (``simlab/scenario.py``'s regions), each on
its own package's ``validate_scenario``.
"""

import pytest

torch = pytest.importorskip("torch")

import test_federation  # noqa: E402
from test_torch_shard import run_mirrored  # noqa: E402
from torch_mirror import (  # noqa: E402
    at_shards, cases, port_twin, without_live_leases,
)

MODS = (test_federation, port_twin("test_federation"))

CASES = cases(test_federation)

#: the cases that never reach the planner (the ring, the owner lookup
#: and its errors, posture parsing, trust domains, the audit layer and
#: the scenario schema's regions);
#: the two live federations scan and run at 8 planner shards too. The
#: test holds this true.
OFF_PLANNER = frozenset({
    "test_members_in_and_unknown_region_falls_back_to_global",
    "test_owner_of_is_region_aware_and_rejects_strays",
    "test_posture_from_policy_reads_region_windows",
    "test_region_faults_and_windows_are_schema2_gated_and_checked",
    "test_region_ring_deterministic_and_home_region_pinned",
    "test_region_ring_fails_over_out_of_region_only_when_region_empty",
    "test_region_ring_without_moves_about_one_nth_within_region",
    "test_regions_require_schema_2_and_errors_name_the_source",
    "test_revoked_root_latches_outage_in_that_region_only",
    "test_schema2_regions_validate_and_v1_documents_still_parse",
    "test_trust_domain_rotate_revoke_restore",
})
PLANNER = frozenset(p.values[0] for p in CASES) - OFF_PLANNER

#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Evidence: ``tests/torch_mirror_selfcheck.py`` with
#: ``MIRROR_FILES=shard,federation``, 4 copies at once on 8 cores, 10
#: runs each (PERF.md §6); the other 9 cases never differed in 40
#: runs.
RACY = {
    "test_partitioned_region_defers_posture_write_until_heal": (
        without_live_leases,
        "the blacked-out region's shard leases lapse (their renewals "
        "answer 503) and are taken again after the heal, racing the "
        "case's end: 13 of 80 runs differed from the first, each only "
        "in eu-west/shard-0's coverage when the case stopped "
        "($.federations[0].stats.managers.eu-west.coverage)"),
}


def test_schema2_names_exactly_the_scenario_schema_cases():
    """Every case of tests/test_federation.py is mirrored: the three
    schema-2 cases too, now that the port has the scenario lab."""
    assert len(CASES) == 13
    assert {p.values[0] for p in CASES} == {
        name for name in vars(test_federation) if name.startswith("test_")}


@pytest.mark.parametrize("name,params,shards", at_shards(CASES, 1))
def test_federation_case_on_both_packages(name, params, shards, request,
                                          tmp_path, monkeypatch):
    run_mirrored(MODS, PLANNER, RACY, name, params, shards, request,
                 tmp_path, monkeypatch)
