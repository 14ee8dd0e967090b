"""The port's lifecycle-episode generator, shrinker and invariants oracle
(``simlab/propgen.py``, ``simlab/invariants.py``) held to the reference's.

The 19 cases of tests/test_propgen.py run on both packages
(``tests/torch_mirror.py``) on a one-shard planner, and the cases whose
live episode runs a fleet or policy controller (they reach the planner)
again on 8 planner shards; the port plans on the CPU
(``TPU_CC_TORCH_DEVICE=cpu``). A case that runs a live lab is compared
on what its schedule fixes, as tests/test_torch_simlab.py sets out (its
``lab_view``, and the keys it masks); the rest on
their whole snapshot.

Beyond the cases: the generated episodes for seeds 1 to 8 are the same
text on both packages, canonically formatted, and the shrinker reduces
the synthetic counterexample to the same document on both.
"""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_propgen  # noqa: E402
from test_torch_simlab import (  # noqa: E402,F401
    mirror_params, mirror_view, run_simlab_case,
)
from torch_mirror import PORT, REF, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_propgen, port_twin("test_propgen"))

#: the cases whose live episode runs a fleet or policy controller and so
#: reaches the planner; they run at 8 planner shards too. The test holds
#: this true.
PLANNER = frozenset({
    "test_key_rotation_reverifies_through_live_replicas",
    "test_policy_conflict_parks_rival_through_live_replicas",
    "test_root_revoked_latches_outage_through_live_replicas",
})

#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` (``MIRROR_FILES=propgen``)
#: found no case of this file leaving a view that differs from itself
#: (PERF.md §6); a case joins only with that evidence.
RACY = {}


@pytest.mark.parametrize("name,params,shards",
                         mirror_params(test_propgen, PLANNER))
def test_propgen_case_on_both_packages(name, params, shards, request,
                                       tmp_path, monkeypatch):
    run_simlab_case(MODS, PLANNER, RACY, name, params, shards, request,
                    tmp_path, monkeypatch)


def test_every_case_is_mirrored():
    assert len(cases(test_propgen)) == 19
    assert PLANNER <= {p.values[0] for p in cases(test_propgen)}


def _generated_and_shrunk(side):
    propgen = side.module("simlab.propgen")
    scenario = side.module("simlab.scenario")
    texts = [scenario.canonical_scenario_text(propgen.generate_episode(seed))
             for seed in range(1, 9)]
    for family in propgen.FAMILIES:
        texts.append(scenario.canonical_scenario_text(
            propgen.generate_episode(5, families=[family])))
    # the reference test's synthetic counterexample, built on this side
    twin = MODS[0] if side is REF else MODS[1]
    doc = twin._padded_counterexample()

    def repro(cand):
        scenario.validate_scenario(cand)
        kinds = [a.get("fault") for a in cand["actions"]]
        return "write_429" in kinds and "agent_crash" in kinds

    shrunk, runs = propgen.shrink(doc, repro, seed=7, max_runs=64)
    return texts, scenario.canonical_scenario_text(shrunk), runs


def test_episodes_and_the_shrinker_are_byte_equal_on_both_packages():
    """Seeds 1 to 8 (and seed 5 pinned to each family): the generated
    episodes' canonical text is byte-equal on the two packages, and the
    shrinker reduces the synthetic counterexample to the same document
    in the same number of runs."""
    want = _generated_and_shrunk(REF)
    got = _generated_and_shrunk(PORT)
    assert got == want, VERSIONS
    texts, shrunk, runs = got
    scenario = PORT.module("simlab.scenario")
    names = [scenario.validate_scenario(json.loads(t)).name for t in texts]
    assert names[:8] == [f"gen-{seed}" for seed in range(1, 9)]
    assert '"agent_crash"' in shrunk and '"write_429"' in shrunk
    assert 0 < runs <= 64
