"""The scenario lab's SLO drills (tests/test_slo_sim.py) on both packages.

The 2 cases run on both packages (``tests/torch_mirror.py``): a
``write_429`` storm that must burn the flip-success budget and fire its
alert, and a clean run that must burn none. Neither lab runs a
controller, so neither reaches the planner. Each is compared on what
its schedule fixes, as tests/test_torch_simlab.py sets out (its
``lab_view``, and the keys it masks): the burn rates,
budgets and alerts themselves move with scrape timing and are held by
the cases' own assertions on each side.

The reference module's autouse fixture (scrapes every 0.25 s,
``TPU_CC_FLEETOBS_INTERVAL_S``) does not reach this file's tests; each
mirrored case sets it the same way (``prepare``).
"""

import pytest

torch = pytest.importorskip("torch")

import test_slo_sim  # noqa: E402
from test_torch_simlab import (  # noqa: E402,F401
    mirror_params, mirror_view, run_simlab_case,
)
from torch_mirror import cases, port_twin  # noqa: E402

MODS = (test_slo_sim, port_twin("test_slo_sim"))

PLANNER = frozenset()

#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` (``MIRROR_FILES=slo_sim``)
#: found no case of this file leaving a view that differs from itself
#: (PERF.md §6); a case joins only with that evidence.
RACY = {}


def prepare(mp):
    """The reference module's autouse ``_fast_scrapes``."""
    mp.setenv("TPU_CC_FLEETOBS_INTERVAL_S", "0.25")


@pytest.mark.parametrize("name,params,shards",
                         mirror_params(test_slo_sim, PLANNER))
def test_slo_case_on_both_packages(name, params, shards, request, tmp_path,
                                   monkeypatch):
    prepare(monkeypatch)
    run_simlab_case(MODS, PLANNER, RACY, name, params, shards, request,
                    tmp_path, monkeypatch)


def test_every_case_is_mirrored():
    assert len(cases(test_slo_sim)) == 2
