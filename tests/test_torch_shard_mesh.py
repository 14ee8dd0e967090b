"""The mirrored cases of tests/test_torch_shard.py,
tests/test_torch_federation.py and tests/test_torch_fleetobs.py that reach
the planner, again on an 8-shard planner (``TPU_CC_PLANNER_MESH=8``).

They are the expensive half of those files (live shard managers and
federations, leases of 0.4 s), kept in a file of their own so that the
suite's workers (``--dist loadfile``) share the cost.
"""

import pytest

pytest.importorskip("torch")

import test_torch_federation as fed  # noqa: E402
import test_torch_fleetobs as fobs  # noqa: E402
import test_torch_shard as shard  # noqa: E402
from test_torch_shard import run_mirrored  # noqa: E402
from torch_mirror import at_shards, cases  # noqa: E402

FILES = {"shard": shard, "federation": fed, "fleetobs": fobs}


def _params():
    out = []
    for key, mod in FILES.items():
        params = fed.CASES if mod is fed else cases(mod.MODS[0])
        for p in at_shards(params, 8, only=mod.PLANNER):
            out.append(pytest.param(key, *p.values, id=f"{key}-{p.id}"))
    return out


@pytest.mark.parametrize("file,name,params,shards", _params())
def test_planner_case_at_8_shards(file, name, params, shards, request,
                                  tmp_path, monkeypatch):
    mod = FILES[file]
    run_mirrored(mod.MODS, mod.PLANNER, mod.RACY, name, params, shards,
                 request, tmp_path, monkeypatch)
