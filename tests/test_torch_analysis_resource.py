"""The port's analyzer held to the reference's on the v6 resourceflow families.

The 57 cases of tests/test_analysis_resource.py run on both packages
(``tests/torch_mirror.py``), the port's twin with the analyzer copies'
path rewrite (tests/test_torch_analysis.py says why): every assertion
must hold on each side.
"""

import pytest

import test_analysis_resource  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

#: the cases the port must see differently, each with its reason
EDITS = (
    ("the fact-cache fixtures build their package directory by its bare "
     "name, which the path rewrite leaves alone; their relpaths name the "
     "port's package, so the directory does too",
     'pkg = tmp_path / "tpu_cc_manager"\n',
     'pkg = tmp_path / "tpu_cc_manager_torch"\n'),
)

MODS = (test_analysis_resource,
        port_twin("test_analysis_resource", EDITS, paths=True))


@pytest.mark.parametrize("name,params", [
    pytest.param(*p.values, id=p.id) for p in cases(test_analysis_resource)])
def test_resource_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, "ccaudit")
