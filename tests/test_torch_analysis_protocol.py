"""The port's analyzer held to the reference's on the v2 protocol families and
the manifest cross-check.

The 61 cases of tests/test_analysis_protocol.py run on both packages
(``tests/torch_mirror.py``), the port's twin with the analyzer copies'
path rewrite (tests/test_torch_analysis.py says why): every assertion
must hold on each side.
"""

import pytest

import test_analysis_protocol  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

#: the cases the port must see differently, each with its reason
EDITS = ()

MODS = (test_analysis_protocol,
        port_twin("test_analysis_protocol", EDITS, paths=True))


@pytest.mark.parametrize("name,params", [
    pytest.param(*p.values, id=p.id) for p in cases(test_analysis_protocol)])
def test_protocol_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, "ccaudit")
