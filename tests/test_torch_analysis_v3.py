"""The port's analyzer held to the reference's on the v3 whole-program passes,
the CLI and SARIF.

The 45 cases of tests/test_analysis_v3.py run on both packages
(``tests/torch_mirror.py``), the port's twin with the analyzer copies'
path rewrite (tests/test_torch_analysis.py says why): every assertion
must hold on each side.

The twin of ``test_ccaudit_repo_scan_under_ten_seconds`` holds the
port's default-surface scan to the reference's 10 s budget.
"""

import pytest

import test_analysis_v3  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

#: the cases the port must see differently, each with its reason
EDITS = ()

MODS = (test_analysis_v3, port_twin("test_analysis_v3", EDITS, paths=True))


@pytest.mark.parametrize("name,params", [
    pytest.param(*p.values, id=p.id) for p in cases(test_analysis_v3)])
def test_v3_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, "ccaudit")
