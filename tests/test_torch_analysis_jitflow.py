"""The port's analyzer held to the reference's on the v5 jitflow families, the
fact cache and the live-surface pins.

The 32 cases of tests/test_analysis_jitflow.py run on both packages
(``tests/torch_mirror.py``), the port's twin with the analyzer copies'
path rewrite (tests/test_torch_analysis.py says why): every assertion
must hold on each side.

On the port the jitflow families find no jitted program, and the live
pins (``test_live_tree_passes_v5_clean``, the ``--files`` slice of
``plan.py``) hold the port's tree under the same rule ids, which the
kernel-launch pass (``analysis/launchflow.py``) reports under too; that
pass has its own tests in tests/test_torch_analysis_launchflow.py.
"""

import pytest

import test_analysis_jitflow  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

#: the cases the port must see differently, each with its reason
EDITS = (
    ("the fact-cache fixtures build their package directory by its bare "
     "name, which the path rewrite leaves alone; their relpaths name the "
     "port's package, so the directory does too",
     'pkg = tmp_path / "tpu_cc_manager"\n',
     'pkg = tmp_path / "tpu_cc_manager_torch"\n', 3),
)

MODS = (test_analysis_jitflow,
        port_twin("test_analysis_jitflow", EDITS, paths=True))


@pytest.mark.parametrize("name,params", [
    pytest.param(*p.values, id=p.id) for p in cases(test_analysis_jitflow)])
def test_jitflow_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, "ccaudit")
