"""The port's drain (``drain.py``: the state label, the reconcile Events, the component and node drainers) held to the reference's.

The 14 cases of tests/test_drain.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and
each node's labels, taints and ``spec.unschedulable``, the pods left bound and the Events posted must be equal on the two sides.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_drain  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
MODS = (test_drain, port_twin("test_drain"))


@pytest.mark.parametrize("name,params", cases(test_drain))
def test_drain_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS)
