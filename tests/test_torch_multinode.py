"""The port's agents, many to one API server held to the reference's.

The 3 cases of tests/test_multinode.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and
the labels, annotations, taints and pods of every node, the Events
posted and every value the write batcher published must be equal on the
two sides, but for the parts the cases in ``RACY`` leave to timing.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_multinode  # noqa: E402
from torch_mirror import (  # noqa: E402
    both, cases, port_twin, settled, without_doctor,
)

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
MODS = (test_multinode, port_twin("test_multinode"))


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run (``tests/torch_mirror_selfcheck.py``
#: records where): case -> (the part compared, why)
RACY = {
    "test_pool_wide_reconcile_32_nodes": (
        without_doctor,
        "each agent's idle-tick doctor verdict lands or not before stop"),
    "test_divergent_per_node_policies": (
        without_doctor,
        "each agent's idle-tick doctor verdict lands or not before stop"),
    "test_reconcile_under_pod_churn": (
        settled,
        "pods churn until the case stops the churner, so the pods left "
        "differ, and so does whether a node's state label went through "
        "the write batcher"),
}


@pytest.mark.parametrize("name,params", cases(test_multinode))
def test_multinode_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY)
