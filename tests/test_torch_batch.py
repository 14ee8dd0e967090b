"""The port's write batcher (``k8s/batch.py``) held to the reference's.

The 10 cases of tests/test_batch.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and the
node each side's ``FakeKube`` ends with, and every document each side's
``NodePatchBatcher`` published, must be equal.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_batch  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
MODS = (test_batch, port_twin("test_batch"))


@pytest.mark.parametrize("name,params", cases(test_batch))
def test_batch_case_on_both_packages(name, params, request, tmp_path):
    got = both(MODS, name, params, request, tmp_path, VERSIONS)
    assert got["kubes"], "the case built no FakeKube"
