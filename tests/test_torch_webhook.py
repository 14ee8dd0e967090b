"""The port's admission webhook (``webhook.py``) held to the reference's.

The 21 cases of tests/test_webhook.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and
every admission response (``mutate_pod``, ``validate_pod``, ``review_response``) must be equal on the two sides. The CLI case runs each package's own ``main``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_webhook  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"
MODS = (test_webhook, port_twin("test_webhook"))


@pytest.mark.parametrize("name,params", cases(test_webhook))
def test_webhook_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS)
