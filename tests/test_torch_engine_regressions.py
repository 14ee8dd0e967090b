"""The port's engine regressions held to the reference's, over the port's
sysfs backend (``device/gpu.py``) on a PCI tree.

The 7 cases of tests/test_engine_regressions.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and what
each side records must be equal: the nodes and Events of every
``FakeKube`` (the one-shot CLI's API server included) and
(``tests/torch_pci_tree.py``) the engine calls with their return values
and span names, and every statefile. A device's path is compared by
index, because ``/dev/accel0`` and ``/dev/nvidia0`` differ by name only.

Named edits: the accel tree of tests/test_device.py becomes the PCI twin
(``torch_pci_tree.make_pci_tree``), and the backend over it the port's.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_engine_regressions  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_engine_regressions, port_twin("test_engine_regressions", edits=[
    pci.BACKEND_IMPORT,
    ("the PCI twin in place of the accel tree",
     "from tests.test_device import make_accel_tree\n",
     "from torch_pci_tree import make_pci_tree as make_accel_tree\n"),
]))


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` found no case of this file
#: that differs from its first run (PERF.md §6).
RACY = {}
#: what the self-check records and compares, as the test does
CALLS, _view = pci.CALLS, pci.view


@pytest.mark.parametrize("name,params", cases(test_engine_regressions))
def test_engine_regression_case_on_both_packages(name, params, request,
                                                 tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY,
         view=_view, calls=CALLS)
