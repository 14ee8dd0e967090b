"""The port's independent verify held to the reference's, over the port's
sysfs backend (``device/gpu.py``) on a PCI tree.

The 5 cases of tests/test_verify_independent.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and what
each side records must be equal (``tests/torch_pci_tree.py``): the engine
calls with their return values and span names, and every statefile. A
device's path is compared by index, because ``/dev/accel0`` and
``/dev/nvidia0`` differ by name only. Both sides' chips cross-read
through the same ``tpudevctl`` binary (``native/``, built by ``make``)
when the case installs it, and through the other store implementation
otherwise.

Named edits: ``_sysfs_env`` builds the PCI twin
(``torch_pci_tree.make_pci_tree``) and the port's backend over it, and
``find_tpudevctl`` is the port's (``device/gpu.py``).
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_verify_independent  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_verify_independent, port_twin("test_verify_independent", edits=[
    ("the port's sysfs backend over the PCI twin tree, and its "
     "find_tpudevctl",
     "from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend, "
     "find_tpudevctl\n",
     "from tpu_cc_manager_torch.device.gpu import find_tpudevctl\n"
     "from torch_pci_tree import make_pci_tree\n"
     "from torch_pci_tree import twin_backend as SysfsTpuBackend\n"),
    ("the PCI twin in place of the accel tree", '''    sysfs = tmp_path / "sysfs"
    dev = tmp_path / "dev"
    dev.mkdir()
    for i in range(n):
        d = sysfs / f"accel{i}" / "device"
        d.mkdir(parents=True)
        (d / "vendor").write_text("0x1ae0\\n")
        (d / "device").write_text("0x0063\\n")
        (dev / f"accel{i}").write_text("")
''', '''    sysfs, dev = make_pci_tree(tmp_path, n=n)
'''),
]))


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` found no case of this file
#: that differs from its first run (PERF.md §6).
RACY = {}
#: what the self-check records and compares, as the test does
CALLS, _view = pci.CALLS, pci.view


@pytest.mark.parametrize("name,params", cases(test_verify_independent))
def test_verify_independent_case_on_both_packages(name, params, request,
                                                  tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY,
         view=_view, calls=CALLS)
