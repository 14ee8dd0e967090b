"""The native store's interop with the port's Python side, held to the
reference's, over the port's sysfs backend (``device/gpu.py``) on a PCI
tree.

Two cases of tests/test_native.py drive the Python side of the native
``libtpudev`` store and ``tpudevctl`` (``native/``, built by ``make``):
``test_tpudevctl_state_interop_with_python`` and
``test_python_ctypes_binding_interop``. They run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and what
each side records must be equal (``tests/torch_pci_tree.py``): every
statefile the C++ and Python stores wrote. A device's path is compared by
index, because ``/dev/accel0`` and ``/dev/nvidia0`` differ by name only.
The file's other cases drive the C++ agent and the bash engine, which
take no Python package, and are not mirrored.

Named edits: ``make_accel_tree`` builds the PCI twin
(``torch_pci_tree.make_pci_tree``), the device node is ``nvidia0``, and
the backend is the port's.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_native  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_native, port_twin("test_native", edits=[
    ("the PCI twin in place of the accel tree", '''def make_accel_tree(root, n=2):
    sysfs = root / "sysfs"
    dev = root / "dev"
    dev.mkdir(exist_ok=True)
    for i in range(n):
        d = sysfs / f"accel{i}" / "device"
        d.mkdir(parents=True)
        (d / "vendor").write_text("0x1ae0\\n")
        (d / "device").write_text("0x0063\\n")
        (dev / f"accel{i}").write_text("")
    return str(sysfs), str(dev)''', '''def make_accel_tree(root, n=2):
    from torch_pci_tree import make_pci_tree

    return make_pci_tree(root, n=n)'''),
    ("the GPU's devfs node", 'devpath = dev + "/accel0"',
     'devpath = dev + "/nvidia0"'),
    ("the port's sysfs backend over the PCI twin tree",
     "    from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend\n",
     "    from torch_pci_tree import twin_backend as SysfsTpuBackend\n"),
]))

#: the cases that drive the Python side (see the module docstring)
PYTHON_SIDE = ("test_tpudevctl_state_interop_with_python",
               "test_python_ctypes_binding_interop")


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` found no case of this file
#: that differs from its first run (PERF.md §6).
RACY = {}
#: what the self-check records and compares, as the test does
CALLS, _view = pci.CALLS, pci.view


@pytest.mark.parametrize("name,params", [
    p for p in cases(test_native) if p.values[0] in PYTHON_SIDE])
def test_native_case_on_both_packages(name, params, request, tmp_path):
    got = both(MODS, name, params, request, tmp_path, VERSIONS, RACY,
               view=_view, calls=CALLS)
    assert got["statefiles"], "the case wrote no statefile"
