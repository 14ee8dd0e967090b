"""The port's doctor (``doctor.py``) held to the reference's.

The 15 cases of tests/test_doctor.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and what
each side records must be equal: the doctor reports, the nodes of every
``FakeKube`` with their evidence, and (``tests/torch_pci_tree.py``) the
evidence documents, verdicts and engine calls of the case and every
statefile.

The reference runs on its ``SysfsTpuBackend`` over a scratch accel tree;
the port runs on its ``SysfsGpuBackend`` (``device/gpu.py``) over the PCI
twin of that tree (``torch_pci_tree.make_pci_tree``), through named edits
of the reference's text: ``_backend`` builds the twin, and the cases that
name a device's devfs node name ``nvidia0`` for ``accel0``. The three
cases that judge devfs gate permissions (``gating="chmod"``) judge the
real gate on both sides: each backend's devfs nodes are scratch files the
gate chmods. A device's path, name and ``device_id`` are compared by
index, because ``/dev/accel0`` and ``/dev/nvidia0`` differ by name only;
the statefile digest, a hash over the device paths, is compared within
each side by the case's own assertions.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_doctor  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_doctor, port_twin("test_doctor", edits=[
    pci.BACKEND_IMPORT,
    ("the PCI twin in place of the accel tree", '''    sysfs = tmp_path / "sysfs"
    dev = tmp_path / "dev"
    dev.mkdir(exist_ok=True)
    for i in range(n):
        d = sysfs / f"accel{i}" / "device"
        d.mkdir(parents=True)
        (d / "vendor").write_text("0x1ae0\\n")
        (d / "device").write_text("0x0063\\n")
        (dev / f"accel{i}").write_text("")
''', '''    sysfs, dev = make_pci_tree(tmp_path, n=n)
'''),
    ("the GPU's devfs node", 'f"{tmp_path}/dev/accel0"',
     'f"{tmp_path}/dev/nvidia0"', 4),
]))


@pytest.mark.parametrize("name,params", cases(test_doctor))
def test_doctor_case_on_both_packages(name, params, request, tmp_path):
    got = both(MODS, name, params, request, tmp_path, VERSIONS,
               view=pci.view, calls=pci.CALLS)
    assert got["doctor_reports"], "the case ran no doctor"
