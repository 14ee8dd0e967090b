"""The port's platform identity (``identity.py``) held to the reference's,
over the port's sysfs backend (``device/gpu.py``) on a PCI tree.

The 20 cases of tests/test_identity.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and what
each side records must be equal: the nodes and Events of every
``FakeKube`` and (``tests/torch_pci_tree.py``) the evidence documents
with their identity claims, the identity and attestation verdicts, the
fleet audits, the engine calls and every statefile. A device's path, name
and ``device_id`` are compared by index, because ``/dev/accel0`` and
``/dev/nvidia0`` differ by name only; the statefile digest, a hash over
the device paths, is compared within each side by the case's own
assertions. The port's fleet controller plans on the CPU
(``TPU_CC_TORCH_DEVICE=cpu``).

Named edit: ``_backend`` builds the PCI twin
(``torch_pci_tree.make_pci_tree``, one GPU) and the port's backend over
it.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_identity  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_identity, port_twin("test_identity", edits=[
    ("the port's sysfs backend over the PCI twin tree",
     "    from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend\n",
     "    from torch_pci_tree import make_pci_tree\n"
     "    from torch_pci_tree import twin_backend as SysfsTpuBackend\n"),
    ("the PCI twin in place of the accel tree", '''    sysfs = tmp_path / "sysfs"
    d = sysfs / "accel0" / "device"
    d.mkdir(parents=True)
    (d / "vendor").write_text("0x1ae0\\n")
    (d / "device").write_text("0x0063\\n")
    (tmp_path / "dev").mkdir(exist_ok=True)
    (tmp_path / "dev" / "accel0").write_text("")
''', '''    sysfs, _dev = make_pci_tree(tmp_path, n=1)
'''),
]))


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` found no case of this file
#: that differs from its first run (PERF.md §6).
RACY = {}
#: what the self-check records and compares, as the test does
CALLS, _view = pci.CALLS, pci.view


@pytest.mark.parametrize("name,params", cases(test_identity))
def test_identity_case_on_both_packages(name, params, request, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY,
         view=_view, calls=CALLS)
