"""The port's evidence (``evidence.py``) held to the reference's, over the
port's sysfs backend (``device/gpu.py``) on a PCI tree.

The 18 cases of tests/test_evidence.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and what
each side records must be equal: the nodes, Events and batcher writes of
every ``FakeKube``, and (``tests/torch_pci_tree.py``) the evidence
documents the case builds, verifies and audits, the attestation and
identity verdicts, the engine calls and every statefile. A device's path,
name and ``device_id`` are compared by index, because ``/dev/accel0`` and
``/dev/nvidia0`` differ by name only; the statefile digest, a hash over
the device paths, is compared within each side by the case's own
assertions. The port's fleet controller plans on the CPU
(``TPU_CC_TORCH_DEVICE=cpu``).

Named edits: ``_sysfs_backend`` builds the PCI twin
(``torch_pci_tree.make_pci_tree``) and the port's backend over it, and
the switch case adds an NVSwitch function (class ``0x068000``) where the
reference adds a device of ``kind`` ``ici-switch``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_evidence  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_evidence, port_twin("test_evidence", edits=[
    pci.BACKEND_IMPORT,
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
    ("an NVSwitch function in place of the ici-switch device",
     '''    d = tmp_path / "sysfs" / "sw0" / "device"
    d.mkdir(parents=True)
    (d / "vendor").write_text("0x1ae0\\n")
    (d / "device").write_text("0x00ff\\n")
    (d / "kind").write_text("ici-switch\\n")
    (tmp_path / "dev" / "sw0").write_text("")
''', '''    add_pci_function(tmp_path / "sysfs", "0000:c0:00.0", device_id="0x22a3",
                     klass="0x068000")
'''),
]))


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` found no case of this file
#: that differs from its first run (PERF.md §6).
RACY = {}
#: what the self-check records and compares, as the test does
CALLS, _view = pci.CALLS, pci.view


@pytest.mark.parametrize("name,params", cases(test_evidence))
def test_evidence_case_on_both_packages(name, params, request, tmp_path,
                                        monkeypatch):
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY,
         view=_view, calls=CALLS)
