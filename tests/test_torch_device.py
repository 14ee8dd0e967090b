"""The port's device layer held to the reference's, with the sysfs backend
(``device/gpu.py``) over a PCI tree in place of the accel tree.

The 13 cases of tests/test_device.py run on both packages
(``tests/torch_mirror.py``): every assertion holds on each side, and what
each side records must be equal: the engine calls, the evidence
documents and every statefile under the case's scratch directory
(``tests/torch_pci_tree.py``). A device's path, name and ``device_id``
are compared by index, because ``/dev/accel0`` and ``/dev/nvidia0``
differ by name only.

Named edits turn the reference's text into the port's:

- ``make_accel_tree`` builds the PCI twin (``torch_pci_tree.make_pci_tree``)
  under the same directory name; a switch of ``kind`` ``ici-switch``
  becomes an NVSwitch function (class ``0x068000``);
- the case that skips a foreign vendor swaps the two vendor ids: NVIDIA's
  ``0x10de`` is the port's own, Google's ``0x1ae0`` the foreign one;
- the H100's id and name stand where the v5p's do, the allowlist case's
  ids are GPU ids, and the devfs paths are ``nvidia<i>``;
- the health attribute lives in the function's own directory
  (``<sysfs>/<bdf>/health``), not under ``accel<i>/``.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import test_device  # noqa: E402
import torch_pci_tree as pci  # noqa: E402
from torch_mirror import both, cases, port_twin  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

MODS = (test_device, port_twin("test_device", edits=[
    pci.BACKEND_IMPORT,
    ("the PCI twin in place of the accel tree",
     '''def make_accel_tree(root, n=2, vendor="0x1ae0", device_id="0x0063", kinds=None):
    sysfs = root / "sys_class_accel"
    dev = root / "dev"
    dev.mkdir(exist_ok=True)
    for i in range(n):
        d = sysfs / f"accel{i}" / "device"
        d.mkdir(parents=True)
        (d / "vendor").write_text(vendor + "\\n")
        (d / "device").write_text(device_id + "\\n")
        if kinds and kinds[i]:
            (d / "kind").write_text(kinds[i] + "\\n")
        (dev / f"accel{i}").write_text("")  # stand-in for the char device
    return str(sysfs), str(dev)''',
     '''def make_accel_tree(root, n=2, vendor="0x10de", device_id="0x2330", kinds=None):
    return make_pci_tree(root, n=n, vendor=vendor, device_id=device_id,
                         kinds=kinds, sysfs_name="sys_class_accel")'''),
    ("the devfs nodes are nvidia<i>",
     'assert [c.path for c in chips] == [dev + f"/accel{i}" for i in range(3)]',
     'assert [c.path for c in chips] == [dev + f"/nvidia{i}" for i in range(3)]'),
    ("the H100's name", 'assert all(c.name == "tpu-v5p" for c in chips)',
     'assert all(c.name == "h100-sxm5-80gb" for c in chips)'),
    ("Google's vendor id is the foreign one here",
     'make_accel_tree(tmp_path, n=2, vendor="0x10de")',
     'make_accel_tree(tmp_path, n=2, vendor="0x1ae0")'),
    ("a GPU id outside the allowlist",
     'make_accel_tree(tmp_path, n=2, device_id="0x005e")',
     'make_accel_tree(tmp_path, n=2, device_id="0x20b2")'),
    ("an allowlist of GPU ids", '"CC_CAPABLE_DEVICE_IDS", "0x0063,0x0062"',
     '"CC_CAPABLE_DEVICE_IDS", "0x2330,0x2331"'),
    ("the same id in upper case", '"CC_CAPABLE_DEVICE_IDS", "0x005E"',
     '"CC_CAPABLE_DEVICE_IDS", "0x20B2"'),
    ("the function's own health attribute",
     'tmp_path / "sys_class_accel" / "accel0" / "health"',
     'tmp_path / "sys_class_accel" / "0000:18:00.0" / "health"', 2),
]))


#: cases whose threads race the case's own end, so that the reference
#: differs from itself run to run: case -> (the part compared, why).
#: Empty: ``tests/torch_mirror_selfcheck.py`` found no case of this file
#: that differs from its first run (PERF.md §6).
RACY = {}
#: what the self-check records and compares, as the test does
CALLS, _view = pci.CALLS, pci.view


@pytest.mark.parametrize("name,params", cases(test_device))
def test_device_case_on_both_packages(name, params, request, tmp_path):
    both(MODS, name, params, request, tmp_path, VERSIONS, RACY,
         view=_view, calls=CALLS)
