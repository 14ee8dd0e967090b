"""The port's sysfs backend (``device/gpu.py``) where it has no reference
case: the PCI scan's class filter, the driver's device minors, the reset
attribute's default, functions the driver does not list, and the
``probe-devices --backend sysfs`` entry point, each on a scratch PCI tree
(``tests/torch_pci_tree.py``).
"""

import json
import os
import stat

import pytest

import torch_pci_tree as pci
from tpu_cc_manager_torch import __main__ as cli
from tpu_cc_manager_torch.device import base as device_base
from tpu_cc_manager_torch.device.base import DeviceError
from tpu_cc_manager_torch.device.gate import MODE_PERMS, DeviceGate
from tpu_cc_manager_torch.device.gpu import (
    SysfsGpuBackend, device_minor,
)
from tpu_cc_manager_torch.device.holders import HolderCheck
from tpu_cc_manager_torch.engine import ModeEngine


@pytest.fixture(autouse=True)
def _fresh_registry(monkeypatch):
    for var in ("TPU_SYSFS_RESET_ATTR", "TPU_SYSFS_HEALTH_ATTR",
                "CC_CAPABLE_DEVICE_IDS", "TPU_CC_DEVICE_BACKEND"):
        monkeypatch.delenv(var, raising=False)
    device_base.set_backend(None)
    yield
    device_base.set_backend(None)


def _backend(tmp_path, n=1, **kw):
    sysfs, dev = pci.make_pci_tree(tmp_path, n=n, **kw)
    return pci.twin_backend(sysfs, dev, str(tmp_path / "state")), sysfs, dev


def _flip(backend, mode, monkeypatch, gating="none"):
    monkeypatch.setenv("TPU_CC_DEVICE_GATING", gating)
    monkeypatch.setenv("TPU_CC_HOLDER_CHECK", "none")
    states = []
    ok = ModeEngine(set_state_label=states.append, backend=backend,
                    evict_components=False).set_mode(mode)
    return ok, states


def test_a_flip_writes_no_reset_attribute_by_default(tmp_path, monkeypatch):
    be, sysfs, _dev = _backend(tmp_path)
    reset = os.path.join(sysfs, pci.bdf(0), "reset")
    with open(reset, "w") as f:
        f.write("")
    assert _flip(be, "on", monkeypatch) == (True, ["on"])
    with open(reset) as f:
        assert f.read() == "", "a flip wrote the PCI reset attribute"
    (chip,), _ = be.find_tpus()
    assert chip.query_cc_mode() == "on"  # committed all the same


def test_a_named_reset_attribute_gets_the_poke(tmp_path, monkeypatch):
    be, sysfs, _dev = _backend(tmp_path)
    reset = os.path.join(sysfs, pci.bdf(0), "reset")
    with open(reset, "w") as f:
        f.write("")
    monkeypatch.setenv("TPU_SYSFS_RESET_ATTR", "reset")
    assert _flip(be, "devtools", monkeypatch) == (True, ["devtools"])
    with open(reset) as f:
        assert f.read() == "1"
    (chip,), _ = be.find_tpus()
    assert chip.query_cc_mode() == "devtools"


def test_a_named_reset_attribute_that_is_absent_is_skipped(tmp_path,
                                                           monkeypatch):
    be, sysfs, _dev = _backend(tmp_path)
    monkeypatch.setenv("TPU_SYSFS_RESET_ATTR", "reset")
    assert _flip(be, "on", monkeypatch) == (True, ["on"])
    assert not os.path.exists(os.path.join(sysfs, pci.bdf(0), "reset"))


def test_a_reset_write_that_fails_is_a_device_error(tmp_path, monkeypatch):
    be, sysfs, _dev = _backend(tmp_path)
    os.mkdir(os.path.join(sysfs, pci.bdf(0), "reset"))  # not writable
    monkeypatch.setenv("TPU_SYSFS_RESET_ATTR", "reset")
    (chip,), _ = be.find_tpus()
    chip.set_cc_mode("on")
    with pytest.raises(DeviceError, match="reset failed"):
        chip.reset()
    assert chip.query_cc_mode() == "off"  # nothing committed


def test_only_gpus_and_switches_of_the_vendor_are_scanned(tmp_path):
    be, sysfs, dev = _backend(tmp_path, n=2)
    # the card's HDMI audio function, a VGA GPU, another vendor's 3D
    # controller, an NVSwitch, and a function with no class attribute
    pci.add_pci_function(sysfs, "0000:18:00.1", device_id="0x22a5",
                         klass="0x040300")
    pci.add_pci_function(sysfs, "0000:40:00.0", device_id="0x2331",
                         klass="0x030000", minor=7, dev_root=dev)
    pci.add_pci_function(sysfs, "0000:50:00.0", vendor="0x1002",
                         device_id="0x740f", klass="0x030200")
    pci.add_pci_function(sysfs, "0000:c0:00.0", device_id=pci.NVSWITCH,
                         klass=pci.SWITCH_CLASS)
    os.unlink(pci.add_pci_function(sysfs, "0000:d0:00.0") / "class")
    chips, err = be.find_tpus()
    assert err is None
    assert [(c.bdf, c.path, c.name, c.device_id) for c in chips] == [
        (pci.bdf(0), f"{dev}/nvidia0", "h100-sxm5-80gb", 0x2330),
        (pci.bdf(1), f"{dev}/nvidia1", "h100-sxm5-80gb", 0x2330),
        ("0000:40:00.0", f"{dev}/nvidia7", "h100-pcie", 0x2331),
    ]
    assert all(c.is_cc_query_supported and c.is_ici_query_supported
               for c in chips)
    (switch,) = be.find_ici_switches()
    assert (switch.bdf, switch.path, switch.name) == (
        "0000:c0:00.0", "pci:0000:c0:00.0", "ici-switch")
    assert switch.is_ici_query_supported and not switch.is_cc_query_supported
    assert switch.sysfs_dir == os.path.join(sysfs, "0000:c0:00.0")


def test_an_unknown_gpu_is_named_gpu_and_capability_is_the_allowlists(
        tmp_path, monkeypatch):
    be, _sysfs, _dev = _backend(tmp_path, device_id="0x20b2")
    (chip,), _ = be.find_tpus()
    assert chip.name == "gpu" and chip.is_cc_query_supported
    monkeypatch.setenv("CC_CAPABLE_DEVICE_IDS", "0x2330")
    (chip,), _ = be.find_tpus()
    assert not chip.is_cc_query_supported
    monkeypatch.setenv("CC_CAPABLE_DEVICE_IDS", "0x2330,bogus")
    chips, err = be.find_tpus()
    assert chips == [] and "CC_CAPABLE_DEVICE_IDS" in err


def test_a_gpu_the_driver_does_not_list_is_keyed_by_its_bdf(tmp_path,
                                                            monkeypatch):
    be, sysfs, dev = _backend(tmp_path, n=1)
    # bound to vfio-pci: no information file, no devfs node
    pci.add_pci_function(sysfs, "0000:60:00.0")
    chips, _ = be.find_tpus()
    assert [c.path for c in chips] == [f"{dev}/nvidia0", "pci:0000:60:00.0"]
    unlisted = chips[1]
    gate = DeviceGate(enabled=True)
    gate.lock_for_flip(unlisted.path)  # no devfs node: nothing to gate
    gate.apply_mode(unlisted.path, "on")
    assert gate.current_perms(unlisted.path) is None
    HolderCheck(enabled=True).ensure_free(unlisted.path)
    unlisted.wait_ready(timeout_s=0.5)
    # the whole flip passes, with the gate on, and gates the listed GPU
    assert _flip(be, "on", monkeypatch, gating="chmod") == (True, ["on"])
    assert [c.query_cc_mode() for c in be.find_tpus()[0]] == ["on", "on"]
    assert stat.S_IMODE(os.stat(f"{dev}/nvidia0").st_mode) == MODE_PERMS["on"]
    # the bdf keys the function's statefile directory
    assert "pci:0000:60:00.0" in os.listdir(tmp_path / "state")


def test_device_minor_reads_the_drivers_information_file(tmp_path):
    pci.make_pci_tree(tmp_path, n=3)
    root = pci.nvidia_proc_root(tmp_path / "sysfs")
    assert [device_minor(root, pci.bdf(i)) for i in range(3)] == [0, 1, 2]
    assert device_minor(root, "0000:ff:00.0") is None
    bad = os.path.join(root, "0000:fe:00.0")
    os.makedirs(bad)
    with open(os.path.join(bad, "information"), "w") as f:
        f.write("Model: \t NVIDIA H100\nDevice Minor: \t ?\n")
    assert device_minor(root, "0000:fe:00.0") is None


def test_a_missing_root_enumerates_nothing(tmp_path):
    be = SysfsGpuBackend(sysfs_root=str(tmp_path / "absent"),
                         dev_root=str(tmp_path), state_dir=str(tmp_path / "s"))
    assert be.find_tpus() == ([], None)
    assert be.find_ici_switches() == []


def _twin_env(monkeypatch, tmp_path):
    sysfs, dev = pci.make_pci_tree(tmp_path, n=2,
                                   kinds=[None, "ici-switch"])
    monkeypatch.setenv("TPU_SYSFS_ROOT", sysfs)
    monkeypatch.setenv("TPU_DEV_ROOT", dev)
    monkeypatch.setenv("TPU_NVIDIA_PROC_ROOT", pci.nvidia_proc_root(sysfs))
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(tmp_path / "state"))
    return sysfs, dev


def test_the_registry_builds_the_backend_from_the_environment(tmp_path,
                                                              monkeypatch):
    _sysfs, dev = _twin_env(monkeypatch, tmp_path)
    monkeypatch.setenv("TPU_CC_DEVICE_BACKEND", "sysfs")
    be = device_base.get_backend()
    assert isinstance(be, SysfsGpuBackend)
    assert [c.path for c in be.find_tpus()[0]] == [f"{dev}/nvidia0"]


def test_probe_devices_backend_sysfs_prints_the_twins_devices(
        tmp_path, monkeypatch, capsys):
    _sysfs, dev = _twin_env(monkeypatch, tmp_path)
    be = SysfsGpuBackend(nvidia_proc_root=os.environ["TPU_NVIDIA_PROC_ROOT"])
    (gpu,), _ = be.find_tpus()
    gpu.set_cc_mode("devtools")
    gpu.reset()
    assert cli.main(["probe-devices", "--backend", "sysfs"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["backend"] == "sysfs" and out["error"] is None
    assert out["devices"] == [
        {"path": f"{dev}/nvidia0", "device_kind": "h100-sxm5-80gb",
         "device_id": 0x2330, "is_ici_switch": False, "cc_capable": True,
         "ici_capable": True, "cc_mode": "devtools", "ici_mode": "off"},
        {"path": f"pci:{pci.bdf(1)}", "device_kind": "ici-switch",
         "device_id": int(pci.NVSWITCH, 16), "is_ici_switch": True,
         "cc_capable": False, "ici_capable": True, "cc_mode": None,
         "ici_mode": "off"},
    ]
    # the override is scoped to the call
    assert "TPU_CC_DEVICE_BACKEND" not in os.environ
