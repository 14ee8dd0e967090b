"""The PCI-tree twin of the reference tests' accel tree, for the port's
sysfs backend (``tpu_cc_manager_torch/device/gpu.py``), and what the
mirrors over it compare.

The reference's tests build ``<sysfs>/accel<i>/device/{vendor,device}``
with Google's vendor id and ``<dev>/accel<i>``. Their twins build what
the port's backend scans on a card's host:

- ``<sysfs>/<bdf>/{vendor,device,class}``: NVIDIA's vendor id, the H100
  SXM's device id and the 3D-controller class (``0x030200``), or the
  NVSwitch class (``0x068000``) where the reference builds a device of
  ``kind`` ``ici-switch``;
- the NVIDIA driver's ``<root>/proc_driver_nvidia_gpus/<bdf>/information``
  with the GPU's ``Device Minor``, beside the sysfs root;
- ``<dev>/nvidia<minor>``, the stand-in for the character device.

GPU ``i`` gets bdf ``0000:<0x18 + i>:00.0`` and minor ``i``, so it sorts
and indexes as the reference's ``accel<i>`` does. A switch has no devfs
node: its path is ``pci:<bdf>``.

The mirrors of the tests that build these trees record, beyond
``tests/torch_mirror.py``'s snapshot, the calls in ``CALLS`` the case
makes from its own thread (the evidence documents, attestation and
identity verdicts and engine return values, each engine call with the
names of the spans it finished) and every statefile under the case's
scratch directory. ``by_index`` then names each device by its index:
``<tmp>/dev/accel0`` and ``<tmp>/dev/nvidia0`` differ by name only, and
so do the two sides' device names and ids. The statefile digest is a
hash over the device paths, so it is compared within each side (by the
case's own assertions), not across.
"""

from __future__ import annotations

import base64
import json
import os
import pathlib
import re
from typing import Optional

NVIDIA = "0x10de"
H100_SXM = "0x2330"
#: an NVSwitch's device id, for the switch twin
NVSWITCH = "0x22a3"
GPU_CLASS = "0x030200"
SWITCH_CLASS = "0x068000"
#: the driver's gpus directory, beside the twin's sysfs root
NVIDIA_PROC_DIR = "proc_driver_nvidia_gpus"


def bdf(i: int) -> str:
    return f"0000:{0x18 + i:02x}:00.0"


def nvidia_proc_root(sysfs_root) -> str:
    return os.path.join(os.path.dirname(str(sysfs_root)), NVIDIA_PROC_DIR)


def add_pci_function(sysfs_root, address: str, *, vendor: str = NVIDIA,
                     device_id: str = H100_SXM, klass: str = GPU_CLASS,
                     minor: Optional[int] = None,
                     dev_root=None) -> pathlib.Path:
    """One function under ``sysfs_root``; with ``minor``, the driver's
    information file for it and, under ``dev_root``, its devfs node."""
    d = pathlib.Path(sysfs_root) / address
    d.mkdir(parents=True)
    (d / "vendor").write_text(vendor + "\n")
    (d / "device").write_text(device_id + "\n")
    (d / "class").write_text(klass + "\n")
    if minor is not None:
        info = pathlib.Path(nvidia_proc_root(sysfs_root)) / address
        info.mkdir(parents=True)
        (info / "information").write_text(
            "Model: \t\t NVIDIA H100 80GB HBM3\n"
            f"Bus Location: \t {address}\n"
            f"Device Minor: \t {minor}\n"
            "GPU Excluded:\t No\n")
        if dev_root is not None:
            (pathlib.Path(dev_root) / f"nvidia{minor}").write_text("")
    return d


def make_pci_tree(root, n: int = 2, vendor: str = NVIDIA,
                  device_id: str = H100_SXM, kinds=None,
                  sysfs_name: str = "sysfs"):
    """``n`` functions under ``root/<sysfs_name>`` (GPUs, or NVSwitches
    where ``kinds[i]`` is ``ici-switch``) and ``root/dev``; returns the
    two roots as strings, as the reference's ``make_accel_tree`` does."""
    root = pathlib.Path(root)
    sysfs, dev = root / sysfs_name, root / "dev"
    sysfs.mkdir(parents=True, exist_ok=True)
    dev.mkdir(exist_ok=True)
    for i in range(n):
        if kinds and kinds[i] == "ici-switch":
            add_pci_function(sysfs, bdf(i), vendor=vendor,
                             device_id=NVSWITCH, klass=SWITCH_CLASS)
        else:
            add_pci_function(sysfs, bdf(i), vendor=vendor,
                             device_id=device_id, minor=i, dev_root=dev)
    return str(sysfs), str(dev)


def twin_backend(sysfs_root=None, dev_root=None, state_dir=None):
    """The port's sysfs backend over a twin tree, reading the driver's
    information files beside the tree's sysfs root."""
    from tpu_cc_manager_torch.device.gpu import SysfsGpuBackend

    return SysfsGpuBackend(
        sysfs_root=sysfs_root, dev_root=dev_root, state_dir=state_dir,
        nvidia_proc_root=nvidia_proc_root(sysfs_root) if sysfs_root else None)


#: the edit every twin makes to its import of the reference's backend
BACKEND_IMPORT = (
    "the port's sysfs backend over the PCI twin tree",
    "from tpu_cc_manager_torch.device.tpu import SysfsTpuBackend\n",
    "from torch_pci_tree import twin_backend as SysfsTpuBackend\n"
    "from torch_pci_tree import add_pci_function, make_pci_tree\n")

#: the calls the mirrors record (``torch_mirror.both``'s ``calls``)
CALLS = ("evidence:build_evidence", "evidence:verify_evidence",
         "evidence:audit_evidence", "attest:judge_attestation",
         "attest:verify_quote", "identity:judge_identity",
         "engine:ModeEngine.set_mode")

_DEVICE = re.compile(r"<tmp>/dev/(?:accel|nvidia)(\d+)")
_DEVICE_KEY = re.compile(r"<tmp>_dev_(?:accel|nvidia)(\d+)")
_HEX = re.compile(r"[0-9a-f]{16,}")
#: the values that hash the device paths, or sign such a hash: their hex
#: is masked, their scheme (``sha256:``, ``hmac-sha256:``) kept
_PATH_HASHES = frozenset({"statefile_digest", "nonce", "sig", "signature",
                          "digest"})


#: a JWT's clock readings
_JWT_CLOCK = frozenset({"iat", "exp", "nbf"})


def _jwt_claims(token: str):
    """A compact JWT as its header and claims, the clock readings masked
    (the signature signs them, so it is left out); anything else as it
    is."""
    parts = token.split(".")
    if len(parts) != 3:
        return token
    try:
        header, claims = (json.loads(base64.urlsafe_b64decode(
            p + "=" * (-len(p) % 4))) for p in parts[:2])
    except ValueError:
        return token
    if not isinstance(claims, dict):
        return token
    return {"jwt_header": header, "jwt_claims": {
        k: "<clock>" if k in _JWT_CLOCK else v for k, v in claims.items()}}


def _device_entries(devices):
    return [{**{k: v for k, v in d.items()
                if k not in ("path", "name", "device_id")},
             "index": i} if isinstance(d, dict) else d
            for i, d in enumerate(devices)]


def by_index(value, key=None):
    """``value`` with each device named by its index (see the module
    docstring) and the hashes over device paths masked."""
    if key in _PATH_HASHES and isinstance(value, str):
        return _HEX.sub("<hash>", value)
    if key == "token" and isinstance(value, str):
        value = _jwt_claims(value)
        if not isinstance(value, str):
            return by_index(value)
    if isinstance(value, dict):
        out = {by_index(k) if isinstance(k, str) else k: by_index(v, k)
               for k, v in value.items()}
        if isinstance(out.get("devices"), list):
            out["devices"] = _device_entries(out["devices"])
        return out
    if isinstance(value, (list, tuple)):
        return [by_index(v) for v in value]
    if isinstance(value, str):
        value = _DEVICE.sub(r"<device \1>", value)
        return _DEVICE_KEY.sub(r"<device \1>", value)
    return value


def view(_name, _side, snapshot):
    """``torch_mirror.both``'s view for the mirrors over these trees."""
    return by_index(snapshot)
