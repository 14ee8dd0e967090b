"""Sysfs/devfs GPU backend — host-side enumeration of the NVIDIA cards.

The port's counterpart of the reference's sysfs backend
(``tpu_cc_manager/device/tpu.py``), and the scan the original bash engine
ran (``scripts/cc-manager.sh:58-76``, SURVEY.md §2.4): every PCI function
under ``/sys/bus/pci/devices`` with NVIDIA's vendor id ``0x10de``.

- GPUs are the functions of class ``0x0300xx`` (VGA) or ``0x0302xx`` (3D
  controller; the H100 SXM is ``0x030200``). NVSwitches, class
  ``0x0680xx``, take the place of the reference's ICI switches and are
  named ``ici-switch`` (PARITY.md §2.4), so reports stay byte-comparable.
  Every other function of the vendor (HDMI audio ``0x0403xx``, USB-C
  controllers) is skipped.
- A GPU's ``path`` is its devfs node, ``TPU_DEV_ROOT/nvidia<minor>``, with
  the minor read from the NVIDIA driver's
  ``/proc/driver/nvidia/gpus/<bdf>/information`` (``Device Minor:``). A
  function the driver does not list (unbound, or bound to ``vfio-pci``)
  and every NVSwitch get ``pci:<bdf>``, which has no devfs node: the
  device gate, the holder scan and ``wait_ready`` treat it as they treat
  any path outside ``/dev``. The path keys the device's statefile
  directory, as every backend's does.
- Modes are staged and committed in the same :class:`ModeStateStore` as
  the reference's (the native ``libtpudev`` store when present), and read
  back independently through ``tpudevctl`` or the other store
  implementation.

**The reset hazard.** On a card's host ``/sys/bus/pci/devices/<bdf>/reset``
exists, and a write to it resets the PCI function under the driver. The
reference writes ``1`` to the attribute named by ``TPU_SYSFS_RESET_ATTR``
(default ``reset``); here the variable defaults to empty, and empty means
no sysfs write at all. A deployment that wants the poke names the
attribute. ``reset()`` always commits the staged modes to the store. No
CC register is touched: that needs NVIDIA's gpu-admin-tools, which are not
part of this project.

Capability comes only from the ``CC_CAPABLE_DEVICE_IDS`` allowlist (unset:
every GPU is capable); ``KNOWN_GPU_DEVICE_IDS`` only names the part.

Environment:

- ``TPU_SYSFS_ROOT``       (default ``/sys/bus/pci/devices``)
- ``TPU_DEV_ROOT``         (default ``/dev``)
- ``TPU_NVIDIA_PROC_ROOT`` (default ``/proc/driver/nvidia/gpus``)
- ``TPU_CC_STATE_DIR``     (default ``/var/lib/tpu-cc-manager``)
- ``CC_CAPABLE_DEVICE_IDS`` — comma-separated hex device ids
- ``TPU_CC_NATIVE_LIB`` — path to libtpudev.so (else bundled, else Python)
- ``TPU_SYSFS_RESET_ATTR`` (default empty: no write) /
  ``TPU_SYSFS_HEALTH_ATTR`` (default ``health``; a PCI function has none,
  and an absent attribute reads as healthy)

Selected with ``TPU_CC_DEVICE_BACKEND=sysfs`` (device.base.get_backend).
"""

from __future__ import annotations

import os
import subprocess
import time
from typing import List, Optional, Tuple

from tpu_cc_manager_torch.device.base import (
    Backend,
    DeviceError,
    TpuChip,
    backoff_intervals,
)
from tpu_cc_manager_torch.device.statefile import (
    ModeStateStore,
    independent_read,
)


def find_tpudevctl() -> Optional[str]:
    """Locate the tpudevctl binary (the independent-verify reader):
    TPUDEVCTL env, the container install path, or the in-repo build."""
    cands = [os.environ.get("TPUDEVCTL"), "/usr/bin/tpudevctl"]
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cands.append(os.path.join(here, "native", "build", "tpudevctl"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


#: NVIDIA's PCI vendor id
NVIDIA_VENDOR_ID = 0x10DE

#: PCI class codes, without the programming interface byte: GPUs are VGA
#: (0x0300) or 3D (0x0302) controllers, NVSwitches "other bridge" (0x0680)
GPU_CLASSES = (0x0300, 0x0302)
SWITCH_CLASS = 0x0680

#: Known GPU PCI device ids -> name. Used for naming only; capability
#: comes from the CC_CAPABLE_DEVICE_IDS allowlist.
KNOWN_GPU_DEVICE_IDS = {
    0x2330: "h100-sxm5-80gb",
    0x2331: "h100-pcie",
}

DEFAULT_SYSFS_ROOT = "/sys/bus/pci/devices"
DEFAULT_NVIDIA_PROC_ROOT = "/proc/driver/nvidia/gpus"


def _read(path: str) -> Optional[str]:
    try:
        with open(path, "r") as f:
            return f.read().strip()
    except OSError:
        return None


def _parse_hex(raw: Optional[str]) -> Optional[int]:
    if raw is None:
        return None
    try:
        return int(raw, 16)
    except ValueError:
        return None


def capable_device_ids() -> Optional[set]:
    """Parse CC_CAPABLE_DEVICE_IDS (reference scripts/cc-manager.sh:19-27).

    Returns None when unset/empty, meaning every GPU is treated as
    capable.
    """
    raw = os.environ.get("CC_CAPABLE_DEVICE_IDS", "").strip()
    if not raw:
        return None
    ids = set()
    for tok in raw.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        try:
            ids.add(int(tok, 16))
        except ValueError:
            raise DeviceError(
                f"invalid CC_CAPABLE_DEVICE_IDS token {tok!r}: expected a "
                f"comma-separated list of hex device ids (e.g. '0x2330')"
            ) from None
    return ids


def device_minor(proc_root: str, bdf: str) -> Optional[int]:
    """The ``Device Minor:`` the NVIDIA driver lists for ``bdf``, or None
    when the driver does not list the function."""
    info = _read(os.path.join(proc_root, bdf, "information"))
    for line in (info or "").splitlines():
        key, _, value = line.partition(":")
        if key.strip() == "Device Minor":
            try:
                return int(value.strip())
            except ValueError:
                return None
    return None


class SysfsGpuChip(TpuChip):
    def __init__(
        self,
        path: str,
        bdf: str,
        sysfs_dir: str,
        device_id: Optional[int],
        store: ModeStateStore,
        *,
        cc_capable: bool,
        is_switch: bool = False,
    ):
        self.path = path
        self.bdf = bdf
        self.sysfs_dir = sysfs_dir
        self.device_id = device_id
        self.name = KNOWN_GPU_DEVICE_IDS.get(device_id or -1, "gpu")
        if is_switch:
            self.name = "ici-switch"
        self._store = store
        self._is_switch = is_switch
        self.is_cc_query_supported = cc_capable and not is_switch
        # PPCIe protection spans GPUs and NVSwitches alike (main.py:160-195)
        self.is_ici_query_supported = cc_capable or is_switch

    def is_ici_switch(self) -> bool:
        return self._is_switch

    def query_cc_mode(self) -> str:
        if not self.is_cc_query_supported:
            raise DeviceError(f"{self.path}: CC query not supported")
        return self._store.effective(self.path, "cc")

    def set_cc_mode(self, mode: str) -> None:
        if not self.is_cc_query_supported:
            raise DeviceError(f"{self.path}: CC not supported")
        self._store.stage(self.path, "cc", mode)

    def query_ici_mode(self) -> str:
        if not self.is_ici_query_supported:
            raise DeviceError(f"{self.path}: ICI query not supported")
        return self._store.effective(self.path, "ici")

    def set_ici_mode(self, mode: str) -> None:
        if not self.is_ici_query_supported:
            raise DeviceError(f"{self.path}: ICI not supported")
        self._store.stage(self.path, "ici", mode)

    def discard_staged(self) -> None:
        self._store.discard(self.path)

    def verify_independent(self, domain: str) -> Optional[str]:
        """Cross-read the effective mode through the tpudevctl binary — a
        different executable against the same fcntl-locked store —
        falling back to the other store implementation in-process when
        the binary isn't installed."""
        ctl = find_tpudevctl()
        if ctl:
            state_dir = self._store.state_dir
            if isinstance(state_dir, bytes):
                state_dir = state_dir.decode()
            env = dict(os.environ, TPU_CC_STATE_DIR=state_dir)
            try:
                r = subprocess.run(
                    [ctl, "query", self.path, domain],
                    capture_output=True, text=True, env=env, timeout=10,
                )
            except (OSError, subprocess.TimeoutExpired) as e:
                raise DeviceError(
                    f"{self.path}: independent verify via {ctl} failed: {e}"
                ) from e
            if r.returncode != 0:
                raise DeviceError(
                    f"{self.path}: independent verify via {ctl} failed "
                    f"(rc={r.returncode}): {r.stderr.strip()}"
                )
            return r.stdout.strip()
        return independent_read(self._store, self.path, domain)

    def reset(self) -> None:
        """Apply staged modes. With ``TPU_SYSFS_RESET_ATTR`` naming an
        attribute of the function that exists, ``1`` is written to it
        first (the reference's poke; on a card's host ``reset`` resets
        the PCI function). Unset, nothing under sysfs is written. The
        staged → effective commit happens in the store either way."""
        attr = os.environ.get("TPU_SYSFS_RESET_ATTR", "").strip()
        reset_attr = os.path.join(self.sysfs_dir, attr) if attr else None
        if reset_attr and os.path.exists(reset_attr):
            try:
                with open(reset_attr, "w") as f:
                    f.write("1")
            except OSError as e:
                raise DeviceError(f"{self.path}: reset failed: {e}") from e
        self._store.commit(self.path)

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        """Poll device-node presence + optional sysfs health until ready
        (wait_for_boot analog, reference main.py:289), backing off
        exponentially from 50 ms (device.base.backoff_intervals)."""
        health_attr = os.path.join(
            self.sysfs_dir, os.environ.get("TPU_SYSFS_HEALTH_ATTR", "health")
        )
        pauses = backoff_intervals(time.monotonic() + timeout_s)
        while True:
            node_ok = os.path.exists(self.path) or not self.path.startswith("/dev/")
            health = _read(health_attr)
            health_ok = health is None or health.lower() in ("ok", "healthy", "1")
            if node_ok and health_ok:
                return
            pause = next(pauses, None)
            if pause is None:
                raise DeviceError(f"{self.path}: not ready after {timeout_s}s")
            time.sleep(pause)


class SysfsGpuBackend(Backend):
    def __init__(
        self,
        sysfs_root: Optional[str] = None,
        dev_root: Optional[str] = None,
        state_dir: Optional[str] = None,
        nvidia_proc_root: Optional[str] = None,
    ):
        self.sysfs_root = sysfs_root or os.environ.get(
            "TPU_SYSFS_ROOT", DEFAULT_SYSFS_ROOT
        )
        self.dev_root = dev_root or os.environ.get("TPU_DEV_ROOT", "/dev")
        self.nvidia_proc_root = nvidia_proc_root or os.environ.get(
            "TPU_NVIDIA_PROC_ROOT", DEFAULT_NVIDIA_PROC_ROOT
        )
        resolved_state_dir = state_dir or os.environ.get(
            "TPU_CC_STATE_DIR", "/var/lib/tpu-cc-manager"
        )
        # prefer the native store when available (one implementation shared
        # with the C++ agent and tpudevctl); identical on-disk layout
        from tpu_cc_manager_torch.device.native import load_native_store

        self.store = (
            load_native_store(resolved_state_dir)
            or ModeStateStore(resolved_state_dir)
        )

    def _scan(self) -> List[SysfsGpuChip]:
        chips: List[SysfsGpuChip] = []
        if not os.path.isdir(self.sysfs_root):
            return chips
        allow = capable_device_ids()
        for bdf in sorted(os.listdir(self.sysfs_root)):
            sysfs_dir = os.path.join(self.sysfs_root, bdf)
            vendor = _parse_hex(_read(os.path.join(sysfs_dir, "vendor")))
            if vendor != NVIDIA_VENDOR_ID:
                continue  # cc-manager.sh:64
            klass = _parse_hex(_read(os.path.join(sysfs_dir, "class")))
            base_class = None if klass is None else klass >> 8
            is_switch = base_class == SWITCH_CLASS
            if not is_switch and base_class not in GPU_CLASSES:
                continue  # audio, USB-C and other functions of the card
            device_id = _parse_hex(_read(os.path.join(sysfs_dir, "device")))
            cc_capable = allow is None or (device_id is not None and device_id in allow)
            minor = None if is_switch else device_minor(self.nvidia_proc_root, bdf)
            path = (os.path.join(self.dev_root, f"nvidia{minor}")
                    if minor is not None else f"pci:{bdf}")
            chips.append(
                SysfsGpuChip(
                    path=path,
                    bdf=bdf,
                    sysfs_dir=sysfs_dir,
                    device_id=device_id,
                    store=self.store,
                    cc_capable=cc_capable,
                    is_switch=is_switch,
                )
            )
        return chips

    def find_tpus(self) -> Tuple[List[TpuChip], Optional[str]]:
        try:
            chips = self._scan()
        except (OSError, DeviceError) as e:
            # enumeration error surface (find_gpus 2-tuple, main.py:128)
            return [], str(e)
        return [c for c in chips if not c.is_ici_switch()], None

    def find_ici_switches(self) -> List[TpuChip]:
        return [c for c in self._scan() if c.is_ici_switch()]
