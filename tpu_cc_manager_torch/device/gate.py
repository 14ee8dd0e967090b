"""Workload-visible device gating — the flip's node-local consequence.

The reference's mode flip programs GPU security state through register
writes, so `cc.mode=on` changes what the device will do
(reference main.py:282-296, scripts/cc-manager.sh:384-405). On Cloud TPU
the attestation mode is a host/runtime property, so without gating a
workload could open ``/dev/accel*`` identically in every mode and the
"mode" would be pure bookkeeping. This module makes the mode *mean*
something on the node:

- **During a flip** the device node is locked (``chmod 0000``): a process
  that could open the chip before the flip observably cannot mid-flip —
  the access-revocation analog of the reference's driver unbind
  (reference scripts/cc-manager.sh:40-50).
- **After a verified commit** the node's permissions encode the effective
  CC mode: ``on`` → 0600 (root/runtime only — workloads must enter
  through the attested runtime path), ``devtools`` → 0660 (group-held
  debug access), ``off`` → 0666 (open). A workload can *detect* the mode
  difference by attempting to open the node.
- **Fail-secure**: if the flip fails after the lock, the node STAYS
  locked until a later successful reconcile — a half-flipped chip is
  never handed back to workloads. (The agent's self-repair loop retries
  half-flipped slices, so lock-out is bounded in practice.)

Gating is selected with ``TPU_CC_DEVICE_GATING``:

- ``chmod`` (default) — permission-bit gating as above;
- ``none``            — disable (kind-style dry runs whose DaemonSet has
  no real ``/dev`` plumbing).

A missing device node is skipped silently: fake/jax backends use
identities like ``tpu:0`` that have no devfs entry, and gating is a
node-filesystem concern by definition.
"""

from __future__ import annotations

import logging
import os
import stat

from tpu_cc_manager_torch.device.base import DeviceError

log = logging.getLogger("tpu-cc-manager.gate")

#: effective CC mode -> device-node permission bits
MODE_PERMS = {
    "on": 0o600,
    "devtools": 0o660,
    "off": 0o666,
}

#: permissions while a flip is in progress: nobody (but root) can open
FLIP_LOCK_PERMS = 0o000


def gating_enabled() -> bool:
    v = os.environ.get("TPU_CC_DEVICE_GATING", "chmod").strip().lower()
    if v in ("chmod", ""):
        return True
    if v in ("none", "off", "false", "0"):
        return False
    raise DeviceError(
        f"unknown TPU_CC_DEVICE_GATING {v!r}: expected chmod | none"
    )


class DeviceGate:
    """Permission-bit gate over device nodes. All methods are no-ops for
    paths that do not exist on the node filesystem."""

    def __init__(self, enabled: bool | None = None):
        self.enabled = gating_enabled() if enabled is None else enabled

    def _chmod(self, path: str, perms: int, *, must_succeed: bool) -> bool:
        if not self.enabled:
            return False
        try:
            os.chmod(path, perms)
            return True
        except FileNotFoundError:
            return False
        except OSError as e:
            if must_succeed:
                raise DeviceError(
                    f"{path}: cannot gate device node ({e}); refusing to "
                    f"flip an ungated device"
                ) from e
            log.warning("%s: cannot set mode perms: %s", path, e)
            return False

    def lock_for_flip(self, path: str) -> None:
        """Revoke workload access for the duration of the flip. Failure to
        lock an *existing* node aborts the flip (fail-secure): flipping a
        chip that workloads can still open is the reference's
        driver-unbind hole."""
        if self._chmod(path, FLIP_LOCK_PERMS, must_succeed=True):
            log.info("%s: locked for mode flip", path)

    def apply_mode(self, path: str, cc_mode: str) -> None:
        """Encode the verified effective CC mode in the node's permission
        bits. Called only after engine verify succeeds."""
        perms = MODE_PERMS.get(cc_mode, MODE_PERMS["on"])
        if self._chmod(path, perms, must_succeed=False):
            log.info("%s: device node perms set to %o for cc=%s",
                     path, perms, cc_mode)

    def current_perms(self, path: str) -> int | None:
        try:
            return stat.S_IMODE(os.stat(path).st_mode)
        except OSError:
            return None
