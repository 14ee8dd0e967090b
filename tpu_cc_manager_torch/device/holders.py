"""Exclusive-hold guarantee: no one else may hold the chip during a flip.

The reference unbinds the kernel driver before touching the device
(reference scripts/cc-manager.sh:40-50,351-356), so the GPU *cannot* be
in use mid-flip. The TPU analog: the device gate (device/gate.py) blocks
*new* opens, but permission bits do nothing to file descriptors that are
already open — a TPU runtime that grabbed ``/dev/accel0`` before the
flip would silently keep using the chip across the "reset". This module
closes that hole:

- :func:`find_holders` scans ``/proc/*/fd`` for open descriptors on the
  device node (the host-side ground truth of "who has the chip");
- :class:`HolderCheck.ensure_free` refuses to commit a staged mode while
  a foreign process holds the device. If
  ``TPU_CC_RUNTIME_RESTART_CMD`` is configured (e.g. ``systemctl
  restart tpu-runtime``) it is invoked once to make the external holder
  let go, then the check polls until the device is free or
  ``TPU_CC_HOLD_WAIT_S`` (default 30 s) expires.

Knobs:

- ``TPU_CC_HOLDER_CHECK``       — ``proc`` (default) | ``none``
- ``TPU_CC_RUNTIME_RESTART_CMD``— command run (via the shell) when a
  holder blocks the flip; empty = no hook, the flip just fails
- ``TPU_CC_HOLD_WAIT_S``        — how long to wait for holders to leave
  after the restart hook (also applies with no hook: a holder already
  exiting gets a grace period)

The scan is best-effort per process (processes may exit mid-scan;
/proc entries of foreign users may be unreadable — unreadable entries
are *ignored*, which is safe here because the agent runs as root on the
node and can read every fd table that matters).
"""

from __future__ import annotations

import logging
import os
import subprocess
import threading
import time
from typing import List, NamedTuple, Sequence

from tpu_cc_manager_torch.device.base import DeviceError

log = logging.getLogger("tpu-cc-manager.holders")


class Holder(NamedTuple):
    pid: int
    comm: str


def find_holders(path: str, exclude_pids: Sequence[int] = ()) -> List[Holder]:
    """Processes (other than this one and ``exclude_pids``) with an open
    fd on ``path``. Empty when the node does not exist."""
    real = os.path.realpath(path)
    if not os.path.exists(real):
        return []
    excluded = {os.getpid(), *exclude_pids}
    out: List[Holder] = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        pid = int(entry)
        if pid in excluded:
            continue
        fd_dir = f"/proc/{entry}/fd"
        try:
            fds = os.listdir(fd_dir)
        except OSError:
            continue  # process gone / unreadable: not a verifiable holder
        for fd in fds:
            try:
                target = os.readlink(os.path.join(fd_dir, fd))
            except OSError:
                continue
            if target == real:
                try:
                    with open(f"/proc/{entry}/comm") as f:
                        comm = f.read().strip()
                except OSError:
                    comm = "?"
                out.append(Holder(pid, comm))
                break
    return out


def check_enabled() -> bool:
    v = os.environ.get("TPU_CC_HOLDER_CHECK", "proc").strip().lower()
    if v in ("proc", ""):
        return True
    if v in ("none", "off", "false", "0"):
        return False
    raise DeviceError(
        f"unknown TPU_CC_HOLDER_CHECK {v!r}: expected proc | none"
    )


class HolderCheck:
    def __init__(
        self,
        enabled: bool | None = None,
        restart_cmd: str | None = None,
        wait_s: float | None = None,
        poll_s: float = 0.5,
    ):
        self.enabled = check_enabled() if enabled is None else enabled
        self.restart_cmd = (
            os.environ.get("TPU_CC_RUNTIME_RESTART_CMD", "").strip()
            if restart_cmd is None else restart_cmd
        )
        self.wait_s = (
            float(os.environ.get("TPU_CC_HOLD_WAIT_S", "30"))
            if wait_s is None else wait_s
        )
        self.poll_s = poll_s
        #: Serializes the restart hook across the engine's parallel flip
        #: workers: the hook restarts ONE shared node-wide runtime, so N
        #: workers whose devices are held by that runtime must run it
        #: once, not N times racing each other (the serial loop's
        #: effective behavior: the first device's restart freed every
        #: sibling's holder too). Dedicated to the hook — never held
        #: around the poll loop or any executor wait.
        self._hook_lock = threading.Lock()

    def _run_restart_hook(self, path: str) -> None:
        log.warning(
            "%s: held by another process; running runtime restart hook: %s",
            path, self.restart_cmd,
        )
        try:
            r = subprocess.run(
                self.restart_cmd, shell=True,
                capture_output=True, text=True, timeout=self.wait_s,
            )
        except subprocess.TimeoutExpired as e:
            raise DeviceError(
                f"{path}: runtime restart hook timed out after "
                f"{self.wait_s}s: {self.restart_cmd!r}"
            ) from e
        if r.returncode != 0:
            raise DeviceError(
                f"{path}: runtime restart hook failed "
                f"(rc={r.returncode}): {(r.stderr or r.stdout).strip()}"
            )

    def ensure_free(self, path: str) -> None:
        """Raise DeviceError if a foreign process still holds ``path``
        after the (optional) restart hook and the grace period. Called by
        the engine between staging and reset — committing a mode under a
        live holder is the one wrong answer."""
        if not self.enabled:
            return
        holders = find_holders(path)
        if not holders:
            return
        if self.restart_cmd:
            with self._hook_lock:
                # a sibling flip's restart may have already freed this
                # device while we waited for the hook lock — re-scan
                # before restarting the shared runtime AGAIN (which
                # would kill the session a completed sibling was
                # reacquiring through wait_ready)
                if find_holders(path):
                    # ccaudit: allow-blocking-under-lock(the hook lock EXISTS to serialize this subprocess: parallel flip workers must restart the shared runtime once, not N times racing)
                    self._run_restart_hook(path)
        deadline = time.monotonic() + self.wait_s
        while True:
            holders = find_holders(path)
            if not holders:
                log.info("%s: device free; proceeding with commit", path)
                return
            if time.monotonic() >= deadline:
                held_by = ", ".join(f"{h.comm}[{h.pid}]" for h in holders)
                raise DeviceError(
                    f"{path}: still held by {held_by} after {self.wait_s}s; "
                    f"refusing to commit a mode flip under a live holder"
                    + ("" if self.restart_cmd else
                       " (no TPU_CC_RUNTIME_RESTART_CMD configured)")
                )
            time.sleep(self.poll_s)
