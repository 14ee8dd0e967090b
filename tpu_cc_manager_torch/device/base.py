"""Device protocol + backend registry for the L0 layer."""

from __future__ import annotations

import abc
import os
import threading
import time
from typing import Iterator, List, Optional, Tuple


class DeviceError(Exception):
    """Any device-layer failure (analog of GpuError, reference main.py:41)."""


#: wait_ready poll cadence, shared by every backend: exponential backoff
#: from 50 ms capped at 1 s, always clamped to the remaining deadline.
#: The old fixed 0.5 s sleep put a mandatory half-second floor under
#: EVERY reset — across an 8-chip plan that floor alone was 4 s of pure
#: waiting, which the parallel flip pipeline would otherwise multiply.
WAIT_READY_POLL_START_S = 0.05
WAIT_READY_POLL_MAX_S = 1.0


def backoff_intervals(deadline: float) -> Iterator[float]:
    """Sleep durations for a ready-poll loop: exponential from
    ``WAIT_READY_POLL_START_S``, capped at ``WAIT_READY_POLL_MAX_S``,
    each clamped to the time left before ``deadline`` (a
    ``time.monotonic()`` instant). Exhausts when the deadline passes —
    callers treat exhaustion as the timeout."""
    delay = WAIT_READY_POLL_START_S
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        yield min(delay, remaining)
        delay = min(delay * 2, WAIT_READY_POLL_MAX_S)


class TpuChip(abc.ABC):
    """One TPU chip (or ICI switch) on this host.

    ``path`` is the stable host-side identity (e.g. ``/dev/accel0``) — the
    BDF analog (reference main.py:140). ``name`` is the human-readable chip
    model (e.g. ``tpu-v5p``).
    """

    path: str
    name: str

    #: Whether CC/attestation mode can even be queried on this part
    #: (capability analog of is_cc_query_supported, reference main.py:135).
    is_cc_query_supported: bool = False
    #: Whether protected-ICI mode is supported (reference main.py:177).
    is_ici_query_supported: bool = False

    @abc.abstractmethod
    def is_ici_switch(self) -> bool:
        """True for ICI switch parts (NVSwitch analog, main.py:131)."""

    @abc.abstractmethod
    def query_cc_mode(self) -> str:
        """Current CC mode: 'on' | 'off' | 'devtools' (main.py:250)."""

    @abc.abstractmethod
    def set_cc_mode(self, mode: str) -> None:
        """Stage the CC mode; takes effect after reset (main.py:282)."""

    @abc.abstractmethod
    def query_ici_mode(self) -> str:
        """Current protected-ICI mode: 'on' | 'off' (main.py:362)."""

    @abc.abstractmethod
    def set_ici_mode(self, mode: str) -> None:
        """Stage protected-ICI mode; takes effect after reset (main.py:393)."""

    def discard_staged(self) -> None:
        """Drop any staged-but-uncommitted mode, reverting staged state to
        the current effective modes. Called by the engine before staging a
        fresh flip so a previous failed/crashed flip's intent cannot ride
        along into this reset. Default: no-op for backends without durable
        staging."""

    def verify_independent(self, domain: str) -> Optional[str]:
        """Re-read the effective mode of ``domain`` through a path that
        shares as little as possible with the flip that just committed —
        a different binary (tpudevctl) or a different store
        implementation against the same on-disk state. The engine
        requires this reading to agree with the target before declaring
        the flip verified (non-tautological verify, reference
        main.py:291-296). Default: None — no independent path exists
        (in-memory fakes), plain verify stands alone."""
        return None

    @abc.abstractmethod
    def reset(self) -> None:
        """Restart the TPU runtime / reset the chip so a staged mode takes
        effect (reset_with_os analog, main.py:286)."""

    @abc.abstractmethod
    def wait_ready(self, timeout_s: float = 60.0) -> None:
        """Block until the chip is healthy after a reset (wait_for_boot
        analog, main.py:289). Raises DeviceError on timeout."""

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} {self.name} @ {self.path}>"


class Backend(abc.ABC):
    """Enumeration entry point — one per device-access mechanism."""

    @abc.abstractmethod
    def find_tpus(self) -> Tuple[List[TpuChip], Optional[str]]:
        """-> (chips, error_or_none); mirrors find_gpus() (main.py:128)."""

    @abc.abstractmethod
    def find_ici_switches(self) -> List[TpuChip]:
        """-> ICI switch parts only (main.py:185)."""


_lock = threading.Lock()
_backend: Optional[Backend] = None


def set_backend(backend: Optional[Backend]) -> None:
    """Install the process-wide device backend (tests install a fake)."""
    global _backend
    with _lock:
        _backend = backend


def _default_backend() -> Backend:
    """Build the backend named by TPU_CC_DEVICE_BACKEND:

    - ``cuda`` (default) — live CUDA enumeration through torch
      (device.cudadev), the path that touches the real card;
    - ``sysfs``          — host PCI sysfs scan for the NVIDIA functions
      (device.gpu), the reference's default backend;
    - ``fake``           — in-memory fake (device.fake), for kind-style
      dry runs where the DaemonSet has no device plumbing at all.

    The default is ``cuda``, not the reference's ``sysfs``: the port's
    entry points and its probe kernel ride the CUDA backend's flips.
    """
    name = os.environ.get("TPU_CC_DEVICE_BACKEND", "cuda").strip().lower()
    if name == "cuda":
        from tpu_cc_manager_torch.device.cudadev import CudaBackend

        return CudaBackend()
    if name == "fake":
        from tpu_cc_manager_torch.device.fake import fake_backend

        return fake_backend()
    if name != "sysfs":
        raise DeviceError(
            f"unknown TPU_CC_DEVICE_BACKEND {name!r}: "
            "expected cuda | sysfs | fake"
        )
    from tpu_cc_manager_torch.device.gpu import SysfsGpuBackend

    return SysfsGpuBackend()


def get_backend() -> Backend:
    """Return the installed backend, defaulting per TPU_CC_DEVICE_BACKEND
    (cuda unless overridden)."""
    global _backend
    with _lock:
        if _backend is None:
            _backend = _default_backend()
        return _backend
