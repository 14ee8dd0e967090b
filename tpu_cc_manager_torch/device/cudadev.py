"""CUDA device backend — the bridge from the mode store to the real card.

The port's counterpart of the reference's JAX/PJRT backend
(``tpu_cc_manager/device/jaxdev.py``): it enumerates the devices **through
the CUDA runtime itself** (``torch.cuda``), keeps the attestation mode in
the same staged/effective :class:`ModeStateStore` on the host, and proves
each device alive after a reset with an on-device computation, the
hand-written kernel K5 (``csrc/probe.cu``). The sequence is the
reference's query → set → reset_with_os → wait_for_boot → verify
(reference main.py:258-296):

- ``find_tpus``    — every CUDA device of the host: name, uuid and PCI
  domain/bus/device ids from ``torch.cuda.get_device_properties``.
  ``path`` is the PCI address (``cuda:0000:18:00.0``, the reference's BDF,
  main.py:140), which ``CUDA_VISIBLE_DEVICES`` does not renumber. It is
  never a ``/dev/nvidia*`` node: the device gate would ``chmod`` a real
  node, and the holder scan would find every other CUDA process (the
  persistence daemon, any other client) holding it.
- ``set/query``    — host-side durable state, the same store and on-disk
  format as every other backend (shared with the C++ shim and the bash
  engine). Programming the card's own CC registers needs NVIDIA's
  gpu-admin-tools (SURVEY.md §2.4) and is out of scope.
- ``reset``        — the runtime restart analog. The reference tears down
  the PJRT client (``clear_backends``); a CUDA context cannot be torn down
  in-process without breaking the process: ``cudaDeviceReset`` would
  invalidate torch's caching allocator and every live tensor, the
  planner's resident ``TickSession`` block included, so it is never
  called. Instead the restart quiesces the runtime: synchronize every
  enumerated device, return torch's cached blocks to the driver
  (``empty_cache``), release IPC handles other processes gave back
  (``ipc_collect``), drop the cached device list and bump
  ``runtime_gen``, all under ``teardown_lock``, then commit staged →
  effective. The next probe re-enumerates and runs on a quiesced device.
- ``wait_ready``   — run K5 ON the device and read its result back, with
  the reference's backoff and its early exit on a generation bump.

Environment:

- ``TPU_CC_STATE_DIR``          (default ``/var/lib/tpu-cc-manager``)
- ``CC_CAPABLE_DEVICE_KINDS``   — comma-separated substrings matched
  against the device name (e.g. ``h100,h200``); unset = every CUDA device
  is CC-capable.
- ``TPU_CC_TORCH_DEVICE=cpu``   — the explicit CPU request (or
  ``CudaBackend(device="cpu")``): ``cpu_chips`` CPU chips, paths
  ``torch:cpu:<i>``, probes through K5's plain version. Tests only. With
  no CUDA device and no such request, enumeration reports an error and
  nothing moves to the CPU by itself.

Selected via ``TPU_CC_DEVICE_BACKEND=cuda`` (the default, see
device.base.get_backend).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, NamedTuple, Optional, Tuple, Union

import torch

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
from tpu_cc_manager_torch.kernels.probe import probe_add_one
from tpu_cc_manager_torch.plan import DEVICE_ENV


def _capable_kinds() -> Optional[List[str]]:
    raw = os.environ.get("CC_CAPABLE_DEVICE_KINDS", "").strip()
    if not raw:
        return None
    return [tok.strip().lower() for tok in raw.split(",") if tok.strip()]


class _Device(NamedTuple):
    """One enumerated device: where tensors go, and what it is called."""

    device_id: int
    torch_device: torch.device
    platform: str
    name: str
    path: str
    uuid: Optional[str]


def _pci_path(props) -> str:
    """``cuda:<domain>:<bus>:<device>.0``, the PCI address in the form
    ``nvidia-smi`` and sysfs print it (CUDA reports no PCI function; a
    GPU is function 0)."""
    return (f"cuda:{props.pci_domain_id:04x}:{props.pci_bus_id:02x}:"
            f"{props.pci_device_id:02x}.0")


class CudaChip(TpuChip):
    """One CUDA device (or, on request, one CPU chip of the tests).

    ``path`` is the device's PCI address, ``cuda:0000:18:00.0``: stable
    for the host whatever ``CUDA_VISIBLE_DEVICES`` says, and the key of
    the device's statefile directory, as every other backend's path is.
    ``device_id`` is the torch ordinal the probe runs on.
    """

    def __init__(
        self,
        backend: "CudaBackend",
        *,
        device_id: int,
        platform: str,
        device_kind: str,
        path: str,
        uuid: Optional[str],
        cc_capable: bool,
    ):
        self._backend = backend
        self._created_gen = backend.runtime_gen
        self.device_id = device_id
        self.platform = platform
        self.uuid = uuid
        self.path = path
        self.name = device_kind
        self.is_cc_query_supported = cc_capable
        self.is_ici_query_supported = cc_capable

    # NVSwitches are not CUDA devices; PPCIe state rides the GPUs.
    def is_ici_switch(self) -> bool:
        return False

    # ------------------------------------------------------------- modes
    def query_cc_mode(self) -> str:
        if not self.is_cc_query_supported:
            raise DeviceError(f"{self.path}: CC query not supported")
        return self._backend.store.effective(self.path, "cc")

    def set_cc_mode(self, mode: str) -> None:
        if not self.is_cc_query_supported:
            raise DeviceError(f"{self.path}: CC not supported")
        self._backend.store.stage(self.path, "cc", mode)

    def query_ici_mode(self) -> str:
        if not self.is_ici_query_supported:
            raise DeviceError(f"{self.path}: ICI query not supported")
        return self._backend.store.effective(self.path, "ici")

    def set_ici_mode(self, mode: str) -> None:
        if not self.is_ici_query_supported:
            raise DeviceError(f"{self.path}: ICI not supported")
        self._backend.store.stage(self.path, "ici", mode)

    def discard_staged(self) -> None:
        self._backend.store.discard(self.path)

    def verify_independent(self, domain: str) -> Optional[str]:
        """Cross-read through the other store implementation (fresh
        handle, shared bytes + lock only). The device-health half of the
        verified claim comes from wait_ready's on-device probe, which the
        engine always runs before verify."""
        return independent_read(self._backend.store, self.path, domain)

    # ------------------------------------------------------------- reset
    def reset(self) -> None:
        """Runtime restart analog (see the module docstring): quiesce
        the CUDA runtime, commit staged→effective, and leave the
        re-enumeration and the probe to wait_ready (reference main.py:286
        analog).

        The restart is **runtime-global**, as the reference's PJRT
        teardown is: chips created under the same runtime generation
        share ONE restart, so a multi-chip plan pays exactly one, and
        later chips in the engine's per-device loop only commit their
        statefiles. The gen check and the restart run under the
        backend's teardown lock, so PARALLEL flips (engine flip
        executor) also pay exactly one."""
        with self._backend.teardown_lock:
            if self._created_gen == self._backend.runtime_gen:
                self._backend.teardown_runtime()
        self._backend.store.commit(self.path)

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        """Run K5 ON this device and read its result back, retrying
        until it answers (reference main.py:289 analog). The retry
        cadence backs off exponentially from 50 ms, clamped to the
        deadline (device.base.backoff_intervals).

        Early exit on a runtime-generation bump: a restart landing
        MID-WAIT (a chip of a newer plan resetting) supersedes the
        session these probes are trying to reach, so the wait fails fast
        with a message that names the supersession instead of
        masquerading as a boot timeout; the engine's failure path retries
        against the live generation."""
        last_err: Optional[Exception] = None
        start_gen = self._backend.runtime_gen
        pauses = backoff_intervals(time.monotonic() + timeout_s)
        while True:
            try:
                self._backend.probe_device(self.device_id)
                return
            except Exception as e:  # CUDA raises RuntimeError subclasses
                last_err = e
                if self._backend.runtime_gen != start_gen:
                    raise DeviceError(
                        f"{self.path}: runtime generation advanced "
                        f"({start_gen} -> {self._backend.runtime_gen}) "
                        f"during wait_ready; probing a superseded "
                        f"session is futile: {e}"
                    ) from e
                pause = next(pauses, None)
                if pause is None:
                    break
                time.sleep(pause)
        raise DeviceError(
            f"{self.path}: not ready after {timeout_s}s: {last_err}"
        )


class CudaBackend(Backend):
    """Every CUDA device of the host, or ``cpu_chips`` CPU chips when the
    caller asks for the CPU (``device="cpu"`` or
    ``TPU_CC_TORCH_DEVICE=cpu``)."""

    def __init__(self, state_dir: Optional[str] = None, *,
                 device: Union[None, str, torch.device] = None,
                 cpu_chips: int = 1):
        resolved = state_dir or os.environ.get(
            "TPU_CC_STATE_DIR", "/var/lib/tpu-cc-manager"
        )
        from tpu_cc_manager_torch.device.native import load_native_store

        self.store = load_native_store(resolved) or ModeStateStore(resolved)
        if device is None:
            device = os.environ.get(DEVICE_ENV) or "cuda"
        kind = torch.device(device).type
        if kind not in ("cuda", "cpu"):
            raise ValueError(
                f"CudaBackend runs on cuda or, when asked, cpu; got {device!r}")
        if cpu_chips < 1:
            raise ValueError(f"cpu_chips must be >= 1, got {cpu_chips}")
        self._cpu = kind == "cpu"
        self._cpu_chips = cpu_chips
        #: Bumped by every restart; chips record the generation they were
        #: enumerated under so one engine plan triggers one restart.
        self.runtime_gen = 0
        #: Serializes the gen-check + restart pair in CudaChip.reset:
        #: parallel flips of same-generation chips must still pay exactly
        #: ONE runtime restart.
        self.teardown_lock = threading.Lock()
        #: the device list, cached per runtime generation: every flip
        #: phase (find_tpus, stage's query, wait_ready's probe retries,
        #: verify) reads it; a restart invalidates it by bumping the gen
        self._devices: Optional[List[_Device]] = None
        self._devices_gen = -1
        self._devices_lock = threading.Lock()

    # ------------------------------------------------------- runtime ops
    def _enumerate(self) -> List[_Device]:
        if self._cpu:
            return [_Device(i, torch.device("cpu"), "cpu", "cpu",
                            f"torch:cpu:{i}", None)
                    for i in range(self._cpu_chips)]
        if not torch.cuda.is_available():
            raise DeviceError(
                "no CUDA device is available; the CPU runs only when asked "
                f"(device='cpu' or {DEVICE_ENV}=cpu)")
        devices = []
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            devices.append(_Device(i, torch.device("cuda", i), "cuda",
                                   props.name, _pci_path(props),
                                   str(props.uuid)))
        return devices

    def _local_devices(self) -> List[_Device]:
        with self._devices_lock:
            if (self._devices is not None
                    and self._devices_gen == self.runtime_gen):
                return self._devices
            gen = self.runtime_gen
        # enumerate OUTSIDE the lock: the first CUDA call initializes the
        # runtime, and wait_ready probes must not serialize behind it
        devices = self._enumerate()
        with self._devices_lock:
            if gen == self.runtime_gen:
                self._devices = devices
                self._devices_gen = gen
        return devices

    def teardown_runtime(self) -> None:
        """Quiesce the CUDA runtime (the restart analog of the module
        docstring): every enumerated device synchronized, torch's cached
        blocks released, IPC handles collected, the device list dropped
        and the generation bumped. Live tensors stay valid."""
        if not self._cpu:
            with self._devices_lock:
                devices = self._devices or []
            for d in devices:
                torch.cuda.synchronize(d.torch_device)
            torch.cuda.empty_cache()
            torch.cuda.ipc_collect()
        with self._devices_lock:
            self.runtime_gen += 1
            self._devices = None
            self._devices_gen = -1

    def probe_device(self, device_id: int) -> float:
        """Run K5 on device ``device_id`` (1.0 in, 2.0 back) and read the
        result back to the host. Returns the round-trip seconds on the
        host clock. Raises if the device is gone or the kernel cannot
        build or launch."""
        dev = None
        for d in self._local_devices():
            if d.device_id == device_id:
                dev = d
                break
        if dev is None:
            raise DeviceError(f"device id {device_id} not enumerable")
        t0 = time.monotonic()
        x = torch.tensor(1.0, dtype=torch.float32, device=dev.torch_device)
        y = probe_add_one(x)
        if float(y) != 2.0:  # pragma: no cover - hardware fault surface
            raise DeviceError(f"device id {device_id} compute check failed")
        return time.monotonic() - t0

    # ------------------------------------------------------- enumeration
    def _scan(self) -> List[CudaChip]:
        try:
            devices = self._local_devices()
        except Exception as e:
            raise DeviceError(f"CUDA enumeration failed: {e}") from e
        kinds = _capable_kinds()
        chips: List[CudaChip] = []
        for d in devices:
            if kinds is None:
                cc_capable = True
            else:
                cc_capable = any(k in d.name.lower() for k in kinds)
            chips.append(
                CudaChip(
                    self,
                    device_id=d.device_id,
                    platform=d.platform,
                    device_kind=d.name,
                    path=d.path,
                    uuid=d.uuid,
                    cc_capable=cc_capable,
                )
            )
        return chips

    def find_tpus(self) -> Tuple[List[TpuChip], Optional[str]]:
        try:
            return list(self._scan()), None
        except DeviceError as e:
            return [], str(e)

    def find_ici_switches(self) -> List[TpuChip]:
        return []

    # ------------------------------------------------------- diagnostics
    def describe(self) -> dict:
        """Machine-readable real-device enumeration (the probe-devices
        CLI serializes this)."""
        from tpu_cc_manager_torch.device import describe_backend

        return describe_backend(self, name="cuda")
