"""L0 device layer — the only code allowed to touch TPU hardware state.

This is the TPU-native replacement for the ``gpu-admin-tools`` surface the
reference consumes (SURVEY.md §2.4; reference main.py:38-41):

==========================================  =====================================
reference (gpu-admin-tools)                 here
==========================================  =====================================
``find_gpus() -> (devices, _)``             :func:`find_tpus`
``find_devices_from_string("nvswitches")``  :func:`find_ici_switches`
``Gpu.bdf`` / ``Gpu.name``                  :attr:`TpuChip.path` / ``.name``
``Gpu.is_nvswitch()``                       :meth:`TpuChip.is_ici_switch`
``Gpu.is_cc_query_supported``               :attr:`TpuChip.is_cc_query_supported`
``Gpu.is_ppcie_query_supported``            :attr:`TpuChip.is_ici_query_supported`
``Gpu.query_cc_mode()``                     :meth:`TpuChip.query_cc_mode`
``Gpu.set_cc_mode(mode)``                   :meth:`TpuChip.set_cc_mode`
``Gpu.query_ppcie_mode()``                  :meth:`TpuChip.query_ici_mode`
``Gpu.set_ppcie_mode(mode)``                :meth:`TpuChip.set_ici_mode`
``Gpu.reset_with_os()``                     :meth:`TpuChip.reset`
``Gpu.wait_for_boot()``                     :meth:`TpuChip.wait_ready`
``GpuError``                                :class:`DeviceError`
==========================================  =====================================

Implementations:

- :class:`tpu_cc_manager.device.fake.FakeChip` /
  :func:`~tpu_cc_manager.device.fake.fake_backend` — in-memory, with fault
  injection; used by the whole test pyramid (SURVEY.md §4) and by the
  kind-style dry run (BASELINE config 1).
- :class:`tpu_cc_manager.device.tpu.SysfsTpuBackend` — real host-side
  enumeration of TPU chips from ``/dev/accel*`` + ``/sys/class/accel``
  (vfio-style) with attestation-mode state managed through the native
  ``libtpudev`` shim (C++) or a pure-Python fallback.
- :class:`tpu_cc_manager.device.jaxdev.JaxTpuBackend` — live enumeration
  through the TPU runtime itself (PJRT/libtpu): on-chip health probes and
  a real runtime-restart reset. The hardware-truth path; selected with
  ``TPU_CC_DEVICE_BACKEND=jax`` (see REALDEV_r02.json for a real v5e
  chip driven through a full flip cycle).

There is deliberately no NVML, no ``nvidia-smi``, and no vendor tooling
anywhere behind this interface — the BASELINE acceptance grep holds by
construction.
"""

from __future__ import annotations

from tpu_cc_manager_torch.device.base import (
    Backend,
    DeviceError,
    TpuChip,
    get_backend,
    set_backend,
)

__all__ = [
    "Backend",
    "DeviceError",
    "TpuChip",
    "get_backend",
    "set_backend",
    "find_tpus",
    "find_ici_switches",
    "describe_backend",
]


def find_tpus():
    """Enumerate TPU chips on this host.

    Returns ``(devices, error_str_or_none)`` — the same shape as the
    reference's ``find_gpus()`` (reference main.py:128,171,208), so the
    engine's call sites keep the reference's error-handling structure.
    """
    return get_backend().find_tpus()


def find_ici_switches():
    """Enumerate ICI switches (NVSwitch analog, reference main.py:185)."""
    return get_backend().find_ici_switches()


def describe_backend(backend=None, name: str = "") -> dict:
    """Machine-readable device inventory for ANY backend (the
    ``probe-devices`` CLI and the bench's real-host extra serialize this).
    Per-device failures are reported in that device's ``error`` field —
    an inventory query never raises for one bad part."""
    backend = backend or get_backend()
    chips, err = backend.find_tpus()
    switches = backend.find_ici_switches()
    devices = []
    for c in list(chips) + [s for s in switches if s not in chips]:
        entry = {
            "path": c.path,
            "device_kind": c.name,
            "is_ici_switch": c.is_ici_switch(),
            "cc_capable": c.is_cc_query_supported,
            "ici_capable": c.is_ici_query_supported,
        }
        for attr in ("platform", "device_id", "process_index", "coords"):
            if hasattr(c, attr):
                entry[attr] = getattr(c, attr)
        try:
            entry["cc_mode"] = (
                c.query_cc_mode() if c.is_cc_query_supported else None
            )
            entry["ici_mode"] = (
                c.query_ici_mode() if c.is_ici_query_supported else None
            )
        except DeviceError as e:
            entry["error"] = str(e)
        devices.append(entry)
    return {
        "backend": name or type(backend).__name__,
        "error": err,
        "devices": devices,
    }
