"""ctypes binding for the native libtpudev.so mode-state store.

When ``TPU_CC_NATIVE_LIB`` points at the shared library (as the container
images set it), the sysfs backend routes mode-state operations through
the same native code the C++ agent and tpudevctl use — one
implementation, three consumers. The on-disk format is identical either
way (see statefile.py), so this is an optimization/consolidation, not a
behavior switch, and the pure-Python store remains the fallback.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

from tpu_cc_manager_torch.device.base import DeviceError


class NativeModeStateStore:
    """Drop-in for ModeStateStore backed by libtpudev.so."""

    def __init__(self, state_dir: str, lib_path: str):
        self.state_dir = state_dir.encode()
        self._lib = ctypes.CDLL(lib_path)
        self._lib.tpudev_stage.argtypes = [ctypes.c_char_p] * 4
        self._lib.tpudev_stage.restype = ctypes.c_int
        self._lib.tpudev_commit.argtypes = [ctypes.c_char_p] * 2
        self._lib.tpudev_commit.restype = ctypes.c_int
        self._lib.tpudev_discard.argtypes = [ctypes.c_char_p] * 2
        self._lib.tpudev_discard.restype = ctypes.c_int
        self._lib.tpudev_read.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t,
        ]
        self._lib.tpudev_read.restype = ctypes.c_int

    def _read(self, path: str, domain: str, staged: bool) -> str:
        buf = ctypes.create_string_buffer(64)
        rc = self._lib.tpudev_read(
            self.state_dir, path.encode(), domain.encode(),
            1 if staged else 0, buf, len(buf),
        )
        if rc != 0:
            # DeviceError (not OSError) so the engine's failure path still
            # publishes cc.mode.state=failed (reference main.py:300-307)
            raise DeviceError(f"tpudev_read failed for {path}/{domain}")
        return buf.value.decode()

    def effective(self, path: str, domain: str) -> str:
        return self._read(path, domain, staged=False)

    def staged(self, path: str, domain: str) -> str:
        return self._read(path, domain, staged=True)

    def stage(self, path: str, domain: str, mode: str) -> None:
        if self._lib.tpudev_stage(
            self.state_dir, path.encode(), domain.encode(), mode.encode()
        ) != 0:
            raise DeviceError(f"tpudev_stage failed for {path}")

    def commit(self, path: str) -> None:
        if self._lib.tpudev_commit(self.state_dir, path.encode()) != 0:
            raise DeviceError(f"tpudev_commit failed for {path}")

    def discard(self, path: str) -> None:
        if self._lib.tpudev_discard(self.state_dir, path.encode()) != 0:
            raise DeviceError(f"tpudev_discard failed for {path}")


def load_native_store(state_dir: str) -> Optional[NativeModeStateStore]:
    """Return the native store when TPU_CC_NATIVE_LIB is set and loadable,
    else None (callers fall back to the pure-Python ModeStateStore)."""
    lib_path = os.environ.get("TPU_CC_NATIVE_LIB")
    if not lib_path or not os.path.exists(lib_path):
        return None
    try:
        return NativeModeStateStore(state_dir, lib_path)
    except OSError:
        return None
