"""Fake device backend — the test double for the whole pyramid.

The reference has no fake device layer at all (SURVEY.md §4: zero tests);
this is the piece the TPU build adds so that the mode engine, agent,
multi-node simulation, and bench can run without hardware (BASELINE
config 1: "dry-run reconcile, mocked device list").

Fault injection knobs model every failure path the engine must handle
(reference main.py:274-307): query failure, set failure, reset failure,
boot-timeout, and verify-mismatch (set silently not taking effect).
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Optional, Tuple

from tpu_cc_manager_torch.device.base import Backend, DeviceError, TpuChip


class FakeChip(TpuChip):
    def __init__(
        self,
        path: str = "/dev/accel0",
        name: str = "tpu-v5p",
        *,
        cc_capable: bool = True,
        ici_capable: bool = True,
        is_switch: bool = False,
        cc_mode: str = "off",
        ici_mode: str = "off",
        reset_latency_s: float = 0.0,
    ) -> None:
        self.path = path
        self.name = name
        self.is_cc_query_supported = cc_capable
        self.is_ici_query_supported = ici_capable
        self._is_switch = is_switch
        self._staged_cc = self._cc_mode = cc_mode
        self._staged_ici = self._ici_mode = ici_mode
        self._reset_latency_s = reset_latency_s
        self._lock = threading.Lock()

        # fault injection
        self.fail_query = False
        self.fail_set = False
        self.fail_reset = False
        self.fail_boot = False
        self.drop_staged_mode = False  # verify-mismatch: set "succeeds" but
        # the mode never takes effect after reset (main.py:292-296 path)

        # counters for assertions
        self.resets = 0
        self.sets = 0
        self.cc_queries = 0
        self.ici_queries = 0

    # -- TpuChip interface ------------------------------------------------
    def is_ici_switch(self) -> bool:
        return self._is_switch

    def query_cc_mode(self) -> str:
        if self.fail_query:
            raise DeviceError(f"{self.path}: query failed (injected)")
        if not self.is_cc_query_supported:
            raise DeviceError(f"{self.path}: CC query not supported")
        with self._lock:
            self.cc_queries += 1
            return self._cc_mode

    def set_cc_mode(self, mode: str) -> None:
        if self.fail_set:
            raise DeviceError(f"{self.path}: set_cc_mode failed (injected)")
        if not self.is_cc_query_supported:
            raise DeviceError(f"{self.path}: CC not supported")
        with self._lock:
            self.sets += 1
            self._staged_cc = mode

    def query_ici_mode(self) -> str:
        if self.fail_query:
            raise DeviceError(f"{self.path}: query failed (injected)")
        if not self.is_ici_query_supported:
            raise DeviceError(f"{self.path}: ICI query not supported")
        with self._lock:
            self.ici_queries += 1
            return self._ici_mode

    def set_ici_mode(self, mode: str) -> None:
        if self.fail_set:
            raise DeviceError(f"{self.path}: set_ici_mode failed (injected)")
        if not self.is_ici_query_supported:
            raise DeviceError(f"{self.path}: ICI not supported")
        with self._lock:
            self.sets += 1
            self._staged_ici = mode

    def discard_staged(self) -> None:
        with self._lock:
            self._staged_cc = self._cc_mode
            self._staged_ici = self._ici_mode

    def set_reset_latency(self, seconds: float) -> None:
        """Simulated reset wall-clock (simlab's flip_latency fault and
        the multichip bench): the next reset sleeps this long. A plain
        attribute write — GIL-atomic, safe to flip mid-run."""
        self._reset_latency_s = seconds

    def reset(self) -> None:
        if self.fail_reset:
            raise DeviceError(f"{self.path}: reset failed (injected)")
        if self._reset_latency_s:
            time.sleep(self._reset_latency_s)
        with self._lock:
            self.resets += 1
            if not self.drop_staged_mode:
                self._cc_mode = self._staged_cc
                self._ici_mode = self._staged_ici

    def wait_ready(self, timeout_s: float = 60.0) -> None:
        if self.fail_boot:
            raise DeviceError(f"{self.path}: boot timeout (injected)")


class FakeBackend(Backend):
    def __init__(
        self,
        chips: Optional[List[FakeChip]] = None,
        enum_error: Optional[str] = None,
    ) -> None:
        self.chips: List[FakeChip] = chips if chips is not None else []
        self.enum_error = enum_error

    def find_tpus(self) -> Tuple[List[TpuChip], Optional[str]]:
        return list(self.chips), self.enum_error

    def find_ici_switches(self) -> List[TpuChip]:
        return [c for c in self.chips if c.is_ici_switch()]


def fake_backend(
    n_chips: int = 4, n_switches: int = 0, **chip_kwargs: Any
) -> FakeBackend:
    """Convenience: a host with n uniform chips (+ optional ICI switches)."""
    chips = [
        FakeChip(path=f"/dev/accel{i}", **chip_kwargs) for i in range(n_chips)
    ]
    chips += [
        FakeChip(
            path=f"/dev/ici-switch{i}",
            name="ici-switch",
            is_switch=True,
            cc_capable=False,
        )
        for i in range(n_switches)
    ]
    return FakeBackend(chips)
