"""Durable staged/effective attestation-mode store.

On Cloud TPU the confidential/attestation mode is tied to the VM + runtime
lifecycle rather than a device register, so the mode flip is an
asynchronous, restart-spanning operation (SURVEY.md §7.4 "hard parts").
This store makes it resumable: the *staged* mode survives agent crashes,
and only a ``commit`` (performed by ``reset()``) moves staged → effective —
the same externally visible contract as the reference's
``set_cc_mode → reset_with_os → query`` sequence (reference
main.py:282-296).

On-disk layout (shared verbatim with the C++ ``libtpudev`` shim and the
bash engine, so all three implementations interoperate on one host)::

    <state_dir>/<device-key>/cc.staged
    <state_dir>/<device-key>/cc.effective
    <state_dir>/<device-key>/ici.staged
    <state_dir>/<device-key>/ici.effective
    <state_dir>/<device-key>/.lock

where ``<device-key>`` is the device path with '/' mapped to '_'
(``/dev/accel0`` → ``_dev_accel0``). Writes are atomic (tempfile +
rename) and serialized by an ``fcntl`` lock per device, because the
Python agent, the bash engine, and the C++ agent may race on one host.
Unknown/absent state reads as ``off`` (a fresh chip is unprotected).

Thread-safety (audited for the parallel flip pipeline, docs/engine.md):
the store holds no instance state beyond ``state_dir``; every operation
opens its own lock file descriptor, and ``flock`` serializes distinct
*open file descriptions*, so two threads of one process exclude each
other exactly like two processes do. The engine's flip executor only
parallelizes across devices — distinct ``<device-key>`` dirs, distinct
locks — so sibling flips never even contend; same-device cross-process
races (bash engine, C++ agent) keep the protection they always had.
``os.makedirs(exist_ok=True)`` in ``_dev_dir`` is idempotent under
concurrent callers by contract.
"""

from __future__ import annotations

import fcntl
import os
import tempfile
from contextlib import contextmanager
from typing import Optional

from tpu_cc_manager_torch.device.base import DeviceError


def device_key(path: str) -> str:
    return path.replace("/", "_")


class ModeStateStore:
    def __init__(self, state_dir: str):
        self.state_dir = state_dir

    def _dev_dir(self, path: str) -> str:
        d = os.path.join(self.state_dir, device_key(path))
        try:
            os.makedirs(d, exist_ok=True)
        except OSError as e:
            raise DeviceError(f"{path}: cannot create state dir {d}: {e}") from e
        return d

    @contextmanager
    def _locked(self, path: str):
        d = self._dev_dir(path)
        lock_path = os.path.join(d, ".lock")
        try:
            lock = open(lock_path, "a+")
        except OSError as e:
            raise DeviceError(f"{path}: cannot open lock {lock_path}: {e}") from e
        with lock:
            fcntl.flock(lock.fileno(), fcntl.LOCK_EX)
            try:
                yield d
            finally:
                fcntl.flock(lock.fileno(), fcntl.LOCK_UN)

    @staticmethod
    def _read(d: str, name: str) -> str:
        try:
            with open(os.path.join(d, name), "r") as f:
                return f.read().strip() or "off"
        except OSError:
            return "off"

    @staticmethod
    def _write_atomic(d: str, name: str, value: str) -> None:
        # Store failures (disk full, read-only fs, permissions) must surface
        # as DeviceError: the engine's failure path catches DeviceError and
        # publishes cc.mode.state=failed (the reference's failure-visibility
        # contract, reference main.py:300-307) — a bare OSError would skip
        # the state label entirely.
        try:
            fd, tmp = tempfile.mkstemp(dir=d, prefix=f".{name}.")
        except OSError as e:
            raise DeviceError(f"cannot stage {name} in {d}: {e}") from e
        try:
            with os.fdopen(fd, "w") as f:
                f.write(value + "\n")
                f.flush()
                os.fsync(f.fileno())
            os.rename(tmp, os.path.join(d, name))
        except BaseException as e:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if isinstance(e, OSError):
                raise DeviceError(f"cannot write {name} in {d}: {e}") from e
            raise

    def _read_only_dir(self, path: str) -> Optional[str]:
        """Device dir for pure reads: None when absent — readers report
        'off' without creating dirs/locks as a side effect (an inventory
        query must not scribble on /var/lib)."""
        d = os.path.join(self.state_dir, device_key(path))
        return d if os.path.isdir(d) else None

    def effective(self, path: str, domain: str) -> str:
        if self._read_only_dir(path) is None:
            return "off"
        with self._locked(path) as d:
            return self._read(d, f"{domain}.effective")

    def staged(self, path: str, domain: str) -> str:
        if self._read_only_dir(path) is None:
            return "off"
        with self._locked(path) as d:
            return self._read(d, f"{domain}.staged")

    def stage(self, path: str, domain: str, mode: str) -> None:
        with self._locked(path) as d:
            self._write_atomic(d, f"{domain}.staged", mode)

    def commit(self, path: str) -> None:
        """Apply all staged modes for the device (runs at reset time)."""
        with self._locked(path) as d:
            for domain in ("cc", "ici"):
                staged = self._read(d, f"{domain}.staged")
                self._write_atomic(d, f"{domain}.effective", staged)

    def discard(self, path: str) -> None:
        """Roll staged back to effective for every domain. The engine calls
        this before staging a new flip so that stale intent from an earlier
        failed/crashed flip can never ride along into the next reset (the
        durable *desired* state lives in the node label, not here)."""
        with self._locked(path) as d:
            for domain in ("cc", "ici"):
                effective = self._read(d, f"{domain}.effective")
                self._write_atomic(d, f"{domain}.staged", effective)


def independent_read(store, path: str, domain: str) -> str:
    """Cross-read the effective mode through an INDEPENDENT store handle,
    preferring the *other* implementation (native libtpudev when the
    caller uses the Python store, and vice versa). This is the engine's
    non-tautological verify path (reference main.py:291-296 re-queries
    hardware that could genuinely disagree): a commit that only "took"
    inside the flipping handle's state — or a statefile tampered after
    commit — is caught by a reader that shares nothing with the writer
    but the bytes on disk and the fcntl lock."""
    from tpu_cc_manager_torch.device.native import load_native_store

    state_dir = store.state_dir
    if isinstance(state_dir, bytes):
        state_dir = state_dir.decode()
    if isinstance(store, ModeStateStore):
        alt = load_native_store(state_dir) or ModeStateStore(state_dir)
    else:
        alt = ModeStateStore(state_dir)
    return alt.effective(path, domain)
