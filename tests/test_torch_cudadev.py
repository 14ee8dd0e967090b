"""CUDA device backend (tpu_cc_manager_torch/device/cudadev.py).

The cases of ``tests/test_jaxdev.py``, run on ``CudaBackend(device="cpu",
cpu_chips=8)``: eight CPU chips, asked for explicitly, whose probe runs
K5's plain version. On the card the same code enumerates every CUDA
device and runs K5 itself (``chip_smoke.py``). Beyond those cases: with no
CUDA device and no CPU request nothing is enumerated and nothing flips,
and a reset leaves the planner's resident session ticking to the same
outputs.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_cc_manager_torch import __main__ as cli  # noqa: E402
from tpu_cc_manager_torch import labels as L  # noqa: E402
from tpu_cc_manager_torch import plan as tplan  # noqa: E402
from tpu_cc_manager_torch.device import base as device_base  # noqa: E402
from tpu_cc_manager_torch.device.base import DeviceError, set_backend  # noqa: E402
from tpu_cc_manager_torch.device.cudadev import CudaBackend  # noqa: E402
from tpu_cc_manager_torch.device.gpu import SysfsGpuBackend  # noqa: E402
from tpu_cc_manager_torch.device.statefile import ModeStateStore  # noqa: E402
from tpu_cc_manager_torch.engine import ModeEngine  # noqa: E402
from tpu_cc_manager_torch.kernels import LAUNCHES  # noqa: E402


@pytest.fixture(autouse=True)
def _reset_port_backend():
    """conftest resets the reference's registry; this file's engines use
    the port's."""
    device_base.set_backend(None)
    yield
    device_base.set_backend(None)


@pytest.fixture
def cuda_backend(tmp_path):
    return CudaBackend(state_dir=str(tmp_path / "state"), device="cpu",
                       cpu_chips=8)


def _no_cuda(monkeypatch):
    monkeypatch.delenv(tplan.DEVICE_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_enumerates_the_requested_cpu_chips(cuda_backend):
    chips, err = cuda_backend.find_tpus()
    assert err is None
    assert len(chips) == 8
    assert [c.path for c in chips] == [f"torch:cpu:{i}" for i in range(8)]
    assert all(c.is_cc_query_supported for c in chips)
    assert sorted(c.device_id for c in chips) == list(range(8))


def test_cpu_chips_only_when_asked(tmp_path, monkeypatch):
    _no_cuda(monkeypatch)
    be = CudaBackend(state_dir=str(tmp_path / "state"))
    chips, err = be.find_tpus()
    assert chips == []
    assert "no CUDA device" in err and tplan.DEVICE_ENV in err
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    chips, err = CudaBackend(state_dir=str(tmp_path / "state")).find_tpus()
    assert err is None and [c.path for c in chips] == ["torch:cpu:0"]


def test_capability_filter_by_device_name(tmp_path, monkeypatch):
    monkeypatch.setenv("CC_CAPABLE_DEVICE_KINDS", "h100,h200")
    be = CudaBackend(state_dir=str(tmp_path / "state"), device="cpu",
                     cpu_chips=8)
    chips, _ = be.find_tpus()
    assert chips and all(not c.is_cc_query_supported for c in chips)
    monkeypatch.setenv("CC_CAPABLE_DEVICE_KINDS", "CPU")
    chips, _ = be.find_tpus()
    assert chips and all(c.is_cc_query_supported for c in chips)


def test_probe_runs_the_plain_version_on_a_cpu_chip(cuda_backend):
    before = dict(LAUNCHES)
    dt = cuda_backend.probe_device(0)
    assert dt >= 0
    assert LAUNCHES == before  # the plain version is no launch
    with pytest.raises(DeviceError):
        cuda_backend.probe_device(99)


def test_full_flip_through_the_backend(cuda_backend):
    # stage -> reset (runtime quiesce + commit) -> wait_ready (probe) ->
    # verify: the reference's per-device sequence (main.py:258-296)
    set_backend(cuda_backend)
    states = []
    engine = ModeEngine(set_state_label=states.append, evict_components=False)
    assert engine.set_mode("on") is True
    assert states == ["on"]
    chips, _ = cuda_backend.find_tpus()
    assert all(c.query_cc_mode() == "on" for c in chips)
    # idempotent fast path on the second application
    states.clear()
    assert engine.set_mode("on") is True
    assert states == ["on"]


def test_describe_inventory_shape(cuda_backend):
    desc = cuda_backend.describe()
    assert desc["backend"] == "cuda"
    assert desc["error"] is None
    assert len(desc["devices"]) == 8
    d0 = desc["devices"][0]
    assert {"path", "device_kind", "platform", "device_id", "cc_capable",
            "ici_capable", "cc_mode", "ici_mode"} <= set(d0)
    assert d0["platform"] == "cpu" and d0["device_kind"] == "cpu"
    json.dumps(desc)  # serializable as-is


def _count_teardowns(monkeypatch):
    calls = []
    real = CudaBackend.teardown_runtime

    def counting(self):
        calls.append(1)
        real(self)

    monkeypatch.setattr(CudaBackend, "teardown_runtime", counting)
    return calls


def test_one_teardown_per_multichip_plan(cuda_backend, monkeypatch):
    # the restart is runtime-global: flipping all 8 chips costs exactly
    # ONE teardown (chips share the generation they were enumerated under)
    set_backend(cuda_backend)
    calls = _count_teardowns(monkeypatch)
    engine = ModeEngine(set_state_label=lambda v: None,
                        evict_components=False)
    assert engine.set_mode("on") is True
    assert len(calls) == 1
    assert cuda_backend.runtime_gen == 1
    chips, _ = cuda_backend.find_tpus()
    assert all(c.query_cc_mode() == "on" for c in chips)


def test_parallel_flip_pays_one_teardown(cuda_backend, monkeypatch):
    # the same under the parallel executor: workers racing CudaChip.reset
    # serialize on the teardown lock and exactly one restarts the runtime
    monkeypatch.setenv("TPU_CC_FLIP_CONCURRENCY", "4")
    set_backend(cuda_backend)
    calls = _count_teardowns(monkeypatch)
    engine = ModeEngine(set_state_label=lambda v: None,
                        evict_components=False)
    assert engine.set_mode("on") is True
    assert len(calls) == 1
    chips, _ = cuda_backend.find_tpus()
    assert all(c.query_cc_mode() == "on" for c in chips)


def test_wait_ready_backoff(cuda_backend, monkeypatch):
    # two probe failures cost ~0.15 s of backoff (0.05 + 0.1)
    import time

    chip = cuda_backend.find_tpus()[0][0]
    failures = {"left": 2}
    real_probe = CudaBackend.probe_device

    def flaky(self, device_id):
        if failures["left"] > 0:
            failures["left"] -= 1
            raise RuntimeError("runtime still rebooting")
        return real_probe(self, device_id)

    monkeypatch.setattr(CudaBackend, "probe_device", flaky)
    t0 = time.monotonic()
    chip.wait_ready(timeout_s=5)
    elapsed = time.monotonic() - t0
    assert failures["left"] == 0
    assert elapsed < 0.5, elapsed


def test_statefile_reads_have_no_side_effects(tmp_path):
    store = ModeStateStore(str(tmp_path / "never-created"))
    assert store.effective("cuda:0000:18:00.0", "cc") == "off"
    assert store.staged("cuda:0000:18:00.0", "cc") == "off"
    assert not os.path.exists(str(tmp_path / "never-created"))


def test_backend_registry_env_selection(tmp_path, monkeypatch):
    monkeypatch.delenv("TPU_CC_DEVICE_BACKEND", raising=False)
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(tmp_path / "state"))
    device_base.set_backend(None)
    assert isinstance(device_base.get_backend(), CudaBackend)  # default
    monkeypatch.setenv("TPU_CC_DEVICE_BACKEND", "cuda")
    device_base.set_backend(None)
    assert isinstance(device_base.get_backend(), CudaBackend)
    monkeypatch.setenv("TPU_CC_DEVICE_BACKEND", "sysfs")
    device_base.set_backend(None)
    assert isinstance(device_base.get_backend(), SysfsGpuBackend)
    monkeypatch.setenv("TPU_CC_DEVICE_BACKEND", "bogus")
    device_base.set_backend(None)
    with pytest.raises(DeviceError):
        device_base.get_backend()


def test_probe_devices_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("TPU_CC_DEVICE_BACKEND", raising=False)
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(tmp_path / "state"))
    assert cli.main(["probe-devices"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["backend"] == "cuda"
    assert out["error"] is None
    assert [d["path"] for d in out["devices"]] == ["torch:cpu:0"]
    assert out["devices"][0]["cc_capable"] is True


def test_probe_devices_cli_backend_flag_and_error_containment(
    tmp_path, monkeypatch, capsys
):
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(tmp_path / "state"))
    # --backend fake probes the in-memory fake (4 chips), rc 0
    assert cli.main(["probe-devices", "--backend", "fake"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["backend"] == "fake"
    assert len(out["devices"]) == 4

    # a crashing backend yields JSON + rc 1, never a traceback
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")

    def boom(self):
        raise RuntimeError("runtime gone")

    monkeypatch.setattr(CudaBackend, "find_tpus", boom)
    assert cli.main(["probe-devices", "--backend", "cuda"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert out["backend"] == "cuda"
    assert "runtime gone" in out["error"]


def test_wait_ready_early_exits_on_generation_bump(cuda_backend,
                                                   monkeypatch):
    """A restart landing MID-WAIT bumps the runtime generation; the
    backoff poll fails fast, naming the supersession, instead of
    holding its whole deadline probing a superseded session."""
    import threading
    import time

    chip = cuda_backend.find_tpus()[0][0]

    def failing_probe(device_id):
        raise RuntimeError("runtime not up (injected)")

    monkeypatch.setattr(cuda_backend, "probe_device", failing_probe)

    def bump():
        time.sleep(0.15)
        with cuda_backend._devices_lock:
            cuda_backend.runtime_gen += 1

    t = threading.Thread(target=bump)
    t.start()
    t0 = time.monotonic()
    with pytest.raises(DeviceError) as ei:
        chip.wait_ready(timeout_s=30.0)
    elapsed = time.monotonic() - t0
    t.join(timeout=5)
    assert not t.is_alive()
    assert elapsed < 5.0, elapsed
    assert "generation advanced" in str(ei.value)


def test_wait_ready_still_times_out_without_a_bump(cuda_backend,
                                                   monkeypatch):
    import time

    chip = cuda_backend.find_tpus()[0][0]
    monkeypatch.setattr(
        cuda_backend, "probe_device",
        lambda device_id: (_ for _ in ()).throw(RuntimeError("still down")),
    )
    t0 = time.monotonic()
    with pytest.raises(DeviceError) as ei:
        chip.wait_ready(timeout_s=0.4)
    assert time.monotonic() - t0 >= 0.35
    assert "not ready after" in str(ei.value)


# ------------------------------------------------ beyond test_jaxdev


def test_no_cuda_and_no_cpu_request_flips_nothing(tmp_path, monkeypatch,
                                                  capsys):
    _no_cuda(monkeypatch)
    state = tmp_path / "state"
    be = CudaBackend(state_dir=str(state))
    set_backend(be)
    states = []
    engine = ModeEngine(set_state_label=states.append,
                        evict_components=False)
    with pytest.raises(DeviceError, match="no CUDA device"):
        engine.set_mode("on")
    assert states == []
    assert not state.exists()  # no chip was staged or committed
    # the CLI reports the error the same way
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(state))
    assert cli.main(["get-cc-mode"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["probe-devices"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out["devices"] == [] and "no CUDA device" in out["error"]
    assert not state.exists()


def test_get_cc_mode_cli(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(tplan.DEVICE_ENV, "cpu")
    monkeypatch.setenv("TPU_CC_STATE_DIR", str(tmp_path / "state"))
    be = CudaBackend()
    ModeEngine(set_state_label=lambda v: None, evict_components=False,
               backend=be).set_mode("devtools")
    assert cli.main(["get-cc-mode"]) == 0
    out = json.loads(capsys.readouterr().out)
    assert out == {"torch:cpu:0": {"cc": "devtools", "ici": "off"}}


def test_reset_leaves_a_tick_session_ticking_the_same(cuda_backend,
                                                      monkeypatch):
    """The restart analog never resets the CUDA context: it synchronizes
    each device and returns cached blocks, so tensors that live across
    it, the planner's resident session block above all, keep their
    values. On the CPU the torch.cuda calls are recorded, not run."""
    enc = tplan.FleetEncoding()
    rng = np.random.default_rng(3)
    for i in range(40):
        enc.apply({"metadata": {"name": f"n{i}", "labels": {
            L.CC_MODE_LABEL: "on",
            L.CC_MODE_STATE_LABEL: str(rng.choice(["on", "off", "failed"])),
            L.TPU_SLICE_LABEL: f"s{i // 4}"}}})
    sess = tplan.TickSession(full_every=0, device="cpu")
    first = sess.tick(enc, force_full=True).outputs
    before = {k: np.asarray(v).copy() for k, v in first.items()}

    calls = []
    for name in ("synchronize", "empty_cache", "ipc_collect"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name: calls.append(_n))
    cuda_backend.find_tpus()  # enumerated: the restart syncs each device
    cuda_backend._cpu = False  # take the CUDA restart path, recorded
    cuda_backend.teardown_runtime()
    cuda_backend._cpu = True
    assert calls == ["synchronize"] * 8 + ["empty_cache", "ipc_collect"]
    assert cuda_backend.runtime_gen == 1
    assert ModeEngine(set_state_label=lambda v: None,
                      evict_components=False,
                      backend=cuda_backend).set_mode("on") is True

    again = sess.tick(enc, force_full=True).outputs
    assert set(again) == set(before)
    for key, want in before.items():
        assert np.array_equal(np.asarray(again[key]), want), key
