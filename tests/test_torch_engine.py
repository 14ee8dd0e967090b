"""The port's mode engine held to the reference's, scenario by scenario.

The same scripted scenarios run through the reference ``ModeEngine`` on
its fake backend and through the port's ``ModeEngine`` on the port's
fake backend. Each run must give the same return values (or the same
exception), the same sequence of state labels, the same span names and
the same ``get_modes()``.

Then the two live backends on the CPU: the reference ``JaxTpuBackend``
over the 8-device virtual CPU mesh (``TPU_CC_JAX_ALLOW_CPU=1``) and the
port's ``CudaBackend(device="cpu", cpu_chips=8)`` take the same flips and
must leave the same statefile contents chip by chip; and each package's
store reads and rewrites what the other one wrote.
"""

import collections
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from tpu_cc_manager import engine as jengine  # noqa: E402
from tpu_cc_manager import trace as jtrace  # noqa: E402
from tpu_cc_manager.device import fake as jfake  # noqa: E402
from tpu_cc_manager.device import statefile as jstatefile  # noqa: E402
from tpu_cc_manager.device.jaxdev import JaxTpuBackend  # noqa: E402
from tpu_cc_manager_torch import engine as tengine  # noqa: E402
from tpu_cc_manager_torch import trace as ttrace  # noqa: E402
from tpu_cc_manager_torch.device import base as tbase  # noqa: E402
from tpu_cc_manager_torch.device import fake as tfake  # noqa: E402
from tpu_cc_manager_torch.device import statefile as tstatefile  # noqa: E402
from tpu_cc_manager_torch.device.cudadev import CudaBackend  # noqa: E402

VERSIONS = f"jax {jax.__version__}, torch {torch.__version__}"

REF = types.SimpleNamespace(engine=jengine, fake=jfake, trace=jtrace)
PORT = types.SimpleNamespace(engine=tengine, fake=tfake, trace=ttrace)


@pytest.fixture(autouse=True)
def _reset_port_backend():
    """conftest resets the reference's registry; the port has its own."""
    tbase.set_backend(None)
    yield
    tbase.set_backend(None)


def _chips(pkg, root, n, **kw):
    # device paths under a directory that does not exist: the gate and
    # the holder scan run as in production and find no node to touch
    return [pkg.fake.FakeChip(path=f"{root}/accel{i}", **kw)
            for i in range(n)]


def _run(pkg, root, scenario, concurrency):
    """Drive one scenario; return what the parity test compares."""
    chips = scenario["chips"](pkg, root)
    states = []
    spans = []
    tracer = pkg.trace.Tracer()
    tracer.add_sink(lambda s: spans.append(s.name))
    engine = pkg.engine.ModeEngine(
        set_state_label=states.append, evict_components=False,
        backend=pkg.fake.FakeBackend(chips), tracer=tracer,
        flip_concurrency=concurrency)
    results = []
    for step in scenario["steps"]:
        if callable(step):
            step(chips)
            continue
        try:
            results.append(engine.set_mode(step))
        except Exception as e:  # compared by type and message
            results.append(f"{type(e).__name__}: {e}")
    return {
        "results": results,
        "states": states,
        # worker threads finish in any order under concurrency
        "spans": (collections.Counter(spans) if concurrency > 1
                  else spans),
        "modes": engine.get_modes(),
    }


def _inject(**faults):
    def step(chips):
        for key, value in faults.items():
            setattr(chips[1], key, value)
    return step


SCENARIOS = {
    "on_off_devtools_ici": {
        "chips": lambda pkg, root: _chips(pkg, root, 4),
        "steps": ["on", "off", "devtools", "ici"],
    },
    "idempotent_fast_path": {
        "chips": lambda pkg, root: _chips(pkg, root, 4),
        "steps": ["on", "on", "on"],
    },
    "mixed_capability": {
        "chips": lambda pkg, root: (
            _chips(pkg, root, 3)
            + [pkg.fake.FakeChip(path=f"{root}/accel9", cc_capable=False,
                                 ici_capable=False)]),
        "steps": ["on", "off", "devtools"],
    },
    "stage_failure": {
        "chips": lambda pkg, root: _chips(pkg, root, 4),
        "steps": [_inject(fail_set=True), "on",
                  _inject(fail_set=False), "on"],
    },
    "reset_failure": {
        "chips": lambda pkg, root: _chips(pkg, root, 4),
        "steps": [_inject(fail_reset=True), "devtools",
                  _inject(fail_reset=False), "devtools"],
    },
    "wait_failure": {
        "chips": lambda pkg, root: _chips(pkg, root, 4),
        "steps": [_inject(fail_boot=True), "on",
                  _inject(fail_boot=False), "on"],
    },
    "verify_mismatch": {
        "chips": lambda pkg, root: _chips(pkg, root, 4),
        "steps": [_inject(drop_staged_mode=True), "on",
                  _inject(drop_staged_mode=False), "on"],
    },
    "invalid_mode": {
        "chips": lambda pkg, root: _chips(pkg, root, 2),
        "steps": ["sideways", "on"],
    },
    "switches_after_chips": {
        "chips": lambda pkg, root: (
            _chips(pkg, root, 2)
            + [pkg.fake.FakeChip(path=f"{root}/ici-switch0",
                                 name="ici-switch", is_switch=True,
                                 cc_capable=False)]),
        "steps": ["ici", "off"],
    },
}


#: scenarios whose outcome does not hang on thread timing: with a fault
#: injected, a parallel sibling that starts after the failure is skipped
#: and one that started before it completes, in either package
TIMING_FREE = ("idempotent_fast_path", "invalid_mode", "mixed_capability",
               "on_off_devtools_ici", "switches_after_chips")


@pytest.mark.parametrize("name,concurrency", (
    [(name, 1) for name in sorted(SCENARIOS)]
    + [(name, 4) for name in TIMING_FREE]))
def test_engine_matches_the_reference(name, concurrency, tmp_path):
    root = str(tmp_path / "no-devfs")
    chips = 8 if concurrency > 1 else None
    scenario = dict(SCENARIOS[name])
    if chips and name == "on_off_devtools_ici":
        scenario["chips"] = lambda pkg, r: _chips(pkg, r, chips)
    want = _run(REF, root, scenario, concurrency)
    got = _run(PORT, root, scenario, concurrency)
    for key in ("results", "states", "spans", "modes"):
        assert got[key] == want[key], (name, key, VERSIONS)
    assert want["results"], name


def test_flip_concurrency_4_runs_the_flips_together(tmp_path):
    """The parallel scenario really ran in parallel in both packages:
    eight flips, at most four at once, the same outcome."""
    import threading

    for pkg in (REF, PORT):
        live, peak = [0], [0]
        lock = threading.Lock()
        chips = _chips(pkg, str(tmp_path / "no-devfs"), 8)
        for chip in chips:
            real = chip.reset

            def reset(_real=real):
                with lock:
                    live[0] += 1
                    peak[0] = max(peak[0], live[0])
                try:
                    import time

                    time.sleep(0.02)
                    _real()
                finally:
                    with lock:
                        live[0] -= 1

            chip.reset = reset
        engine = pkg.engine.ModeEngine(
            set_state_label=lambda v: None, evict_components=False,
            backend=pkg.fake.FakeBackend(chips), flip_concurrency=4)
        assert engine.set_mode("on") is True
        assert 1 < peak[0] <= 4, (pkg.engine.__name__, peak[0])
        assert all(c.resets == 1 for c in chips)


# ----------------------------------------------- the live CPU backends


FILES = ("cc.staged", "cc.effective", "ici.staged", "ici.effective")


def _files(state_dir, path):
    d = state_dir / jstatefile.device_key(path)
    return {name: (d / name).read_text() for name in FILES}


def test_live_backends_leave_the_same_statefiles(tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_CC_JAX_ALLOW_CPU", "1")
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jbe = JaxTpuBackend(state_dir=str(jdir))
    tbe = CudaBackend(state_dir=str(tdir), device="cpu", cpu_chips=8)
    engines = [
        pkg.engine.ModeEngine(
            set_state_label=lambda v: None, evict_components=False,
            backend=be)
        for pkg, be in ((REF, jbe), (PORT, tbe))
    ]
    for mode in ("on", "off", "devtools", "ici"):
        assert [e.set_mode(mode) for e in engines] == [True, True], mode
        for i in range(8):
            assert (_files(tdir, f"torch:cpu:{i}")
                    == _files(jdir, f"jax:cpu:{i}")), (mode, i, VERSIONS)
    assert jbe.runtime_gen == tbe.runtime_gen == 4
    jmodes = engines[0].get_modes()
    tmodes = engines[1].get_modes()
    assert [jmodes[f"jax:cpu:{i}"] for i in range(8)] == [
        tmodes[f"torch:cpu:{i}"] for i in range(8)]


@pytest.mark.parametrize("writer,reader", [
    (jstatefile.ModeStateStore, tstatefile.ModeStateStore),
    (tstatefile.ModeStateStore, jstatefile.ModeStateStore),
])
def test_statefiles_round_trip_between_the_packages(writer, reader,
                                                    tmp_path):
    paths = ["jax:cpu:0", "torch:cpu:3", "cuda:0000:3b:00.0"]
    w, r = writer(str(tmp_path)), reader(str(tmp_path))
    for i, path in enumerate(paths):
        w.stage(path, "cc", ("on", "devtools", "off")[i])
        w.stage(path, "ici", "on")
        w.commit(path)
        w.stage(path, "cc", "devtools")  # staged, not committed
    for i, path in enumerate(paths):
        assert r.effective(path, "cc") == ("on", "devtools", "off")[i]
        assert r.effective(path, "ici") == "on"
        assert r.staged(path, "cc") == "devtools"
        # and back: the reader rolls staged back and commits a new mode
        r.discard(path)
        r.stage(path, "cc", "off")
        r.commit(path)
        assert w.effective(path, "cc") == "off"
        assert w.staged(path, "ici") == "on"


def test_port_backend_reads_a_state_dir_the_reference_backend_wrote(
        tmp_path, monkeypatch):
    """One state directory, both live backends: what JaxTpuBackend
    committed for a device path reads back through the port's store and
    independent verify path, and the port's flips read back through the
    reference's."""
    monkeypatch.setenv("TPU_CC_JAX_ALLOW_CPU", "1")
    state = tmp_path / "state"
    jbe = JaxTpuBackend(state_dir=str(state))
    tbe = CudaBackend(state_dir=str(state), device="cpu", cpu_chips=8)
    jeng = jengine.ModeEngine(set_state_label=lambda v: None,
                              evict_components=False, backend=jbe)
    teng = tengine.ModeEngine(set_state_label=lambda v: None,
                              evict_components=False, backend=tbe)
    assert jeng.set_mode("devtools") is True
    assert teng.set_mode("ici") is True
    for i in range(8):
        assert tbe.store.effective(f"jax:cpu:{i}", "cc") == "devtools"
        assert tstatefile.independent_read(
            tbe.store, f"jax:cpu:{i}", "cc") == "devtools"
        assert jbe.store.effective(f"torch:cpu:{i}", "ici") == "on"
        assert jbe.store.effective(f"torch:cpu:{i}", "cc") == "off"
