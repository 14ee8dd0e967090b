"""The kernel library's build is bounded (``kernels/_build.py``).

``nvcc`` is replaced by shell scripts under ``tmp_path``: one that hangs,
one that fails, one that compiles but hangs in the link. A hung compile
must raise within its deadline, for the caller and for a thread waiting
on the library lock, and leave no compiler process and no work
directory behind; a failing one must still raise ``nvcc failed`` with
its log. These run on the CPU: nothing here needs a card or a compiler.
"""

import os
import threading
import time

import pytest

from tpu_cc_manager_torch.kernels import _build

DEADLINE_S = 1.5
#: what killing and reaping the compilers may add to the deadline
MARGIN_S = 3.0

#: records its own pid and its child's, then waits on a child that sleeps
#: far past any deadline here
HANG = """#!/bin/sh
echo $$ >> {pids}
sleep 60 &
echo $! >> {pids}
wait
"""

FAIL = """#!/bin/sh
echo "error: refusing $*"
exit 2
"""

#: compiles (writes the object it is asked for) but hangs in the link
HANG_IN_LINK = """#!/bin/sh
case "$*" in
  *-shared*) echo $$ >> {pids}; sleep 60 & echo $! >> {pids}; wait ;;
esac
while [ $# -gt 0 ]; do
  if [ "$1" = "-o" ]; then : > "$2"; fi
  shift
done
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    """Point the build at a scratch build directory and a script standing
    in for ``nvcc``; returns a function that writes the script and the
    file its processes record their pids in."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(_build, "COMPILE_TIMEOUT_S", DEADLINE_S)
    monkeypatch.setattr(_build, "LINK_TIMEOUT_S", DEADLINE_S)
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "_failures", 0)
    monkeypatch.setattr(_build, "_last_error", None)
    pids = tmp_path / "pids"

    def install(body: str):
        script = tmp_path / "nvcc"
        script.write_text(body.format(pids=pids))
        script.chmod(0o755)
        monkeypatch.setattr(_build, "nvcc_path", lambda: str(script))
        return pids

    return install


def _children() -> set:
    """Pids of this process's children that have not been reaped."""
    me, out = os.getpid(), set()
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == me:
            out.add(int(entry))
    return out


def _running(pid: int) -> bool:
    """Whether ``pid`` is a live process (a zombie waiting for its
    reaper is not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _recorded(pids) -> list:
    return [int(p) for p in pids.read_text().split()] if pids.exists() else []


def _assert_clean(pids, before: set) -> None:
    recorded = _recorded(pids)
    assert recorded, "the fake nvcc never ran"
    deadline = time.monotonic() + MARGIN_S  # an orphan's reaping is async
    while any(_running(p) for p in recorded) and time.monotonic() < deadline:
        time.sleep(0.05)
    assert not [p for p in recorded if _running(p)], "a compiler outlived the build"
    assert _children() <= before, "the build left a child process"
    assert not list(_build.BUILD_DIR.glob("tmp-*")), "a work directory was left"
    assert not _build.library_path().exists()
    assert _build._lib is None


def test_a_hung_compile_raises_within_its_deadline(fake_nvcc):
    pids = fake_nvcc(HANG)
    before = _children()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"did not compile \S+\.cu within 1\.5 s"):
        _build.library()
    elapsed = time.monotonic() - t0
    assert DEADLINE_S <= elapsed < DEADLINE_S + MARGIN_S, elapsed
    # every source's compile started, and every one was killed with its child
    assert len(_recorded(pids)) == 2 * len(_build.SOURCES)
    _assert_clean(pids, before)


def test_a_thread_waiting_on_the_lock_gets_the_same_error(fake_nvcc):
    pids = fake_nvcc(HANG)
    before = _children()
    errors = {}

    def call(who):
        t0 = time.monotonic()
        try:
            _build.library()
        except RuntimeError as e:
            errors[who] = (str(e), time.monotonic() - t0)

    first = threading.Thread(target=call, args=("first",))
    first.start()
    deadline = time.monotonic() + DEADLINE_S
    while not _recorded(pids) and time.monotonic() < deadline:
        time.sleep(0.01)  # the first caller is building, under the lock
    second = threading.Thread(target=call, args=("second",))
    second.start()
    first.join(DEADLINE_S + 2 * MARGIN_S)
    second.join(DEADLINE_S + 2 * MARGIN_S)
    assert not first.is_alive() and not second.is_alive(), "a caller hangs"
    assert set(errors) == {"first", "second"}
    assert errors["second"][0] == errors["first"][0]
    assert "did not compile" in errors["second"][0]
    assert errors["second"][1] < DEADLINE_S + MARGIN_S, errors
    # the waiting thread did not start a build of its own
    assert len(_recorded(pids)) == 2 * len(_build.SOURCES)
    _assert_clean(pids, before)
    # a later call builds afresh (and fails afresh here)
    with pytest.raises(RuntimeError, match="did not compile"):
        _build.library()
    assert len(_recorded(pids)) == 4 * len(_build.SOURCES)


def test_a_hung_link_raises_within_its_deadline(fake_nvcc):
    pids = fake_nvcc(HANG_IN_LINK)
    before = _children()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"did not link \S+ within 1\.5 s"):
        _build.library()
    assert time.monotonic() - t0 < DEADLINE_S + MARGIN_S
    assert len(_recorded(pids)) == 2
    _assert_clean(pids, before)


def test_a_failing_compile_raises_with_its_log(fake_nvcc, tmp_path):
    fake_nvcc(FAIL)
    before = _children()
    with pytest.raises(RuntimeError, match="nvcc failed on") as err:
        _build.library()
    assert "error: refusing" in str(err.value)
    assert all(f"== {name}" in str(err.value) for name in _build.SOURCES)
    assert _children() <= before
    assert not list(_build.BUILD_DIR.glob("tmp-*"))
    assert _build._lib is None
